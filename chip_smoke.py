#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``mxnet_tpu_torch``) on one GPU.

Run from the root of a checkout on a host with an NVIDIA H100:

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. device: the card's name and count, and ``nvidia-smi``'s name and power
   limit line.
2. build: compiles every hand-written kernel library from
   ``mxnet_tpu_torch/csrc`` with ``nvcc`` into ``build/`` (one ``nvcc`` per
   source, all started together) and prints the seconds and ``ptxas -v``.
3. kernel: holds each kernel against its plain PyTorch version on the card
   at the main path's shapes (and ragged, cross-attention, causal and
   low-precision cases), then times kernel, plain version and the PyTorch
   library call that computes the same function (a yardstick only; the port
   never calls it) with CUDA events, beside the least time the card could
   take for the work. The flash-attention forward (K1) and backward (dQ K2,
   dK/dV K3); the fused SGD/Adam updates (K4, K5) on a small ragged list
   here, on BERT-base's parameters in phase 7. For K1-K3 also the HMMA
   instructions of every instantiation in the built library (``cuobjdump
   -sass``; none, or local memory at D=64, fails the phase), their registers,
   stack, local and shared memory (``cuobjdump -res-usage``), the f32 bound
   of the 3xTF32 tensor-core route beside the FMA one, K1 and SDPA's forward
   and the port's and SDPA's whole backward replayed from captured CUDA
   graphs. K1-K3 are also held and timed at each rank's shape of phase 11
   (BH 24, Tq 512 against Tk 1024, D 64), at the pipeline microbatch's of
   phase 24 (BH 24, T 1024, D 64: f32 and bf16, against the plain versions,
   timed beside SDPA and the bound), and at the widest head they take,
   D = 256 (two passes of 128 output columns), at BH 24, T 1024: f32 and
   bf16, causal and not, against the plain versions, timed beside SDPA and
   the bound; each D = 256 instantiation's registers, stack and local
   memory are printed with the others.
4. serve: BERT-base at T=1024 (full published width, 12 layers, random
   weights from a seed loaded through ``convert.load_jax_params``) on
   ``gpu(0)`` in f32 with TF32 off answers requests of batch 1, 2, 4 and 8;
   every launch counter is set to 0 just before and read just after, and
   the flash kernel must have launched once per layer per request. One more
   batch-8 request runs under ``torch.profiler`` for the device time by
   kernel and the device's busy share. The batch-1 request is then answered
   on the CPU by the plain versions and the logits compared.
5. train: BERT-base at T=1024, batch 8, f32 with TF32 off, trained through
   Gluon (``autograd.record()``, ``SoftmaxCrossEntropyLoss`` over the MLM
   logits of every token, ``loss.backward()``, ``Trainer("adam", lr
   1e-4).step(8)``) on one batch for a warm-up and 4 timed steps; each step
   must launch K1, K2 and K3 once per layer (counters set to 0 just before
   the steps) and give a finite loss. Step time, tokens/s, loss, peak device
   memory, and one more step under ``torch.profiler``.
6. train check: one step of a 2-layer model of BERT-base width at T=1024,
   batch 1, same weights, on ``gpu(0)`` and on the CPU (plain versions):
   loss, every gradient and every weight after the Adam step compared.
7. fused update: ``fused_adam_apply`` and ``fused_sgd_apply`` on the
   trained BERT-base's 157 weights and last gradients with fresh zero
   states, t=1 then t=2 (counters set to 0 just before: one launch per
   call), against their plain versions; timed beside ``torch.optim``'s
   fused Adam and SGD and the bound.

   Also the fused training step's rules (``sgd_mom_update``'s,
   ``sgd_update``'s and ``adam_update``'s, ``fused_*_update``) against their
   plain versions and timed in place; each also in its device-scalar form
   (``fused_*_update_hyper``: the 10 scalars read from device memory, the form
   every trainer's step uses), bitwise against the by-value form and timed
   beside it in place and by graph replay (one launch a replay).
8. the rtc (K6), ResNet-50 serve, probe and ResNet-50 training phases. rtc:
   the example kernels against their plain versions (``axpy`` also on views
   off a 16-byte boundary, exact), ``axpy`` on 2^26 f32 on a grid sized to
   the data and the SM count, timed by CUDA events and by CUDA-graph replay
   beside ``torch.add``, NVRTC's compile split into loading ``libnvrtc``,
   ``nvrtcCompileProgram`` and ``cuModuleLoadData``, and an empty launch's
   host time over 1000 synced launches. The probe holds K7 against its
   plain version on three ResNet-50 im2col shapes and on real im2col data,
   times it by CUDA events and by graph replay beside ``torch.matmul`` and
   the cuDNN convolution, and fails if its bf16 or f16 instantiation lacks
   HGMMA (``wgmma``) or UTMALDG (TMA); its f32 route (FMA) is timed by graph
   replay at the same shapes beside ``torch.matmul`` with TF32 off.
9. the fused one-device training step (``parallel.DataParallelTrainer``):
   BERT-base T=1024 batch 8 with Adam from the training phase's weights,
   batch and lr, f32 with TF32 off (its 5 losses within 1e-4 relative of the
   Gluon-Trainer phase's) and bf16, 5 steps each; ResNet-50 v1 batch 32
   with bench.py's SGD recipe, f32 and bf16, 6 steps each. Every counter is
   set to 0 just before each run; each step must launch the update kernel
   (K5 with ``adam_update``'s rule, K4 with ``sgd_mom_update``'s) once, K1-K3
   once a layer, call no registered ``adam_update`` and build the update's
   pointer table at the first step only; the layers must run in the asked
   dtype (the bf16 profile must show the flash kernels' bf16
   instantiations); one more step of each runs under ``torch.profiler``
   (device busy and idle share, launches a step, the update's device ms).
   Then one step of each of the two small models of the train checks
   through ``DataParallelTrainer``, GPU against CPU, same tolerances.
10. the distributed step at world size 1 (``phase_dist_bert_nccl``): one
   rank on the card over NCCL (``_dist_util``'s backend rule), a mesh of
   ranks ``{dp: 1, tp: 1, sp: 1}``, ``data_spec=P("dp", "sp")``, the bucketed
   gradient all-reduce and the loss reduction; BERT-base T=1024 batch 8, Adam,
   f32 and bf16, 5 steps and one profiled; its losses equal ``phase_dp_bert``'s
   to 1e-6 relative, its step time beside that phase's.
11. ``dryrun_multichip``'s step on 8 ranks (``phase_dist_bert_ranks``): the
   layout dp2 x tp2 x sp2 as 8 processes sharing the card over gloo (NCCL
   refuses two ranks on one device), launched by ``_dist_util.launch_local``:
   BERT-base width, 6 of its 12 layers, T=1024, global batch 8, Megatron specs
   (``shard_params_megatron``), ``data_spec=P("dp", "sp")``, Adam, f32, 2
   steps. Every rank launches K1-K3 once a layer a step at (24, 512, 1024,
   64) and K5 once; the losses, the gathered gradients after step 1 and the
   gathered weights after the last step equal the one-rank fused step's on the same
   global batch (1e-5 relative, 1e-3 of each tensor's max, 2e-5). Any rank's
   failure or a hang past the join timeout fails the script. A correctness
   run: gloo stages every collective through the host.
12. ``phase_lc_kernels``: K1, K2 and K3 with the causal mask at the
   long-context path's shape (BH 8, T = Tk = 32768, D 32, f32) and at the
   4-rank hops' (BH 4, 4096 x 4096, D 32: the causal diagonal hop and a full
   hop), each held against its plain version (at T = 8192 if the plain
   backward at the path's shape takes more than 20 s), timed by CUDA-graph
   replay beside its plain version, its bound (the pairs under the mask at
   3xTF32's 165 TFLOP/s) and SDPA's causal forward and whole backward.
13. ``phase_lc_train``: ``recipes.long_context``'s ``LongContextTrainer`` on a
   world-1 NCCL mesh ``{dp: 1, sp: 1}`` at the recipe's configuration
   (``LongContextLM`` 2 layers, units 64, hidden 128, 2 heads, vocab 512;
   T = 32768, batch 4, f32, Adam lr 1e-3), 5 steps and one profiled: K1, K2
   and K3 twice a step, all causal, and K5 once (the sharded update at dp
   1); the loss must fall. ``phase_lc_check``: one step of the same model at
   T = 2048, batch 2, on the card against the CPU.
14. ``phase_lc_ranks``: the trainer at dp2 x sp2 as 4 ranks sharing the card
   over gloo (ring attention over sp, the sharded update over dp), T = 8192,
   global batch 4, 2 steps, against the one-rank step; each rank's K1-K3
   launches by mask and shape follow its hop schedule (rank sp=s: one causal
   hop and s full hops a layer) and K5 runs once a step over its shard's
   segments; the ring's point-to-point bytes beside the reference's estimate.
15. ``phase_zero_bert_ranks``: ``DataParallelTrainer(zero_update=True)`` on 2
   ranks at dp2 over gloo, 2 layers of BERT-base width, T = 1024, batch 4,
   Adam, 2 steps, native, bf16 and int8 on the wire, against
   ``zero_update=False``; each rank's optimizer state about half.

The elastic kill-and-resume (``mxnet_tpu_torch.elastic``), each path with
every counter set to 0 just before it and read just after:

16. ``phase_elastic_bert`` (after phase 9, on a world-1 NCCL group):
   BERT-base width (6 of its 12 layers, ELASTIC_CFG), T=1024 batch 8, f32,
   Adam lr 1e-4 through
   ``elastic.run(trainer, feed, num_steps=8, save_every=3)``: asynchronous
   snapshots at steps 3 and 6 while the steps go on and a final one at 8;
   the step times around the saves, the time ``save()`` held the step path,
   the device copy against its byte bound, the copy to pinned host memory,
   the write. Then a trainer with its own initial weights boots through
   ``resume_or_init`` from step 6: ``(6, "resumed")``, every tensor bitwise
   the saved leaf, steps 7-8 equal to the run's at rtol 1e-6; K1-K3 6
   launches a step and K5 one in both runs.
17. ``phase_elastic_kill``: the same run in a child process, SIGKILLed once
   the step-4 snapshot is committed and the step-6 write has begun; a second
   child resumes from step 4 (the torn directory invisible, then pruned) and
   continues the uninterrupted losses at rtol 1e-6; a third gets SIGTERM and
   ends in a final snapshot, preempted.
18. In phase 11, the dryrun's elastic half on the 8 ranks: a snapshot after
   step 1, a rebuilt trainer on every rank through ``resume_or_init`` ->
   ``(1, "resumed")``, its step equal to step 2 at rtol 1e-6, and the
   manifest's chunks by the ownership rule (each tp shard written once).
19. In phase 12, K1-K3 at D = 16 at the dryrun's 4-rank hops (timed beside
   SDPA) and, f32 and bf16, at D = 16 and D = 80 (zero-padded to 128)
   against their plain versions; ``phase_elastic_lc`` (on phase 13's
   group): ``LongContextTrainer`` at T = 32768 snapshotted after step 2 and
   resumed into a rebuilt trainer, ``(2, "resumed")``, step 3 at rtol 1e-6;
   phase 14 again with ``dryrun_multichip``'s long-context model
   (``LC_DRYRUN_CFG``: units 32, 2 heads, so D = 16).
20. ``phase_elastic_zero_reshard``: phase 15's model with ``zero_update``, a
   dp2 snapshot after step 2 resumed at world 1 and a dp1 snapshot resumed
   on dp2: ``"resharded"``, every Adam lane bitwise the re-canonicalised
   saved lane, step 3 against the saving degree's at TOL_ZERO_LOSS /
   TOL_ZERO_W.

The MoE half of ``dryrun_multichip`` (``parallel.moe``,
``models.MoETransformerLM``, ``recipes.moe``), last:

21. ``phase_moe_train`` (on a world-1 NCCL group), the slice's main path:
   ``MoETransformerLM`` at Switch-Base-8's widths (4 of its 12 layers,
   units 768, hidden 3072, 12 heads, 8 experts, top-1, capacity factor 1.25,
   vocab 32128; 211 M parameters) with seeded weights through ``load_jax_params``,
   ``get_recipe("moe").build_trainer`` on ``{dp: 1, ep: 1}``, Adam lr 1e-4,
   T=1024 batch 8, f32 with TF32 off: 5 steps and one profiled, K1-K3 4
   launches and K5 one a step, the loss falling; tokens/s, TFLOP/s by
   ``bench.py:1874``'s count without its one-hot term, idle share, peak
   memory, dropped assignments. ``phase_moe_check``: one step of 2 such
   layers, batch 1, GPU against CPU, the routing compared first.
22. ``phase_moe_serve``: the forward outside a trainer (``moe_ffn``) at batch
   1 and 8, K1 12 launches each, the batch-1 logits against the CPU's.
23. ``phase_moe_ranks``: 4 ranks sharing the card over gloo: the dryrun's
   ``expert_parallel_moe`` (E 4, D 16, H 32, 32 tokens) against ``moe_ffn``
   on each token shard; the recipe at Switch-Base-8 widths and 2 layers,
   T=1024, global batch 4, 3 steps on dp2 x ep2 against dp4 x ep1 (routing,
   losses, step-3 weights; K1-K3 and K5 counted on every rank); a dp2 x ep2
   snapshot after step 2 resumed on dp1 x ep4: "resharded", step 3 equal.

The 1F1B pipeline of ``dryrun_multichip`` (``parallel.PipelineTrainer``), after
phase 11:

24. ``phase_pp_train`` (on a world-1 NCCL group), the slice's main path:
   ``bert_base(max_length=1024)`` from the training phase's weights through
   ``load_jax_params`` and one forward, ``PipelineTrainer`` on ``{pp: 1, dp:
   1}``, Adam lr 1e-4, batch 8 in M = 4 microbatches, f32 with TF32 off: a
   warm-up, 5 timed steps and one profiled; K1-K3 48 launches a step (12
   layers x 4) and K5 one, the first 3 losses against phase 9's
   DataParallelTrainer batch-8 step at 1e-5 relative, the loss falling;
   step ms, tokens/s, idle share, launches, peak memory; then 3 bf16 steps
   on the bf16 kernels. ``phase_pp_check``: one step of 2 such layers,
   batch 2, M = 2, GPU against CPU at the training checks' tolerances.
25. ``phase_pp_ranks``: 2 ranks sharing the card over gloo: (a) ``{pp: 2}``,
   M = 4, 3 steps against phase 24's (losses 1e-5, step-3 weights after
   ``sync()`` 2e-5), K1-K3 24 launches and K5 one a rank-step, the embed and
   head bitwise equal on the ranks; (b) M = 8 on batch 16: each stage's peak
   memory at M = 4 and 8 (stage 0's within the extra tokens plus 10%),
   beside GPipe's M microbatches of activations; (c) the step-2 snapshot
   resumed on ``{pp: 1, dp: 2}``: "resharded", step 3 equal.
26. ``phase_pp_dryrun``: the dryrun's own pipeline step on 4 ranks, ``{pp:
   2, dp: 2}``, ``bert_tiny(vocab_size=512)``, T 32, batch 8, M = 2, 3 steps
   against the one-rank DataParallelTrainer (losses 1e-5, weights 2e-5).

Tensor parallelism and ZeRO inside the pipeline's stages (``tp_mode=
"partitioned"``: ``parallel.megatron``'s programs; ``"sharded"``; ``zero_update``):

24b. ``phase_pp_tp_train`` (in phase 24's world-1 NCCL group), the slice's
   main path: BERT-base T=1024, batch 8, M = 4, Adam 1e-4, f32 with TF32 off
   through ``PipelineTrainer(tp_axis="tp", tp_mode="partitioned",
   dp_axis="dp", zero_update=True)`` on ``{pp: 1, tp: 1, dp: 1}``: 5 losses
   against phase 24's at 1e-5 relative; K1-K3 48 launches a step at (24,
   1024, 1024, 64) and K5 one a weight decay; 10 timed steps (p50, p90,
   tokens/s), a traced step (host launches, device busy, idle share), peak
   memory, the counted collectives beside the reference's estimates.
26b. ``phase_pp_tp_ranks``: 4 gloo ranks sharing the card, 2 layers of
   BERT-base width, T=1024, batch 4, M = 2, 3 steps, against the tp-1
   partitioned run in this process: ``{tp: 2}`` partitioned (K1-K3 on 6 heads
   a rank) and weight-sharded, losses 1e-5 and weights 2e-5; sp against none
   with dropout 0.1 (the first loss bitwise); ``{tp: 2, dp: 2}`` with ZeRO,
   native and bf16 wire; each tp 2 rank's kept tp-split bytes half their
   whole, its peak memory, its counted weight gathers (0 partitioned) and
   activation all-reduces (M(4L+2)); a tp 2 snapshot resumed on ``{tp: 4}``
   at vocab 30520 (30522 does not split 4 ways), rtol 5e-4. K1-K3 are also
   held and timed in phase 3 at a tp 2 rank's (BH 12, T 1024, D 64).

The pipeline's other schedules and models (GPipe, ``remat``, the interleaved
``virtual_stages``, ``LongContextLM``'s and ``MoETransformerLM``'s
``pipeline_split``):

24c. ``phase_pp_gpipe`` (in phase 24's world-1 NCCL group): BERT-base
   T=1024, batch 8, M = 4, Adam 1e-4, f32, ``schedule="gpipe"`` with and
   without ``remat``: the first loss against phase 24's 1F1B at 1e-5, the
   weights after 3 steps at 2e-5; K1 96 launches a step with remat (the
   backward runs each stage forward again) and 48 without, K2/K3 48, K5
   one; 10 timed steps (p50, p90), a traced one (idle share). Then the peak
   memory at a microbatch of 2 sequences, M 4 and 8, of 1F1B and GPipe with
   and without remat: 1F1B's flat within the extra tokens plus 10%.
24d. ``phase_pp_interleaved`` (same group): ``virtual_stages`` 2 and 3
   (chunks of 6 and 4 layers), 3 steps each against phase 24's losses at
   1e-5, at most min(M, 2v - 1) microbatches in a chunk, no send.
13b. ``phase_pp_lc`` (in phase 13's group): ``LongContextLM.pipeline_split``
   at the recipe's configuration, T 32768, batch 4 in M = 4, Adam 1e-3,
   through the Gluon cells and partitioned at tp 1 (the causal branch of
   ``megatron.cell_forward``): 3 losses against phase 13's
   ``LongContextTrainer`` at 1e-5; causal K1-K3 8 launches a step, K5 one;
   8 timed steps, a traced one. Phase 12 times K1-K3 at its microbatch's
   causal shape (BH 2, T 32768, D 32).
21b. ``phase_pp_moe`` (in phase 21's group): ``MoETransformerLM.pipeline_split``
   at Switch-Base-8 widths, T 1024, batch 8 in M = 4, Adam 1e-4, f32, the
   task loss: 3 steps of K1-K3 16 launches and K5 one, a falling loss, the
   dropped assignments, 8 timed steps, a traced one, peak memory; a 2-layer
   copy, one step of batch 2 in M = 2, GPU against CPU (routing flips
   counted, then the training checks' tolerances).
23b. ``phase_pp_sched_ranks``: 4 gloo ranks sharing the card (correctness
   and memory), 2 steps of batch 4 in M = 2 against the same model's 1F1B at
   pp 1 in this process, losses 1e-5 and weights 2e-5: GPipe at ``{pp: 2}``
   and ``{pp: 2, dp: 2}`` (2 layers of BERT-base width), the interleaved pp
   2 x v 2 (4 layers, stack order [0, 2, 1, 3]), ``LongContextLM``'s split
   at ``{tp: 2}`` partitioned (T 2048) and the MoE's (2 layers of
   Switch-Base-8 width, ``_tp_moe``); stage 0's peak for GPipe and 1F1B at M
   4 and 8.

The compiled paths (``mxnet_tpu_torch.engine``), last. Since this slice the
fused step of phases 9-10, 13, 16-17, 19 and 21 is captured as a CUDA graph
on the card (step 1 of a batch signature eager, step 2 captured, replays
after); the launch counters count the replays, so their checks hold as
before, and every fused step must reach K4/K5 only through the device-scalar
form:

27. ``phase_graph_serve``: ``hybridize(static_alloc=True, static_shape=True)``
   on BERT-base T=1024 (batch 1, 2, 4, 8), ResNet-50 v1 (batch 1, 32) and the
   MoE LM at Switch-Base-8 widths (T 1024, batch 1, 8), f32 with TF32 off:
   GRAPH_TIMED requests eagerly, then hybridized (the first call of a batch
   captures, the others replay): replayed logits bitwise the eager ones,
   fresh tensors, latency p50/p90 of both, K1 launches a request by the
   counter (12), the launches the host issued a request (``torch.profiler``'s
   runtime API records), capture seconds and pool bytes, one capture a batch.
28. ``phase_graph_train``: each fused-step path eagerly and captured, from the
   same weights: BERT-base T=1024 batch 8 Adam (f32, bf16), ResNet-50 batch
   32 SGD momentum (f32, bf16), and on a world-1 NCCL group the NCCL BERT
   step, ``LongContextTrainer`` (T 32768, batch 4) and ``MoETrainer``
   (Switch-Base-8, T 1024, batch 8). GRAPH_CMP_STEPS steps compared, losses
   and every weight bitwise (ResNet-50, long context and MoE under
   ``torch.use_deterministic_algorithms``: their backward otherwise adds with
   atomics in an order that changes from run to run, eager against eager
   too), and GRAPH_SCHED_STEPS steps under a FactorScheduler that changes lr
   every step, bitwise, with one capture; then each mode timed over
   GRAPH_TIMED steps after two (p50/p90), the counters over them (steps x
   the per-step launches), one capture and steps - 1 replays, the launches
   the host issued a step, peak memory, a replay's busy time by CUDA events
   and the idle share. Also a
   snapshot saved under the captured BERT step, resumed by a rebuilt trainer
   whose steps equal the run's bitwise and then installed in place into that
   captured trainer (no capture, the replays bitwise), and a 2-layer BERT with dropout 0.1
   whose 3 captured steps equal 3 eager ones after the same seed.

The rest of A2 (``parallel/overlap.py``, 2-bit compression, ``dist_async``,
``elastic/coordinator.py``), after them:

29. ``phase_overlap_bert``: on a world-1 NCCL group, BERT-base T=1024 batch 8
   Adam through ``DataParallelTrainer(overlap_grads=True,
   overlap_segments=4)`` against the plain fused step from the same weights:
   losses and weights, K1-K3 12 and K5 1 a step, one capture and its replays
   bitwise eager, p50/p90 and idle share of both steps, and a padded trace of
   an eager overlapped step in which the buckets' kernels on the side stream
   start before the backward's last kernel.
30. ``phase_overlap_ranks``: 4 gloo ranks, a narrow BERT (T 1024): the
   overlapped step x {replicated, ZeRO} x {f32, bf16, int8 wire} against
   one rank, and the 2-bit compressed step against one process fed the same
   four shards with the same residual rule, on the card and on the CPU.
31. ``phase_coord_kill``: 3 processes, a gloo dp-3 mesh, 2 layers of
   BERT-base width, ``elastic.run(coordinator=...)`` saving every 2 steps;
   a non-leader SIGKILLed at a step boundary, the survivors' ``peer_dead``
   stop, one agreed step S committed by both; a world-1 resume from S against
   an uninterrupted world-1 run.
32. ``phase_dist_async``: 2 workers under ``gluon.Trainer(kvstore=
   "dist_async")`` (the same model, SGD on the servers), 3 steps: every push
   applied once at its home, the homes' values a host replay of the pushes.

It prints the kernels' JSON line and, last, ``{"ok": true, "device": ...}``.
Without a CUDA device, or without the rest of the repository beside it, it
exits non-zero and prints no result. Its full results, with each phase's
seconds (``phase_seconds``), also go to ``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import contextlib
import json
import os
import shutil
import signal
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
T_START = time.perf_counter()
PHASE_SECONDS = {}                 # phase name -> seconds by this process's clock


def _time_phases():
    """Wrap every ``phase_*`` function of this module so that its seconds
    (summed over its calls) land in PHASE_SECONDS and in the log."""
    for name, fn in list(globals().items()):
        if name.startswith("phase_") and callable(fn):
            def run(*args, _fn=fn, _name=name, **kwargs):
                t = time.perf_counter()
                try:
                    return _fn(*args, **kwargs)
                finally:
                    dt = time.perf_counter() - t
                    PHASE_SECONDS[_name] = PHASE_SECONDS.get(_name, 0.0) + dt
                    log(f"[time] {_name}: {dt:.1f} s ({time.perf_counter() - T_START:.1f} s "
                        f"since the start)")
            globals()[name] = run

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12, "float16": 989e12}
PEAK_TF32_FLOPS = 495e12  # tensor cores; an f32-accurate product by 3xTF32 takes 3

# Tolerances of the kernel against its plain version, same inputs on the
# card: both accumulate in f32 and differ only in the order of summation
# (f32), plus, in bf16/f16, where a 1-ulp difference flips the rounding of p
# or of the output (bf16 ulp is 2^-8 of the value).
TOL_O = {"float32": 1e-4, "bfloat16": 2e-2, "float16": 4e-3}
TOL_LSE = 1e-4
# GPU against CPU logits, both f32 with TF32 off: only summation order
# differs, through 12 layers; logits are O(1).
TOL_LOGITS = 1e-3
# Backward kernels against their plain version, relative to the largest
# |gradient| of the tensor: both accumulate in f32 and differ in the order
# of summation over up to 1024 keys (f32); in bf16/f16 dS and P are rounded
# to the input dtype before each product, where a 1-ulp difference in S flips
# a rounding, and the results are rounded once more (bf16 ulp 2^-8).
TOL_BWD = {"float32": 1e-4, "bfloat16": 3e-2, "float16": 1e-2}
# Fused updates against their plain version, relative to each tensor's
# largest |value|: the same f32 formulas, apart from the compiler's fused
# multiply-adds (a few ulps).
TOL_FUSED = 1e-5
# One training step, GPU against CPU, f32 with TF32 off on both, the same
# weights and batch: only the order of summation differs (cuBLAS against
# the CPU's GEMMs, the kernels against their plain versions), through 2
# layers and a 30522-way decoder. Loss relative; each gradient relative to
# its tensor's largest |g|. Weights after one Adam step: Adam's first step
# moves each element by lr * g / (|g| + 3.2e-7), about lr, whatever the size
# of g, so an element whose gradient lies within the gradient tolerance of 0
# can step either way; those may differ by 2 lr, all others by f32 rounding.
TOL_TRAIN_LOSS = 1e-5
TOL_TRAIN_GRAD = 1e-3
TOL_TRAIN_W = 1e-6


def log(msg):
    print(msg, flush=True)


def phase_device(torch):
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    log(f"[device] {name} x{count}; torch {torch.__version__} cuda {torch.version.cuda}")
    log(smi.splitlines()[0])
    return {"name": name, "count": count, "nvidia_smi": smi.splitlines()[0]}


def phase_build():
    """Every kernel library, one nvcc each, all started together."""
    import threading
    from mxnet_tpu_torch.ops import cuda as cuda_ops
    from mxnet_tpu_torch.ops.cuda import blocked_matmul as bm
    from mxnet_tpu_torch.ops.cuda import flash_attention as fa
    from mxnet_tpu_torch.ops.cuda import fused_optimizer as fo
    loaders = {"flash_attention_fwd": fa._library,
               "flash_attention_bwd": fa._bwd_library,
               "fused_optimizer": fo._library,
               "blocked_matmul": bm._library}
    errors = []

    def load(fn):
        try:
            fn()
        except BaseException as e:  # re-raised below, in the main thread
            errors.append(e)
    t0 = time.perf_counter()
    threads = [threading.Thread(target=load, args=(fn,)) for fn in loaders.values()]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    seconds = time.perf_counter() - t0
    if errors:
        raise errors[0]
    log(f"[build] {len(loaders)} libraries in {seconds:.2f} s (wall, in parallel)")
    out = {"wall_s": seconds}
    for name in loaders:
        info = cuda_ops.build_info.get(name, {})
        out[name] = info.get("seconds")
        log(f"[build] {name}: nvcc {info.get('seconds', float('nan')):.2f} s")
        kernel = None
        for line in info.get("ptxas", "").splitlines():
            if "Compiling entry function" in line:
                kernel = _short_kernel_name(line)
            elif "Used" in line or "spill" in line:
                log(f"  ptxas {kernel}: {line.strip().replace('ptxas info    : ', '')}")
    return out


def _short_kernel_name(line):
    """'flash_bwd_dq_kernel<f32, 64>' out of a ptxas 'Compiling entry' line."""
    import re
    mangled = line.split("'")[1] if "'" in line else line
    m = re.search(r"\d+(flash_\w+?_kernel|multi_tensor_update|blocked_matmul_kernel|"
                  r"blocked_matmul_wgmma_kernel)I",
                  mangled)
    if not m:
        return mangled[-60:]
    rest, args = mangled[m.end():], []
    tokens = [(r"13__nv_bfloat16", "bf16"), (r"6__half", "f16"), (r"f", "f32"),
              (r"S\d*_", None), (r"Lb1E", "adam"), (r"Lb0E", "sgd"),
              (r"Li(\d+)E", "")]
    while rest and not rest.startswith("E"):
        for pat, name in tokens:
            t = re.match(pat, rest)
            if t:
                args.append(args[-1] if name is None else (name or t.group(1)))
                rest = rest[t.end():]
                break
        else:
            break
    return f"{m.group(1)}<{', '.join(args)}>"


def _time_ms(torch, fn, iters, warmup=3):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _attention_inputs(torch, gen, BH, T, Tk, D, dtype):
    dev = torch.device("cuda", 0)
    return tuple(torch.randn((BH, n, D), generator=gen, device=dev).to(dtype)
                 for n in (T, Tk, Tk))


def _bound_ms(BH, T, Tk, D, dtype_name, elem):
    """Least time for K1: its operations (S and PV, 2*BH*T*Tk*D each) or its
    bytes (q, k, v read once, O and LSE written once), whichever is larger.
    In f32 the operations are held to the 3xTF32 tensor-core route, three
    TF32 products each at 495 TFLOP/s (``bound_ms``), with the 67 TFLOP/s FMA
    bound of a kernel on the FMA units beside it (``fma_bound_ms``)."""
    flops = 4.0 * BH * T * Tk * D
    nbytes = elem * (2 * BH * T * D + 2 * BH * Tk * D) + 4 * BH * T
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    out = {}
    if dtype_name == "float32":
        t_ops = 3 * flops / PEAK_TF32_FLOPS * 1e3
        out["fma_bound_ms"] = max(flops / PEAK_FLOPS["float32"] * 1e3, t_bytes)
    else:
        t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
    out["bound_ms"] = max(t_ops, t_bytes)
    out["bound_by"] = "operations" if t_ops >= t_bytes else "bytes"
    return out


# Each rank's flash shapes in phase_dist_bert_ranks (dp2 x tp2 x sp2 on BERT-base,
# global batch 8, T=1024): B/dp=4 sequences, H/tp=6 heads, T/sp=512 query rows
# against the Tk=1024 gathered keys.
SP_CASES = [("sp-shard", 4, 6, 512, 1024, 64, "float32", False),
            ("sp-shard", 4, 6, 512, 1024, 64, "bfloat16", False)]
# (timings key, dtype, B, H, T, Tk, D): the one-device step's shape, the sp
# shard's, the pipeline microbatch's, a tp 2 rank's share of it (6 heads), and
# the widest head the kernels take (D = 256 at BH 24, T 1024: two passes of 128
# output columns)
TIMED_SHAPES = [("float32", "float32", 8, 12, 1024, 1024, 64),
                ("bfloat16", "bfloat16", 8, 12, 1024, 1024, 64),
                ("sp_float32", "float32", 4, 6, 512, 1024, 64),
                ("pp_float32", "float32", 2, 12, 1024, 1024, 64),
                ("pp_bfloat16", "bfloat16", 2, 12, 1024, 1024, 64),
                ("tp_float32", "float32", 2, 6, 1024, 1024, 64),
                ("tp_bfloat16", "bfloat16", 2, 6, 1024, 1024, 64),
                ("d256_float32", "float32", 2, 12, 1024, 1024, 256),
                ("d256_bfloat16", "bfloat16", 2, 12, 1024, 1024, 256)]
# The pipeline's microbatch of 2 sequences in phase_pp_train (BERT-base, T=1024),
# in f32 and then in bf16; a tp 2 rank's 6 heads of it (phase_pp_tp_ranks)
PP_CASES = [("pp-microbatch", 2, 12, 1024, 1024, 64, dt, False)
            for dt in ("float32", "bfloat16")] + \
    [("tp-rank", 2, 6, 1024, 1024, 64, dt, False) for dt in ("float32", "bfloat16")]
# K1-K3 at D = 256 against their plain versions (the TIMED_SHAPES' shape)
HEAD256_CASES = [("head256", 2, 12, 1024, 1024, 256, dt, causal)
                 for dt in ("float32", "bfloat16") for causal in (False, True)]


def phase_kernel(torch):
    from mxnet_tpu_torch.ops.cuda import flash_attention as fa
    import torch.nn.functional as F
    gen = torch.Generator(device="cuda").manual_seed(0)
    dtypes = {"float32": torch.float32, "bfloat16": torch.bfloat16,
              "float16": torch.float16}
    # (label, B, H, T, Tk, D, dtype, causal)
    cases = [("bert-base", 8, 12, 1024, 1024, 64, "float32", False),
             ("bert-base", 8, 12, 1024, 1024, 64, "float32", True),
             ("bert-base", 8, 12, 1024, 1024, 64, "bfloat16", False),
             ("bert-base", 8, 12, 1024, 1024, 64, "bfloat16", True),
             ("ragged", 2, 4, 1000, 1000, 64, "float32", False),
             ("ragged", 2, 4, 1000, 1000, 64, "float32", True),
             ("cross", 2, 2, 96, 224, 32, "float32", False),
             ("head128", 1, 4, 300, 300, 128, "float16", True),
             *SP_CASES, *PP_CASES, *HEAD256_CASES]
    worst = 0.0
    results = []
    with torch.no_grad():
        for label, B, H, T, Tk, D, dname, causal in cases:
            q, k, v = _attention_inputs(torch, gen, B * H, T, Tk, D, dtypes[dname])
            o, lse = fa.flash_attention_fwd(q, k, v, causal)
            torch.cuda.synchronize()
            o_ref, lse_ref = fa.flash_attention_fwd_plain(q, k, v, causal)
            err_o = (o.float() - o_ref.float()).abs().max().item()
            err_lse = (lse - lse_ref).abs().max().item()
            ok = err_o <= TOL_O[dname] and err_lse <= TOL_LSE
            log(f"[kernel] flash_attention_fwd {label} B={B} H={H} T={T} Tk={Tk} "
                f"D={D} {dname} causal={causal}: max|dO|={err_o:.3e} "
                f"(tol {TOL_O[dname]:.0e}) max|dLSE|={err_lse:.3e} "
                f"(tol {TOL_LSE:.0e}) {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"flash_attention_fwd disagrees with its "
                                     f"plain version ({label}, {dname}, causal={causal})")
            if dname == "float32":
                worst = max(worst, err_o, err_lse)
            results.append({"case": label, "B": B, "H": H, "T": T, "Tk": Tk,
                            "D": D, "dtype": dname, "causal": causal,
                            "err_o": err_o, "err_lse": err_lse})

        resources = _fwd_resources(fa)
        timings = {}
        for key, dname, B, H, T, Tk, D in TIMED_SHAPES:
            q, k, v = _attention_inputs(torch, gen, B * H, T, Tk, D, dtypes[dname])
            q4 = q.view(B, H, T, D)
            k4, v4 = (t.view(B, H, Tk, D) for t in (k, v))
            flops = 4.0 * B * H * T * Tk * D
            ms = _time_ms(torch, lambda: fa.flash_attention_fwd(q, k, v), 20)
            graph_ms = _graph_ms(torch, lambda: fa.flash_attention_fwd(q, k, v))
            plain_ms = _time_ms(torch, lambda: fa.flash_attention_fwd_plain(q, k, v), 5)
            lib_ms = _time_ms(torch, lambda: F.scaled_dot_product_attention(q4, k4, v4), 20)
            lib_graph_ms = _graph_ms(torch, lambda: F.scaled_dot_product_attention(q4, k4, v4))
            bound = _bound_ms(B * H, T, Tk, D, dname, q.element_size())
            timings[key] = dict(B=B, H=H, T=T, Tk=Tk, D=D, ms=ms, graph_ms=graph_ms,
                                plain_ms=plain_ms,
                                  library_ms=lib_ms, library_graph_ms=lib_graph_ms,
                                  tflops=flops / graph_ms / 1e9, **bound)
            fma = (f", FMA bound {bound['fma_bound_ms']:.4f}" if dname == "float32" else "")
            log(f"[kernel] flash_attention_fwd B={B} H={H} T={T} Tk={Tk} D={D} {dname}: "
                f"kernel {ms:.4f} ms (graph replay {graph_ms:.4f}, "
                f"{flops / graph_ms / 1e9:.1f} TFLOP/s), plain {plain_ms:.4f} ms, sdpa "
                f"{lib_ms:.4f} ms (graph replay {lib_graph_ms:.4f}), bound "
                f"{bound['bound_ms']:.4f} ms ({bound['bound_by']}){fma}")
    return {"cases": results, "max_abs_err_f32": worst, "timings": timings,
            "resources": resources}


def _bwd_bound_ms(kind, BH, T, Tk, D, dtype_name, elem):
    """Least time for one backward kernel: its operations (dq: S, dP, dQ;
    dkv: S, dP, dV, dK, 2*BH*T*Tk*D each) or its bytes (q, k, v, dO, LSE and
    delta read once, its outputs written once), whichever is larger. In f32
    the operations are held to the 3xTF32 tensor-core route, three TF32
    products each at 495 TFLOP/s (``bound_ms``), with the 67 TFLOP/s FMA
    bound of the earlier kernels beside it (``fma_bound_ms``)."""
    products = 3 if kind == "dq" else 4
    flops = 2.0 * products * BH * T * Tk * D
    reads = elem * (2 * BH * T * D + 2 * BH * Tk * D) + 8 * BH * T
    writes = elem * (BH * T * D if kind == "dq" else 2 * BH * Tk * D)
    t_bytes = (reads + writes) / PEAK_BYTES_PER_S * 1e3
    out = {}
    if dtype_name == "float32":
        t_ops = 3 * flops / PEAK_TF32_FLOPS * 1e3
        out["fma_bound_ms"] = max(flops / PEAK_FLOPS["float32"] * 1e3, t_bytes)
    else:
        t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
    out["bound_ms"] = max(t_ops, t_bytes)
    out["bound_by"] = "operations" if t_ops >= t_bytes else "bytes"
    return out


def _sass_resources(lib_name, kernel_re, required, no_spill, smem_bytes=None):
    """For every instantiation in ``build/lib<lib_name>.so`` whose short
    name matches ``kernel_re``: its HMMA (``mma.sync``), HGMMA (``wgmma``)
    and UTMALDG (TMA load) instructions (``cuobjdump -sass``), registers,
    stack and local memory (``cuobjdump -res-usage``; spills live in local
    memory) and, with ``smem_bytes(match)``, its dynamic shared memory a
    block. Read from the library itself, so the same whether or not this
    process built it. Fails if no kernel matches, or if an instantiation
    lacks an instruction of ``required(match)``, has no resource line, or
    uses stack or local memory where ``no_spill(match)``."""
    import re
    import shutil
    from mxnet_tpu_torch.ops import cuda as cuda_ops
    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    path = str(cuda_ops.BUILD_DIR / f"lib{lib_name}.so")
    counted = ("HMMA", "HGMMA", "UTMALDG")

    def dump(flag):
        return subprocess.run([tool, flag, path], capture_output=True, text=True,
                              timeout=300, check=True).stdout
    kernels, name = {}, None
    for line in dump("-sass").splitlines():
        if "Function :" in line:
            name = _short_kernel_name(line.split("Function :", 1)[1].strip())
            kernels[name] = dict.fromkeys(counted, 0)
        elif name:
            for op in counted:
                if re.search(rf"\b{op}\b", line):
                    kernels[name][op] += 1
    name = None
    for line in dump("-res-usage").splitlines():
        if line.strip().startswith("Function "):
            name = _short_kernel_name(line.strip()[len("Function "):].rstrip(":"))
        elif name and "REG:" in line:
            usage = {k: int(v) for k, v in re.findall(r"([A-Z]+):(\d+)", line)}
            kernels.setdefault(name, dict.fromkeys(counted, 0)).update(
                registers=usage.get("REG"), stack_bytes=usage.get("STACK", 0),
                local_bytes=usage.get("LOCAL", 0))
            name = None
    out, failures = {}, []
    for name, info in sorted(kernels.items()):
        m = re.fullmatch(kernel_re, name)
        if not m:
            continue
        out[name] = info
        if smem_bytes is not None:
            info["smem_bytes"] = smem_bytes(m)
        log(f"[kernel] {name}: " + ", ".join(f"{info[op]} {op}" for op in counted)
            + f", {info.get('registers')} registers, {info.get('stack_bytes')} B stack, "
            f"{info.get('local_bytes')} B local memory"
            + (f", {info['smem_bytes']} B dynamic shared memory a block"
               if smem_bytes is not None else ""))
        failures += [f"{name} has no {op} instruction" for op in required(m) if not info[op]]
        if info.get("registers") is None:
            failures.append(f"{name} has no resource line in cuobjdump -res-usage")
        elif no_spill(m) and info["stack_bytes"] + info["local_bytes"] > 0:
            failures.append(f"{name} uses {info['stack_bytes']} B stack and "
                            f"{info['local_bytes']} B local memory")
    if not out:
        failures.append(f"no kernel matching {kernel_re} in lib{lib_name}.so")
    if failures:
        raise AssertionError("; ".join(failures))
    return out


_DTYPE_CODE = {"f32": 0, "bf16": 1, "f16": 2}


def _bwd_resources(fa):
    """K2/K3: HMMA in every instantiation, no stack or local memory at D=64."""
    lib = fa._bwd_library()
    res = _sass_resources(
        "flash_attention_bwd", r"flash_bwd_(dq|dkv)_kernel<(\w+), (\d+)>",
        required=lambda m: ("HMMA",), no_spill=lambda m: m.group(3) == "64",
        smem_bytes=lambda m: lib.mxt_flash_attention_bwd_smem_bytes(
            int(m.group(1) == "dkv"), int(m.group(3)), _DTYPE_CODE[m.group(2)]))
    for kind in ("dq", "dkv"):
        if not any(n.startswith(f"flash_bwd_{kind}_kernel<") for n in res):
            raise AssertionError(f"flash_bwd_{kind}_kernel not found in the SASS")
    return res


def _fwd_resources(fa):
    """K1: HMMA in every instantiation, no stack or local memory at D=64."""
    lib = fa._library()
    return _sass_resources(
        "flash_attention_fwd", r"flash_fwd_kernel<(\w+), (\d+)>",
        required=lambda m: ("HMMA",), no_spill=lambda m: m.group(2) == "64",
        smem_bytes=lambda m: lib.mxt_flash_attention_fwd_smem_bytes(
            int(m.group(2)), _DTYPE_CODE[m.group(1)]))


def _matmul_resources():
    """K7: HGMMA and UTMALDG in the bf16 and f16 (wgmma + TMA) instantiations;
    f32 is the FMA kernel."""
    res = _sass_resources(
        "blocked_matmul", r"blocked_matmul(_wgmma)?_kernel<(\w+)>",
        required=lambda m: ("HGMMA", "UTMALDG") if m.group(2) != "f32" else (),
        no_spill=lambda m: False)
    for dt in ("bf16", "f16"):
        if f"blocked_matmul_wgmma_kernel<{dt}>" not in res:
            raise AssertionError(f"blocked_matmul_wgmma_kernel<{dt}> not found in the SASS")
    return res


def _graph_ms(torch, fn, iters=20):
    """Device time of one call of ``fn``: the call captured once in a CUDA
    graph, then replayed back to back between CUDA events, so the host's
    launches and allocations are out of the way. (``torch.profiler`` read
    the same times but, started many times in one process, once returned
    every kernel's time scaled down and once no device record at all.)"""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return _time_ms(torch, graph.replay, iters)


def phase_kernel_bwd(torch):
    """K2 and K3 against the plain backward, then timed."""
    from mxnet_tpu_torch.ops.cuda import flash_attention as fa
    import torch.nn.functional as F
    gen = torch.Generator(device="cuda").manual_seed(1)
    dtypes = {"float32": torch.float32, "bfloat16": torch.bfloat16,
              "float16": torch.float16}
    cases = [("bert-base", 8, 12, 1024, 1024, 64, "float32", False),
             ("bert-base", 8, 12, 1024, 1024, 64, "float32", True),
             ("bert-base", 8, 12, 1024, 1024, 64, "bfloat16", False),
             ("bert-base", 8, 12, 1024, 1024, 64, "bfloat16", True),
             ("ragged", 2, 4, 1000, 1000, 64, "float32", False),
             ("ragged", 2, 4, 1000, 1000, 64, "float32", True),
             ("cross", 2, 2, 96, 224, 32, "float32", False),
             ("head128", 1, 4, 300, 300, 128, "float16", True),
             *SP_CASES, *PP_CASES, *HEAD256_CASES]
    results, worst = [], {"dq": 0.0, "dkv": 0.0}
    with torch.no_grad():
        for label, B, H, T, Tk, D, dname, causal in cases:
            q, k, v = _attention_inputs(torch, gen, B * H, T, Tk, D, dtypes[dname])
            do = torch.randn(q.shape, generator=gen, device=q.device).to(q.dtype)
            o, lse = fa.flash_attention_fwd(q, k, v, causal)
            got = fa.flash_attention_bwd(q, k, v, o, lse, do, causal)
            torch.cuda.synchronize()
            expect = fa.flash_attention_bwd_plain(q, k, v, o, lse, do, causal)
            errs = {}
            for name, g, e in zip(("dq", "dk", "dv"), got, expect):
                rel = ((g.float() - e.float()).abs().max()
                       / e.float().abs().max().clamp_min(1e-30)).item()
                errs[name] = {"max_abs": (g.float() - e.float()).abs().max().item(),
                              "rel": rel}
            ok = all(e["rel"] <= TOL_BWD[dname] for e in errs.values())
            log(f"[kernel] flash_attention_bwd {label} B={B} H={H} T={T} Tk={Tk} "
                f"D={D} {dname} causal={causal}: "
                + " ".join(f"max|d{n[1:]}|={e['max_abs']:.3e} ({e['rel']:.1e} of max)"
                           for n, e in errs.items())
                + f" (tol {TOL_BWD[dname]:.0e} of max) {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"flash_attention_bwd disagrees with its plain "
                                     f"version ({label}, {dname}, causal={causal})")
            if dname == "float32":
                worst["dq"] = max(worst["dq"], errs["dq"]["max_abs"])
                worst["dkv"] = max(worst["dkv"], errs["dk"]["max_abs"],
                                   errs["dv"]["max_abs"])
            results.append({"case": label, "B": B, "H": H, "T": T, "Tk": Tk, "D": D,
                            "dtype": dname, "causal": causal, "errors": errs})

    resources = _bwd_resources(fa)
    timings = {}
    for key, dname, B, H, T, Tk, D in TIMED_SHAPES:
        BH = B * H
        q, k, v = _attention_inputs(torch, gen, BH, T, Tk, D, dtypes[dname])
        do = torch.randn(q.shape, generator=gen, device=q.device).to(q.dtype)
        with torch.no_grad():
            o, lse = fa.flash_attention_fwd(q, k, v)
            delta = (do.float() * o.float()).sum(-1)
            dq_ms = _time_ms(torch, lambda: fa.flash_attention_bwd_dq(
                q, k, v, do, lse, delta), 20)
            dkv_ms = _time_ms(torch, lambda: fa.flash_attention_bwd_dkv(
                q, k, v, do, lse, delta), 20)
            plain_ms = _time_ms(torch, lambda: fa.flash_attention_bwd_plain(
                q, k, v, o, lse, do), 5)
        q4 = q.view(B, H, T, D).clone().requires_grad_()
        k4, v4 = (t.view(B, H, Tk, D).clone().requires_grad_() for t in (k, v))
        do4 = do.view(B, H, T, D)

        def sdpa_fwd():
            return F.scaled_dot_product_attention(q4, k4, v4)

        def sdpa_fwd_bwd():
            torch.autograd.grad(sdpa_fwd(), (q4, k4, v4), do4)
        with torch.no_grad():
            sdpa_fwd_ms = _time_ms(torch, sdpa_fwd, 20)
            # the port's whole backward, delta's torch ops included, read as
            # SDPA's is below
            port_ms = _graph_ms(torch, lambda: fa.flash_attention_bwd(
                q, k, v, o, lse, do))
        sdpa_both = _time_ms(torch, sdpa_fwd_bwd, 20)
        # SDPA's whole backward, its preprocessing of dO and O included:
        # forward+backward less the same forward, both replayed from graphs
        sdpa_graph_both = _graph_ms(torch, sdpa_fwd_bwd)
        sdpa_graph_fwd = _graph_ms(torch, sdpa_fwd)
        entry = {"B": B, "H": H, "T": T, "Tk": Tk, "D": D, "plain_ms": plain_ms,
                 "library_ms": sdpa_graph_both - sdpa_graph_fwd,
                 "library_graph_fwd_bwd_ms": sdpa_graph_both,
                 "library_graph_fwd_ms": sdpa_graph_fwd,
                 "port_bwd_ms": port_ms,
                 "library_fwd_bwd_less_fwd_ms": sdpa_both - sdpa_fwd_ms,
                 "library_fwd_bwd_ms": sdpa_both, "library_fwd_ms": sdpa_fwd_ms}
        for kind, ms in (("dq", dq_ms), ("dkv", dkv_ms)):
            entry[kind] = dict(ms=ms, **_bwd_bound_ms(kind, BH, T, Tk, D, dname,
                                                      q.element_size()))
        timings[key] = entry
        fma = (f", FMA bound {entry['dq']['fma_bound_ms']:.4f} / "
               f"{entry['dkv']['fma_bound_ms']:.4f}" if dname == "float32" else "")
        log(f"[kernel] flash_attention_bwd B={B} H={H} T={T} Tk={Tk} D={D} {dname}: "
            f"dQ kernel {dq_ms:.4f} ms (bound {entry['dq']['bound_ms']:.4f}, "
            f"{entry['dq']['bound_by']}), dK/dV kernel {dkv_ms:.4f} ms (bound "
            f"{entry['dkv']['bound_ms']:.4f}, {entry['dkv']['bound_by']}){fma}; "
            f"together {dq_ms + dkv_ms:.4f} ms; plain (both) {plain_ms:.4f} ms")
        log(f"[kernel]   whole backward, replayed from a CUDA graph: port "
            f"{port_ms:.4f} ms (delta's torch ops included), SDPA "
            f"{entry['library_ms']:.4f} ms (forward+backward {sdpa_graph_both:.4f} "
            f"less forward {sdpa_graph_fwd:.4f}); SDPA forward+backward less "
            f"forward by CUDA events around host-paced calls "
            f"{entry['library_fwd_bwd_less_fwd_ms']:.4f} ({sdpa_both:.4f} less "
            f"{sdpa_fwd_ms:.4f})")
    return {"cases": results, "max_abs_err_f32": worst, "timings": timings,
            "resources": resources}


def _ragged_list(torch, gen, dtype, shapes):
    dev = torch.device("cuda", 0)
    return [torch.randn(s, generator=gen, device=dev).to(dtype) for s in shapes]


def _fused_errors(torch, got, expect):
    """Largest |kernel - plain| relative to each tensor's largest |plain|."""
    worst_rel, worst_abs = 0.0, 0.0
    for a, b in zip(sum(map(list, got), []), sum(map(list, expect), [])):
        if b.numel() == 0:
            continue
        d = (a.float() - b.float()).abs().max().item()
        worst_abs = max(worst_abs, d)
        worst_rel = max(worst_rel, d / max(b.float().abs().max().item(), 1e-30))
    return worst_rel, worst_abs


def phase_kernel_fused_ragged(torch):
    """K4 and K5 against their plain versions on a small ragged list: odd
    sizes, a chunk boundary, an empty and a misaligned tensor, three dtypes."""
    from mxnet_tpu_torch.ops.cuda import fused_optimizer as fo
    gen = torch.Generator(device="cuda").manual_seed(2)
    shapes = [(1000, 77), (3,), (16384,), (16385,), (0,), (5, 1)]
    out = []
    for wname, sname in (("float32", "float32"), ("bfloat16", "float32"),
                         ("float16", "float16")):
        wd_t, sd_t = getattr(torch, wname), getattr(torch, sname)
        w = _ragged_list(torch, gen, wd_t, shapes)
        w.append(torch.randn(1001, generator=gen, device="cuda").to(wd_t)[1:])
        g = _ragged_list(torch, gen, wd_t, shapes + [(1000,)])
        m = [0.1 * t for t in _ragged_list(torch, gen, sd_t, shapes + [(1000,)])]
        v = [0.01 * t.abs() for t in _ragged_list(torch, gen, sd_t, shapes + [(1000,)])]
        tol = TOL_FUSED if wname == "float32" else 1e-2
        for name, fn, plain, args, kw in (
                ("fused_adam", fo.fused_adam_apply, fo.fused_adam_apply_plain,
                 (w, g, m, v), {"lr": 1e-2, "wd": 0.01, "t": 3}),
                ("fused_sgd", fo.fused_sgd_apply, fo.fused_sgd_apply_plain,
                 (w, g, m), {"lr": 1e-2, "momentum": 0.9, "wd": 0.01})):
            got = fn(*args, **kw)
            torch.cuda.synchronize()
            rel, _ = _fused_errors(torch, got, plain(*args, **kw))
            ok = rel <= tol
            log(f"[kernel] {name} ragged list of {len(w)} ({wname} weights, "
                f"{sname} states): max|d| {rel:.2e} of max (tol {tol:.0e}) "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"{name} disagrees with its plain version")
            out.append({"kernel": name, "weights": wname, "states": sname,
                        "rel_err": rel})
    return out


def phase_serve(torch):
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.convert import load_jax_params, seeded_params
    from mxnet_tpu_torch.models import bert_base
    from mxnet_tpu_torch.ops.cuda import flash_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("[serve] bert_base(max_length=1024) f32, TF32 off "
        f"(matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}, "
        f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32})")
    T, n_layers = 1024, 12
    t0 = time.perf_counter()
    net = bert_base(max_length=T)
    params = seeded_params(net, seed=0)
    net.initialize(ctx=mx.gpu(0))
    load_jax_params(net, params)
    torch.cuda.synchronize()
    log(f"[serve] model ready in {time.perf_counter() - t0:.2f} s, "
        f"{sum(p.size for p in params.values())} parameters")
    rs = np.random.RandomState(1)
    batches = [1, 1, 2, 4, 8]   # the first batch-1 request is the warm-up
    requests = [rs.randint(0, 30522, size=(b, T)).astype(np.int32) for b in batches]

    fa.flash_attention_fwd.launches = 0   # every kernel's count, just before
    torch.cuda.reset_peak_memory_stats()
    served = []
    first_logits = None
    for i, tokens in enumerate(requests):
        before = fa.flash_attention_fwd.launches
        t_start = time.perf_counter()
        logits = net(mx.nd.array(tokens, ctx=mx.gpu(0), dtype="int32"))
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t_start) * 1e3
        launched = fa.flash_attention_fwd.launches - before
        finite = bool(torch.isfinite(logits._data).all().item())
        B = tokens.shape[0]
        log(f"[serve] request {i} batch={B} T={T}: {ms:.2f} ms, "
            f"{B * T / ms * 1e3:.0f} tokens/s, flash launches {launched}, "
            f"logits {logits.shape} finite={finite}"
            + (" (warm-up)" if i == 0 else ""))
        if launched != n_layers:
            raise AssertionError(f"expected {n_layers} flash launches, got {launched}")
        if not finite or logits.shape != (B, T, 30522):
            raise AssertionError("bad logits")
        if i == 0:
            first_logits = logits.asnumpy()
        served.append({"batch": B, "ms": ms, "tokens_per_s": B * T / ms * 1e3,
                       "warmup": i == 0})
        del logits
    launches = {"flash_attention_fwd": fa.flash_attention_fwd.launches}
    peak = torch.cuda.max_memory_allocated()
    log(f"[serve] launches {launches}; peak device memory {peak / 2**30:.3f} GiB")
    last = mx.nd.array(requests[-1], ctx=mx.gpu(0), dtype="int32")
    profile = _profile(torch, "batch=8 request", lambda: net(last))

    t0 = time.perf_counter()
    net_cpu = bert_base(max_length=T)
    net_cpu.initialize(ctx=mx.cpu())
    load_jax_params(net_cpu, params)
    ref = net_cpu(mx.nd.array(requests[0], ctx=mx.cpu(), dtype="int32")).asnumpy()
    diff = float(np.abs(ref - first_logits).max())
    log(f"[serve] batch-1 logits, GPU vs CPU: max|d|={diff:.3e} "
        f"(tol {TOL_LOGITS:.0e}, max|logit|={np.abs(ref).max():.3f}, "
        f"CPU run {time.perf_counter() - t0:.1f} s)")
    if not diff <= TOL_LOGITS:
        raise AssertionError("GPU logits disagree with the CPU run")
    return {"requests": served, "launches": launches, "peak_bytes": peak,
            "cpu_max_abs_diff": diff, "profile": profile}


def _kernel_group(name):
    low = name.lower()
    if "flash_fwd_kernel" in low:
        return "flash_attention_fwd"
    if "flash_bwd_dq_kernel" in low:
        return "flash_attention_bwd_dq"
    if "flash_bwd_dkv_kernel" in low:
        return "flash_attention_bwd_dkv"
    if "multi_tensor_update" in low:
        return "fused_optimizer"
    if "blocked_matmul_kernel" in low:
        return "blocked_matmul"
    if any(s in low for s in ("batch_norm", "batchnorm", "bn_fw", "bn_bw", "welford")):
        return "batchnorm"
    if any(s in low for s in ("conv", "fprop", "dgrad", "wgrad", "implicit", "winograd",
                              "cudnn")):
        return "convolution (cuDNN)"
    if any(s in low for s in ("gemm", "xmma", "cutlass", "cublas", "nvjet")):
        return "matmul (cuBLAS)"
    if "pool" in low:
        return "pooling"
    return "other (elementwise, norms, copies)"


def _profile(torch, label, fn):
    """``fn()`` once under torch.profiler: device time by kernel group and
    the device's busy share of the wall time."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [(e.key, e.self_device_time_total, e.count)
               for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.self_device_time_total > 0]
    if not kernels:
        log("[profile] no device events recorded: device time not measured")
        return {"wall_us": wall_us, "device_us": None}
    device_us = sum(k[1] for k in kernels)
    groups, counts = {}, {}
    for name, us, n in kernels:
        g = _kernel_group(name)
        groups[g] = groups.get(g, 0.0) + us
        counts[g] = counts.get(g, 0) + n
    log(f"[profile] {label}: wall {wall_us / 1e3:.2f} ms, device busy "
        f"{device_us / 1e3:.2f} ms ({100 * device_us / wall_us:.1f}%)")
    for g, us in sorted(groups.items(), key=lambda kv: -kv[1]):
        log(f"[profile]   {g}: {us / 1e3:.2f} ms in {counts[g]} launches "
            f"({100 * us / device_us:.1f}% of device time)")
    top = sorted(kernels, key=lambda k: -k[1])[:8]
    for name, us, n in top:
        log(f"[profile]   {us / 1e3:8.3f} ms x{n:<4d} {name[:90]}")
    return {"wall_us": wall_us, "device_us": device_us, "groups_us": groups,
            "group_launches": counts, "idle_share": 1.0 - device_us / wall_us,
            "flash_kernels": sorted({k for k, _, _ in kernels if "flash_" in k}),
            "top": [{"kernel": k, "us": us, "count": n} for k, us, n in top]}


def _idle_from_steps(label, profile, steps):
    """Add the device's idle share of an unprofiled step: 1 - busy / the
    median unprofiled step after the warm-up. The profiled step's own wall
    time (``idle_share``) holds the profiler's cost as well."""
    if profile.get("device_us") is None:
        return profile
    ms = float(np.median([st["ms"] for st in steps if not st["warmup"]]))
    profile["step_median_ms"] = ms
    profile["idle_share_steps"] = 1.0 - profile["device_us"] / 1e3 / ms
    log(f"[profile] {label}: busy {profile['device_us'] / 1e3:.2f} ms of the median "
        f"unprofiled step's {ms:.2f} ms: idle {100 * profile['idle_share_steps']:.1f}% "
        f"(of the profiled step's wall: {100 * profile['idle_share']:.1f}%)")
    return profile


def _step_profile(torch, label, fn, steps):
    """``_profile`` of one more step, which must record device time (a
    session that records none is tried twice more), with the idle share of
    the unprofiled ``steps``."""
    for _ in range(3):
        profile = _profile(torch, label, fn)
        if profile["device_us"] is not None:
            return _idle_from_steps(label, profile, steps)
    raise AssertionError(f"{label}: the profiler recorded no device time in 3 sessions")


def _bert_trainer(mx, net, lr):
    return (mx.gluon.loss.SoftmaxCrossEntropyLoss(),
            mx.gluon.Trainer(net.collect_params(), "adam", {"learning_rate": lr}))


def _train_step(mx, net, loss_fn, trainer, x, y):
    with mx.autograd.record():
        loss = loss_fn(net(x), y)
    loss.backward()
    trainer.step(x.shape[0])
    return loss


def phase_train(torch):
    """BERT-base training at T=1024, batch 8, through Gluon on gpu(0)."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.convert import load_jax_params, seeded_params
    from mxnet_tpu_torch.models import bert_base
    from mxnet_tpu_torch.ops.cuda import flash_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    B, T, n_layers, V = 8, 1024, 12, 30522
    t0 = time.perf_counter()
    net = bert_base(max_length=T)
    params = seeded_params(net, seed=0)
    net.initialize(ctx=mx.gpu(0))
    load_jax_params(net, params)
    loss_fn, trainer = _bert_trainer(mx, net, 1e-4)
    rs = np.random.RandomState(2)
    x = mx.nd.array(rs.randint(0, V, size=(B, T)).astype(np.int32), ctx=mx.gpu(0),
                    dtype="int32")
    y = mx.nd.array(rs.randint(0, V, size=(B, T)).astype(np.int32), ctx=mx.gpu(0),
                    dtype="int32")
    torch.cuda.synchronize()
    log(f"[train] bert_base(max_length={T}) f32, TF32 off "
        f"(matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}, "
        f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}), "
        f"{sum(p.size for p in params.values())} parameters in {len(params)} "
        f"tensors, Trainer adam lr 1e-4, batch {B}x{T}; ready in "
        f"{time.perf_counter() - t0:.2f} s")
    counters = (fa.flash_attention_fwd, fa.flash_attention_bwd_dq,
                fa.flash_attention_bwd_dkv)
    for c in counters:           # every kernel's count, just before the path
        c.launches = 0
    torch.cuda.reset_peak_memory_stats()
    steps = []
    for i in range(5):           # step 0 is the warm-up
        before = [c.launches for c in counters]
        t_start = time.perf_counter()
        loss = _train_step(mx, net, loss_fn, trainer, x, y)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t_start) * 1e3
        launched = [c.launches - b for c, b in zip(counters, before)]
        value = float(loss.mean().asscalar())
        log(f"[train] step {i}: {ms:.2f} ms, {B * T / ms * 1e3:.0f} tokens/s, "
            f"loss {value:.6f}, launches fwd/dQ/dKV {launched}"
            + (" (warm-up)" if i == 0 else ""))
        if launched != [n_layers] * 3:
            raise AssertionError(f"expected {n_layers} launches of each flash "
                                 f"kernel per step, got {launched}")
        if not np.isfinite(value):
            raise AssertionError("training loss is not finite")
        steps.append({"ms": ms, "tokens_per_s": B * T / ms * 1e3, "loss": value,
                      "warmup": i == 0})
    launches = {c.__name__: c.launches for c in counters}
    peak = torch.cuda.max_memory_allocated()
    log(f"[train] launches {launches}; peak device memory {peak / 2**30:.3f} GiB; "
        f"loss {steps[0]['loss']:.6f} -> {steps[-1]['loss']:.6f}")
    if not steps[-1]["loss"] < steps[0]["loss"]:
        raise AssertionError("the loss did not fall on a repeated batch")
    profile = _idle_from_steps("training step", _profile(
        torch, "training step, batch 8",
        lambda: _train_step(mx, net, loss_fn, trainer, x, y)), steps)
    weights = [p.data()._data for p in net.collect_params().values()]
    grads = [p.grad()._data for p in net.collect_params().values()]
    batch = (x.asnumpy().astype(np.int32), y.asnumpy().astype(np.int32))
    return {"steps": steps, "launches": launches, "peak_bytes": peak,
            "profile": profile}, weights, grads, params, batch


def _dp_trainer(mx, net, ctx, optimizer, params, dtype=None):
    """The fused one-device step on ``ctx`` (``parallel.DataParallelTrainer``)."""
    return mx.parallel.DataParallelTrainer(
        net, mx.gluon.loss.SoftmaxCrossEntropyLoss(), optimizer, params, dtype=dtype,
        mesh=mx.parallel.make_mesh({"dp": 1}, devices=[ctx]))


def _tiny_bert_step(mx, ctx, params, x, y, dp=False):
    from mxnet_tpu_torch.convert import load_jax_params
    from mxnet_tpu_torch.models import BertModel
    net = BertModel(num_layers=2, max_length=1024)
    net.initialize(ctx=ctx)
    load_jax_params(net, params)
    xs, ys = (mx.nd.array(a, ctx=ctx, dtype="int32") for a in (x, y))
    keys = net._collect_params_with_prefix()
    if dp:
        trainer = _dp_trainer(mx, net, ctx, "adam", {"learning_rate": 1e-4})
        loss = float(trainer.step(xs, ys))
        grads = {k: p.grad().asnumpy() for k, p in keys.items()}
    else:
        loss_fn, trainer = _bert_trainer(mx, net, 1e-4)
        with mx.autograd.record():
            out = loss_fn(net(xs), ys)
        out.backward()
        loss = float(out.asnumpy()[0])
        grads = {k: p.grad().asnumpy() for k, p in keys.items()}
        trainer.step(1)
    weights = {k: p.data().asnumpy() for k, p in keys.items()}
    return loss, grads, weights


def _step_agreement(gpu, cpu, lr):
    """(loss, grads, weights) of one Adam step on two devices against each
    other: loss relative, each gradient relative to its tensor's max, the
    weights absolute except where the gradient lies within the gradient
    tolerance of 0, whose elements Adam may step either way (2 lr)."""
    loss_rel = abs(gpu[0] - cpu[0]) / abs(cpu[0])
    grad_rel = max(float(np.abs(gpu[1][k] - g).max()) / max(float(np.abs(g).max()), 1e-30)
                   for k, g in cpu[1].items())
    w_strict, loose, n_loose = 0.0, 0.0, 0
    for k, w in cpu[2].items():
        g = cpu[1][k]
        d = np.abs(gpu[2][k] - w)
        near0 = np.abs(g) <= TOL_TRAIN_GRAD * max(np.abs(g).max(), 1e-30)
        w_strict = max(w_strict, float(d[~near0].max()) if (~near0).any() else 0.0)
        if near0.any():
            loose = max(loose, float(d[near0].max()))
            n_loose += int((near0 & (g != 0)).sum())
    ok = (loss_rel <= TOL_TRAIN_LOSS and grad_rel <= TOL_TRAIN_GRAD
          and w_strict <= TOL_TRAIN_W and loose <= 2.0 * lr * 1.001
          and set(gpu[1]) == set(cpu[1]))
    return {"loss_rel": loss_rel, "grad_rel": grad_rel, "weight_max_abs": w_strict,
            "near_zero_grad_elements": n_loose, "near_zero_weight_max_abs": loose, "ok": ok}


def phase_train_check(torch, dp=False):
    """One step of a 2-layer model of BERT-base width, GPU against CPU,
    through ``gluon.Trainer`` or (``dp``) ``DataParallelTrainer``."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.convert import seeded_params
    from mxnet_tpu_torch.models import BertModel
    t0 = time.perf_counter()
    params = seeded_params(BertModel(num_layers=2, max_length=1024), seed=5)
    rs = np.random.RandomState(6)
    x = rs.randint(0, 30522, size=(1, 1024)).astype(np.int32)
    y = rs.randint(0, 30522, size=(1, 1024)).astype(np.int32)
    gpu = _tiny_bert_step(mx, mx.gpu(0), params, x, y, dp)
    cpu = _tiny_bert_step(mx, mx.cpu(), params, x, y, dp)
    res = _step_agreement(gpu, cpu, 1e-4)
    log(f"[{'dp-' if dp else ''}train-check] 2 layers of BERT-base width, T=1024, "
        f"batch 1, one Adam step{' (DataParallelTrainer)' if dp else ''}, GPU vs CPU: loss "
        f"{gpu[0]:.6f} vs {cpu[0]:.6f} (rel {res['loss_rel']:.2e}, tol {TOL_TRAIN_LOSS:.0e}); "
        f"gradients max|d| {res['grad_rel']:.2e} of the tensor's max (tol "
        f"{TOL_TRAIN_GRAD:.0e}); weights max|d| {res['weight_max_abs']:.2e} (tol "
        f"{TOL_TRAIN_W:.0e}), {res['near_zero_grad_elements']} elements with a nonzero |g| "
        f"within the gradient tolerance of 0 up to {res['near_zero_weight_max_abs']:.2e} "
        f"(tol 2 lr = 2e-4); {'ok' if res['ok'] else 'FAIL'} "
        f"({time.perf_counter() - t0:.1f} s)")
    if not res.pop("ok"):
        raise AssertionError("GPU training step disagrees with the CPU run")
    return dict(res, loss_gpu=gpu[0], loss_cpu=cpu[0])


def phase_fused(torch, weights, grads):
    """K4 and K5 on the trained BERT-base's weights and last gradients."""
    from mxnet_tpu_torch.ops.cuda import fused_optimizer as fo
    n = sum(w.numel() for w in weights)
    log(f"[fused] BERT-base: {len(weights)} tensors, {n} f32 parameters")
    w0 = [w.detach().clone() for w in weights]
    g0 = [g.detach().clone() for g in grads]

    def zeros():
        return [torch.zeros_like(w) for w in w0]

    adam_kw = {"lr": 1e-4, "wd": 0.01}
    sgd_kw = {"lr": 1e-2, "momentum": 0.9, "wd": 0.01}
    m0, v0, mom0 = zeros(), zeros(), zeros()

    fo.fused_adam_apply.launches = 0      # every kernel's count, just before
    fo.fused_sgd_apply.launches = 0
    adam1 = fo.fused_adam_apply(w0, g0, m0, v0, t=1, **adam_kw)
    adam2 = fo.fused_adam_apply(adam1[0], g0, adam1[1], adam1[2], t=2, **adam_kw)
    sgd1 = fo.fused_sgd_apply(w0, g0, mom0, **sgd_kw)
    sgd2 = fo.fused_sgd_apply(sgd1[0], g0, sgd1[1], **sgd_kw)
    torch.cuda.synchronize()
    launches = {"fused_adam": fo.fused_adam_apply.launches,
                "fused_sgd": fo.fused_sgd_apply.launches}
    log(f"[fused] launches {launches} for 2 calls each")
    if launches != {"fused_adam": 2, "fused_sgd": 2}:
        raise AssertionError("expected exactly one launch per fused call")

    errs = {}
    for name, got, expect in (
            ("fused_adam", adam1, fo.fused_adam_apply_plain(w0, g0, m0, v0, t=1, **adam_kw)),
            ("fused_adam", adam2, fo.fused_adam_apply_plain(
                adam1[0], g0, adam1[1], adam1[2], t=2, **adam_kw)),
            ("fused_sgd", sgd1, fo.fused_sgd_apply_plain(w0, g0, mom0, **sgd_kw)),
            ("fused_sgd", sgd2, fo.fused_sgd_apply_plain(sgd1[0], g0, sgd1[1], **sgd_kw))):
        rel, abs_ = _fused_errors(torch, got, expect)
        prev = errs.get(name, (0.0, 0.0))
        errs[name] = (max(prev[0], rel), max(prev[1], abs_))
    for name, (rel, abs_) in errs.items():
        ok = rel <= TOL_FUSED
        log(f"[fused] {name} vs plain, t=1 and t=2: max|d| {abs_:.3e} "
            f"({rel:.2e} of the tensor's max, tol {TOL_FUSED:.0e}) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{name} disagrees with its plain version")

    # the torch fused optimizers compute the same first step
    pw = [torch.nn.Parameter(w.clone()) for w in w0]
    for p, g in zip(pw, g0):
        p.grad = g.clone()
    lib_adam = torch.optim.Adam(pw, lr=adam_kw["lr"], weight_decay=adam_kw["wd"],
                                fused=True)
    lib_adam.step()
    d_adam = max((p.detach() - w).abs().max().item() for p, w in zip(pw, adam1[0]))
    ps = [torch.nn.Parameter(w.clone()) for w in w0]
    for p, g in zip(ps, g0):
        p.grad = g.clone()
    lib_sgd = torch.optim.SGD(ps, lr=sgd_kw["lr"], momentum=sgd_kw["momentum"],
                              weight_decay=sgd_kw["wd"], fused=True)
    lib_sgd.step()
    d_sgd = max((p.detach() - w).abs().max().item() for p, w in zip(ps, sgd1[0]))
    log(f"[fused] first step against torch.optim (fused=True): Adam max|dw| "
        f"{d_adam:.3e}, SGD max|dw| {d_sgd:.3e}")
    # sgd_update's rule (rescale 1, clip off) is torch's SGD without momentum
    pn = [torch.nn.Parameter(w.clone()) for w in w0]
    for p, g in zip(pn, g0):
        p.grad = g.clone()
    lib_sgd_nomom = torch.optim.SGD(pn, lr=1e-3, momentum=0.0, weight_decay=0.01,
                                    fused=True)

    # timing: in place (out= the inputs), so the pointer table is cached
    wa, ma, va = [w.clone() for w in w0], zeros(), zeros()
    ws, ms = [w.clone() for w in w0], zeros()
    adam_ms = _time_ms(torch, lambda: fo.fused_adam_apply(
        wa, g0, ma, va, t=2, out=(wa, ma, va), **adam_kw), 10)
    sgd_ms = _time_ms(torch, lambda: fo.fused_sgd_apply(
        ws, g0, ms, out=(ws, ms), **sgd_kw), 10)
    adam_plain = _time_ms(torch, lambda: fo.fused_adam_apply_plain(
        w0, g0, m0, v0, t=2, **adam_kw), 3)
    sgd_plain = _time_ms(torch, lambda: fo.fused_sgd_apply_plain(w0, g0, mom0, **sgd_kw), 3)
    adam_lib = _time_ms(torch, lib_adam.step, 10)
    sgd_lib = _time_ms(torch, lib_sgd.step, 10)
    sgd_nomom_lib = _time_ms(torch, lib_sgd_nomom.step, 10)
    del pn, lib_sgd_nomom
    # the fused training step's rules (the registered ops' arithmetic), two
    # calls each with lr changed between them; then the device-scalar form,
    # which the training paths run, timed in place beside the by-value form
    step_rules = {
        "fused_adam_update": (lambda w, st, lr: fo.fused_adam_update(
            w, g0, *st, lr, wd=0.01, clip_gradient=1.0, out=(w, *st)), 2, 28, adam_lib),
        "fused_sgd_mom_update": (lambda w, st, lr: fo.fused_sgd_mom_update(
            w, g0, *st, lr, momentum=0.9, wd=0.01, out=(w, *st)), 1, 20, sgd_lib),
        "fused_sgd_update": (lambda w, st, lr: fo.fused_sgd_update(
            w, g0, lr, wd=0.01, out=(w,)), 0, 12, sgd_nomom_lib)}
    rule_ms, hyper_form = {}, {}
    for name, (call, n_states, per, lib) in step_rules.items():
        plain = getattr(fo, name + "_plain")
        w, st = [t.clone() for t in w0], [zeros() for _ in range(n_states)]
        worst = (0.0, 0.0)
        for lr in (1e-3, 3e-4):
            expect = plain(w, g0, *st, lr, **({"momentum": 0.9} if n_states == 1 else {}),
                           wd=0.01, **({"clip_gradient": 1.0} if n_states == 2 else {}))
            got = call(w, st, lr)
            rel, abs_ = _fused_errors(torch, got, expect)
            worst = (max(worst[0], rel), max(worst[1], abs_))
        ok = worst[0] <= TOL_FUSED
        log(f"[fused] {name} (the fused step's rule) vs plain, two calls: max|d| "
            f"{worst[1]:.3e} ({worst[0]:.2e} of the tensor's max, tol {TOL_FUSED:.0e}) "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{name} disagrees with its plain version")
        errs[name] = worst
        st0 = [zeros() for _ in range(n_states)]
        plain_ms = _time_ms(torch, lambda: plain(w0, g0, *st0, 1e-3), 3)
        hyper_form[name] = _fused_hyper_form(torch, fo, name, w, st, g0)
        rule_ms[name] = (hyper_form[name]["hyper_ms"], plain_ms, lib, per)
    out = {"parameters": n, "tensors": len(w0), "launches": launches,
           "first_step_vs_torch": {"adam": d_adam, "sgd": d_sgd}}
    for name, ms, plain, lib, per in (("fused_adam", adam_ms, adam_plain, adam_lib, 28),
                                      ("fused_sgd", sgd_ms, sgd_plain, sgd_lib, 20),
                                      *[(k, *v) for k, v in rule_ms.items()]):
        bound = per * n / PEAK_BYTES_PER_S * 1e3
        out[name] = {"ms": ms, "plain_ms": plain, "library_ms": lib, "bound_ms": bound,
                     "bound_by": "bytes", "max_abs_err": errs[name][1],
                     "rel_err": errs[name][0], **hyper_form.get(name, {})}
        log(f"[fused] {name}: kernel {ms:.4f} ms, plain {plain:.4f} ms, torch.optim "
            f"fused {lib if lib is None else round(lib, 4)} ms, bound {bound:.4f} ms "
            f"(bytes: {per} B x {n}), {per * n / ms / 1e9:.3f} TB/s")
    return out


FUSED_RULE_KW = {"fused_adam_update": dict(lr=1e-3, beta1=0.9, beta2=0.999, epsilon=1e-8,
                                           wd=0.01, clip_gradient=1.0),
                 "fused_sgd_mom_update": dict(lr=1e-3, momentum=0.9, wd=0.01),
                 "fused_sgd_update": dict(lr=1e-3, wd=0.01)}
FUSED_REPLAYS = 10


def _fused_by_value(fo, name, kw):
    """The fused step's rule ``name`` through the kernel's by-value entry
    point (``mxt_fused_sgd``/``mxt_fused_adam``: the scalars as launch
    arguments), in place; its launches are not counted."""
    clip = kw.get("clip_gradient", -1.0)
    if name == "fused_adam_update":
        sc = (kw["lr"], kw["beta1"], kw["beta2"], kw["epsilon"], kw["wd"], 1.0, 1.0, 1.0, clip)
        return lambda ws, g, sts: fo._adam(name, ws, g, *sts, sc, (ws, *sts))
    rule = fo._RULE_SGD_MOM if name == "fused_sgd_mom_update" else fo._RULE_SGD
    sc = (kw["lr"], kw.get("momentum", 0.0), kw["wd"], 1.0, clip)
    return lambda ws, g, sts: fo._sgd(name, rule, ws, g, sts[0] if sts else None, sc,
                                      (ws, *sts))


def _fused_hyper_form(torch, fo, name, w, st, g0):
    """The fused step's rule ``name`` in its device-scalar form
    (``<name>_hyper``, the scalars read from a device tensor: the form the
    training paths run) against the kernel's by-value form on the same
    lists: bitwise, both timed in place by CUDA events and by graph replay;
    the device form's graph is captured through ``engine.capture`` and its
    launches a replay read from the rule's counter over FUSED_REPLAYS
    replays."""
    from mxnet_tpu_torch import engine
    kw = FUSED_RULE_KW[name]
    hyper = torch.tensor(fo.hyper_values(**kw), device=w[0].device)
    fn, counter = getattr(fo, name + "_hyper"), getattr(fo, name)
    value = _fused_by_value(fo, name, kw)

    def hcall(ws, sts):
        return fn(ws, g0, *sts, hyper, out=(ws, *sts))
    wa, sa = [t.clone() for t in w], [[t.clone() for t in s_] for s_ in st]
    wb, sb = [t.clone() for t in w], [[t.clone() for t in s_] for s_ in st]
    value(wa, g0, sa)
    hcall(wb, sb)
    torch.cuda.synchronize()
    equal = all(torch.equal(a, b) for a, b in zip(wa + sum(sa, []), wb + sum(sb, [])))
    del wa, sa, wb, sb
    value_ms = _time_ms(torch, lambda: value(w, g0, st), 10)
    hyper_ms = _time_ms(torch, lambda: hcall(w, st), 10)
    value_graph_ms = _graph_ms(torch, lambda: value(w, g0, st))
    with engine.side_stream(w[0].device):
        hcall(w, st)
    entry = engine.capture(lambda: hcall(w, st), ("fused_probe", name), w[0].device,
                           owner=hcall)
    torch.cuda.synchronize()
    before = counter.launches
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(FUSED_REPLAYS):
        entry.replay()
    end.record()
    torch.cuda.synchronize()
    hyper_graph_ms = start.elapsed_time(end) / FUSED_REPLAYS
    per_replay = (counter.launches - before) / FUSED_REPLAYS
    counter.launches = before                  # comparison launches do not count
    del entry
    log(f"[fused] {name} device-scalar form against by-value: "
        f"{'bitwise equal' if equal else 'DIFFERS'}; in place {hyper_ms:.4f} ms against "
        f"{value_ms:.4f} ms; graph replay {hyper_graph_ms:.4f} against {value_graph_ms:.4f} "
        f"ms; {per_replay:g} launches a replay (counter over {FUSED_REPLAYS} replays)")
    if not equal or per_replay != 1:
        raise AssertionError(f"{name}: the device-scalar form differs from the by-value one "
                             f"or launched {per_replay} times a replay")
    return {"hyper_ms": hyper_ms, "value_ms": value_ms, "hyper_graph_ms": hyper_graph_ms,
            "value_graph_ms": value_graph_ms, "hyper_equal_value": equal,
            "launches_per_replay": per_replay}


# --- K6 (mx.rtc), K7 (blocked matmul probe), ResNet-50 ----------------------

def phase_rtc(torch):
    """K6: the example kernels compiled with NVRTC and launched through
    ``mx.rtc``, each against its plain version; axpy timed on 2^26 f32 by
    CUDA events and by CUDA-graph replay beside ``torch.add``, on a grid
    sized to the data and the card, and checked exactly on views off a
    16-byte boundary; an empty launch's host time."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import rtc
    t0 = time.perf_counter()
    module = rtc.CudaModule(rtc.EXAMPLES_SOURCE, exports=rtc.EXAMPLES_EXPORTS)
    compile_ms = (time.perf_counter() - t0) * 1e3
    n = 1 << 26
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    grid, block = rtc.axpy_launch_dims(n, sms)
    gen = torch.Generator(device="cuda").manual_seed(3)
    x, y = (mx.nd.NDArray(torch.randn(n, generator=gen, device="cuda")) for _ in range(2))
    rows, cols = 1000, 777
    m = mx.nd.NDArray(torch.randn((rows, cols), generator=gen, device="cuda"))
    s_in = mx.nd.NDArray(torch.randn(4096, generator=gen, device="cuda"))
    s_out = mx.nd.zeros((4096,), ctx=mx.gpu(0))
    axpy = module.get_kernel("axpy", rtc.AXPY_SIGNATURE, out_shapes=[((n,), "float32")])
    scale3 = module.get_kernel("scale3<float>", rtc.SCALE3_SIGNATURE)
    transpose = module.get_kernel("transpose", rtc.TRANSPOSE_SIGNATURE,
                                  out_shapes=[((cols, rows), "float32")])
    empty = module.get_kernel("empty")
    grid_t = (-(-cols // 32), -(-rows // 32), 1)

    rtc.CudaKernel.launches = 0          # the rtc path: counts set to 0 just before
    (z,) = axpy.launch([x, y, n], mx.gpu(0), grid, block)
    scale3.launch([s_in, s_out, 4096], mx.gpu(0), (16, 1, 1), (256, 1, 1))
    (t,) = transpose.launch([m, rows, cols], mx.gpu(0), grid_t, (32, 32, 1),
                            shared_mem=32 * 33 * 4)
    (t64,) = transpose.launch([m, rows, cols], mx.gpu(0), grid_t, (32, 32, 1),
                              shared_mem=64 * 1024)     # above the 48 KiB default
    empty.launch([], mx.gpu(0), (1,), (1,))
    torch.cuda.synchronize()
    launches = rtc.CudaKernel.launches
    split = {k: v * 1e3 for k, v in rtc.timings.items()}
    log(f"[rtc] NVRTC compile of the examples {compile_ms:.1f} ms (libnvrtc load "
        f"{split.get('nvrtc_load_s', float('nan')):.1f} ms, nvrtcCompileProgram "
        f"{split.get('nvrtc_compile_s', float('nan')):.1f} ms; cuModuleLoadData at the "
        f"first launch {split.get('module_load_s', float('nan')):.2f} ms); launches "
        f"{launches}; axpy grid {grid[0]}x{block[0]} ({sms} SMs)")
    if launches != 5:
        raise AssertionError(f"expected 5 rtc launches, got {launches}")
    errs = {"axpy": (z._data - rtc.axpy_plain(x._data, y._data)).abs().max().item(),
            "scale3": (s_out._data - rtc.scale3_plain(s_in._data)).abs().max().item(),
            "transpose": (t._data - rtc.transpose_plain(m._data)).abs().max().item(),
            "transpose_64KiB": (t64._data - rtc.transpose_plain(m._data)).abs().max().item()}
    # axpy off a 16-byte boundary: all three views on the same offset (the
    # scalar head aligns them), and on different offsets (the scalar path)
    inplace = module.get_kernel("axpy", rtc.AXPY_SIGNATURE)
    for name, (xo, yo) in (("axpy_offset_4B", (1, 1)), ("axpy_offsets_4B_8B", (1, 2))):
        k = n - 8
        xv, yv = mx.nd.NDArray(x._data[xo:xo + k]), mx.nd.NDArray(y._data[yo:yo + k])
        zv = mx.nd.NDArray(torch.empty(k + 1, device="cuda")[1:])
        inplace.launch([xv, yv, zv, k], mx.gpu(0), *rtc.axpy_launch_dims(k, sms))
        errs[name] = (zv._data - rtc.axpy_plain(xv._data, yv._data)).abs().max().item()
    log(f"[rtc] against the plain versions (exact: the same f32 arithmetic): {errs}")
    if any(v != 0.0 for v in errs.values()):
        raise AssertionError("an rtc kernel disagrees with its plain version")

    def run_axpy():
        axpy.launch([x, y, n], mx.gpu(0), grid, block)

    def run_add():
        torch.add(y._data, x._data, alpha=2.0)
    ms = _time_ms(torch, run_axpy, 20)
    lib_ms = _time_ms(torch, run_add, 20)
    graph_ms = _graph_ms(torch, run_axpy)
    lib_graph_ms = _graph_ms(torch, run_add)
    plain_ms = _time_ms(torch, lambda: rtc.axpy_plain(x._data, y._data), 20)
    bound = 12.0 * n / PEAK_BYTES_PER_S * 1e3
    empty_launch = lambda: empty.launch([], mx.gpu(0), (1,), (1,))   # noqa: E731
    for _ in range(10):
        empty_launch()
    torch.cuda.synchronize()
    readings = []                # 7 readings of 1000 launches, each synced once
    for _ in range(7):
        t0 = time.perf_counter()
        for _ in range(1000):
            empty_launch()
        torch.cuda.synchronize()
        readings.append((time.perf_counter() - t0) * 1e3)
    empty_host_us = float(np.median(readings))
    empty_device_us = _time_ms(torch, empty_launch, 1000) * 1e3
    log(f"[rtc] axpy on 2^26 f32: kernel {ms:.4f} ms (graph replay {graph_ms:.4f}, "
        f"{100 * bound / graph_ms:.1f}% of the bound), plain {plain_ms:.4f} ms, torch.add "
        f"{lib_ms:.4f} ms (graph replay {lib_graph_ms:.4f}; kernel/torch.add "
        f"{graph_ms / lib_graph_ms:.3f}x by graph), bound {bound:.4f} ms (bytes: 12 B x "
        f"2^26), {12.0 * n / graph_ms / 1e9:.3f} TB/s; empty launch {empty_host_us:.2f} us "
        f"(host clock per launch over 1000, synced; median of 7, "
        f"{min(readings):.2f}-{max(readings):.2f}), {empty_device_us:.2f} us (CUDA "
        f"events per launch)")
    return {"compile_ms": compile_ms, "compile_split_ms": split, "launches": launches,
            "errors": errs, "max_abs_err": max(errs.values()), "ms": ms,
            "graph_ms": graph_ms, "plain_ms": plain_ms, "library_ms": lib_ms,
            "library_graph_ms": lib_graph_ms, "bound_ms": bound, "grid": list(grid),
            "sms": sms, "empty_launch_host_us": empty_host_us,
            "empty_launch_host_us_readings": readings,
            "empty_launch_device_us": empty_device_us}


# ResNet-50 batch-32 convolutions the TPU probe timed (conv_kernel_probe.py
# CONVS): (N, Cin, H, W, Cout, k, stride), and the im2col product of each
# padded to 512 / 512 / 256 as the probe pads it.
PROBE_CONVS = [(32, 256, 14, 14, 256, 3, 1), (32, 512, 7, 7, 512, 3, 1),
               (32, 1024, 14, 14, 256, 1, 1)]
TOL_PROBE = 1e-2   # bf16: one rounding of an f32 sum, relative to the output's max


def _ceil_to(x, m):
    return (x + m - 1) // m * m


def _probe_shape(n, cin, h, w, cout, k, stride):
    m = n * (h // stride) * (w // stride)
    return _ceil_to(m, 512), _ceil_to(cin * k * k, 512), _ceil_to(cout, 256)


def _rel_err(got, expect):
    d = (got.float() - expect.float()).abs().max().item()
    return d, d / max(expect.float().abs().max().item(), 1e-30)


def _im2col_check(torch, activations, weights):
    """K7 on the im2col form of real ResNet-50 activations against the port's
    Convolution op (cuDNN), in bf16."""
    import torch.nn.functional as F
    from mxnet_tpu_torch.ops.cuda import blocked_matmul as bm
    from mxnet_tpu_torch.ops.nn import convolution
    out = {}
    for name, x in activations.items():
        x, w = x.to(torch.bfloat16), weights[name].to(torch.bfloat16)
        n, cin, h, wd = x.shape
        cout, _, k, _ = w.shape
        if k == 1:
            cols = x.permute(0, 2, 3, 1).reshape(n * h * wd, cin)
        else:
            cols = F.unfold(x, k, padding=k // 2).transpose(1, 2).reshape(n * h * wd, cin * k * k)
        y = bm.blocked_matmul(cols.contiguous(), w.reshape(cout, -1).t().contiguous())
        y = y.reshape(n, h, wd, cout).permute(0, 3, 1, 2)
        ref = convolution(x, w, None, kernel=(k, k), num_filter=cout, pad=(k // 2, k // 2),
                          no_bias=True)
        d, rel = _rel_err(y, ref)
        out[name] = {"shape": list(x.shape), "weight": list(w.shape), "max_abs": d, "rel": rel}
        log(f"[probe] real data, {name}: im2col {tuple(cols.shape)} x "
            f"({cols.shape[1]}, {cout}) through K7 vs Convolution (cuDNN), bf16: "
            f"max|d| {d:.3e} ({rel:.1e} of max, tol {TOL_PROBE:.0e}) "
            f"{'ok' if rel <= TOL_PROBE else 'FAIL'}")
        if rel > TOL_PROBE:
            raise AssertionError(f"K7 on real im2col data disagrees with the convolution ({name})")
    return out


def phase_probe(torch, activations, weights):
    """K7, the port's counterpart of ``conv_kernel_probe.main``: the blocked
    matmul over the im2col forms of ResNet-50's batch-32 convolutions in
    bf16, against its plain version, torch.matmul and the convolution."""
    from mxnet_tpu_torch.ops.cuda import blocked_matmul as bm
    from mxnet_tpu_torch.ops.nn import convolution
    gen = torch.Generator(device="cuda").manual_seed(4)
    cases = []
    for conv in PROBE_CONVS:
        M, K, N = _probe_shape(*conv)
        a = torch.randn((M, K), generator=gen, device="cuda").to(torch.bfloat16)
        b = (0.05 * torch.randn((K, N), generator=gen, device="cuda")).to(torch.bfloat16)
        cases.append((conv, (M, K, N), a, b))

    bm.blocked_matmul.launches = 0        # the probe path: counts set to 0 just before
    outs = [bm.blocked_matmul(a, b) for _, _, a, b in cases]
    real = _im2col_check(torch, activations, weights)
    torch.cuda.synchronize()
    launches = bm.blocked_matmul.launches
    log(f"[probe] K7 launches on the probe path: {launches}")
    if launches != len(cases) + len(activations):
        raise AssertionError(f"expected {len(cases) + len(activations)} K7 launches, "
                             f"got {launches}")
    results = []
    for (conv, (M, K, N), a, b), out in zip(cases, outs):
        d, rel = _rel_err(out, bm.blocked_matmul_plain(a, b))
        if rel > TOL_PROBE:
            raise AssertionError(f"K7 disagrees with its plain version at {(M, K, N)}")
        n, cin, h, w, cout, k, stride = conv
        x = torch.randn((n, cin, h, w), generator=gen, device="cuda").to(torch.bfloat16)
        wt = (0.05 * torch.randn((cout, cin, k, k), generator=gen, device="cuda")).to(torch.bfloat16)
        ms = _time_ms(torch, lambda: bm.blocked_matmul(a, b), 20)
        graph_ms = _graph_ms(torch, lambda: bm.blocked_matmul(a, b))
        plain_ms = _time_ms(torch, lambda: bm.blocked_matmul_plain(a, b), 5)
        mm_ms = _time_ms(torch, lambda: torch.matmul(a, b), 20)
        mm_graph_ms = _graph_ms(torch, lambda: torch.matmul(a, b))
        conv_ms = _time_ms(torch, lambda: convolution(
            x, wt, None, kernel=(k, k), num_filter=cout, stride=(stride, stride),
            pad=(k // 2, k // 2), no_bias=True), 20)
        flops = 2.0 * M * K * N
        nbytes = 2.0 * (M * K + K * N + M * N)
        t_ops, t_bytes = flops / PEAK_FLOPS["bfloat16"] * 1e3, nbytes / PEAK_BYTES_PER_S * 1e3
        fma_floor = flops / PEAK_FLOPS["float32"] * 1e3
        conv_graph_ms = _graph_ms(torch, lambda: convolution(
            x, wt, None, kernel=(k, k), num_filter=cout, stride=(stride, stride),
            pad=(k // 2, k // 2), no_bias=True))
        r = {"conv": list(conv), "mkn": [M, K, N], "max_abs_err": d, "rel_err": rel,
             "ms": ms, "graph_ms": graph_ms, "plain_ms": plain_ms, "library_ms": mm_ms,
             "library_graph_ms": mm_graph_ms, "conv_ms": conv_ms,
             "conv_graph_ms": conv_graph_ms, "bound_ms": max(t_ops, t_bytes),
             "bound_by": "operations" if t_ops >= t_bytes else "bytes",
             "fma_floor_ms": fma_floor, "tflops": flops / graph_ms / 1e9}
        results.append(r)
        log(f"[probe] ({M},{K})x({K},{N}) bf16 from conv{k}x{k} {cin}->{cout} {h}x{w} bs{n}: "
            f"K7 {ms:.4f} ms (graph replay {graph_ms:.4f}, {r['tflops']:.1f} TFLOP/s), "
            f"plain {plain_ms:.4f} ms, torch.matmul {mm_ms:.4f} ms (graph replay "
            f"{mm_graph_ms:.4f}), Convolution (cuDNN) {conv_ms:.4f} ms (graph replay "
            f"{conv_graph_ms:.4f}); bound {r['bound_ms'] * 1e3:.2f} us ({r['bound_by']}), "
            f"FMA-only floor {fma_floor * 1e3:.1f} us; max|d| vs plain {d:.3e} ({rel:.1e} "
            f"of max, tol {TOL_PROBE:.0e}) ok")
    total = {key: sum(r[key] for r in results)
             for key in ("ms", "graph_ms", "plain_ms", "library_ms", "library_graph_ms",
                         "conv_ms", "conv_graph_ms", "bound_ms", "fma_floor_ms")}
    log(f"[probe] three shapes summed, graph replay: K7 {total['graph_ms']:.4f} ms, "
        f"torch.matmul {total['library_graph_ms']:.4f} ms "
        f"({total['graph_ms'] / total['library_graph_ms']:.2f}x), cuDNN "
        f"{total['conv_graph_ms']:.4f} ms; bound {total['bound_ms']:.4f} ms")
    by_bytes = sum(r["bound_ms"] for r in results if r["bound_by"] == "bytes")
    total["bound_by"] = "bytes" if 2 * by_bytes >= total["bound_ms"] else "operations"
    return {"launches": launches, "shapes": results, "real_data": real, "total": total,
            "max_abs_err": max(r["max_abs_err"] for r in results),
            "f32": _probe_f32(torch, cases), "resources": _matmul_resources()}


TOL_PROBE_F32 = 1e-5   # f32 FMA kernel against the plain f32 product: summation order


def _probe_f32(torch, cases):
    """K7's f32 route (its FMA kernel) at the probe shapes, by graph
    replay, beside ``torch.matmul`` in f32 with TF32 off and the FMA bound
    (67 TFLOP/s) and byte bound."""
    from mxnet_tpu_torch.ops.cuda import blocked_matmul as bm
    torch.backends.cuda.matmul.allow_tf32 = False
    rows = []
    for _, (M, K, N), a16, b16 in cases:
        a, b = a16.float(), b16.float()
        d, rel = _rel_err(bm.blocked_matmul(a, b), bm.blocked_matmul_plain(a, b))
        if rel > TOL_PROBE_F32:
            raise AssertionError(f"K7 f32 disagrees with its plain version at {(M, K, N)}")
        graph_ms = _graph_ms(torch, lambda: bm.blocked_matmul(a, b))
        mm_graph_ms = _graph_ms(torch, lambda: torch.matmul(a, b))
        flops = 2.0 * M * K * N
        t_ops = flops / PEAK_FLOPS["float32"] * 1e3
        t_bytes = 4.0 * (M * K + K * N + M * N) / PEAK_BYTES_PER_S * 1e3
        r = {"mkn": [M, K, N], "graph_ms": graph_ms, "library_graph_ms": mm_graph_ms,
             "bound_ms": max(t_ops, t_bytes),
             "bound_by": "operations" if t_ops >= t_bytes else "bytes",
             "rel_err": rel, "tflops": flops / graph_ms / 1e9}
        rows.append(r)
        log(f"[probe] f32 ({M},{K})x({K},{N}): K7 (FMA) graph replay {graph_ms:.4f} ms "
            f"({r['tflops']:.1f} TFLOP/s), torch.matmul f32 TF32 off {mm_graph_ms:.4f} ms; "
            f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}, 67 TFLOP/s FMA); vs plain "
            f"{rel:.1e} of max (tol {TOL_PROBE_F32:.0e})")
    total = {k: sum(r[k] for r in rows) for k in ("graph_ms", "library_graph_ms", "bound_ms")}
    log(f"[probe] f32 three shapes summed, graph replay: K7 {total['graph_ms']:.4f} ms, "
        f"torch.matmul {total['library_graph_ms']:.4f} ms, bound {total['bound_ms']:.4f} ms")
    return {"shapes": rows, "total": total}


TOL_RESNET_LOGITS = 1e-3     # GPU against CPU, relative to the logits' max
RESNET_TRAIN_GFLOP = 3 * 7.64   # per 224x224 image (bench.py:39-51, port's own copy)
TOL_TRAIN_RUNNING = 1e-5


def _resnet50(mx, ctx, params):
    """ResNet-50 v1 on ``ctx``: one batch-1 shape pass, then the seeded weights."""
    from mxnet_tpu_torch.convert import load_jax_params, seeded_params
    from mxnet_tpu_torch.gluon.model_zoo.vision import resnet50_v1
    net = resnet50_v1()
    net.initialize(ctx=ctx)
    net(mx.nd.zeros((1, 3, 224, 224), ctx=ctx))
    if params is None:
        params = seeded_params(net, seed=0)
    load_jax_params(net, params)
    return net, params


def phase_resnet_serve(torch):
    import mxnet_tpu_torch as mx
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    net, params = _resnet50(mx, mx.gpu(0), None)
    torch.cuda.synchronize()
    log(f"[resnet-serve] resnet50_v1 f32, TF32 off (matmul.allow_tf32="
        f"{torch.backends.cuda.matmul.allow_tf32}, cudnn.allow_tf32="
        f"{torch.backends.cudnn.allow_tf32}), {sum(p.size for p in params.values())} "
        f"parameters in {len(params)} tensors; ready in {time.perf_counter() - t0:.2f} s")
    rs = np.random.RandomState(7)
    torch.cuda.reset_peak_memory_stats()
    served = []
    for batch in (1, 8, 32):
        images = rs.uniform(-1, 1, (batch, 3, 224, 224)).astype(np.float32)
        for i in range(4):          # the first of each batch size is its warm-up
            t_start = time.perf_counter()
            logits = net(mx.nd.array(images, ctx=mx.gpu(0)))
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t_start) * 1e3
            ok = logits.shape == (batch, 1000) and bool(torch.isfinite(logits._data).all())
            log(f"[resnet-serve] batch={batch} request {i}: {ms:.2f} ms, "
                f"{batch / ms * 1e3:.1f} img/s, logits {logits.shape} finite={ok}"
                + (" (warm-up)" if i == 0 else ""))
            if not ok:
                raise AssertionError("bad ResNet-50 logits")
            served.append({"batch": batch, "ms": ms, "img_per_s": batch / ms * 1e3,
                           "warmup": i == 0})
    peak = torch.cuda.max_memory_allocated()
    log(f"[resnet-serve] peak device memory {peak / 2**30:.3f} GiB")
    x32 = mx.nd.array(rs.uniform(-1, 1, (32, 3, 224, 224)).astype(np.float32), ctx=mx.gpu(0))
    profile = _profile(torch, "resnet50 batch=32 request", lambda: net(x32))

    # the probe's real data: inputs of a 3x3 and a 1x1 convolution of stage 3
    acts, weights, hooks = {}, {}, []
    for name, conv in (("stage3 3x3 256->256", net.features[6][1].body[3]),
                       ("stage3 1x1 1024->256", net.features[6][1].body[0])):
        hooks.append(conv.register_forward_pre_hook(
            lambda blk, args, name=name: acts.__setitem__(name, args[0]._data.detach())))
        weights[name] = conv.weight.data()._data.detach()
    net(x32)
    for h in hooks:
        h.detach()

    images = rs.uniform(-1, 1, (2, 3, 224, 224)).astype(np.float32)
    gpu_logits = net(mx.nd.array(images, ctx=mx.gpu(0))).asnumpy()
    t0 = time.perf_counter()
    net_cpu, _ = _resnet50(mx, mx.cpu(), params)
    ref = net_cpu(mx.nd.array(images, ctx=mx.cpu())).asnumpy()
    diff = float(np.abs(ref - gpu_logits).max())
    scale = float(np.abs(ref).max())
    log(f"[resnet-serve] batch-2 logits, GPU vs CPU: max|d| {diff:.3e} ({diff / scale:.1e} "
        f"of max|logit| {scale:.3f}, tol {TOL_RESNET_LOGITS:.0e}); logits std "
        f"{ref.std():.4f}, mean {ref.mean():.4f} (CPU run {time.perf_counter() - t0:.1f} s)")
    if not diff <= TOL_RESNET_LOGITS * scale or not ref.std() > 0.1:
        raise AssertionError("ResNet-50 GPU logits disagree with the CPU run, or are trivial")
    return ({"requests": served, "peak_bytes": peak, "profile": profile,
             "cpu_max_abs_diff": diff, "cpu_rel_diff": diff / scale,
             "logits_std": float(ref.std())}, params, acts, weights)


def _sgd_trainer(mx, net):
    return (mx.gluon.loss.SoftmaxCrossEntropyLoss(),
            mx.gluon.Trainer(net.collect_params(), "sgd",
                             {"learning_rate": 0.05, "momentum": 0.9, "wd": 1e-4}))


def _zero_last_gamma(params):
    """The seeded weights with the γ of each bottleneck's last BatchNorm set
    to 0, so that every block starts as the identity (Goyal et al. 2017,
    GluonCV's ``last_gamma``). From the plain seeded weights, SGD at lr 0.05
    and momentum 0.9 without warm-up drives the loss up after its first step."""
    return {k: np.zeros_like(v) if k.endswith("body.7.gamma") else v
            for k, v in params.items()}


def phase_resnet_train(torch, params):
    """ResNet-50 v1 training at batch 32, 224x224, f32, through Gluon, from
    the seeded weights with zero-γ residual branches."""
    import mxnet_tpu_torch as mx
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    B = 32
    net, _ = _resnet50(mx, mx.gpu(0), _zero_last_gamma(params))
    loss_fn, trainer = _sgd_trainer(mx, net)
    rs = np.random.RandomState(8)
    x = mx.nd.array(rs.uniform(-1, 1, (B, 3, 224, 224)).astype(np.float32), ctx=mx.gpu(0))
    y = mx.nd.array(rs.randint(0, 1000, (B,)).astype(np.int32), ctx=mx.gpu(0), dtype="int32")
    stem_mean = net.features[1].running_mean.data()._data.clone()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    steps = []
    for i in range(6):           # step 0 is the warm-up
        t_start = time.perf_counter()
        loss = _train_step(mx, net, loss_fn, trainer, x, y)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t_start) * 1e3
        value = float(loss.mean().asscalar())
        img_s = B / ms * 1e3
        log(f"[resnet-train] step {i}: {ms:.2f} ms, {img_s:.1f} img/s, "
            f"{img_s * RESNET_TRAIN_GFLOP / 1e3:.2f} TFLOP/s, loss {value:.6f}"
            + (" (warm-up)" if i == 0 else ""))
        if not np.isfinite(value):
            raise AssertionError("training loss is not finite")
        steps.append({"ms": ms, "img_per_s": img_s,
                      "tflops": img_s * RESNET_TRAIN_GFLOP / 1e3, "loss": value,
                      "warmup": i == 0})
    peak = torch.cuda.max_memory_allocated()
    moved = (net.features[1].running_mean.data()._data - stem_mean).abs().max().item()
    log(f"[resnet-train] peak device memory {peak / 2**30:.3f} GiB; loss "
        f"{steps[0]['loss']:.6f} -> {steps[-1]['loss']:.6f}; stem running_mean "
        f"moved by up to {moved:.3e}")
    if not steps[-1]["loss"] < steps[0]["loss"]:
        raise AssertionError("the loss did not fall on a repeated batch")
    if not moved > 0:
        raise AssertionError("the running stats did not change")
    profile = _idle_from_steps("resnet50 training step", _profile(
        torch, "resnet50 training step, batch 32",
        lambda: _train_step(mx, net, loss_fn, trainer, x, y)), steps)
    with mx.autograd.record():
        loss = loss_fn(net(x), y)
    loss.backward()
    sgd = _profile(torch, "resnet50 Trainer.step (SGD momentum, per parameter)",
                   lambda: trainer.step(B))
    return {"steps": steps, "peak_bytes": peak, "profile": profile, "sgd_profile": sgd,
            "running_mean_moved": moved}


def _narrow_resnet_step(mx, ctx, params, x, y, dp=False):
    from mxnet_tpu_torch.convert import load_jax_params
    from mxnet_tpu_torch.gluon.model_zoo.vision import BottleneckV1, ResNetV1
    net = ResNetV1(BottleneckV1, [1, 1, 1, 1], [16, 32, 64, 128, 256])
    net.initialize(ctx=ctx)
    net(mx.nd.zeros((1,) + x.shape[1:], ctx=ctx))
    if params is None:
        from mxnet_tpu_torch.convert import seeded_params
        params = seeded_params(net, seed=9)
    load_jax_params(net, params)
    xs, ys = mx.nd.array(x, ctx=ctx), mx.nd.array(y, ctx=ctx, dtype="int32")
    keys = net._collect_params_with_prefix()
    if dp:
        trainer = _dp_trainer(mx, net, ctx, "sgd",
                              {"learning_rate": 0.05, "momentum": 0.9, "wd": 1e-4})
        loss = float(trainer.step(xs, ys))
        grads = {k: p.grad().asnumpy() for k, p in keys.items() if p.grad_req != "null"}
    else:
        loss_fn, trainer = _sgd_trainer(mx, net)
        with mx.autograd.record():
            out = loss_fn(net(xs), ys)
        out.backward()
        loss = float(out.asnumpy().mean())
        grads = {k: p.grad().asnumpy() for k, p in keys.items() if p.grad_req != "null"}
        trainer.step(x.shape[0])
    state = {k: p.data().asnumpy() for k, p in keys.items()}
    return loss, grads, state, params


def phase_resnet_train_check(torch, dp=False):
    """One SGD step of a narrow ResNet-50-style net, GPU against CPU, through
    ``gluon.Trainer`` or (``dp``) ``DataParallelTrainer``.
    The biases of the 1x1 convolutions that feed a training-mode BatchNorm
    have a gradient of 0 in exact arithmetic (the BatchNorm subtracts the
    batch mean); what is left is rounding noise, held to 1e-5 of the net's
    largest gradient instead of its own max."""
    import mxnet_tpu_torch as mx
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rs = np.random.RandomState(10)
    x = rs.uniform(-1, 1, (4, 3, 64, 64)).astype(np.float32)
    y = rs.randint(0, 1000, (4,)).astype(np.int32)
    gpu = _narrow_resnet_step(mx, mx.gpu(0), None, x, y, dp)
    cpu = _narrow_resnet_step(mx, mx.cpu(), gpu[3], x, y, dp)
    loss_rel = abs(gpu[0] - cpu[0]) / abs(cpu[0])
    gmax = max(float(np.abs(g).max()) for g in cpu[1].values())
    grad_rel, noise = 0.0, 0.0
    for k, g in cpu[1].items():
        d = float(np.abs(gpu[1][k] - g).max())
        if k.endswith("body.0.bias") or k.endswith("body.6.bias"):
            noise = max(noise, d / gmax)
        else:
            grad_rel = max(grad_rel, d / max(float(np.abs(g).max()), 1e-30))
    w_abs, run_rel = 0.0, 0.0
    for k, w in cpu[2].items():
        d = float(np.abs(gpu[2][k] - w).max())
        if "running" in k:
            run_rel = max(run_rel, d / max(float(np.abs(w).max()), 1e-30))
        else:
            w_abs = max(w_abs, d)
    ok = (loss_rel <= TOL_TRAIN_LOSS and grad_rel <= TOL_TRAIN_GRAD and noise <= 1e-5
          and w_abs <= TOL_TRAIN_W and run_rel <= TOL_TRAIN_RUNNING)
    log(f"[{'dp-' if dp else ''}resnet-train-check] ResNetV1 bottleneck, 1 block a "
        f"stage, channels [16, 32, 64, 128, 256], 64x64, batch 4, one SGD step"
        f"{' (DataParallelTrainer)' if dp else ''}, GPU vs CPU: loss "
        f"{gpu[0]:.6f} vs {cpu[0]:.6f} (rel {loss_rel:.2e}, tol {TOL_TRAIN_LOSS:.0e}); "
        f"gradients {grad_rel:.2e} of the tensor's max (tol {TOL_TRAIN_GRAD:.0e}), "
        f"pre-BatchNorm biases {noise:.2e} of the largest gradient (tol 1e-05); weights "
        f"max|d| {w_abs:.2e} (tol {TOL_TRAIN_W:.0e}); running mean/var {run_rel:.2e} "
        f"of max (tol {TOL_TRAIN_RUNNING:.0e}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("GPU ResNet training step disagrees with the CPU run")
    return {"loss_gpu": gpu[0], "loss_cpu": cpu[0], "loss_rel": loss_rel,
            "grad_rel": grad_rel, "pre_bn_bias_noise": noise, "weight_max_abs": w_abs,
            "running_rel": run_rel}


# --- the fused one-device training step (parallel.DataParallelTrainer) -------

TOL_DP_GLUON = 1e-4   # DPT f32 loss trajectory against the Gluon-Trainer phase's


def _fused_counters():
    from mxnet_tpu_torch.ops.cuda import fused_optimizer as fo
    return {c.__name__: c for c in (fo.fused_sgd_apply, fo.fused_adam_apply,
                                    fo.fused_sgd_mom_update, fo.fused_sgd_update,
                                    fo.fused_adam_update)}


def _dp_steps(torch, label, trainer, x, y, n, per_step, units, counters, after=None):
    """``n`` steps of ``trainer`` on one batch (the first a warm-up), every
    counter in ``counters`` set to 0 just before; each step must launch
    exactly ``per_step`` of them. ``after(i)`` runs after step i's checks."""
    for c in counters.values():
        c.launches = 0
        if hasattr(c, "launches_by_dtype"):
            c.launches_by_dtype = {}
    steps = []
    for i in range(n):
        before = {k: c.launches for k, c in counters.items()}
        t_start = time.perf_counter()
        pending = trainer.step(x, y)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t_start) * 1e3
        launched = {k: c.launches - before[k] for k, c in counters.items()}
        value = float(pending)
        log(f"[{label}] step {i}: {ms:.2f} ms, {units[0] / ms * 1e3:.1f} {units[1]}, loss "
            f"{value:.6f}, launches {launched}" + (" (warm-up)" if i == 0 else ""))
        if launched != per_step:
            raise AssertionError(f"{label}: expected launches {per_step} a step, got "
                                 f"{launched}")
        if not np.isfinite(value):
            raise AssertionError(f"{label}: the loss is not finite")
        steps.append({"ms": ms, units[1]: units[0] / ms * 1e3, "loss": value,
                      "warmup": i == 0})
        if after is not None:
            after(i)
    return steps


def phase_dp_bert(torch, params, batch, gluon_steps):
    """BERT-base T=1024, batch 8, Adam lr 1e-4, through DataParallelTrainer on
    gpu(0) from the Gluon-Trainer phase's weights and batch: f32 with TF32
    off (its loss trajectory against the Gluon phase's) and bf16, 5 steps each
    and one more under the profiler; K5 once a step with adam_update's rule,
    K1-K3 once a layer, no registered ``adam_update`` called."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.convert import load_jax_params
    from mxnet_tpu_torch.models import bert_base
    from mxnet_tpu_torch.ops.cuda import flash_attention as fa
    from mxnet_tpu_torch.ops.cuda import fused_optimizer as fo
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    tokens, labels = batch
    B, T = tokens.shape
    n_layers = 12
    adam_op = mx.ops.get_op("adam_update")
    out = {}
    for dtype in ("float32", "bfloat16"):
        net = bert_base(max_length=T)
        net.initialize(ctx=mx.gpu(0))
        load_jax_params(net, params)
        trainer = _dp_trainer(mx, net, mx.gpu(0), "adam", {"learning_rate": 1e-4},
                              None if dtype == "float32" else dtype)
        x = mx.nd.array(tokens, ctx=mx.gpu(0), dtype="int32")
        y = mx.nd.array(labels, ctx=mx.gpu(0), dtype="int32")
        seen = set()
        hook = net.encoder.layers[0].register_forward_hook(
            lambda blk, args, o: seen.add(str(o._data.dtype)))
        counters = dict(_fused_counters(), **{c.__name__: c for c in (
            fa.flash_attention_fwd, fa.flash_attention_bwd_dq, fa.flash_attention_bwd_dkv)})
        per_step = {k: 0 for k in counters}
        per_step.update(fused_adam_update=1, flash_attention_fwd=n_layers,
                        flash_attention_bwd_dq=n_layers, flash_attention_bwd_dkv=n_layers)
        adam_calls = adam_op.calls
        built = fo.table_stats["built"]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        label = f"dp-bert {dtype}"
        steps = _dp_steps(torch, label, trainer, x, y, 5, per_step, (B * T, "tokens_per_s"),
                          counters)
        by_dtype = {c.__name__: c.launches_by_dtype for c in (
            fa.flash_attention_fwd, fa.flash_attention_bwd_dq, fa.flash_attention_bwd_dkv)}
        hook.detach()
        peak = torch.cuda.max_memory_allocated()
        launches = {k: c.launches for k, c in counters.items() if c.launches}
        tables = fo.table_stats["built"] - built
        log(f"[{label}] launches {launches}; registered adam_update calls "
            f"{adam_op.calls - adam_calls}; pointer tables built {tables}; flash launches "
            f"by dtype {by_dtype}; layer output dtype {sorted(seen)}; peak device memory {peak / 2**30:.3f} GiB; loss "
            f"{steps[0]['loss']:.6f} -> {steps[-1]['loss']:.6f}")
        if adam_op.calls != adam_calls:
            raise AssertionError("the fused step called the registered adam_update")
        if tables != 1:
            raise AssertionError(f"the update's pointer table was built {tables} times")
        if seen != {f"torch.{dtype}"}:
            raise AssertionError(f"the layers ran in {seen}, not {dtype}")
        if any(counts != {dtype: 5 * n_layers} for counts in by_dtype.values()):
            raise AssertionError(f"expected the {dtype} flash kernels only, "
                                 f"{n_layers} a step: {by_dtype}")
        if not steps[-1]["loss"] < steps[0]["loss"]:
            raise AssertionError("the loss did not fall on a repeated batch")
        r = {"steps": steps, "launches": launches, "peak_bytes": peak,
             "flash_launches_by_dtype": by_dtype}
        if dtype == "float32":
            ref = [st["loss"] for st in gluon_steps]
            rel = max(abs(a["loss"] - b) / abs(b) for a, b in zip(steps, ref))
            log(f"[{label}] loss trajectory against the Gluon-Trainer phase's "
                f"{[round(v, 6) for v in ref]}: max rel {rel:.2e} (tol {TOL_DP_GLUON:.0e}) "
                f"{'ok' if rel <= TOL_DP_GLUON else 'FAIL'}")
            if rel > TOL_DP_GLUON:
                raise AssertionError("DPT f32 losses disagree with the Gluon-Trainer phase")
            r["gluon_loss_rel"] = rel
        r["profile"] = _step_profile(torch, f"{label} step, batch {B}",
                                     lambda: trainer.step(x, y), steps)
        r["update_ms"] = _group_ms(r["profile"], "fused_optimizer")
        names = r["profile"]["flash_kernels"]
        cname = {"float32": "float", "bfloat16": "__nv_bfloat16"}[dtype]
        if len(names) != 3 or not all(f"_kernel<{cname}," in k for k in names):
            raise AssertionError(f"the profiled {dtype} step launched {names}")
        out[dtype] = r
        del trainer, net
        torch.cuda.empty_cache()
    return out


def _group_ms(profile, group):
    us = (profile.get("groups_us") or {}).get(group)
    return None if us is None else us / 1e3


def _dp_sgd_check(torch, label, trainer):
    """K4's ``sgd_mom_update`` rule on the trainer's own lists (clones of its
    weights, gradient buffers and momenta after its steps) against the plain
    version: the recipe's lr, momentum and wd, then with rescale and clip on.
    Also the rule's time in place on those lists in the form the step runs
    (the scalars in a device tensor), by CUDA events (the wrapper's host work
    on 193 tensors shows there) and by graph replay."""
    from mxnet_tpu_torch.ops.cuda import fused_optimizer as fo
    opt = trainer.optimizer
    lr = float(opt.learning_rate)
    worst, ms, graph_ms, sizes = (0.0, 0.0), 0.0, 0.0, []
    for wd, idx in trainer._groups.items():
        ws = [trainer._plist[i]._param.detach().clone() for i in idx]
        gs = [trainer._plist[i]._grad.clone() for i in idx]
        moms = [trainer._opt_state[i][0].clone() for i in idx]
        sizes += [w.numel() for w in ws]
        for rescale, clip in ((1.0, -1.0), (0.5, 1e-3)):
            args = (ws, gs, moms, lr, opt.momentum, wd, rescale, clip)
            rel, abs_ = _fused_errors(torch, fo.fused_sgd_mom_update(*args),
                                      fo.fused_sgd_mom_update_plain(*args))
            worst = (max(worst[0], rel), max(worst[1], abs_))
        hyper = torch.tensor(fo.hyper_values(lr=lr, momentum=opt.momentum, wd=wd),
                             device=ws[0].device)
        update = lambda: fo.fused_sgd_mom_update_hyper(           # noqa: E731
            ws, gs, moms, hyper, out=(ws, moms))
        ms += _time_ms(torch, update, 20)
        graph_ms += _graph_ms(torch, update)
    n = sum(sizes)
    small = sum(1 for k in sizes if k < 16384)
    bound = 20 * n / PEAK_BYTES_PER_S * 1e3
    ok = worst[0] <= TOL_FUSED
    log(f"[{label}] K4 sgd_mom_update rule on the trainer's {len(sizes)} tensors "
        f"({n} parameters, {small} under one 16384-element chunk), lr {lr} momentum "
        f"{opt.momentum} wd {list(trainer._groups)}, then rescale 0.5 and clip 1e-3, vs "
        f"plain: max|d| {worst[1]:.3e} ({worst[0]:.2e} of the tensor's max, tol "
        f"{TOL_FUSED:.0e}) {'ok' if ok else 'FAIL'}; in place {ms:.4f} ms (graph replay "
        f"{graph_ms:.4f}; bound {bound:.4f} ms, bytes: 20 B x {n})")
    if not ok:
        raise AssertionError(f"{label}: K4's sgd_mom_update rule disagrees with its "
                             f"plain version on the trainer's parameters")
    return {"tensors": len(sizes), "parameters": n, "under_one_chunk": small,
            "max_abs_err": worst[1], "rel_err": worst[0], "ms": ms, "graph_ms": graph_ms,
            "bound_ms": bound}


def phase_dp_resnet(torch, params, gluon_profile):
    """ResNet-50 v1, batch 32, 224x224, bench.py's recipe (SGD lr 0.05,
    momentum 0.9, wd 1e-4) through DataParallelTrainer, f32 with TF32 off and
    bf16, from the seeded weights with zero-γ residual branches: 6 steps each
    and one profiled; K4 once a step with sgd_mom_update's rule."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.ops.cuda import fused_optimizer as fo
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    B = 32
    rs = np.random.RandomState(8)
    xs = rs.uniform(-1, 1, (B, 3, 224, 224)).astype(np.float32)
    ys = rs.randint(0, 1000, (B,)).astype(np.int32)
    gluon_launches = sum((gluon_profile.get("group_launches") or {}).values())
    out = {}
    for dtype in ("float32", "bfloat16"):
        net, _ = _resnet50(mx, mx.gpu(0), _zero_last_gamma(params))
        trainer = _dp_trainer(mx, net, mx.gpu(0), "sgd",
                              {"learning_rate": 0.05, "momentum": 0.9, "wd": 1e-4},
                              None if dtype == "float32" else dtype)
        x = mx.nd.array(xs, ctx=mx.gpu(0))
        y = mx.nd.array(ys, ctx=mx.gpu(0), dtype="int32")
        stem_mean = net.features[1].running_mean.data()._data.clone()
        counters = _fused_counters()
        per_step = dict({k: 0 for k in counters}, fused_sgd_mom_update=1)
        built = fo.table_stats["built"]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        label = f"dp-resnet {dtype}"
        steps = _dp_steps(torch, label, trainer, x, y, 6, per_step, (B, "img_per_s"),
                          counters)
        peak = torch.cuda.max_memory_allocated()
        moved = (net.features[1].running_mean.data()._data - stem_mean).abs().max().item()
        tables = fo.table_stats["built"] - built
        launches = {k: c.launches for k, c in counters.items() if c.launches}
        log(f"[{label}] peak device memory {peak / 2**30:.3f} GiB; loss "
            f"{steps[0]['loss']:.6f} -> {steps[-1]['loss']:.6f}; stem running_mean moved "
            f"by up to {moved:.3e}; pointer tables built {tables}")
        if not moved > 0:
            raise AssertionError("the running stats did not change")
        if tables != 1:
            raise AssertionError(f"the update's pointer table was built {tables} times")
        update_check = _dp_sgd_check(torch, label, trainer)
        profile = _step_profile(torch, f"{label} step, batch {B}",
                                lambda: trainer.step(x, y), steps)
        total = sum(profile["group_launches"].values())
        log(f"[{label}] launches a step {total} (Gluon-Trainer step: {gluon_launches})")
        out[dtype] = {"steps": steps, "peak_bytes": peak, "running_mean_moved": moved,
                      "profile": profile, "launches_per_step": total,
                      "gluon_launches_per_step": gluon_launches,
                      "update_ms": _group_ms(profile, "fused_optimizer"),
                      "update_check": update_check, "launches": launches}
        del trainer, net
        torch.cuda.empty_cache()
    return out


def phase_dp_check(torch):
    """One DataParallelTrainer step on the card against the CPU, f32 with
    TF32 off: the 2-layer BERT-base-wide model with Adam and the narrow
    ResNetV1 with SGD momentum, under the training checks' tolerances."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return {"bert": phase_train_check(torch, dp=True),
            "resnet": phase_resnet_train_check(torch, dp=True)}


# --- the distributed step: DataParallelTrainer over torch.distributed --------

TOL_DIST_NCCL = 1e-6   # world-1 losses against phase_dp_bert's, relative
TOL_DIST_LOSS = 1e-5   # the ranks' losses against the one-rank fused step's, relative
TOL_DIST_GRAD = 1e-3   # gathered gradients after step 1, of each tensor's max
TOL_DIST_W = 2e-5      # gathered weights after the last step (tests' TOL_W)
DIST_RANK_LAYERS = 6   # phase_dist_bert_ranks: BERT-base width, depth cut to 6 of 12 layers


def _mesh_axes(n):
    """Factor n into (dp, tp, sp), every axis used when n allows (the
    layout of ``__graft_entry__._mesh_axes``)."""
    tp = 2 if n % 2 == 0 else 1
    sp = 2 if n % 4 == 0 else 1
    return {"dp": n // (tp * sp), "tp": tp, "sp": sp}


def _flash_counters():
    from mxnet_tpu_torch.ops.cuda import flash_attention as fa
    return {c.__name__: c for c in (fa.flash_attention_fwd, fa.flash_attention_bwd_dq,
                                    fa.flash_attention_bwd_dkv)}


def _zero_counters(counters):
    for c in counters.values():
        c.launches = 0
        for attr in ("launches_by_dtype", "launches_by_shape", "launches_by_mask"):
            if hasattr(c, attr):
                setattr(c, attr, {})


def phase_dist_bert_nccl(torch, params, batch, dp_bert):
    """World size 1 over NCCL (the backend rule's choice for one rank on one
    card): the mesh of ranks, the bucketed gradient all-reduce and the loss
    reduction on BERT-base T=1024 batch 8, Adam lr 1e-4, from phase_dp_bert's
    weights and batch, f32 (TF32 off) and bf16, 5 steps and one profiled;
    the losses equal phase_dp_bert's to TOL_DIST_NCCL."""
    import torch.distributed as dist
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import _dist_util
    from mxnet_tpu_torch.convert import load_jax_params
    from mxnet_tpu_torch.models import bert_base
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    tokens, labels = batch
    B, T = tokens.shape
    n_layers = 12
    backend = _dist_util.choose_backend("gpu", 1, torch.cuda.device_count())
    log(f"[dist-nccl] backend rule: 1 rank on a host with {torch.cuda.device_count()} "
        f"CUDA device(s) -> {backend}")
    work = os.path.join(ROOT, "build", "dist")
    os.makedirs(work, exist_ok=True)
    rendezvous = os.path.join(work, f"nccl.{os.getpid()}.{time.time_ns()}")
    _dist_util.init_process_group(device="gpu", rank=0, world_size=1,
                                  init_method=f"file://{rendezvous}")
    out = {"backend": dist.get_backend()}
    try:
        if out["backend"] != "nccl":
            raise AssertionError(f"world 1 on one card runs {out['backend']}, not nccl")
        mesh = mx.parallel.make_mesh({"dp": 1, "tp": 1, "sp": 1}, devices=[mx.gpu(0)])
        log(f"[dist-nccl] {mesh}, process group {dist.get_backend()} world "
            f"{dist.get_world_size()}")
        for dtype in ("float32", "bfloat16"):
            net = bert_base(max_length=T)
            net.initialize(ctx=mx.gpu(0))
            load_jax_params(net, params)
            trainer = mx.parallel.DataParallelTrainer(
                net, mx.gluon.loss.SoftmaxCrossEntropyLoss(), "adam",
                {"learning_rate": 1e-4}, mesh=mesh, data_spec=mx.parallel.P("dp", "sp"),
                dtype=None if dtype == "float32" else dtype)
            x = mx.nd.array(tokens, ctx=mx.gpu(0), dtype="int32")
            y = mx.nd.array(labels, ctx=mx.gpu(0), dtype="int32")
            counters = dict(_fused_counters(), **_flash_counters())
            per_step = dict({k: 0 for k in counters}, fused_adam_update=1,
                            flash_attention_fwd=n_layers, flash_attention_bwd_dq=n_layers,
                            flash_attention_bwd_dkv=n_layers)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            label = f"dist-nccl {dtype}"
            steps = _dp_steps(torch, label, trainer, x, y, 5, per_step,
                              (B * T, "tokens_per_s"), counters)
            launches = {k: c.launches for k, c in counters.items() if c.launches}
            peak = torch.cuda.max_memory_allocated()
            ref = [st["loss"] for st in dp_bert[dtype]["steps"]]
            rel = max(abs(a["loss"] - b) / abs(b) for a, b in zip(steps, ref))
            med = float(np.median([st["ms"] for st in steps if not st["warmup"]]))
            ref_med = float(np.median([st["ms"] for st in dp_bert[dtype]["steps"]
                                       if not st["warmup"]]))
            log(f"[{label}] {len(trainer._buckets)} gradient buckets, one all_reduce "
                f"each; launches {launches}; peak {peak / 2**30:.3f} GiB; losses against "
                f"phase_dp_bert's {[round(v, 6) for v in ref]}: max rel {rel:.2e} (tol "
                f"{TOL_DIST_NCCL:.0e}) {'ok' if rel <= TOL_DIST_NCCL else 'FAIL'}; median "
                f"step {med:.2f} ms against phase_dp_bert's {ref_med:.2f} ms")
            if rel > TOL_DIST_NCCL:
                raise AssertionError(f"{label}: losses disagree with phase_dp_bert")
            profile = _step_profile(torch, f"{label} step, batch {B}",
                                    lambda: trainer.step(x, y), steps)
            out[dtype] = {"steps": steps, "launches": launches, "peak_bytes": peak,
                          "loss_rel": rel, "step_median_ms": med,
                          "dp_bert_step_median_ms": ref_med,
                          "buckets": len(trainer._buckets), "profile": profile,
                          "launches_per_step": sum(profile["group_launches"].values())}
            log(f"[{label}] launches a step {out[dtype]['launches_per_step']} "
                f"(phase_dp_bert: {sum(dp_bert[dtype]['profile']['group_launches'].values())})")
            del trainer, net
            torch.cuda.empty_cache()
    finally:
        _dist_util.destroy_process_group()
    return out


def rank_dist_bert(workdir, cfg, axes, steps, device, lr, elastic_dir=None):
    """One rank of phase_dist_bert_ranks: the dryrun's step (Megatron specs,
    ``data_spec=P("dp", "sp")``, Adam) ``steps`` times on ``axes``, counting
    every kernel launch by step and shape; rank 0 writes the gathered
    gradients after the first step and the gathered weights after the last.
    With ``elastic_dir``, the dryrun's elastic half: a snapshot after the
    first step (``save_trainer(wait=True)``), whose next step gives the
    expected loss; after the last step a trainer rebuilt with its own
    initial weights boots through ``resume_or_init`` and takes that step
    again."""
    import torch
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import _dist_util, elastic
    from mxnet_tpu_torch.convert import gather_grads, gather_params, load_jax_params
    from mxnet_tpu_torch.models import BertModel
    ctx = _dist_util.rank_context(device)
    gpu = ctx.device_type == "gpu"
    if gpu:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    weights = dict(np.load(os.path.join(workdir, "weights.npz")))
    data = np.load(os.path.join(workdir, "data.npz"))
    mesh = mx.parallel.make_mesh(axes, devices=[ctx])
    net = BertModel(**cfg, head_major_qkv=True)
    net.initialize(ctx=ctx)
    load_jax_params(net, weights)
    del weights
    n_sharded = mx.parallel.shard_params_megatron(net, axis="tp")
    trainer = mx.parallel.DataParallelTrainer(
        net, mx.gluon.loss.SoftmaxCrossEntropyLoss(), "adam", {"learning_rate": lr},
        mesh=mesh, data_spec=mx.parallel.P("dp", "sp"))
    x = mx.nd.array(data["x"], ctx=ctx, dtype="int32")
    y = mx.nd.array(data["y"], ctx=ctx, dtype="int32")
    counters = dict(_fused_counters(), **_flash_counters())
    _zero_counters(counters)
    if gpu:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    ready_s = time.perf_counter() - t0
    out = {"rank": mesh.rank, "coords": dict(mesh.coords), "sharded": n_sharded,
           "buckets": len(trainer._buckets), "ready_s": ready_s, "steps": []}
    for i in range(steps):
        before = {k: c.launches for k, c in counters.items()}
        shapes = {k: dict(c.launches_by_shape) for k, c in _flash_counters().items()}
        t_step = time.perf_counter()
        loss = float(trainer.step(x, y))
        if gpu:
            torch.cuda.synchronize()
        launched = {k: c.launches - before[k] for k, c in counters.items()
                    if c.launches - before[k]}
        by_shape = {k: {s: n - shapes[k].get(s, 0) for s, n in c.launches_by_shape.items()
                        if n - shapes[k].get(s, 0)}
                    for k, c in _flash_counters().items()}
        out["steps"].append({"loss": loss, "s": time.perf_counter() - t_step,
                             "launches": launched, "flash_by_shape": by_shape})
        if i == 0:
            grads = gather_grads(net)
            if mesh.rank == 0:
                np.savez(os.path.join(workdir, "grads.npz"), **grads)
            del grads
            if elastic_dir is not None:
                t_save = time.perf_counter()
                mgr = elastic.SnapshotManager(elastic_dir)
                elastic.save_trainer(mgr, trainer, wait=True)
                out["elastic"] = {"save_s": time.perf_counter() - t_save,
                                  "save_return_s": mgr.last_stats["return_s"],
                                  "copy_bytes": mgr.last_stats["copy_bytes"]}
    params = gather_params(net)
    if mesh.rank == 0:
        np.savez(os.path.join(workdir, "params.npz"), **params)
    out["peak_bytes"] = torch.cuda.max_memory_allocated() if gpu else None
    out["device"] = str(ctx)
    if elastic_dir is not None:
        del trainer, net, params
        if gpu:
            torch.cuda.empty_cache()

        def rebuild():
            mx.random.seed(100 + mesh.rank)
            net2 = BertModel(**cfg, head_major_qkv=True)
            net2.initialize(ctx=ctx)
            mx.parallel.shard_params_megatron(net2, axis="tp")
            return mx.parallel.DataParallelTrainer(
                net2, mx.gluon.loss.SoftmaxCrossEntropyLoss(), "adam", {"learning_rate": lr},
                mesh=mesh, data_spec=mx.parallel.P("dp", "sp"))

        t_resume = time.perf_counter()
        _, tr2, start, outcome = elastic.resume_or_init(elastic_dir, rebuild)
        resume_s = time.perf_counter() - t_resume
        before = {k: c.launches for k, c in counters.items()}
        got = float(tr2.step(x, y))
        out["elastic"].update(start=start, outcome=outcome, loss=got, resume_s=resume_s,
                              launches={k: c.launches - before[k] for k, c in counters.items()
                                        if c.launches - before[k]})
    return out


def phase_dist_bert_ranks(torch, params, batch, device="gpu", cfg=None, n=8, steps=2,
                          timeout=900):
    """``_mesh_axes(n)``'s layout (8: dp2 x tp2 x sp2) as n ranks of
    torch.distributed on the one card over gloo (NCCL refuses two ranks on a
    device), launched by ``_dist_util.launch_local``: BERT-base width
    (``cfg``), T=1024, global batch 8, Adam lr 1e-4, f32 with TF32 off,
    ``steps`` steps of the dryrun's step. Against the one-rank fused step
    on the same global batch: the losses to TOL_DIST_LOSS, the gathered
    gradients after step 1 to TOL_DIST_GRAD of each tensor's max, the
    gathered weights after the last to TOL_DIST_W. Every rank must launch
    K1, K2 and K3 once a layer a step at (B/dp * H/tp, T/sp, T, D) and K5
    once a step. A correctness run: gloo stages every collective through the
    host, so its times are not the card's speed."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import _dist_util
    from mxnet_tpu_torch.convert import load_jax_params
    from mxnet_tpu_torch.models import BertModel
    cfg = cfg or dict(vocab_size=30522, num_layers=DIST_RANK_LAYERS, units=768,
                      hidden_size=3072, num_heads=12, max_length=1024)
    params = _first_layers(params, cfg["num_layers"])
    axes = _mesh_axes(n)
    tokens, labels = batch
    B, T = tokens.shape
    n_layers = cfg["num_layers"]
    backend = _dist_util.choose_backend(device, n, torch.cuda.device_count()
                                        if device == "gpu" else 0)
    shape = (f"{B // axes['dp'] * cfg['num_heads'] // axes['tp']}x{T // axes['sp']}x{T}x"
             f"{cfg['units'] // cfg['num_heads']}")
    log(f"[dist-ranks] {n} ranks {axes} on {device} (backend rule: {n} ranks, "
        f"{torch.cuda.device_count() if device == 'gpu' else 0} device(s) -> {backend}); "
        f"BertModel {cfg} head_major_qkv, batch {B}x{T}, {steps} Adam steps; flash "
        f"shape a rank (BH x Tq x Tk x D) {shape}")
    if backend != "gloo":
        raise AssertionError(f"{n} ranks on one card must take gloo, the rule gave {backend}")
    work = os.path.join(ROOT, "build", "dist_bert")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    elastic_dir = os.path.join(work, "elastic")
    t0 = time.perf_counter()
    np.savez(os.path.join(work, "weights.npz"), **params)
    np.savez(os.path.join(work, "data.npz"), x=tokens, y=labels)
    # the one-rank fused step on the same global batch
    ctx = mx.gpu(0) if device == "gpu" else mx.cpu()
    net = BertModel(**cfg, head_major_qkv=True)
    net.initialize(ctx=ctx)
    load_jax_params(net, params)
    trainer = mx.parallel.DataParallelTrainer(
        net, mx.gluon.loss.SoftmaxCrossEntropyLoss(), "adam", {"learning_rate": 1e-4},
        mesh=mx.parallel.make_mesh({"dp": 1}, devices=[ctx]))
    x = mx.nd.array(tokens, ctx=ctx, dtype="int32")
    y = mx.nd.array(labels, ctx=ctx, dtype="int32")
    keys = net._collect_params_with_prefix()
    ref_losses = []
    for i in range(steps):
        ref_losses.append(float(trainer.step(x, y)))
        if i == 0:
            ref_grads = {k: p.grad().asnumpy() for k, p in keys.items()}
    ref_weights = {k: p.data().asnumpy() for k, p in keys.items()}
    del trainer, net, keys, x, y
    if device == "gpu":
        torch.cuda.empty_cache()
    log(f"[dist-ranks] one-rank fused step: losses {[round(v, 6) for v in ref_losses]} "
        f"({time.perf_counter() - t0:.1f} s with the weights written)")
    t_launch = time.perf_counter()
    ranks = _dist_util.launch_local(
        "chip_smoke:rank_dist_bert", n,
        {"workdir": work, "cfg": cfg, "axes": axes, "steps": steps, "device": device,
         "lr": 1e-4, "elastic_dir": elastic_dir},
        device=device, timeout=timeout, pythonpath=[ROOT], workdir=os.path.join(work, "launch"))
    seconds = time.perf_counter() - t_launch
    per_step = {"fused_adam_update": 1, "flash_attention_fwd": n_layers,
                "flash_attention_bwd_dq": n_layers, "flash_attention_bwd_dkv": n_layers}
    elastic_out = _elastic_ranks_check(ranks, elastic_dir, axes, per_step, device)
    worst_loss = 0.0
    for r in ranks:
        losses = [st["loss"] for st in r["steps"]]
        rel = max(abs(a - b) / abs(b) for a, b in zip(losses, ref_losses))
        worst_loss = max(worst_loss, rel)
        peak = "not measured" if r["peak_bytes"] is None else \
            f"{r['peak_bytes'] / 2**30:.3f} GiB"
        log(f"[dist-ranks] rank {r['rank']} {r['coords']} on {r['device']}: ready in "
            f"{r['ready_s']:.1f} s, steps {[round(st['s'], 2) for st in r['steps']]} s, "
            f"losses {[round(v, 6) for v in losses]} (max rel {rel:.2e}), peak {peak}, "
            f"{r['buckets']} buckets; launches a step {[st['launches'] for st in r['steps']]}")
        for i, st in enumerate(r["steps"]):
            if device == "cpu":     # a rehearsal: the plain versions count nothing
                break
            want = dict(per_step)
            if st["launches"] != want:
                raise AssertionError(f"rank {r['rank']} step {i}: launches {st['launches']}, "
                                     f"expected {want}")
            for k, shapes in st["flash_by_shape"].items():
                if shapes != {shape: n_layers}:
                    raise AssertionError(f"rank {r['rank']} step {i}: {k} launched at "
                                         f"{shapes}, expected {shape} x {n_layers}")
    grads = dict(np.load(os.path.join(work, "grads.npz")))
    got_w = dict(np.load(os.path.join(work, "params.npz")))
    shutil.rmtree(work, ignore_errors=True)       # 4 x 533 MB of arrays at BERT-base
    worst_grad = max(float(np.abs(grads[k] - g).max()) / max(float(np.abs(g).max()), 1e-30)
                     for k, g in ref_grads.items())
    worst_w = max(float(np.abs(got_w[k] - w).max()) for k, w in ref_weights.items())
    ok = (worst_loss <= TOL_DIST_LOSS and worst_grad <= TOL_DIST_GRAD
          and worst_w <= TOL_DIST_W and set(grads) == set(ref_grads))
    log(f"[dist-ranks] against the one-rank fused step: losses max rel {worst_loss:.2e} "
        f"(tol {TOL_DIST_LOSS:.0e}), gradients after step 1 {worst_grad:.2e} of each "
        f"tensor's max (tol {TOL_DIST_GRAD:.0e}), weights after step {steps} max|d| "
        f"{worst_w:.2e} (tol {TOL_DIST_W:.0e}) {'ok' if ok else 'FAIL'}; {n} ranks ran "
        f"in {seconds:.1f} s (a correctness run: ranks sharing the card over gloo)")
    if not ok:
        raise AssertionError("the ranks disagree with the one-rank fused step")
    return {"axes": axes, "backend": backend, "cfg": cfg, "shape": shape, "seconds": seconds,
            "ref_losses": ref_losses, "loss_rel": worst_loss, "grad_rel": worst_grad,
            "weight_abs": worst_w, "ranks": ranks, "elastic": elastic_out,
            "launches": {k: sum(sum(st["launches"].get(k, 0) for st in r["steps"])
                                + r["elastic"]["launches"].get(k, 0)
                                for r in ranks) for k in per_step},
            "launches_per_rank_step": per_step}


def _elastic_ranks_check(ranks, elastic_dir, axes, per_step, device):
    """phase_dist_bert_ranks' elastic half: every rank resumed (1, "resumed")
    with the step after the snapshot equal to its uninterrupted step 2 at
    TOL_RESUME, the resumed step's launches those of a step, and the
    manifest's chunks by the ownership rule (each tp shard written once)."""
    worst = 0.0
    for r in ranks:
        e = r["elastic"]
        rel = abs(e["loss"] - r["steps"][1]["loss"]) / abs(r["steps"][1]["loss"])
        worst = max(worst, rel)
        if (e["start"], e["outcome"]) != (1, "resumed") or rel > TOL_RESUME or \
                (device == "gpu" and e["launches"] != per_step):
            raise AssertionError(f"rank {r['rank']}: resumed ({e['start']}, {e['outcome']!r}), "
                                 f"loss {e['loss']} against {r['steps'][1]['loss']} (rel "
                                 f"{rel:.2e}), launches {e['launches']}")
    split = _check_ownership(elastic_dir, 1, axes)
    want = 3 * ranks[0]["sharded"]
    log(f"[dist-ranks] elastic: save_trainer(wait=True) after step 1 in "
        f"{max(r['elastic']['save_s'] for r in ranks):.2f} s (save() returned in "
        f"{max(r['elastic']['save_return_s'] for r in ranks) * 1e3:.1f} ms; "
        f"{sum(r['elastic']['copy_bytes'] for r in ranks) / 1e9:.3f} GB copied over the ranks); "
        f"every rank resume_or_init -> (1, 'resumed') in "
        f"{max(r['elastic']['resume_s'] for r in ranks):.2f} s, its step 2 loss against the "
        f"uninterrupted max rel {worst:.2e} (tol {TOL_RESUME:.0e}); manifest: {split} leaves "
        f"in tp shards, each shard once from the rank at (dp 0, tp t, sp 0) (expected "
        f"{want}: the sharded parameters and their Adam m and v), every other leaf once "
        f"from rank 0 {'ok' if split == want else 'FAIL'}")
    if split != want:
        raise AssertionError(f"{split} tp-split leaves in the manifest, expected {want}")
    return {"loss_rel": worst, "tp_split_leaves": split,
            "save_s": max(r["elastic"]["save_s"] for r in ranks),
            "resume_s": max(r["elastic"]["resume_s"] for r in ranks)}


# --- the long-context recipe: causal K1-K3 at T=32768, ring attention, ZeRO ----

# recipes/long_context.py's make_model defaults (head dim 32), its default
# MXNET_TPU_LONG_CONTEXT_SEQ, and bench.py's BENCH_LC_BATCH default
LC_CFG = dict(num_layers=2, units=64, hidden_size=128, num_heads=2)
LC_VOCAB = 512
LC_T, LC_B = 32768, 4
LC_LR = 1e-3                       # make_trainer's default
LC_CHECK_T, LC_CHECK_B = 2048, 2
LC_RANKS_T, LC_RANKS_B = 8192, 4
# causal K1-K3: the path's shape (B*H, T, Tk, D) and the 4-rank hops' (B/dp*H, T/sp)
LC_SHAPES = [("path", 8, 32768, 32768, 32, True),
             ("pp-microbatch", 2, 32768, 32768, 32, True),      # phase_pp_lc's microbatch
             ("hop-diagonal", 4, 4096, 4096, 32, True),
             ("hop-full", 4, 4096, 4096, 32, False),
             ("d16-hop-diagonal", 4, 4096, 4096, 16, True),
             ("d16-hop-full", 4, 4096, 4096, 16, False)]
# dryrun_multichip's long-context model (__graft_entry__.py:243-257): units 32
# over 2 heads, so K1-K3 run at D = 16 (the d16 rows above are its 4-rank hops
# at phase_lc_ranks' T and batch); and the head dims the kernels are held at
# beyond the path's: 16 (instantiated) and 80 (zero-padded to 128), f32 and
# bf16, causal, at (BH, T, T)
LC_DRYRUN_CFG = dict(num_layers=1, units=32, hidden_size=64, num_heads=2)
HEAD_DIM_CHECKS = [(4, 2048, 16), (4, 2048, 80)]
PLAIN_BWD_MAX_S = 20.0             # above it the path shape's check takes T=8192


PEAK_3XTF32_FLOPS = PEAK_TF32_FLOPS / 3
# phase_zero_bert_ranks: the sharded step against the replicated one on the
# same ranks. Native wire: the same sum of two ranks and the same elementwise
# Adam. bf16/int8 wire: the gradients after step 1 within the wire's quantum
# (_wire_ratio <= 1); the losses within the reference's bounds
# (tests/test_zero_dp.py); the mean weight distance after the last step, in
# lr x steps, within TOL_ZERO_COMPRESSED_W, set from the readings 1.75e-4
# (bf16) and 0.314 (int8) on an H100 (PERF.md §6). The largest distance is
# no test: Adam moves an element whose gradient is mostly wire noise by
# about lr a step either way
TOL_ZERO_LOSS, TOL_ZERO_W = 1e-6, 2e-6
TOL_ZERO_COMPRESSED = {"bfloat16": 2e-2, "int8": 5e-2}
TOL_ZERO_COMPRESSED_W = {"bfloat16": 1e-3, "int8": 0.4}


def _causal_pairs(T, Tk, causal):
    """(q, k) pairs the attention computes: T*Tk, or under the causal mask
    (T = Tk) the T(T+1)/2 on and below the diagonal."""
    return T * (T + 1) // 2 if causal else T * Tk


def _lc_bound(kind, BH, T, Tk, D, causal):
    """Least time for K1 ("fwd", 2 products), K2 ("dq", 3) or K3 ("dkv", 4)
    on f32 inputs: the products over the (q, k) pairs the mask keeps, 2*D
    flops a pair each, at 3xTF32's 165 TFLOP/s effective rate, or the bytes
    (each input read once, each output written once) over 3.35 TB/s,
    whichever is larger."""
    products = {"fwd": 2, "dq": 3, "dkv": 4}[kind]
    flops = 2.0 * products * BH * D * _causal_pairs(T, Tk, causal)
    if kind == "fwd":
        nbytes = 4 * (2 * BH * T * D + 2 * BH * Tk * D) + 4 * BH * T
    else:
        nbytes = 4 * (2 * BH * T * D + 2 * BH * Tk * D) + 8 * BH * T \
            + 4 * (BH * T * D if kind == "dq" else 2 * BH * Tk * D)
    t_ops = flops / PEAK_3XTF32_FLOPS * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    return {"gflop": flops / 1e9, "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def _rel_max(got, want):
    return float((got.float() - want.float()).abs().max() / want.float().abs().max()
                 .clamp_min(1e-30))


def phase_lc_kernels(torch):
    """K1, K2 and K3 with the long-context path's masks and shapes, f32: held
    against their plain versions (the path's shape at T=32768, or T=8192 if the
    plain backward there would take more than PLAIN_BWD_MAX_S), in f32 and in
    f64, at TOL_BWD: the f64 plain version is the exact result, which the f32
    plain version meets to 1.6e-5 of max at T=32768, so a kernel that sums
    its long loops as carefully needs no more than the short shapes' bound;
    then timed by CUDA-graph replay beside the plain versions, the bound and
    SDPA's causal forward and whole backward (yardsticks the port never
    calls)."""
    from mxnet_tpu_torch.ops.cuda import flash_attention as fa
    import torch.nn.functional as F
    gen = torch.Generator(device="cuda").manual_seed(8)
    out = {"checks": [], "timings": {}}
    for label, BH, T, Tk, D, causal in LC_SHAPES:
        q, k, v = _attention_inputs(torch, gen, BH, T, Tk, D, torch.float32)
        do = torch.randn(q.shape, generator=gen, device=q.device)
        with torch.no_grad():
            o, lse = fa.flash_attention_fwd(q, k, v, causal)
            delta = (do * o).sum(-1)
            dq = fa.flash_attention_bwd_dq(q, k, v, do, lse, delta, causal)
            dk, dv = fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta, causal)
            torch.cuda.synchronize()
            # the plain backward's time at this shape decides the checked shape
            t0 = time.perf_counter()
            expect_o, expect_lse = fa.flash_attention_fwd_plain(q, k, v, causal)
            expect = fa.flash_attention_bwd_plain(q, k, v, o, lse, do, causal)
            torch.cuda.synchronize()
            plain_s = time.perf_counter() - t0
            checked = (BH, T, Tk, D)
            if plain_s > PLAIN_BWD_MAX_S:
                Tc = 8192
                checked = (BH, Tc, Tc, D)
                qc, kc, vc, doc = (t[:, :Tc].contiguous() for t in (q, k, v, do))
                o, lse = fa.flash_attention_fwd(qc, kc, vc, causal)
                delta = (doc * o).sum(-1)
                dq = fa.flash_attention_bwd_dq(qc, kc, vc, doc, lse, delta, causal)
                dk, dv = fa.flash_attention_bwd_dkv(qc, kc, vc, doc, lse, delta, causal)
                expect_o, expect_lse = fa.flash_attention_fwd_plain(qc, kc, vc, causal)
                expect = fa.flash_attention_bwd_plain(qc, kc, vc, o, lse, doc, causal)
            errs = {"o": float((o - expect_o).abs().max()),
                    "lse": float((lse - expect_lse).abs().max()),
                    **{n: _rel_max(g, e) for n, g, e in zip(("dq", "dk", "dv"),
                                                             (dq, dk, dv), expect)}}
            # the same plain versions in f64: each f32 result's distance from it
            q64, k64, v64, do64 = (t[:, :checked[1]].double() for t in (q, k, v, do))
            o64, lse64 = fa.flash_attention_fwd_plain(q64, k64, v64, causal)
            exact = fa.flash_attention_bwd_plain(q64, k64, v64, o64, lse64, do64, causal)
            f64 = {who: {n: _rel_max(g.double(), e) for n, g, e in
                         zip(("dq", "dk", "dv"), grads, exact)}
                   for who, grads in (("kernel", (dq, dk, dv)), ("plain", expect))}
            del q64, k64, v64, do64, o64, lse64, exact
        tol = TOL_BWD["float32"]
        ok = (errs["o"] <= TOL_O["float32"] and errs["lse"] <= TOL_LSE
              and all(errs[n] <= tol and f64["kernel"][n] <= tol for n in ("dq", "dk", "dv")))
        log(f"[lc-kernel] {label} causal={causal} checked at BHxTxTkxD "
            f"{'x'.join(map(str, checked))} (plain fwd+bwd {plain_s:.1f} s at "
            f"{BH}x{T}x{Tk}x{D}): max|dO| {errs['o']:.2e} (tol {TOL_O['float32']:.0e}), "
            f"max|dLSE| {errs['lse']:.2e} (tol {TOL_LSE:.0e}), dQ/dK/dV "
            f"{errs['dq']:.1e}/{errs['dk']:.1e}/{errs['dv']:.1e} of max (tol {tol:.1e}); "
            f"against the f64 plain version: kernel "
            + "/".join(f"{f64['kernel'][n]:.1e}" for n in ("dq", "dk", "dv"))
            + ", f32 plain " + "/".join(f"{f64['plain'][n]:.1e}" for n in ("dq", "dk", "dv"))
            + f" {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"K1-K3 disagree with their plain versions ({label})")
        out["checks"].append({"case": label, "causal": causal, "checked_shape": checked,
                              "plain_s": plain_s, "errors": errs, "tol_bwd": tol,
                              "against_f64": f64})
        del expect, expect_o, expect_lse
        with torch.no_grad():
            o, lse = fa.flash_attention_fwd(q, k, v, causal)
            delta = (do * o).sum(-1)
            ms = {"fwd": _graph_ms(torch, lambda: fa.flash_attention_fwd(q, k, v, causal)),
                  "dq": _graph_ms(torch, lambda: fa.flash_attention_bwd_dq(
                      q, k, v, do, lse, delta, causal)),
                  "dkv": _graph_ms(torch, lambda: fa.flash_attention_bwd_dkv(
                      q, k, v, do, lse, delta, causal))}
            port_bwd = _graph_ms(torch, lambda: fa.flash_attention_bwd(
                q, k, v, o, lse, do, causal))
            plain = {"fwd": _time_ms(torch, lambda: fa.flash_attention_fwd_plain(
                q, k, v, causal), 1, warmup=1)}
            plain["bwd"] = _time_ms(torch, lambda: fa.flash_attention_bwd_plain(
                q, k, v, o, lse, do, causal), 1, warmup=1)
        B, H = BH // 2, 2
        q4 = q.view(B, H, T, D).clone().requires_grad_()
        k4, v4 = (t.view(B, H, Tk, D).clone().requires_grad_() for t in (k, v))
        do4 = do.view(B, H, T, D)

        def sdpa_fwd():
            return F.scaled_dot_product_attention(q4, k4, v4, is_causal=causal)

        def sdpa_fwd_bwd():
            torch.autograd.grad(sdpa_fwd(), (q4, k4, v4), do4)
        with torch.no_grad():
            sdpa_f = _graph_ms(torch, sdpa_fwd)
        sdpa_fb = _graph_ms(torch, sdpa_fwd_bwd)
        entry = {"BH": BH, "T": T, "Tk": Tk, "D": D, "causal": causal,
                 "port_bwd_ms": port_bwd, "plain_fwd_ms": plain["fwd"],
                 "plain_bwd_ms": plain["bwd"], "sdpa_fwd_ms": sdpa_f,
                 "sdpa_bwd_ms": sdpa_fb - sdpa_f, "sdpa_fwd_bwd_ms": sdpa_fb}
        for kind in ("fwd", "dq", "dkv"):
            entry[kind] = dict(ms=ms[kind], **_lc_bound(kind, BH, T, Tk, D, causal))
            entry[kind]["tflops"] = entry[kind]["gflop"] / ms[kind]
        out["timings"][label] = entry
        log(f"[lc-kernel] {label} {BH}x{T}x{Tk}x{D} f32 causal={causal}, graph replay: "
            + ", ".join(f"{n} {entry[n]['ms']:.4f} ms (bound {entry[n]['bound_ms']:.4f}, "
                        f"{entry[n]['bound_by']}, {entry[n]['tflops']:.1f} TFLOP/s)"
                        for n, name in (("fwd", "K1"), ("dq", "K2"), ("dkv", "K3")))
            + f"; port whole backward {port_bwd:.4f} ms; plain fwd {plain['fwd']:.2f} ms, "
            f"bwd {plain['bwd']:.2f} ms; SDPA forward {sdpa_f:.4f} ms, whole backward "
            f"{sdpa_fb - sdpa_f:.4f} ms")
        del q, k, v, do, o, lse, delta, q4, k4, v4
        torch.cuda.empty_cache()
    out["head_dims"] = _head_dim_checks(torch, gen)
    return out


def _head_dim_checks(torch, gen):
    """K1-K3 at the head dims of HEAD_DIM_CHECKS (16 instantiated, 80
    zero-padded to 128 by the wrappers), causal, f32 and bf16, against their
    plain versions: O, dQ, dK and dV within TOL_BWD of each one's max, the LSE
    within TOL_LSE."""
    from mxnet_tpu_torch.ops.cuda import flash_attention as fa
    checks = []
    for BH, T, D in HEAD_DIM_CHECKS:
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype).rpartition(".")[2]
            q, k, v = _attention_inputs(torch, gen, BH, T, T, D, dtype)
            do = torch.randn(q.shape, generator=gen, device=q.device).to(dtype)
            with torch.no_grad():
                o, lse = fa.flash_attention_fwd(q, k, v, True)
                delta = (do.float() * o.float()).sum(-1)
                dq = fa.flash_attention_bwd_dq(q, k, v, do, lse, delta, True)
                dk, dv = fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta, True)
                expect_o, expect_lse = fa.flash_attention_fwd_plain(q, k, v, True)
                expect = fa.flash_attention_bwd_plain(q, k, v, o, lse, do, True)
                torch.cuda.synchronize()
            errs = {"lse": float((lse - expect_lse).abs().max()),
                    **{n: _rel_max(g, e) for n, g, e in zip(("o", "dq", "dk", "dv"),
                                                            (o, dq, dk, dv),
                                                            (expect_o, *expect))}}
            tol = TOL_BWD[name]
            ok = errs["lse"] <= TOL_LSE and all(errs[n] <= tol for n in ("o", "dq", "dk", "dv"))
            log(f"[lc-kernel] head dim {D} ({'instantiated' if D in fa._HEAD_DIMS else f'padded to {fa._kernel_dim(D, name)}'}) "
                f"{BH}x{T}x{T} {name} causal: O/dQ/dK/dV "
                + "/".join(f"{errs[n]:.1e}" for n in ("o", "dq", "dk", "dv"))
                + f" of max (tol {tol:.0e}), max|dLSE| {errs['lse']:.1e} "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"K1-K3 at head dim {D} ({name}) disagree with their "
                                     f"plain versions")
            checks.append({"BH": BH, "T": T, "D": D, "dtype": name, "errors": errs, "tol": tol})
            del q, k, v, do, o, lse, delta, dq, dk, dv, expect, expect_o, expect_lse
    return checks


def _lc_weights(cfg=LC_CFG):
    """The recipe's model at the widths of ``cfg`` (LC_CFG), seeded (the same
    weights for every phase; positions up to LC_T)."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.convert import seeded_params
    from mxnet_tpu_torch.recipes import long_context as lc
    net = lc.LongContextLM(LC_VOCAB, max_length=LC_T, **cfg)
    net.initialize(ctx=mx.cpu())
    return seeded_params(net, seed=11)


def _lc_batch(B, T, seed):
    rs = np.random.RandomState(seed)
    return (rs.randint(0, LC_VOCAB, size=(B, T)).astype(np.int32),
            rs.randint(0, LC_VOCAB, size=(B, T)).astype(np.int32))


def _lc_trainer(mx, weights, ctx, mesh, max_length, cfg=LC_CFG):
    from mxnet_tpu_torch.convert import load_jax_params
    from mxnet_tpu_torch.recipes import get_recipe
    recipe = get_recipe("long_context")
    net = recipe.build_model(vocab_size=LC_VOCAB, seq_len=max_length, ctx=ctx, **cfg)
    load_jax_params(net, {k: v[:max_length] if k == "pos_embed.weight" else v
                          for k, v in weights.items()})
    return net, recipe.build_trainer(net, mesh, learning_rate=LC_LR)


def _lc_counters():
    return dict(_flash_counters(), fused_adam_update=_fused_counters()["fused_adam_update"])


def phase_lc_train(torch, weights):
    """LongContextTrainer on a world-1 NCCL mesh {dp: 1, sp: 1} (the caller
    holds the process group) at the recipe's configuration: T=32768, batch 4,
    f32 (TF32 off), Adam lr 1e-3; 5 steps and one profiled. Each step must
    launch K1, K2 and K3 twice (one causal hop a layer) and K5 once (one wd
    group), and the loss must fall."""
    import torch.distributed as dist
    import mxnet_tpu_torch as mx
    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = mx.parallel.make_mesh({"dp": 1, "sp": 1}, devices=[mx.gpu(0)])
    net, trainer = _lc_trainer(mx, weights, mx.gpu(0), mesh, LC_T)
    tokens, labels = _lc_batch(LC_B, LC_T, seed=12)
    x = mx.nd.array(tokens, ctx=mx.gpu(0), dtype="int32")
    y = mx.nd.array(labels, ctx=mx.gpu(0), dtype="int32")
    counters = _lc_counters()
    n = LC_CFG["num_layers"]
    per_step = {"flash_attention_fwd": n, "flash_attention_bwd_dq": n,
                "flash_attention_bwd_dkv": n, "fused_adam_update": 1}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_counters(counters)
    label = "lc-train"
    log(f"[{label}] LongContextLM {LC_CFG} vocab {LC_VOCAB}, batch {LC_B} x T {LC_T}, "
        f"{mesh} over {dist.get_backend()}, {len(trainer._zero_plan)} ZeRO bucket(s)")
    steps = _dp_steps(torch, label, trainer, x, y, 5, per_step, (LC_B * LC_T, "tokens_per_s"),
                      counters)
    masks = {k: dict(c.launches_by_mask) for k, c in _flash_counters().items()}
    launches = {k: c.launches for k, c in counters.items()}
    peak = torch.cuda.max_memory_allocated()
    if any(m.get("full") for m in masks.values()):
        raise AssertionError(f"{label}: a flash kernel ran without the causal mask: {masks}")
    if not steps[-1]["loss"] < steps[0]["loss"]:
        raise AssertionError(f"{label}: the loss did not fall")
    profile = _step_profile(torch, f"{label} step", lambda: trainer.step(x, y), steps)
    med = float(np.median([st["ms"] for st in steps if not st["warmup"]]))
    log(f"[{label}] median step {med:.2f} ms, {LC_B * LC_T / med * 1e3:.0f} tokens/s; "
        f"launches {launches} ({masks}); a step: {sum(profile['group_launches'].values())} "
        f"launches; peak {peak / 2**30:.3f} GiB")
    out = {"steps": steps, "step_median_ms": med, "tokens_per_s": LC_B * LC_T / med * 1e3,
           "launches": launches, "launches_by_mask": masks, "peak_bytes": peak,
           "profile": profile, "launches_per_step": sum(profile["group_launches"].values()),
           "per_step": per_step}
    del trainer, net
    torch.cuda.empty_cache()
    return out


def _lc_step(mx, weights, ctx, mesh, x, y):
    net, trainer = _lc_trainer(mx, weights, ctx, mesh, LC_CHECK_T)
    xs, ys = (mx.nd.array(a, ctx=ctx, dtype="int32") for a in (x, y))
    loss = float(trainer.step(xs, ys))
    grads = {k: g.cpu().numpy() for k, g in trainer.gathered_grads().items()}
    keys = net._collect_params_with_prefix()
    return loss, grads, {k: p.data().asnumpy() for k, p in keys.items()}


def phase_lc_check(torch, weights):
    """One LongContextTrainer step at the recipe's widths, T=2048, batch 2: on
    the card over the world-1 NCCL mesh (the caller's process group: the
    sharded update at dp 1) against the CPU on a mesh of one device (the
    kernels' plain versions), f32 with TF32 off, under the training checks'
    tolerances."""
    import mxnet_tpu_torch as mx
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    x, y = _lc_batch(LC_CHECK_B, LC_CHECK_T, seed=13)
    gpu = _lc_step(mx, weights, mx.gpu(0), mx.parallel.make_mesh(
        {"dp": 1, "sp": 1}, devices=[mx.gpu(0)]), x, y)
    cpu = _lc_step(mx, weights, mx.cpu(), mx.parallel.Mesh([mx.cpu()], ("dp", "sp"), (1, 1)),
                   x, y)
    res = _step_agreement(gpu, cpu, LC_LR)
    log(f"[lc-check] LongContextLM {LC_CFG}, T={LC_CHECK_T}, batch {LC_CHECK_B}, one "
        f"LongContextTrainer step, GPU (NCCL world 1) vs CPU: loss {gpu[0]:.6f} vs "
        f"{cpu[0]:.6f} (rel {res['loss_rel']:.2e}, tol {TOL_TRAIN_LOSS:.0e}); gradients "
        f"{res['grad_rel']:.2e} of the tensor's max (tol {TOL_TRAIN_GRAD:.0e}); weights "
        f"max|d| {res['weight_max_abs']:.2e} (tol {TOL_TRAIN_W:.0e}), "
        f"{res['near_zero_grad_elements']} elements with a nonzero |g| within the gradient "
        f"tolerance of 0 up to {res['near_zero_weight_max_abs']:.2e} (tol 2 lr); "
        f"{'ok' if res['ok'] else 'FAIL'} ({time.perf_counter() - t0:.1f} s)")
    if not res["ok"]:
        raise AssertionError("the long-context step on the card disagrees with the CPU")
    res.pop("ok")
    return dict(res, loss_gpu=gpu[0], loss_cpu=cpu[0])


def rank_lc(workdir, axes, steps, T, device, lr, cfg=LC_CFG):
    """One rank of phase_lc_ranks: LongContextTrainer on ``axes`` ``steps``
    times, counting every kernel launch by step, shape and mask and the ring's
    point-to-point bytes; rank 0 writes the reduced gradients after the first
    step and the weights after the last."""
    import torch
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import _dist_util
    from mxnet_tpu_torch.convert import gather_params
    ctx = _dist_util.rank_context(device)
    gpu = ctx.device_type == "gpu"
    if gpu:
        torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    weights = dict(np.load(os.path.join(workdir, "weights.npz")))
    data = np.load(os.path.join(workdir, "data.npz"))
    mesh = mx.parallel.make_mesh(axes, devices=[ctx])
    net, trainer = _lc_trainer(mx, weights, ctx, mesh, T, cfg)
    x = mx.nd.array(data["x"], ctx=ctx, dtype="int32")
    y = mx.nd.array(data["y"], ctx=ctx, dtype="int32")
    counters = _lc_counters()
    _zero_counters(counters)
    if gpu:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    segments = sum(len(v) for v in trainer._segments.values())
    seg_elems = sum(w.numel() for v in trainer._segments.values() for w, _, _ in v)
    shard_elems = sum(max(0, min(zb["spec"].used_size, (r + 1) * zb["spec"].shard_size)
                          - r * zb["spec"].shard_size)
                      for zb in trainer._zero_buckets
                      for r in [mesh.axis_index("dp")])
    out = {"rank": mesh.rank, "coords": dict(mesh.coords), "ready_s": time.perf_counter() - t0,
           "segments": segments, "segment_elements": seg_elems, "shard_elements": shard_elems,
           "wd_groups": len(trainer._segments), "ring_step_bytes":
           trainer._ring_step_bytes(tuple(data["x"].shape))[0], "steps": []}
    for i in range(steps):
        before = {k: c.launches for k, c in counters.items()}
        flash = {k: (dict(c.launches_by_shape), dict(c.launches_by_mask))
                 for k, c in _flash_counters().items()}
        p2p = dict(_dist_util.p2p_stats)
        t_step = time.perf_counter()
        loss = float(trainer.step(x, y))
        if gpu:
            torch.cuda.synchronize()
        out["steps"].append({
            "loss": loss, "s": time.perf_counter() - t_step,
            "launches": {k: c.launches - before[k] for k, c in counters.items()},
            "by_shape": {k: {s: n - flash[k][0].get(s, 0) for s, n in
                             c.launches_by_shape.items() if n - flash[k][0].get(s, 0)}
                         for k, c in _flash_counters().items()},
            "by_mask": {k: {m: n - flash[k][1].get(m, 0) for m, n in
                            c.launches_by_mask.items() if n - flash[k][1].get(m, 0)}
                        for k, c in _flash_counters().items()},
            "p2p_bytes": _dist_util.p2p_stats["bytes"] - p2p["bytes"],
            "p2p_sends": _dist_util.p2p_stats["sends"] - p2p["sends"]})
        if i == 0:
            grads = {k: g.cpu().numpy() for k, g in trainer.gathered_grads().items()}
            if mesh.rank == 0:
                np.savez(os.path.join(workdir, "grads.npz"), **grads)
    params = gather_params(net)
    if mesh.rank == 0:
        np.savez(os.path.join(workdir, "params.npz"), **params)
    out["peak_bytes"] = torch.cuda.max_memory_allocated() if gpu else None
    out["device"] = str(ctx)
    return out


def phase_lc_ranks(torch, weights, device="gpu", axes=None, T=LC_RANKS_T, B=LC_RANKS_B,
                   steps=2, timeout=900, cfg=LC_CFG, label="lc-ranks"):
    """LongContextTrainer on dp2 x sp2 as 4 ranks sharing the card over gloo
    (a correctness run; the ring's sends go through host memory), the
    recipe's widths, T=8192, global batch 4, Adam, f32, ``steps`` steps, against the
    one-rank step (a mesh of one device) on the same global batch: losses to TOL_DIST_LOSS,
    gradients after step 1 to TOL_DIST_GRAD of each tensor's max, weights
    after the last to TOL_DIST_W. Each rank s of sp must launch K1 (and K2, K3)
    once a layer with the causal mask (its diagonal hop) and s times a layer
    without (the hops from earlier ranks), all at (B/dp*H, T/sp, T/sp, D),
    and K5 once a step over its shard's segments. ``cfg`` (LC_CFG) sets the
    model's widths: ``LC_DRYRUN_CFG``, dryrun_multichip's, runs K1-K3 at
    D = 16."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import _dist_util
    axes = axes or {"dp": 2, "sp": 2}
    n = axes["dp"] * axes["sp"]
    n_layers = cfg["num_layers"]
    heads = cfg["num_heads"]
    D = cfg["units"] // heads
    shape = f"{B // axes['dp'] * heads}x{T // axes['sp']}x{T // axes['sp']}x{D}"
    backend = _dist_util.choose_backend(device, n, torch.cuda.device_count()
                                        if device == "gpu" else 0)
    log(f"[{label}] {n} ranks {axes} on {device} over {backend}; LongContextLM {cfg}, "
        f"batch {B} x T {T}, {steps} Adam steps; hop shape {shape}")
    work = os.path.join(ROOT, "build", label)
    os.makedirs(work, exist_ok=True)
    tokens, labels = _lc_batch(B, T, seed=14)
    np.savez(os.path.join(work, "weights.npz"), **weights)
    np.savez(os.path.join(work, "data.npz"), x=tokens, y=labels)
    ctx = mx.gpu(0) if device == "gpu" else mx.cpu()
    net, trainer = _lc_trainer(mx, weights, ctx, mx.parallel.Mesh([ctx], ("dp", "sp"), (1, 1)), T,
                               cfg)
    xs, ys = (mx.nd.array(a, ctx=ctx, dtype="int32") for a in (tokens, labels))
    ref_losses = []
    for i in range(steps):
        ref_losses.append(float(trainer.step(xs, ys)))
        if i == 0:
            ref_grads = {k: g.cpu().numpy() for k, g in trainer.gathered_grads().items()}
    ref_weights = {k: p.data().asnumpy() for k, p in net._collect_params_with_prefix().items()}
    del trainer, net
    t_launch = time.perf_counter()
    ranks = _dist_util.launch_local(
        "chip_smoke:rank_lc", n, {"workdir": work, "axes": axes, "steps": steps, "T": T,
                                  "device": device, "lr": LC_LR, "cfg": cfg},
        device=device, timeout=timeout, pythonpath=[ROOT], workdir=os.path.join(work, "launch"))
    seconds = time.perf_counter() - t_launch
    worst_loss = 0.0
    for r in ranks:
        s = r["coords"]["sp"]
        losses = [st["loss"] for st in r["steps"]]
        worst_loss = max(worst_loss, max(abs(a - b) / abs(b) for a, b in zip(losses, ref_losses)))
        log(f"[{label}] rank {r['rank']} {r['coords']}: ready {r['ready_s']:.1f} s, steps "
            f"{[round(st['s'], 2) for st in r['steps']]} s, losses "
            f"{[round(v, 6) for v in losses]}; K1 by mask {r['steps'][-1]['by_mask']}; "
            f"K5 {[st['launches']['fused_adam_update'] for st in r['steps']]} over "
            f"{r['segments']} segments ({r['segment_elements']} of the shard's "
            f"{r['shard_elements']} used elements); P2P {r['steps'][-1]['p2p_bytes']} B in "
            f"{r['steps'][-1]['p2p_sends']} sends a step (the reference's estimate "
            f"{r['ring_step_bytes']} B)")
        if r["segment_elements"] != r["shard_elements"] or r["wd_groups"] != 1:
            raise AssertionError(f"rank {r['rank']}: segments cover {r['segment_elements']} "
                                 f"of {r['shard_elements']} shard elements")
        if device == "cpu":          # a rehearsal: the plain versions count nothing
            continue
        for i, st in enumerate(r["steps"]):
            want_mask = {"causal": n_layers, **({"full": s * n_layers} if s else {})}
            for k in _flash_counters():
                if st["by_mask"][k] != want_mask or \
                        st["by_shape"][k] != {shape: (s + 1) * n_layers}:
                    raise AssertionError(f"rank {r['rank']} step {i}: {k} launched "
                                         f"{st['by_mask'][k]} at {st['by_shape'][k]}, "
                                         f"expected {want_mask} at {shape}")
            if st["launches"]["fused_adam_update"] != 1:
                raise AssertionError(f"rank {r['rank']} step {i}: K5 launched "
                                     f"{st['launches']['fused_adam_update']} times")
    grads = dict(np.load(os.path.join(work, "grads.npz")))
    got_w = dict(np.load(os.path.join(work, "params.npz")))
    shutil.rmtree(work, ignore_errors=True)
    worst_grad = max(float(np.abs(grads[k] - g).max()) / max(float(np.abs(g).max()), 1e-30)
                     for k, g in ref_grads.items())
    worst_w = max(float(np.abs(got_w[k] - w).max()) for k, w in ref_weights.items())
    ok = (worst_loss <= TOL_DIST_LOSS and worst_grad <= TOL_DIST_GRAD
          and worst_w <= TOL_DIST_W and set(grads) == set(ref_grads))
    log(f"[{label}] against the one-rank step (losses {[round(v, 6) for v in ref_losses]}): "
        f"losses max rel {worst_loss:.2e} (tol {TOL_DIST_LOSS:.0e}), gradients after step 1 "
        f"{worst_grad:.2e} of each tensor's max (tol {TOL_DIST_GRAD:.0e}), weights after "
        f"step {steps} max|d| {worst_w:.2e} (tol {TOL_DIST_W:.0e}) {'ok' if ok else 'FAIL'}; "
        f"{n} ranks in {seconds:.1f} s (a correctness run: ranks sharing the card over gloo, "
        f"the ring's sends staged through host memory)")
    if not ok:
        raise AssertionError("the long-context ranks disagree with the one-rank step")
    return {"axes": axes, "backend": backend, "T": T, "B": B, "shape": shape,
            "seconds": seconds, "ref_losses": ref_losses, "loss_rel": worst_loss,
            "grad_rel": worst_grad, "weight_abs": worst_w, "ranks": ranks,
            "launches": {k: sum(st["launches"][k] for r in ranks for st in r["steps"])
                         for k in _lc_counters()}}


ZERO_CONFIGS = {"replicated": (False, None), "zero": (True, None),
                "zero_bfloat16": (True, "bfloat16"), "zero_int8": (True, "int8")}


def _wire_chunks(trainer):
    """Per parameter path, the wire chunk of each element: chunk j of bucket b
    (the slice of the flat bucket that rank j reduces) numbered across
    buckets. The int8 wire takes one scale per chunk and rank."""
    paths = {id(p): k for k, p in trainer.net._collect_params_with_prefix().items()}
    out, base = {}, 0
    for b in trainer._zero_plan:
        for i, o, n, shape in zip(b.indices, b.offsets, b.sizes, b.shapes):
            ids = base + (o + np.arange(n, dtype=np.int64)) // b.shard_size
            out[paths[id(trainer._plist[i])]] = ids.astype(np.int32).reshape(shape)
        base += b.ndp
    return out


def _wire_ratio(comm, n, rep, got, chunks):
    """The largest of |got - rep| over the wire's quantum, element by element:
    bf16 n 2^-8 of the tensor's max (each rank's value rounded once to an
    8-bit significand), int8 n / 127 of its chunk's max (one scale, max /
    127, per chunk and rank)."""
    if comm == "int8":
        ids = np.concatenate([chunks[k].ravel() for k in rep])
        cmax = np.zeros(int(ids.max()) + 1)
        np.maximum.at(cmax, ids, np.concatenate([np.abs(rep[k]).ravel() for k in rep]))
    worst = 0.0
    for key, r in rep.items():
        quantum = (n / 127.0 * cmax[chunks[key]] if comm == "int8"
                   else n * 2.0 ** -8 * np.abs(r).max())
        worst = max(worst, float((np.abs(got[key] - r) / np.maximum(quantum, 1e-30)).max()))
    return worst


def rank_zero_bert(workdir, cfg, steps, device, lr):
    """One rank of phase_zero_bert_ranks at dp2: each configuration of
    ZERO_CONFIGS for ``steps`` Adam steps from the same weights; rank 0
    writes the weights after the last step of each."""
    import torch
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import _dist_util
    from mxnet_tpu_torch.convert import gather_params, load_jax_params
    from mxnet_tpu_torch.models import BertModel
    ctx = _dist_util.rank_context(device)
    gpu = ctx.device_type == "gpu"
    if gpu:
        torch.backends.cuda.matmul.allow_tf32 = False
    weights = dict(np.load(os.path.join(workdir, "weights.npz")))
    data = np.load(os.path.join(workdir, "data.npz"))
    mesh = mx.parallel.make_mesh({"dp": 2}, devices=[ctx])
    x = mx.nd.array(data["x"], ctx=ctx, dtype="int32")
    y = mx.nd.array(data["y"], ctx=ctx, dtype="int32")
    counters = dict(_fused_counters(), **_flash_counters())
    out = {"rank": mesh.rank}
    for name, (zero, comm) in ZERO_CONFIGS.items():
        net = BertModel(**cfg)
        net.initialize(ctx=ctx)
        load_jax_params(net, weights)
        trainer = mx.parallel.DataParallelTrainer(
            net, mx.gluon.loss.SoftmaxCrossEntropyLoss(), "adam", {"learning_rate": lr},
            mesh=mesh, zero_update=zero, comm_dtype=comm)
        _zero_counters(counters)
        losses, secs = [], []
        for i in range(steps):
            t0 = time.perf_counter()
            losses.append(float(trainer.step(x, y)))
            secs.append(time.perf_counter() - t0)
            if i == 0:
                grads = {k: g.cpu().numpy() for k, g in trainer.gathered_grads().items()}
        params = gather_params(net)
        if mesh.rank == 0:
            np.savez(os.path.join(workdir, f"{name}.npz"), **params)
            np.savez(os.path.join(workdir, f"{name}_grads.npz"), **grads)
            if comm == "int8":
                np.savez(os.path.join(workdir, "chunks.npz"), **_wire_chunks(trainer))
        out[name] = {"losses": losses, "s": secs,
                     "state_bytes": trainer._opt_state_replica_bytes(),
                     "launches": {k: c.launches for k, c in counters.items() if c.launches},
                     "buckets": len(trainer._zero_plan) or len(trainer._buckets)}
        del trainer, net, params, grads
        if gpu:
            torch.cuda.empty_cache()
    return out


def phase_zero_bert_ranks(torch, device="gpu", cfg=None, steps=2, timeout=900):
    """DataParallelTrainer(zero_update=True) on 2 ranks at dp2 sharing the card
    over gloo (a correctness run): 2 layers of BERT-base width, T=1024, global
    batch 4, Adam lr 1e-4, 3 steps, with native, bf16 and int8 wire dtypes,
    against zero_update=False on the same ranks: native losses to
    TOL_ZERO_LOSS and weights to TOL_ZERO_W; bf16 and int8 with the step-1
    gradients within the wire's quantum, the losses within
    TOL_ZERO_COMPRESSED and the mean weight distance within
    TOL_ZERO_COMPRESSED_W lr x steps. Each rank's
    optimizer state must be about half the replicated step's, and every
    configuration must launch K5 once a step and K1-K3 once a layer."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import _dist_util
    from mxnet_tpu_torch.convert import seeded_params
    from mxnet_tpu_torch.models import BertModel
    cfg = cfg or dict(vocab_size=30522, num_layers=2, units=768, hidden_size=3072,
                      num_heads=12, max_length=1024)
    lr = 1e-4
    backend = _dist_util.choose_backend(device, 2, torch.cuda.device_count()
                                        if device == "gpu" else 0)
    work = os.path.join(ROOT, "build", "zero_bert")
    os.makedirs(work, exist_ok=True)
    net = BertModel(**cfg)
    net.initialize(ctx=mx.cpu())
    np.savez(os.path.join(work, "weights.npz"), **seeded_params(net, seed=15))
    del net
    rs = np.random.RandomState(16)
    T = cfg["max_length"]
    np.savez(os.path.join(work, "data.npz"),
             x=rs.randint(0, cfg["vocab_size"], size=(4, T)).astype(np.int32),
             y=rs.randint(0, cfg["vocab_size"], size=(4, T)).astype(np.int32))
    log(f"[zero-ranks] 2 ranks at dp2 on {device} over {backend}; BertModel {cfg}, batch "
        f"4 x {T}, {steps} Adam steps, configurations {list(ZERO_CONFIGS)}")
    t0 = time.perf_counter()
    ranks = _dist_util.launch_local(
        "chip_smoke:rank_zero_bert", 2, {"workdir": work, "cfg": cfg, "steps": steps,
                                         "device": device, "lr": lr},
        device=device, timeout=timeout, pythonpath=[ROOT], workdir=os.path.join(work, "launch"))
    seconds = time.perf_counter() - t0
    params = {name: dict(np.load(os.path.join(work, f"{name}.npz"))) for name in ZERO_CONFIGS}
    grads = {name: dict(np.load(os.path.join(work, f"{name}_grads.npz")))
             for name in ZERO_CONFIGS}
    chunks = dict(np.load(os.path.join(work, "chunks.npz")))
    shutil.rmtree(work, ignore_errors=True)
    rep_w = params["replicated"]
    out = {"seconds": seconds, "backend": backend, "cfg": cfg, "ranks": ranks, "configs": {}}
    ok = True
    n = cfg["num_layers"]
    for name in ZERO_CONFIGS:
        comm = ZERO_CONFIGS[name][1]
        loss_tol = TOL_ZERO_COMPRESSED.get(comm, TOL_ZERO_LOSS)
        loss_rel = max(abs(a - b) / abs(b) for r in ranks
                       for a, b in zip(r[name]["losses"], r["replicated"]["losses"]))
        w_abs = max(float(np.abs(params[name][k] - w).max()) for k, w in rep_w.items())
        w_mean = float(sum(np.abs(params[name][k] - w).sum() for k, w in rep_w.items())
                       / sum(w.size for w in rep_w.values())) / (lr * steps)
        wire = (_wire_ratio(comm, 2, grads["replicated"], grads[name], chunks)
                if comm else None)
        ratio = max(r[name]["state_bytes"] / r["replicated"]["state_bytes"] for r in ranks)
        launches = [r[name]["launches"] for r in ranks]
        if comm:
            w_check = (f"gradients {wire:.3f} of the wire's quantum (tol 1), weights mean|d| "
                       f"{w_mean:.2e} lr x steps (tol {TOL_ZERO_COMPRESSED_W[comm]:.0e}), "
                       f"max|d| {w_abs:.2e}")
            good = wire <= 1.0 and w_mean <= TOL_ZERO_COMPRESSED_W[comm]
        else:
            w_check = f"weights max|d| {w_abs:.2e} (tol {TOL_ZERO_W:.0e})"
            good = w_abs <= TOL_ZERO_W
        good = good and loss_rel <= loss_tol and \
            ranks[0][name]["losses"][-1] < ranks[0][name]["losses"][0]
        if name != "replicated":
            good = good and 0.45 <= ratio <= 0.55
        if device == "gpu":
            good = good and all(
                lc.get("fused_adam_update") == steps and lc.get("flash_attention_fwd") == n * steps
                and lc.get("flash_attention_bwd_dq") == n * steps
                and lc.get("flash_attention_bwd_dkv") == n * steps for lc in launches)
        ok = ok and good
        out["configs"][name] = {"loss_rel": loss_rel, "weight_abs": w_abs,
                                "weight_mean_lr_steps": w_mean, "wire_ratio": wire,
                                "state_ratio": ratio, "losses": ranks[0][name]["losses"],
                                "state_bytes": [r[name]["state_bytes"] for r in ranks],
                                "s": [r[name]["s"] for r in ranks], "launches": launches}
        log(f"[zero-ranks] {name}: losses {[round(v, 6) for v in ranks[0][name]['losses']]}, "
            f"against the replicated step max rel {loss_rel:.2e} (tol {loss_tol:.0e}), "
            f"{w_check}; optimizer state a rank "
            f"{[r[name]['state_bytes'] for r in ranks]} B ({ratio:.3f} of the replicated "
            f"step's); steps {[round(v, 2) for v in ranks[0][name]['s']]} s; launches "
            f"{launches[0]}; {'ok' if good else 'FAIL'}")
    log(f"[zero-ranks] 2 ranks in {seconds:.1f} s (a correctness run: ranks sharing the "
        f"card over gloo)")
    if not ok:
        raise AssertionError("the sharded update disagrees with the replicated step")
    return out


# --- elastic kill-and-resume: snapshot, kill and resume the fused step ----------

TOL_RESUME = 1e-6       # the resumed losses, relative (the reference's, __graft_entry__.py:155)
ELASTIC_STEPS, ELASTIC_EVERY = 8, 3
ELASTIC_LAYERS = 6      # the elastic phases' BERT: base width, depth cut to 6 of 12 layers
ELASTIC_CFG = dict(vocab_size=30522, num_layers=ELASTIC_LAYERS, units=768, hidden_size=3072,
                   num_heads=12, max_length=1024)
KILL_EVERY = 2          # phase_elastic_kill: the child saves every 2 steps, killed at 6
CHILD_TIMEOUT_S = 300


def _ratio(a, b):
    return a / b if b else float("nan")


def _elastic_counters():
    return dict(_flash_counters(), fused_adam_update=_fused_counters()["fused_adam_update"])


def _first_layers(params, n):
    """BERT weights less the encoder layers from ``n`` on: a model of the same
    width and ``n`` layers takes the first ``n`` of a deeper one's."""
    import re
    return {k: v for k, v in params.items()
            if not (m := re.search(r"encoder\.layers\.(\d+)\.", k)) or int(m.group(1)) < n}


def _bert_dp(mx, params, ctx, mesh, cfg=None, seed=None):
    """BERT (``cfg``; by default ELASTIC_CFG, BERT-base width and
    ELASTIC_LAYERS layers) under DataParallelTrainer with the dryrun's data
    spec, Adam lr 1e-4: the weights ``params`` (their first layers), or with
    ``params`` None its own initial weights (a rebuilt trainer before a
    resume)."""
    from mxnet_tpu_torch.convert import load_jax_params
    from mxnet_tpu_torch.models import BertModel
    if seed is not None:
        mx.random.seed(seed)
    cfg = cfg or ELASTIC_CFG
    net = BertModel(**cfg)
    net.initialize(ctx=ctx)
    if params is not None:
        load_jax_params(net, _first_layers(params, cfg["num_layers"]))
    return net, mx.parallel.DataParallelTrainer(
        net, mx.gluon.loss.SoftmaxCrossEntropyLoss(), "adam", {"learning_rate": 1e-4},
        mesh=mesh, data_spec=mx.parallel.P(*[a for a in ("dp", "sp") if a in mesh.shape]))


def _snapshot_equal(trainer, directory, step):
    """Every leaf of the trainer but ``rng`` against the snapshot's, bitwise:
    the names that differ and the bytes compared."""
    from mxnet_tpu_torch import elastic
    snap = elastic.capture(trainer)
    bad, nbytes = [], 0
    with elastic.SnapshotReader(directory, step) as rd:
        for name, leaf in snap["leaves"].items():
            if name == "rng":
                continue
            chunk = isinstance(leaf, elastic.state.Chunk)
            got = leaf.data.cpu().numpy() if chunk else np.asarray(leaf)
            want = rd.read_region(name, leaf.index) if chunk else rd(name)
            nbytes += want.nbytes
            if got.dtype != want.dtype or not np.array_equal(got.view(np.uint8),
                                                             want.view(np.uint8)):
                bad.append(name)
    return bad, nbytes


def phase_elastic_bert(torch, params, batch):
    """The main path at full width on the world-1 NCCL group the caller
    holds: BERT-base width (ELASTIC_CFG: 6 of its 12 layers) T=1024 batch 8,
    f32 (TF32 off), Adam lr 1e-4, through
    ``elastic.run(trainer, feed, num_steps=8, save_every=3)``: snapshots at
    steps 3 and 6 while the steps go on, and the final synchronous one at 8.
    Then a trainer with its own initial weights boots through
    ``resume_or_init`` from the snapshot of step 6 (step 8's removed, as if
    killed before it): ``(6, "resumed")``, every tensor bitwise the saved
    leaf, and steps 7-8 equal to the run's at TOL_RESUME. K1-K3 launch once a
    layer a step and K5 once, in both runs."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import elastic
    from mxnet_tpu_torch.elastic import manifest
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    tokens, labels = batch
    B, T = tokens.shape
    ctx = mx.gpu(0)
    mesh = mx.parallel.make_mesh({"dp": 1, "tp": 1, "sp": 1}, devices=[ctx])
    work = os.path.join(ROOT, "build", "elastic_bert")
    shutil.rmtree(work, ignore_errors=True)
    x = mx.nd.array(tokens, ctx=ctx, dtype="int32")
    y = mx.nd.array(labels, ctx=ctx, dtype="int32")
    net, trainer = _bert_dp(mx, params, ctx, mesh)
    n_layers = len(net.encoder.layers)
    mgr = elastic.SnapshotManager(work, save_interval_steps=ELASTIC_EVERY)
    counters = _elastic_counters()
    steps, saves = [], {}
    torch.cuda.synchronize()
    last = [time.perf_counter()]
    mem0 = torch.cuda.memory_allocated()

    def on_step(t, loss):
        torch.cuda.synchronize()
        now = time.perf_counter()
        steps.append({"step": t, "ms": (now - last[0]) * 1e3, "loss": float(loss),
                      "saved": mgr._last_saved == t})
        if mgr._last_saved == t:
            saves[t] = mgr.last_stats        # the writer fills in the rest
        last[0] = time.perf_counter()

    _zero_counters(counters)
    t_run = time.perf_counter()
    res = elastic.run(trainer, [(x, y)] * ELASTIC_STEPS, num_steps=ELASTIC_STEPS,
                      manager=mgr, on_step=on_step)
    run_s = time.perf_counter() - t_run
    launches = {k: c.launches for k, c in counters.items()}
    final = dict(mgr.last_stats, save_seconds=mgr.save_seconds)
    want = {"fused_adam_update": ELASTIC_STEPS, **{k: n_layers * ELASTIC_STEPS
                                                  for k in _flash_counters()}}
    losses = [st["loss"] for st in steps]
    plain = [st["ms"] for st in steps if not st["saved"] and st["step"] not in
             (1, ELASTIC_EVERY + 1, 2 * ELASTIC_EVERY + 1)]
    log(f"[elastic-bert] BERT-base width, {n_layers} layers, T={T} batch {B} f32 Adam on "
        f"{mesh} over NCCL: "
        f"elastic.run {ELASTIC_STEPS} steps, save_every {ELASTIC_EVERY}, {run_s:.2f} s; "
        f"steps (ms) {[round(st['ms'], 2) for st in steps]} (saves after "
        f"{sorted(saves)}); losses {[round(v, 6) for v in losses]}; launches {launches}")
    if res["step"] != ELASTIC_STEPS or res["preempted"]:
        raise AssertionError(f"elastic.run ended at {res}")
    if launches != want:
        raise AssertionError(f"elastic-bert: launches {launches}, expected {want}")
    if manifest.all_complete_steps(work) != [3, 6, 8]:
        raise AssertionError(f"snapshots {manifest.all_complete_steps(work)}, expected 3, 6, 8")
    bound_ms = None
    for t, st in sorted(saves.items()) + [(ELASTIC_STEPS, final)]:
        bound_ms = 2 * st["copy_bytes"] / PEAK_BYTES_PER_S * 1e3
        log(f"[elastic-bert] save at step {t}: save() waited {st['wait_s'] * 1e3:.2f} ms for "
            f"the previous write, then returned in {st['return_s'] * 1e3:.2f} ms; "
            f"device copy {st['copy_bytes'] / 1e9:.3f} GB in {st['d2d_ms']:.3f} ms (bound "
            f"{bound_ms:.3f} ms, read + write at 3.35 TB/s; {_ratio(bound_ms, st['d2d_ms']):.0%} "
            f"of it), extra device memory {st['device_extra_bytes'] / 2**30:.3f} GiB in flight; "
            f"D2H {st['d2h_ms']:.2f} ms ({_ratio(st['copy_bytes'] / 1e6, st['d2h_ms']):.2f} "
            f"GB/s), pinned buffer {st['host_alloc_s'] * 1e3:.1f} ms; write "
            f"{st['write_s']:.2f} s ({_ratio(st['nbytes'] / 1e9, st['write_s']):.2f} GB/s, "
            f"{st['nbytes']} B)")
    routes = _copy_routes(torch, trainer)
    # a kill before step 8's snapshot: the newest is step 6
    shutil.rmtree(manifest.step_path(work, ELASTIC_STEPS))
    del trainer, net, mgr
    torch.cuda.empty_cache()
    made = {}

    def rebuild():
        t0 = time.perf_counter()
        out = _bert_dp(mx, None, ctx, mesh, seed=123)
        torch.cuda.synchronize()
        made["s"] = time.perf_counter() - t0
        return out[1]

    t0 = time.perf_counter()
    _, tr2, start, outcome = elastic.resume_or_init(work, rebuild)
    resume_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    bad, compared = _snapshot_equal(tr2, work, start)
    _zero_counters(counters)
    got = [float(tr2.step(x, y)) for _ in range(ELASTIC_STEPS - start)]
    after = {k: c.launches for k, c in counters.items()}
    want2 = {"fused_adam_update": ELASTIC_STEPS - start,
             **{k: n_layers * (ELASTIC_STEPS - start) for k in _flash_counters()}}
    rel = max(abs(a - b) / abs(b) for a, b in zip(got, losses[start:]))
    ok = (start, outcome) == (2 * ELASTIC_EVERY, "resumed") and not bad and \
        rel <= TOL_RESUME and after == want2
    log(f"[elastic-bert] resume_or_init -> ({start}, {outcome!r}) in {resume_s:.2f} s "
        f"(trainer built in {made['s']:.2f} s, the rest reading and installing); "
        f"{compared / 1e9:.3f} GB of leaves against the snapshot bitwise: "
        f"{'equal' if not bad else f'{len(bad)} differ, e.g. {bad[:3]}'}; steps "
        f"{start + 1}-{ELASTIC_STEPS} losses {[round(v, 6) for v in got]} against the "
        f"uninterrupted {[round(v, 6) for v in losses[start:]]}: max rel {rel:.2e} (tol "
        f"{TOL_RESUME:.0e}); launches {after} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the resumed BERT-base run disagrees with the uninterrupted one")
    del tr2
    shutil.rmtree(work, ignore_errors=True)
    torch.cuda.empty_cache()
    steady = float(np.median(plain)) if plain else None
    return {"steps": steps, "losses": losses, "saves": {str(k): v for k, v in saves.items()},
            "copy_routes": routes,
            "final_save": final, "copy_bound_ms": bound_ms, "run_s": run_s,
            "step_median_ms": steady, "resume_s": resume_s, "rebuild_s": made["s"],
            "install_s": resume_s - made["s"], "bitwise_bytes": compared,
            "resumed_losses": got, "loss_rel": rel, "launches": {
                k: launches[k] + after[k] for k in launches},
            "device_base_bytes": mem0}


def _copy_routes(torch, trainer, reps=5):
    """The device copy of a snapshot's leaves two ways, in turns: one
    ``clone`` a leaf (the reference's per-leaf ``jnp.copy``) and
    ``SnapshotManager``'s one flat buffer and one multi-tensor copy. Each
    rep: the host's time to enqueue the copy, and the CUDA events' span (the
    device time, or the enqueue time where the device waits for the host).
    Medians of ``reps``."""
    from mxnet_tpu_torch import elastic
    from mxnet_tpu_torch.elastic.snapshot import _DeviceCopy
    tensors = [(n, v.data) for n, v in elastic.capture(trainer)["leaves"].items()
               if isinstance(v, elastic.state.Chunk) and v.owner]
    side = torch.cuda.Stream()
    routes = {"per_leaf": lambda: [t.clone() for _, t in tensors],
              "flat": lambda: _DeviceCopy(tensors[0][1].device, tensors, side)}
    times = {k: {"host_ms": [], "event_ms": []} for k in routes}
    for _ in range(reps):
        for name, fn in routes.items():
            torch.cuda.synchronize()
            a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            t0 = time.perf_counter()
            a.record()
            out = fn()
            b.record()
            host = (time.perf_counter() - t0) * 1e3
            torch.cuda.synchronize()
            times[name]["host_ms"].append(host)
            times[name]["event_ms"].append(a.elapsed_time(b))
            del out
    out = {k: {m: float(np.median(v)) for m, v in t.items()} for k, t in times.items()}
    log(f"[elastic-bert] the device copy of {len(tensors)} leaves, median of {reps}: one "
        f"clone a leaf is enqueued in {out['per_leaf']['host_ms']:.2f} ms on the host "
        f"({out['per_leaf']['event_ms']:.2f} ms between its events), one flat buffer and "
        f"one multi-tensor copy in {out['flat']['host_ms']:.2f} ms "
        f"({out['flat']['event_ms']:.2f} ms)")
    return dict(out, leaves=len(tensors))


def elastic_child(workdir, mode, directory, num_steps, save_every):
    """A child process of phase_elastic_kill: joins a world-1 NCCL group, boots
    the trainer of phase_elastic_bert (ELASTIC_CFG) from the saved weights through
    ``resume_or_init`` and runs ``elastic.run``, appending each step's loss to
    ``<mode>.losses`` (flushed); writes ``<mode>.json`` when the run returns."""
    import torch
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import _dist_util, elastic
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    params = dict(np.load(os.path.join(workdir, "weights.npz")))
    data = np.load(os.path.join(workdir, "data.npz"))
    _dist_util.init_process_group(
        device="gpu", rank=0, world_size=1,
        init_method=f"file://{os.path.join(workdir, f'{mode}.{os.getpid()}.rdv')}")
    ctx = mx.gpu(0)
    mesh = mx.parallel.make_mesh({"dp": 1, "tp": 1, "sp": 1}, devices=[ctx])
    x = mx.nd.array(data["x"], ctx=ctx, dtype="int32")
    y = mx.nd.array(data["y"], ctx=ctx, dtype="int32")
    mgr, trainer, start, outcome = elastic.resume_or_init(
        directory, lambda: _bert_dp(mx, params, ctx, mesh)[1],
        save_interval_steps=save_every)
    del params
    counters = _elastic_counters()
    _zero_counters(counters)
    log_path = os.path.join(workdir, f"{mode}.losses")
    with open(log_path, "a") as f:
        def on_step(t, loss):
            f.write(json.dumps({"step": t, "loss": float(loss)}) + "\n")
            f.flush()
        res = elastic.run(trainer, [(x, y)] * num_steps, num_steps=num_steps,
                          manager=mgr, on_step=on_step)
    out = {"start": start, "outcome": outcome, "step": res["step"],
           "n_layers": len(trainer.net.encoder.layers),
           "preempted": res["preempted"], "launches": {k: c.launches for k, c in
                                                       counters.items()},
           "steps_run": len(res["losses"])}
    with open(os.path.join(workdir, f"{mode}.json"), "w") as f:
        json.dump(out, f)
    _dist_util.destroy_process_group()


def _child(workdir, mode, directory, num_steps, save_every):
    code = (f"import sys; sys.path.insert(0, {ROOT!r}); import chip_smoke as cs; "
            f"cs.elastic_child({workdir!r}, {mode!r}, {directory!r}, {num_steps}, "
            f"{save_every})")
    out = open(os.path.join(workdir, f"{mode}.log"), "w")
    return subprocess.Popen([sys.executable, "-c", code], stdout=out,
                            stderr=subprocess.STDOUT, cwd=ROOT)


def _child_fail(workdir, mode, msg):
    with open(os.path.join(workdir, f"{mode}.log")) as f:
        tail = f.read()[-3000:]
    raise AssertionError(f"{msg}; the child's output ends:\n{tail}")


def _wait_child(proc, workdir, mode):
    try:
        rc = proc.wait(timeout=CHILD_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        _child_fail(workdir, mode, f"child {mode} still running after {CHILD_TIMEOUT_S} s")
    if rc != 0:
        _child_fail(workdir, mode, f"child {mode} exited {rc}")
    with open(os.path.join(workdir, f"{mode}.json")) as f:
        return json.load(f)


def _read_losses(workdir, mode):
    path = os.path.join(workdir, f"{mode}.losses")
    if not os.path.exists(path):
        return []
    with open(path) as f:
        return [json.loads(line) for line in f if line.endswith("\n")]


def phase_elastic_kill(torch, params, batch, ref_losses):
    """A real kill. A child process (same interpreter) trains phase_elastic_bert's
    BERT-base run with ``save_every=2`` and is sent SIGKILL once the step-4
    manifest exists and the step-6 write has begun; a second child boots
    through ``resume_or_init``: ``(4, "resumed")`` with the torn step-6
    directory invisible, then steps 5-8 (a snapshot at 5 and at 8, after
    which retention prunes the torn directory), their losses equal to the
    uninterrupted run's at TOL_RESUME; a third child, in a fresh directory, is
    sent SIGTERM after its second step: ``PreemptionGuard`` lets the step
    finish, the run writes a final snapshot and returns preempted. The
    children reuse the kernels built in ``build/``."""
    from mxnet_tpu_torch.elastic import manifest
    tokens, labels = batch
    work = os.path.join(ROOT, "build", "elastic_kill")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    np.savez(os.path.join(work, "weights.npz"), **params)
    np.savez(os.path.join(work, "data.npz"), x=tokens, y=labels)
    snap = os.path.join(work, "snap")
    t0 = time.perf_counter()
    proc = _child(work, "kill", snap, ELASTIC_STEPS, KILL_EVERY)
    torn = manifest.step_path(snap, 3 * KILL_EVERY)
    deadline = time.monotonic() + CHILD_TIMEOUT_S
    while not (manifest.latest_complete_step(snap) == 2 * KILL_EVERY and os.path.isdir(torn)):
        if proc.poll() is not None:
            _child_fail(work, "kill", f"the child exited ({proc.returncode}) before the kill")
        if time.monotonic() > deadline:
            proc.kill()
            _child_fail(work, "kill", "no step-6 write within the time limit")
        time.sleep(0.005)
    proc.send_signal(signal.SIGKILL)
    proc.wait()
    killed_s = time.perf_counter() - t0
    torn_files = sorted(os.listdir(torn)) if os.path.isdir(torn) else []
    latest = manifest.latest_complete_step(snap)
    ran = _read_losses(work, "kill")
    log(f"[elastic-kill] child 1 SIGKILLed after {killed_s:.1f} s, {len(ran)} steps run; "
        f"complete snapshots {manifest.all_complete_steps(snap)}, the torn step "
        f"{3 * KILL_EVERY} directory holds {torn_files}")
    if latest != 2 * KILL_EVERY or os.path.exists(os.path.join(torn, manifest.MANIFEST)):
        raise AssertionError(f"after the kill the latest complete snapshot is {latest}")
    t1 = time.perf_counter()
    res = _wait_child(_child(work, "resume", snap, ELASTIC_STEPS, 5), work, "resume")
    resume_s = time.perf_counter() - t1
    got = [r["loss"] for r in _read_losses(work, "resume")]
    rel = max(abs(a - b) / abs(b) for a, b in zip(got, ref_losses[res["start"]:]))
    pruned = not os.path.isdir(torn)
    n_layers = res["n_layers"]
    want = {"fused_adam_update": len(got), **{k: n_layers * len(got) for k in _flash_counters()}}
    ok = (res["start"], res["outcome"]) == (2 * KILL_EVERY, "resumed") and \
        len(got) == ELASTIC_STEPS - 2 * KILL_EVERY and rel <= TOL_RESUME and pruned and \
        manifest.all_complete_steps(snap)[-1] == ELASTIC_STEPS and res["launches"] == want
    log(f"[elastic-kill] child 2: resume_or_init -> ({res['start']}, {res['outcome']!r}); "
        f"steps {res['start'] + 1}-{res['step']} losses {[round(v, 6) for v in got]} against "
        f"the uninterrupted {[round(v, 6) for v in ref_losses[res['start']:]]}: max rel "
        f"{rel:.2e} (tol {TOL_RESUME:.0e}); torn directory pruned: {pruned}; snapshots "
        f"{manifest.all_complete_steps(snap)}; launches {res['launches']}; {resume_s:.1f} s "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the run resumed after SIGKILL disagrees with the uninterrupted one")
    snap3 = os.path.join(work, "snap_term")
    t2 = time.perf_counter()
    proc = _child(work, "term", snap3, 100, 0)
    deadline = time.monotonic() + CHILD_TIMEOUT_S
    while len(_read_losses(work, "term")) < 2:
        if proc.poll() is not None:
            _child_fail(work, "term", f"the child exited ({proc.returncode}) before SIGTERM")
        if time.monotonic() > deadline:
            proc.kill()
            _child_fail(work, "term", "no second step within the time limit")
        time.sleep(0.005)
    proc.send_signal(signal.SIGTERM)
    term = _wait_child(proc, work, "term")
    term_s = time.perf_counter() - t2
    final = manifest.all_complete_steps(snap3)
    ok = term["preempted"] and term["outcome"] == "fresh" and final == [term["step"]] and \
        term["step"] >= 2
    log(f"[elastic-kill] child 3: SIGTERM after its step 2 -> preempted {term['preempted']} "
        f"at step {term['step']}, final snapshot(s) {final}; {term_s:.1f} s "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("SIGTERM did not end in a final snapshot")
    shutil.rmtree(work, ignore_errors=True)
    return {"killed_after_s": killed_s, "steps_before_kill": len(ran), "torn_files": torn_files,
            "resume": res, "resumed_losses": got, "loss_rel": rel, "resume_child_s": resume_s,
            "term": term, "term_child_s": term_s,
            "launches": {k: res["launches"].get(k, 0) + term["launches"].get(k, 0)
                         for k in _elastic_counters()}}


def _check_ownership(directory, step, axes):
    """The manifest's chunks against the ownership rule on a dp x tp x sp mesh:
    every leaf tiled exactly once; a leaf in one chunk written by rank 0; a
    tensor-parallel leaf in tp chunks along one dim, chunk t written by the
    rank at (dp 0, tp t, sp 0). Returns the number of tp-split leaves."""
    from mxnet_tpu_torch.elastic import manifest
    man = manifest.load(directory, step)
    names = tuple(axes)
    shape = tuple(axes.values())

    def file_of(coords):
        r = 0
        for a, n in zip(names, shape):
            r = r * n + coords.get(a, 0)
        return f"shard-{r:05d}.npz"

    split = 0
    for leaf, spec in man["leaves"].items():
        chunks = man["chunks"][leaf]
        size = int(np.prod(spec["shape"], dtype=np.int64))
        covered = sum(int(np.prod([b - a for a, b in c["index"]], dtype=np.int64))
                      for c in chunks)
        regions = {tuple(map(tuple, c["index"])) for c in chunks}
        if covered != size or len(regions) != len(chunks):
            raise AssertionError(f"leaf {leaf}: chunks cover {covered} of {size}")
        if len(chunks) == 1:
            if chunks[0]["file"] != "shard-00000.npz":
                raise AssertionError(f"replicated leaf {leaf} written by {chunks[0]['file']}")
            continue
        if len(chunks) != axes["tp"]:
            raise AssertionError(f"leaf {leaf} in {len(chunks)} chunks")
        dims = [d for d, n in enumerate(spec["shape"])
                if chunks[0]["index"][d] != [0, n]]
        step_ = spec["shape"][dims[0]] // axes["tp"]
        for c in chunks:
            t = c["index"][dims[0]][0] // step_
            if c["file"] != file_of({"tp": t}):
                raise AssertionError(f"leaf {leaf} tp shard {t} written by {c['file']}")
        split += 1
    return split


def rank_elastic_zero(workdir, cfg, device, lr, modes):
    """One rank of phase_elastic_zero_reshard, running each of ``modes`` in
    turn on this world's dp (``zero_update=True``, one shard a rank).
    ``save``: 2 steps from the saved weights, a snapshot to ``dp<n>``, step 3.
    ``resume``: boot from the other degree's snapshot through
    ``resume_or_init``, hold this rank's re-packed Adam lanes against
    ``_revector`` of the saved ones, bitwise, then step 3. Rank 0 writes the
    weights after each step 3 to ``<mode>_dp<n>.npz``."""
    import torch
    import torch.distributed as dist
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import _dist_util, elastic
    from mxnet_tpu_torch.convert import gather_params, load_jax_params
    from mxnet_tpu_torch.elastic import state as es
    from mxnet_tpu_torch.models import BertModel
    ctx = _dist_util.rank_context(device)
    if ctx.device_type == "gpu":
        torch.backends.cuda.matmul.allow_tf32 = False
    n = dist.get_world_size()
    data = np.load(os.path.join(workdir, "data.npz"))
    mesh = mx.parallel.make_mesh({"dp": n}, devices=[ctx])
    x = mx.nd.array(data["x"], ctx=ctx, dtype="int32")
    y = mx.nd.array(data["y"], ctx=ctx, dtype="int32")

    def make(weights):
        net = BertModel(**cfg)
        net.initialize(ctx=ctx)
        if weights is not None:
            load_jax_params(net, weights)
        return net, mx.parallel.DataParallelTrainer(
            net, mx.gluon.loss.SoftmaxCrossEntropyLoss(), "adam", {"learning_rate": lr},
            mesh=mesh, zero_update=True)

    counters = _elastic_counters()
    results = {}
    for mode in modes:
        _zero_counters(counters)
        out = {"rank": mesh.rank, "world": n}
        t0 = time.perf_counter()
        if mode == "save":
            net, trainer = make(dict(np.load(os.path.join(workdir, "weights.npz"))))
            out["losses"] = [float(trainer.step(x, y)) for _ in range(2)]
            mgr = elastic.SnapshotManager(os.path.join(workdir, f"dp{n}"))
            elastic.save_trainer(mgr, trainer, wait=True)
            out["start"], out["outcome"] = 0, "fresh"
        else:
            src = os.path.join(workdir, f"dp{3 - n}")
            holder = {}

            def rebuild():
                holder["net"], tr = make(None)
                return tr
            _, trainer, out["start"], out["outcome"] = elastic.resume_or_init(src, rebuild)
            net = holder["net"]
            with elastic.SnapshotReader(src, out["start"]) as rd:
                old = [es._bucket_from(d) for d in rd.manifest["meta"]["zero_plan"]]
                pos = mesh.axis_index("dp")
                same = True
                for b, zb in zip(trainer._zero_plan, trainer._zero_buckets):
                    for k, lane in enumerate(zb["state"]):
                        full = es._revector(old, [rd(f"opt.b{jo}.{k + 1}")
                                                  for jo in range(len(old))], b)
                        want = full[pos * b.shard_size:(pos + 1) * b.shard_size]
                        same = same and np.array_equal(lane.cpu().numpy().view(np.uint32),
                                                       want.view(np.uint32))
            out["lanes_bitwise"] = same
            out["buckets"] = [len(old), len(trainer._zero_plan)]
            out["losses"] = []
        out["losses"].append(float(trainer.step(x, y)))
        out["launches"] = {k: c.launches for k, c in counters.items()}
        out["s"] = time.perf_counter() - t0
        params = gather_params(net)
        if mesh.rank == 0:
            np.savez(os.path.join(workdir, f"{mode}_dp{n}.npz"), **params)
        results[mode] = out
        del trainer, net, params
        if ctx.device_type == "gpu":
            torch.cuda.empty_cache()
    return results


def phase_elastic_zero_reshard(torch, device="gpu", cfg=None, timeout=900):
    """The ZeRO state across data degrees, with phase_zero_bert_ranks' model
    (2 layers of BERT-base width, T=1024, global batch 4, Adam lr 1e-4,
    ``zero_update=True``): a snapshot after step 2 on dp2 (2 ranks sharing the
    card over gloo) resumed at world 1 (NCCL): ``"resharded"``, every Adam lane
    bitwise ``_revector`` of the saved lanes, and step 3's loss and weights
    against the 2-rank run's step 3 at TOL_ZERO_LOSS / TOL_ZERO_W; then the
    reverse, a dp1 snapshot resumed on dp2."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import _dist_util
    from mxnet_tpu_torch.convert import seeded_params
    from mxnet_tpu_torch.models import BertModel
    cfg = cfg or dict(vocab_size=30522, num_layers=2, units=768, hidden_size=3072,
                      num_heads=12, max_length=1024)
    lr = 1e-4
    work = os.path.join(ROOT, "build", "elastic_zero")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    net = BertModel(**cfg)
    net.initialize(ctx=mx.cpu())
    np.savez(os.path.join(work, "weights.npz"), **seeded_params(net, seed=15))
    del net
    rs = np.random.RandomState(16)
    T = cfg["max_length"]
    np.savez(os.path.join(work, "data.npz"),
             x=rs.randint(0, cfg["vocab_size"], size=(4, T)).astype(np.int32),
             y=rs.randint(0, cfg["vocab_size"], size=(4, T)).astype(np.int32))
    t0 = time.perf_counter()
    runs = {}
    for modes, n in ((("save",), 2), (("resume", "save"), 1), (("resume",), 2)):
        out = _dist_util.launch_local(
            "chip_smoke:rank_elastic_zero", n, {"workdir": work, "cfg": cfg, "device": device,
                                                "lr": lr, "modes": modes},
            device=device, timeout=timeout, pythonpath=[ROOT],
            workdir=os.path.join(work, f"launch_{'_'.join(modes)}_dp{n}"))
        for mode in modes:
            runs[f"{mode}_dp{n}"] = [r[mode] for r in out]
    seconds = time.perf_counter() - t0
    w = {k: dict(np.load(os.path.join(work, f"{k}.npz"))) for k in runs}
    shutil.rmtree(work, ignore_errors=True)
    out = {"seconds": seconds, "cfg": cfg, "runs": runs}
    ok = True
    n_layers = cfg["num_layers"]
    for resumed, saved in (("resume_dp1", "save_dp2"), ("resume_dp2", "save_dp1")):
        r, s = runs[resumed], runs[saved]
        loss_rel = max(abs(a["losses"][0] - b["losses"][2]) / abs(b["losses"][2])
                       for a in r for b in s)
        w_abs = max(float(np.abs(w[resumed][k] - v).max()) for k, v in w[saved].items())
        good = all(a["start"] == 2 and a["outcome"] == "resharded" and a["lanes_bitwise"]
                   for a in r) and loss_rel <= TOL_ZERO_LOSS and w_abs <= TOL_ZERO_W
        if device == "gpu":
            good = good and all(a["launches"].get("fused_adam_update") == 1 and all(
                a["launches"].get(k) == n_layers for k in _flash_counters()) for a in r)
        ok = ok and good
        out[resumed] = {"loss_rel": loss_rel, "weight_abs": w_abs,
                        "outcome": [a["outcome"] for a in r],
                        "lanes_bitwise": [a["lanes_bitwise"] for a in r],
                        "buckets": r[0]["buckets"]}
        log(f"[elastic-zero] {saved} -> {resumed}: resume_or_init -> "
            f"{[(a['start'], a['outcome']) for a in r]}, buckets (saved, new) "
            f"{r[0]['buckets']}, Adam lanes bitwise _revector of the saved: "
            f"{[a['lanes_bitwise'] for a in r]}; step 3 loss {r[0]['losses'][0]:.6f} against "
            f"{s[0]['losses'][2]:.6f} (max rel {loss_rel:.2e}, tol {TOL_ZERO_LOSS:.0e}), "
            f"weights max|d| {w_abs:.2e} (tol {TOL_ZERO_W:.0e}); launches "
            f"{r[0]['launches']} {'ok' if good else 'FAIL'}")
    log(f"[elastic-zero] 3 launches in {seconds:.1f} s (dp2 ranks sharing the card over gloo)")
    if not ok:
        raise AssertionError("the ZeRO resume across data degrees disagrees")
    out["launches"] = {k: sum(a["launches"].get(k, 0) for rr in runs.values() for a in rr)
                       for k in _elastic_counters()}
    return out


def phase_elastic_lc(torch, weights):
    """LongContextTrainer at phase_lc_train's path (T=32768, batch 4, causal
    K1-K3 at D=32, the world-1 NCCL group the caller holds): 2 steps, a
    snapshot, step 3; a trainer with its own initial weights resumed from it:
    ``(2, "resumed")`` and step 3 at TOL_RESUME."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import elastic
    from mxnet_tpu_torch.recipes import get_recipe
    torch.backends.cuda.matmul.allow_tf32 = False
    ctx = mx.gpu(0)
    mesh = mx.parallel.make_mesh({"dp": 1, "sp": 1}, devices=[ctx])
    work = os.path.join(ROOT, "build", "elastic_lc")
    shutil.rmtree(work, ignore_errors=True)
    net, trainer = _lc_trainer(mx, weights, ctx, mesh, LC_T)
    tokens, labels = _lc_batch(LC_B, LC_T, seed=12)
    x = mx.nd.array(tokens, ctx=ctx, dtype="int32")
    y = mx.nd.array(labels, ctx=ctx, dtype="int32")
    counters = _elastic_counters()
    _zero_counters(counters)
    for _ in range(2):
        trainer.step(x, y)
    mgr = elastic.SnapshotManager(work)
    elastic.save_trainer(mgr, trainer, wait=True)
    stats = dict(mgr.last_stats)
    expect = float(trainer.step(x, y))
    del trainer, net
    recipe = get_recipe("long_context")

    def rebuild():
        mx.random.seed(321)
        net2 = recipe.build_model(vocab_size=LC_VOCAB, seq_len=LC_T, ctx=ctx, **LC_CFG)
        return recipe.build_trainer(net2, mesh, learning_rate=LC_LR)

    t0 = time.perf_counter()
    _, tr2, start, outcome = elastic.resume_or_init(work, rebuild)
    resume_s = time.perf_counter() - t0
    bad, _ = _snapshot_equal(tr2, work, start)
    got = float(tr2.step(x, y))
    launches = {k: c.launches for k, c in counters.items()}
    rel = abs(got - expect) / abs(expect)
    n = LC_CFG["num_layers"]
    want = {"fused_adam_update": 4, **{k: 4 * n for k in _flash_counters()}}
    ok = (start, outcome) == (2, "resumed") and rel <= TOL_RESUME and not bad and launches == want
    log(f"[elastic-lc] LongContextTrainer T={LC_T} batch {LC_B}: snapshot after step 2 "
        f"({stats['copy_bytes'] / 1e6:.1f} MB, save() {stats['return_s'] * 1e3:.2f} ms), "
        f"resume_or_init -> ({start}, {outcome!r}) in {resume_s:.2f} s, leaves bitwise: "
        f"{not bad}; step 3 loss {got:.6f} against {expect:.6f} (rel {rel:.2e}, tol "
        f"{TOL_RESUME:.0e}); launches {launches} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the resumed long-context run disagrees")
    del tr2
    shutil.rmtree(work, ignore_errors=True)
    torch.cuda.empty_cache()
    return {"start": start, "outcome": outcome, "loss": got, "expect": expect, "rel": rel,
            "resume_s": resume_s, "save": stats, "launches": launches}


# -- the MoE half of dryrun_multichip -----------------------------------------------------
# Switch-Base-8's published widths (Fedus et al. 2021, arXiv:2101.03961; the
# google/switch-base-8 config) in the repository's decoder-only MoE LM, every
# cell's FFN a mixture; T = 1024 so that the attention takes K1-K3
# (MXNET_FLASH_ATTENTION_MIN_SEQ). Depth cut to 4 of the 12 layers (210 M of
# the 532 M parameters) to keep the script in its time; the rank phases run 2.
MOE_CFG = dict(vocab_size=32128, num_layers=4, units=768, hidden_size=3072, num_heads=12,
               num_experts=8, top_k=1, capacity_factor=1.25, max_length=1024)
MOE_T, MOE_B = 1024, 8
MOE_LR = 1e-4
MOE_RANK_LAYERS = 2
MOE_RANKS_B = 4                    # one sequence a rank on 4 ranks
MOE_CHECK_B = 1
# the dryrun's functional call (__graft_entry__.py:188-203 on 4 devices)
MOE_DRYRUN = dict(E=4, D=16, H=32, tokens=32, top_k=1, capacity_factor=4.0)
TOL_MOE_DRYRUN = 2e-5              # tests/test_recipes.py:192-214's
TOL_MOE_RESUME = 1e-5              # __graft_entry__.py:237's


def moe_train_flops(B, T, cfg, shards=1, dispatch=False):
    """bench.py:1874's analytic FLOPs of one MoE training step, 3x the
    forward: attention, gate, the experts over every slot, the decoder; the
    one-hot dispatch/combine einsums' term only with ``dispatch`` (the
    port gathers instead)."""
    N = B * T
    units, hidden, E = cfg["units"], cfg["hidden_size"], cfg["num_experts"]
    cap = max(1, int(cfg["capacity_factor"] * (N // shards) * cfg["top_k"] / E))
    attn = 2 * N * units * 3 * units + 4 * N * T * units + 2 * N * units * units
    gate = 2 * N * units * E
    expert = 2 * 2 * shards * E * cap * units * hidden
    one_hot = 2 * 2 * N * E * cap * units if dispatch else 0
    return 3 * (cfg["num_layers"] * (attn + gate + expert + one_hot)
                + 2 * N * units * cfg["vocab_size"])


def _moe_weights(cfg, seed):
    """Seeded f32 weights for every path of the MoE LM at ``cfg`` (the model
    is built for its shapes only, never initialized)."""
    from mxnet_tpu_torch.convert import seeded_params
    from mxnet_tpu_torch.models import MoETransformerLM
    return seeded_params(MoETransformerLM(**cfg), seed)


def _moe_batch(B, T, seed, vocab=None):
    vocab = vocab or MOE_CFG["vocab_size"]
    rs = np.random.RandomState(seed)
    return (rs.randint(0, vocab, size=(B, T)).astype(np.int32),
            rs.randint(0, vocab, size=(B, T)).astype(np.int32))


def _moe_net(mx, weights, ctx, cfg=None):
    """``MoETransformerLM(**cfg)`` (default MOE_CFG) on ``ctx`` with
    ``weights`` (the main path's entry points: the class, ``initialize``,
    ``load_jax_params``)."""
    from mxnet_tpu_torch.convert import load_jax_params
    from mxnet_tpu_torch.models import MoETransformerLM
    net = MoETransformerLM(**(cfg or MOE_CFG))
    net.initialize(ctx=ctx)
    load_jax_params(net, weights)
    return net


def _moe_trainer(net, mesh):
    from mxnet_tpu_torch.recipes import get_recipe
    return get_recipe("moe").build_trainer(net, mesh, learning_rate=MOE_LR)


def _flips(a, b):
    """Tokens whose routing differs between two runs' ``last_assignments``."""
    return sum(int((np.asarray(x) != np.asarray(y)).any(axis=-1).sum()) for x, y in zip(a, b))


def phase_moe_train(torch, weights):
    """The main path of the MoE slice on a world-1 NCCL mesh {dp: 1, ep: 1}
    (the caller holds the process group): ``MoETransformerLM`` at
    Switch-Base-8's widths, seeded weights through ``load_jax_params``,
    ``get_recipe("moe").build_trainer``, Adam lr 1e-4, f32 with TF32 off,
    T=1024 batch 8; 5 steps and one profiled, then ``drain()``. Each step
    must launch K1, K2 and K3 once a layer and K5 once (the dense shard
    segments and the expert tensors under one weight decay), and the loss
    must fall."""
    import torch.distributed as dist
    import mxnet_tpu_torch as mx
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    mesh = mx.parallel.make_mesh({"dp": 1, "ep": 1}, devices=[mx.gpu(0)])
    net = _moe_net(mx, weights, mx.gpu(0))
    trainer = _moe_trainer(net, mesh)
    ready_s = time.perf_counter() - t0
    tokens, labels = _moe_batch(MOE_B, MOE_T, seed=31)
    x = mx.nd.array(tokens, ctx=mx.gpu(0), dtype="int32")
    y = mx.nd.array(labels, ctx=mx.gpu(0), dtype="int32")
    n = MOE_CFG["num_layers"]
    counters = _elastic_counters()
    per_step = {"flash_attention_fwd": n, "flash_attention_bwd_dq": n,
                "flash_attention_bwd_dkv": n, "fused_adam_update": 1}
    n_params = sum(int(np.prod(p.shape)) for p in net.collect_params().values())
    n_expert = sum(int(np.prod(p.shape)) for p in net.collect_params().values()
                   if getattr(p, "_is_moe_expert", False))
    label = "moe-train"
    cap = mx.parallel.moe_capacity(MOE_B * MOE_T, 1, MOE_CFG["capacity_factor"],
                                   MOE_CFG["num_experts"])
    log(f"[{label}] MoETransformerLM {MOE_CFG}: {n_params} parameters ({n_expert} in the "
        f"experts), batch {MOE_B} x T {MOE_T}, capacity {cap} slots an expert, {mesh} over "
        f"{dist.get_backend()}, {len(trainer._zero_plan)} ZeRO bucket(s), "
        f"{len(trainer._buckets)} expert gradient bucket(s); ready in {ready_s:.1f} s")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_counters(counters)
    steps = _dp_steps(torch, label, trainer, x, y, 5, per_step,
                      (MOE_B * MOE_T, "tokens_per_s"), counters)
    launches = {k: c.launches for k, c in counters.items()}
    peak = torch.cuda.max_memory_allocated()
    trainer.drain()
    dropped = trainer.global_dropped_tokens()
    if not steps[-1]["loss"] < steps[0]["loss"]:
        raise AssertionError(f"{label}: the loss did not fall")
    profile = _step_profile(torch, f"{label} step", lambda: trainer.step(x, y), steps)
    med = float(np.median([st["ms"] for st in steps if not st["warmup"]]))
    flops = moe_train_flops(MOE_B, MOE_T, MOE_CFG)
    flops_einsum = moe_train_flops(MOE_B, MOE_T, MOE_CFG, dispatch=True)
    tflops = flops / med / 1e9
    log(f"[{label}] median step {med:.2f} ms, {MOE_B * MOE_T / med * 1e3:.0f} tokens/s, "
        f"{tflops:.1f} TFLOP/s of {flops / 1e12:.3f} TFLOP a step (bench.py:1874's count "
        f"without the one-hot dispatch/combine term, which the port does not run; with it "
        f"{flops_einsum / 1e12:.3f} TFLOP); launches {launches} over 5 steps; peak "
        f"{peak / 2**30:.3f} GiB; dropped (token, choice) assignments {dropped} of "
        f"{5 * MOE_B * MOE_T} in 5 steps; a profiled step "
        f"{sum(profile['group_launches'].values())} launches")
    out = {"steps": steps, "step_median_ms": med, "tokens_per_s": MOE_B * MOE_T / med * 1e3,
           "flops_per_step": flops, "flops_per_step_with_one_hot": flops_einsum,
           "tflops": tflops, "launches": launches, "per_step": per_step, "peak_bytes": peak,
           "dropped": dropped, "profile": profile, "capacity": cap, "parameters": n_params,
           "expert_parameters": n_expert, "ready_s": ready_s,
           "launches_per_step": sum(profile["group_launches"].values())}
    del trainer, net, x, y
    torch.cuda.empty_cache()
    return out


def phase_moe_serve(torch, weights):
    """The Switch-Base-8-width MoE LM's forward outside a trainer (``net(tokens)``,
    ``moe_ffn`` in every cell) at T=1024: batch 1 (a warm-up), 1, 8, 8; each
    forward launches K1 once a layer. The batch-1 logits against the CPU's
    (the plain versions), f32, TF32 off, at TOL_LOGITS with the routing
    compared first."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.ops.cuda import flash_attention as fa
    from mxnet_tpu_torch.parallel import moe as pmoe
    torch.backends.cuda.matmul.allow_tf32 = False
    net = _moe_net(mx, weights, mx.gpu(0))
    n = MOE_CFG["num_layers"]
    rs = np.random.RandomState(32)
    requests = [rs.randint(0, MOE_CFG["vocab_size"], size=(b, MOE_T)).astype(np.int32)
                for b in (1, 1, 8, 8)]
    counters = {"flash_attention_fwd": fa.flash_attention_fwd}
    _zero_counters(counters)
    torch.cuda.reset_peak_memory_stats()
    served, first = [], None
    with torch.no_grad():
        for i, tokens in enumerate(requests):
            before = fa.flash_attention_fwd.launches
            t_start = time.perf_counter()
            with pmoe.collect_metrics() as mc:
                logits = net(mx.nd.array(tokens, ctx=mx.gpu(0), dtype="int32"))
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t_start) * 1e3
            launched = fa.flash_attention_fwd.launches - before
            B = tokens.shape[0]
            finite = bool(torch.isfinite(logits._data).all().item())
            log(f"[moe-serve] request {i} batch={B} T={MOE_T}: {ms:.2f} ms, "
                f"{B * MOE_T / ms * 1e3:.0f} tokens/s, K1 launches {launched}, dropped "
                f"{int(mc.dropped_total())}" + (" (warm-up)" if i == 0 else ""))
            if launched != n or not finite or \
                    logits.shape != (B, MOE_T, MOE_CFG["vocab_size"]):
                raise AssertionError(f"moe-serve: {launched} K1 launches, finite={finite}, "
                                     f"logits {logits.shape}")
            if i == 1:
                first = (logits.asnumpy(), [a.cpu().numpy() for a in mc.assignments])
            served.append({"batch": B, "ms": ms, "tokens_per_s": B * MOE_T / ms * 1e3,
                           "warmup": i == 0})
            del logits
    launches = {"flash_attention_fwd": fa.flash_attention_fwd.launches}
    peak = torch.cuda.max_memory_allocated()
    del net
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    net_cpu = _moe_net(mx, weights, mx.cpu())
    with torch.no_grad(), pmoe.collect_metrics() as mc:
        ref = net_cpu(mx.nd.array(requests[1], ctx=mx.cpu(), dtype="int32")).asnumpy()
    flips = _flips(first[1], [a.numpy() for a in mc.assignments])
    rel = float(np.abs(ref - first[0]).max() / np.abs(ref).max())
    ok = flips == 0 and rel <= TOL_LOGITS
    log(f"[moe-serve] batch-1 logits, GPU vs CPU: routing flips {flips}, max|d| {rel:.3e} "
        f"of max|logit| {np.abs(ref).max():.3f} (tol {TOL_LOGITS:.0e}); CPU run "
        f"{time.perf_counter() - t0:.1f} s; launches {launches}; peak {peak / 2**30:.3f} GiB "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the MoE forward on the card disagrees with the CPU")
    batch8 = [r["ms"] for r in served if r["batch"] == 8]
    return {"requests": served, "batch8_ms": float(np.median(batch8)), "launches": launches,
            "peak_bytes": peak, "cpu_rel": rel, "flips": flips}


def _moe_step(mx, weights, ctx, mesh, x, y, cfg):
    net = _moe_net(mx, weights, ctx, cfg)
    trainer = _moe_trainer(net, mesh)
    loss = float(trainer.step(*(mx.nd.array(a, ctx=ctx, dtype="int32") for a in (x, y))))
    grads = {k: g.cpu().numpy() for k, g in trainer.gathered_grads().items()}
    routes = [a.cpu().numpy() for a in trainer.last_assignments]
    keys = net._collect_params_with_prefix()
    return (loss, grads, {k: p.data().asnumpy() for k, p in keys.items()}), routes


def phase_moe_check(torch, cfg=None):
    """One MoETrainer step of a 2-layer model of Switch-Base-8 width, T=1024,
    batch 1: on the card over the world-1 NCCL mesh (the caller's group:
    expert_parallel_moe over ep 1, the sharded update at dp 1) against the
    CPU on a mesh of one device (moe_ffn, the kernels' plain versions), f32
    with TF32 off; the routing compared first (flips reported), then the
    training checks' tolerances (_step_agreement)."""
    import mxnet_tpu_torch as mx
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = cfg or dict(MOE_CFG, num_layers=MOE_RANK_LAYERS)
    t0 = time.perf_counter()
    weights = _moe_weights(cfg, seed=33)
    x, y = _moe_batch(MOE_CHECK_B, MOE_T, seed=34, vocab=cfg["vocab_size"])
    gpu, routes_gpu = _moe_step(mx, weights, mx.gpu(0), mx.parallel.make_mesh(
        {"dp": 1, "ep": 1}, devices=[mx.gpu(0)]), x, y, cfg)
    torch.cuda.empty_cache()
    cpu, routes_cpu = _moe_step(mx, weights, mx.cpu(),
                                mx.parallel.Mesh([mx.cpu()], ("dp", "ep"), (1, 1)), x, y, cfg)
    flips = _flips(routes_gpu, routes_cpu)
    res = _step_agreement(gpu, cpu, MOE_LR)
    ok = res.pop("ok") and flips == 0
    log(f"[moe-check] {cfg['num_layers']} layers of Switch-Base-8 width, T={MOE_T}, batch "
        f"{MOE_CHECK_B}, one MoETrainer step, GPU (NCCL world 1) vs CPU: routing flips "
        f"{flips}; loss {gpu[0]:.6f} vs {cpu[0]:.6f} (rel {res['loss_rel']:.2e}, tol "
        f"{TOL_TRAIN_LOSS:.0e}); gradients {res['grad_rel']:.2e} of the tensor's max (tol "
        f"{TOL_TRAIN_GRAD:.0e}); weights max|d| {res['weight_max_abs']:.2e} (tol "
        f"{TOL_TRAIN_W:.0e}), {res['near_zero_grad_elements']} elements with a nonzero |g| "
        f"within the gradient tolerance of 0 up to {res['near_zero_weight_max_abs']:.2e} "
        f"(tol 2 lr); {'ok' if ok else 'FAIL'} ({time.perf_counter() - t0:.1f} s)")
    if not ok:
        raise AssertionError("the MoE step on the card disagrees with the CPU")
    return dict(res, flips=flips, loss_gpu=gpu[0], loss_cpu=cpu[0])


def _moe_run(mx, torch, weights, ctx, cfg, axes, x, y, steps, snapshot=None):
    """MoETrainer on ``axes`` for ``steps`` steps, counting launches and
    keeping each step's routing; a snapshot after step 2 into ``snapshot``."""
    from mxnet_tpu_torch import elastic
    gpu = ctx.device_type == "gpu"
    mesh = mx.parallel.make_mesh(axes, devices=[ctx])
    net = _moe_net(mx, weights, ctx, cfg)
    trainer = _moe_trainer(net, mesh)
    counters = _elastic_counters()
    _zero_counters(counters)
    xs, ys = (mx.nd.array(a, ctx=ctx, dtype="int32") for a in (x, y))
    out = {"losses": [], "routes": [], "launches": [], "s": []}
    for i in range(steps):
        before = {k: c.launches for k, c in counters.items()}
        t0 = time.perf_counter()
        out["losses"].append(float(trainer.step(xs, ys)))
        if gpu:
            torch.cuda.synchronize()
        out["s"].append(time.perf_counter() - t0)
        out["launches"].append({k: c.launches - before[k] for k, c in counters.items()})
        out["routes"].append([a.cpu().numpy().tolist() for a in trainer.last_assignments])
        if snapshot and i == 1:
            elastic.save_trainer(elastic.SnapshotManager(snapshot), trainer, wait=True)
    out["dropped"] = trainer.global_dropped_tokens()
    out["experts_local"] = list(net.cells[0].moe.w1._param.shape)
    return out, net


def rank_moe(workdir, device, steps, cfg):
    """One of 4 ranks of phase_moe_ranks: (a) the dryrun's expert_parallel_moe
    on {ep: 4}; (b) the recipe on {dp: 2, ep: 2} (a snapshot after step 2)
    and on {dp: 4, ep: 1}; (c) {dp: 1, ep: 4} resumed from the snapshot."""
    import torch
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import _dist_util, elastic
    from mxnet_tpu_torch.convert import gather_params
    from mxnet_tpu_torch.parallel import moe as pmoe
    ctx = _dist_util.rank_context(device)
    if ctx.device_type == "gpu":
        torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    d = dict(np.load(os.path.join(workdir, "dryrun.npz")))
    ep = mx.parallel.make_mesh({"ep": 4}, devices=[ctx])
    r = ep.axis_index("ep")
    E, nl = MOE_DRYRUN["E"], MOE_DRYRUN["tokens"] // 4
    dev = ctx.torch_device
    xl = torch.from_numpy(d["x"][r * nl:(r + 1) * nl]).to(dev)
    gw = torch.from_numpy(d["gate_w"]).to(dev)
    w1 = torch.from_numpy(d["w1"]).to(dev)
    w2 = torch.from_numpy(d["w2"]).to(dev)
    kw = dict(top_k=MOE_DRYRUN["top_k"], capacity_factor=MOE_DRYRUN["capacity_factor"])
    el = E // 4
    y_ep = pmoe.expert_parallel_moe(xl, gw, w1[r * el:(r + 1) * el], w2[r * el:(r + 1) * el],
                                    axis_name="ep", mesh=ep, **kw)
    y_one = pmoe.moe_ffn(xl, gw, w1, w2, **kw)
    out = {"rank": ep.rank, "dryrun_rel": float((y_ep - y_one).abs().max()
                                                / y_one.abs().max().clamp_min(1e-30)),
           "dryrun_finite": bool(torch.isfinite(y_ep).all())}
    weights = dict(np.load(os.path.join(workdir, "weights.npz")))
    data = np.load(os.path.join(workdir, "data.npz"))
    out["ready_s"] = time.perf_counter() - t0
    for axes, snap in (({"dp": 2, "ep": 2}, os.path.join(workdir, "snap")),
                       ({"dp": 4, "ep": 1}, None)):
        key = f"dp{axes['dp']}ep{axes['ep']}"
        out[key], net = _moe_run(mx, torch, weights, ctx, cfg, axes, data["x"], data["y"],
                                 steps, snap)
        params = gather_params(net)
        if ep.rank == 0:
            np.savez(os.path.join(workdir, f"{key}.npz"), **params)
        del net, params
        if ctx.device_type == "gpu":
            torch.cuda.empty_cache()
    mesh = mx.parallel.make_mesh({"dp": 1, "ep": 4}, devices=[ctx])

    def rebuild():
        from mxnet_tpu_torch.models import MoETransformerLM
        mx.random.seed(123)
        net = MoETransformerLM(**cfg)
        net.initialize(ctx=ctx)
        return _moe_trainer(net, mesh)
    t1 = time.perf_counter()
    _, trainer, start, outcome = elastic.resume_or_init(os.path.join(workdir, "snap"), rebuild)
    resume_s = time.perf_counter() - t1
    loss = float(trainer.step(*(mx.nd.array(data[k], ctx=ctx, dtype="int32")
                                for k in ("x", "y"))))
    out["resume"] = {"start": start, "outcome": outcome, "loss": loss, "s": resume_s,
                     "experts_local": list(trainer.net.cells[0].moe.w1._param.shape),
                     "routes": [a.cpu().numpy().tolist() for a in trainer.last_assignments]}
    return out


def phase_moe_ranks(torch, device="gpu", steps=3, timeout=900, cfg=None):
    """The MoE half of dryrun_multichip on 4 ranks sharing the card over gloo
    (a correctness run: gloo stages every collective through the host):
    (a) expert_parallel_moe at the dryrun's shapes (E 4, D 16, H 32, 32
    tokens, top-1, capacity factor 4) against moe_ffn on each rank's token
    shard at TOL_MOE_DRYRUN; (b) the recipe at Switch-Base-8 widths and 2
    layers, T=1024, global batch 4, 3 steps, on {dp: 2, ep: 2} against
    {dp: 4, ep: 1} (the same 4 token shards, so the same gating): routing
    compared first, then losses at TOL_DIST_LOSS and the step-3 weights at
    TOL_DIST_W; every rank launches K1-K3 once a layer and K5 once a step;
    (c) a snapshot after step 2 on {dp: 2, ep: 2} resumed on {dp: 1, ep: 4}
    through resume_or_init into the shared directory: "resharded", step 3's
    loss at TOL_MOE_RESUME."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import _dist_util
    cfg = cfg or dict(MOE_CFG, num_layers=MOE_RANK_LAYERS)
    n = 4
    backend = _dist_util.choose_backend(device, n, torch.cuda.device_count()
                                        if device == "gpu" else 0)
    work = os.path.join(ROOT, "build", "moe_ranks")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    rs = np.random.RandomState(0)       # the dryrun's draws (__graft_entry__.py:191-197)
    E, D, H, N = (MOE_DRYRUN[k] for k in ("E", "D", "H", "tokens"))
    np.savez(os.path.join(work, "dryrun.npz"),
             x=rs.normal(0, 1, (N, D)).astype(np.float32),
             gate_w=rs.normal(0, 0.5, (D, E)).astype(np.float32),
             w1=rs.normal(0, 0.5, (E, D, H)).astype(np.float32),
             w2=rs.normal(0, 0.5, (E, H, D)).astype(np.float32))
    np.savez(os.path.join(work, "weights.npz"), **_moe_weights(cfg, seed=35))
    x, y = _moe_batch(MOE_RANKS_B, MOE_T, seed=36, vocab=cfg["vocab_size"])
    np.savez(os.path.join(work, "data.npz"), x=x, y=y)
    log(f"[moe-ranks] {n} ranks on {device} over {backend}: the dryrun's expert_parallel_moe "
        f"{MOE_DRYRUN}; MoETrainer at {cfg}, batch {MOE_RANKS_B} x T {MOE_T}, {steps} steps "
        f"on dp2 x ep2 and dp4 x ep1, the dp2 x ep2 snapshot resumed on dp1 x ep4")
    t0 = time.perf_counter()
    ranks = _dist_util.launch_local(
        "chip_smoke:rank_moe", n, {"workdir": work, "device": device, "steps": steps,
                                   "cfg": cfg},
        device=device, timeout=timeout, pythonpath=[ROOT], workdir=os.path.join(work, "launch"))
    seconds = time.perf_counter() - t0
    w = {k: dict(np.load(os.path.join(work, f"{k}.npz"))) for k in ("dp2ep2", "dp4ep1")}
    shutil.rmtree(work, ignore_errors=True)
    per_step = {"flash_attention_fwd": MOE_RANK_LAYERS, "flash_attention_bwd_dq":
                MOE_RANK_LAYERS, "flash_attention_bwd_dkv": MOE_RANK_LAYERS,
                "fused_adam_update": 1}
    dry = max(r["dryrun_rel"] for r in ranks)
    ok_a = dry <= TOL_MOE_DRYRUN and all(r["dryrun_finite"] for r in ranks)
    flips = sum(_flips(sa, sb) for r in ranks
                for sa, sb in zip(r["dp2ep2"]["routes"], r["dp4ep1"]["routes"]))
    loss_rel = max(abs(a - b) / abs(b) for r in ranks
                   for a, b in zip(r["dp2ep2"]["losses"], r["dp4ep1"]["losses"]))
    w_abs = max(float(np.abs(w["dp2ep2"][k] - v).max()) for k, v in w["dp4ep1"].items())
    launches_ok = device != "gpu" or all(st == per_step for r in ranks for key in
                                         ("dp2ep2", "dp4ep1") for st in r[key]["launches"])
    ok_b = flips == 0 and loss_rel <= TOL_DIST_LOSS and w_abs <= TOL_DIST_W and launches_ok
    resume_flips = sum(_flips(r["resume"]["routes"], r["dp2ep2"]["routes"][2]) for r in ranks)
    resume_rel = max(abs(r["resume"]["loss"] - r["dp2ep2"]["losses"][2])
                     / abs(r["dp2ep2"]["losses"][2]) for r in ranks)
    ok_c = all((r["resume"]["start"], r["resume"]["outcome"]) == (2, "resharded")
               for r in ranks) and resume_rel <= TOL_MOE_RESUME and resume_flips == 0
    for r in ranks:
        log(f"[moe-ranks] rank {r['rank']}: ready {r['ready_s']:.1f} s; dp2ep2 losses "
            f"{[round(v, 6) for v in r['dp2ep2']['losses']]} steps "
            f"{[round(s, 2) for s in r['dp2ep2']['s']]} s, experts here "
            f"{r['dp2ep2']['experts_local']}; dp4ep1 losses "
            f"{[round(v, 6) for v in r['dp4ep1']['losses']]}; launches a step "
            f"{r['dp2ep2']['launches'][-1]}; resume {r['resume']['start']}, "
            f"{r['resume']['outcome']!r} in {r['resume']['s']:.2f} s, experts here "
            f"{r['resume']['experts_local']}, step 3 loss {r['resume']['loss']:.6f}")
    log(f"[moe-ranks] (a) the dryrun's call against moe_ffn on each token shard: max "
        f"{dry:.2e} of max (tol {TOL_MOE_DRYRUN:.0e}) {'ok' if ok_a else 'FAIL'}")
    log(f"[moe-ranks] (b) dp2 x ep2 against dp4 x ep1: routing flips {flips}; losses max rel "
        f"{loss_rel:.2e} (tol {TOL_DIST_LOSS:.0e}); step-{steps} weights max|d| {w_abs:.2e} "
        f"(tol {TOL_DIST_W:.0e}); dropped {ranks[0]['dp2ep2']['dropped']} and "
        f"{ranks[0]['dp4ep1']['dropped']}; launches {'ok' if launches_ok else 'FAIL'} "
        f"{'ok' if ok_b else 'FAIL'}")
    log(f"[moe-ranks] (c) ep-reshard resume: routing flips {resume_flips}, step 3 max rel "
        f"{resume_rel:.2e} (tol {TOL_MOE_RESUME:.0e}) {'ok' if ok_c else 'FAIL'}; "
        f"{n} ranks in {seconds:.1f} s")
    if not (ok_a and ok_b and ok_c):
        raise AssertionError("the MoE ranks disagree")
    return {"backend": backend, "seconds": seconds, "dryrun_rel": dry, "flips": flips,
            "loss_rel": loss_rel, "weight_abs": w_abs, "resume_rel": resume_rel,
            "resume_outcomes": [r["resume"]["outcome"] for r in ranks],
            "losses": {k: ranks[0][k]["losses"] for k in ("dp2ep2", "dp4ep1")},
            "resume_loss": [r["resume"]["loss"] for r in ranks],
            "launches": {k: sum(st[k] for r in ranks for key in ("dp2ep2", "dp4ep1")
                                for st in r[key]["launches"]) for k in per_step}}


PP_T, PP_B, PP_M = 1024, 8, 4      # the pipeline's main path: BERT-base, microbatches of 2
PP_LR = 1e-4
PP_STEPS = 6                       # a warm-up and 5 timed
PP_BF16_STEPS = 3
PP_CHECK_LAYERS, PP_CHECK_B, PP_CHECK_M = 2, 2, 2
TOL_PP_LOSS = 1e-5                 # against DataParallelTrainer's batch-8 step, relative
TOL_PP_W = 2e-5                    # step-3 weights of 2 ranks against one (tests' TOL_W)
PP_MEM_MARGIN = 0.10               # stage 0's peak at M = 8 over M = 4's, beyond the tokens
# dryrun_multichip's pipeline (__graft_entry__.py:162-179): bert_tiny, T 32,
# Bp = 2 * 2 * dp, M = 2, Adam 1e-4, on {pp: 2, dp: 2}
PP_DRYRUN = dict(vocab=512, T=32, B=8, M=2, lr=1e-4, steps=3)


def _pp_trainer(mx, net, mesh, M, dp_axis=None, dtype=None, schedule="1f1b", **kw):
    """``parallel.PipelineTrainer`` with the dryrun's configuration: softmax
    cross entropy over the MLM logits, Adam lr 1e-4, the 1F1B schedule
    (``schedule``, ``remat`` and ``virtual_stages`` through ``kw``)."""
    return mx.parallel.PipelineTrainer(
        net, mx.gluon.loss.SoftmaxCrossEntropyLoss(), optimizer="adam",
        optimizer_params={"learning_rate": PP_LR}, mesh=mesh, dp_axis=dp_axis,
        num_microbatch=M, schedule=schedule, dtype=dtype, **kw)


def _bert_base_net(mx, params, ctx, cfg=None):
    """``bert_base(max_length=1024)`` (or ``BertModel(**cfg)``) on ``ctx`` with
    ``params`` through ``load_jax_params``."""
    from mxnet_tpu_torch.convert import load_jax_params
    from mxnet_tpu_torch.models import BertModel, bert_base
    net = bert_base(max_length=PP_T) if cfg is None else BertModel(**cfg)
    net.initialize(ctx=ctx)
    load_jax_params(net, params)
    return net


def _host_weights(net):
    return {k: p.data().asnumpy() for k, p in net._collect_params_with_prefix().items()}


def phase_pp_train(torch, params, batch, dp_bert):
    """The 1F1B pipeline's main path on a world-1 NCCL mesh {pp: 1, dp: 1}
    (the caller holds the process group): BERT-base at T=1024 from the
    training phase's weights (``load_jax_params``, then one forward),
    ``PipelineTrainer`` with Adam lr 1e-4, batch 8 in M = 4 microbatches,
    f32 with TF32 off: a warm-up, 5 timed steps and one profiled. Each step
    must launch K1, K2 and K3 once a layer and microbatch (48) and K5 once;
    its first 3 losses equal DataParallelTrainer's batch-8 step's
    (``phase_dp_bert``, same weights and batch) to TOL_PP_LOSS, and the loss
    falls. Then 3 steps in bfloat16 (the bf16 kernels, 48 a step). Returns
    the results and the weights after step 3 (for ``phase_pp_ranks``)."""
    import torch.distributed as dist
    import mxnet_tpu_torch as mx
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    tokens, labels = batch
    B, T = tokens.shape
    n_layers = 12
    label = "pp-train"
    t0 = time.perf_counter()
    mesh = mx.parallel.make_mesh({"pp": 1, "dp": 1}, devices=[mx.gpu(0)])
    x = mx.nd.array(tokens, ctx=mx.gpu(0), dtype="int32")
    y = mx.nd.array(labels, ctx=mx.gpu(0), dtype="int32")
    net = _bert_base_net(mx, params, mx.gpu(0))
    with mx.autograd.predict_mode():
        net(mx.nd.array(tokens[:1], ctx=mx.gpu(0), dtype="int32"))
    torch.cuda.synchronize()
    tr = _pp_trainer(mx, net, mesh, PP_M, dp_axis="dp")
    ready_s = time.perf_counter() - t0
    counters = _elastic_counters()
    per_step = {"flash_attention_fwd": n_layers * PP_M, "flash_attention_bwd_dq":
                n_layers * PP_M, "flash_attention_bwd_dkv": n_layers * PP_M,
                "fused_adam_update": 1}
    n_params = sum(int(np.prod(p.shape)) for p in net.collect_params().values())
    log(f"[{label}] bert_base(max_length={T}) {n_params} parameters, batch {B} x T {T} in "
        f"M={PP_M} microbatches of {B // PP_M}, {mesh} over {dist.get_backend()}, "
        f"{len(tr._groups)} update group(s); ready in {ready_s:.1f} s")
    w3 = {}

    def grab(i):
        if i == 2:
            tr.sync()
            w3.update(_host_weights(net))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_counters(counters)
    steps = _dp_steps(torch, label, tr, x, y, PP_STEPS, per_step,
                      (B * T, "tokens_per_s"), counters, after=grab)
    launches = {k: c.launches for k, c in counters.items()}
    peak = torch.cuda.max_memory_allocated()
    stats = dict(tr.last_stats)
    ref = [st["loss"] for st in dp_bert["float32"]["steps"][:3]]
    rel = max(abs(a["loss"] - b) / abs(b) for a, b in zip(steps, ref))
    log(f"[{label}] first 3 losses against DataParallelTrainer's batch-8 step "
        f"{[round(v, 6) for v in ref]}: max rel {rel:.2e} (tol {TOL_PP_LOSS:.0e}) "
        f"{'ok' if rel <= TOL_PP_LOSS else 'FAIL'}")
    if rel > TOL_PP_LOSS:
        raise AssertionError(f"{label}: losses disagree with DataParallelTrainer's")
    if not steps[-1]["loss"] < steps[0]["loss"]:
        raise AssertionError(f"{label}: the loss did not fall")
    profile = _step_profile(torch, f"{label} step, batch {B}, M={PP_M}",
                            lambda: tr.step(x, y), steps)
    tr.drain()
    med = float(np.median([st["ms"] for st in steps if not st["warmup"]]))
    log(f"[{label}] median step {med:.2f} ms, {B * T / med * 1e3:.0f} tokens/s, idle "
        f"{100 * profile['idle_share_steps']:.1f}%, a profiled step "
        f"{sum(profile['group_launches'].values())} launches; kernel launches {launches} "
        f"over {PP_STEPS} steps ({per_step} a step); peak {peak / 2**30:.3f} GiB; schedule "
        f"{stats}")
    out = {"steps": steps, "step_median_ms": med, "tokens_per_s": B * T / med * 1e3,
           "launches": launches, "per_step": per_step, "peak_bytes": peak,
           "loss_rel_dp": rel, "profile": profile, "schedule": stats, "ready_s": ready_s,
           "parameters": n_params, "launches_per_step": sum(profile["group_launches"].values())}
    del tr, net
    torch.cuda.empty_cache()
    # the bf16 kernels on the pipeline
    net = _bert_base_net(mx, params, mx.gpu(0))
    tr = _pp_trainer(mx, net, mesh, PP_M, dp_axis="dp", dtype="bfloat16")
    _zero_counters(counters)
    bf16 = _dp_steps(torch, f"{label} bf16", tr, x, y, PP_BF16_STEPS, per_step,
                     (B * T, "tokens_per_s"), counters)
    by_dtype = {k: dict(c.launches_by_dtype) for k, c in _flash_counters().items()}
    log(f"[{label} bf16] flash launches by dtype {by_dtype}")
    if any(v != {"bfloat16": PP_BF16_STEPS * n_layers * PP_M} for v in by_dtype.values()):
        raise AssertionError(f"{label} bf16: expected the bf16 flash kernels only, "
                             f"{n_layers * PP_M} a step: {by_dtype}")
    out["bfloat16"] = {"steps": bf16, "launches": {k: c.launches for k, c in counters.items()},
                       "flash_launches_by_dtype": by_dtype}
    del tr, net
    torch.cuda.empty_cache()
    return out, w3


def _pp_step(mx, ctx, params, mesh, x, y, cfg):
    """One PipelineTrainer step (M = PP_CHECK_M) of ``BertModel(**cfg)`` on
    ``ctx``: (loss, reduced gradients, weights) by structural path."""
    net = _bert_base_net(mx, params, ctx, cfg)
    tr = _pp_trainer(mx, net, mesh, PP_CHECK_M, dp_axis="dp")
    xs, ys = (mx.nd.array(a, ctx=ctx, dtype="int32") for a in (x, y))
    loss = float(tr.step(xs, ys))
    tr.sync()
    keys = net._collect_params_with_prefix()
    return (loss, {k: p.grad().asnumpy() for k, p in keys.items()}, _host_weights(net))


def phase_pp_check(torch):
    """One PipelineTrainer step of a 2-layer model of BERT-base width at
    T=1024, batch 2 in 2 microbatches: on the card over the world-1 NCCL mesh
    (the caller's group) against the CPU on a mesh of one device (the
    kernels' plain versions), f32 with TF32 off: loss, every gradient and
    every weight after the Adam step at the training checks' tolerances."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.convert import seeded_params
    from mxnet_tpu_torch.models import BertModel
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    cfg = dict(num_layers=PP_CHECK_LAYERS, max_length=PP_T)
    params = seeded_params(BertModel(**cfg), seed=40)
    rs = np.random.RandomState(41)
    x = rs.randint(0, 30522, size=(PP_CHECK_B, PP_T)).astype(np.int32)
    y = rs.randint(0, 30522, size=(PP_CHECK_B, PP_T)).astype(np.int32)
    gpu = _pp_step(mx, mx.gpu(0), params, mx.parallel.make_mesh(
        {"pp": 1, "dp": 1}, devices=[mx.gpu(0)]), x, y, cfg)
    torch.cuda.empty_cache()
    cpu = _pp_step(mx, mx.cpu(), params, mx.parallel.Mesh([mx.cpu()], ("pp", "dp"), (1, 1)),
                   x, y, cfg)
    res = _step_agreement(gpu, cpu, PP_LR)
    ok = res.pop("ok")
    log(f"[pp-check] {PP_CHECK_LAYERS} layers of BERT-base width, T={PP_T}, batch "
        f"{PP_CHECK_B} in {PP_CHECK_M} microbatches, one PipelineTrainer step, GPU (NCCL "
        f"world 1) vs CPU: loss {gpu[0]:.6f} vs {cpu[0]:.6f} (rel {res['loss_rel']:.2e}, tol "
        f"{TOL_TRAIN_LOSS:.0e}); gradients {res['grad_rel']:.2e} of the tensor's max (tol "
        f"{TOL_TRAIN_GRAD:.0e}); weights max|d| {res['weight_max_abs']:.2e} (tol "
        f"{TOL_TRAIN_W:.0e}), {res['near_zero_grad_elements']} elements with a nonzero |g| "
        f"within the gradient tolerance of 0 up to {res['near_zero_weight_max_abs']:.2e} "
        f"(tol 2 lr); {'ok' if ok else 'FAIL'} ({time.perf_counter() - t0:.1f} s)")
    if not ok:
        raise AssertionError("the pipeline step on the card disagrees with the CPU")
    return dict(res, loss_gpu=gpu[0], loss_cpu=cpu[0])


def _digest(arrays):
    import hashlib
    h = hashlib.sha1()
    for a in arrays:
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()


def rank_pp(workdir, device, steps, cfg=None):
    """One of 2 ranks of phase_pp_ranks: (a) {pp: 2} at M = 4, ``steps``
    steps (a snapshot after step 2), peak memory of the last; the embed's and
    head's digest after the last step, the weights after ``sync()``; (b) M = 8
    on batch 16 (microbatches still of 2), peak of its second step; (c)
    {pp: 1, dp: 2} resumed from the snapshot, one step."""
    import torch
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import _dist_util, elastic
    ctx = _dist_util.rank_context(device)
    gpu = ctx.device_type == "gpu"
    if gpu:
        torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    params = dict(np.load(os.path.join(workdir, "weights.npz")))
    data = np.load(os.path.join(workdir, "data.npz"))
    x, y = (mx.nd.array(data[k][:PP_B], ctx=ctx, dtype="int32") for k in ("x", "y"))
    x16, y16 = (mx.nd.array(data[k], ctx=ctx, dtype="int32") for k in ("x", "y"))
    counters = _elastic_counters()

    def memory():
        return (torch.cuda.memory_allocated(), torch.cuda.max_memory_allocated()) if gpu \
            else (0, 0)
    net = _bert_base_net(mx, params, ctx, cfg)
    tr = _pp_trainer(mx, net, mx.parallel.make_mesh({"pp": 2}, devices=[ctx]), PP_M)
    out = {"rank": tr.mesh.rank, "stage": tr.stage, "layers": list(tr._own),
           "ready_s": time.perf_counter() - t0, "losses": [], "launches": [], "s": []}
    _zero_counters(counters)
    for i in range(steps):
        if i == steps - 1 and gpu:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            out["static_bytes"] = memory()[0]
        before = {k: c.launches for k, c in counters.items()}
        t_step = time.perf_counter()
        out["losses"].append(float(tr.step(x, y)))
        out["s"].append(time.perf_counter() - t_step)
        out["launches"].append({k: c.launches - before[k] for k, c in counters.items()})
        if i == 1:
            elastic.save_trainer(elastic.SnapshotManager(os.path.join(workdir, "snap")), tr,
                                 wait=True)
    out["peak_m4"] = memory()[1]
    out["in_flight_m4"] = tr.last_stats["max_in_flight"]
    out["wire"] = dict(tr.last_stats)
    # the reference's two cyclic rings send one activation each a tick:
    # 2(M + 2(pp - 1)) hops, where the port sends only the live ones
    hops = 2 * (PP_M + 2 * (2 - 1))
    out["estimate"] = [hops * tr.last_stats["bytes"] // tr.last_stats["sends"], hops]
    out["embed_head"] = _digest([p._param.detach().cpu().numpy()
                                 for p in tr._embed_plist + tr._head_plist])
    tr.sync()
    if tr.mesh.rank == 0:
        np.savez(os.path.join(workdir, "pp2.npz"), **_host_weights(net))
    del tr
    if gpu:
        torch.cuda.empty_cache()
    tr8 = _pp_trainer(mx, net, mx.parallel.make_mesh({"pp": 2}, devices=[ctx]), 2 * PP_M)
    tr8.step(x16, y16)
    if gpu:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        out["static_bytes_m8"] = memory()[0]
    tr8.step(x16, y16)
    out["peak_m8"] = memory()[1]
    out["in_flight_m8"] = tr8.last_stats["max_in_flight"]
    del tr8, net
    if gpu:
        torch.cuda.empty_cache()
    mesh = mx.parallel.make_mesh({"pp": 1, "dp": 2}, devices=[ctx])

    def rebuild():
        from mxnet_tpu_torch.models import BertModel, bert_base
        mx.random.seed(200 + mesh.rank)
        net2 = bert_base(max_length=PP_T) if cfg is None else BertModel(**cfg)
        net2.initialize(ctx=ctx)
        return _pp_trainer(mx, net2, mesh, PP_M, dp_axis="dp")
    t_resume = time.perf_counter()
    _, tr2, start, outcome = elastic.resume_or_init(os.path.join(workdir, "snap"), rebuild)
    out["resume"] = {"start": start, "outcome": outcome, "s": time.perf_counter() - t_resume,
                     "loss": float(tr2.step(x, y)), "layers": list(tr2._own)}
    return out


def phase_pp_ranks(torch, params, batch, pp_train, pp_w3, device="gpu", steps=3,
                   timeout=900, cfg=None):
    """The pipeline at pp = 2 as 2 ranks sharing the card over gloo (a
    correctness run: gloo stages the point-to-point messages and the
    collectives through the host), BERT-base at T=1024 (or ``cfg``):
    (a) {pp: 2}, M = 4, batch 8, 3 steps: the losses equal phase_pp_train's
    first 3 to TOL_PP_LOSS, the weights after step 3 (``sync()``) its step-3
    weights to TOL_PP_W, each rank launches K1-K3 6 layers x 4 = 24 times and
    K5 once a step, the embed and head bitwise equal on both ranks; (b) M = 8
    on batch 16 (microbatches still of 2): each rank's peak device memory at
    M = 4 and M = 8; stage 0's may grow by no more than the extra tokens plus
    PP_MEM_MARGIN, beside what GPipe's order would hold (M times one
    microbatch's stage activations); (c) the snapshot of (a) after step 2
    resumed on {pp: 1, dp: 2} through resume_or_init: "resharded", step 3's
    loss equal to (a)'s to TOL_PP_LOSS."""
    from mxnet_tpu_torch import _dist_util
    n = 2
    n_layers = (cfg or {}).get("num_layers", 12)
    backend = _dist_util.choose_backend(device, n, torch.cuda.device_count()
                                        if device == "gpu" else 0)
    work = os.path.join(ROOT, "build", "pp_ranks")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    tokens, labels = batch
    rs = np.random.RandomState(42)
    vocab = (cfg or {}).get("vocab_size", 30522)
    more = rs.randint(0, vocab, size=(2,) + tokens.shape).astype(np.int32)
    np.savez(os.path.join(work, "weights.npz"), **params)
    np.savez(os.path.join(work, "data.npz"), x=np.concatenate([tokens, more[0]]),
             y=np.concatenate([labels, more[1]]))
    log(f"[pp-ranks] {n} ranks on {device} over {backend}: {{pp: 2}} at M={PP_M} batch "
        f"{PP_B}, then M={2 * PP_M} batch {2 * PP_B}, then the step-2 snapshot resumed on "
        f"{{pp: 1, dp: 2}}")
    t0 = time.perf_counter()
    ranks = _dist_util.launch_local(
        "chip_smoke:rank_pp", n, {"workdir": work, "device": device, "steps": steps,
                                  "cfg": cfg},
        device=device, timeout=timeout, pythonpath=[ROOT], workdir=os.path.join(work, "launch"))
    seconds = time.perf_counter() - t0
    got_w = dict(np.load(os.path.join(work, "pp2.npz")))
    shutil.rmtree(work, ignore_errors=True)
    per_step = {"flash_attention_fwd": n_layers // n * PP_M,
                "flash_attention_bwd_dq": n_layers // n * PP_M,
                "flash_attention_bwd_dkv": n_layers // n * PP_M, "fused_adam_update": 1}
    ref = [st["loss"] for st in pp_train["steps"][:steps]]
    loss_rel = max(abs(a - b) / abs(b) for r in ranks for a, b in zip(r["losses"], ref))
    w_abs = max(float(np.abs(got_w[k] - w).max()) for k, w in pp_w3.items())
    launches_ok = device != "gpu" or all(st == per_step for r in ranks for st in r["launches"])
    eh_equal = len({r["embed_head"] for r in ranks}) == 1
    ok_a = loss_rel <= TOL_PP_LOSS and w_abs <= TOL_PP_W and launches_ok and eh_equal
    extra = PP_B * PP_T * 4 * 2          # the 8 more sequences' tokens and labels, int32
    mem = [{"stage": r["stage"], "peak_m4": r["peak_m4"], "peak_m8": r["peak_m8"],
            "static": r.get("static_bytes"), "in_flight": [r["in_flight_m4"],
                                                           r["in_flight_m8"]]}
           for r in sorted(ranks, key=lambda r: r["stage"])]
    s0 = mem[0]
    # stage 0 holds 3 microbatches' activations at its peak (the rest is
    # static); GPipe's order would hold all M of them
    act = (s0["peak_m4"] - s0["static"]) / s0["in_flight"][0] if device == "gpu" else 0
    s0["gpipe_m8_estimate"] = (s0["static"] or 0) + 2 * PP_M * act
    ok_b = device != "gpu" or s0["peak_m8"] <= (s0["peak_m4"] + extra) * (1 + PP_MEM_MARGIN)
    ok_b = ok_b and [m["in_flight"] for m in mem] == [[3, 3], [1, 1]]
    resume_rel = max(abs(r["resume"]["loss"] - r["losses"][2]) / abs(r["losses"][2])
                     for r in ranks)
    ok_c = all((r["resume"]["start"], r["resume"]["outcome"]) == (2, "resharded")
               for r in ranks) and resume_rel <= TOL_PP_LOSS
    for r in sorted(ranks, key=lambda r: r["rank"]):
        log(f"[pp-ranks] rank {r['rank']} stage {r['stage']} layers {r['layers']}: ready "
            f"{r['ready_s']:.1f} s, steps {[round(v, 2) for v in r['s']]} s, losses "
            f"{[round(v, 6) for v in r['losses']]}, launches a step {r['launches'][-1]}, "
            f"sends {r['wire']['sends']} ({r['wire']['bytes']} B) a step against the "
            f"reference's cyclic estimate {r['estimate'][1]} hops ({r['estimate'][0]} B); "
            f"resume {r['resume']['start']} {r['resume']['outcome']!r} in "
            f"{r['resume']['s']:.1f} s, step 3 {r['resume']['loss']:.6f}")
    gib = 2 ** 30
    for m in mem:
        log(f"[pp-ranks] stage {m['stage']}: peak {m['peak_m4'] / gib:.3f} GiB at M={PP_M}, "
            f"{m['peak_m8'] / gib:.3f} GiB at M={2 * PP_M} (static {(m['static'] or 0) / gib:.3f}"
            f" GiB; in flight {m['in_flight']})")
    log(f"[pp-ranks] GPipe's order would hold all M={2 * PP_M} microbatches on stage 0: "
        f"static + {2 * PP_M} x {act / gib:.3f} GiB (a microbatch's stage activations at "
        f"M={PP_M}: peak less static over the 3 in flight) = "
        f"{s0['gpipe_m8_estimate'] / gib:.3f} GiB, against 1F1B's {s0['peak_m8'] / gib:.3f}")
    log(f"[pp-ranks] (a) losses against phase_pp_train's max rel {loss_rel:.2e} (tol "
        f"{TOL_PP_LOSS:.0e}); step-{steps} weights max|d| {w_abs:.2e} (tol {TOL_PP_W:.0e}); "
        f"launches {'ok' if launches_ok else 'FAIL'} ({per_step} a rank-step); embed and head "
        f"{'bitwise equal' if eh_equal else 'DIFFER'} across the ranks "
        f"{'ok' if ok_a else 'FAIL'}")
    log(f"[pp-ranks] (b) stage 0's peak {s0['peak_m4'] / 2**30:.3f} -> "
        f"{s0['peak_m8'] / 2**30:.3f} GiB from M={PP_M} to M={2 * PP_M} (limit: +{extra} B of "
        f"tokens, +{100 * PP_MEM_MARGIN:.0f}%) {'ok' if ok_b else 'FAIL'}")
    log(f"[pp-ranks] (c) pp2 -> pp1 x dp2 resume: step 3 max rel {resume_rel:.2e} (tol "
        f"{TOL_PP_LOSS:.0e}) {'ok' if ok_c else 'FAIL'}; {n} ranks in {seconds:.1f} s")
    if not (ok_a and ok_b and ok_c):
        raise AssertionError("the pipeline ranks disagree")
    return {"backend": backend, "seconds": seconds, "loss_rel": loss_rel, "weight_abs": w_abs,
            "memory": mem, "resume_rel": resume_rel,
            "losses": [r["losses"] for r in ranks],
            "resume_outcomes": [r["resume"]["outcome"] for r in ranks],
            "wire": [r["wire"] for r in ranks], "estimate": ranks[0]["estimate"],
            "launches": {k: sum(st[k] for r in ranks for st in r["launches"])
                         for k in per_step}, "per_rank_step": per_step}


def _dryrun_batch(seed):
    rs = np.random.RandomState(seed)
    shape = (PP_DRYRUN["B"], PP_DRYRUN["T"])
    return (rs.randint(0, PP_DRYRUN["vocab"], size=shape).astype(np.int32),
            rs.randint(0, PP_DRYRUN["vocab"], size=shape).astype(np.int32))


def rank_pp_dryrun(workdir, device):
    """One of 4 ranks of phase_pp_dryrun: the dryrun's pipeline step on
    {pp: 2, dp: 2}, PP_DRYRUN's steps; rank 0 writes the weights after
    ``sync()``."""
    import torch
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import _dist_util
    from mxnet_tpu_torch.convert import load_jax_params
    from mxnet_tpu_torch.models import bert_tiny
    ctx = _dist_util.rank_context(device)
    if ctx.device_type == "gpu":
        torch.backends.cuda.matmul.allow_tf32 = False
    params = dict(np.load(os.path.join(workdir, "weights.npz")))
    x, y = (mx.nd.array(a, ctx=ctx, dtype="int32") for a in _dryrun_batch(43))
    net = bert_tiny(vocab_size=PP_DRYRUN["vocab"])
    net.initialize(ctx=ctx)
    load_jax_params(net, params)
    tr = mx.parallel.PipelineTrainer(
        net, mx.gluon.loss.SoftmaxCrossEntropyLoss(), optimizer="adam",
        optimizer_params={"learning_rate": PP_DRYRUN["lr"]},
        mesh=mx.parallel.make_mesh({"pp": 2, "dp": 2}, devices=[ctx]), dp_axis="dp",
        num_microbatch=PP_DRYRUN["M"], schedule="1f1b")
    counters = _elastic_counters()
    _zero_counters(counters)
    losses = [float(tr.step(x, y)) for _ in range(PP_DRYRUN["steps"])]
    tr.sync()
    if tr.mesh.rank == 0:
        np.savez(os.path.join(workdir, "pp.npz"), **_host_weights(net))
    return {"rank": tr.mesh.rank, "coords": dict(tr.mesh.coords), "losses": losses,
            "launches": {k: c.launches for k, c in counters.items()}}


def phase_pp_dryrun(torch, device="gpu", timeout=600):
    """``dryrun_multichip``'s pipeline step (``__graft_entry__.py:162-179``) on
    4 ranks sharing the card over gloo: {pp: 2, dp: 2}, ``bert_tiny(vocab_size
    =512)``, T 32, batch 8, M = 2, Adam lr 1e-4, 3 steps against the one-rank
    DataParallelTrainer's on the same weights and batch: losses to
    TOL_PP_LOSS, the weights after step 3 to TOL_PP_W; K5 once a rank-step (T
    = 32 takes the plain attention: no K1-K3)."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import _dist_util
    from mxnet_tpu_torch.convert import seeded_params
    from mxnet_tpu_torch.models import bert_tiny
    n = 4
    work = os.path.join(ROOT, "build", "pp_dryrun")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    params = seeded_params(bert_tiny(vocab_size=PP_DRYRUN["vocab"]), seed=44)
    np.savez(os.path.join(work, "weights.npz"), **params)
    ctx = mx.gpu(0) if device == "gpu" else mx.cpu()
    net = _bert_base_net(mx, params, ctx, dict(vocab_size=PP_DRYRUN["vocab"], num_layers=2,
                                               units=128, hidden_size=512, num_heads=2))
    dpt = _dp_trainer(mx, net, ctx, "adam", {"learning_rate": PP_DRYRUN["lr"]})
    x, y = (mx.nd.array(a, ctx=ctx, dtype="int32") for a in _dryrun_batch(43))
    ref = [float(dpt.step(x, y)) for _ in range(PP_DRYRUN["steps"])]
    ref_w = _host_weights(net)
    del dpt, net
    t0 = time.perf_counter()
    ranks = _dist_util.launch_local(
        "chip_smoke:rank_pp_dryrun", n, {"workdir": work, "device": device},
        device=device, timeout=timeout, pythonpath=[ROOT], workdir=os.path.join(work, "launch"))
    seconds = time.perf_counter() - t0
    got_w = dict(np.load(os.path.join(work, "pp.npz")))
    shutil.rmtree(work, ignore_errors=True)
    loss_rel = max(abs(a - b) / abs(b) for r in ranks for a, b in zip(r["losses"], ref))
    w_abs = max(float(np.abs(got_w[k] - w).max()) for k, w in ref_w.items())
    want = {"flash_attention_fwd": 0, "flash_attention_bwd_dq": 0,
            "flash_attention_bwd_dkv": 0, "fused_adam_update": PP_DRYRUN["steps"]}
    launches_ok = device != "gpu" or all(r["launches"] == want for r in ranks)
    ok = loss_rel <= TOL_PP_LOSS and w_abs <= TOL_PP_W and launches_ok
    log(f"[pp-dryrun] {{pp: 2, dp: 2}} bert_tiny(vocab_size={PP_DRYRUN['vocab']}), T "
        f"{PP_DRYRUN['T']}, batch {PP_DRYRUN['B']}, M={PP_DRYRUN['M']}, {n} ranks on {device} "
        f"in {seconds:.1f} s: losses {[round(v, 6) for v in ranks[0]['losses']]} against the "
        f"one-rank step's {[round(v, 6) for v in ref]}, max rel {loss_rel:.2e} (tol "
        f"{TOL_PP_LOSS:.0e}); step-{PP_DRYRUN['steps']} weights max|d| {w_abs:.2e} (tol "
        f"{TOL_PP_W:.0e}); launches {[r['launches'] for r in ranks]} "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the dryrun's pipeline step disagrees with the one-rank step")
    return {"seconds": seconds, "loss_rel": loss_rel, "weight_abs": w_abs, "losses": ref,
            "launches": {k: sum(r["launches"][k] for r in ranks) for k in want}}


# --- tensor parallelism and ZeRO inside the pipeline stages ---------------------------

PP_TP_STEPS = 5                    # held against phase_pp_train's first 5 losses
PP_TP_TIMED = 10                   # timed steps after them: p50 and p90
PP_TP_LAYERS, PP_TP_B, PP_TP_M, PP_TP_RANK_STEPS = 2, 4, 2, 2
PP_TP_VOCAB4 = 30520               # the tp 4 reshard's vocab: 30522 does not split 4 ways
TOL_PP_TP_WIRE = {"bfloat16": (5e-4, 1e-3)}   # losses rel, weights abs (the tests' bars)
TOL_PP_TP_RESUME = 5e-4            # the reference's own (tests/test_partitioned_tp.py:254)


def _pp_tp_trainer(mx, net, mesh, M, **kw):
    """``PipelineTrainer`` with phase_pp_train's loss and optimizer and a tp
    axis (partitioned unless ``tp_mode`` says otherwise)."""
    kw.setdefault("tp_mode", "partitioned")
    return mx.parallel.PipelineTrainer(
        net, mx.gluon.loss.SoftmaxCrossEntropyLoss(), optimizer="adam",
        optimizer_params={"learning_rate": PP_LR}, mesh=mesh, num_microbatch=M,
        schedule="1f1b", tp_axis="tp", **kw)


def _held_bytes(tr):
    """Bytes of weights and optimizer state the trainer keeps on this rank:
    ``(all, the tp-split leaves', what those leaves would take whole)``."""
    total = split = whole = 0
    for lf in tr._all_leaves():
        n = sum(t.numel() * t.element_size() for t in (lf.w, *lf.state))
        total += n
        if lf.dim is not None:
            split += n
            whole += int(np.prod(lf.param.shape)) * lf.w.element_size() * (1 + len(lf.state))
    for tag in ("e", "s", "h"):
        total += sum(t.numel() * t.element_size() for zb in tr._zbuckets[tag]
                     for t in zb["state"])
    return total, split, whole


def phase_pp_tp_train(torch, params, batch, pp_train):
    """Tensor parallelism and ZeRO in the stages on the main path, world-1
    NCCL {pp: 1, tp: 1, dp: 1} (the caller holds the group): BERT-base at
    T=1024, batch 8 in M = 4, Adam lr 1e-4, f32 with TF32 off, through
    ``PipelineTrainer(tp_mode="partitioned", zero_update=True)``: the cells,
    embed and head as ``parallel.megatron``'s programs, the update over ZeRO
    buckets. Its first PP_TP_STEPS losses equal phase_pp_train's (the Gluon
    blocks' 1F1B step, same weights and batch) to TOL_PP_LOSS; each step
    launches K1-K3 48 times at (24, 1024, 1024, 64) and K5 once a weight
    decay. Then PP_TP_TIMED timed steps (p50, p90, tokens/s), one step traced
    (``_api_launches``: host launches, device busy, idle = 1 - busy / p50),
    peak memory and the counted collectives beside the reference's
    estimates."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.ops.cuda import flash_attention as fa
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    tokens, labels = batch
    B, T = tokens.shape
    n_layers = 12
    label = "pp-tp-train"
    t0 = time.perf_counter()
    mesh = mx.parallel.make_mesh({"pp": 1, "tp": 1, "dp": 1}, devices=[mx.gpu(0)])
    x = mx.nd.array(tokens, ctx=mx.gpu(0), dtype="int32")
    y = mx.nd.array(labels, ctx=mx.gpu(0), dtype="int32")
    net = _bert_base_net(mx, params, mx.gpu(0))
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    tr = _pp_tp_trainer(mx, net, mesh, PP_M, dp_axis="dp", zero_update=True)
    ready_s = time.perf_counter() - t0
    counters = _elastic_counters()
    per_step = {"flash_attention_fwd": n_layers * PP_M, "flash_attention_bwd_dq":
                n_layers * PP_M, "flash_attention_bwd_dkv": n_layers * PP_M,
                "fused_adam_update": len(tr._groups)}
    buckets = {t: len(getattr(tr, f"_zplan_{t}")) for t in ("e", "s", "h")}
    log(f"[{label}] bert_base(max_length={T}), batch {B} x T {T} in M={PP_M}, {mesh}, "
        f"tp_mode='partitioned', zero_update=True: ZeRO buckets {buckets}, "
        f"{len(tr._groups)} update group(s); ready in {ready_s:.1f} s")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_counters(counters)
    steps = _dp_steps(torch, label, tr, x, y, PP_TP_STEPS, per_step, (B * T, "tokens_per_s"),
                      counters)
    ref = [st["loss"] for st in pp_train["steps"][:PP_TP_STEPS]]
    rel = max(abs(a["loss"] - b) / abs(b) for a, b in zip(steps, ref))
    log(f"[{label}] {PP_TP_STEPS} losses against phase_pp_train's (the Gluon blocks' 1F1B "
        f"step) {[round(v, 6) for v in ref]}: max rel {rel:.2e} (tol {TOL_PP_LOSS:.0e}) "
        f"{'ok' if rel <= TOL_PP_LOSS else 'FAIL'}")
    if rel > TOL_PP_LOSS:
        raise AssertionError(f"{label}: the partitioned step disagrees with the 1F1B step")
    if not steps[-1]["loss"] < steps[0]["loss"]:
        raise AssertionError(f"{label}: the loss did not fall")
    ms = []
    for _ in range(PP_TP_TIMED):
        t_step = time.perf_counter()
        tr.step(x, y)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t_step) * 1e3)
    n_steps = PP_TP_STEPS + PP_TP_TIMED
    launches = {k: c.launches for k, c in counters.items()}
    by_shape = {k: dict(c.launches_by_shape) for k, c in _flash_counters().items()}
    heads, units = tr._cplan.heads, tr._cplan.units
    want_shape = {f"{B // PP_M * heads}x{T}x{T}x{units // heads}": n_steps * n_layers * PP_M}
    ok = launches == {k: v * n_steps for k, v in per_step.items()} and \
        all(v == want_shape for v in by_shape.values())
    peak = torch.cuda.max_memory_allocated() - base
    trace = _api_launches(torch, lambda: tr.step(x, y))
    pct = _pct(ms)
    idle = 1.0 - trace["device_busy_ms"] / pct["p50"]
    comm, estimate = dict(tr.last_stats["comm"]), tr.comm_estimate((B, T))
    held = _held_bytes(tr)
    log(f"[{label}] step p50 {pct['p50']:.2f} ms, p90 {pct['p90']:.2f} ms over "
        f"{PP_TP_TIMED}, {B * T / pct['p50'] * 1e3:.0f} tokens/s; traced step: device busy "
        f"{trace['device_busy_ms']:.2f} ms, idle {100 * idle:.2f}% of the p50, "
        f"{trace['host_launches']} host launches; peak {peak / 2**30:.3f} GiB above the "
        f"phase's start; weights and optimizer state held {held[0] / 2**30:.3f} GiB")
    log(f"[{label}] kernel launches over {n_steps} steps {launches} ({per_step} a step), "
        f"K1-K3 by shape {by_shape} (want {want_shape}) {'ok' if ok else 'FAIL'}; "
        f"collectives counted in a step {comm} (world 1: every group of one rank is "
        f"skipped), the reference's estimates {estimate}")
    if not ok:
        raise AssertionError(f"{label}: kernel launches {launches}, by shape {by_shape}")
    out = {"steps": steps, "loss_rel_pp": rel, "ms": ms, "pct": pct,
           "tokens_per_s": B * T / pct["p50"] * 1e3, "trace": trace, "idle_share": idle,
           "launches": launches, "per_step": per_step, "launches_by_shape": by_shape,
           "peak_bytes": peak, "held_bytes": held[0], "comm": comm, "estimate": estimate,
           "buckets": buckets, "ready_s": ready_s, "seconds": time.perf_counter() - t0}
    del tr, net
    torch.cuda.empty_cache()
    return out


def rank_pp_tp(workdir, device, steps, cfg, cfg4):
    """One of 4 ranks of phase_pp_tp_ranks (see there): each configuration's
    losses, counted collectives, kernel launches by shape, held bytes and peak
    memory; rank 0 writes each one's weights after ``sync()``."""
    import torch
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import _dist_util, elastic
    from mxnet_tpu_torch.models import BertModel
    ctx = _dist_util.rank_context(device)
    gpu = ctx.device_type == "gpu"
    if gpu:
        torch.backends.cuda.matmul.allow_tf32 = False
    params = dict(np.load(os.path.join(workdir, "weights.npz")))
    params4 = dict(np.load(os.path.join(workdir, "weights4.npz")))
    data = np.load(os.path.join(workdir, "data.npz"))
    x, y = (mx.nd.array(data[k], ctx=ctx, dtype="int32") for k in ("x", "y"))
    counters = _elastic_counters()
    rank = torch.distributed.get_rank()
    out = {"rank": rank}
    two = {"rep": 2, "pp": 1, "tp": 2}

    def run(name, axes, weights=params, c=cfg, dropout=0.0, megatron=False, n=steps,
            snapshot=None, **kw):
        net = _bert_base_net(mx, weights, ctx, dict(c, dropout=dropout))
        if megatron:
            mx.parallel.shard_params_megatron(net, axis="tp")
        mx.random.seed(7)
        if gpu:
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
        tr = _pp_tp_trainer(mx, net, mx.parallel.make_mesh(axes, devices=[ctx]), PP_TP_M, **kw)
        _zero_counters(counters)
        t0 = time.perf_counter()
        losses = []
        for i in range(n):
            losses.append(float(tr.step(x, y)))
            if snapshot is not None and i + 1 == snapshot:
                elastic.save_trainer(elastic.SnapshotManager(os.path.join(workdir, name)), tr,
                                     wait=True)
        res = {"losses": losses, "s": time.perf_counter() - t0, "comm": tr.last_stats["comm"],
               "launches": {k: c.launches for k, c in counters.items()},
               "by_shape": {k: dict(c.launches_by_shape) for k, c in
                            _flash_counters().items()},
               "held": _held_bytes(tr),
               "peak": torch.cuda.max_memory_allocated() - base if gpu else 0}
        tr.sync()
        if rank == 0:
            np.savez(os.path.join(workdir, f"{name}.npz"), **_host_weights(net))
        del tr, net
        return res
    out["part"] = run("part", two)
    out["sharded"] = run("sharded", two, megatron=True, tp_mode="sharded")
    out["drop"] = run("drop", two, dropout=0.1)
    out["drop_sp"] = run("drop_sp", two, dropout=0.1, sequence_parallel=True)
    zero = {"pp": 1, "tp": 2, "dp": 2}
    out["zero"] = run("zero", zero, dp_axis="dp", zero_update=True)
    out["zero_bf16"] = run("zero_bf16", zero, dp_axis="dp", zero_update=True,
                           comm_dtype="bfloat16")
    out["tp2"] = run("tp2", two, weights=params4, c=cfg4, n=4, snapshot=2)
    mx.random.seed(9)
    fresh = BertModel(**cfg4)
    fresh.initialize(ctx=ctx)
    tr4 = _pp_tp_trainer(mx, fresh, mx.parallel.make_mesh({"pp": 1, "tp": 4}, devices=[ctx]),
                         PP_TP_M)
    t0 = time.perf_counter()
    with elastic.SnapshotReader(os.path.join(workdir, "tp2"), 2) as rd:
        elastic.state.install(tr4, rd.manifest["meta"], rd, rd.names - {"rng"})
    out["tp4"] = {"install_s": time.perf_counter() - t0,
                  "losses": [float(tr4.step(x, y)) for _ in range(2)]}
    return out


def phase_pp_tp_ranks(torch, device="gpu", cfg=None, timeout=900):
    """Tensor parallelism and ZeRO in the stages as 4 gloo ranks sharing the
    card (correctness and memory, not time): BERT-base widths with
    PP_TP_LAYERS layers (or ``cfg``), T=1024, batch PP_TP_B in M = PP_TP_M,
    Adam 1e-4, PP_TP_RANK_STEPS steps, against the same trainer partitioned
    at tp 1 on a mesh of one device in this process: {tp: 2} partitioned
    (K1-K3 on 6 heads a rank) and weight-sharded (``shard_params_megatron``),
    losses to TOL_PP_LOSS and weights after ``sync()`` to TOL_PP_W; {tp: 2}
    partitioned with sequence parallelism against none, dropout 0.1: the
    first loss bitwise, then the f32 tolerances; {tp: 2, dp: 2} partitioned
    with ZeRO against the tp-1 run on the same global batch, native (the f32
    tolerances) and bf16 wire (TOL_PP_TP_WIRE). On each tp 2 rank: the
    weights and optimizer state it keeps for the tp-split leaves are half of
    theirs whole; partitioned gathers no weight and issues M (4L + 2)
    activation all-reduces a step, weight-sharded gathers. A tp 2 snapshot
    (vocab PP_TP_VOCAB4, which splits 4 ways) resumed on {tp: 4} continues the
    tp 2 trajectory to TOL_PP_TP_RESUME."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import _dist_util
    from mxnet_tpu_torch.convert import seeded_params
    from mxnet_tpu_torch.models import BertModel
    label = "pp-tp-ranks"
    cfg = dict(cfg or dict(num_layers=PP_TP_LAYERS, max_length=PP_T))
    cfg4 = dict(cfg, vocab_size=PP_TP_VOCAB4)
    L = cfg["num_layers"]
    T = cfg["max_length"]
    heads = cfg.get("num_heads", 12)
    D = cfg.get("units", 768) // heads
    vocab = min(cfg.get("vocab_size", 30522), PP_TP_VOCAB4)
    n = 4
    work = os.path.join(ROOT, "build", "pp_tp_ranks")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    params = seeded_params(BertModel(**cfg), seed=45)
    params4 = seeded_params(BertModel(**cfg4), seed=46)
    rs = np.random.RandomState(47)
    data = {k: rs.randint(0, vocab, size=(PP_TP_B, T)).astype(np.int32)
            for k in ("x", "y")}
    np.savez(os.path.join(work, "weights.npz"), **params)
    np.savez(os.path.join(work, "weights4.npz"), **params4)
    np.savez(os.path.join(work, "data.npz"), **data)
    ctx = mx.gpu(0) if device == "gpu" else mx.cpu()
    gpu = device == "gpu"
    if gpu:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
    net = _bert_base_net(mx, params, ctx, cfg)
    tr = _pp_tp_trainer(mx, net, mx.parallel.Mesh([ctx], ("pp", "tp"), (1, 1)), PP_TP_M)
    x, y = (mx.nd.array(data[k], ctx=ctx, dtype="int32") for k in ("x", "y"))
    ref = [float(tr.step(x, y)) for _ in range(PP_TP_RANK_STEPS)]
    held1 = _held_bytes(tr)
    peak1 = torch.cuda.max_memory_allocated() - base if gpu else 0
    tr.sync()
    ref_w = _host_weights(net)
    del tr, net
    if gpu:
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = _dist_util.launch_local(
        "chip_smoke:rank_pp_tp", n, {"workdir": work, "device": device,
                                     "steps": PP_TP_RANK_STEPS, "cfg": cfg, "cfg4": cfg4},
        device=device, timeout=timeout, pythonpath=[ROOT], workdir=os.path.join(work, "launch"))
    seconds = time.perf_counter() - t0
    got = {k: dict(np.load(os.path.join(work, f"{k}.npz")))
           for k in ("part", "sharded", "drop", "drop_sp", "zero", "zero_bf16")}
    shutil.rmtree(work, ignore_errors=True)

    def close(name, want_losses, want_w, tol):
        rel = max(abs(a - b) / abs(b) for r in ranks for a, b in zip(r[name]["losses"],
                                                                      want_losses))
        w_abs = max(float(np.abs(got[name][k] - w).max()) for k, w in want_w.items())
        ok = rel <= tol[0] and w_abs <= tol[1]
        log(f"[{label}] {name}: losses {[round(v, 6) for v in ranks[0][name]['losses']]} "
            f"max rel {rel:.2e} (tol {tol[0]:.0e}), weights max|d| {w_abs:.2e} (tol "
            f"{tol[1]:.0e}) {'ok' if ok else 'FAIL'}")
        return ok, rel, w_abs
    f32 = (TOL_PP_LOSS, TOL_PP_W)
    checks = {name: close(name, ref, ref_w, f32) for name in ("part", "sharded", "zero")}
    checks["zero_bf16"] = close("zero_bf16", ref, ref_w, TOL_PP_TP_WIRE["bfloat16"])
    drop = [r["drop"]["losses"] for r in ranks]
    checks["drop_sp"] = close("drop_sp", drop[0], got["drop"], f32)
    first_bitwise = all(r["drop"]["losses"][0] == r["drop_sp"]["losses"][0] for r in ranks)
    dropped = drop[0][0] != ranks[0]["part"]["losses"][0]
    log(f"[{label}] dropout 0.1, sp against none: first loss "
        f"{'bitwise equal' if first_bitwise else 'DIFFERS'} on every rank; dropout "
        f"{'changes' if dropped else 'DOES NOT change'} the loss")
    tp4 = max(abs(a - b) / abs(b) for r in ranks
              for a, b in zip(r["tp4"]["losses"], r["tp2"]["losses"][2:]))
    log(f"[{label}] tp 2 snapshot (vocab {PP_TP_VOCAB4}) resumed on {{tp: 4}}: steps 3-4 "
        f"{[round(v, 6) for v in ranks[0]['tp4']['losses']]} against tp 2's "
        f"{[round(v, 6) for v in ranks[0]['tp2']['losses'][2:]]}, max rel {tp4:.2e} (tol "
        f"{TOL_PP_TP_RESUME:.0e}); install {ranks[0]['tp4']['install_s']:.2f} s")
    M_act = PP_TP_M * (4 * L + 2)
    mem_ok = comm_ok = launch_ok = True
    for r in sorted(ranks, key=lambda r: r["rank"]):
        for name in ("part", "sharded"):
            held, split, whole = r[name]["held"]
            ratio = split / whole
            mem_ok &= ratio == 0.5
            comm = r[name]["comm"]
            gathers = comm.get("tp_weight_all_gather@tp", {"calls": 0})["calls"]
            acts = comm.get("act_all_reduce@tp", {"calls": 0})["calls"]
            comm_ok &= (gathers == 0 and acts == M_act) if name == "part" else \
                (gathers > 0 and acts == 0)
            log(f"[{label}] rank {r['rank']} {name}: held {held / 2**20:.1f} MiB (tp 1: "
                f"{held1[0] / 2**20:.1f}), its tp-split leaves {split / 2**20:.1f} of "
                f"{whole / 2**20:.1f} MiB whole ({ratio:.3f}); peak {r[name]['peak'] / 2**30:.3f}"
                f" GiB (tp 1: {peak1 / 2**30:.3f}); a step's weight all-gathers {gathers}, "
                f"activation all-reduces {acts} (M(4L+2) = {M_act}); {r[name]['s']:.1f} s")
        want = {f"{PP_TP_B // PP_TP_M * heads // 2}x{T}x{T}x{D}":
                PP_TP_RANK_STEPS * L * PP_TP_M}
        launch_ok &= not gpu or all(v == want for v in r["part"]["by_shape"].values())
    log(f"[{label}] K1-K3 on {heads // 2} heads a rank: {ranks[0]['part']['by_shape']} "
        f"{'ok' if launch_ok else 'FAIL'}; {n} ranks in {seconds:.1f} s")
    ok = all(c[0] for c in checks.values()) and first_bitwise and dropped and \
        tp4 <= TOL_PP_TP_RESUME and mem_ok and comm_ok and launch_ok
    if not ok:
        raise AssertionError(f"{label}: a check failed (see above)")
    return {"seconds": seconds, "ref_losses": ref, "held_tp1": held1, "peak_tp1": peak1,
            "checks": {k: {"loss_rel": c[1], "weight_abs": c[2]} for k, c in checks.items()},
            "tp4_rel": tp4, "act_all_reduces_per_rank_step": M_act,
            "ranks": ranks,
            "launches": {k: sum(r[c]["launches"][k] for r in ranks
                                for c in ("part", "sharded", "drop", "drop_sp", "zero",
                                          "zero_bf16", "tp2"))
                         for k in ranks[0]["part"]["launches"]}}


# --- the pipeline's other schedules and models: GPipe, interleaved stages, LC and MoE ---

PP_GPIPE_CHECKED = 3               # steps held against phase_pp_train's; its step-3 weights
PP_SCHED_TIMED = 8                 # timed steps after them: p50 and p90
PP_MEM_MICRO = 2                   # the memory sweep's microbatch (sequences) at M 4 and 8
PP_VIRTUAL = (2, 3)                # phase_pp_interleaved's virtual stages (12 layers: 6, 4)
PP_LC_M = 4                        # LongContextLM's pipeline: batch LC_B in 4 microbatches
PP_MOE_M, PP_MOE_STEPS = 4, 3      # the MoE pipeline: batch MOE_B in 4, 3 checked steps
PP_MOE_CHECK_B, PP_MOE_CHECK_M = 2, 2
PP_SCHED_RANK_STEPS = 2
PP_SCHED_RANK_B, PP_SCHED_RANK_M = 4, 2
PP_LC_RANK_T = 2048                # the ranks' LongContextLM sequence: causal K1-K3 on a tp half


def _flash_per_step(n, fwd=1):
    """K1-K3 and K5 a step: ``n`` attention calls (layers x microbatches),
    K1 ``fwd`` times each (2 where remat runs the forward again)."""
    return {"flash_attention_fwd": fwd * n, "flash_attention_bwd_dq": n,
            "flash_attention_bwd_dkv": n, "fused_adam_update": 1}


def _timed_steps(torch, tr, x, y, n):
    """``n`` steps of ``tr``, each ending in a sync: their ms."""
    ms = []
    for _ in range(n):
        t_step = time.perf_counter()
        tr.step(x, y)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t_step) * 1e3)
    return ms


def _timed_report(torch, label, tr, x, y, tokens, counters, per_step, done):
    """PP_SCHED_TIMED timed steps after ``done`` checked ones (the launch
    counts of all of them checked against ``per_step``), then one step
    traced (``_api_launches``): p50, p90, tokens/s, device busy, the idle
    share 1 - busy / p50, host launches."""
    ms = _timed_steps(torch, tr, x, y, PP_SCHED_TIMED)
    n = done + PP_SCHED_TIMED
    launches = {k: c.launches for k, c in counters.items()}
    if launches != {k: v * n for k, v in per_step.items()}:
        raise AssertionError(f"{label}: launches {launches} over {n} steps, want {per_step} "
                             f"a step")
    trace = _api_launches(torch, lambda: tr.step(x, y))
    pct = _pct(ms)
    idle = 1.0 - trace["device_busy_ms"] / pct["p50"]
    log(f"[{label}] step p50 {pct['p50']:.2f} ms, p90 {pct['p90']:.2f} ms over "
        f"{PP_SCHED_TIMED}, {tokens / pct['p50'] * 1e3:.0f} tokens/s; traced step: device busy "
        f"{trace['device_busy_ms']:.2f} ms, idle {100 * idle:.2f}% of the p50, "
        f"{trace['host_launches']} host launches; launches over {n} steps {launches}")
    return {"ms": ms, "pct": pct, "tokens_per_s": tokens / pct["p50"] * 1e3, "trace": trace,
            "idle_share": idle, "launches": launches}


def _pp_memory(torch, mx, net, mesh, x16, y16):
    """Peak device memory of one step at a microbatch of PP_MEM_MICRO
    sequences, M 4 (batch 8) and M 8 (batch 16), for 1F1B and GPipe with
    and without remat (the step after a warm-up one; ``static`` the memory
    held before it, ``act`` the peak above it). ``x16``, ``y16``: (16, T)
    numpy tokens and labels."""
    out = {}
    for name, kw in (("1f1b", {}), ("gpipe_remat", dict(schedule="gpipe")),
                     ("gpipe_noremat", dict(schedule="gpipe", remat=False))):
        for M in (PP_M, 2 * PP_M):
            b = PP_MEM_MICRO * M
            xs, ys = (mx.nd.array(a[:b], ctx=mx.gpu(0), dtype="int32") for a in (x16, y16))
            tr = _pp_trainer(mx, net, mesh, M, dp_axis="dp", **kw)
            tr.step(xs, ys)
            torch.cuda.synchronize()
            static = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            tr.step(xs, ys)
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated()
            out[f"{name}_m{M}"] = {"peak": peak, "static": static, "act": peak - static,
                                   "in_flight": tr.last_stats["max_in_flight"]}
            del tr
            torch.cuda.empty_cache()
    gib = 2 ** 30
    for key, m in out.items():
        log(f"[pp-memory] {key}: peak {m['peak'] / gib:.3f} GiB, static {m['static'] / gib:.3f},"
            f" above it {m['act'] / gib:.3f} GiB, {m['in_flight']} microbatches held")
    return out


def phase_pp_gpipe(torch, params, batch, pp_train, pp_w3):
    """GPipe on the main path, world-1 NCCL {pp: 1, dp: 1} (the caller holds
    the group): BERT-base at T=1024, batch 8 in M = 4, Adam lr 1e-4, f32 with
    TF32 off, ``schedule="gpipe"`` with ``remat`` and without. Each: its
    first loss against phase_pp_train's 1F1B (same weights and batch) to
    TOL_PP_LOSS, its weights after 3 steps against phase_pp_train's step-3
    weights to TOL_PP_W (the order of the gradient sums differs); each step
    launches K1 48 times (96 with remat: the backward runs each stage forward
    again), K2 and K3 48 and K5 once; then PP_SCHED_TIMED timed steps and one
    traced. Then the memory sweep (``_pp_memory``): 1F1B's peak above the
    static memory may grow from M 4 to M 8 by no more than the extra tokens
    plus PP_MEM_MARGIN, beside GPipe's with and without remat."""
    import mxnet_tpu_torch as mx
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    tokens, labels = batch
    B, T = tokens.shape
    n_layers = 12
    mesh = mx.parallel.make_mesh({"pp": 1, "dp": 1}, devices=[mx.gpu(0)])
    x = mx.nd.array(tokens, ctx=mx.gpu(0), dtype="int32")
    y = mx.nd.array(labels, ctx=mx.gpu(0), dtype="int32")
    counters = _elastic_counters()
    ref = [st["loss"] for st in pp_train["steps"][:PP_GPIPE_CHECKED]]
    out = {}
    for remat in (True, False):
        label = "pp-gpipe" + ("" if remat else "-noremat")
        t0 = time.perf_counter()
        net = _bert_base_net(mx, params, mx.gpu(0))
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        tr = _pp_trainer(mx, net, mesh, PP_M, dp_axis="dp", schedule="gpipe", remat=remat)
        per_step = _flash_per_step(n_layers * PP_M, 2 if remat else 1)
        w3 = {}

        def grab(i):
            if i == PP_GPIPE_CHECKED - 1:
                tr.sync()
                w3.update(_host_weights(net))
        _zero_counters(counters)
        steps = _dp_steps(torch, label, tr, x, y, PP_GPIPE_CHECKED, per_step,
                          (B * T, "tokens_per_s"), counters, after=grab)
        rels = [abs(a["loss"] - b) / abs(b) for a, b in zip(steps, ref)]
        w_abs = max(float(np.abs(w3[k] - w).max()) for k, w in pp_w3.items())
        ok = rels[0] <= TOL_PP_LOSS and w_abs <= TOL_PP_W and \
            steps[-1]["loss"] < steps[0]["loss"]
        log(f"[{label}] losses {[round(st['loss'], 6) for st in steps]} against 1F1B's "
            f"{[round(v, 6) for v in ref]}: rel {[f'{r:.1e}' for r in rels]} (the first's tol "
            f"{TOL_PP_LOSS:.0e}); step-{PP_GPIPE_CHECKED} weights max|d| {w_abs:.2e} (tol "
            f"{TOL_PP_W:.0e}); schedule {tr.last_stats} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{label}: GPipe disagrees with 1F1B")
        res = _timed_report(torch, label, tr, x, y, B * T, counters, per_step,
                            PP_GPIPE_CHECKED)
        res.update(steps=steps, loss_rel=rels, weight_abs=w_abs, per_step=per_step,
                   schedule=dict(tr.last_stats), seconds=time.perf_counter() - t0,
                   peak_bytes=torch.cuda.max_memory_allocated() - base)
        out["remat" if remat else "noremat"] = res
        del tr, net
        torch.cuda.empty_cache()
    # the memory sweep, on one model
    rs = np.random.RandomState(42)
    more = rs.randint(0, params["word_embed.weight"].shape[0],
                      size=(2,) + tokens.shape).astype(np.int32)
    net = _bert_base_net(mx, params, mx.gpu(0))
    mem = _pp_memory(torch, mx, net, mesh, np.concatenate([tokens, more[0]]),
                     np.concatenate([labels, more[1]]))
    del net
    torch.cuda.empty_cache()
    extra = PP_B * PP_T * 4 * 2          # the 8 more sequences' tokens and labels, int32
    f4, f8 = mem[f"1f1b_m{PP_M}"], mem[f"1f1b_m{2 * PP_M}"]
    flat = f8["peak"] <= (f4["peak"] + extra) * (1 + PP_MEM_MARGIN)
    log(f"[pp-memory] 1F1B peak {f4['peak'] / 2**30:.3f} -> {f8['peak'] / 2**30:.3f} GiB from "
        f"M={PP_M} to M={2 * PP_M} (limit +{extra} B of tokens, +{100 * PP_MEM_MARGIN:.0f}%) "
        f"{'ok' if flat else 'FAIL'}; GPipe with remat "
        f"{mem[f'gpipe_remat_m{PP_M}']['peak'] / 2**30:.3f} -> "
        f"{mem[f'gpipe_remat_m{2 * PP_M}']['peak'] / 2**30:.3f}, without "
        f"{mem[f'gpipe_noremat_m{PP_M}']['peak'] / 2**30:.3f} -> "
        f"{mem[f'gpipe_noremat_m{2 * PP_M}']['peak'] / 2**30:.3f} GiB")
    if not flat:
        raise AssertionError("pp-memory: 1F1B's peak grew with M")
    out["memory"] = mem
    return out


def phase_pp_interleaved(torch, params, batch, pp_train):
    """The interleaved 1F1B on the main path, world-1 NCCL {pp: 1, dp: 1}:
    BERT-base at T=1024, batch 8 in M = 4, Adam lr 1e-4, f32, at
    ``virtual_stages`` 2 and 3 (chunks of 6 and 4 layers), 3 steps each: the
    losses within TOL_PP_LOSS of phase_pp_train's (v 1), K1-K3 48 and K5
    once a step, M + 2(v - 1) ticks, at most min(M, 2 v - 1) microbatches
    in a chunk, no send (a chunk hands its output to the next within the
    process)."""
    import mxnet_tpu_torch as mx
    torch.backends.cuda.matmul.allow_tf32 = False
    tokens, labels = batch
    B, T = tokens.shape
    mesh = mx.parallel.make_mesh({"pp": 1, "dp": 1}, devices=[mx.gpu(0)])
    x = mx.nd.array(tokens, ctx=mx.gpu(0), dtype="int32")
    y = mx.nd.array(labels, ctx=mx.gpu(0), dtype="int32")
    counters = _elastic_counters()
    per_step = _flash_per_step(12 * PP_M)
    ref = [st["loss"] for st in pp_train["steps"][:3]]
    out = {}
    for v in PP_VIRTUAL:
        label = f"pp-interleaved-v{v}"
        net = _bert_base_net(mx, params, mx.gpu(0))
        tr = _pp_trainer(mx, net, mesh, PP_M, dp_axis="dp", virtual_stages=v)
        _zero_counters(counters)
        steps = _dp_steps(torch, label, tr, x, y, 3, per_step, (B * T, "tokens_per_s"),
                          counters)
        rel = max(abs(a["loss"] - b) / abs(b) for a, b in zip(steps, ref))
        stats = dict(tr.last_stats)
        want = {"ticks": PP_M + 2 * (v - 1), "max_in_flight": min(PP_M, 2 * v - 1),
                "sends": 0, "bytes": 0}
        ok = rel <= TOL_PP_LOSS and {k: stats[k] for k in want} == want
        med = float(np.median([st["ms"] for st in steps[1:]]))
        log(f"[{label}] chunks of {12 // v} layers: losses against v 1's max rel {rel:.2e} "
            f"(tol {TOL_PP_LOSS:.0e}); schedule {stats} (want {want}); median step "
            f"{med:.2f} ms {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{label}: the interleaved schedule disagrees")
        out[f"v{v}"] = {"steps": steps, "loss_rel": rel, "schedule": stats,
                        "step_median_ms": med, "per_step": per_step,
                        "launches": {k: c.launches for k, c in counters.items()}}
        del tr, net
        torch.cuda.empty_cache()
    out["launches"] = {k: sum(r["launches"][k] for r in out.values()) for k in per_step}
    return out


def _lc_pipeline(mx, weights, ctx, mesh, M, T, cfg=LC_CFG, **kw):
    """``LongContextLM`` (``cfg``, positions up to ``T``) with ``weights``
    in ``PipelineTrainer`` through its ``pipeline_split``: the recipe's loss
    and Adam lr."""
    from mxnet_tpu_torch.convert import load_jax_params
    from mxnet_tpu_torch.recipes import long_context as lc
    net = lc.LongContextLM(LC_VOCAB, max_length=T, **cfg)
    net.initialize(ctx=ctx)
    load_jax_params(net, {k: v[:T] if k == "pos_embed.weight" else v
                          for k, v in weights.items()})
    return net, mx.parallel.PipelineTrainer(
        net, lc.token_cross_entropy, optimizer="adam", optimizer_params={"learning_rate": LC_LR},
        mesh=mesh, num_microbatch=M, **kw)


def phase_pp_lc(torch, weights, lc_train):
    """``LongContextLM.pipeline_split`` on a world-1 NCCL mesh, at the
    recipe's configuration: T=32768, batch 4 in M = 4 microbatches, Adam
    1e-3, f32 with TF32 off, through the Gluon cells and through
    ``tp_mode="partitioned"`` at tp 1 (``megatron.cell_forward``'s causal
    branch). The first 3 losses of each against LongContextTrainer's
    (phase_lc_train: the same weights and batch) to TOL_PP_LOSS: the
    microbatch means average to the batch mean. Each step launches causal
    K1, K2 and K3 8 times (2 layers x 4) and K5 once; then PP_SCHED_TIMED
    timed steps and one traced."""
    import mxnet_tpu_torch as mx
    torch.backends.cuda.matmul.allow_tf32 = False
    tokens, labels = _lc_batch(LC_B, LC_T, seed=12)     # phase_lc_train's batch
    x = mx.nd.array(tokens, ctx=mx.gpu(0), dtype="int32")
    y = mx.nd.array(labels, ctx=mx.gpu(0), dtype="int32")
    ref = [st["loss"] for st in lc_train["steps"][:3]]
    counters = _lc_counters()
    per_step = _flash_per_step(LC_CFG["num_layers"] * PP_LC_M)
    out = {}
    for name, axes, kw in (("gluon", {"pp": 1, "dp": 1}, {}),
                           ("partitioned", {"pp": 1, "tp": 1},
                            dict(tp_axis="tp", tp_mode="partitioned"))):
        label = f"pp-lc-{name}"
        mesh = mx.parallel.make_mesh(axes, devices=[mx.gpu(0)])
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        net, tr = _lc_pipeline(mx, weights, mx.gpu(0), mesh, PP_LC_M, LC_T, **kw)
        _zero_counters(counters)
        steps = _dp_steps(torch, label, tr, x, y, 3, per_step, (LC_B * LC_T, "tokens_per_s"),
                          counters)
        rel = max(abs(a["loss"] - b) / abs(b) for a, b in zip(steps, ref))
        masks = {k: dict(c.launches_by_mask) for k, c in _flash_counters().items()}
        ok = rel <= TOL_PP_LOSS and not any(m.get("full") for m in masks.values()) and \
            steps[-1]["loss"] < steps[0]["loss"]
        log(f"[{label}] LongContextLM {LC_CFG}, batch {LC_B} x T {LC_T} in M={PP_LC_M}: "
            f"losses against LongContextTrainer's {[round(v, 6) for v in ref]}: max rel "
            f"{rel:.2e} (tol {TOL_PP_LOSS:.0e}); K1-K3 by mask {masks} "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{label}: the pipeline disagrees with LongContextTrainer")
        res = _timed_report(torch, label, tr, x, y, LC_B * LC_T, counters, per_step, 3)
        res.update(steps=steps, loss_rel=rel, per_step=per_step, launches_by_mask=masks,
                   peak_bytes=torch.cuda.max_memory_allocated() - base)
        out[name] = res
        del tr, net
        torch.cuda.empty_cache()
    out["launches"] = {k: sum(r["launches"][k] for r in out.values()) for k in per_step}
    return out


def _moe_pipeline(mx, weights, ctx, mesh, M, cfg=None, **kw):
    """``MoETransformerLM`` (``cfg``, default MOE_CFG) with ``weights`` in
    ``PipelineTrainer`` through its ``pipeline_split``: the recipe's task
    loss, Adam lr 1e-4."""
    from mxnet_tpu_torch.recipes import moe as rmoe
    net = _moe_net(mx, weights, ctx, cfg)
    return net, mx.parallel.PipelineTrainer(
        net, rmoe.token_cross_entropy, optimizer="adam",
        optimizer_params={"learning_rate": MOE_LR}, mesh=mesh, num_microbatch=M, **kw)


def _moe_pp_step(mx, weights, ctx, mesh, x, y, cfg):
    """One pipeline step of the MoE LM: ((loss, gradients, weights), each
    gated forward's routing)."""
    from mxnet_tpu_torch.parallel import moe as pmoe
    net, tr = _moe_pipeline(mx, weights, ctx, mesh, PP_MOE_CHECK_M, cfg)
    xs, ys = (mx.nd.array(a, ctx=ctx, dtype="int32") for a in (x, y))
    with pmoe.collect_metrics() as mc:
        loss = float(tr.step(xs, ys))
    keys = net._collect_params_with_prefix()
    return ((loss, {k: p.grad().asnumpy() for k, p in keys.items()}, _host_weights(net)),
            [a.cpu().numpy() for a in mc.assignments])


def phase_pp_moe(torch, weights):
    """``MoETransformerLM.pipeline_split`` on a world-1 NCCL mesh {pp: 1, dp:
    1}: Switch-Base-8 widths (MOE_CFG, 4 layers, 211 M parameters), T=1024,
    batch 8 in M = 4, Adam 1e-4, f32 with TF32 off, the task loss:
    PP_MOE_STEPS steps, each launching K1-K3 16 times and K5 once, a finite loss that falls, the
    dropped assignments; PP_SCHED_TIMED timed steps and one traced; peak
    memory. The capacity is each microbatch's, so the losses are not
    MoETrainer's. Then a 2-layer copy at the same widths, one step of batch
    2 in M = 2, on the card against the CPU (the plain versions): the
    routing first (flips counted), then the training checks' tolerances,
    gate_w's rounding-only gradient apart."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.parallel import moe as pmoe
    torch.backends.cuda.matmul.allow_tf32 = False
    label = "pp-moe"
    t0 = time.perf_counter()
    mesh = mx.parallel.make_mesh({"pp": 1, "dp": 1}, devices=[mx.gpu(0)])
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    net, tr = _moe_pipeline(mx, weights, mx.gpu(0), mesh, PP_MOE_M, dp_axis="dp")
    tokens, labels = _moe_batch(MOE_B, MOE_T, seed=31)      # phase_moe_train's batch
    x = mx.nd.array(tokens, ctx=mx.gpu(0), dtype="int32")
    y = mx.nd.array(labels, ctx=mx.gpu(0), dtype="int32")
    counters = _elastic_counters()
    per_step = _flash_per_step(MOE_CFG["num_layers"] * PP_MOE_M)
    _zero_counters(counters)
    with pmoe.collect_metrics() as mc:
        steps = _dp_steps(torch, label, tr, x, y, PP_MOE_STEPS, per_step,
                          (MOE_B * MOE_T, "tokens_per_s"), counters)
    dropped = int(mc.dropped_total())
    assignments = PP_MOE_STEPS * MOE_B * MOE_T * MOE_CFG["top_k"] * MOE_CFG["num_layers"]
    if not steps[-1]["loss"] < steps[0]["loss"]:
        raise AssertionError(f"{label}: the loss did not fall")
    res = _timed_report(torch, label, tr, x, y, MOE_B * MOE_T, counters, per_step,
                        PP_MOE_STEPS)
    peak = torch.cuda.max_memory_allocated() - base
    log(f"[{label}] MoETransformerLM at Switch-Base-8 widths, batch {MOE_B} x T {MOE_T} in "
        f"M={PP_MOE_M}: losses {[round(st['loss'], 6) for st in steps]}; dropped (token, "
        f"choice) assignments {dropped} of {assignments} over {PP_MOE_STEPS} steps and "
        f"{MOE_CFG['num_layers']} layers; peak {peak / 2**30:.3f} GiB above the phase's start")
    res.update(steps=steps, per_step=per_step, dropped=dropped, assignments=assignments,
               peak_bytes=peak, ready_s=time.perf_counter() - t0)
    del tr, net, x, y
    torch.cuda.empty_cache()
    # the 2-layer copy, GPU against CPU
    cfg = dict(MOE_CFG, num_layers=MOE_RANK_LAYERS)
    w2 = _moe_weights(cfg, seed=35)
    xc, yc = _moe_batch(PP_MOE_CHECK_B, MOE_T, seed=36, vocab=cfg["vocab_size"])
    gpu, routes_gpu = _moe_pp_step(mx, w2, mx.gpu(0), mesh, xc, yc, cfg)
    torch.cuda.empty_cache()
    cpu, routes_cpu = _moe_pp_step(mx, w2, mx.cpu(),
                                   mx.parallel.Mesh([mx.cpu()], ("pp",), (1,)), xc, yc, cfg)
    flips = _flips(routes_gpu, routes_cpu)
    # top-1's normalized combine weight is g/g = 1: the task loss gives the
    # gate no gradient but f32 rounding, different on the two devices, so
    # gate_w's gradient is compared by neither bar, and its weights, which
    # Adam may step by up to lr either way on such noise, at 2 lr
    gate = [k for k in cpu[1] if k.endswith("moe.gate_w")]
    gpu_r, cpu_r = ((r[0], *({k: v for k, v in d.items() if k not in gate} for d in r[1:]))
                    for r in (gpu, cpu))
    check = _step_agreement(gpu_r, cpu_r, MOE_LR)
    gate_w = max(float(np.abs(gpu[2][k] - cpu[2][k]).max()) for k in gate)
    gate_g = max(float(np.abs(gpu[1][k]).max()) for k in gate)
    ok = check.pop("ok") and flips == 0 and gate_w <= 2.0 * MOE_LR * 1.001
    log(f"[{label}-check] {MOE_RANK_LAYERS} layers of Switch-Base-8 width, T={MOE_T}, batch "
        f"{PP_MOE_CHECK_B} in M={PP_MOE_CHECK_M}, one PipelineTrainer step, GPU vs CPU: routing "
        f"flips {flips} over {len(routes_gpu)} gated forwards; loss {gpu[0]:.6f} vs "
        f"{cpu[0]:.6f} (rel {check['loss_rel']:.2e}, tol {TOL_TRAIN_LOSS:.0e}); gradients but "
        f"gate_w's {check['grad_rel']:.2e} of the tensor's max (tol {TOL_TRAIN_GRAD:.0e}); "
        f"weights max|d| {check['weight_max_abs']:.2e} (tol {TOL_TRAIN_W:.0e}), "
        f"{check['near_zero_grad_elements']} elements with a nonzero |g| within the gradient "
        f"tolerance of 0 up to {check['near_zero_weight_max_abs']:.2e} (tol 2 lr); gate_w "
        f"(largest |g| {gate_g:.1e}, rounding) weights max|d| {gate_w:.2e} (tol 2 lr) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{label}: the MoE pipeline step on the card disagrees with the "
                             f"CPU")
    res["check"] = dict(check, flips=flips, loss_gpu=gpu[0], loss_cpu=cpu[0],
                        gate_w_weight_abs=gate_w, gate_w_grad_max=gate_g)
    return res


def rank_pp_sched(workdir, device, steps, cfg, cfg4, lc_cfg, lc_T, moe_cfg):
    """One of 4 ranks of phase_pp_sched_ranks (see there): each case's
    losses and launches, stage 0's peaks; rank 0 writes each case's weights
    after ``sync()``."""
    import torch
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import _dist_util
    ctx = _dist_util.rank_context(device)
    gpu = ctx.device_type == "gpu"
    if gpu:
        torch.backends.cuda.matmul.allow_tf32 = False
    data = dict(np.load(os.path.join(workdir, "data.npz")))
    counters = _elastic_counters()
    rank = torch.distributed.get_rank()
    out = {"rank": rank}

    def mesh(axes):
        return mx.parallel.make_mesh(axes, devices=[ctx])

    def run(name, make, xk, n=steps):
        net, tr = make()
        x, y = (mx.nd.array(data[f"{xk}_{k}"], ctx=ctx, dtype="int32") for k in ("x", "y"))
        _zero_counters(counters)
        t0 = time.perf_counter()
        losses = [float(tr.step(x, y)) for _ in range(n)]
        res = {"losses": losses, "s": time.perf_counter() - t0, "stage": tr.stage,
               "stats": {k: v for k, v in tr.last_stats.items() if k != "comm"},
               "own": list(tr._own), "stack_order": list(tr._stack_order),
               "launches": {k: c.launches for k, c in counters.items()}}
        tr.sync()
        if rank == 0:
            np.savez(os.path.join(workdir, f"{name}.npz"), **_host_weights(net))
        del tr, net
        return res

    def bert(c, axes, **kw):
        def make():
            net = _bert_base_net(mx, dict(np.load(os.path.join(workdir, f"{c}.npz"))), ctx,
                                 cfg if c == "bert2" else cfg4)
            return net, _pp_trainer(mx, net, mesh(axes), PP_SCHED_RANK_M, **kw)
        return make
    two = {"rep": 2, "pp": 2}
    out["gpipe_pp2"] = run("gpipe_pp2", bert("bert2", two, schedule="gpipe"), "bert")
    out["gpipe_pp2_dp2"] = run("gpipe_pp2_dp2", bert("bert2", {"pp": 2, "dp": 2},
                                                     dp_axis="dp", schedule="gpipe"), "bert")
    out["v2_pp2"] = run("v2_pp2", bert("bert4", two, virtual_stages=2), "bert")
    tp = {"rep": 2, "pp": 1, "tp": 2}
    part = dict(tp_axis="tp", tp_mode="partitioned")
    lc_w = dict(np.load(os.path.join(workdir, "lc.npz")))
    out["lc_tp2"] = run("lc_tp2", lambda: _lc_pipeline(
        mx, lc_w, ctx, mesh(tp), PP_SCHED_RANK_M, lc_T, cfg=lc_cfg, **part), "lc")
    moe_w = dict(np.load(os.path.join(workdir, "moe.npz")))
    out["moe_tp2"] = run("moe_tp2", lambda: _moe_pipeline(
        mx, moe_w, ctx, mesh(tp), PP_SCHED_RANK_M, moe_cfg, **part), "moe")
    # stage 0's peak at a microbatch of PP_MEM_MICRO, M 4 and 8: GPipe and 1F1B
    net = _bert_base_net(mx, dict(np.load(os.path.join(workdir, "bert2.npz"))), ctx, cfg)
    peaks = {}
    for name, kw in (("1f1b", {}), ("gpipe", dict(schedule="gpipe"))):
        for M in (PP_M, 2 * PP_M):
            b = PP_MEM_MICRO * M
            x, y = (mx.nd.array(data[f"mem_{k}"][:b], ctx=ctx, dtype="int32") for k in "xy")
            tr = _pp_trainer(mx, net, mesh(two), M, **kw)
            tr.step(x, y)
            if gpu:
                torch.cuda.synchronize()
                static = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
            tr.step(x, y)
            peaks[f"{name}_m{M}"] = {"stage": tr.stage, **(
                {"peak": torch.cuda.max_memory_allocated(), "static": static} if gpu else {})}
            del tr
            if gpu:
                torch.cuda.empty_cache()
    out["memory"] = peaks
    return out


def phase_pp_sched_ranks(torch, device="gpu", cfg=None, timeout=900):
    """The new schedules and splits as 4 gloo ranks sharing the card
    (correctness and memory, not time), PP_SCHED_RANK_STEPS steps of batch
    PP_SCHED_RANK_B in M = PP_SCHED_RANK_M, each against the same model's
    1F1B at pp 1 in this process: GPipe at {pp: 2} and {pp: 2, dp: 2} on 2
    layers of BERT-base width (or ``cfg``) at T=1024; the interleaved pp 2 x
    v 2 on 4 such layers (stack order [0, 2, 1, 3]); ``LongContextLM``'s
    split at {tp: 2} partitioned (the causal branch, one head a rank) at
    T=PP_LC_RANK_T; the MoE's split at {tp: 2} partitioned (``_tp_moe``: 4
    of the 8 experts a rank) on 2 layers of Switch-Base-8 width: losses to
    TOL_PP_LOSS, the weights after ``sync()`` to TOL_PP_W. Then stage 0's
    peak memory at {pp: 2} for GPipe against 1F1B at M 4 and 8 (microbatches
    of PP_MEM_MICRO sequences)."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import _dist_util
    from mxnet_tpu_torch.convert import seeded_params
    from mxnet_tpu_torch.models import BertModel
    label = "pp-sched-ranks"
    cfg = dict(cfg or dict(num_layers=2, max_length=PP_T))
    cfg4 = dict(cfg, num_layers=4)
    lc_cfg = dict(LC_CFG)
    moe_cfg = dict(MOE_CFG, num_layers=MOE_RANK_LAYERS)
    T = cfg["max_length"]
    vocab = cfg.get("vocab_size", 30522)
    n = 4
    work = os.path.join(ROOT, "build", "pp_sched_ranks")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    weights = {"bert2": seeded_params(BertModel(**cfg), seed=50),
               "bert4": seeded_params(BertModel(**cfg4), seed=51),
               "lc": _lc_weights(lc_cfg), "moe": _moe_weights(moe_cfg, seed=52)}
    for k, w in weights.items():
        np.savez(os.path.join(work, f"{k}.npz"), **w)
    rs = np.random.RandomState(53)
    data = {}
    for k, (vv, tt) in {"bert": (vocab, T), "lc": (LC_VOCAB, PP_LC_RANK_T),
                        "moe": (moe_cfg["vocab_size"], MOE_T)}.items():
        for part in ("x", "y"):
            data[f"{k}_{part}"] = rs.randint(0, vv, size=(PP_SCHED_RANK_B, tt)).astype(np.int32)
    for part in ("x", "y"):
        data[f"mem_{part}"] = rs.randint(0, vocab, size=(2 * PP_M * PP_MEM_MICRO, T)).astype(
            np.int32)
    np.savez(os.path.join(work, "data.npz"), **data)
    ctx = mx.gpu(0) if device == "gpu" else mx.cpu()
    if device == "gpu":
        torch.backends.cuda.matmul.allow_tf32 = False
    one = mx.parallel.Mesh([ctx], ("pp",), (1,))

    def reference(name, make, xk):
        net, tr = make()
        x, y = (mx.nd.array(data[f"{xk}_{k}"], ctx=ctx, dtype="int32") for k in ("x", "y"))
        losses = [float(tr.step(x, y)) for _ in range(PP_SCHED_RANK_STEPS)]
        tr.sync()
        w = _host_weights(net)
        del tr, net
        if device == "gpu":
            torch.cuda.empty_cache()
        return losses, w

    def bert(c, cf):
        def make():
            net = _bert_base_net(mx, weights[c], ctx, cf)
            return net, _pp_trainer(mx, net, one, PP_SCHED_RANK_M)
        return make
    refs = {"bert2": reference("bert2", bert("bert2", cfg), "bert"),
            "bert4": reference("bert4", bert("bert4", cfg4), "bert"),
            "lc": reference("lc", lambda: _lc_pipeline(mx, weights["lc"], ctx, one,
                                                       PP_SCHED_RANK_M, PP_LC_RANK_T,
                                                       cfg=lc_cfg), "lc"),
            "moe": reference("moe", lambda: _moe_pipeline(mx, weights["moe"], ctx, one,
                                                          PP_SCHED_RANK_M, moe_cfg), "moe")}
    t0 = time.perf_counter()
    ranks = _dist_util.launch_local(
        "chip_smoke:rank_pp_sched", n, {"workdir": work, "device": device,
                                        "steps": PP_SCHED_RANK_STEPS, "cfg": cfg, "cfg4": cfg4,
                                        "lc_cfg": lc_cfg, "lc_T": PP_LC_RANK_T,
                                        "moe_cfg": moe_cfg},
        device=device, timeout=timeout, pythonpath=[ROOT], workdir=os.path.join(work, "launch"))
    seconds = time.perf_counter() - t0
    cases = {"gpipe_pp2": "bert2", "gpipe_pp2_dp2": "bert2", "v2_pp2": "bert4",
             "lc_tp2": "lc", "moe_tp2": "moe"}
    got = {k: dict(np.load(os.path.join(work, f"{k}.npz"))) for k in cases}
    shutil.rmtree(work, ignore_errors=True)
    checks, ok = {}, True
    for name, ref in cases.items():
        want_losses, want_w = refs[ref]
        rel = max(abs(a - b) / abs(b) for r in ranks for a, b in zip(r[name]["losses"],
                                                                      want_losses))
        w_abs = max(float(np.abs(got[name][k] - w).max()) for k, w in want_w.items())
        good = rel <= TOL_PP_LOSS and w_abs <= TOL_PP_W
        if name == "v2_pp2":
            good &= all(r[name]["stack_order"] == [0, 2, 1, 3] for r in ranks)
        checks[name] = {"loss_rel": rel, "weight_abs": w_abs}
        ok &= good
        log(f"[{label}] {name}: losses {[round(v, 6) for v in ranks[0][name]['losses']]} "
            f"against one rank's {[round(v, 6) for v in want_losses]}: max rel {rel:.2e} (tol "
            f"{TOL_PP_LOSS:.0e}), weights max|d| {w_abs:.2e} (tol {TOL_PP_W:.0e}); rank 0 "
            f"schedule {ranks[0][name]['stats']}, layers {ranks[0][name]['own']}, launches "
            f"{ranks[0][name]['launches']}, {ranks[0][name]['s']:.1f} s "
            f"{'ok' if good else 'FAIL'}")
    gib = 2 ** 30
    mem = {}
    for r in ranks:
        for key, m in r["memory"].items():
            if m["stage"] == 0 and "peak" in m:
                mem.setdefault(key, []).append(m)
    for key, ms in sorted(mem.items()):
        log(f"[{label}] stage 0 {key}: peak " + ", ".join(
            f"{m['peak'] / gib:.3f} GiB (static {m['static'] / gib:.3f})" for m in ms))
    log(f"[{label}] {n} ranks in {seconds:.1f} s {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{label}: a case disagrees with one rank")
    return {"seconds": seconds, "checks": checks, "memory_stage0": mem,
            "launches": {k: sum(r[c]["launches"][k] for r in ranks for c in cases)
                         for k in ranks[0]["gpipe_pp2"]["launches"]},
            "ranks": [{k: v for k, v in r.items() if k != "memory"} for r in ranks]}


# --- CUDA graphs: the compiled step and the CachedOp (mxnet_tpu_torch.engine) -----

GRAPH_TIMED = 8             # timed requests or steps a mode: p50 and p90 exist
GRAPH_CMP_STEPS = 3         # captured steps against eager: warm-up, capture, a replay
GRAPH_SCHED_STEPS = 3       # under a FactorScheduler that changes lr every step
GRAPH_SCHED = (1, 0.9)      # FactorScheduler(step, factor)
GRAPH_BUSY_REPLAYS = 3      # back-to-back replays between CUDA events: a graph's span
GRAPH_DROPOUT_CFG = dict(vocab_size=1024, num_layers=2, units=128, hidden_size=512,
                         num_heads=2, max_length=1024, dropout=0.1)


def _pct(ms):
    return {"p50": float(np.percentile(ms, 50)), "p90": float(np.percentile(ms, 90)),
            "n": len(ms)}


PROFILE_PAD = 1024           # spin kernels of 100 cycles that open a profiler session
PROFILE_SESSIONS = 3
PROFILE_ROUNDS = 4           # rounds of PROFILE_SESSIONS before a trace is given up
MEASURED = "chip_smoke.measured"


def _trace_once(torch, fn):
    """One profiler session of ``fn()`` (see ``_api_launches``). A session
    that lost its padding or ``fn``'s range, or kept no device record after
    the padding, has ``device_ops`` 0 and says what it lost."""
    from torch.profiler import ProfilerActivity, profile, record_function
    cuda = torch.autograd.DeviceType.CUDA
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(PROFILE_PAD):
            torch.cuda._sleep(100)
        torch.cuda.synchronize()
        with record_function(MEASURED):
            fn()
            torch.cuda.synchronize()
    events = prof.events()
    window = next((e.time_range for e in events
                   if e.name == MEASURED and e.device_type != cuda), None)
    pads = [e.time_range.end for e in events if e.device_type == cuda and "spin_kernel" in e.name]
    if window is None or not pads:
        return {"device_ops": 0, "pads_kept": len(pads),
                "lost": "fn's range" if window is None else "the whole padding"}
    api, spans = {}, []
    for e in events:
        if e.device_type == cuda:
            if e.name != MEASURED and "spin_kernel" not in e.name \
                    and e.time_range.start >= max(pads) and e.time_range.end > e.time_range.start:
                spans.append((e.time_range.start, e.time_range.end))
        elif window.start <= e.time_range.start <= window.end and e.name.startswith(
                ("cudaLaunch", "cuLaunch", "cudaGraphLaunch", "cuGraphLaunch", "cudaMemcpy",
                 "cuMemcpy")):
            api[e.name] = api.get(e.name, 0) + 1
    busy_us, end_us = 0.0, float("-inf")
    for a, b in sorted(spans):
        busy_us += max(0.0, b - max(a, end_us))
        end_us = max(end_us, b)
    launches = sum(n for k, n in api.items() if "Launch" in k)
    return {"api": api, "host_launches": launches if api else None, "pads_kept": len(pads),
            "lost": None if spans else "every device record after the padding",
            "device_ops": len(spans), "device_busy_ms": busy_us / 1e3 if spans else None,
            "device_span_ms": (end_us - min(spans)[0]) / 1e3 if spans else None}


def _api_launches(torch, fn):
    """``fn()`` under torch.profiler, PROFILE_SESSIONS sessions: the
    launches the host issued in its range, by API name (kernel and graph
    launches, copies), and from the device records after a session's
    padding the operations, the busy time (the union of their intervals) and
    the span from the first one's start to the last one's end. On the H100
    host a session loses its first N device records, N growing with the
    process's age, and now and then records in its middle or a stretched
    time (in 150 sessions of one 200-kernel call: 27 records lost at a
    session's start, 35 in its middle, a 34.7 ms replay read as 40.2 ms).
    N counts records, not time: with 64 spin kernels of 100,000 cycles, and
    again of 400,000 after a 50 ms wait on the host, the sessions of two
    full runs of this script kept 49-51 of them at 260-300 s, 38-40 at
    430-470 s, 24-25 at 640-670 s and 7 at 960 s (a call's first session
    often all 64); with 64 of 100 cycles every session of the last step
    lost them all and the step failed. So each session opens with
    PROFILE_PAD spin kernels, left out; the sessions that kept the most
    operations are kept, and of those the one with the median busy time is
    returned, with every session's operations, busy time and spin kernels
    kept. A round in which no session kept a device record after its padding
    is logged and run again, up to PROFILE_ROUNDS rounds."""
    runs = []
    for _ in range(PROFILE_ROUNDS):
        round_ = [_trace_once(torch, fn) for _ in range(PROFILE_SESSIONS)]
        runs += round_
        if any(r["device_ops"] for r in round_):
            break
        log(f"[profile] {PROFILE_SESSIONS} sessions kept no device record: lost "
            f"{[r['lost'] for r in round_]}, spin kernels kept "
            f"{[r['pads_kept'] for r in round_]} of {PROFILE_PAD}")
    kept = [r for r in runs if r["device_ops"]]
    if not kept:
        raise AssertionError(f"{len(runs)} profiler sessions kept no device record")
    full = max(r["device_ops"] for r in kept)
    best = sorted((r for r in kept if r["device_ops"] == full),
                  key=lambda r: r["device_busy_ms"])
    return dict(best[len(best) // 2], sessions={
        "device_ops": [r["device_ops"] for r in runs],
        "busy_ms": [r.get("device_busy_ms") for r in runs],
        "pads_kept": [r["pads_kept"] for r in runs]})


def _rel_diff(torch, a, b):
    """max |a - b| over max |b|, 0.0 when bitwise equal."""
    if torch.equal(a, b):
        return 0.0
    return float((a.float() - b.float()).abs().max() / b.float().abs().max().clamp_min(1e-30))


def _serve_modes(torch, mx, label, net, inputs, k1_per_request, tol):
    """The requests of ``inputs`` ({batch: NDArray on the card}) eagerly,
    then with ``net`` hybridized (the first call of a batch captures, the
    others replay): logits replayed against eager, latency p50/p90 over
    GRAPH_TIMED requests each, K1 launches a request (the counter under
    replay), launches the host issued a request, capture seconds and pool
    bytes."""
    from mxnet_tpu_torch import engine
    from mxnet_tpu_torch.ops.cuda import flash_attention as fa

    def timed(x):
        ms, out = [], None
        for _ in range(GRAPH_TIMED):
            del out
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = net(x)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        return out, ms

    rows, eager = {}, {}
    k1_start = fa.flash_attention_fwd.launches
    with torch.no_grad():
        for b, x in inputs.items():
            net(x)
            out, ms = timed(x)
            eager[b] = out._data
            rows[b] = {"eager_ms": _pct(ms), "eager_launches": _api_launches(torch, lambda: net(x))}
        net.hybridize(static_alloc=True, static_shape=True)
        engine.reset_stats()
        for b, x in inputs.items():
            first = net(x)._data
            before = fa.flash_attention_fwd.launches
            out, ms = timed(x)
            k1 = (fa.flash_attention_fwd.launches - before) / GRAPH_TIMED
            entry = next(e for sig, e in net._cached_graphs.items()
                         if sig[0][0][0] == tuple(x.shape))
            diff = max(_rel_diff(torch, first, eager[b]), _rel_diff(torch, out._data, eager[b]))
            r = rows[b]
            r.update(graph_ms=_pct(ms), k1_per_request=k1, max_rel_diff=diff,
                     graph_launches=_api_launches(torch, lambda: net(x)),
                     capture_s=entry.graph.capture_seconds, pool_bytes=entry.graph.pool_bytes,
                     fresh=out._data.data_ptr() != entry.graph.outputs[0].data_ptr())
            log(f"[graph-serve] {label} batch {b}: eager p50 {r['eager_ms']['p50']:.3f} / p90 "
                f"{r['eager_ms']['p90']:.3f} ms, replayed p50 {r['graph_ms']['p50']:.3f} / p90 "
                f"{r['graph_ms']['p90']:.3f} ms; logits max rel diff {diff:.3e} (tol {tol:.0e}); "
                f"K1 {k1:g} a request; host launches {r['eager_launches']['host_launches']} -> "
                f"{r['graph_launches']['host_launches']} ({r['graph_launches']['api']}); capture "
                f"{entry.graph.capture_seconds:.3f} s, pool {entry.graph.pool_bytes / 2**20:.1f} MiB")
            if diff > tol or k1 != k1_per_request or not r["fresh"]:
                raise AssertionError(f"graph-serve {label} batch {b}: diff {diff}, K1 {k1} "
                                     f"(want {k1_per_request}), fresh {r['fresh']}")
            del first, out
        stats = engine.cache_stats()
        if stats["captures"] != len(inputs):
            raise AssertionError(f"graph-serve {label}: {stats['captures']} captures for "
                                 f"{len(inputs)} signatures")
    del eager
    return {"batches": {str(b): r for b, r in rows.items()}, "engine": stats,
            "k1_launches": fa.flash_attention_fwd.launches - k1_start}


def _weights_of(net):
    return {k: p._param.detach().clone() for k, p in net._collect_params_with_prefix().items()}


def _weights_diff(torch, got, want):
    return max(_rel_diff(torch, got[k], w) for k, w in want.items())


@contextlib.contextmanager
def _deterministic(torch, on):
    """``torch.use_deterministic_algorithms`` (warnings only, for cuBLAS's
    workspace setting) inside the block when ``on``: cuDNN's deterministic
    weight gradients, ``index_add_`` by a sort."""
    if not on:
        yield
        return
    prev = (torch.are_deterministic_algorithms_enabled(),
            torch.is_deterministic_algorithms_warn_only_enabled())
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(prev[0], warn_only=prev[1])


def _as_mode(trainer, captured):
    """``trainer`` as built (its step captured on the card), or with its body
    run eagerly every step: the same trainer's eager yardstick."""
    if not captured:
        trainer._graph_reason = "eager yardstick"
    return trainer


def _train_compare(torch, make, x, y, steps, sched, atomic):
    """``steps`` steps of an eager and a captured trainer from the same
    weights (``sched``: under a FactorScheduler that changes lr every step):
    the largest relative differences of the losses and the weights, and the
    captures of the captured run."""
    from mxnet_tpu_torch import engine
    from mxnet_tpu_torch.lr_scheduler import FactorScheduler
    runs = {}
    with _deterministic(torch, atomic):
        for captured in (False, True):
            trainer = _as_mode(make(), captured)
            if sched:
                sch = FactorScheduler(*GRAPH_SCHED)
                sch.base_lr = trainer.optimizer.lr
                trainer.optimizer.lr_scheduler = sch
            engine.reset_stats()
            losses = [float(trainer.step(x, y)) for _ in range(steps)]
            runs[captured] = (losses, _weights_of(trainer.net), engine.cache_stats()["captures"],
                              float(trainer.optimizer.learning_rate))
            del trainer
    (le, we, _, _), (lc, wc, captures, lr) = runs[False], runs[True]
    return {"loss_rel": max(abs(a - b) / abs(b) for a, b in zip(lc, le)),
            "weight_rel": _weights_diff(torch, wc, we), "captures": captures,
            "final_lr": lr, "losses": lc}


def _train_modes(torch, mx, label, make, x, y, per_step, atomic=False):
    """One training path eagerly and captured (``make()`` -> a trainer on
    the path's net, its weights reset to the path's seeded ones; the eager
    mode is the same trainer with ``_as_mode``): GRAPH_CMP_STEPS steps
    compared, losses and every weight bitwise (under
    ``torch.use_deterministic_algorithms`` where ``atomic``: ResNet-50's cuDNN
    weight gradients, the long-context model's embedding gradient (131,072
    tokens into 512 rows) and MoE's ``index_add_`` otherwise add with atomics,
    in an order that changes from run to run, eager against eager too; the
    timed runs below use the default, faster kernels, so for these paths the
    timed graphs are not the ones compared); then each mode timed over
    GRAPH_TIMED steps after two (p50/p90), the launch counters over those
    steps (steps x ``per_step``), one capture and steps - 1 replays, peak
    memory, and one more step under torch.profiler: the launches the host
    issued, the device's busy time (the union of the trace's device
    intervals) and each mode's idle share, 1 - busy / p50, as measured
    (negative where the profiled step's busy time exceeds the p50 of the
    unprofiled ones); in the captured mode also the span of
    GRAPH_BUSY_REPLAYS back-to-back replays by CUDA events
    (``graph_span_ms``, which counts gaps inside the graph as busy). Before
    that, GRAPH_SCHED_STEPS steps under a FactorScheduler that changes lr
    every step, captured against eager, bitwise, with one capture."""
    from mxnet_tpu_torch import engine
    counters = {**_fused_counters(), **_flash_counters()}
    n = 2 + GRAPH_TIMED
    cmp = {"steps": _train_compare(torch, make, x, y, GRAPH_CMP_STEPS, False, atomic),
           "scheduled": _train_compare(torch, make, x, y, GRAPH_SCHED_STEPS, True, atomic)}
    res = {}
    for mode in ("eager", "captured"):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        trainer = _as_mode(make(), mode == "captured")
        if trainer.captured != (mode == "captured"):
            raise AssertionError(f"graph-train {label}: {mode} trainer captured="
                                 f"{trainer.captured} ({trainer._graph_reason})")
        _zero_counters(counters)
        engine.reset_stats()
        ms = []
        for i in range(n):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            pending = trainer.step(x, y)
            torch.cuda.synchronize()
            if i >= 2:
                ms.append((time.perf_counter() - t0) * 1e3)
            if not np.isfinite(float(pending)):
                raise AssertionError(f"graph-train {label} {mode}: loss not finite")
        launches = {k: c.launches for k, c in counters.items() if c.launches}
        stats = engine.cache_stats()
        peak = torch.cuda.max_memory_allocated()
        api = _api_launches(torch, lambda: trainer.step(x, y))
        r = {"step_ms": _pct(ms), "launches": launches, "per_step": per_step,
             "engine": stats, "peak_bytes": peak, "host_launches": api["host_launches"],
             "api": api["api"], "device_ops": api["device_ops"],
             "busy_ms": api["device_busy_ms"], "device_span_ms": api["device_span_ms"],
             "sessions": api["sessions"]}
        r["idle_share"] = (1.0 - r["busy_ms"] / r["step_ms"]["p50"]
                           if r["busy_ms"] is not None else None)
        want = {k: v * n for k, v in per_step.items() if v}
        if launches != want:
            raise AssertionError(f"graph-train {label} {mode}: launches {launches} over {n} "
                                 f"steps, want {want}")
        if r["busy_ms"] is None:
            raise AssertionError(f"graph-train {label} {mode}: the profiler recorded no "
                                 f"device operation")
        if mode == "captured":
            if (stats["captures"], stats["replays"]) != (1, n - 1):
                raise AssertionError(f"graph-train {label}: captures {stats['captures']}, "
                                     f"replays {stats['replays']} over {n} steps")
            entry = next(iter(trainer._graphs.values())).graph
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(GRAPH_BUSY_REPLAYS):
                entry.graph.replay()
            end.record()
            torch.cuda.synchronize()
            r.update(graph_span_ms=start.elapsed_time(end) / GRAPH_BUSY_REPLAYS,
                     capture_s=entry.capture_seconds, pool_bytes=entry.pool_bytes)
            # the same graph's device span in the trace and by CUDA events:
            # near 1 where the trace kept every record of the step
            r["trace_span_vs_events"] = r["device_span_ms"] / r["graph_span_ms"]
        res[mode] = r
        del trainer
    e, c = res["eager"], res["captured"]
    log(f"[graph-train] {label}: step eager p50 {e['step_ms']['p50']:.3f} / p90 "
        f"{e['step_ms']['p90']:.3f} ms, captured p50 {c['step_ms']['p50']:.3f} / p90 "
        f"{c['step_ms']['p90']:.3f} ms; profiled busy {e['busy_ms']:.3f} / {c['busy_ms']:.3f} "
        f"ms (device span {e['device_span_ms']:.3f} / {c['device_span_ms']:.3f} ms), idle "
        f"{e['idle_share']:.2%} / {c['idle_share']:.2%}; a replay's span by CUDA events "
        f"{c['graph_span_ms']:.3f} ms (the trace's / the events' "
        f"{c['trace_span_vs_events']:.4f}); device operations {e['device_ops']} / "
        f"{c['device_ops']}; host launches a step {e['host_launches']} -> "
        f"{c['host_launches']} ({c['api']}); peak {e['peak_bytes'] / 2**30:.3f} / "
        f"{c['peak_bytes'] / 2**30:.3f} GiB; capture {c['capture_s']:.3f} s, pool "
        f"{c['pool_bytes'] / 2**20:.1f} MiB; launches {c['launches']} over {n} steps; "
        f"captured against eager{' (deterministic algorithms)' if atomic else ''}: "
        f"{GRAPH_CMP_STEPS} steps {cmp['steps']['loss_rel']:.3e} / "
        f"{cmp['steps']['weight_rel']:.3e}, {GRAPH_SCHED_STEPS} scheduled steps "
        f"{cmp['scheduled']['loss_rel']:.3e} / {cmp['scheduled']['weight_rel']:.3e} (losses / "
        f"weights, bitwise wanted), lr {cmp['scheduled']['final_lr']:.3e} at the end, "
        f"{cmp['scheduled']['captures']} capture")
    bad = [k for k, d in cmp.items() if d["loss_rel"] or d["weight_rel"] or d["captures"] != 1]
    if bad:
        raise AssertionError(f"graph-train {label}: captured disagrees with eager in {bad}: "
                             f"{cmp}")
    return {"modes": res, "compare": cmp, "deterministic_algorithms": atomic}


def phase_graph_serve(torch, bert_params, resnet_params, moe_weights):
    """``hybridize()``'s CachedOp on the card: BERT-base T=1024 (batch 1, 2,
    4, 8; K1 12 a request), ResNet-50 v1 (batch 1, 32) and the MoE LM at
    Switch-Base-8 widths (T 1024, batch 1, 8), f32 with TF32 off, eager
    against replayed."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.convert import load_jax_params
    from mxnet_tpu_torch.models import bert_base
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ctx = mx.gpu(0)
    out = {}
    rs = np.random.RandomState(40)
    net = bert_base(max_length=1024)
    net.initialize(ctx=ctx)
    load_jax_params(net, bert_params)
    out["bert"] = _serve_modes(torch, mx, "bert-base", net, {
        b: mx.nd.array(rs.randint(0, 30522, size=(b, 1024)).astype(np.int32), ctx=ctx,
                       dtype="int32") for b in (1, 2, 4, 8)}, 12, 0.0)
    del net
    net, _ = _resnet50(mx, ctx, resnet_params)
    out["resnet"] = _serve_modes(torch, mx, "resnet-50", net, {
        b: mx.nd.array(rs.uniform(-1, 1, (b, 3, 224, 224)).astype(np.float32), ctx=ctx)
        for b in (1, 32)}, 0, 0.0)
    del net
    net = _moe_net(mx, moe_weights, ctx)
    out["moe"] = _serve_modes(torch, mx, "moe", net, {
        b: mx.nd.array(rs.randint(0, MOE_CFG["vocab_size"], size=(b, MOE_T)).astype(np.int32),
                       ctx=ctx, dtype="int32") for b in (1, 8)}, MOE_CFG["num_layers"], 0.0)
    del net
    torch.cuda.empty_cache()
    return out


def phase_graph_train(torch, bert_params, bert_batch, resnet_params, lc_weights, moe_weights):
    """The fused step captured on the card against the same step eager: BERT-
    base T=1024 batch 8 Adam (f32 with TF32 off, bf16), ResNet-50 batch 32 SGD
    momentum (f32, bf16), and on a world-1 NCCL group the NCCL BERT step,
    LongContextTrainer at T=32768 batch 4 and MoETrainer at Switch-Base-8
    widths, T 1024 batch 8 (f32); a snapshot saved under the captured BERT
    step resumed bitwise; a 2-layer BERT with dropout 0.1 captured against
    eager after the same seed."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.convert import load_jax_params
    from mxnet_tpu_torch.models import BertModel, bert_base
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ctx = mx.gpu(0)
    n_layers = 12
    out = {}
    bert_step = dict({k: 0 for k in {**_fused_counters(), **_flash_counters()}},
                     fused_adam_update=1, flash_attention_fwd=n_layers,
                     flash_attention_bwd_dq=n_layers, flash_attention_bwd_dkv=n_layers)
    x, y = (mx.nd.array(a, ctx=ctx, dtype="int32") for a in bert_batch)
    net = bert_base(max_length=1024)
    net.initialize(ctx=ctx)
    for dtype in ("float32", "bfloat16"):
        def make(dtype=dtype):
            load_jax_params(net, bert_params)
            return mx.parallel.DataParallelTrainer(
                net, mx.gluon.loss.SoftmaxCrossEntropyLoss(), "adam", {"learning_rate": 1e-4},
                mesh=mx.parallel.make_mesh({"dp": 1}, devices=[ctx]),
                dtype=None if dtype == "float32" else dtype)
        out[f"bert_{dtype}"] = _train_modes(torch, mx, f"bert-base {dtype}", make, x, y,
                                            bert_step)
    out["snapshot"] = _graph_snapshot(torch, mx, net, bert_params, x, y)
    del net
    rs = np.random.RandomState(41)
    rx = mx.nd.array(rs.uniform(-1, 1, (32, 3, 224, 224)).astype(np.float32), ctx=ctx)
    ry = mx.nd.array(rs.randint(0, 1000, (32,)).astype(np.int32), ctx=ctx, dtype="int32")
    params0 = _zero_last_gamma(resnet_params)
    rnet, _ = _resnet50(mx, ctx, params0)
    sgd_step = dict({k: 0 for k in bert_step}, fused_sgd_mom_update=1)
    for dtype in ("float32", "bfloat16"):
        def make(dtype=dtype):
            load_jax_params(rnet, params0)
            return mx.parallel.DataParallelTrainer(
                rnet, mx.gluon.loss.SoftmaxCrossEntropyLoss(), "sgd",
                {"learning_rate": 0.05, "momentum": 0.9, "wd": 1e-4},
                dtype=None if dtype == "float32" else dtype,
                mesh=mx.parallel.make_mesh({"dp": 1}, devices=[ctx]))
        out[f"resnet_{dtype}"] = _train_modes(torch, mx, f"resnet-50 {dtype}", make, rx, ry,
                                              sgd_step, atomic=True)
    del rnet
    out["dropout"] = _graph_dropout(torch, mx)
    torch.cuda.empty_cache()
    with _world1_nccl(torch):
        mesh = mx.parallel.make_mesh({"dp": 1, "tp": 1, "sp": 1}, devices=[ctx])
        net = bert_base(max_length=1024)
        net.initialize(ctx=ctx)

        def make():
            load_jax_params(net, bert_params)
            return mx.parallel.DataParallelTrainer(
                net, mx.gluon.loss.SoftmaxCrossEntropyLoss(), "adam", {"learning_rate": 1e-4},
                mesh=mesh, data_spec=mx.parallel.P("dp", "sp"))
        out["nccl_bert"] = _train_modes(torch, mx, "bert-base nccl world 1", make, x, y,
                                        bert_step)
        del net
        torch.cuda.empty_cache()
        lc_mesh = mx.parallel.make_mesh({"dp": 1, "sp": 1}, devices=[ctx])
        lnet, _ = _lc_trainer(mx, lc_weights, ctx, lc_mesh, LC_T)
        lx, ly = (mx.nd.array(a, ctx=ctx, dtype="int32") for a in _lc_batch(LC_B, LC_T, 42))
        lc_step = dict({k: 0 for k in bert_step}, fused_adam_update=1,
                       **{k: LC_CFG["num_layers"] for k in _flash_counters()})

        def make():
            from mxnet_tpu_torch.recipes import get_recipe
            load_jax_params(lnet, {k: v[:LC_T] if k == "pos_embed.weight" else v
                                   for k, v in lc_weights.items()})
            return get_recipe("long_context").build_trainer(lnet, lc_mesh,
                                                            learning_rate=LC_LR)
        out["long_context"] = _train_modes(torch, mx, f"long-context T={LC_T}", make, lx, ly,
                                           lc_step, atomic=True)
        del lnet
        torch.cuda.empty_cache()
        moe_mesh = mx.parallel.make_mesh({"dp": 1, "ep": 1}, devices=[ctx])
        mnet = _moe_net(mx, moe_weights, ctx)
        mx_, my_ = (mx.nd.array(a, ctx=ctx, dtype="int32") for a in _moe_batch(MOE_B, MOE_T, 43))
        moe_step = dict(bert_step, **{k: MOE_CFG["num_layers"] for k in _flash_counters()})

        def make():
            from mxnet_tpu_torch.recipes import get_recipe
            load_jax_params(mnet, moe_weights)
            return get_recipe("moe").build_trainer(mnet, moe_mesh, learning_rate=MOE_LR)
        out["moe"] = _train_modes(torch, mx, "moe switch-base-8", make, mx_, my_, moe_step,
                                  atomic=True)
        del mnet
        torch.cuda.empty_cache()
    return out


def _graph_snapshot(torch, mx, net, bert_params, x, y):
    """A snapshot saved under the captured BERT-base f32 step (after step 3),
    two more steps; a rebuilt trainer resumes from it and its two steps (a
    warm-up and a capture) equal the run's bitwise; the snapshot installed
    again, in place, into that trainer: its graph stays (no capture) and the
    two replays equal the run's bitwise."""
    from mxnet_tpu_torch import elastic, engine
    from mxnet_tpu_torch.convert import load_jax_params
    work = os.path.join(ROOT, "build", "graph_snapshot")
    shutil.rmtree(work, ignore_errors=True)
    load_jax_params(net, bert_params)
    mesh = mx.parallel.make_mesh({"dp": 1}, devices=[mx.gpu(0)])
    trainer = mx.parallel.DataParallelTrainer(
        net, mx.gluon.loss.SoftmaxCrossEntropyLoss(), "adam", {"learning_rate": 1e-4},
        mesh=mesh)
    for _ in range(3):
        trainer.step(x, y)
    mgr = elastic.SnapshotManager(work)
    elastic.save_trainer(mgr, trainer, wait=True)
    mgr.close()
    after = [float(trainer.step(x, y)) for _ in range(2)]
    w_after = _weights_of(net)
    del trainer

    def rebuild():
        from mxnet_tpu_torch.models import bert_base
        n2 = bert_base(max_length=1024)
        n2.initialize(ctx=mx.gpu(0))
        return mx.parallel.DataParallelTrainer(
            n2, mx.gluon.loss.SoftmaxCrossEntropyLoss(), "adam", {"learning_rate": 1e-4},
            mesh=mesh)
    _, tr2, start, outcome = elastic.resume_or_init(work, rebuild)
    got = [float(tr2.step(x, y)) for _ in range(2)]
    w_diff = _weights_diff(torch, _weights_of(tr2.net), w_after)
    # the same snapshot installed in place into the trainer whose step is
    # captured now: its graph stays, the steps replay
    engine.reset_stats()
    _, tr3, start3, _ = elastic.resume_or_init(work, lambda: tr2)
    again = [float(tr3.step(x, y)) for _ in range(2)]
    stats = engine.cache_stats()
    w_diff3 = _weights_diff(torch, _weights_of(tr3.net), w_after)
    ok = ((start, outcome) == (3, "resumed") and got == after and w_diff == 0.0
          and tr2.captured and tr3 is tr2 and start3 == 3 and again == after
          and w_diff3 == 0.0 and (stats["captures"], stats["replays"]) == (0, 2))
    log(f"[graph-train] snapshot after captured step 3 -> resume_or_init ({start}, "
        f"{outcome!r}); steps 4-5 {got} against the run's {after}, weights max rel diff "
        f"{w_diff:.3e}; installed again in place into the captured trainer: steps 4-5 "
        f"{again}, weights {w_diff3:.3e}, captures {stats['captures']}, replays "
        f"{stats['replays']} {'ok' if ok else 'FAIL'}")
    del tr2, tr3
    shutil.rmtree(work, ignore_errors=True)
    if not ok:
        raise AssertionError("a snapshot of the captured step did not resume bitwise")
    return {"step": start, "outcome": outcome, "losses": got, "weight_rel": w_diff,
            "in_place": {"losses": again, "weight_rel": w_diff3, "engine": stats}}


def _graph_dropout(torch, mx):
    """A 2-layer BERT (units 128) with dropout 0.1 at T=1024 batch 4: 3
    captured steps against 3 eager ones after the same ``mx.random.seed``."""
    from mxnet_tpu_torch.convert import load_jax_params, seeded_params
    from mxnet_tpu_torch.models import BertModel
    rs = np.random.RandomState(44)
    x, y = (mx.nd.array(rs.randint(0, 1024, size=(4, 1024)).astype(np.int32), ctx=mx.gpu(0),
                        dtype="int32") for _ in range(2))
    weights = seeded_params(BertModel(**GRAPH_DROPOUT_CFG), seed=45)
    runs = {}
    for captured in (False, True):
        mx.random.seed(46)
        net = BertModel(**GRAPH_DROPOUT_CFG)
        net.initialize(ctx=mx.gpu(0))
        load_jax_params(net, weights)
        tr = _as_mode(mx.parallel.DataParallelTrainer(
            net, mx.gluon.loss.SoftmaxCrossEntropyLoss(), "adam", {"learning_rate": 1e-3},
            mesh=mx.parallel.make_mesh({"dp": 1}, devices=[mx.gpu(0)])), captured)
        runs[captured] = ([float(tr.step(x, y)) for _ in range(3)], _weights_of(net))
        del tr, net
    w_diff = _weights_diff(torch, runs[True][1], runs[False][1])
    ok = runs[True][0] == runs[False][0] and w_diff == 0.0
    log(f"[graph-train] dropout 0.1, 3 steps after mx.random.seed(46): captured "
        f"{runs[True][0]} against eager {runs[False][0]}, weights max rel diff {w_diff:.3e} "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the captured dropout steps differ from the eager ones")
    return {"captured": runs[True][0], "eager": runs[False][0], "weight_rel": w_diff}


# --- the rest of A2: overlapped buckets, 2-bit compression, the coordinator, dist_async ---

OVERLAP_SEGMENTS = 4
OVERLAP_CHECKED = 5          # steps held against the plain step: warm-up, capture, 3 replays
OVERLAP_TIMED = 10           # timed steps after them: p50 and p90
TOL_OVERLAP_LOSS = 1e-6      # overlapped losses against the plain step's, relative
TOL_OVERLAP_W = 1e-6         # weights after OVERLAP_CHECKED steps, of each tensor's max


def _stream_trace(torch, fn):
    """One profiler session of ``fn()``, opened by PROFILE_PAD spin kernels
    (left out): every device kernel after them as (start us, end us, stream,
    name), in start order. The stream is the trace's resource id."""
    from torch.profiler import ProfilerActivity, profile, record_function
    cuda = torch.autograd.DeviceType.CUDA
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(PROFILE_PAD):
            torch.cuda._sleep(100)
        torch.cuda.synchronize()
        with record_function(MEASURED):
            fn()
            torch.cuda.synchronize()
    events = [e for e in prof.events() if e.device_type == cuda and e.name != MEASURED]
    pads = [e.time_range.end for e in events if "spin_kernel" in e.name]
    start = max(pads) if pads else float("-inf")
    return sorted((e.time_range.start, e.time_range.end, getattr(e, "device_resource_id", None),
                   e.name) for e in events
                  if "spin_kernel" not in e.name and e.time_range.start >= start)


def _overlap_interleaving(kernels):
    """From ``_stream_trace``'s kernels of one overlapped step: the compute
    stream (the one running K2/K3), the backward's last kernel (the last one
    on it before K5's ``multi_tensor_update``), and the kernels on other
    streams (the buckets' copies and collectives) before K5, with how many of
    them start before that last backward kernel and before the last K2/K3
    launch; both counts must be positive."""
    bwd = [k for k in kernels if "flash_bwd" in k[3]]
    adam = [k for k in kernels if "multi_tensor_update" in k[3]]     # K4/K5's kernel
    if not bwd or not adam:
        return {"ok": False, "why": f"{len(bwd)} K2/K3 and {len(adam)} K5 records kept"}
    compute = bwd[0][2]
    t_update = adam[0][0]
    mine = [k for k in kernels if k[2] == compute and k[0] < t_update]
    last_bwd = mine[-1]
    side = [k for k in kernels if k[2] != compute and k[0] < t_update]
    early = [k for k in side if k[0] < last_bwd[0]]
    before_last_flash = [k for k in side if k[0] < bwd[-1][0]]
    return {"ok": bool(early) and bool(before_last_flash), "compute_stream": compute,
            "side_before_last_flash_bwd": len(before_last_flash),
            "last_flash_bwd_start_us": bwd[-1][0] - kernels[0][0],
            "side_streams": sorted({k[2] for k in side}, key=str),
            "side_kernels": len(side), "side_before_last_bwd": len(early),
            "first_side_start_us": side[0][0] - kernels[0][0] if side else None,
            "last_bwd_start_us": last_bwd[0] - kernels[0][0],
            "k5_start_us": t_update - kernels[0][0], "last_bwd_kernel": last_bwd[3][:80],
            "side_names": sorted({k[3][:60] for k in side}),
            "first_bwd_start_us": bwd[0][0] - kernels[0][0]}


def phase_overlap_bert(torch, params, batch):
    """The overlapped reduction on the card, on the caller's world-1 NCCL
    group: BERT-base T=1024, batch 8, f32 (TF32 off), Adam lr 1e-4, through
    ``DataParallelTrainer(overlap_grads=True, overlap_segments=4)`` against
    the plain fused step from the same weights: OVERLAP_CHECKED losses and
    the weights after them (TOL_OVERLAP_LOSS / TOL_OVERLAP_W; no leaf spans
    two segments, so bitwise is expected), K1-K3 12 and K5 1 a step, the
    overlapped step captured (one capture) and its replays bitwise its eager
    steps; p50/p90 of OVERLAP_TIMED steps and the idle share of both steps;
    a padded trace of an eager overlapped step, in which the buckets' work on
    the side stream starts before the backward's last kernel."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import engine
    from mxnet_tpu_torch.convert import load_jax_params
    from mxnet_tpu_torch.models import bert_base
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    tokens, labels = batch
    B, T = tokens.shape
    n_layers = 12
    ctx = mx.gpu(0)
    mesh = mx.parallel.make_mesh({"dp": 1}, devices=[ctx])
    x = mx.nd.array(tokens, ctx=ctx, dtype="int32")
    y = mx.nd.array(labels, ctx=ctx, dtype="int32")
    net = bert_base(max_length=T)
    net.initialize(ctx=ctx)

    def make(overlap):
        load_jax_params(net, params)
        return mx.parallel.DataParallelTrainer(
            net, mx.gluon.loss.SoftmaxCrossEntropyLoss(), "adam", {"learning_rate": 1e-4},
            mesh=mesh, overlap_grads=overlap,
            overlap_segments=OVERLAP_SEGMENTS if overlap else None)

    counters = dict(_fused_counters(), **_flash_counters())
    per_step = dict({k: 0 for k in counters}, fused_adam_update=1,
                    **{k: n_layers for k in _flash_counters()})
    out = {}
    for mode in ("plain", "overlap"):
        trainer = make(mode == "overlap")
        engine.reset_stats()
        steps = _dp_steps(torch, f"overlap-bert {mode}", trainer, x, y, OVERLAP_CHECKED,
                          per_step, (B * T, "tokens_per_s"), counters)
        r = {"losses": [st["loss"] for st in steps], "weights": _weights_of(net),
             "captured": trainer.captured, "engine": engine.cache_stats()}
        if mode == "overlap":
            plan = trainer._overlap_plan
            spans = sorted({i for s in plan.segments for i in s.uses} -
                           {i for s in plan.segments for i in s.owned})
            r["plan"] = {"segments": [list(s.names) for s in plan.segments],
                         "owned": [len(s.owned) for s in plan.segments],
                         "buckets": {str(k): v for k, v in trainer._seg_buckets.items()},
                         "leaves_spanning_segments": [trainer._plist[i].name for i in spans]}
        ms = _timed_steps(torch, trainer, x, y, OVERLAP_TIMED)
        api = _api_launches(torch, lambda: trainer.step(x, y))
        r.update(step_ms=_pct(ms), busy_ms=api["device_busy_ms"],
                 host_launches=api["host_launches"], sessions=api["sessions"])
        r["idle_share"] = 1.0 - r["busy_ms"] / r["step_ms"]["p50"]
        out[mode] = r
        del trainer
        torch.cuda.empty_cache()
    p, o = out["plain"], out["overlap"]
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(o["losses"], p["losses"]))
    w_rel = _weights_diff(torch, o["weights"], p["weights"])
    cmp = _train_compare(torch, lambda: make(True), x, y, OVERLAP_CHECKED, False, False)
    eager = _as_mode(make(True), False)
    eager.step(x, y)
    torch.cuda.synchronize()
    trace = _overlap_interleaving(_stream_trace(torch, lambda: eager.step(x, y)))
    del eager
    torch.cuda.empty_cache()
    for mode in ("plain", "overlap"):
        del out[mode]["weights"]
    good = (loss_rel <= TOL_OVERLAP_LOSS and w_rel <= TOL_OVERLAP_W and o["captured"]
            and o["engine"]["captures"] == 1 and cmp["loss_rel"] == 0.0
            and cmp["weight_rel"] == 0.0 and cmp["captures"] == 1 and trace["ok"]
            and len(o["plan"]["segments"]) == OVERLAP_SEGMENTS)
    log(f"[overlap-bert] plan {o['plan']['segments']} owning {o['plan']['owned']} "
        f"parameters, buckets by segment {o['plan']['buckets']}, leaves spanning segments "
        f"{o['plan']['leaves_spanning_segments']}; losses {[round(v, 6) for v in o['losses']]} "
        f"against the plain step's: max rel {loss_rel:.3e} (tol {TOL_OVERLAP_LOSS:.0e}), "
        f"weights {w_rel:.3e} of max (tol {TOL_OVERLAP_W:.0e}); captured replays against "
        f"eager: losses {cmp['loss_rel']:.3e}, weights {cmp['weight_rel']:.3e} (bitwise "
        f"wanted), {cmp['captures']} capture; step p50 / p90 plain {p['step_ms']['p50']:.3f} "
        f"/ {p['step_ms']['p90']:.3f} ms, overlapped {o['step_ms']['p50']:.3f} / "
        f"{o['step_ms']['p90']:.3f} ms; busy {p['busy_ms']:.3f} / {o['busy_ms']:.3f} ms, idle "
        f"{p['idle_share']:.2%} / {o['idle_share']:.2%}; trace of an eager overlapped step: "
        f"{trace} {'ok' if good else 'FAIL'}")
    if not good:
        raise AssertionError("the overlapped step disagrees with the plain one or its "
                             "buckets do not interleave with the backward")
    out.update(loss_rel=loss_rel, weight_rel=w_rel, captured_vs_eager=cmp, trace=trace,
               launches={k: OVERLAP_CHECKED * v for k, v in per_step.items() if v})
    del net
    torch.cuda.empty_cache()
    return out


OVERLAP_RANK_CONFIGS = {"overlap": (False, None), "overlap_bf16": (False, "bfloat16"),
                        "overlap_int8": (False, "int8"), "overlap_zero": (True, None),
                        "overlap_zero_bf16": (True, "bfloat16"),
                        "overlap_zero_int8": (True, "int8")}
OVERLAP_RANK_CFG = dict(vocab_size=8192, num_layers=2, units=128, hidden_size=512,
                        num_heads=2, max_length=1024)
COMP_THRESHOLD = 2.0 ** -10  # a power of two: sums of the quantized values are exact
COMP_LR = 0.5
TOL_COMP_LOSS = 1e-6         # the ranks' losses against the one-process emulation's, relative
TOL_COMP_W = 1e-6            # the ranks' weights against the emulation's on the card, of max


def rank_overlap(workdir, cfg, steps, device, lr):
    """One of 4 ranks of phase_overlap_ranks: each OVERLAP_RANK_CONFIGS
    configuration (``overlap_grads=True``, 2 segments) for ``steps`` Adam
    steps, then the 2-bit compressed step (no overlap, plain SGD); rank 0
    writes the weights after each."""
    import torch
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import _dist_util
    from mxnet_tpu_torch.convert import gather_params, load_jax_params
    from mxnet_tpu_torch.models import BertModel
    ctx = _dist_util.rank_context(device)
    if ctx.device_type == "gpu":
        torch.backends.cuda.matmul.allow_tf32 = False
    weights = dict(np.load(os.path.join(workdir, "weights.npz")))
    data = np.load(os.path.join(workdir, "data.npz"))
    mesh = mx.parallel.make_mesh({"dp": 4}, devices=[ctx])
    x = mx.nd.array(data["x"], ctx=ctx, dtype="int32")
    y = mx.nd.array(data["y"], ctx=ctx, dtype="int32")
    counters = dict(_fused_counters(), **_flash_counters())
    out = {"rank": mesh.rank}
    configs = dict(OVERLAP_RANK_CONFIGS, compressed=None)
    for name, conf in configs.items():
        net = BertModel(**cfg)
        net.initialize(ctx=ctx)
        load_jax_params(net, weights)
        if conf is None:
            trainer = mx.parallel.DataParallelTrainer(
                net, mx.gluon.loss.SoftmaxCrossEntropyLoss(), "sgd",
                {"learning_rate": COMP_LR}, mesh=mesh,
                compression={"type": "2bit", "threshold": COMP_THRESHOLD})
        else:
            trainer = mx.parallel.DataParallelTrainer(
                net, mx.gluon.loss.SoftmaxCrossEntropyLoss(), "adam", {"learning_rate": lr},
                mesh=mesh, overlap_grads=True, overlap_segments=2, zero_update=conf[0],
                comm_dtype=conf[1])
        _zero_counters(counters)
        losses = [float(trainer.step(x, y)) for _ in range(steps)]
        if mesh.rank == 0:
            np.savez(os.path.join(workdir, f"{name}.npz"), **gather_params(net))
        out[name] = {"losses": losses,
                     "launches": {k: c.launches for k, c in counters.items() if c.launches},
                     "segments": len(trainer._overlap_plan) if trainer._overlap else 0,
                     "buckets": len(trainer._zero_plan or trainer._overlap_buckets
                                    or trainer._buckets)}
        del trainer, net
        if ctx.device_type == "gpu":
            torch.cuda.empty_cache()
    return out


def _compressed_emulation(torch, mx, cfg, weights, x, y, ndp, steps, ctx):
    """The 2-bit compressed dp ``ndp`` step in one process: each of ``ndp``
    shards of the batch takes its own gradient of its mean loss, adds its own
    residual and quantizes to {-t, 0, +t}; the quantized gradients are summed
    and divided by ``ndp`` and applied by the fused step's SGD update (K4 on
    the card). Returns the losses (the shards' mean) and the weights."""
    from mxnet_tpu_torch.convert import gather_params, load_jax_params
    from mxnet_tpu_torch.models import BertModel
    from mxnet_tpu_torch.ndarray import NDArray
    from mxnet_tpu_torch.parallel.data_parallel import functional_optimizer
    net = BertModel(**cfg)
    net.initialize(ctx=ctx)
    load_jax_params(net, weights)
    dev = ctx.torch_device
    plist = [p for p in net.collect_params().values() if p._param is not None]
    opt = mx.optimizer.create("sgd", learning_rate=COMP_LR)
    init, update, hyper = functional_optimizer(opt)
    states = [init(p._param.detach()) for p in plist]
    h = torch.tensor([hyper(1, np.float32(COMP_LR), 0.0)], dtype=torch.float32, device=dev)
    resid = [[torch.zeros_like(p._param) for p in plist] for _ in range(ndp)]
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    xt = torch.as_tensor(x, device=dev)
    yt = torch.as_tensor(y, device=dev)
    rows = xt.shape[0] // ndp
    thr = float(COMP_THRESHOLD)
    losses = []
    for _ in range(steps):
        qsum = [torch.zeros_like(p._param) for p in plist]
        total = torch.zeros((), dtype=torch.float32, device=dev)
        for s in range(ndp):
            with torch.enable_grad(), mx.autograd.record(train_mode=True):
                pred = net(NDArray(xt[s * rows:(s + 1) * rows], ctx))
                local = loss_fn(pred, NDArray(yt[s * rows:(s + 1) * rows], ctx))._data.mean()
                grads = torch.autograd.grad(local, [p._param for p in plist],
                                            allow_unused=True)
            with torch.no_grad():
                total += local.detach().float() * (1.0 / ndp)
                for g, r, q in zip(grads, resid[s], qsum):
                    acc = (g if g is not None else torch.zeros_like(r)).float() + r
                    qq = torch.where(acc >= thr, thr, torch.where(acc <= -thr, -thr, 0.0))
                    r.copy_(acc - qq)
                    q.add_(qq)
        with torch.no_grad():
            gs = [q.div_(ndp) for q in qsum]
            update([p._param for p in plist], gs, states, h[0])
        losses.append(float(total))
    return losses, gather_params(net)


def phase_overlap_ranks(torch, device="gpu", cfg=None, steps=3, timeout=900):
    """4 ranks sharing the card over gloo (a correctness run) on a narrow BERT
    (OVERLAP_RANK_CFG, T=1024, global batch 8): the overlapped step
    (2 segments) x {replicated, ZeRO} x {f32, bf16, int8 wire}, Adam lr
    1e-4, ``steps`` steps, against one rank on the whole batch (f32 wire:
    losses TOL_DIST_LOSS, weights TOL_DIST_W; bf16/int8: TOL_ZERO_COMPRESSED
    and TOL_ZERO_COMPRESSED_W, as phase_zero_bert_ranks); K5 1 and K1-K3 2 a
    step on every rank; then the 2-bit compressed step (plain SGD, no
    overlap) against one process fed the same four shards with the same
    residual rule (``_compressed_emulation``) on the card (losses
    TOL_COMP_LOSS, weights TOL_COMP_W; bitwise expected) and on the CPU
    (weights within steps x lr x t / 4 of a flipped quantization, and few
    of them)."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import _dist_util
    from mxnet_tpu_torch.convert import gather_params, load_jax_params, seeded_params
    from mxnet_tpu_torch.models import BertModel
    from mxnet_tpu_torch.parallel.mesh import Mesh
    cfg = cfg or dict(OVERLAP_RANK_CFG)
    lr, n, T = 1e-4, 4, cfg["max_length"]
    work = os.path.join(ROOT, "build", "overlap_ranks")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    net = BertModel(**cfg)
    net.initialize(ctx=mx.cpu())
    weights = seeded_params(net, seed=17)
    np.savez(os.path.join(work, "weights.npz"), **weights)
    del net
    rs = np.random.RandomState(18)
    xs = rs.randint(0, cfg["vocab_size"], size=(2 * n, T)).astype(np.int32)
    ys = rs.randint(0, cfg["vocab_size"], size=(2 * n, T)).astype(np.int32)
    np.savez(os.path.join(work, "data.npz"), x=xs, y=ys)
    t0 = time.perf_counter()
    ranks = _dist_util.launch_local(
        "chip_smoke:rank_overlap", n, {"workdir": work, "cfg": cfg, "steps": steps,
                                       "device": device, "lr": lr},
        device=device, timeout=timeout, pythonpath=[ROOT], workdir=os.path.join(work, "launch"))
    seconds = time.perf_counter() - t0
    got = {name: dict(np.load(os.path.join(work, f"{name}.npz")))
           for name in list(OVERLAP_RANK_CONFIGS) + ["compressed"]}
    ctx = mx.gpu(0) if device == "gpu" else mx.cpu()
    one = BertModel(**cfg)
    one.initialize(ctx=ctx)
    load_jax_params(one, weights)
    tr = mx.parallel.DataParallelTrainer(one, mx.gluon.loss.SoftmaxCrossEntropyLoss(), "adam",
                                         {"learning_rate": lr},
                                         mesh=Mesh([ctx], ("dp",), (1,)))
    xo = mx.nd.array(xs, ctx=ctx, dtype="int32")
    yo = mx.nd.array(ys, ctx=ctx, dtype="int32")
    one_losses = [float(tr.step(xo, yo)) for _ in range(steps)]
    one_w = gather_params(one)
    del tr, one
    out = {"seconds": seconds, "cfg": cfg, "one_rank_losses": one_losses, "configs": {}}
    ok = True
    nl = cfg["num_layers"]
    for name, (zero, comm) in OVERLAP_RANK_CONFIGS.items():
        loss_tol = TOL_ZERO_COMPRESSED.get(comm, TOL_DIST_LOSS)
        loss_rel = max(abs(a - b) / abs(b) for r in ranks
                       for a, b in zip(r[name]["losses"], one_losses))
        w_abs = max(float(np.abs(got[name][k] - w).max()) for k, w in one_w.items())
        w_mean = float(sum(np.abs(got[name][k] - w).sum() for k, w in one_w.items())
                       / sum(w.size for w in one_w.values())) / (lr * steps)
        if comm:
            good = w_mean <= TOL_ZERO_COMPRESSED_W[comm]
            w_check = (f"weights mean|d| {w_mean:.2e} lr x steps (tol "
                       f"{TOL_ZERO_COMPRESSED_W[comm]:.0e}), max|d| {w_abs:.2e}")
        else:
            good = w_abs <= TOL_DIST_W
            w_check = f"weights max|d| {w_abs:.2e} (tol {TOL_DIST_W:.0e})"
        launches = [r[name]["launches"] for r in ranks]
        if device == "gpu":
            good = good and all(lc.get("fused_adam_update") == steps and all(
                lc.get(k) == nl * steps for k in _flash_counters()) for lc in launches)
        good = good and loss_rel <= loss_tol and all(r[name]["segments"] == 2 for r in ranks)
        ok = ok and good
        out["configs"][name] = {"loss_rel": loss_rel, "weight_abs": w_abs,
                                "weight_mean_lr_steps": w_mean, "launches": launches[0],
                                "buckets": ranks[0][name]["buckets"],
                                "losses": ranks[0][name]["losses"]}
        log(f"[overlap-ranks] {name}: losses {[round(v, 6) for v in ranks[0][name]['losses']]} "
            f"against one rank's {[round(v, 6) for v in one_losses]}: max rel {loss_rel:.2e} "
            f"(tol {loss_tol:.0e}), {w_check}; {ranks[0][name]['buckets']} buckets; launches "
            f"{launches[0]} {'ok' if good else 'FAIL'}")
    emu_losses, emu_w = _compressed_emulation(torch, mx, cfg, weights, xs, ys, n, steps, ctx)
    cpu_losses, cpu_w = (_compressed_emulation(torch, mx, cfg, weights, xs, ys, n, steps,
                                               mx.cpu()) if device == "gpu"
                         else (emu_losses, emu_w))
    comp = got["compressed"]
    c_loss = max(abs(a - b) / abs(b) for r in ranks
                 for a, b in zip(r["compressed"]["losses"], emu_losses))
    c_w = max(float(np.abs(comp[k] - w).max() / max(np.abs(w).max(), 1e-30))
              for k, w in emu_w.items())
    quantum = steps * COMP_LR * COMP_THRESHOLD / n
    cpu_abs = max(float(np.abs(comp[k] - w).max()) for k, w in cpu_w.items())
    cpu_far = sum(int((np.abs(comp[k] - w) > 1e-6 * max(np.abs(w).max(), 1e-30)).sum())
                  for k, w in cpu_w.items())
    cpu_n = sum(w.size for w in cpu_w.values())
    cpu_loss = max(abs(a - b) / abs(b) for a, b in zip(emu_losses, cpu_losses))
    moved = sum(int((comp[k] != w).sum()) for k, w in weights.items())
    good = (c_loss <= TOL_COMP_LOSS and c_w <= TOL_COMP_W and cpu_abs <= quantum + 1e-6
            and cpu_far <= 1e-3 * cpu_n and cpu_loss <= TOL_TRAIN_LOSS and moved > 0)
    ok = ok and good
    out["compressed"] = {"loss_rel": c_loss, "weight_rel": c_w, "cpu_weight_abs": cpu_abs,
                         "cpu_elements_beyond_1e-6": cpu_far, "elements": cpu_n,
                         "cpu_loss_rel": cpu_loss, "elements_moved": moved,
                         "losses": ranks[0]["compressed"]["losses"],
                         "launches": ranks[0]["compressed"]["launches"]}
    log(f"[overlap-ranks] compressed (2-bit, t = 2^-10, SGD lr {COMP_LR}): losses "
        f"{[round(v, 6) for v in ranks[0]['compressed']['losses']]} against one process fed "
        f"the 4 shards {[round(v, 6) for v in emu_losses]}: max rel {c_loss:.2e} (tol "
        f"{TOL_COMP_LOSS:.0e}), weights {c_w:.2e} of max (tol {TOL_COMP_W:.0e}); against the "
        f"CPU's emulation: losses {cpu_loss:.2e} (tol {TOL_TRAIN_LOSS:.0e}), weights max|d| "
        f"{cpu_abs:.2e} (tol {quantum:.2e}, one flipped quantum a step), {cpu_far} of {cpu_n} "
        f"elements beyond 1e-6 of max; {moved} elements moved; launches "
        f"{ranks[0]['compressed']['launches']} {'ok' if good else 'FAIL'}")
    log(f"[overlap-ranks] 4 ranks in {seconds:.1f} s (a correctness run: ranks sharing the "
        f"card over gloo)")
    shutil.rmtree(work, ignore_errors=True)
    if not ok:
        raise AssertionError("the overlapped or compressed ranks disagree with one rank")
    out["launches"] = {k: sum(r[c]["launches"].get(k, 0) for r in ranks
                              for c in list(OVERLAP_RANK_CONFIGS) + ["compressed"])
                       for k in {**_fused_counters(), **_flash_counters()}}
    return out


COORD_CFG = dict(vocab_size=30522, num_layers=2, units=768, hidden_size=3072, num_heads=12,
                 max_length=1024)
COORD_STEPS = 6              # the uninterrupted run's steps
COORD_KILL_AT = 3            # the victim dies at this step boundary (odd: no save there)
COORD_EVERY = 2
COORD_LEASE_MIN = 6.0        # seconds; at least 4 measured steps (a step and its save)


def coord_child(workdir, rank, world, root, device="gpu"):
    """One host of phase_coord_kill: a rank of a gloo dp ``world`` mesh on the
    card, a Coordinator under ``root`` whose lease is sized from this host's
    first two steps, ``elastic.run`` with a coordinated SnapshotManager saving
    every COORD_EVERY steps; at step COORD_KILL_AT every host waits at a gate,
    heartbeating, which the parent opens after SIGKILLing the victim and
    waiting out its lease.
    Writes ``report-<rank>.json``."""
    import torch
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import _dist_util, elastic
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    params = dict(np.load(os.path.join(workdir, "weights.npz")))
    data = np.load(os.path.join(workdir, "data.npz"))
    with open(os.path.join(workdir, "cfg.json")) as f:
        cfg = json.load(f)
    _dist_util.init_process_group(device=device, rank=rank, world_size=world,
                                  init_method=f"file://{os.path.join(workdir, 'rdzv')}")
    ctx = _dist_util.rank_context(device)
    mesh = mx.parallel.make_mesh({"dp": world}, devices=[ctx])
    coord = elastic.Coordinator(root, rank, lease_timeout=COORD_LEASE_MIN,
                                straggler_timeout=120.0, heartbeat_interval=0.0)
    coord.join()
    deadline = time.monotonic() + 120
    while len(coord.view().live) < world:
        if time.monotonic() > deadline:
            raise AssertionError("the coordinator's rendezvous timed out")
        time.sleep(0.05)
    x = mx.nd.array(data["x"], ctx=ctx, dtype="int32")
    y = mx.nd.array(data["y"], ctx=ctx, dtype="int32")
    mgr, trainer, start, outcome = elastic.resume_or_init(
        root, lambda: _bert_dp(mx, params, ctx, mesh, cfg=cfg)[1],
        save_interval_steps=COORD_EVERY, coordinator=coord)
    del params
    counters = _elastic_counters()
    _zero_counters(counters)
    losses, stamps = {}, [time.perf_counter()]

    def on_step(t, loss):
        losses[str(t)] = float(loss)
        stamps.append(time.perf_counter())
        if t == 2:
            # the lease from the measured steps (each with its save's hold)
            coord.lease_timeout = max(COORD_LEASE_MIN, 4 * max(np.diff(stamps)))
        if t == COORD_KILL_AT:
            with open(os.path.join(workdir, f"gate-{rank}"), "w") as f:
                f.write(str(coord.lease_timeout))
            while not os.path.exists(os.path.join(workdir, "go")):
                # alive while held: a host at the gate keeps its lease
                coord.heartbeat(t, force=True)
                time.sleep(0.1)

    res = elastic.run(trainer, [(x, y)] * 100, num_steps=COORD_STEPS, manager=mgr,
                      on_step=on_step, coordinator=coord)
    report = {"rank": rank, "start": start, "outcome": outcome, "step": res["step"],
              "preempted": res["preempted"], "stop": res["stop"], "losses": losses,
              "lease": coord.lease_timeout, "step_s": list(np.diff(stamps)),
              "generation": coord.generation, "straggler_aborts": coord.straggler_aborts,
              "launches": {k: c.launches for k, c in counters.items()}}
    with open(os.path.join(workdir, f"report-{rank}.json"), "w") as f:
        json.dump(report, f)
    coord.leave()
    sys.stdout.flush()
    os._exit(0)      # the group has a dead member: no collective teardown


def phase_coord_kill(torch, cfg=None, world=3, device="gpu"):
    """The coordinated kill on the card: ``world`` spawned processes, each a
    rank of a gloo dp mesh with a 2-layer BERT at base width (T=1024, one
    sequence a rank, Adam lr 1e-4), run ``elastic.run(coordinator=...)`` with
    a ``SnapshotManager(coordinator=...)`` saving every COORD_EVERY steps. At
    step boundary COORD_KILL_AT (every host held at a gate) the parent
    SIGKILLs a non-leader and waits out the lease; the survivors see the dead
    lease, post ``peer_dead``, agree on one final step S and commit it
    together (members = the survivors). A fresh world-1 run resumes from S
    and its losses for S+1..COORD_STEPS follow a world-1 run of all
    COORD_STEPS steps at TOL_RESUME; the ranks' losses up to S follow it at
    TOL_DIST_LOSS (a dp 3 mean against one)."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import elastic
    from mxnet_tpu_torch.convert import seeded_params
    from mxnet_tpu_torch.elastic import manifest
    from mxnet_tpu_torch.models import BertModel
    cfg = cfg or dict(COORD_CFG)
    work = os.path.join(ROOT, "build", "coord_kill")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    root = os.path.join(work, "snap")
    net = BertModel(**cfg)
    net.initialize(ctx=mx.cpu())
    params = seeded_params(net, seed=19)
    del net
    np.savez(os.path.join(work, "weights.npz"), **params)
    rs = np.random.RandomState(20)
    T = cfg["max_length"]
    xs = rs.randint(0, cfg["vocab_size"], size=(world, T)).astype(np.int32)
    ys = rs.randint(0, cfg["vocab_size"], size=(world, T)).astype(np.int32)
    np.savez(os.path.join(work, "data.npz"), x=xs, y=ys)
    with open(os.path.join(work, "cfg.json"), "w") as f:
        json.dump(cfg, f)
    env = dict(os.environ, OMP_NUM_THREADS=str(max(1, (os.cpu_count() or 1) // world)),
               LOCAL_RANK="0", LOCAL_WORLD_SIZE=str(world))
    procs = []
    t0 = time.perf_counter()
    for r in range(world):
        code = (f"import sys; sys.path.insert(0, {ROOT!r}); import chip_smoke as cs; "
                f"cs.coord_child({work!r}, {r}, {world}, {root!r}, {device!r})")
        out = open(os.path.join(work, f"rank{r}.log"), "w")
        procs.append(subprocess.Popen([sys.executable, "-c", code], stdout=out,
                                      stderr=subprocess.STDOUT, cwd=ROOT,
                                      env=dict(env, LOCAL_RANK=str(r))))
    victim = world - 1
    try:
        deadline = time.monotonic() + CHILD_TIMEOUT_S
        while not all(os.path.exists(os.path.join(work, f"gate-{r}")) for r in range(world)):
            for r, p in enumerate(procs):
                if p.poll() is not None:
                    _child_fail(work, f"rank{r}", f"rank {r} exited ({p.returncode}) before "
                                                  f"the gate")
            if time.monotonic() > deadline:
                _child_fail(work, "rank0", "the hosts did not reach the gate in time")
            time.sleep(0.05)
        lease = max(float(open(os.path.join(work, f"gate-{r}")).read()) for r in range(world))
        gate_s = time.perf_counter() - t0
        procs[victim].send_signal(signal.SIGKILL)
        procs[victim].wait()
        time.sleep(lease + 1.0)
        with open(os.path.join(work, "go"), "w") as f:
            f.write("go")
        for r, p in enumerate(procs[:victim]):
            try:
                rc = p.wait(timeout=CHILD_TIMEOUT_S)
            except subprocess.TimeoutExpired:
                _child_fail(work, f"rank{r}", f"survivor {r} still running after "
                                              f"{CHILD_TIMEOUT_S} s")
            if rc != 0:
                _child_fail(work, f"rank{r}", f"survivor {r} exited {rc}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    ranks_s = time.perf_counter() - t0
    reports = [json.load(open(os.path.join(work, f"report-{r}.json"))) for r in range(victim)]
    s = reports[0]["step"]
    steps = manifest.all_complete_steps(root)
    man = manifest.load(root, s) if s in steps else {"meta": {}}
    ok = (all(rep["preempted"] and rep["step"] == s and rep["stop"]["reason"] == "peer_dead"
              for rep in reports) and s == COORD_KILL_AT
          and man["meta"].get("members") == list(range(victim)))
    log(f"[coord-kill] {world} hosts, gate after {gate_s:.1f} s, lease {lease:.1f} s (from the "
        f"measured steps {[round(v, 3) for v in reports[0]['step_s']]}); rank {victim} "
        f"SIGKILLed at step {COORD_KILL_AT}; survivors stop {reports[0]['stop']}, final step "
        f"S = {[rep['step'] for rep in reports]}, snapshots {steps}, manifest at S members "
        f"{man['meta'].get('members')} generation {man['meta'].get('generation')} fence "
        f"{man.get('fence')}; {ranks_s:.1f} s {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the survivors did not commit one manifest at the agreed step")
    # the uninterrupted world-1 run and the world-1 resume from S
    ctx = mx.gpu(0) if device == "gpu" else mx.cpu()
    from mxnet_tpu_torch.parallel.mesh import Mesh
    mesh1 = Mesh([ctx], ("dp",), (1,))
    x = mx.nd.array(xs, ctx=ctx, dtype="int32")
    y = mx.nd.array(ys, ctx=ctx, dtype="int32")
    _, ref = _bert_dp(mx, params, ctx, mesh1, cfg=cfg)
    ref_losses = [float(ref.step(x, y)) for _ in range(COORD_STEPS)]
    del ref
    counters = _elastic_counters()
    _zero_counters(counters)
    coord = elastic.Coordinator(root, 0, lease_timeout=30.0)
    coord.join()
    mgr, tr, start, outcome = elastic.resume_or_init(
        root, lambda: _bert_dp(mx, None, ctx, mesh1, cfg=cfg)[1], coordinator=coord)
    resumed = [float(tr.step(x, y)) for _ in range(COORD_STEPS - start)]
    coord.leave()
    launches = {k: c.launches for k, c in counters.items()}
    del tr
    if device == "gpu":
        torch.cuda.empty_cache()
    rank_rel = max(abs(rep["losses"][str(t)] - ref_losses[t - 1]) / abs(ref_losses[t - 1])
                   for rep in reports for t in range(1, s + 1))
    res_rel = max(abs(a - b) / abs(b) for a, b in zip(resumed, ref_losses[s:]))
    nl = cfg["num_layers"]
    want = {"fused_adam_update": COORD_STEPS - s,
            **{k: nl * (COORD_STEPS - s) for k in _flash_counters()}}
    ranks_launches = [rep["launches"] for rep in reports]
    ok = (start, outcome) == (s, "resharded") and res_rel <= TOL_RESUME and \
        rank_rel <= TOL_DIST_LOSS
    if device == "gpu":
        ok = ok and launches == want and all(
            lc["fused_adam_update"] == s and all(lc[k] == nl * s for k in _flash_counters())
            for lc in ranks_launches)
    log(f"[coord-kill] world-1 resume: resume_or_init -> ({start}, {outcome!r}); steps "
        f"{s + 1}-{COORD_STEPS} losses {[round(v, 6) for v in resumed]} against the "
        f"uninterrupted world-1 run's {[round(v, 6) for v in ref_losses[s:]]}: max rel "
        f"{res_rel:.2e} (tol {TOL_RESUME:.0e}); the ranks' steps 1-{s} against it: max rel "
        f"{rank_rel:.2e} (tol {TOL_DIST_LOSS:.0e}); launches {launches}, the ranks' "
        f"{ranks_launches} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the world-1 resume from the coordinated snapshot disagrees")
    shutil.rmtree(work, ignore_errors=True)
    return {"S": s, "lease_s": lease, "gate_s": gate_s, "ranks_s": ranks_s,
            "snapshots": steps, "members": man["meta"].get("members"),
            "generation": man["meta"].get("generation"), "fence": man.get("fence"),
            "reports": reports, "resumed_losses": resumed, "reference_losses": ref_losses,
            "resume_rel": res_rel, "rank_rel": rank_rel,
            "launches": {k: launches.get(k, 0) + sum(lc.get(k, 0) for lc in ranks_launches)
                         for k in _elastic_counters()}}


ASYNC_STEPS = 3
ASYNC_LR = 0.05


def rank_dist_async(workdir, cfg, steps, device):
    """One of 2 workers of phase_dist_async: a 2-layer BERT at base width on
    the card under ``gluon.Trainer(kvstore="dist_async")`` (SGD on the
    servers, update on the store), ``steps`` steps on its half of the batch.
    The gradients it pushes for keys whose home is the other worker go to
    ``pushed-<rank>-<step>.npz``; after a barrier each worker replays its home
    keys' pushes in the order its server applied them through a fresh SGD
    updater on the host, from the keys' initial values, and holds the replay
    against the server's value and against a pull, bitwise."""
    import torch
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import _dist_util
    from mxnet_tpu_torch.convert import load_jax_params
    from mxnet_tpu_torch.models import BertModel
    ctx = _dist_util.rank_context(device)
    if ctx.device_type == "gpu":
        torch.backends.cuda.matmul.allow_tf32 = False
    weights = dict(np.load(os.path.join(workdir, "weights.npz")))
    data = np.load(os.path.join(workdir, "data.npz"))
    kv = mx.kv.create("dist_async")
    r, n = kv.rank, kv.num_workers
    pushed = {}
    push = kv.push

    def recording_push(key, value, priority=0):
        if kv._home(key) != r:
            pushed[str(key)] = value.asnumpy().copy()
        else:
            own.setdefault(key, []).append(value.asnumpy().copy())
        return push(key, value, priority)

    own = {}
    kv.push = recording_push
    net = BertModel(**cfg)
    net.initialize(ctx=ctx)
    load_jax_params(net, weights)
    params = list(net.collect_params().values())
    initial = [p.data().asnumpy().copy() for p in params]
    trainer = mx.gluon.Trainer(params, "sgd", {"learning_rate": ASYNC_LR}, kvstore=kv)
    rows = data["x"].shape[0] // n
    x = mx.nd.array(data["x"][r * rows:(r + 1) * rows], ctx=ctx, dtype="int32")
    y = mx.nd.array(data["y"][r * rows:(r + 1) * rows], ctx=ctx, dtype="int32")
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    counters = _flash_counters()
    _zero_counters(counters)
    losses, secs = [], []
    for step in range(steps):
        t0 = time.perf_counter()
        with mx.autograd.record():
            loss = loss_fn(net(x), y)
        loss.backward()
        trainer.step(rows)
        losses.append(float(loss.mean().asnumpy()))
        secs.append(time.perf_counter() - t0)
        np.savez(os.path.join(workdir, f"pushed-{r}-{step}.npz"), **pushed)
        pushed.clear()
    launches = {k: c.launches for k, c in counters.items()}
    st = _dist_util.store()
    st.set(f"chip_smoke_client/{r}", kv._ps_client._id)
    rank_of = {st.get(f"chip_smoke_client/{q}").decode(): q for q in range(n)}
    kv.barrier()             # every push was acknowledged, so applied at its home
    server = kv._ps_server
    mine = [k for k in range(len(params)) if kv._home(k) == r]
    files = {(q, s): np.load(os.path.join(workdir, f"pushed-{q}-{s}.npz"))
             for q in range(n) if q != r for s in range(steps)}
    opt = mx.optimizer.create("sgd", learning_rate=ASYNC_LR, rescale_grad=1.0 / rows)
    upd = mx.optimizer.get_updater(opt)
    counts, bad_server, bad_pull = {}, [], []
    for k in mine:
        counts[str(k)] = server.push_counts.get(k, 0)
        taken = {q: 0 for q in range(n)}
        w = mx.nd.array(initial[k], ctx=mx.cpu())
        for cid in server.applied.get(k, []):
            q = rank_of[cid]
            g = own[k][taken[q]] if q == r else files[(q, taken[q])][str(k)]
            taken[q] += 1
            upd(k, mx.nd.array(g, ctx=mx.cpu()), w)
        if not np.array_equal(w.asnumpy(), server._store[k]):
            bad_server.append(k)
        pulled = mx.nd.zeros(w.shape, ctx=ctx)
        kv.pull(k, out=pulled)
        if not np.array_equal(w.asnumpy(), pulled.asnumpy()):
            bad_pull.append(k)
    kv.barrier()
    kv.close()
    return {"rank": r, "losses": losses, "step_s": secs, "home_keys": len(mine),
            "keys": len(params), "push_counts": counts, "replay_differs_server": bad_server,
            "replay_differs_pull": bad_pull, "launches": launches}


def phase_dist_async(torch, device="gpu", cfg=None, steps=ASYNC_STEPS, timeout=600):
    """``dist_async`` on the card: 2 workers (gloo, sharing the card) under
    ``gluon.Trainer(kvstore="dist_async")`` with a 2-layer BERT at base width,
    T=1024, one sequence each, SGD lr ASYNC_LR on the parameter servers,
    ``steps`` steps: each key's pushes applied at its home exactly once
    (steps x workers), the losses finite, and the home's value equal
    (bitwise) to a host replay of the pushes in the order it applied them;
    K1-K3 2 a step on each worker."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import _dist_util
    from mxnet_tpu_torch.convert import seeded_params
    from mxnet_tpu_torch.models import BertModel
    cfg = cfg or dict(COORD_CFG)
    work = os.path.join(ROOT, "build", "dist_async")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    net = BertModel(**cfg)
    net.initialize(ctx=mx.cpu())
    np.savez(os.path.join(work, "weights.npz"), **seeded_params(net, seed=21))
    del net
    rs = np.random.RandomState(22)
    T = cfg["max_length"]
    np.savez(os.path.join(work, "data.npz"),
             x=rs.randint(0, cfg["vocab_size"], size=(2, T)).astype(np.int32),
             y=rs.randint(0, cfg["vocab_size"], size=(2, T)).astype(np.int32))
    t0 = time.perf_counter()
    ranks = _dist_util.launch_local(
        "chip_smoke:rank_dist_async", 2, {"workdir": work, "cfg": cfg, "steps": steps,
                                          "device": device},
        device=device, timeout=timeout, pythonpath=[ROOT], workdir=os.path.join(work, "launch"))
    seconds = time.perf_counter() - t0
    nl = cfg["num_layers"]
    counts = {k: v for rk in ranks for k, v in rk["push_counts"].items()}
    ok = (len(counts) == ranks[0]["keys"]
          and all(v == steps * 2 for v in counts.values())
          and all(np.isfinite(rk["losses"]).all() for rk in ranks)
          and not any(rk["replay_differs_server"] or rk["replay_differs_pull"] for rk in ranks))
    if device == "gpu":
        ok = ok and all(rk["launches"][k] == nl * steps for rk in ranks
                        for k in _flash_counters())
    log(f"[dist-async] 2 workers over {ranks[0]['keys']} keys ({[rk['home_keys'] for rk in ranks]} "
        f"at each home): pushes applied a key {sorted(set(counts.values()))} (want "
        f"{steps * 2}); losses {[[round(v, 6) for v in rk['losses']] for rk in ranks]}; "
        f"steps {[[round(v, 2) for v in rk['step_s']] for rk in ranks]} s; host replay "
        f"against the servers and the pulls: keys differing "
        f"{[rk['replay_differs_server'] + rk['replay_differs_pull'] for rk in ranks]}; "
        f"launches {[rk['launches'] for rk in ranks]}; {seconds:.1f} s "
        f"{'ok' if ok else 'FAIL'}")
    shutil.rmtree(work, ignore_errors=True)
    if not ok:
        raise AssertionError("dist_async did not apply every push exactly once")
    return {"seconds": seconds, "ranks": ranks, "launches": {
        k: sum(rk["launches"][k] for rk in ranks) for k in _flash_counters()}}


@contextlib.contextmanager
def _world1_nccl(torch):
    """A world-1 process group on the card, over the backend rule's choice
    (NCCL), for the block's phases."""
    import torch.distributed as dist
    from mxnet_tpu_torch import _dist_util
    work = os.path.join(ROOT, "build", "dist")
    os.makedirs(work, exist_ok=True)
    _dist_util.init_process_group(
        device="gpu", rank=0, world_size=1,
        init_method=f"file://{os.path.join(work, f'lc.{os.getpid()}.{time.time_ns()}')}")
    try:
        if dist.get_backend() != "nccl":
            raise AssertionError(f"world 1 on one card runs {dist.get_backend()}, not nccl")
        yield
    finally:
        _dist_util.destroy_process_group()


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the GPU host",
              file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(ROOT, "mxnet_tpu_torch")):
        print("chip_smoke: mxnet_tpu_torch/ not found beside chip_smoke.py",
              file=sys.stderr)
        return 3
    sys.path.insert(0, ROOT)
    _time_phases()
    t0 = time.perf_counter()
    device = phase_device(torch)
    build = phase_build()
    kernel = phase_kernel(torch)
    kernel_bwd = phase_kernel_bwd(torch)
    kernel_fused = phase_kernel_fused_ragged(torch)
    serve = phase_serve(torch)
    train, weights, grads, bert_params, bert_batch = phase_train(torch)
    train_check = phase_train_check(torch)
    fused = phase_fused(torch, weights, grads)
    del weights, grads
    torch.cuda.empty_cache()
    rtc = phase_rtc(torch)
    resnet_serve, resnet_params, acts, conv_weights = phase_resnet_serve(torch)
    probe = phase_probe(torch, acts, conv_weights)
    del acts, conv_weights
    resnet_train = phase_resnet_train(torch, resnet_params)
    resnet_train_check = phase_resnet_train_check(torch)
    dp_bert = phase_dp_bert(torch, bert_params, bert_batch, train["steps"])
    dist_nccl = phase_dist_bert_nccl(torch, bert_params, bert_batch, dp_bert)
    dp_resnet = phase_dp_resnet(torch, resnet_params, resnet_train["profile"])
    dp_check = phase_dp_check(torch)
    torch.cuda.empty_cache()
    with _world1_nccl(torch):
        elastic_bert = phase_elastic_bert(torch, bert_params, bert_batch)
    elastic_kill = phase_elastic_kill(torch, bert_params, bert_batch, elastic_bert["losses"])
    dist_ranks = phase_dist_bert_ranks(torch, bert_params, bert_batch)
    with _world1_nccl(torch):
        pp_train, pp_w3 = phase_pp_train(torch, bert_params, bert_batch, dp_bert)
        pp_check = phase_pp_check(torch)
        pp_tp_train = phase_pp_tp_train(torch, bert_params, bert_batch, pp_train)
        pp_gpipe = phase_pp_gpipe(torch, bert_params, bert_batch, pp_train, pp_w3)
        pp_interleaved = phase_pp_interleaved(torch, bert_params, bert_batch, pp_train)
    pp_ranks = phase_pp_ranks(torch, bert_params, bert_batch, pp_train, pp_w3)
    del pp_w3
    pp_dryrun = phase_pp_dryrun(torch)
    pp_tp_ranks = phase_pp_tp_ranks(torch)
    torch.cuda.empty_cache()
    lc_kernels = phase_lc_kernels(torch)
    lc_weights = _lc_weights()
    with _world1_nccl(torch):
        lc_train = phase_lc_train(torch, lc_weights)
        pp_lc = phase_pp_lc(torch, lc_weights, lc_train)
        lc_check = phase_lc_check(torch, lc_weights)
        elastic_lc = phase_elastic_lc(torch, lc_weights)
    torch.cuda.empty_cache()
    lc_ranks = phase_lc_ranks(torch, lc_weights)
    lc_ranks_d16 = phase_lc_ranks(torch, _lc_weights(LC_DRYRUN_CFG), cfg=LC_DRYRUN_CFG,
                                  label="lc-ranks-d16")
    zero_ranks = phase_zero_bert_ranks(torch)
    elastic_zero = phase_elastic_zero_reshard(torch)
    moe_weights = _moe_weights(MOE_CFG, seed=30)
    with _world1_nccl(torch):
        moe_train = phase_moe_train(torch, moe_weights)
        moe_check = phase_moe_check(torch)
        pp_moe = phase_pp_moe(torch, moe_weights)
    moe_serve = phase_moe_serve(torch, moe_weights)
    moe_ranks = phase_moe_ranks(torch)
    pp_sched_ranks = phase_pp_sched_ranks(torch)
    graph_serve = phase_graph_serve(torch, bert_params, resnet_params, moe_weights)
    graph_train = phase_graph_train(torch, bert_params, bert_batch, resnet_params, lc_weights,
                                    moe_weights)
    del moe_weights
    with _world1_nccl(torch):
        overlap_bert = phase_overlap_bert(torch, bert_params, bert_batch)
    del bert_params
    torch.cuda.empty_cache()
    overlap_ranks = phase_overlap_ranks(torch)
    coord_kill = phase_coord_kill(torch)
    dist_async = phase_dist_async(torch)
    f32 = kernel["timings"]["float32"]
    b32 = kernel_bwd["timings"]["float32"]
    src = "mxnet_tpu_torch/csrc/"
    ref = "mxnet_tpu/ops/pallas/"
    dist_by_dtype = {dt: dist_nccl[dt] for dt in ("float32", "bfloat16")}

    def dp_launches(name):
        """Launches of ``name`` on the fused-step paths, by path (the ranks'
        summed)."""
        return {**{f"{label}_{dt}": phase[dt]["launches"].get(name, 0) for label, phase in
                   (("dp_bert", dp_bert), ("dp_resnet", dp_resnet),
                    ("dist_nccl", dist_by_dtype)) for dt in phase},
                "dist_ranks": dist_ranks["launches"].get(name, 0),
                "lc_train": lc_train["launches"].get(name, 0),
                "lc_ranks": lc_ranks["launches"].get(name, 0),
                "lc_ranks_d16": lc_ranks_d16["launches"].get(name, 0),
                "moe_train": moe_train["launches"].get(name, 0),
                "moe_ranks": moe_ranks["launches"].get(name, 0),
                "pp_train": pp_train["launches"].get(name, 0),
                "pp_train_bfloat16": pp_train["bfloat16"]["launches"].get(name, 0),
                "pp_ranks": pp_ranks["launches"].get(name, 0),
                "pp_dryrun": pp_dryrun["launches"].get(name, 0),
                "pp_tp_train": pp_tp_train["launches"].get(name, 0),
                "pp_tp_ranks": pp_tp_ranks["launches"].get(name, 0),
                "pp_gpipe": pp_gpipe["remat"]["launches"].get(name, 0),
                "pp_gpipe_noremat": pp_gpipe["noremat"]["launches"].get(name, 0),
                "pp_interleaved": pp_interleaved["launches"].get(name, 0),
                "pp_lc": pp_lc["launches"].get(name, 0),
                "pp_moe": pp_moe["launches"].get(name, 0),
                "pp_sched_ranks": pp_sched_ranks["launches"].get(name, 0),
                **{label: phase["launches"].get(name, 0) for label, phase in
                   (("elastic_bert", elastic_bert), ("elastic_kill", elastic_kill),
                    ("elastic_lc", elastic_lc), ("elastic_zero", elastic_zero),
                    ("overlap_bert", overlap_bert), ("overlap_ranks", overlap_ranks),
                    ("coord_kill", coord_kill), ("dist_async", dist_async))},
                # the 2-bit compressed ranks' plain SGD: K4's sgd_update rule
                **({"overlap_ranks_sgd_update": overlap_ranks["launches"].get(
                    "fused_sgd_update", 0)} if name == "fused_sgd_mom_update" else {}),
                **{f"graph_{path}_{mode}": r["modes"][mode]["launches"].get(name, 0)
                   for path, r in graph_train.items() if "modes" in r for mode in r["modes"]},
                "zero_ranks": sum(lc.get(name, 0) for c in zero_ranks["configs"].values()
                                  for lc in c["launches"])}

    def lc_entry(kind):
        """K1-K3 on the long-context path: the causal rows at each shape."""
        return {label: {k: t[k] for k in ("BH", "T", "Tk", "D", "causal", "port_bwd_ms",
                                          "plain_fwd_ms", "plain_bwd_ms", "sdpa_fwd_ms",
                                          "sdpa_bwd_ms")} | t[kind]
                for label, t in lc_kernels["timings"].items()} | {
            "launches_per_step": lc_train["per_step"].get(
                {"fwd": "flash_attention_fwd", "dq": "flash_attention_bwd_dq",
                 "dkv": "flash_attention_bwd_dkv"}[kind]),
            "checks": lc_kernels["checks"], "head_dim_checks": lc_kernels["head_dims"]}
    fwd_by_path = {"serve": serve["launches"]["flash_attention_fwd"],
                   "train": train["launches"]["flash_attention_fwd"],
                   "moe_serve": moe_serve["launches"]["flash_attention_fwd"],
                   **{f"graph_serve_{path}": r["k1_launches"]
                      for path, r in graph_serve.items()},
                   **{k: v for k, v in dp_launches("flash_attention_fwd").items()
                      if not k.startswith("dp_resnet")}}
    sp_f, sp_b = kernel["timings"]["sp_float32"], kernel_bwd["timings"]["sp_float32"]
    bf16 = kernel["timings"]["bfloat16"]

    def timed_rows(kind, prefix):
        """K1-K3 at one of TIMED_SHAPES' extra shapes (``prefix``: ``pp``, the
        pipeline's microbatch, ``tp``, a tp 2 rank's share of it, or ``d256``),
        f32 and bf16."""
        out = {}
        for dt in ("float32", "bfloat16"):
            if kind == "fwd":
                t = kernel["timings"][f"{prefix}_{dt}"]
                out[dt] = {k: t[k] for k in ("B", "H", "T", "Tk", "D", "ms", "graph_ms",
                                             "plain_ms", "library_ms", "library_graph_ms",
                                             "bound_ms", "bound_by", "tflops")}
            else:
                t = kernel_bwd["timings"][f"{prefix}_{dt}"]
                out[dt] = dict({k: t[k] for k in ("B", "H", "T", "Tk", "D", "plain_ms",
                                                  "library_ms", "port_bwd_ms")}, **t[kind])
        if prefix == "d256":
            res = kernel["resources"] if kind == "fwd" else kernel_bwd["resources"]
            out["resources"] = {n: r for n, r in res.items() if n.endswith(", 256>")}
        return out
    entries = [
        ("flash_attention_fwd", "flash_attention_fwd.cu", "flash_attention.py:86",
         sum(fwd_by_path.values()), kernel["max_abs_err_f32"], f32["ms"],
         f32["plain_ms"], f32["bound_ms"], f32["bound_by"], f32["library_ms"],
         {"launches_by_path": fwd_by_path,
          "bound": "3xTF32 on the tensor cores (3 TF32 products at 495 TFLOP/s)",
          "fma_bound_ms": f32["fma_bound_ms"], "graph_ms": f32["graph_ms"],
          "library_graph_ms": f32["library_graph_ms"], "tflops": f32["tflops"],
          "bfloat16": {k: bf16[k] for k in ("ms", "graph_ms", "plain_ms", "library_ms",
                                            "library_graph_ms", "bound_ms", "tflops")},
          "hmma": {n: r["HMMA"] for n, r in kernel["resources"].items()},
          "sp_shard": {k: sp_f[k] for k in ("B", "H", "T", "Tk", "ms", "graph_ms",
                                            "plain_ms", "library_ms", "bound_ms",
                                            "bound_by")},
          "launches_per_rank_step": {"shape": dist_ranks["shape"],
                                     "n": dist_ranks["cfg"]["num_layers"]},
          "long_context": lc_entry("fwd"), "pipeline_microbatch": timed_rows("fwd", "pp"),
          "pipeline_tp_rank": timed_rows("fwd", "tp"),
          "head_dim_256": timed_rows("fwd", "d256")}),
        *[(f"flash_attention_bwd_{kind}", "flash_attention_bwd.cu",
           f"flash_attention.py:{line}",
           train["launches"][f"flash_attention_bwd_{kind}"]
           + sum(dp_launches(f"flash_attention_bwd_{kind}").values()),
           kernel_bwd["max_abs_err_f32"][kind], b32[kind]["ms"], b32["plain_ms"],
           b32[kind]["bound_ms"], b32[kind]["bound_by"], b32["library_ms"],
           {"plain_and_library_cover": "dQ and dK/dV together",
            "bound": "3xTF32 on the tensor cores (3 TF32 products at 495 TFLOP/s)",
            "fma_bound_ms": b32[kind]["fma_bound_ms"],
            "port_bwd_ms": b32["port_bwd_ms"],
            "library_fwd_bwd_less_fwd_ms": b32["library_fwd_bwd_less_fwd_ms"],
            "launches_by_path": dp_launches(f"flash_attention_bwd_{kind}"),
            "sp_shard": dict({k: sp_b[k] for k in ("B", "H", "T", "Tk", "plain_ms",
                                                   "library_ms", "port_bwd_ms")},
                             **sp_b[kind]),
            "hmma": {n: r["HMMA"] for n, r in kernel_bwd["resources"].items()
                     if n.startswith(f"flash_bwd_{kind}_kernel<")},
            "long_context": lc_entry(kind), "pipeline_microbatch": timed_rows(kind, "pp"),
            "pipeline_tp_rank": timed_rows(kind, "tp"),
            "head_dim_256": timed_rows(kind, "d256")})
          for kind, line in (("dq", 181), ("dkv", 229))],
        *[(name, "fused_optimizer.cu", f"fused_optimizer.py:{line}",
           sum(dp_launches(rule).values()),
           max([fused[rule]["max_abs_err"]] + [c["max_abs_err"] for c in dp_checks]),
           fused[rule]["ms"],
           fused[rule]["plain_ms"], fused[rule]["bound_ms"], "bytes",
           fused[rule]["library_ms"],
           {"rule": f"{rule} (the fused step's), BERT-base's parameters, in place",
            "launches_by_path": dp_launches(rule),
            "update_ms_in_step": {f"{label}_{dt}": phase[dt]["update_ms"]
                                  for label, phase in (("dp_bert", dp_bert),
                                                       ("dp_resnet", dp_resnet))
                                  for dt in phase},
            "pallas_rule": {k: fused[pallas][k] for k in
                            ("ms", "plain_ms", "bound_ms", "max_abs_err")},
            "device_scalar_form": {k: fused[rule][k] for k in
                                   ("hyper_ms", "value_ms", "hyper_graph_ms",
                                    "value_graph_ms", "hyper_equal_value",
                                    "launches_per_replay")},
            **({"dp_resnet_check": {dt: dp_resnet[dt]["update_check"] for dt in dp_resnet}}
               if dp_checks else {}),
            **({"pipeline": {"per_step": pp_train["per_step"]["fused_adam_update"],
                             "per_rank_step": pp_ranks["per_rank_step"]["fused_adam_update"],
                             "update": "the embed, the stage's own layers and the head, "
                                       "one weight decay"},
                "pipeline_tp_zero": {
                    "per_step": pp_tp_train["per_step"]["fused_adam_update"],
                    "update": "the pieces of the rank's shard of every ZeRO bucket (embed, "
                              "stage, head), one weight decay"},
                "pipeline_schedules": {
                    "per_step": {
                        "gpipe": pp_gpipe["remat"]["per_step"]["fused_adam_update"],
                        **{f"interleaved_{v}": r["per_step"]["fused_adam_update"]
                           for v, r in pp_interleaved.items() if v != "launches"},
                        "long_context": pp_lc["gluon"]["per_step"]["fused_adam_update"],
                        "moe": pp_moe["per_step"]["fused_adam_update"]},
                    "update": "the embed, the stage's layers and the head, one weight "
                              "decay, after the schedule's last backward"}}
               if rule == "fused_adam_update" else {}),
            **({"moe": {"per_step": moe_train["per_step"]["fused_adam_update"],
                        "update": "the dense ZeRO shard segments and the expert tensors, "
                                  "one weight decay"}}
               if rule == "fused_adam_update" else {}),
            **({"long_context": {
                "per_step": lc_train["per_step"]["fused_adam_update"],
                "segments_per_rank": [r["segments"] for r in lc_ranks["ranks"]],
                "zero_state_ratio": {k: c["state_ratio"] for k, c in
                                     zero_ranks["configs"].items()}}}
               if rule == "fused_adam_update" else {})})
          for name, line, rule, pallas, dp_checks in (
              ("fused_sgd", 66, "fused_sgd_mom_update", "fused_sgd",
               [dp_resnet[dt]["update_check"] for dt in dp_resnet]),
              ("fused_adam", 116, "fused_adam_update", "fused_adam", []))],
    ]
    pt = probe["total"]
    pr3 = [
        ("rtc_cuda_module", "mxnet_tpu_torch/rtc.py", "mxnet_tpu/rtc.py:61",
         rtc["launches"], rtc["max_abs_err"], rtc["ms"], rtc["plain_ms"], rtc["bound_ms"],
         "bytes", rtc["library_ms"],
         {"timed": "axpy (2x+y) on 2^26 f32 through CudaModule/launch",
          "library": "torch.add(y, x, alpha=2.0)", "graph_ms": rtc["graph_ms"],
          "library_graph_ms": rtc["library_graph_ms"], "grid": rtc["grid"],
          "nvrtc_compile_ms": rtc["compile_ms"], "compile_split_ms": rtc["compile_split_ms"],
          "empty_launch_host_us": rtc["empty_launch_host_us"],
          "empty_launch_device_us": rtc["empty_launch_device_us"]}),
        ("blocked_matmul", "mxnet_tpu_torch/csrc/blocked_matmul.cu",
         "benchmark/conv_kernel_probe.py:59", probe["launches"], probe["max_abs_err"],
         pt["ms"], pt["plain_ms"], pt["bound_ms"], pt["bound_by"], pt["library_ms"],
         {"timed": "sum over the three bf16 probe shapes",
          "library": "torch.matmul (bf16)", "conv_ms": pt["conv_ms"],
          "graph_ms": pt["graph_ms"], "library_graph_ms": pt["library_graph_ms"],
          "conv_graph_ms": pt["conv_graph_ms"], "fma_floor_ms": pt["fma_floor_ms"],
          "float32": probe["f32"],
          "sass": {n: {op: r[op] for op in ("HMMA", "HGMMA", "UTMALDG")}
                   for n, r in probe["resources"].items()},
          "shapes": [{k: r[k] for k in ("mkn", "ms", "graph_ms", "plain_ms", "library_ms",
                                        "library_graph_ms", "conv_ms", "conv_graph_ms",
                                        "bound_ms", "bound_by", "tflops")}
                     for r in probe["shapes"]]}),
    ]
    entries = [(name, src + source, ref + replaces, *rest)
               for name, source, replaces, *rest in entries] + pr3
    line = {"kernels": [dict({
        "name": name, "route": "cuda", "source": source,
        "replaces": replaces, "launches": launches, "max_abs_err": err,
        "max_err": err, "ms": ms, "kernel_ms": ms, "plain_ms": plain,
        "bound_ms": bound, "bound_by": by, "library_ms": lib}, **extra)
        for name, source, replaces, launches, err, ms, plain, bound, by, lib, extra
        in entries]}
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump({"device": device, "build_s": build, "kernel": kernel,
                   "kernel_bwd": kernel_bwd, "kernel_fused": kernel_fused,
                   "serve": serve, "train": train, "train_check": train_check,
                   "fused": fused, "rtc": rtc, "resnet_serve": resnet_serve,
                   "probe": probe, "resnet_train": resnet_train,
                   "resnet_train_check": resnet_train_check, "dp_bert": dp_bert,
                   "dp_resnet": dp_resnet, "dp_check": dp_check, "dist_nccl": dist_nccl,
                   "dist_ranks": dist_ranks, "lc_kernels": lc_kernels,
                   "lc_train": lc_train, "lc_check": lc_check, "lc_ranks": lc_ranks,
                   "lc_ranks_d16": lc_ranks_d16, "zero_ranks": zero_ranks,
                   "elastic_bert": elastic_bert, "elastic_kill": elastic_kill,
                   "elastic_lc": elastic_lc, "elastic_zero": elastic_zero,
                   "moe_train": moe_train, "moe_check": moe_check, "moe_serve": moe_serve,
                   "moe_ranks": moe_ranks, "pp_train": pp_train, "pp_check": pp_check,
                   "pp_ranks": pp_ranks, "pp_dryrun": pp_dryrun, "pp_tp_train": pp_tp_train,
                   "pp_tp_ranks": pp_tp_ranks, "pp_gpipe": pp_gpipe,
                   "pp_interleaved": pp_interleaved, "pp_lc": pp_lc, "pp_moe": pp_moe,
                   "pp_sched_ranks": pp_sched_ranks,
                   "graph_serve": graph_serve, "graph_train": graph_train,
                   "overlap_bert": overlap_bert, "overlap_ranks": overlap_ranks,
                   "coord_kill": coord_kill, "dist_async": dist_async,
                   "kernels": line["kernels"],
                   "seconds": time.perf_counter() - t0, "phase_seconds": PHASE_SECONDS,
                   "process_seconds": time.perf_counter() - T_START},
                  f, indent=1, default=float)
    log(f"[done] {time.perf_counter() - t0:.1f} s, {time.perf_counter() - T_START:.1f} s "
        f"since the process started")
    print(json.dumps(line))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": device["name"],
                                             "count": device["count"]}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
