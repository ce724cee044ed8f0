"""Pipeline parallelism: GPipe, the 1F1B schedule and ``PipelineTrainer``.

Counterpart of ``mxnet_tpu/parallel/pipeline.py``: ``pipeline_spec``,
``pipeline_apply`` and ``gpipe_schedule`` (:78-122), ``schedule_1f1b``
(:125-247) and ``PipelineTrainer`` (:250-1348): the 1F1B schedule, its
interleaved form (``virtual_stages=v``) and GPipe (``schedule="gpipe"``,
``remat``) over a ``pp`` mesh axis, with optional ``dp`` and ``tp`` axes, in
float32 or bfloat16 (float32 master weights), frozen lanes
(``grad_req='null'``), ``step``, ``drain``, ``sync``, ``num_update``,
``state_dict`` and ``load_state_dict`` (the ``pp`` snapshot kind of
``elastic/state.py``). ::

    embed, cells, head = net.pipeline_split()      # models/bert.py
    tr = PipelineTrainer(net, loss, "adam", {"learning_rate": 1e-4},
                         mesh=make_mesh({"pp": 2, "tp": 2, "dp": 2}), dp_axis="dp",
                         tp_axis="tp", tp_mode="partitioned", zero_update=True,
                         num_microbatch=4)
    loss = tr.step(x, y)        # a PendingScalar of the global batch's mean

``step`` is admitted into a ``DispatchWindow`` (reference :575, :1135-1143)
and, with telemetry on, books the reference's per-step comm estimates
(``comm_estimate``; at pp above 1 the embed's and head's gradient sum over
pp), the optimizer state a rank holds, the signature's FLOPs and
``record_step(source="pipeline")`` (:1243-1294; its goodput bubble waits for
the goodput ledger).

The reference runs the schedule as one ``lax.scan`` inside ``shard_map``.
Here every rank of a ``torch.distributed`` mesh (``parallel/mesh.py``) runs
its own stage of the same tick loop eagerly:

- **The ticks and lanes are the reference's.** M + 2(pp v - 1) ticks; chunk
  c of stage s is logical stage l = c pp + s (v = 1: l = s, one chunk of
  the stage's layers); at tick t it runs the forward of microbatch t - l
  and the backward of microbatch t - 2(pp v - 1) + l. The last logical
  stage turns a microbatch around within one tick. A lane outside [0, M) is
  skipped, where the reference computes it on zeros and masks it
  (:176-186). The interleaved forward wraps from the last stage's chunk c
  to stage 0's chunk c + 1, the cotangents the other way (:182-184,
  :213-216); at pp = 1 a chunk hands its output to the next chunk within
  the process (no send).
- **Each in-flight microbatch keeps its autograd graph**, where the
  reference stashes the stage input and re-derives the vjp (:200-222). The
  numbers and the bound are the same: chunk c of stage s holds at most
  min(M, 2(pp v - 1 - l) + 1) microbatches, at most 2 pp v - 1 whatever M
  is (``last_stats["max_in_flight"]``, the most of any chunk), and no
  forward is run twice (K1 once a layer and microbatch, K2 and K3 once each
  in its backward).
- **GPipe** (``pipeline_apply``, reference :78-111): M + pp - 1 forward
  ticks (stage s runs microbatch t - s; stage 0 takes ``x_stack[t]``, the
  others what their neighbour sent), then the transposed order, the same
  ticks reversed, in the backward of one ``torch.autograd.Function``: each
  microbatch's weight gradients are added into the same buffers and its
  input's cotangent goes to the previous stage. With ``remat=True`` each
  stage forward runs under ``torch.utils.checkpoint`` (non-reentrant): only
  its input is kept and the backward runs it again, with the port's
  autograd mode and dropout generator state of the first run; with
  ``remat=False`` every microbatch keeps its whole graph until the
  backward, GPipe's O(M) activation memory. A second derivative through
  the Function (``create_graph``) raises the reference's
  ``autograd._NO_SECOND_ORDER``: the reversed ticks' point-to-point
  exchanges are not autograd ops, so nothing could record it (the
  reference's ``pipeline_apply``, plain JAX, differentiates twice). The trainer's GPipe step runs
  the embed on stage 0's M microbatches, ``pipeline_apply`` over the
  stages, then the head and loss of each microbatch on the last stage (the
  reference computes the head on every stage and masks it, :933-957).
- **The backward** of a microbatch is ``torch.autograd.grad`` of the head
  loss times 1 / (M dp) on the last stage, or of the stage output against
  the received cotangent elsewhere, with respect to the stage's trainable
  leaves and its input; the leaves' gradients are added into their buffers
  (microbatch sums of the 1 / (M dp)-scaled loss: the dp mean of the
  reference's sums over M, ``:930-935``), the input's goes to the previous
  stage.
- **The wires.** After each tick, one ``_dist_util.exchange`` round posts
  the activations to the next stage (tag ``FWD_TAG + 2 c`` for the
  receiving chunk c) and the cotangents to the previous one
  (``BWD_TAG + 2 c``), in the order of their tags on both sides (NCCL pairs
  a peer's messages by order). The reference's two cyclic ``ppermute``\\ s
  (:233-236) become the sends whose receive is live: both peers know the
  schedule, so a send is skipped exactly where the peer's receive is. At two
  stages both rings join the same pair of ranks; the tags keep them apart.
  At pp = 1 nothing is exchanged. The stages learn the shape and dtype of
  what they receive from the embed run once in predict mode (cached per
  batch signature; the reference's ``eval_shape``, :397).
- **The reductions** (reference :957-993): the embed's and the head's
  gradients (nonzero on stage 0 and on the last stage only) are summed over
  pp and dp in one all-reduce of a flat buffer, the stage's own layers' over
  dp in another; the loss over pp and dp. A group of one rank is skipped.
- **No stacked storage.** Every rank holds the model's Parameters; each
  updates its own stage's layers and the replicated embed and head, with
  ``functional_optimizer``'s rule for each weight decay (one launch of K5
  for Adam or K4 for SGD through its pointer table; the other rules a
  tensor at a time), reading its scalars from the trainer's ``_hyper`` rows
  as the fused step does. LAMB's and LARS's norms (the LAMB/LARS lanes) are
  taken over the stage's copies of a cell parameter together
  (``_stacks``), as over the reference's stacked leaf of the stage's
  layers, and over each embed and head parameter alone; under ZeRO or a
  ``tp_axis`` they raise with the reference's words (:473-476, :657-659).
  Weight-decay indices follow the reference's convention (:551-556): embed
  leaves first, then the cell leaves (one index for a leaf of every layer),
  then the head, so a ``wd_mult`` set by index selects the same parameter in
  both packages. Stage s owns rows [s L, (s + 1) L) of the stack order
  (``_stack_order``, reference :480-486: row s L + c Lc + j holds layer
  (c pp + s) Lc + j, the identity at v = 1), its chunk c the rows' c-th
  Lc. ``sync()`` all-gathers each stage's rows over pp and writes each into
  the layer the stack order names, so that every rank's Parameters hold
  every weight, as the reference's single-controller ``sync``
  (:1301-1326) leaves them.

The compositions (reference :271-294):

- **``tp_axis`` with ``tp_mode="sharded"``** (weight-sharded): a leaf whose
  ``Parameter.sharding`` splits a dim over ``tp`` is kept as this rank's
  shard (its weights and optimizer state); once a step, outside autograd,
  ``tensor_parallel.gather_tp`` all-gathers it into the Parameter, which the
  Gluon blocks compute with (:854-858), and the update reads this rank's
  slice of the full gradient, the same on every tp rank (``slice_tp``,
  :976-980). The full weight exists on every rank during the step.
- **``tp_mode="partitioned"``** (Megatron, ``parallel/megatron.py``): the
  layer plans (``plan_embed``, ``plan_cell``, ``plan_head``) decide each
  leaf's layout; each rank keeps only its view shard of a partitioned leaf,
  and the stage runs ``embed_forward``, ``cell_forward`` and
  ``head_loss_forward`` on the shards (:874, :901, :907), the decoder fused
  into ``vocab_parallel_cross_entropy``. No weight is ever gathered: the
  collectives move activations. The gradients of replicated leaves are
  partial sums, all-reduced over tp with the others of their flat buffer
  (:982-993). At tp > 1 the Parameters of partitioned leaves keep no storage
  until ``sync()`` gathers them back. ``sequence_parallel=True`` shards the
  non-matmul regions over the same ranks. Dropout keys are the step, the
  stage, the dp rank, the layer and the microbatch; the seed is agreed over
  the mesh at construction.
- **``zero_update``** over ``dp`` (:665-791): the embed's, the stage's and
  the head's trainable leaves are planned into flat buckets
  (``zero.plan_buckets``, over the stage's stacked (L, ...) and the
  tp-local view shapes); after the backward each bucket is reduce-scattered
  over dp in ``comm_dtype`` (native, ``"bfloat16"``, ``"int8"``), the
  rank's shard updated (its pieces join the update's lists: still one
  launch of K4/K5 a weight decay) against its 1/dp of the optimizer state,
  and all-gathered back. Weight-sharded tp and ZeRO do not compose
  (:651-656).

**The compiled step** (the reference jits the whole step, embed ->
schedule -> head -> loss -> backward -> update, :296, :1092-1116): on the
card ``step`` is captured as one CUDA graph (``engine.capture``), with
``DataParallelTrainer``'s lifecycle. Step 1 of a batch signature runs the
body eagerly on the engine's side stream (the warm-up: kernels, pointer
tables, the embed's shape probe); step 2 captures the body over static
microbatch stacks and replays it; later steps copy the stacks in, write
``_hyper`` and replay. The graph is the schedule's whole tick loop on this
rank (its point-to-point rounds, each schedule and split, tp and ZeRO)
with the reductions and the update. A replay runs no Python of the step:
``last_stats`` (ticks, in flight, sends, ``comm``) is the captured step's on
every replay, its collectives are added to ``comm_stats``, and the engine
adds its launches and ``p2p_stats`` sends. Dropout in Gluon mode draws from
the port's device generator, which the graph registers, so a replay draws
what the eager step would. What runs it eagerly every step
(``_graph_reason``, from ``_eager_reason``):

- ``"cpu"``: a CPU device;
- ``"gloo"``: a mesh whose groups are not all NCCL (its ranks share one
  card; gloo cannot be captured);
- ``"keyed_dropout"``: partitioned tp with a dropout rate above 0: its
  masks come from a ``torch.Generator`` seeded on the host from a key that
  holds the step (``megatron._dropout``), which a graph would replay;
- ``"remat_dropout"``: GPipe with ``remat`` over stages that hold a
  Dropout above 0: the recompute resets the generator to where the first
  run began, which a capture cannot read.

``last_stats`` adds ``comm``: the collectives the step issued, ``{"op@axis":
{"calls", "bytes"}}`` (from ``_dist_util.comm_stats``: the payload is the
tensor a rank passes in, its shard for an all-gather); ``comm_estimate``
gives the reference's estimates beside them.

Refused, as the reference refuses them (``tests/test_pipeline_1f1b.py``,
``tests/test_pipeline_parallel.py``, ``tests/test_partitioned_tp.py``):
layers that do not divide into pp x v chunks, ``virtual_stages`` without
1F1B, GPipe with partitioned tp, cells that are not structurally
identical, uninitialized parameters, a batch that does not divide by M dp, a
net without ``pipeline_split``, a stage block that keeps aux state
(BatchNorm's running statistics), a cell leaf frozen in some layers only, an
unknown ``tp_mode``, ``sequence_parallel`` without partitioned tp, a
partitioned loss that is not the mean token cross entropy, heads, hidden or
vocab that do not divide by tp, ZeRO without ``dp_axis`` or with
weight-sharded tp, a sequence that does not divide by tp under sp. As in
the reference, ``remat`` serves GPipe only.
"""
from __future__ import annotations

import copy
import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..base import MXNetError, env, torch_dtype
from ..ndarray import NDArray
from .. import autograd
from .. import engine
from .. import optimizer as opt_mod
from .. import telemetry as _telem
from .. import _dist_util
from ..engine import async_feed as _feed
from ..gluon.block import _Fold
from . import megatron as _mg
from . import zero as _zero
from .data_parallel import (DataParallelTrainer, PendingScalar, _StepGraph,
                            functional_optimizer, refuse_trust_ratio, write_hyper)
from .mesh import P, current_mesh, require_axis
from .tensor_parallel import gather_tp, shard_tensor, slice_tp, tp_shard_dim
from .step_program import StepProgram, config_fingerprint, structural_fingerprint

__all__ = ["pipeline_spec", "pipeline_apply", "gpipe_schedule", "schedule_1f1b",
           "PipelineTrainer"]

env.declare("MXNET_TPU_PP_SCHEDULE", "1f1b", str,
            "Default PipelineTrainer schedule: '1f1b' (bounded activation "
            "memory) or 'gpipe' (grad-of-scan transpose)")

FWD_TAG = 1     # activations, stage s -> s + 1 (to chunk c: FWD_TAG + 2 c)
BWD_TAG = 2     # cotangents, stage s -> s - 1 (to chunk c: BWD_TAG + 2 c)


def pipeline_spec(num_stages: int, axis: str = "pp"):
    return {"num_stages": num_stages, "axis": axis}


def _stage_of(mesh, axis_name) -> Tuple[int, int]:
    return (mesh.axis_size(axis_name), mesh.axis_index(axis_name)) if mesh else (1, 0)


def _exchange(sends, recvs, group):
    """``_dist_util.exchange`` with each side's messages in the order of
    (peer, tag): NCCL pairs two ranks' messages by the order they are
    posted, and both sides of a message use the same tag."""
    if group is not None:
        key = lambda m: (m[1], m[2])     # noqa: E731
        _dist_util.exchange(sorted(sends, key=key), sorted(recvs, key=key), group)


def _remat(fn: Callable) -> Callable:
    """``fn(params, h, tick)`` under non-reentrant ``torch.utils.checkpoint``:
    the forward keeps its input only and the backward runs it again. The
    rerun sees the port's autograd mode of the first run and draws the same
    dropout masks: the device generator is set back to where the first run
    started, and after the rerun to where it was (the reference's
    ``jax.checkpoint`` replays the same keys)."""
    from torch.utils.checkpoint import checkpoint
    from .. import random as _rng

    def run(params, h, tick):
        mode = (autograd.is_recording(), autograd.is_training())
        # a CUDA graph's capture cannot read the generator's state; the
        # trainer captures remat only where its stages draw no dropout
        # (PipelineTrainer._eager_reason, "remat_dropout")
        gen = None if engine.capturing() else _rng.generator(h.device)
        start: list = []

        def body(a):
            if not start:
                start.append(gen.get_state() if gen is not None else None)
                return fn(params, a, tick)
            now = gen.get_state() if gen is not None else None
            if gen is not None:
                gen.set_state(start[0])
            try:
                with autograd._RecordingScope(*mode):
                    return fn(params, a, tick)
            finally:
                if gen is not None:
                    gen.set_state(now)
        # the port draws from its own generators: torch's default one is not
        # saved (nor could it be during a capture)
        return checkpoint(body, h, use_reentrant=False, preserve_rng_state=False)
    return run


class _GPipeRun:
    """One call of ``pipeline_apply`` on this rank: the forward ticks, the
    stash of each microbatch's (input, output) and the reversed ticks."""

    def __init__(self, stage_fn, n, s, group, remat):
        self.fn = _remat(stage_fn) if remat else stage_fn
        self.n, self.s, self.group = n, s, group
        self.stash: Dict[int, tuple] = {}
        self.stats = {"ticks": 0, "max_in_flight": 0}
        self._sent = dict(_dist_util.p2p_stats)

    def forward(self, x_stack, params):
        n, s, M = self.n, self.s, x_stack.shape[0]
        params = list(params)
        self.M, self.meta, self.params = M, x_stack[0], params
        self.stats["ticks"] = M + n - 1
        outs, recv = [], None
        with torch.enable_grad():
            for t in range(M + n - 1):
                sends, recvs = [], []
                m = t - s
                if 0 <= m < M:
                    h_in = (x_stack[m] if s == 0 else recv).detach().requires_grad_()
                    h_out = self.fn(params, h_in, t)
                    self.stash[m] = (h_in, h_out)
                    self.stats["max_in_flight"] = max(self.stats["max_in_flight"],
                                                      len(self.stash))
                    if s < n - 1:
                        sends.append((h_out.detach(), s + 1, FWD_TAG))
                    else:
                        outs.append(h_out.detach())
                recv = None
                if s > 0 and 0 <= t + 1 - s < M:
                    recv = torch.empty_like(self.meta)
                    recvs.append((recv, s - 1, FWD_TAG))
                _exchange(sends, recvs, self.group)
        return torch.stack(outs) if s == n - 1 else torch.zeros_like(x_stack)

    def backward(self, dout):
        n, s, M, params = self.n, self.s, self.M, self.params
        grads: List[Optional[torch.Tensor]] = [None] * len(params)
        dxs: List[Optional[torch.Tensor]] = [None] * M
        cot = None
        for t in reversed(range(M + n - 1)):
            sends, recvs = [], []
            m = t - s
            if 0 <= m < M:
                h_in, h_out = self.stash.pop(m)
                got = torch.autograd.grad(h_out, list(params) + [h_in],
                                          dout[m] if s == n - 1 else cot, allow_unused=True)
                acc = [(i, g) for i, g in enumerate(got[:-1]) if g is not None]
                for i, g in acc:
                    if grads[i] is None:
                        grads[i] = g
                old = [(grads[i], g) for i, g in acc if grads[i] is not g]
                if old:
                    torch._foreach_add_([b for b, _ in old], [g for _, g in old])
                dx = got[-1] if got[-1] is not None else torch.zeros_like(h_in)
                if s == 0:
                    dxs[m] = dx
                else:
                    sends.append((dx, s - 1, BWD_TAG))
                del got, h_in, h_out
            cot = None
            if s < n - 1 and 0 <= t - 1 - s < M:
                cot = torch.empty_like(self.meta)
                recvs.append((cot, s + 1, BWD_TAG))
            _exchange(sends, recvs, self.group)
        self.stats.update({k: _dist_util.p2p_stats[k] - self._sent[k] for k in ("sends", "bytes")})
        return (torch.stack(dxs) if s == 0 else None), grads


class _GPipe(torch.autograd.Function):
    @staticmethod
    def forward(ctx, run, x_stack, *params):
        ctx.run = run
        return run.forward(x_stack, params)

    @staticmethod
    def backward(ctx, dout):
        if torch.is_grad_enabled():
            # create_graph: the reversed ticks' point-to-point exchanges are
            # not autograd ops, so no second derivative could be recorded
            # through them (the reference's pipeline_apply differentiates
            # twice); refuse rather than return a wrong one
            from ..autograd import _NO_SECOND_ORDER
            raise MXNetError(_NO_SECOND_ORDER)
        dx, grads = ctx.run.backward(dout)
        ctx.run = None
        return (None, dx, *grads)


def _pipeline_apply(stage_fn, stage_params, x_stack, mesh, axis_name, remat):
    n, s = _stage_of(mesh, axis_name)
    group = mesh.group(axis_name) if n > 1 else None
    run = _GPipeRun(stage_fn, n, s, group, remat)
    return _GPipe.apply(run, x_stack, *stage_params), run


def pipeline_apply(stage_fn: Callable, stage_params, x_stack, mesh=None,
                   axis_name: str = "pp", remat: bool = True):
    """GPipe's differentiable schedule (reference :78-111) on this rank's
    stage of ``axis_name`` of ``mesh`` (None: one stage).

    ``stage_fn(stage_params, x_mb, tick) -> y_mb`` is this stage's layers,
    shape-preserving; ``stage_params`` the tensors it differentiates (a
    sequence, passed back to it as a list); ``tick`` the schedule step (this
    stage runs microbatch ``tick - stage``); ``x_stack`` the (M, ...)
    microbatch stack, on every stage (only stage 0's is read: the others
    receive their inputs, and take its shape and dtype). Returns the (M,
    ...) output stack, valid on the last stage and zeros elsewhere. Its
    backward runs the transposed schedule on every stage, so every rank of
    the axis must differentiate through the output (a zero cotangent
    elsewhere than on the last stage): the gradients of ``stage_params`` are
    summed over the microbatches, and stage 0 gets ``x_stack``'s. See the
    module docstring for ``remat``."""
    out, _ = _pipeline_apply(stage_fn, list(stage_params), x_stack, mesh, axis_name, remat)
    return out


def gpipe_schedule(stage_fn: Callable, n_microbatch: int, axis_name: str = "pp", mesh=None):
    """The reference's shim over ``pipeline_apply`` (:114-120): a stage of
    no parameters, ``stage_fn(x_mb) -> y_mb``, without remat. Returns
    ``run(x_stack)``; like the reference, it reads M from ``x_stack``."""
    def run(x_stack):
        return pipeline_apply(lambda _, x, t: stage_fn(x), (), x_stack, mesh=mesh,
                              axis_name=axis_name, remat=False)
    return run


def schedule_1f1b(embed_fn: Callable, stage_fn: Callable, head_loss_fn: Callable,
                  params: Sequence[torch.Tensor], grads: Sequence[torch.Tensor],
                  x_stack, y_stack, mesh=None, axis_name: str = "pp",
                  n_chunks: int = 1, act_meta=None, loss_scale: float = 1.0):
    """This rank's stage of the 1F1B schedule (reference :125-247), eager,
    interleaved over ``n_chunks`` chunks of its layers.

    ``embed_fn(x_mb, m) -> act`` (logical stage 0's entry), ``stage_fn(act,
    m, c) -> act`` (chunk c of this stage's layers, shape-preserving),
    ``head_loss_fn(act, y_mb, m) -> scalar`` (the last logical stage's head
    and mean loss); ``x_stack`` and ``y_stack`` index microbatch m as
    ``x_stack[m]``. Run under ``torch.enable_grad()`` and
    ``autograd.record()``. The gradient of ``loss_scale`` times each
    microbatch's loss with respect to each of ``params`` that the stage
    reaches is added into ``grads`` (buffers of the same shapes).
    ``act_meta`` is ``(shape, dtype, device)`` of one activation (what the
    stages receive: activations and cotangents); a pipeline of more than one
    stage requires it.

    Returns ``(loss_sum, stats)``: the sum of the microbatches' losses (on
    the last stage; zero elsewhere) and ``{"ticks", "max_in_flight",
    "sends", "bytes"}`` of this rank (``max_in_flight`` the most
    microbatches any chunk held; the sends from ``p2p_stats``)."""
    n, s = _stage_of(mesh, axis_name)
    if n > 1 and act_meta is None:
        raise MXNetError("schedule_1f1b over more than one stage needs act_meta, "
                         "the (shape, dtype, device) of one activation")
    v = int(n_chunks)
    if v < 1:
        raise MXNetError("n_chunks must be >= 1")
    nv = n * v
    M = len(x_stack)
    group = mesh.group(axis_name) if n > 1 else None
    params = list(params)
    stash: List[Dict[int, tuple]] = [{} for _ in range(v)]
    loss_sum = None
    fwd_in: List[Optional[torch.Tensor]] = [None] * v
    bwd_in: List[Optional[torch.Tensor]] = [None] * v
    stats = {"ticks": M + 2 * (nv - 1), "max_in_flight": 0}
    sent = dict(_dist_util.p2p_stats)

    def route(msg, lstage, tag, local, sends):
        """``msg`` to logical stage ``lstage``: a send, or at one stage the
        next tick's input of chunk ``lstage``."""
        peer, chunk = lstage % n, lstage // n
        if peer == s:
            local[chunk] = msg
        else:
            sends.append((msg, peer, tag + 2 * chunk))
    for t in range(stats["ticks"]):
        sends, recvs = [], []
        local_f: Dict[int, torch.Tensor] = {}
        local_b: Dict[int, torch.Tensor] = {}
        for c in range(v):
            ls = c * n + s                # this chunk's logical stage
            mf = t - ls                   # the forward lane's microbatch
            if not 0 <= mf < M:
                continue
            h_in = embed_fn(x_stack[mf], mf) if ls == 0 else fwd_in[c].requires_grad_()
            h_out = stage_fn(h_in, mf, c)
            lossv = None
            if ls == nv - 1:
                lossv = head_loss_fn(h_out, y_stack[mf], mf)
                part = lossv.detach().float()
                loss_sum = part if loss_sum is None else loss_sum + part
            else:
                route(h_out.detach(), ls + 1, FWD_TAG, local_f, sends)
            stash[c][mf] = (h_in, h_out, lossv)
            stats["max_in_flight"] = max(stats["max_in_flight"], len(stash[c]))
        for c in range(v):
            ls = c * n + s
            mb = t - 2 * (nv - 1) + ls    # the backward lane's microbatch
            if not 0 <= mb < M:
                continue
            h_in, h_out, lossv = stash[c].pop(mb)
            inputs = params if ls == 0 else params + [h_in]
            if not inputs:              # stage 0 with every parameter frozen
                got = []
            elif lossv is not None:
                got = torch.autograd.grad(lossv * loss_scale, inputs, allow_unused=True)
            else:
                got = torch.autograd.grad(h_out, inputs, bwd_in[c], allow_unused=True)
            pairs = [(b, g) for b, g in zip(grads, got) if g is not None]
            if pairs:
                torch._foreach_add_([b for b, _ in pairs], [g for _, g in pairs])
            if ls > 0:
                route(got[-1], ls - 1, BWD_TAG, local_b, sends)
            del got, h_in, h_out, lossv
        # the next tick's inputs: what the peers sent at this one
        fwd_in, bwd_in = [None] * v, [None] * v
        for c in range(v):
            ls = c * n + s
            if ls > 0 and 0 <= t + 1 - ls < M:
                peer = (ls - 1) % n
                if peer == s:
                    fwd_in[c] = local_f.pop(c)
                else:
                    fwd_in[c] = torch.empty(act_meta[0], dtype=act_meta[1], device=act_meta[2])
                    recvs.append((fwd_in[c], peer, FWD_TAG + 2 * c))
            if ls < nv - 1 and 0 <= t + 1 - 2 * (nv - 1) + ls < M:
                peer = (ls + 1) % n
                if peer == s:
                    bwd_in[c] = local_b.pop(c)
                else:
                    bwd_in[c] = torch.empty(act_meta[0], dtype=act_meta[1], device=act_meta[2])
                    recvs.append((bwd_in[c], peer, BWD_TAG + 2 * c))
        _exchange(sends, recvs, group)
    stats.update({k: _dist_util.p2p_stats[k] - sent[k] for k in ("sends", "bytes")})
    if loss_sum is None:
        dev = act_meta[2] if act_meta is not None else None
        loss_sum = torch.zeros((), dtype=torch.float32, device=dev)
    return loss_sum, stats


def _dropouts(block):
    """The Dropout layers under ``block``."""
    from ..gluon.nn import Dropout
    return [m for m in block.modules() if isinstance(m, Dropout)]


def _add_comm(comm: dict, sign: int) -> None:
    """Add (``sign`` 1) or take back (-1) a step's ``last_stats["comm"]``
    in ``_dist_util.comm_stats``."""
    for name, c in comm.items():
        op, axis = name.split("@", 1)
        _dist_util.count_comm(op, axis, sign * c["bytes"], calls=sign * c["calls"])


def _aux_blocks(block) -> List[str]:
    """The BatchNorm layers under ``block``: the port's blocks that write aux
    state (running statistics) in a training forward."""
    from ..gluon.nn import BatchNorm
    return [type(m).__name__ for m in block.modules() if isinstance(m, BatchNorm)]


class _Leaf:
    """One leaf of the step: ``param`` the Gluon Parameter; ``x`` the tensor
    the schedule differentiates (the Parameter's own tensor, or the local
    view shard of a partitioned leaf); ``w`` the tensor the update writes
    (``x``, or this rank's shard of a weight-sharded leaf); ``dim`` the
    dimension of ``w``'s storage split over tp (None: replicated); ``grad``
    the gradient buffer of ``x``; ``gshard`` the contiguous gradient of
    ``w`` when it is not ``grad``; ``state`` the optimizer state of ``w``."""

    __slots__ = ("param", "x", "w", "dim", "grad", "gshard", "state", "trainable",
                 "tp_sum")

    def __init__(self, param, x, w, dim, trainable):
        self.param, self.x, self.w, self.dim = param, x, w, dim
        self.trainable = trainable
        self.grad = self.gshard = None
        self.state = ()
        self.tp_sum = False


def _stacks(keys) -> List[List[int]]:
    """The positions of an update list grouped by stack key (None: alone)."""
    out: Dict[object, List[int]] = {}
    for pos, key in enumerate(keys):
        out.setdefault(("own", pos) if key is None else key, []).append(pos)
    return list(out.values())


class PipelineTrainer:
    """The pipeline trainer over a ``pp`` axis of a mesh of ranks, with
    optional ``dp`` and ``tp`` axes; see the module docstring. ``net``
    exposes ``pipeline_split() -> (embed, cells, head)``; ``loss`` is a Gluon
    ``Loss`` or a callable ``(pred, label) -> per-sample loss`` on tensors
    (its mean is the microbatch's loss). ``schedule`` is ``"1f1b"`` (the
    default, ``MXNET_TPU_PP_SCHEDULE``; ``virtual_stages`` chunks a stage)
    or ``"gpipe"`` (``remat``)."""

    def __init__(self, net, loss, optimizer="sgd", optimizer_params=None, mesh=None,
                 num_microbatch: Optional[int] = None, pp_axis: str = "pp",
                 dp_axis: Optional[str] = None, tp_axis: Optional[str] = None,
                 tp_mode: str = "sharded", sequence_parallel: bool = False, dtype=None,
                 remat: bool = True, schedule: Optional[str] = None, virtual_stages: int = 1,
                 zero_update: Optional[bool] = None, bucket_bytes: Optional[int] = None,
                 comm_dtype=None):
        self.net = net
        self.loss = loss
        self.mesh = mesh if mesh is not None else current_mesh()
        self.n_stages = require_axis(self.mesh, pp_axis, "pipeline stages")
        self.pp_axis, self.dp_axis, self.tp_axis = pp_axis, dp_axis, tp_axis
        self.n_dp = require_axis(self.mesh, dp_axis, "data parallelism") if dp_axis else 1
        self.n_tp = require_axis(self.mesh, tp_axis, "tensor parallelism") if tp_axis else 1
        if tp_mode not in ("sharded", "partitioned"):
            raise MXNetError(f"unknown tp_mode {tp_mode!r}; use 'sharded' (per-step weight "
                             f"gather) or 'partitioned' (compute-partitioned Megatron "
                             f"collectives)")
        if tp_mode == "partitioned" and tp_axis is None:
            raise MXNetError("tp_mode='partitioned' requires a tp_axis")
        self.tp_mode = tp_mode
        self._partitioned = tp_axis is not None and tp_mode == "partitioned"
        self._sharded = tp_axis is not None and not self._partitioned
        self.sequence_parallel = bool(sequence_parallel)
        if self.sequence_parallel and not self._partitioned:
            raise MXNetError("sequence_parallel shards the non-matmul regions over the tp "
                             "device group; it requires tp_mode='partitioned'")
        self.remat = bool(remat)
        if schedule is None:
            schedule = env.get("MXNET_TPU_PP_SCHEDULE") or "1f1b"
        if schedule not in ("1f1b", "gpipe"):
            raise MXNetError(f"unknown pipeline schedule {schedule!r}; use '1f1b' or 'gpipe'")
        self.schedule = schedule
        self.virtual_stages = int(virtual_stages)
        if self.virtual_stages < 1:
            raise MXNetError("virtual_stages must be >= 1")
        if self.virtual_stages > 1 and schedule != "1f1b":
            raise MXNetError("virtual_stages (interleaved schedule) requires schedule='1f1b'")
        if self._partitioned and schedule != "1f1b":
            raise MXNetError("tp_mode='partitioned' runs its manual collectives inside the "
                             "1F1B tick body; schedule='gpipe' (grad-of-scan) only supports "
                             "weight-sharded tp")

        if not hasattr(net, "pipeline_split"):
            raise MXNetError(f"{type(net).__name__} has no pipeline_split(); implement it "
                             f"returning (embed_block, identical_cells, head_block)")
        embed, cells, head = net.pipeline_split()
        if len(cells) % (self.n_stages * self.virtual_stages) != 0:
            raise MXNetError(f"{len(cells)} layers do not divide into {self.n_stages} "
                             f"pipeline stages x {self.virtual_stages} virtual chunks")
        self._embed, self._cells, self._head = embed, list(cells), head
        self.n_layers = len(cells)
        self.layers_per_stage = self.n_layers // self.n_stages

        def _plist(block):
            ps = list(block.collect_params().values())
            if any(p._param is None for p in ps):
                raise MXNetError("net has uninitialized parameters; run one eager forward "
                                 "before PipelineTrainer")
            return ps

        self._embed_plist = _plist(embed)
        self._head_plist = _plist(head)
        self._cell_plists = [_plist(c) for c in cells]
        ref = self._cell_plists[0]
        for j, cp in enumerate(self._cell_plists[1:], 1):
            if len(cp) != len(ref) or any(a._param.shape != b._param.shape or
                                          a._param.dtype != b._param.dtype
                                          for a, b in zip(cp, ref)):
                raise MXNetError(f"cell {j} is not structurally identical to cell 0; "
                                 f"pipeline stages must be homogeneous")
        self._tr_e = [p.grad_req != "null" for p in self._embed_plist]
        self._tr_h = [p.grad_req != "null" for p in self._head_plist]
        self._tr_s = [p.grad_req != "null" for p in ref]
        for cp in self._cell_plists[1:]:
            for i, p in enumerate(cp):
                if (p.grad_req != "null") != self._tr_s[i]:
                    raise MXNetError(f"cell param {ref[i].name!r} is frozen in some layers "
                                     f"but not others; freeze a stacked leaf uniformly "
                                     f"across cells")
        for what, blocks in (("embed block", [embed]), ("cell", cells), ("head block", [head])):
            aux = [n for b in blocks for n in _aux_blocks(b)]
            if aux:
                raise MXNetError(f"pipeline {what} emits mutable aux state (BN running stats: "
                                 f"{aux[0]}); pipeline stages must be stateless")

        # each leaf's layout: the layer plans (partitioned; Parameter.sharding
        # is not read), or the dim its spec shards over tp (weight-sharded)
        nE, nS, nH = len(self._embed_plist), len(ref), len(self._head_plist)
        self._lay_e, self._lay_s, self._lay_h = [None] * nE, [None] * nS, [None] * nH
        if self._partitioned:
            self._eplan = _mg.plan_embed(embed, self._embed_plist, self.n_tp)
            self._cplan = _mg.plan_cell(cells[0], ref, self.n_tp)
            self._hplan = _mg.plan_head(head, self._head_plist, self.n_tp)
            self._lay_e = list(self._eplan.layouts)
            self._lay_s = list(self._cplan.layouts)
            self._lay_h = list(self._hplan.layouts)
            self._tp_e = [_mg.view_shard_dim(lay) for lay in self._lay_e]
            self._tp_s = [_mg.view_shard_dim(lay) for lay in self._lay_s]
            self._tp_h = [_mg.view_shard_dim(lay) for lay in self._lay_h]
            self._validate_partitioned_loss()
        elif tp_axis is not None:
            self._tp_e = [tp_shard_dim(p.sharding, tp_axis) for p in self._embed_plist]
            self._tp_h = [tp_shard_dim(p.sharding, tp_axis) for p in self._head_plist]
            self._tp_s = [tp_shard_dim(p.sharding, tp_axis) for p in ref]
            for cp in self._cell_plists[1:]:
                for i, p in enumerate(cp):
                    if tp_shard_dim(p.sharding, tp_axis) != self._tp_s[i]:
                        raise MXNetError(f"cell param {ref[i].name!r} carries different tp "
                                         f"specs across cells; stacked leaves must shard "
                                         f"uniformly")
        else:
            self._tp_e, self._tp_s, self._tp_h = [None] * nE, [None] * nS, [None] * nH
        # storage (view) shapes: the logical ones but for a blocked layout
        self._view_e = [_mg.view_shape(tuple(p.shape), lay)
                        for p, lay in zip(self._embed_plist, self._lay_e)]
        self._view_s = [_mg.view_shape(tuple(p.shape), lay) for p, lay in zip(ref, self._lay_s)]
        self._view_h = [_mg.view_shape(tuple(p.shape), lay)
                        for p, lay in zip(self._head_plist, self._lay_h)]
        for views, dims, plist in ((self._view_e, self._tp_e, self._embed_plist),
                                   (self._view_h, self._tp_h, self._head_plist),
                                   (self._view_s, self._tp_s, ref)):
            for vshape, d, p in zip(views, dims, plist):
                if d is not None and vshape[d] % self.n_tp != 0:
                    raise MXNetError(f"{p.name!r} {'partitioned ' if self._partitioned else ''}"
                                     f"dim {d} ({vshape[d]}) does not divide by "
                                     f"tp={self.n_tp}")

        self.compute_dtype: Optional[torch.dtype] = None
        if dtype is not None and torch_dtype(dtype) != torch.float32:
            self.compute_dtype = torch_dtype(dtype)
            if self.compute_dtype != torch.bfloat16:
                raise MXNetError(f"PipelineTrainer supports float32/bfloat16, got {dtype!r}")
        self.optimizer = optimizer if isinstance(optimizer, opt_mod.Optimizer) \
            else opt_mod.create(optimizer, **(optimizer_params or {}))
        self._init_fn, self._update_fn, self._hyper_fn = functional_optimizer(self.optimizer)
        if tp_axis is not None:
            refuse_trust_ratio(self.optimizer, "tp")      # reference :473-476
        self.num_microbatch = int(num_microbatch if num_microbatch is not None
                                  else self.n_stages)
        if zero_update is None:
            zero_update = bool(env.get("MXNET_TPU_ZERO"))
        self._zero = bool(zero_update)
        self._bucket_bytes = int(bucket_bytes if bucket_bytes is not None
                                 else env.get("MXNET_TPU_BUCKET_BYTES"))
        if comm_dtype is None:
            comm_dtype = env.get("MXNET_TPU_COMM_DTYPE") or None
        self._comm_dtype = _zero.canonical_comm_dtype(comm_dtype) if self._zero else None
        if self._zero:
            self._validate_zero()
        self.device = self.mesh.device
        everything = self._embed_plist + self._head_plist + [p for cp in self._cell_plists
                                                             for p in cp]
        elsewhere = [p.name for p in everything if p.list_ctx()[0] != self.device]
        if elsewhere:
            raise MXNetError(f"parameters {elsewhere[:3]} are not on the mesh's device "
                             f"{self.device}")

        # this rank's stage; the schedule order of the layers (reference
        # :480-486: row s L + c Lc + j holds layer (c pp + s) Lc + j; v = 1
        # the identity) and this stage's rows of it
        self.stage = self.mesh.axis_index(pp_axis)
        L, v = self.layers_per_stage, self.virtual_stages
        Lc = L // v
        self._stack_order = [(c * self.n_stages + s) * Lc + j for s in range(self.n_stages)
                             for c in range(v) for j in range(Lc)]
        self._own = self._stack_order[self.stage * L:(self.stage + 1) * L]
        first, last = self.stage == 0, self.stage == self.n_stages - 1
        # weight-decay indices: embed leaves, then the cell leaves, then the head
        self._wd_e = [self.optimizer._get_wd(i) for i in range(nE)]
        self._wd_s = [self.optimizer._get_wd(nE + i) for i in range(nS)]
        self._wd_h = [self.optimizer._get_wd(nE + nS + i) for i in range(nH)]

        dist_mesh = self.mesh.distributed
        self._tp_idx = self.mesh.axis_index(tp_axis) if tp_axis else 0
        self._leaves_e = [self._make_leaf(p, lay, d, v, t) for p, lay, d, v, t in zip(
            self._embed_plist, self._lay_e, self._tp_e, self._view_e, self._tr_e)]
        self._leaves_h = [self._make_leaf(p, lay, d, v, t) for p, lay, d, v, t in zip(
            self._head_plist, self._lay_h, self._tp_h, self._view_h, self._tr_h)]
        self._leaves_s = [[self._make_leaf(self._cell_plists[m][i], self._lay_s[i],
                                           self._tp_s[i], self._view_s[i], self._tr_s[i])
                           for i in range(nS)] for m in self._own]
        # gradient buffers: views into flat buffers, one for each set of axes
        # the gradients are summed over (the embed and head over pp and dp,
        # the stage's layers over dp; under partitioned tp a replicated leaf
        # over tp too, its partial sums; under ZeRO dp leaves the all-reduce
        # for the buckets' reduce-scatter)
        rep = [lf for lf in self._leaves_e + self._leaves_h if lf.trainable]
        own = [lf for row in self._leaves_s for lf in row if lf.trainable]
        for lf in rep + own:
            lf.tp_sum = self._partitioned and self.n_tp > 1 and lf.dim is None
        dp = () if self._zero else (dp_axis,)
        self._flats: List[Tuple[torch.Tensor, Optional[tuple]]] = []
        for leaves, axes in ((rep, (pp_axis,) + dp), (own, dp)):
            for tp_sum in (False, True):
                part = [lf for lf in leaves if lf.tp_sum == tp_sum]
                flat = self._flat_grads(part)
                if flat is not None:
                    ax = tuple(a for a in axes + ((tp_axis,) if tp_sum else ()) if a)
                    self._flats.append((flat, ax if dist_mesh and ax and
                                        self.mesh.group_size(ax) > 1 else None))
        # what the schedule differentiates on this stage
        self._train = [lf for row in self._leaves_s for lf in row if lf.trainable] + \
            ([lf for lf in self._leaves_e if lf.trainable] if first else []) + \
            ([lf for lf in self._leaves_h if lf.trainable] if last else [])
        self._used = (self._embed_plist if first else []) + \
            [self._cell_plists[m][i] for m in self._own for i in range(nS)] + \
            (self._head_plist if last else [])
        self._gather_leaves = [lf for lf in (self._leaves_e if first else []) +
                               [lf for row in self._leaves_s for lf in row] +
                               (self._leaves_h if last else []) if lf.dim is not None]
        # optimizer state and each weight decay's update lists (weights,
        # gradients, states): whole leaves, or under ZeRO the pieces of this
        # rank's shard of each bucket
        self._groups: Dict[float, Tuple[list, list, list]] = {}
        # each entry's stack: the stage's copies of one cell parameter share
        # one (LAMB's and LARS's norm over them, the reference's stacked
        # leaf); every other entry has its own
        self._stack_keys: Dict[float, list] = {}
        self._zbuckets: Dict[str, list] = {"e": [], "s": [], "h": []}
        self._zplan_e = self._zplan_s = self._zplan_h = ()
        if self._zero:
            self._init_zero_state()
        else:
            for lf, wd, key in [*((lf, wd, None) for lf, wd in zip(self._leaves_e, self._wd_e)),
                                *((lf, wd, None) for lf, wd in zip(self._leaves_h, self._wd_h)),
                                *((lf, self._wd_s[i], i) for row in self._leaves_s
                                  for i, lf in enumerate(row))]:
                if lf.trainable:
                    lf.state = self._init_fn(lf.w.detach())
                    self._add(wd, lf.w, lf.gshard if lf.gshard is not None else lf.grad,
                              lf.state, key)
        self._stacks = {wd: _stacks(keys) for wd, keys in self._stack_keys.items()}
        self._opt_e = [lf.state for lf in self._leaves_e]

        self._pp_group = self.mesh.group(pp_axis) if dist_mesh and self.n_stages > 1 else None
        rep_axes = tuple(a for a in (pp_axis, dp_axis) if a is not None)
        self._rep_group = self.mesh.group(rep_axes) if dist_mesh and \
            self.mesh.group_size(rep_axes) > 1 else None
        if self._pp_group is not None:
            # every rank of the pp group takes part in its first collective
            # (NCCL sets its communicator up there), before the first tick's
            # point-to-point round, which joins two of them only
            dist.all_reduce(torch.zeros(1, device=self.device.torch_device),
                            group=self._pp_group)
        self._seed = 0
        if self._partitioned:
            # the dropout seed of the partitioned programs: one for the mesh
            self._seed = self._draw_seed()
            if dist_mesh and self.mesh.size > 1:
                seed = torch.tensor([self._seed], dtype=torch.int64,
                                    device=self.device.torch_device)
                dist.broadcast(seed, src=0, group=self.mesh.group(self.mesh.axis_names))
                self._seed = int(seed.item())
            self._pcfg = _mg.PartitionConfig(axis=tp_axis, n_tp=self.n_tp,
                                             sp=self.sequence_parallel and self.n_tp > 1,
                                             mesh=self.mesh)
            self._release_partitioned()
        self._hyper = torch.zeros((max(1, len(self._groups)), len(self._hyper_fn.fields)),
                                  dtype=torch.float32, device=self.device.torch_device)
        self._t = 0
        self._act_meta: Dict[tuple, tuple] = {}
        self.last_stats: Optional[dict] = None
        self._graphs: Dict[tuple, _StepGraph] = {}
        # the in-flight window (reference :575), each signature's FLOPs
        # (engine.count_once: at a captured step's warm-up, or at an eager
        # step's first with telemetry on) and comm estimates
        self._window = _feed.DispatchWindow(name="pp")
        self._flops: Dict[tuple, float] = {}
        self._comm_est: Dict[tuple, dict] = {}
        # why the step runs eagerly every time, None to capture it; the tests
        # and chip_smoke set it to a string to run the same trainer eagerly
        self._graph_reason = self._eager_reason()
        self._program = StepProgram(f"pp.step[{type(net).__name__}]", (
            "pp_step", structural_fingerprint(net), config_fingerprint(
                optimizer=type(self.optimizer).__name__,
                opt_conf=tuple(sorted(
                    (k, repr(v)) for k, v in vars(self.optimizer).items()
                    if isinstance(v, (int, float, bool, str, type(None))))),
                wds=tuple(float(w) for w in self._wd_e + self._wd_s + self._wd_h),
                loss=self.loss, mesh=tuple(sorted(self.mesh.shape.items())),
                axis_order=self.mesh.axis_names, pp_axis=pp_axis, dp_axis=dp_axis,
                tp_axis=tp_axis, schedule=self.schedule, remat=self.remat,
                virtual_stages=self.virtual_stages, num_microbatch=self.num_microbatch,
                trainable=(tuple(self._tr_e), tuple(self._tr_s), tuple(self._tr_h)),
                tp_dims=(tuple(self._tp_e), tuple(self._tp_s), tuple(self._tp_h)),
                tp_mode=self.tp_mode, sequence_parallel=self.sequence_parallel,
                tp_layouts=((tuple(self._lay_e), tuple(self._lay_s), tuple(self._lay_h))
                            if self._partitioned else None),
                compute_dtype=str(self.compute_dtype), zero=self._zero,
                bucket_bytes=self._bucket_bytes if self._zero else None,
                comm_dtype=self._comm_dtype)))

    def _eager_reason(self) -> Optional[str]:
        """Why the step runs eagerly every time, or None to capture it (the
        module docstring, "The compiled step"): ``"cpu"``, ``"gloo"``,
        ``"keyed_dropout"`` or ``"remat_dropout"``."""
        if self.device.device_type != "gpu":
            return "cpu"
        if self.mesh.distributed and any(dist.get_backend(g) != "nccl"
                                         for g in self.mesh._groups.values()):
            return "gloo"
        if self._partitioned and (self._eplan.dropout or self._cplan.attn_dropout
                                  or self._cplan.ffn_dropout):
            return "keyed_dropout"
        if self.schedule == "gpipe" and self.remat and not self._partitioned and any(
                m._rate > 0 for b in [self._embed, *self._cells, self._head]
                for m in _dropouts(b)):
            return "remat_dropout"
        return None

    @property
    def captured(self) -> bool:
        """Whether this trainer's steps run as captured CUDA graphs."""
        return self._graph_reason is None

    # -- construction helpers --------------------------------------------------
    def _validate_partitioned_loss(self):
        """The partitioned head fuses the decoder into the vocab-parallel cross
        entropy, so the loss must be the mean token cross entropy (reference
        :619-644)."""
        from ..gluon.loss import SoftmaxCrossEntropyLoss
        lo = self.loss
        if isinstance(lo, SoftmaxCrossEntropyLoss):
            if (getattr(lo, "_sparse_label", True) and not getattr(lo, "_from_logits", False)
                    and getattr(lo, "_axis", -1) in (-1,)
                    and getattr(lo, "_weight", None) is None):
                return
            raise MXNetError("tp_mode='partitioned' fuses the LM head into a vocab-parallel "
                             "softmax cross-entropy; SoftmaxCrossEntropyLoss must use "
                             "sparse_label=True, from_logits=False, axis=-1, weight=None")
        if getattr(lo, "__name__", "") == "token_cross_entropy":
            return
        raise MXNetError("tp_mode='partitioned' supports mean token cross-entropy losses "
                         "only (gluon SoftmaxCrossEntropyLoss or "
                         "recipes.long_context.token_cross_entropy); got "
                         f"{type(lo).__name__}")

    def _validate_zero(self):
        """The reference's ``_validate_zero`` (:647-663)."""
        if self.dp_axis is None:
            raise MXNetError("zero_update requires a dp_axis: the sharded update "
                             "distributes over data-parallel replicas")
        if self._sharded:
            raise MXNetError("zero_update and weight-sharded tp_axis do not compose in "
                             "PipelineTrainer (the gathered weights would defeat the sharded "
                             "state); tp_mode='partitioned' composes: its optimizer state "
                             "covers each rank's tp shards")
        refuse_trust_ratio(self.optimizer, "zero")

    def _draw_seed(self) -> int:
        """A dropout seed for the partitioned programs, from the port's host
        generator."""
        from .. import random as _rng
        return int(torch.randint(0, 2 ** 62, (1,), generator=_rng.generator("cpu")).item())

    def _make_leaf(self, p, layout, dim, view, trainable) -> _Leaf:
        """This rank's leaf of Parameter ``p`` (see ``_Leaf``)."""
        full = p._param
        if dim is None:
            return _Leaf(p, full, full, None, trainable)
        if self._sharded:
            shard = shard_tensor(full.detach(), _tp_spec(dim, full.dim(), self.tp_axis),
                                 self.mesh).clone(memory_format=torch.contiguous_format)
            lf = _Leaf(p, full, shard, dim, trainable)
            if trainable:
                lf.gshard = torch.zeros_like(shard)
            return lf
        # partitioned: the local view shard, a view of the Parameter at tp 1
        if self.n_tp == 1:
            local = full.detach().view(view)
        else:
            local = shard_tensor(full.detach().reshape(view),
                                 _tp_spec(dim, len(view), self.tp_axis),
                                 self.mesh).clone(memory_format=torch.contiguous_format)
        local.requires_grad_(trainable)
        return _Leaf(p, local, local, dim, trainable)

    def _release_partitioned(self):
        """At tp > 1 the Parameters of partitioned leaves keep no storage
        between ``sync()`` calls: the leaves hold this rank's shards, and
        ``sync()`` gathers the full weights back."""
        if self.n_tp == 1:
            return
        for lf in self._all_leaves():
            if lf.dim is not None and lf.param._param.numel():
                lf.param._param.data = lf.param._param.data.new_empty((0,))
                lf.param._grad = None
        engine.note_storage_change()

    def _all_leaves(self):
        return self._leaves_e + self._leaves_h + [lf for row in self._leaves_s for lf in row]

    def _add(self, wd, w, g, state, key=None):
        ws, gs, ss = self._groups.setdefault(float(wd), ([], [], []))
        ws.append(w)
        gs.append(g)
        ss.append(state)
        self._stack_keys.setdefault(float(wd), []).append(key)

    def _flat_grads(self, leaves) -> Optional[torch.Tensor]:
        """One flat buffer whose views, 64 elements apart, become the gradient
        buffers of ``leaves`` (the Parameters' own ``_grad`` where the leaf is
        the Parameter's tensor)."""
        if not leaves:
            return None
        align = 64
        counts = [-(-lf.x.numel() // align) * align for lf in leaves]
        flat = torch.zeros(sum(counts), dtype=leaves[0].x.dtype,
                           device=self.device.torch_device)
        off = 0
        for lf, n in zip(leaves, counts):
            if lf.x.dtype != flat.dtype:
                raise MXNetError(f"{lf.param.name} is {lf.x.dtype}, the other trained "
                                 f"parameters {flat.dtype}")
            lf.grad = flat[off:off + lf.x.numel()].view(lf.x.shape)
            if lf.x is lf.param._param:
                lf.param._grad = lf.grad
                autograd._mark(lf.param._param, lf.grad, lf.param.grad_req)
            off += n
        return flat

    def _init_zero_state(self):
        """ZeRO over dp (reference :665-791): the embed's, the stage's and the
        head's trainable floating leaves planned into flat buckets over their
        local shapes (the stage's stacked as (L, ...), tp-local view shapes
        under partitioned tp); this rank keeps the reduced gradient and the
        optimizer state of its 1/dp shard of each bucket, cut at leaf (and
        layer) boundaries into pieces that join the update's lists."""
        ndp = self.n_dp
        pos = self.mesh.axis_index(self.dp_axis) if self.mesh.distributed else 0
        dev = self.device.torch_device
        L = self.layers_per_stage

        def entries(leaves, stacked):
            return [(i, ((L,) if stacked else ()) + tuple(lf.w.shape), lf.w.dtype)
                    for i, lf in enumerate(leaves) if lf.trainable and lf.w.is_floating_point()]

        groups = (("e", [[lf] for lf in self._leaves_e], self._wd_e, False),
                  ("s", [[row[i] for row in self._leaves_s]
                         for i in range(len(self._wd_s))], self._wd_s, True),
                  ("h", [[lf] for lf in self._leaves_h], self._wd_h, False))
        for tag, members, wds, stacked in groups:
            plan = _zero.plan_buckets(entries([m[0] for m in members], stacked), ndp,
                                      self._bucket_bytes)
            setattr(self, f"_zplan_{tag}", plan)
            for b in plan:
                dtype = members[b.indices[0]][0].w.dtype
                wshard = torch.zeros(b.shard_size, dtype=dtype, device=dev)
                zb = {"spec": b, "members": [members[i] for i in b.indices],
                      "stacked": stacked,
                      "gshard": torch.zeros(b.shard_size, dtype=dtype, device=dev),
                      "wshard": wshard, "state": self._init_fn(wshard), "pieces": []}
                lo, hi = pos * b.shard_size, (pos + 1) * b.shard_size
                for i, o in zip(b.indices, b.offsets):
                    for j, lf in enumerate(members[i]):
                        n = lf.w.numel()
                        a, e = max(o + j * n, lo), min(o + (j + 1) * n, hi)
                        if a >= e:
                            continue
                        piece = slice(a - lo, e - lo)
                        w = lf.w.detach().view(-1)[a - o - j * n:e - o - j * n]
                        zb["pieces"].append((w, zb["wshard"][piece]))
                        self._add(wds[i], w, zb["gshard"][piece],
                                  tuple(st[piece] for st in zb["state"]))
                self._zbuckets[tag].append(zb)

    # -- the step --------------------------------------------------------------
    def _raw(self, a) -> torch.Tensor:
        t = a._data if isinstance(a, NDArray) else torch.as_tensor(np.asarray(a))
        return t.to(self.device.torch_device)

    def _loss_mean(self, pred: NDArray, label: torch.Tensor) -> torch.Tensor:
        return DataParallelTrainer._loss_mean(self, pred, label)

    def _stack(self, t: torch.Tensor) -> torch.Tensor:
        """``(M, B/(M dp), ...)``: the microbatches of this rank's dp slice."""
        M = self.num_microbatch
        t = t.reshape((M, t.shape[0] // M) + tuple(t.shape[1:]))
        if self.n_dp > 1:
            n = t.shape[1] // self.n_dp
            d = self.mesh.axis_index(self.dp_axis)
            t = t[:, d * n:(d + 1) * n]
        return t.contiguous()

    def _key(self, *parts) -> tuple:
        """The dropout key of a program call: the same on every tp rank of
        this stage, distinct across steps, stages, dp ranks, layers and
        microbatches (the reference folds the same coordinates, :838-846)."""
        dp = self.mesh.axis_index(self.dp_axis) if self.dp_axis else 0
        return (self._seed, self._t, self.stage, dp) + parts

    def _low(self, leaves):
        cdt = self.compute_dtype
        return [lf.x.to(cdt) if cdt is not None and lf.x.is_floating_point() else lf.x
                for lf in leaves]

    def _embed_fn(self, x, m):
        if self._partitioned:
            return _mg.embed_forward(self._eplan, self._pcfg, self._low(self._leaves_e), x,
                                     self._key(10_000, m))
        return self._embed(NDArray(x, self.device))._data

    def _stage_fn(self, h, m, c=0):
        """Chunk ``c`` of this stage's layers (all of them at v = 1) on
        microbatch ``m``."""
        Lc = self.layers_per_stage // self.virtual_stages
        rows = range(c * Lc, (c + 1) * Lc)
        if self._partitioned:
            for j in rows:
                h = _mg.cell_forward(self._cplan, self._pcfg, self._low(self._leaves_s[j]), h,
                                     self._key(self._own[j], m))
            return h
        out = NDArray(h, self.device)
        for j in rows:
            out = self._cells[self._own[j]](out)
        return out._data

    def _head_loss_fn(self, h, y, m):
        if self._partitioned:
            return _mg.head_loss_forward(self._hplan, self._pcfg, self._low(self._leaves_h),
                                         h, y, self._key(10_001, m))
        return self._loss_mean(self._head(NDArray(h, self.device)), y)

    def _activation(self, xs) -> tuple:
        """``(shape, dtype, device)`` of one activation between stages. The
        shape of the embed's output on microbatch 0 in predict mode (no
        dropout draws), once for each batch signature, or under partitioned
        tp (B, T or T/tp under sp, units); the dtype the compute dtype where
        one is set (the reference's ``_ppermute_stats``, :404)."""
        key = (tuple(xs.shape), xs.dtype)
        if key not in self._act_meta:
            if self._partitioned:
                T = xs.shape[2] // (self.n_tp if self._pcfg.sp else 1)
                w = self._leaves_e[self._eplan.word_w].x
                self._act_meta[key] = ((xs.shape[1], T, self._eplan.units),
                                       self.compute_dtype or w.dtype, w.device)
            else:
                with torch.no_grad(), autograd.pause(train_mode=False):
                    a = self._embed_fn(xs[0], 0)
                self._act_meta[key] = (tuple(a.shape), self.compute_dtype or a.dtype,
                                       a.device)
        return self._act_meta[key]

    def _gather_sharded(self, leaves, what="tp_weight_all_gather"):
        """Weight-sharded tp: each sharded leaf's full weight all-gathered
        over tp into its Parameter, outside autograd (reference :854-858)."""
        for lf in leaves:
            if lf.dim is not None:
                full = gather_tp(lf.w, lf.dim, self.tp_axis, self.mesh)
                if full is not lf.w:
                    _dist_util.count_comm(what, self.tp_axis,
                                          lf.w.numel() * lf.w.element_size())
                lf.x.detach().copy_(full)

    def _forward_backward(self, xs, ys) -> torch.Tensor:
        """The schedule's pass over the microbatches: the loss mean of the
        global batch (every rank), the reduced gradients in the buffers."""
        M = self.num_microbatch
        cdt = self.compute_dtype
        with torch.no_grad():
            for flat, _ in self._flats:
                flat.zero_()
            if self._sharded:
                self._gather_sharded(self._gather_leaves)
        meta = self._activation(xs) if self.n_stages > 1 else None
        blocks = not self._partitioned
        try:
            with torch.enable_grad(), autograd.record(train_mode=True):
                if cdt is not None and blocks:
                    for p in self._used:
                        if p._param.is_floating_point():
                            p._compute = p._param.to(cdt)
                if self.schedule == "gpipe":
                    loss_sum, stats = self._gpipe(xs, ys, meta, 1.0 / (M * self.n_dp))
                else:
                    loss_sum, stats = schedule_1f1b(
                        self._embed_fn, self._stage_fn, self._head_loss_fn,
                        [lf.x for lf in self._train], [lf.grad for lf in self._train],
                        xs, ys, mesh=self.mesh if self.n_stages > 1 else None,
                        axis_name=self.pp_axis, n_chunks=self.virtual_stages,
                        act_meta=meta, loss_scale=1.0 / (M * self.n_dp))
        finally:
            if blocks:
                for p in self._used:
                    p._compute = None
        self.last_stats = stats
        with torch.no_grad():
            lossv = loss_sum.to(self.device.torch_device) / M
            if self._rep_group is not None:
                lossv = lossv / self.n_dp
                dist.all_reduce(lossv, group=self._rep_group)
            for flat, axes in self._flats:
                if axes is not None:
                    dist.all_reduce(flat, group=self.mesh.group(axes))
                    _dist_util.count_comm("grad_all_reduce", "+".join(axes),
                                          flat.numel() * flat.element_size())
        return lossv

    def _gpipe(self, xs, ys, meta, loss_scale):
        """GPipe's pass (reference :933-957): the embed of stage 0's M
        microbatches, ``pipeline_apply`` over the stages, the head and loss
        of each microbatch on the last stage; one ``autograd.grad`` of
        ``loss_scale`` times their sum (elsewhere of the output against a
        zero cotangent) runs the reversed ticks. Returns ``(loss_sum,
        stats)`` as ``schedule_1f1b`` does."""
        M, first, last = self.num_microbatch, self.stage == 0, \
            self.stage == self.n_stages - 1
        if first:
            h = torch.stack([self._embed_fn(xs[m], m) for m in range(M)])
        else:
            h = torch.zeros((M,) + tuple(meta[0]), dtype=meta[1], device=meta[2])
        if not h.requires_grad:         # the reversed ticks run on every stage
            h.requires_grad_()
        own = [lf.x for row in self._leaves_s for lf in row if lf.trainable]
        out, run = _pipeline_apply(lambda _, a, t: self._stage_fn(a, t - self.stage), own, h,
                                   self.mesh if self.n_stages > 1 else None, self.pp_axis,
                                   self.remat)
        leaves = [lf.x for lf in self._train] + [h]
        if last:
            total = None
            for m in range(M):
                lv = self._head_loss_fn(out[m], ys[m], m).float()
                total = lv if total is None else total + lv
            got = torch.autograd.grad(total * loss_scale, leaves, allow_unused=True)
            loss_sum = total.detach()
        else:
            got = torch.autograd.grad(out, leaves, torch.zeros_like(out), allow_unused=True)
            loss_sum = torch.zeros((), dtype=torch.float32, device=out.device)
        pairs = [(lf.grad, g) for lf, g in zip(self._train, got) if g is not None]
        if pairs:
            torch._foreach_add_([b for b, _ in pairs], [g for _, g in pairs])
        return loss_sum, run.stats

    def _reduce_zero(self):
        """Each bucket's gradient (the stage's stacked over its layers)
        reduce-scattered over dp in the wire dtype into this rank's shard."""
        for tag in ("e", "s", "h"):
            for zb in self._zbuckets[tag]:
                b = zb["spec"]
                grads = {i: torch.stack([lf.grad for lf in m]) if zb["stacked"] else m[0].grad
                         for i, m in zip(b.indices, zb["members"])}
                flat = _zero.flatten_bucket(b, grads)
                zb["gshard"].copy_(_zero.reduce_scatter_bucket(
                    flat, self.dp_axis, self.n_dp, self._comm_dtype, self.mesh))
                if self.n_dp > 1:
                    _dist_util.count_comm("zero_reduce_scatter", self.dp_axis,
                                          flat.numel() * flat.element_size())

    def _gather_zero(self):
        """Each bucket's updated shard all-gathered over dp into the leaves."""
        if self.n_dp == 1:
            return               # the shard is the bucket: updated in place
        for tag in ("e", "s", "h"):
            for zb in self._zbuckets[tag]:
                if zb["pieces"]:
                    torch._foreach_copy_([d for _, d in zb["pieces"]],
                                         [w for w, _ in zb["pieces"]])
                full = _zero.all_gather_bucket(zb["wshard"], self.dp_axis, self.mesh)
                _dist_util.count_comm("zero_all_gather", self.dp_axis,
                                      zb["wshard"].numel() * zb["wshard"].element_size())
                b = zb["spec"]
                dst, src = [], []
                for m, (i, view) in zip(zb["members"], _zero.unflatten_bucket(b, full)):
                    for j, lf in enumerate(m):
                        dst.append(lf.w.detach())
                        src.append(view[j] if zb["stacked"] else view)
                torch._foreach_copy_(dst, src)

    def _body(self, xs, ys) -> torch.Tensor:
        """The step's device work on the stacked microbatches: the schedule,
        the gradients' reductions and the update; ``last_stats`` gets the
        step's counts, its ``comm`` the collectives it issued. Returns the
        loss."""
        before = {k: list(v) for k, v in _dist_util.comm_stats.items()}
        with _Fold():     # hybridized blocks fold into the step, which counts their FLOPs
            lossv = self._forward_backward(xs, ys)
        with torch.no_grad():
            if self._sharded:
                for lf in self._all_leaves():
                    if lf.gshard is not None:
                        lf.gshard.copy_(slice_tp(lf.grad, lf.dim, self.tp_axis, self.mesh))
            if self._zero:
                self._reduce_zero()
            for k, (wd, (ws, gs, ss)) in enumerate(self._groups.items()):
                self._update_fn(ws, gs, ss, self._hyper[k], stacks=self._stacks.get(wd))
            if self._zero:
                self._gather_zero()
        comm = {}
        for key, (calls, nbytes) in _dist_util.comm_stats.items():
            c0, b0 = before.get(key, (0, 0))
            if calls > c0:
                comm["@".join(key)] = {"calls": calls - c0, "bytes": nbytes - b0}
        self.last_stats["comm"] = comm
        return lossv

    def _operand_ptrs(self):
        """The addresses a captured step reads: every leaf's tensors and
        gradient, and the Parameters the blocks compute with."""
        return (tuple((lf.x.data_ptr(), lf.w.data_ptr(),
                       lf.grad.data_ptr() if lf.grad is not None else 0)
                      for lf in self._all_leaves()),
                tuple(p._param.data_ptr() for p in self._used))

    def _graph_step(self, xs, ys) -> torch.Tensor:
        """The step on the card: warm up at a signature's first step (which
        also runs the embed's shape probe), capture at its second, replay
        from then on. A replay runs no Python of the step, so it sets
        ``last_stats`` (the tick loop's counts and ``comm``) to the captured
        step's and adds that step's collectives to ``comm_stats``, as the
        engine adds its launches to the kernels' counters and its sends to
        ``p2p_stats``."""
        sig = (tuple(xs.shape), xs.dtype, tuple(ys.shape), ys.dtype)
        key = ("pp_step", id(self), self._program.fingerprint, sig)
        entry = self._graphs.get(sig)
        graph = engine.lookup(key) if entry is not None else None
        if graph is None:
            if entry is None or entry.graph is not None:     # new, or its graph went stale
                self._graphs[sig] = _StepGraph()
                with engine.side_stream(self.device.torch_device):
                    return engine.count_once(self._flops, sig, self._body, xs, ys)
            entry.x, entry.y = xs.clone(), ys.clone()
            graph = entry.graph = engine.capture(
                lambda: (self._body(entry.x, entry.y),), key, self.device.torch_device,
                owner=self, ptrs=PipelineTrainer._operand_ptrs)
            entry.stats = copy.deepcopy(self.last_stats)
            _add_comm(entry.stats["comm"], -1)     # the capture ran nothing
        entry.x.copy_(xs)
        entry.y.copy_(ys)
        lossv = graph.replay()[0].clone()
        self.last_stats = copy.deepcopy(entry.stats)
        _add_comm(entry.stats["comm"], 1)
        return lossv

    def step(self, x, y) -> PendingScalar:
        """One training step of the schedule on the global batch ``x``, ``y``."""
        xr, yr = self._raw(x), self._raw(y)
        M, B = self.num_microbatch, xr.shape[0]
        self.optimizer.rescale_grad = 1.0
        if B % (M * self.n_dp) != 0:
            raise MXNetError(f"batch {B} must divide by num_microbatch*dp = {M}*{self.n_dp}")
        if self._partitioned and self.sequence_parallel and self.n_tp > 1 and \
                xr.dim() >= 2 and xr.shape[1] % self.n_tp != 0:
            raise MXNetError(f"sequence_parallel shards the sequence axis over tp: seq_len "
                             f"{xr.shape[1]} must divide by n_tp={self.n_tp}")
        xs, ys = self._stack(xr), self._stack(yr)
        self._t += 1
        self.optimizer.num_update = self._t
        lr = np.float32(self.optimizer.learning_rate)
        write_hyper(self._hyper, [self._hyper_fn(self._t, lr, wd) for wd in self._groups])
        sig = (tuple(xs.shape), xs.dtype, tuple(ys.shape), ys.dtype)
        with _telem.annotate("mx.pp.step"):
            if self._graph_reason is None:
                lossv = self._graph_step(xs, ys)
            elif _telem._ENABLED:   # an eager step: counted at its first with telemetry on
                lossv = engine.count_once(self._flops, sig, self._body, xs, ys)
            else:
                lossv = self._body(xs, ys)
        # telemetry after the window's admission: completion-paced, no sync
        self._window.admit(lossv)
        if _telem._ENABLED:
            self._record_telemetry(sig, tuple(xr.shape), B)
        return PendingScalar(lossv)

    def _record_telemetry(self, sig, x_shape, examples):
        """The reference's per-step comm estimates (``comm_estimate``; at pp
        above 1 also the embed's and head's gradient sum over pp), the
        optimizer state a rank holds, the signature's FLOPs and the step
        (reference :1243-1294, less the goodput bubble)."""
        est = self._comm_est.get(sig)
        if est is None:
            est = self._comm_est[sig] = self.comm_estimate(x_shape)
        axes = {"ppermute": "pp", "tp_act_psum": "tp", "tp_act_all_gather": "sp",
                "tp_act_psum_scatter": "sp", "tp_weight_all_gather": "tp",
                "reduce_scatter": "dp", "all_gather": "dp"}
        for op, (calls, nbytes) in est.items():
            _telem.record_comm(op, nbytes, store="mesh", calls=calls, axis=axes[op])
        if self.n_stages > 1:
            rep = sum(math.prod(lf.param.shape) * lf.x.element_size()
                      for lf in self._leaves_e + self._leaves_h)
            _telem.record_comm("pipeline_grad_psum", rep, store="mesh", axis="pp")
        _telem.record_optimizer_state(
            _zero.per_replica_state_bytes([ss for _, (_, _, ss) in self._groups.items()]),
            source="pipeline")
        flops = self._flops.get(sig, 0.0)
        engine.record_execution("step", flops)
        _telem.record_step(examples, source="pipeline", flops_per_step=flops or None,
                           lr=float(self.optimizer.learning_rate),
                           dispatch_wait_seconds=self._window.wait_seconds)

    def comm_estimate(self, x_shape) -> Dict[str, Tuple[int, int]]:
        """The reference's per-step estimates of this trainer's tensor-parallel
        and ZeRO collectives for a global batch of ``x_shape`` (B, T), summed
        over the pipeline's stages: ``{op: (calls, wire bytes)}`` under the
        reference's op names (``_record_partitioned_tp_telemetry``,
        :1180-1219: (tp - 1)/tp of one microbatch's activation per
        collective, M (4L + 2) all-reduces, or M (2L + 1) 2 all-gathers and as
        many reduce-scatters under sp; ``_record_zero_telemetry``,
        :1221-1231; the weight-sharded gather, :1258-1266), and at pp > 1 the
        schedule's activation hops (``_ppermute_stats``, :1146-1178): one
        v-stack of a microbatch's activation each way at each of M + pp v - 1
        ticks (GPipe) or M + 2(pp v - 1) (1F1B), a rank's share over dp."""
        B, T = int(x_shape[0]), int(x_shape[1])
        M, L, ntp = self.num_microbatch, self.n_layers, self.n_tp
        out: Dict[str, Tuple[int, int]] = {}
        if self.n_stages > 1:
            nv = self.n_stages * self.virtual_stages
            hops = M + nv - 1 if self.schedule == "gpipe" else M + 2 * (nv - 1)
            tokens = torch.zeros((M, B // (M * self.n_dp), T), dtype=torch.int32,
                                 device=self.device.torch_device)
            shape, dtype, _ = self._activation(tokens)
            act = math.prod(shape) * torch.empty((), dtype=dtype).element_size()
            out["ppermute"] = (2 * hops, act * self.virtual_stages * 2 * hops)
        if self._partitioned and ntp > 1:
            item = (self.compute_dtype or self._leaves_e[self._eplan.word_w].x.dtype).itemsize
            act = (B // M) * T * self._eplan.units // self.n_dp * item
            wire = act * (ntp - 1) // ntp
            if self.sequence_parallel:
                calls = M * (2 * L + 1) * 2
                out["tp_act_all_gather"] = (calls, wire * calls)
                out["tp_act_psum_scatter"] = (calls, wire * calls)
            else:
                calls = M * (4 * L + 2)
                out["tp_act_psum"] = (calls, wire * calls)
        elif self._sharded and ntp > 1:
            full = [lf.param for lf in self._leaves_e + self._leaves_h if lf.dim is not None]
            full += [p for cp in self._cell_plists for p, d in zip(cp, self._tp_s)
                     if d is not None]
            out["tp_weight_all_gather"] = (
                1, sum(math.prod(p.shape) * p._param.element_size() * (ntp - 1) // ntp
                       for p in full))
        if self._zero:
            plans = self._zplan_e + self._zplan_s + self._zplan_h
            n = len(plans)
            out["reduce_scatter"] = (n, _zero.reduce_scatter_wire_bytes(
                plans, self.n_dp, self._comm_dtype))
            out["all_gather"] = (n, _zero.all_gather_wire_bytes(plans, self.n_dp))
        return out

    def drain(self):
        """Wait until every step that was issued has finished on the device:
        the window's boundary sync, then the device's."""
        self._window.drain()
        if self.device.device_type == "gpu":
            torch.cuda.synchronize(self.device.torch_device)

    def sync(self):
        """Leave every weight in every rank's Parameters: the tp shards
        gathered (weight-sharded and partitioned leaves, the blocked views
        folded back to the logical shapes), then each cell leaf's layers
        all-gathered over pp from the stages that own them, unstacked
        through ``_stack_order`` (collectives every rank of the mesh calls). Under partitioned tp at tp > 1 this gives
        the Parameters their storage back."""
        self.drain()
        with torch.no_grad():
            for lf in self._all_leaves():
                if self._partitioned and self.n_tp > 1 and lf.dim is None:
                    # a replicated leaf's copies agree across tp up to a lossy
                    # wire's chunk scales (int8): tp rank 0's is the model's
                    group = self.mesh.group(self.tp_axis)
                    dist.broadcast(lf.w.detach(), dist.get_global_rank(group, 0), group=group)
                if lf.dim is None or (self._partitioned and self.n_tp == 1):
                    continue
                full = gather_tp(lf.w, lf.dim, self.tp_axis, self.mesh)
                p = lf.param
                if self._partitioned:
                    full = full.reshape(tuple(p.shape))
                    if p._param.shape != full.shape:
                        p._param.data = torch.empty_like(full)
                        p._init_grad()
                        engine.note_storage_change()
                p._param.detach().copy_(full)
            if self._pp_group is None:
                return
            L = self.layers_per_stage
            for i in range(len(self._cell_plists[0])):
                mine = torch.stack([self._cell_plists[m][i]._param.detach() for m in self._own])
                full = torch.empty((self.n_layers,) + tuple(mine.shape[1:]),
                                   dtype=mine.dtype, device=mine.device)
                dist.all_gather_into_tensor(full, mine, group=self._pp_group)
                for r, m in enumerate(self._stack_order):
                    if r // L != self.stage:
                        self._cell_plists[m][i]._param.detach().copy_(full[r])

    @property
    def num_update(self):
        return self._t

    def state_dict(self):
        """The training state in the elastic snapshot schema (kind ``pp``,
        ``elastic/state.py``), copied: later steps leave it as it is (the
        reference's leaves are immutable arrays)."""
        from ..elastic import state as _estate
        snap = _estate.capture(self)
        for name, v in snap["leaves"].items():
            if isinstance(v, _estate.Chunk):
                snap["leaves"][name] = _estate.Chunk(v.data.clone(), v.shape, v.index, v.owner)
        return snap

    def load_state_dict(self, snapshot):
        """Install a ``state_dict()`` (or a manifest's) snapshot: the stage
        rows of this rank, the embed and head, the optimizer state, then
        ``sync()``."""
        from ..elastic import state as _estate
        self.drain()
        leaves, meta = snapshot["leaves"], snapshot["meta"]
        _estate.install(self, meta, _estate.LeafFetch(leaves), set(leaves))
        return self


def _tp_spec(dim: int, ndim: int, axis: str):
    spec = [None] * ndim
    spec[dim] = axis
    return P(*spec)
