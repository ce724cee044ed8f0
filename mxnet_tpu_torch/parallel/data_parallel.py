"""The fused training step on one device: ``DataParallelTrainer``.

Counterpart of ``mxnet_tpu/parallel/data_parallel.py``: ``functional_optimizer``
(:51) and ``DataParallelTrainer`` (:276) with its step body
(``_make_apply_fn`` :237, ``_build_step`` :805), ``run_steps``, ``step``,
``drain``, ``sync`` and ``num_update`` (:1373-1567). The reference compiles
forward, backward and the update of every parameter into one jit, with lr,
t and the loss scale as device arguments (:805, :832, :1479-1492). Here the
step body (``_body``: forward, backward, the copy into the gradient
buckets, their all-reduce, the update) is written once. The update of
every parameter under SGD (and LBSGD, ccSGD) or Adam is one launch of the
fused multi-tensor kernel (``ops/cuda/fused_optimizer.py``, kernels K4 and
K5 of ``csrc/fused_optimizer.cu``) with the rules the reference's step
applies: ``sgd_update``, ``sgd_mom_update`` and ``adam_update`` with the
bias correction folded into lr (``_k_sgd``, ``_k_sgd_mom``, ``_k_adam``);
under AdamW, LAMB, LARS, NAG, RMSProp (not centered) and AdaGrad it is the
optimizer class's own ``_k_*`` rule in tensor ops, a tensor at a time (the
reference's rules are plain jnp in its jit: no Pallas kernel). The update
reads its scalars (lr, wd, the bias corrections, ..., one row a weight
decay, the fields the rule declares) from the trainer's ``_hyper`` tensor
on the device, which the host writes before each step, so a new learning
rate costs no new program.

The compiled step: on a CUDA device the body is captured as a CUDA graph
(``engine.capture``). Step 1 of a signature (the shapes and dtypes of x and
y) runs the body eagerly on the engine's side stream as the warm-up (it
builds the kernels, the update's pointer tables, cuBLAS's and autograd's
state, NCCL's communicator); step 2 captures the body over static buffers
(x, y, ``_hyper`` and the loss slot) and replays it; every later step
replays it. The host's work a step is then: copy x and y into the static
buffers, write ``_hyper`` for this step's lr and t (through a pinned
buffer, asynchronously; under float16 also ``_amp_gate``), replay, clone
the loss slot into the ``PendingScalar``. The float16 step is captured
like the others: its loss scale, its count of finite steps and its overflow
flag live in device memory, and the graph scales, checks, gates the update
and runs the scaler's policy (below) with no host read. One capture per signature and trainer (the key holds
``id(trainer)``, ``engine.cache_stats()`` counts them); a new lr or t
captures nothing. A parameter or gradient buffer given new storage since
the capture (the engine's ``storage_epoch``, then the addresses) drops the
graph, and the next step warms up again; the elastic restore writes in
place and keeps it. The kernels' launch counters count each replay
(``engine``). What runs the body eagerly every step (``_graph_reason``):

- ``"cpu"``: a CPU device, where the kernels' plain versions run (the same
  device ops as the graph, the float16 ones included);
- ``"gloo"``: a mesh of ranks whose groups are not all NCCL (gloo cannot
  be captured).

At world size 1 over NCCL the all-reduces (the replicated step's buckets,
ZeRO's sum over the data axes other than the batch axis, the loss, the
float16 overflow flag) are
captured into the graph as NCCL calls; ZeRO's reduce-scatter and all-gather
and the ring's sends are not issued at a degree of 1.
``_program`` does not record whether the step is captured: a snapshot of a
captured step restores into an eager trainer and back.

::

    trainer = mx.parallel.DataParallelTrainer(
        net, mx.gluon.loss.SoftmaxCrossEntropyLoss(), "sgd",
        {"learning_rate": 0.05, "momentum": 0.9, "wd": 1e-4}, dtype="bfloat16")
    loss = trainer.step(x, y)          # a PendingScalar: float(loss) syncs

A step (reference :832-877):

- sets the optimizer's ``rescale_grad`` to 1 and ``num_update`` to the step
  count t, and reads the learning rate through its ``lr_scheduler``;
- runs the net in training mode under ``autograd.record()``. With
  ``dtype="bfloat16"`` or ``"float16"`` every floating parameter's compute
  copy (``Parameter._compute``) is the parameter cast to that dtype, and so
  is a floating input; labels and integer tokens are not cast. The cast is
  differentiable, so the gradients reach the float32 parameters as float32.
  BatchNorm's running statistics are computed from the cast copies and
  written into the parameters in their own dtype (the reference's aux
  carry, :869-876);
- takes the mean of the loss (a Gluon ``Loss`` or a callable on the
  prediction's and the label's tensors), and its gradients with respect to
  every trainable parameter into the parameters' gradient buffers;
- under float16 (reference :830-876), multiplies the loss by the scale (a
  float64 tensor of ``LossScaler.bind``, taken as float32), the gradients
  by its reciprocal, and sets the overflow flag ``_found`` where any is not
  finite (``torch._amp_foreach_non_finite_check_and_unscale_``; on a mesh
  of ranks the MAX over every rank). K4/K5 read the flag as their gate
  (``skip``): an overflowing step writes no weight, no optimizer state and,
  under 2-bit compression, no residual. Then ``LossScaler.update_on_device``
  halves the scale on an overflow (not below 1) or doubles it after
  ``scale_window`` finite steps (:1514-1518). ``step`` runs the policy
  every step; ``run_steps`` keeps the scale for the call and runs it at its
  last step on the OR of the call's flags (``_found_acc``). Nothing of it
  is read on the host: ``LossScaler.loss_scale`` syncs only when read;
- updates every trainable parameter and its state in place: under SGD and
  Adam with one launch (one per distinct weight decay, each reading its row
  of ``_hyper``; one in the models of this repository), through the cached
  pointer table; under the other rules a tensor at a time, LAMB's and
  LARS's norms each parameter's own (a sharded parameter's summed over the
  ranks that hold its pieces). The parameters, gradient buffers and
  states keep their storage from step to step. Under ``zero_update`` LAMB
  and LARS raise with the reference's words: their norms would be taken
  over bucket shards.

``step`` returns a ``PendingScalar`` of the loss (``engine.async_feed``'s),
which syncs only when read, so steps of every dtype, captured or not, run
without a host sync. Each ``step`` (each ``run_steps`` call) is admitted into
an ``engine.async_feed.DispatchWindow`` (reference :350, :1441-1527): an event
recorded after it, and a wait on the step ``MXNET_TPU_INFLIGHT_STEPS`` (2)
before it, so the host runs at most that far ahead; ``drain()`` is the
boundary sync. With telemetry on, a step then books (``_record_telemetry``,
reference :694-795) the comm bytes of its collectives (the reference's
estimates: the gradient all-reduce, ZeRO's reduce-scatter and all-gather, the
overlapped ones labelled so), the optimizer state a rank holds, the
signature's FLOPs (counted once by ``engine.count_once``: over a captured
signature's eager warm-up whatever telemetry's flag, since a replay runs no
Python, or over an eager signature's first step with telemetry on) into
``engine.record_execution``, and
``record_step``; the step runs under ``telemetry.annotate("mx.dp.step")`` and,
with tracing armed, records the ``mx.dp.step`` span. A batch from a
``DeviceFeed`` built ``for_trainer`` is already this rank's part. The
parameters are the ``Parameter``s' own tensors, so ``sync()`` only waits for
the device.

On a mesh of ``torch.distributed`` ranks (``make_mesh`` after
``_dist_util.init_process_group``; each rank runs the same program), the
step is the reference's GSPMD step made explicit:

- ``data_spec`` (default ``P(batch_axis_name)``) names the mesh axes that
  split the data's dimensions: with ``P("dp", "sp")`` each rank takes its
  rows of the global batch it is given and its columns of the sequence
  (``y`` by the spec's first ``y.ndim`` entries). The forward runs under
  ``with activate(mesh, "sp")``, so the model sees its sequence shard;
- parameters with a ``sharding`` spec (``shard_params_megatron``) are placed
  at construction, the counterpart of ``_place_param`` (:645): each rank
  keeps its shard in storage of its own, and the tensor-parallel layers
  compute their part (``gluon/nn/basic_layers.py``, ``models/bert.py``);
- the loss is the mean over the global batch: each rank's mean is weighted
  by its share of the elements, and the returned ``PendingScalar`` is the
  sum of those over the data axes, the global mean;
- after the backward the gradients are summed over the data axes (the axes
  of ``data_spec``), never over an axis that shards parameters: under the
  convention of ``parallel/megatron.py`` every rank's gradients are full
  for what it holds. The gradient buffers are views into flat buckets of at
  most ``bucket_bytes`` (default ``MXNET_TPU_BUCKET_BYTES``), in reverse
  declaration order, one ``all_reduce`` per bucket;
- the update stays one launch of K4/K5 per weight decay over the rank's own
  parameters and shards; under float16 the overflow flag is agreed over
  every rank (an all-reduce with MAX, on the device);
- ``state_dict()`` gathers the shards into full tensors.

With ``zero_update=True`` (default ``MXNET_TPU_ZERO``) the step is the
reference's ``_build_step_zero`` (:983) made explicit (``parallel/zero.py``),
for pure data parallelism (``_validate_zero`` :544: replicated parameters,
``data_spec=P(batch_axis_name)``; ``recipes.long_context.LongContextTrainer``
also takes ``P("dp", "sp")``):

- at construction (``_init_zero_state`` :598) the trainable floating
  parameters are planned into flat buckets of at most ``bucket_bytes`` in
  declaration order (``zero.plan_buckets``), each parameter's gradient buffer
  becomes a view into its bucket's flat gradient, and the optimizer state is
  kept for this rank's 1/dp shard of each bucket only;
- after the backward each bucket's gradients are summed over the data axes
  other than ``batch_axis_name`` (``sp``) and reduce-scattered over it
  (``zero.reduce_scatter_bucket``, on the wire in ``comm_dtype``, default
  ``MXNET_TPU_COMM_DTYPE``); being each rank's share of the global mean,
  they need no division;
- the shard update stays one launch of K4/K5 per distinct weight decay: a
  rank's shard is cut at parameter boundaries into segments, each an entry
  of the kernel's pointer table under its parameter's wd, views into the
  parameters themselves, the reduced gradient shard and the state shard; the
  pad is in no segment (the reference carries a per-element ``wd_vector``
  instead, for which K4/K5 have no slot);
- each bucket's updated shard is all-gathered (``zero.all_gather_bucket``)
  back into the replicated parameters. Trainable parameters outside every
  bucket (none in this repository's models) take the replicated step's
  all-reduce and update.

A subclass adapts the plan through three hooks: ``_zero_entries`` (the
parameters the buckets pack), ``_may_shard_over_data`` (a parameter sharded
over a data axis) and ``_grad_axes`` (the axes a gradient bucket outside
ZeRO is summed over); ``recipes.moe.MoETrainer`` keeps its ep-sharded
experts out of the buckets and sums their gradients over dp only.

``gathered_grads()`` gives the reduced gradients (the shards gathered) and
``state_dict()`` the full optimizer state. ``_program`` (a
``parallel.step_program.StepProgram``, the configuration's fingerprint) and
``_dp_degree`` are what ``elastic.state.capture`` records besides the
tensors (reference :351, :540). A mesh of one device takes the one-device
step unchanged, ``zero_update`` included (its shard is the whole bucket, the
same arithmetic).

With ``overlap_grads=True`` (default ``MXNET_TPU_OVERLAP_GRADS``) the step is
the reference's ``_build_step_overlap`` (:1096) made explicit
(``parallel/overlap.py``; its rules, ``_validate_overlap`` :574: pure data
parallelism, no compression; an explicit ``True`` on a net with no chain
raises, the environment's default falls back to the plain step with a
warning):

- the net's chain (``overlap.chain_blocks``) is cut into
  ``overlap_segments`` segments (default ``MXNET_TPU_OVERLAP_SEGMENTS``,
  ``overlap.plan_segments``), and the gradient buckets (ZeRO's, or the
  replicated step's, both from ``zero.plan_buckets`` with the plan's
  ``boundaries``) never span two segments;
- the forward runs segment by segment, the backward is one
  ``torch.autograd.grad`` a segment, newest first; as soon as a segment's
  call returns, its owned gradients are copied into their buckets and the
  buckets' collectives (the all-reduce, or under ZeRO the reduce-scatter, on
  the ``comm_dtype`` wire) are issued on a side stream forked from the
  current one, which the current stream joins before the update. So they run
  while the older segments' backward runs, inside a captured graph too;
- the update is the plain step's: one K4/K5 launch per weight decay, then
  ZeRO's all-gather.

With ``compression={"type": "2bit", "threshold": t}`` (reference :447-500,
``_build_step_compressed`` :879; pure data parallelism, neither ZeRO nor
overlap) each rank takes the gradients of its own batch's mean loss, adds
its residual of each trainable parameter (``_comp_resid``, float32, kept
from step to step), quantizes the sum to {-t, 0, +t} (t where it is >= t,
-t where <= -t, else 0), keeps sum - quantized as the new residual, and the
quantized gradients are averaged over the batch axis (the all-reduce of the
buckets, then a division by the axis size) before the update. Under float16
an overflowing step changes no residual.
"""
from __future__ import annotations

import contextlib
import math
import time
import warnings
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..base import MXNetError, env, torch_dtype
from ..ndarray import NDArray
from .. import autograd
from .. import engine
from .. import optimizer as opt_mod
from .. import telemetry as _telem
from ..engine import async_feed as _feed
from ..engine.async_feed import PendingScalar
from ..telemetry import tracing as _tracing
from .. import _dist_util
from . import overlap as _overlap
from . import zero as _zero
from ..gluon.block import _Fold
from ..gluon.loss import Loss as GluonLoss
from ..ops.cuda import fused_optimizer as _fo
from .mesh import P, activate, current_mesh, require_axis
from .step_program import StepProgram, config_fingerprint, structural_fingerprint
from .tensor_parallel import local_part, spec_axes

def _f32(x) -> np.float32:
    return np.float32(x)


def _f32_pow(base, t) -> np.float32:
    """``1 - base**t`` in float32 (the reference's traced ``1 - beta**t``)."""
    return np.float32(1) - _f32(base) ** _f32(t)


def _row(fields, **values) -> List[float]:
    """The float32-rounded values of ``fields``, in order."""
    if set(values) != set(fields):
        raise MXNetError(f"hyper row: fields {sorted(set(fields) ^ set(values))} differ")
    return [float(_f32(values[k])) for k in fields]


def _keep_old(skip):
    """The float16 gate as a 0-d bool on the device (True: write nothing),
    or None; the flag is never read on the host."""
    return None if skip is None else skip.reshape(()) != 0


def _put(keep, dst, new):
    """Write each ``new`` into its ``dst`` in place, or leave ``dst`` as it
    is where ``keep`` is set."""
    for d, n in zip(dst, new):
        d.copy_(n if keep is None else torch.where(keep, d, n))


def _group_norm(norms):
    """The float32 2-norm of a stack of tensors from theirs (one: itself)."""
    if len(norms) == 1:
        return norms[0]
    return torch.sqrt(sum(n * n for n in norms))


def _whole_norms(norms, group):
    """The 2-norms of whole tensors from their pieces' on this rank, the
    other pieces on the ranks of ``group`` (one all-reduce); as they are
    where ``group`` is None."""
    if group is None:
        return norms
    sq = torch.stack(norms).square()
    dist.all_reduce(sq, group=group)
    return sq.sqrt().unbind(0)


def _scalars(h, fields, clip):
    """The row ``h`` as 0-d views by field; the clip a float -1 (no clip
    ops) where the optimizer's is off (``clip`` < 0)."""
    s = dict(zip(fields, h.reshape(-1).unbind(0)))
    if clip < 0:
        s["clip_gradient"] = -1.0
    return s


def _elementwise(fields, rule, clip):
    """The update of a rule applied tensor by tensor, its scalars after the
    states the row's ``fields`` in order."""
    def update(ws, gs, states, h, skip=None, stacks=None, groups=None):
        s = _scalars(h, fields, clip)
        args = [s[f] for f in fields]
        keep = _keep_old(skip)
        for w, g, st in zip(ws, gs, states):
            _put(keep, (w, *st), rule(w, g, *st, *args))
    return update


def functional_optimizer(opt: "opt_mod.Optimizer"):
    """``(init, update, hyper)`` for an optimizer, in the reference's dispatch
    order (:77-182): AdamW, LAMB, Adam, LARS, NAG, RMSProp (not centered),
    AdaGrad, SGD (and its subclasses: LBSGD, ccSGD); any other raises, as in
    the reference. ``init(weight)`` -> the state tuple (LAMB's float32);
    ``hyper(t, lr, wd)`` -> step t's scalars, in the order of
    ``hyper.fields``: Adam's and SGD's the 10 of
    ``fused_optimizer.HYPER_FIELDS`` (Adam's bias correction folded into lr
    as ``_k_adam`` does), the other rules their own, with c1 = 1 - beta1**t
    and c2 = 1 - beta2**t in float32 (1 and 1 for LAMB without bias
    correction); ``update(weights, grads, states, hyper, skip=None,
    stacks=None, groups=None)`` applies the rule to the lists in place,
    reading every scalar from ``hyper``, a float32 tensor of those fields on
    the weights' device, and writing nothing where ``skip`` (a float32
    tensor of one element, or None) is nonzero.

    Adam and SGD are one launch of K4/K5's device form on the card (their
    plain versions on the CPU); the other rules are the classes' own
    ``_k_*`` rules in tensor ops, tensor by tensor, with 0-d views of the
    row as their scalars, so a captured step replays each step's values.
    LAMB's and LARS's norms are each tensor's own, or with ``stacks`` (lists
    of positions) one norm over each stack's tensors together: the
    pipeline's layers of a stage, which the reference stacks into one leaf.
    ``groups`` (a process group or None by position) names the ranks that
    hold the other pieces of a sharded tensor: its norms are summed over
    them, so they are the whole tensor's, as under the reference's GSPMD
    step (a stack's tensors share one group).
    The clip is the optimizer's setting when it is made, as in the
    reference (``clip`` is closed over there, :74); off, its ops are left
    out."""
    O = opt_mod.optimizer
    clip = opt.clip_gradient if opt.clip_gradient is not None else -1.0

    def zeros(*dtype):
        return lambda w: tuple(torch.zeros_like(w, dtype=d) for d in dtype or (None,))

    def base(wd, lr, **kw):
        return dict(lr=lr, wd=wd, rescale_grad=opt.rescale_grad, clip_gradient=clip, **kw)

    if isinstance(opt, O.AdamW):
        fields = ("lr", "eta", "wd", "rescale_grad", "clip_gradient", "beta1", "beta2",
                  "epsilon", "c1", "c2")
        init, update = zeros(None, None), _elementwise(fields, O._k_adamw, clip)

        def hyper(t, lr, wd):
            return _row(fields, **base(wd, lr, eta=opt.eta, beta1=opt.beta1,
                                       beta2=opt.beta2, epsilon=opt.epsilon,
                                       c1=_f32_pow(opt.beta1, t), c2=_f32_pow(opt.beta2, t)))
    elif isinstance(opt, O.LAMB):
        fields = ("lr", "wd", "rescale_grad", "clip_gradient", "beta1", "beta2", "epsilon",
                  "c1", "c2", "lower_bound", "upper_bound")
        init = zeros(torch.float32, torch.float32)

        def update(ws, gs, states, h, skip=None, stacks=None, groups=None):
            s = _scalars(h, fields, clip)
            keep = _keep_old(skip)
            for grp in stacks or ([i] for i in range(len(ws))):
                dirs = [O._lamb_direction(ws[i], gs[i], *states[i], s["wd"],
                                          s["rescale_grad"], s["clip_gradient"], s["beta1"],
                                          s["beta2"], s["epsilon"], s["c1"], s["c2"])
                        for i in grp]
                wn, rn = _whole_norms((_group_norm([O._norm(ws[i]) for i in grp]),
                                       _group_norm([O._norm(r) for r, _, _ in dirs])),
                                      groups and groups[grp[0]])
                for i, (r, m2, v2) in zip(grp, dirs):
                    _put(keep, (ws[i], *states[i]), (
                        O._lamb_apply(ws[i], r, wn, rn, s["lr"], s["lower_bound"],
                                      s["upper_bound"]), m2, v2))

        def hyper(t, lr, wd):
            bc = opt.bias_correction
            return _row(fields, **base(
                wd, lr, beta1=opt.beta1, beta2=opt.beta2, epsilon=opt.epsilon,
                c1=_f32_pow(opt.beta1, t) if bc else 1.0,
                c2=_f32_pow(opt.beta2, t) if bc else 1.0,
                lower_bound=opt.lower_bound or 0.0, upper_bound=opt.upper_bound or np.inf))
    elif isinstance(opt, O.Adam):
        def init(w):
            return (torch.zeros_like(w), torch.zeros_like(w))

        def hyper(t, lr, wd):
            # _k_adam: lr_t = lr * sqrt(c2) / c1, all f32 (t an f32 step count)
            lr_t = _f32(lr) * np.sqrt(_f32_pow(opt.beta2, t)) / _f32_pow(opt.beta1, t)
            return _fo.hyper_values(lr=lr_t, beta1=opt.beta1, beta2=opt.beta2,
                                    epsilon=opt.epsilon, wd=wd,
                                    rescale_grad=opt.rescale_grad, clip_gradient=clip)

        def update(ws, gs, states, h, skip=None, stacks=None, groups=None):
            ms, vs = [s[0] for s in states], [s[1] for s in states]
            _fo.fused_adam_update_hyper(ws, gs, ms, vs, h, out=(ws, ms, vs), skip=skip)
        fields = _fo.HYPER_FIELDS
    elif isinstance(opt, O.LARS):
        fields = ("lr", "wd", "rescale_grad", "clip_gradient", "momentum", "eta", "epsilon")
        init = zeros()

        def update(ws, gs, states, h, skip=None, stacks=None, groups=None):
            s = _scalars(h, fields, clip)
            keep = _keep_old(skip)
            for grp in stacks or ([i] for i in range(len(ws))):
                firsts = [O._lars_norms(ws[i], gs[i], s["rescale_grad"], s["clip_gradient"])
                          for i in grp]
                wn, gn = _whole_norms((_group_norm([f[1] for f in firsts]),
                                       _group_norm([f[2] for f in firsts])),
                                      groups and groups[grp[0]])
                for i, (g, _, _) in zip(grp, firsts):
                    _put(keep, (ws[i], *states[i]), O._lars_apply(
                        ws[i], g, states[i][0], wn, gn, s["lr"], s["wd"], s["momentum"],
                        s["eta"], s["epsilon"]))

        def hyper(t, lr, wd):
            return _row(fields, **base(wd, lr, momentum=opt.momentum, eta=opt.eta,
                                       epsilon=opt.epsilon))
    elif isinstance(opt, O.NAG):
        fields = ("lr", "wd", "rescale_grad", "clip_gradient", "momentum")
        init, update = zeros(), _elementwise(fields, O._k_nag, clip)

        def hyper(t, lr, wd):
            return _row(fields, **base(wd, lr, momentum=opt.momentum))
    elif isinstance(opt, O.RMSProp) and not opt.centered:
        fields = ("lr", "wd", "rescale_grad", "clip_gradient", "rho", "epsilon")
        init, update = zeros(), _elementwise(fields, O._k_rmsprop, clip)

        def hyper(t, lr, wd):
            return _row(fields, **base(wd, lr, rho=opt.gamma1, epsilon=opt.epsilon))
    elif isinstance(opt, O.AdaGrad):
        fields = ("lr", "wd", "rescale_grad", "clip_gradient", "epsilon")
        init, update = zeros(), _elementwise(fields, O._k_adagrad, clip)

        def hyper(t, lr, wd):
            return _row(fields, **base(wd, lr, epsilon=opt.float_stable_eps))
    elif isinstance(opt, O.SGD):
        fields = _fo.HYPER_FIELDS

        def hyper(t, lr, wd):
            return _fo.hyper_values(lr=lr, momentum=opt.momentum, wd=wd,
                                    rescale_grad=opt.rescale_grad, clip_gradient=clip)

        if opt.momentum == 0.0:
            def init(w):
                return ()

            def update(ws, gs, states, h, skip=None, stacks=None, groups=None):
                _fo.fused_sgd_update_hyper(ws, gs, h, out=(ws,), skip=skip)
        else:
            def init(w):
                return (torch.zeros_like(w),)

            def update(ws, gs, states, h, skip=None, stacks=None, groups=None):
                moms = [s[0] for s in states]
                _fo.fused_sgd_mom_update_hyper(ws, gs, moms, h, out=(ws, moms), skip=skip)
    else:
        raise MXNetError(f"no functional adapter for optimizer {type(opt).__name__}; use "
                         f"gluon.Trainer or add one")
    hyper.fields = fields
    return init, update, hyper


def refuse_trust_ratio(opt, where: str):
    """The reference's refusal of LAMB and LARS where their per-tensor norms
    would be taken over pieces of tensors: ``where`` is ``"zero"`` (ZeRO's
    bucket shards, reference :566-571) or ``"tp"`` (the pipeline's tp
    shards, reference ``parallel/pipeline.py:473-476``)."""
    O = opt_mod.optimizer
    if not isinstance(opt, (O.LAMB, O.LARS)):
        return
    name = type(opt).__name__
    if where == "zero":
        raise MXNetError(f"zero_update does not support {name}: its per-tensor trust-ratio "
                         f"norms do not decompose over flat bucket shards; use "
                         f"sgd/adam/adamw/...")
    raise MXNetError(f"tensor parallelism does not support {name}: per-tensor trust-ratio "
                     f"norms are wrong on tp shards")


def write_hyper(dst: torch.Tensor, rows) -> None:
    """Write the step's scalar rows into ``dst`` (a trainer's ``_hyper``)
    ahead of the work that reads them: in place on the CPU; on the card from
    a pinned buffer, asynchronously on the current stream (the caching host
    allocator keeps each buffer until its copy has run), so neither the host
    nor a replay in flight waits for the other."""
    src = torch.tensor(rows, dtype=torch.float32)
    if dst.device.type == "cpu":
        dst.copy_(src)
    else:
        dst.copy_(src.pin_memory(), non_blocking=True)


class _StepGraph:
    """One signature's captured step (``graph`` None until step 2, held
    here so that the engine's weak cache keeps it) with its static
    inputs (and, for ``PipelineTrainer``, the captured step's
    ``last_stats``)."""

    __slots__ = ("graph", "x", "y", "stats")

    def __init__(self):
        self.graph = None
        self.x = self.y = self.stats = None


class DataParallelTrainer:
    """The fused training step on one device; see the module docstring.
    ``net`` is an initialized ``HybridBlock`` (run one forward first if its
    shapes are deferred); ``loss`` a Gluon ``Loss`` or a callable
    ``(pred, label) -> per-sample loss`` on tensors."""

    def __init__(self, net, loss, optimizer="sgd", optimizer_params=None, mesh=None,
                 batch_axis_name: str = "dp", dtype=None, data_spec=None,
                 compression=None, zero_update=None, bucket_bytes=None,
                 comm_dtype=None, overlap_grads=None, overlap_segments=None):
        self._zero = bool(zero_update if zero_update is not None
                          else env.get("MXNET_TPU_ZERO"))
        overlap_env = overlap_grads is None
        self._overlap = bool(env.get("MXNET_TPU_OVERLAP_GRADS") if overlap_env
                             else overlap_grads)
        self._overlap_segments = int(overlap_segments if overlap_segments is not None
                                     else env.get("MXNET_TPU_OVERLAP_SEGMENTS"))
        self._overlap_plan: Optional[_overlap.SegmentPlan] = None
        self._overlap_buckets = ()
        self._seg_buckets: Dict[int, List[int]] = {}
        self._comm_stream = None
        if comm_dtype is None:
            comm_dtype = env.get("MXNET_TPU_COMM_DTYPE") or None
        self._comm_dtype = _zero.canonical_comm_dtype(comm_dtype) \
            if (self._zero or self._overlap) else None
        self.net = net
        self.compute_dtype: Optional[torch.dtype] = None
        if dtype is not None and torch_dtype(dtype) != torch.float32:
            self.compute_dtype = torch_dtype(dtype)
            if self.compute_dtype not in (torch.bfloat16, torch.float16):
                raise MXNetError(f"dtype must be float32/bfloat16/float16, got {dtype!r}")
        self._scaler = None
        if self.compute_dtype == torch.float16:
            from ..contrib.amp.loss_scaler import LossScaler
            self._scaler = LossScaler()
        self.mesh = mesh if mesh is not None else current_mesh()
        self.batch_axis = batch_axis_name
        self.data_spec = data_spec if data_spec is not None else P(batch_axis_name)
        self._data_axes = []          # (dim, axis names) of the data's split dims
        for d, axes in spec_axes(self.data_spec):
            for a in axes:
                require_axis(self.mesh, a, f"data_spec {self.data_spec}")
            self._data_axes.append((d, axes))
        reduce_axes = [a for _, axes in self._data_axes for a in axes]
        self._reduce_axes = tuple(a for a in self.mesh.axis_names if a in reduce_axes)
        seq = self.data_spec[1] if len(self.data_spec) > 1 else None
        if isinstance(seq, tuple):
            raise MXNetError(f"data_spec {self.data_spec}: the sequence dim splits "
                             f"over one axis")
        self._seq_axis = seq
        self.optimizer = optimizer if isinstance(optimizer, opt_mod.Optimizer) \
            else opt_mod.create(optimizer, **(optimizer_params or {}))
        self._init_fn, self._update_fn, self._hyper_fn = functional_optimizer(self.optimizer)
        self.loss = loss
        params = list(net.collect_params().values())
        deferred = [p.name for p in params
                    if p._param is None and p._deferred_init is not None]
        if deferred:
            raise MXNetError(f"net has deferred-init parameters ({deferred[0]}...); "
                             f"run one forward pass before constructing "
                             f"DataParallelTrainer")
        self._plist = [p for p in params if p._param is not None]
        self.device = self.mesh.device
        elsewhere = [p.name for p in self._plist if p.list_ctx()[0] != self.device]
        if elsewhere:
            raise MXNetError(f"parameters {elsewhere[:3]} are not on the mesh's device "
                             f"{self.device}")
        for p in self._plist:
            for _, axes in spec_axes(p.sharding):
                for a in axes:
                    require_axis(self.mesh, a, f"the sharding of {p.name}")
                    if a in self._reduce_axes and not self._may_shard_over_data(p):
                        raise MXNetError(f"{p.name} is sharded over the data axis {a!r} "
                                         f"({p.sharding}): a data axis splits the batch, "
                                         f"not parameters")
            if self.mesh.distributed and spec_axes(p.sharding):
                if p._mesh is None:
                    p._place(self.mesh)       # reference _place_param (:645)
                elif p._mesh is not self.mesh:
                    raise MXNetError(f"{p.name} is placed on another mesh, {p._mesh}")
        self._trainable = [p.grad_req != "null" for p in self._plist]
        # the ranks holding the other pieces of each sharded parameter, over
        # which LAMB's and LARS's norms are summed (the reference's norms are
        # the global tensor's)
        self._norm_groups = [
            self.mesh.group(tuple(a for _, axes in spec_axes(p.sharding) for a in axes))
            if self.mesh.distributed and spec_axes(p.sharding) else None
            for p in self._plist]
        self._t = 0
        self._buckets: List[torch.Tensor] = []     # flat gradient buckets (all-reduce)
        self._bucket_axes: List[tuple] = []        # the axes each bucket is summed over
        self._zero_plan = ()
        self._zero_buckets: List[dict] = []
        # one update launch for each distinct weight decay, over the whole
        # parameters of _groups and, under ZeRO, this rank's segments of
        # _segments (views of the weights, the gradient shard, the state shard)
        self._groups: Dict[float, List[int]] = {}
        self._segments: Dict[float, List[tuple]] = {}
        self._bucket_bytes = int(bucket_bytes if bucket_bytes is not None
                                 else env.get("MXNET_TPU_BUCKET_BYTES"))
        if self._overlap:
            self._plan_overlap(compression, overlap_env)
        if self._zero:
            if compression:
                raise MXNetError("zero_update is incompatible with 2-bit gradient "
                                 "compression; use comm_dtype='bfloat16'/'int8' for "
                                 "compressed collectives instead")
            self._validate_zero()
            refuse_trust_ratio(self.optimizer, "zero")
        self._compression = self._validate_compression(compression)
        wds = [self.optimizer._get_wd(i) for i in range(len(self._plist))]
        zero = self._zero and self.mesh.distributed
        in_bucket = self._init_zero_state(wds) if zero else frozenset()
        bucketed = in_bucket
        if self._overlap and self.mesh.distributed and not zero:
            bucketed = self._init_overlap_buckets()
        if self.mesh.distributed:
            self._make_buckets([i for i in range(len(self._plist)) if i not in bucketed])
        if self._overlap:
            seg_of = self._overlap_plan.segment_of_slot
            for bi, b in enumerate(self._zero_plan or self._overlap_buckets):
                owners = {seg_of[i] for i in b.indices}
                if len(owners) != 1:      # the plan's boundaries exclude it
                    raise MXNetError(f"bucket {bi} spans segments {sorted(owners)}")
                self._seg_buckets.setdefault(owners.pop(), []).append(bi)
        self._comp_resid = [torch.zeros_like(p._param, dtype=torch.float32)
                            if t and p._param.is_floating_point() else None
                            for p, t in zip(self._plist, self._trainable)] \
            if self._compression else []
        self._opt_state = [self._init_fn(p._param.detach()) if t and i not in in_bucket
                           else () for i, (p, t) in enumerate(zip(self._plist,
                                                                  self._trainable))]
        for i, (t, wd) in enumerate(zip(self._trainable, wds)):
            if t and i not in in_bucket:
                self._groups.setdefault(float(wd), []).append(i)
        self._dp_degree = self.mesh.axis_size(self.batch_axis)
        # the update's scalars, a row for each weight decay, on the device
        self._wd_order = list(dict.fromkeys([*self._groups, *self._segments]))
        self._hyper = torch.zeros((max(1, len(self._wd_order)), len(self._hyper_fn.fields)),
                                  dtype=torch.float32, device=self.device.torch_device)
        if self._scaler is not None:
            # float16: the scale and the count on the device (LossScaler.bind),
            # this step's overflow flag (the gate K4/K5 read), the flags' OR
            # since the policy last ran, and whether this step runs the policy
            dev = self.device.torch_device
            self._scaler.bind(dev)
            self._found, self._found_acc, self._amp_gate = (
                torch.zeros(1, dtype=torch.float32, device=dev) for _ in range(3))
        self._graphs: Dict[tuple, _StepGraph] = {}
        # the bounded in-flight window (reference :350) and each signature's
        # FLOPs, counted once (engine.count_once): at a captured step's
        # warm-up, or at an eager step's first with telemetry on
        self._window = _feed.DispatchWindow(name="dp")
        self._flops: Dict[tuple, float] = {}
        self._ar_bytes = self._rs_bytes = self._ag_bytes = None
        # why the body runs eagerly every step, None to capture it; the tests
        # set it to a string to run the same trainer eagerly as a yardstick
        self._graph_reason = self._eager_reason()
        # the configuration's identity, which elastic snapshots record
        # (reference :515-541; the placement of one run is left out)
        self._program = StepProgram(f"dp.step[{type(net).__name__}]", (
            "dp_step", structural_fingerprint(net), config_fingerprint(
                optimizer=type(self.optimizer).__name__,
                opt_conf=tuple(sorted(
                    (k, repr(v)) for k, v in vars(self.optimizer).items()
                    if isinstance(v, (int, float, bool, str, type(None))))),
                wds=tuple(float(w) for w in wds), loss=self.loss,
                mesh=tuple(sorted(self.mesh.shape.items())),
                axis_order=self.mesh.axis_names, batch_axis=self.batch_axis,
                data_spec=tuple(str(a) for a in self.data_spec),
                param_specs=tuple(str(p.sharding) for p in self._plist),
                trainable=tuple(self._trainable), compute_dtype=str(self.compute_dtype),
                scaled=self._scaler is not None,
                compression=tuple(sorted(self._compression.items()))
                if self._compression else None, zero=self._zero,
                bucket_bytes=self._bucket_bytes if (self._zero or self._overlap) else None,
                comm_dtype=self._comm_dtype,
                overlap=self._overlap_plan.fingerprint if self._overlap else None)))

    def _eager_reason(self) -> Optional[str]:
        """Why the step runs its body eagerly every time, or None to capture
        it (see the module docstring)."""
        if self.device.device_type != "gpu":
            return "cpu"
        if self.mesh.distributed and any(dist.get_backend(g) != "nccl"
                                         for g in self.mesh._groups.values()):
            return "gloo"
        return None

    # -- the sharded update (parallel/zero.py) ------------------------------------
    def _pure_dp(self, what: str):
        """Raise unless parameters are replicated and the data is split over
        the batch axis only (what ``what`` requires)."""
        bad = [p.name for p in self._plist if spec_axes(p.sharding)]
        if bad or tuple(self.data_spec) != (self.batch_axis,):
            raise MXNetError(f"{what} requires pure data parallelism (replicated "
                             f"parameters, data sharded over the batch axis only); "
                             f"offending params={bad[:3]} data_spec={self.data_spec}")

    def _validate_zero(self):
        """zero_update preconditions (reference :544, less its compression
        check, which the constructor makes): pure data parallelism."""
        self._pure_dp("zero_update")

    def _validate_overlap(self, compression):
        """overlap_grads preconditions (reference :574)."""
        if compression:
            raise MXNetError("overlap_grads is incompatible with 2-bit gradient compression; "
                             "use comm_dtype='bfloat16'/'int8' for a compressed overlapped "
                             "wire instead")
        self._pure_dp("overlap_grads")

    def _validate_compression(self, compression) -> Optional[dict]:
        """The compression settings (reference :447-500), or None."""
        if not compression:
            return None
        comp = dict(compression)
        ctype = comp.get("type", "2bit")
        if ctype != "2bit":
            raise MXNetError(f"unsupported gradient compression {ctype!r}")
        self._pure_dp("gradient compression")
        return comp

    def _plan_overlap(self, compression, from_env: bool):
        """Segment the backward (reference :391-418); an overlap the
        environment asked for falls back to the plain step with a warning."""
        try:
            self._validate_overlap(compression)
            self._overlap_plan = _overlap.plan_segments(self.net, self._plist,
                                                        self._overlap_segments)
            owning = sum(1 for s in self._overlap_plan.segments if s.owned)
            if owning < 2:
                raise MXNetError(f"overlap_grads needs >= 2 backward segments that own "
                                 f"parameters, got {owning}; nothing to overlap")
        except MXNetError as e:
            if not from_env:
                raise
            warnings.warn(f"MXNET_TPU_OVERLAP_GRADS: falling back to the plain fused step "
                          f"({e})", UserWarning, stacklevel=3)
            self._overlap = False
            self._overlap_plan = None
            if not self._zero:
                self._comm_dtype = None

    def _init_overlap_buckets(self) -> frozenset:
        """The replicated step's gradient buckets under overlap (reference
        :436-445): ``zero.plan_buckets`` with the segments' boundaries, each
        parameter's gradient buffer a view into its bucket; returns the
        parameters in a bucket."""
        ndp = self.mesh.axis_size(self.batch_axis)
        self._overlap_buckets = _zero.plan_buckets(self._zero_entries(), ndp,
                                                   self._bucket_bytes,
                                                   boundaries=self._overlap_plan.boundaries)
        for b in self._overlap_buckets:
            dtype = self._plist[b.indices[0]]._param.dtype
            flat = torch.zeros(b.padded_size, dtype=dtype, device=self.device.torch_device)
            for i, g in _zero.unflatten_bucket(b, flat):
                p = self._plist[i]
                p._grad = g
                autograd._mark(p._param, p._grad, p.grad_req)
            self._buckets.append(flat)
            self._bucket_axes.append(self._reduce_axes)
        engine.note_storage_change()      # the gradient buffers are bucket views now
        return frozenset(i for b in self._overlap_buckets for i in b.indices)

    def _init_zero_state(self, wds) -> frozenset:
        """Plan the buckets (reference :598), make each bucketed parameter's
        gradient buffer a view into its bucket, keep the reduced gradient,
        optimizer state and weights of this rank's shard, and cut the shard
        into ``_segments`` by weight decay; returns the parameters in a
        bucket."""
        ndp = self.mesh.axis_size(self.batch_axis)
        pos = self.mesh.axis_index(self.batch_axis)
        dev = self.device.torch_device
        self._zero_plan = _zero.plan_buckets(
            self._zero_entries(), ndp, self._bucket_bytes,
            boundaries=self._overlap_plan.boundaries if self._overlap else None)
        for b in self._zero_plan:
            dtype = self._plist[b.indices[0]]._param.dtype
            gflat = torch.zeros(b.padded_size, dtype=dtype, device=dev)
            for i, g in _zero.unflatten_bucket(b, gflat):
                p = self._plist[i]
                p._grad = g
                autograd._mark(p._param, p._grad, p.grad_req)
            wshard = torch.zeros(b.shard_size, dtype=dtype, device=dev)
            gshard = torch.zeros(b.shard_size, dtype=dtype, device=dev)
            state = self._init_fn(wshard)
            zb = {"spec": b, "gflat": gflat, "wshard": wshard, "gshard": gshard,
                  "state": state, "segments": [], "weights": [], "in_shard": []}
            lo, hi = pos * b.shard_size, (pos + 1) * b.shard_size
            for i, o, n in zip(b.indices, b.offsets, b.sizes):
                a, e = max(o, lo), min(o + n, hi)
                if a >= e:
                    continue
                zb["segments"].append((i, a - o, e - o, a - lo))
                w = self._plist[i]._param.detach().view(-1)[a - o:e - o]
                part = slice(a - lo, e - lo)
                zb["weights"].append(w)
                zb["in_shard"].append(wshard[part])
                self._segments.setdefault(float(wds[i]), []).append(
                    (w, gshard[part], tuple(st[part] for st in state)))
            self._zero_buckets.append(zb)
        engine.note_storage_change()      # the gradient buffers are bucket views now
        return frozenset(i for b in self._zero_plan for i in b.indices)

    def _zero_entries(self):
        """``(index, shape, dtype)`` of the parameters the ZeRO buckets pack:
        the trainable floating ones."""
        return [(i, p._param.shape, p._param.dtype) for i, (p, t) in
                enumerate(zip(self._plist, self._trainable))
                if t and p._param.is_floating_point()]

    def _may_shard_over_data(self, p) -> bool:
        """Whether ``p`` may be sharded over a data axis (a subclass whose
        layers exchange those shards, ``recipes.moe``'s experts)."""
        return False

    def _grad_axes(self, i) -> tuple:
        """The mesh axes parameter ``i``'s gradient is summed over outside
        the ZeRO buckets: the data axes."""
        return self._reduce_axes

    def _reduce_zero(self):
        """Sum each bucket over the data axes but the batch axis, and
        reduce-scatter it over the batch axis into the gradient shard."""
        ndp = self.mesh.axis_size(self.batch_axis)
        others = tuple(a for a in self._reduce_axes if a != self.batch_axis)
        for zb in self._zero_buckets:
            if others:
                dist.all_reduce(zb["gflat"], group=self.mesh.group(others))
            zb["gshard"].copy_(_zero.reduce_scatter_bucket(
                zb["gflat"], self.batch_axis, ndp, self._comm_dtype, self.mesh))

    def _gather_zero(self):
        """All-gather each bucket's updated shard into the parameters."""
        if self.mesh.axis_size(self.batch_axis) == 1:
            return                 # the shard is the bucket: updated in place
        for zb in self._zero_buckets:
            if zb["weights"]:
                torch._foreach_copy_(zb["in_shard"], zb["weights"])
            full = _zero.all_gather_bucket(zb["wshard"], self.batch_axis, self.mesh)
            views = _zero.unflatten_bucket(zb["spec"], full)
            torch._foreach_copy_([self._plist[i]._param.detach() for i, _ in views],
                                 [v for _, v in views])

    def _opt_state_replica_bytes(self) -> int:
        """Bytes of optimizer state this rank holds (``zero`` shards only)."""
        return _zero.per_replica_state_bytes(
            [self._opt_state, [zb["state"] for zb in self._zero_buckets]])

    def _full_zero(self, key):
        """Per parameter index, the full tensors of the bucket shards under
        ``key`` ("gshard", or "state" for a tuple): an all-gather of every
        bucket, a collective."""
        out = {}
        for zb in self._zero_buckets:
            shards = zb[key] if key == "state" else (zb[key],)
            fulls = [_zero.all_gather_bucket(s, self.batch_axis, self.mesh)
                     for s in shards]
            for f in fulls:
                for i, v in _zero.unflatten_bucket(zb["spec"], f):
                    out.setdefault(i, []).append(v.clone())
        return {i: tuple(v) if key == "state" else v[0] for i, v in out.items()}

    def gathered_grads(self) -> Dict[str, torch.Tensor]:
        """Copies of the reduced gradient of every trainable parameter by
        structural path, full: under ZeRO the gradient shards gathered over the
        batch axis (a collective every rank calls), else the gradient buffers."""
        full = self._full_zero("gshard") if self._zero_buckets else {}
        paths = {id(p): k for k, p in self.net._collect_params_with_prefix().items()}
        return {paths.get(id(p), p.name): full[i] if i in full else p._grad.clone()
                for i, p in enumerate(self._plist) if self._trainable[i]}

    def _make_buckets(self, indices):
        """Flat gradient buckets of the trainable parameters among ``indices``,
        in reverse declaration order (the order the backward finishes them),
        of at most ``bucket_bytes``, one dtype and one set of ``_grad_axes``
        each; every such parameter's gradient buffer becomes a view into its
        bucket, each view starting 64 elements apart."""
        align = 64
        live = [i for i in reversed(indices) if self._trainable[i]]
        by_kind: Dict[tuple, List[int]] = {}
        for i in live:
            by_kind.setdefault((self._grad_axes(i), self._plist[i]._grad.dtype), []).append(i)
        for (axes, dtype), idx in by_kind.items():
            elem = torch.empty((), dtype=dtype).element_size()
            sizes = [(i, -(-self._plist[i]._grad.numel() // align) * align * elem)
                     for i in idx]
            for keys in _dist_util.plan_buckets(sizes, self._bucket_bytes):
                counts = [-(-self._plist[i]._grad.numel() // align) * align for i in keys]
                flat = torch.zeros(sum(counts), dtype=dtype,
                                   device=self.device.torch_device)
                off = 0
                for i, n in zip(keys, counts):
                    p = self._plist[i]
                    p._grad = flat[off:off + p._grad.numel()].view(p._grad.shape)
                    autograd._mark(p._param, p._grad, p.grad_req)
                    off += n
                self._buckets.append(flat)
                self._bucket_axes.append(axes)
        engine.note_storage_change()      # the gradient buffers are bucket views now

    # -- the step --------------------------------------------------------------
    def _raw(self, a) -> torch.Tensor:
        if isinstance(a, NDArray):
            t = a._data
        elif isinstance(a, torch.Tensor):
            t = a
        else:
            t = torch.as_tensor(np.asarray(a))
        return t.to(self.device.torch_device)

    def _local(self, t: torch.Tensor, stacked: bool = False) -> torch.Tensor:
        """This rank's part of a global batch tensor under ``data_spec``
        (dims shift by one for a stacked run); a ``DeviceFeed``'s leaf for
        this mesh is that part already."""
        if not self.mesh.distributed or _feed.is_local(t):
            return t
        return local_part(t, self._data_axes, self.mesh, stacked)

    def _share(self) -> float:
        """This rank's share of the global batch's elements."""
        return 1.0 / math.prod(self.mesh.axis_size(a) for a in self._reduce_axes)

    def _loss_mean(self, pred: NDArray, label: torch.Tensor) -> torch.Tensor:
        if isinstance(self.loss, GluonLoss):
            return self.loss(pred, NDArray(label, self.device))._data.mean()
        return torch.mean(self.loss(pred._data, label))

    def _forward_backward(self, x, y, scale) -> torch.Tensor:
        """The loss mean, with the gradients of ``scale`` times it in the
        trainable parameters' gradient buffers (on a mesh of ranks: this
        rank's part of the global mean, its gradients summed over the data
        axes)."""
        cdt = self.compute_dtype
        scope = self._forward_scope()
        with torch.enable_grad(), autograd.record(train_mode=True):
            if cdt is not None:
                for p in self._plist:
                    if p._param.is_floating_point():
                        p._compute = p._param.to(cdt)
                if x.is_floating_point():
                    x = x.to(cdt)
            try:
                with scope:
                    out = self.net(NDArray(x, self.device))
            finally:
                for p in self._plist:
                    p._compute = None
            pred = out[0] if isinstance(out, (tuple, list)) else out
            local = self._loss_mean(pred, y)
            lossv = local * self._share() if self.mesh.distributed else local
            # the compressed step quantizes the gradients of the rank's own mean
            head = local if self._compression else lossv
            head = head * scale if scale is not None else head
            train = [p for p, t in zip(self._plist, self._trainable) if t]
            grads = torch.autograd.grad(head, [p._param for p in train],
                                        allow_unused=True)
        with torch.no_grad():
            self._set_grads(train, grads)
            if self.mesh.distributed and self._reduce_axes and not self._compression:
                for flat, axes in zip(self._buckets, self._bucket_axes):
                    dist.all_reduce(flat, group=self.mesh.group(axes))
            return self._global_loss(lossv)

    @staticmethod
    def _set_grads(params, grads):
        """Copy ``grads`` into the parameters' gradient buffers; a parameter
        the loss did not reach gets a zero gradient."""
        got = [(p._grad, g) for p, g in zip(params, grads) if g is not None]
        if got:
            torch._foreach_copy_([b for b, _ in got], [g for _, g in got])
        for p, g in zip(params, grads):
            if g is None:
                p._grad.zero_()

    def _global_loss(self, lossv: torch.Tensor) -> torch.Tensor:
        """The rank's share of the loss summed over the data axes: the global
        mean (the loss itself in one process)."""
        lossv = lossv.detach()
        if self.mesh.distributed and self._reduce_axes:
            lossv = lossv.float().clone()
            dist.all_reduce(lossv, group=self.mesh.group(self._reduce_axes))
        return lossv

    # -- the overlapped backward (parallel/overlap.py) -------------------------------
    def _forward_backward_overlap(self, x, y, scale) -> torch.Tensor:
        """``_forward_backward`` segment by segment (module docstring): the
        forward through each segment's blocks on a detached input, then one
        ``torch.autograd.grad`` a segment, newest first, each followed by its
        buckets' collectives."""
        cdt = self.compute_dtype
        segs = self._overlap_plan.segments
        ins, outs = [], []
        with torch.enable_grad(), autograd.record(train_mode=True), self._forward_scope():
            if cdt is not None and x.is_floating_point():
                x = x.to(cdt)
            h = NDArray(x, self.device)
            for seg in segs:
                hin = None
                if seg.index > 0:
                    t = (h[0] if isinstance(h, (tuple, list)) else h)._data
                    hin = t.detach().requires_grad_(t.is_floating_point())
                    h = NDArray(hin, self.device)
                uses = [self._plist[i] for i in seg.uses]
                if cdt is not None:
                    for p in uses:
                        if p._param.is_floating_point():
                            p._compute = p._param.to(cdt)
                try:
                    for blk in seg.blocks:
                        h = blk(h)
                finally:
                    for p in uses:
                        p._compute = None
                ins.append(hin)
                outs.append(h)
            pred = h[0] if isinstance(h, (tuple, list)) else h
            lossv = self._loss_mean(pred, y)
            if self.mesh.distributed:
                lossv = lossv * self._share()
            head = lossv * scale if scale is not None else lossv
            acc: Dict[int, torch.Tensor] = {}
            side = self._side_stream()
            held: List[torch.Tensor] = []    # gradients the side stream reads
            cot = None
            for seg in reversed(segs):
                train = [i for i in seg.uses if self._trainable[i]]
                inputs = [self._plist[i]._param for i in train]
                hin = ins[seg.index]
                if hin is not None and hin.requires_grad:
                    inputs.append(hin)
                if seg.index == len(segs) - 1:
                    res = torch.autograd.grad(head, inputs, allow_unused=True)
                elif cot is not None:
                    out = outs[seg.index]
                    out = (out[0] if isinstance(out, (tuple, list)) else out)._data
                    res = torch.autograd.grad(out, inputs, grad_outputs=cot,
                                              allow_unused=True)
                else:               # nothing after this segment reached its output
                    res = [None] * len(inputs)
                if len(inputs) > len(train):
                    cot, res = res[-1], res[:-1]
                else:
                    cot = None
                for i, g in zip(train, res):
                    if g is not None:
                        acc[i] = g if i not in acc else acc[i] + g
                with torch.no_grad():
                    self._finish_segment(seg, acc, side, held)
        with torch.no_grad():
            if side is not None:
                torch.cuda.current_stream(self.device.torch_device).wait_stream(side)
            held.clear()
            return self._global_loss(lossv)

    def _side_stream(self):
        """The stream the buckets' collectives run on: a side stream on the
        card on a mesh of ranks, None (the current stream) otherwise."""
        if not self.mesh.distributed or self.device.device_type != "gpu":
            return None
        if self._comm_stream is None:
            self._comm_stream = torch.cuda.Stream(self.device.torch_device)
        return self._comm_stream

    def _finish_segment(self, seg, acc, side, held):
        """Write the gradients ``seg`` owns into their buffers and issue its
        buckets' collectives (on ``side``, forked from the current stream)."""
        owned = [i for i in seg.owned if self._trainable[i]]
        for i in owned:
            if i not in acc:
                self._plist[i]._grad.zero_()
        got = [(self._plist[i]._grad, acc.pop(i)) for i in owned if i in acc]
        if side is None:
            if got:
                torch._foreach_copy_([b for b, _ in got], [g for _, g in got])
            self._reduce_segment(seg.index)
            return
        side.wait_stream(torch.cuda.current_stream(self.device.torch_device))
        held.extend(g for _, g in got)
        with torch.cuda.stream(side):
            if got:
                torch._foreach_copy_([b for b, _ in got], [g for _, g in got])
            self._reduce_segment(seg.index)

    def _reduce_segment(self, s: int):
        """The collectives of segment ``s``'s buckets: ZeRO's reduce-scatter
        into the gradient shard, or the all-reduce of the replicated step."""
        if not self.mesh.distributed:
            return
        ndp = self.mesh.axis_size(self.batch_axis)
        for bi in self._seg_buckets.get(s, ()):
            if self._zero_buckets:
                zb = self._zero_buckets[bi]
                zb["gshard"].copy_(_zero.reduce_scatter_bucket(
                    zb["gflat"], self.batch_axis, ndp, self._comm_dtype, self.mesh))
            else:
                _overlap.allreduce_bucket(self._buckets[bi], self.batch_axis, ndp,
                                          self._comm_dtype, self.mesh)

    def _compress_reduce(self, skip=None):
        """2-bit quantization with error feedback of every trainable floating
        gradient, then their mean over the batch axis (module docstring).
        Where ``skip`` (the float16 overflow flag) is set, every residual
        keeps its value (reference :945-950)."""
        thr = float(self._compression.get("threshold", 0.5))
        keep = skip.reshape(()) != 0 if skip is not None else None
        for p, r in zip(self._plist, self._comp_resid):
            if r is None:
                continue
            g = p._grad
            acc = g.float() + r
            q = torch.where(acc >= thr, thr, torch.where(acc <= -thr, -thr, 0.0))
            r.copy_(acc - q if keep is None else torch.where(keep, r, acc - q))
            g.copy_(q)
        if self.mesh.distributed and self._reduce_axes:
            n = self.mesh.axis_size(self.batch_axis)
            for flat, axes in zip(self._buckets, self._bucket_axes):
                dist.all_reduce(flat, group=self.mesh.group(axes))
                flat.div_(n)

    def _forward_scope(self):
        """The context the forward runs in: the mesh made active with the
        sequence axis, on a mesh of ranks."""
        return activate(self.mesh, self._seq_axis) if self.mesh.distributed \
            else contextlib.nullcontext()

    def _unscale_check(self, scale: torch.Tensor) -> torch.Tensor:
        """Gradients times 1/scale in place, and ``_found`` set to 1 where
        any is not finite on any rank (the all-reduce's MAX); device work
        only, nothing read on the host. Returns ``_found``."""
        grads = [p._grad for p, t in zip(self._plist, self._trainable)
                 if t and p._grad.is_floating_point()]
        self._found.zero_()
        torch._amp_foreach_non_finite_check_and_unscale_(grads, self._found,
                                                         torch.reciprocal(scale))
        if self.mesh.distributed:
            dist.all_reduce(self._found, op=dist.ReduceOp.MAX,
                            group=self.mesh.group(self.mesh.axis_names))
        return self._found

    def _update(self, skip=None):
        with torch.no_grad():
            if self._zero_buckets and not self._overlap:
                self._reduce_zero()
            for k, wd in enumerate(self._wd_order):
                idx, segments = self._groups.get(wd, []), self._segments.get(wd, [])
                self._update_fn([self._plist[i]._param for i in idx] + [w for w, _, _ in segments],
                                [self._plist[i]._grad for i in idx] + [g for _, g, _ in segments],
                                [self._opt_state[i] for i in idx] + [s for _, _, s in segments],
                                self._hyper[k], skip, groups=[self._norm_groups[i] for i in idx]
                                + [None] * len(segments))
            if self._zero_buckets:
                self._gather_zero()

    def _body(self, x, y) -> torch.Tensor:
        """The step's device work: forward, backward, the gradient buckets'
        reduction and the update. Under float16 the loss is scaled by the
        device's scale, the update (and the compression's residuals) gated
        by the overflow flag, and the scaler's policy run where ``_amp_gate``
        says, all on the device. Returns the loss."""
        scale = self._scaler.scale_tensor() if self._scaler is not None else None
        with _Fold():     # hybridized blocks fold into the step, which counts their FLOPs
            if self._overlap:
                lossv = self._forward_backward_overlap(x, y, scale)
            else:
                lossv = self._forward_backward(x, y, scale)
        with torch.no_grad():
            skip = self._unscale_check(scale) if scale is not None else None
            if self._compression:
                self._compress_reduce(skip)
            self._update(skip)
            if scale is not None:
                acc = self._found_acc
                acc.copy_(torch.maximum(acc, skip))
                self._scaler.update_on_device(acc, self._amp_gate)
                acc.copy_(torch.where(self._amp_gate != 0, torch.zeros_like(acc), acc))
        return lossv

    def _one_step(self, x, y, policy: bool = True) -> torch.Tensor:
        """Write the step's scalars (and under float16 whether it runs the
        scaler's policy), then run the body: replayed where captured."""
        self._t += 1
        self.optimizer.num_update = self._t
        lr = _f32(self.optimizer.learning_rate)
        write_hyper(self._hyper, [self._hyper_fn(self._t, lr, wd) for wd in self._wd_order])
        if self._scaler is not None:
            write_hyper(self._amp_gate, [1.0 if policy else 0.0])
        if self._graph_reason is None:
            return self._graph_step(x, y)
        if _telem._ENABLED:         # an eager step: counted at its first with telemetry on
            return engine.count_once(self._flops, self._signature(x, y), self._body, x, y)
        return self._body(x, y)

    @staticmethod
    def _signature(x, y) -> tuple:
        return (tuple(x.shape), x.dtype, tuple(y.shape), y.dtype)

    # -- the captured step -------------------------------------------------------
    def _operand_ptrs(self):
        return tuple((p._param.data_ptr(), p._grad.data_ptr() if p._grad is not None else 0)
                     for p in self._plist)

    def _graph_step(self, x, y) -> torch.Tensor:
        """The step on the card: warm up at a signature's first step, capture
        at its second, replay from then on (module docstring)."""
        sig = self._signature(x, y)
        key = ("dp_step", id(self), self._program.fingerprint, sig)
        entry = self._graphs.get(sig)
        graph = engine.lookup(key) if entry is not None else None
        if graph is None:
            if entry is None or entry.graph is not None:     # new, or its graph went stale
                self._graphs[sig] = _StepGraph()
                with engine.side_stream(self.device.torch_device):
                    return engine.count_once(self._flops, sig, self._body, x, y)
            entry.x, entry.y = x.clone(), y.clone()
            graph = entry.graph = engine.capture(
                lambda: (self._body(entry.x, entry.y),), key, self.device.torch_device,
                owner=self, ptrs=DataParallelTrainer._operand_ptrs)
        entry.x.copy_(x)
        entry.y.copy_(y)
        return graph.replay()[0].clone()

    @property
    def captured(self) -> bool:
        """Whether this trainer's steps run as captured CUDA graphs."""
        return self._graph_reason is None

    def step(self, x, y, batch_size=None) -> PendingScalar:
        """One fused training step on the batch ``x``, ``y``; the step is
        admitted into the in-flight window (which blocks on the step two
        before it, never on this one) before telemetry records it, so the
        step time runs at completion pace and no sync is added."""
        self.optimizer.rescale_grad = 1.0
        x, y = self._local(self._raw(x)), self._local(self._raw(y))
        t_sp = time.perf_counter() if _tracing._ENABLED else 0.0
        with _telem.annotate("mx.dp.step"):
            lossv = self._one_step(x, y)
        if _tracing._ENABLED:
            _tracing.record_span("mx.dp.step", t_sp, time.perf_counter(),
                                 step=self._t, source="data_parallel")
        self._window.admit(lossv)
        if _telem._ENABLED:
            self._record_telemetry(self._signature(x, y), batch_size or self._examples(x), 1)
        return PendingScalar(lossv)

    def _examples(self, x, stacked: bool = False) -> int:
        """The global batch's examples, from this rank's part of it."""
        n = x.shape[1] if stacked else x.shape[0]
        if self.mesh.distributed and self._data_axes and self._data_axes[0][0] == 0:
            n *= math.prod(self.mesh.axis_size(a) for a in self._data_axes[0][1])
        return n

    def run_steps(self, x, y, n, stacked=False) -> NDArray:
        """``n`` steps, one after another (the reference scans them in one
        program): on one batch, or with ``stacked=True`` on ``x[i], y[i]``,
        each a replay of the captured step where it is captured. The learning
        rate follows the scheduler step by step; the float16 loss scale stays
        fixed for the call, as in the reference, and is updated once at its
        end. Returns the losses."""
        xr = self._local(self._raw(x), stacked)
        yr = self._local(self._raw(y), stacked)
        if stacked and (xr.shape[0] != n or yr.shape[0] != n):
            raise MXNetError(f"run_steps(stacked=True): leading dim must be n={n}, "
                             f"got {xr.shape[0]}/{yr.shape[0]}")
        self.optimizer.rescale_grad = 1.0
        t_sp = time.perf_counter() if _tracing._ENABLED else 0.0
        with _telem.annotate("mx.dp.run_steps"):
            losses = torch.stack([self._one_step(xr[i] if stacked else xr,
                                                 yr[i] if stacked else yr,
                                                 policy=i == n - 1) for i in range(n)])
        if _tracing._ENABLED:
            _tracing.record_span("mx.dp.run_steps", t_sp, time.perf_counter(), steps=n,
                                 step=self._t, source="data_parallel")
        # one run_steps call is one entry of the window, as in the reference
        self._window.admit(losses)
        if _telem._ENABLED:
            sig = self._signature(xr[0], yr[0]) if stacked else self._signature(xr, yr)
            self._record_telemetry(sig, self._examples(xr, stacked) * n, n)
        return NDArray(losses, self.device)

    def drain(self):
        """Wait until every step that was issued has finished on the device:
        the window's boundary sync, then the device's."""
        self._window.drain()
        if self.device.device_type == "gpu":
            torch.cuda.synchronize(self.device.torch_device)

    # -- telemetry (reference :694-795) -------------------------------------------
    def _grad_allreduce_bytes(self) -> int:
        """Ring estimate of the step's gradient all-reduce over dp: 2 (n - 1)
        / n of the trainable parameters' bytes."""
        if self._ar_bytes is None:
            n = self._dp_degree
            total = sum(p._param.numel() * p._param.element_size()
                        for p, t in zip(self._plist, self._trainable) if t)
            self._ar_bytes = (total * 2 * (n - 1)) // n if n > 1 else 0
        return self._ar_bytes

    def _zero_wire_bytes(self):
        if self._rs_bytes is None:
            if self._zero_plan:
                self._rs_bytes = _zero.reduce_scatter_wire_bytes(
                    self._zero_plan, self._dp_degree, self._comm_dtype)
                self._ag_bytes = _zero.all_gather_wire_bytes(self._zero_plan, self._dp_degree)
            else:
                self._rs_bytes = _overlap.allreduce_wire_bytes(
                    self._overlap_buckets, self._dp_degree, self._comm_dtype)
                self._ag_bytes = 0
        return self._rs_bytes, self._ag_bytes

    def _record_zero_telemetry(self, steps):
        """ZeRO's reduce-scatter of the gradient buckets and all-gather of
        the updated shards (ring estimates over the bucket plan)."""
        rs, ag = self._zero_wire_bytes()
        nb = len(self._zero_plan)
        _telem.record_comm("reduce_scatter", rs * steps, store="mesh",
                           calls=steps * nb, axis="dp")
        _telem.record_comm("all_gather", ag * steps, store="mesh",
                           calls=steps * nb, axis="dp")

    def _record_overlap_telemetry(self, steps):
        """The overlapped step's collectives issued inside the backward carry
        overlap "1"; ZeRO's all-gather runs after it and does not."""
        rs, ag = self._zero_wire_bytes()
        if self._zero_plan:
            nb = len(self._zero_plan)
            _telem.record_comm("reduce_scatter", rs * steps, store="mesh",
                               calls=steps * nb, overlapped=True, axis="dp")
            _telem.record_comm("all_gather", ag * steps, store="mesh",
                               calls=steps * nb, axis="dp")
        else:
            nb = len(self._overlap_buckets)
            _telem.record_comm("allreduce", rs * steps, store="mesh",
                               calls=steps * nb, overlapped=True, axis="dp")

    def _record_telemetry(self, sig, examples, steps):
        """Comm bytes, optimizer-state bytes, the signature's FLOPs into the
        engine's count, and the step (after the window's admission: no sync)."""
        flops = self._flops.get(sig, 0.0) * steps
        if self._dp_degree > 1:
            if self._overlap:
                self._record_overlap_telemetry(steps)
            elif self._zero:
                self._record_zero_telemetry(steps)
            else:
                _telem.record_comm("allreduce", self._grad_allreduce_bytes() * steps,
                                   store="mesh", calls=steps, axis="dp")
        _telem.record_optimizer_state(self._opt_state_replica_bytes(),
                                      source="data_parallel")
        engine.record_execution("step", flops, steps=steps)
        _telem.record_step(examples, source="data_parallel", steps=steps,
                           flops_per_step=(flops / steps if flops else None),
                           lr=float(self.optimizer.learning_rate),
                           dispatch_wait_seconds=self._window.wait_seconds)

    def sync(self):
        """The parameters are the ``Parameter``s' own tensors: wait for them."""
        self.drain()

    @property
    def num_update(self):
        return self._t

    def state_dict(self) -> Dict[str, Dict[str, torch.Tensor]]:
        """``{"params": {path: tensor}, "opt_state": {path: (tensor, ...)}}``
        by structural path, every sharded tensor gathered to its full shape
        (a collective on a mesh of ranks: every rank calls it)."""
        from .tensor_parallel import gather_tensor
        paths = {id(p): k for k, p in self.net._collect_params_with_prefix().items()}
        zero_states = self._full_zero("state") if self._zero_buckets else {}
        params, states = {}, {}
        for i, (p, st) in enumerate(zip(self._plist, self._opt_state)):
            key = paths.get(id(p), p.name)
            params[key] = gather_tensor(p._param.detach(), p.sharding, p._mesh)
            if i in zero_states:
                states[key] = zero_states[i]
            elif st:
                states[key] = tuple(gather_tensor(s, p.sharding, p._mesh) for s in st)
        return {"params": params, "opt_state": states, "num_update": self._t}


__all__ = ["DataParallelTrainer", "functional_optimizer", "refuse_trust_ratio", "PendingScalar"]
