"""The fused training step on one device: ``DataParallelTrainer``.

Counterpart of ``mxnet_tpu/parallel/data_parallel.py``: ``functional_optimizer``
(:51) and ``DataParallelTrainer`` (:276) with its step body
(``_make_apply_fn`` :237, ``_build_step`` :805), ``run_steps``, ``step``,
``drain``, ``sync`` and ``num_update`` (:1373-1567). The reference compiles
forward, backward and the update of every parameter into one jit, with lr,
t and the loss scale as device arguments (:805, :832, :1479-1492). Here the
step body (``_body``: forward, backward, the copy into the gradient
buckets, their all-reduce, the update) is written once, and the update of
every parameter is one launch of the fused multi-tensor kernel
(``ops/cuda/fused_optimizer.py``, kernels K4 and K5 of
``csrc/fused_optimizer.cu``) with the rules the reference's step applies:
``sgd_update``, ``sgd_mom_update`` and ``adam_update`` with the bias
correction folded into lr (``_k_sgd``, ``_k_sgd_mom``, ``_k_adam``). The
update reads its scalars (lr, momentum, wd, ..., one row a weight decay)
from the trainer's ``_hyper`` tensor on the device, which the host writes
before each step, so a new learning rate costs no new program.

The compiled step: on a CUDA device the body is captured as a CUDA graph
(``engine.capture``). Step 1 of a signature (the shapes and dtypes of x and
y) runs the body eagerly on the engine's side stream as the warm-up (it
builds the kernels, the update's pointer tables, cuBLAS's and autograd's
state, NCCL's communicator); step 2 captures the body over static buffers
(x, y, ``_hyper`` and the loss slot) and replays it; every later step
replays it. The host's work a step is then: copy x and y into the static
buffers, write ``_hyper`` for this step's lr and t (through a pinned
buffer, asynchronously), replay, clone the loss slot into the
``PendingScalar``. One capture per signature and trainer (the key holds
``id(trainer)``, ``engine.cache_stats()`` counts them); a new lr or t
captures nothing. A parameter or gradient buffer given new storage since
the capture (the engine's ``storage_epoch``, then the addresses) drops the
graph, and the next step warms up again; the elastic restore writes in
place and keeps it. The kernels' launch counters count each replay
(``engine``). What runs the body eagerly every step (``_graph_reason``):

- ``"cpu"``: a CPU device, where the kernels' plain versions run;
- ``"float16"``: the loss-scaled step reads its overflow flag on the host
  (``_unscale_finite``); its flag on the device is ROADMAP A1b's;
- ``"gloo"``: a mesh of ranks whose groups are not all NCCL (gloo cannot
  be captured).

At world size 1 over NCCL the all-reduces (the replicated step's buckets,
ZeRO's sum over the data axes other than the batch axis, the loss) are
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
- under float16 (eager, see above), multiplies the gradients by
  1/loss_scale and checks them for inf and NaN; reading that flag is the
  step's one host sync. An overflow skips the whole update, and
  ``LossScaler.update_from_step`` halves the scale (:1514-1518);
- updates every trainable parameter and its state in place with one launch
  (one per distinct weight decay, each reading its row of ``_hyper``; one
  in the models of this repository), through the cached pointer table: the
  parameters, gradient buffers and states keep their storage from step to
  step.

``step`` returns a ``PendingScalar`` of the loss, which syncs only when read,
so float32 and bfloat16 steps, captured or not, run without a host sync. The
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
  every rank;
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
from .. import _dist_util
from . import overlap as _overlap
from . import zero as _zero
from ..gluon.loss import Loss as GluonLoss
from ..ops.cuda import fused_optimizer as _fo
from .mesh import P, activate, current_mesh, require_axis
from .step_program import StepProgram, config_fingerprint, structural_fingerprint
from .tensor_parallel import shard_tensor, spec_axes

def _f32(x) -> np.float32:
    return np.float32(x)


def functional_optimizer(opt: "opt_mod.Optimizer"):
    """``(init, update, hyper)`` for an ``SGD`` or ``Adam``: ``init(weight)``
    -> the state tuple; ``hyper(t, lr, wd)`` -> the 10 scalars of step t's
    update (``fused_optimizer.HYPER_FIELDS``; Adam's bias correction folded
    into lr as ``_k_adam`` does); ``update(weights, grads, states, hyper)``
    applies the rule to the lists in place, reading the scalars from
    ``hyper``, a float32 tensor of those 10 on the weights' device: one
    launch of K4/K5's device form on the card, the plain version on the
    CPU."""
    clip = opt.clip_gradient if opt.clip_gradient is not None else -1.0

    if isinstance(opt, opt_mod.Adam):
        def init(w):
            return (torch.zeros_like(w), torch.zeros_like(w))

        def hyper(t, lr, wd):
            # _k_adam: lr_t = lr * sqrt(c2) / c1, all f32 (t an f32 step count)
            c1 = np.float32(1) - _f32(opt.beta1) ** _f32(t)
            c2 = np.float32(1) - _f32(opt.beta2) ** _f32(t)
            lr_t = _f32(lr) * np.sqrt(c2) / c1
            return _fo.hyper_values(lr=lr_t, beta1=opt.beta1, beta2=opt.beta2,
                                    epsilon=opt.epsilon, wd=wd,
                                    rescale_grad=opt.rescale_grad, clip_gradient=clip)

        def update(ws, gs, states, h):
            ms, vs = [s[0] for s in states], [s[1] for s in states]
            _fo.fused_adam_update_hyper(ws, gs, ms, vs, h, out=(ws, ms, vs))
        return init, update, hyper

    if isinstance(opt, opt_mod.SGD):
        def hyper(t, lr, wd):
            return _fo.hyper_values(lr=lr, momentum=opt.momentum, wd=wd,
                                    rescale_grad=opt.rescale_grad, clip_gradient=clip)

        if opt.momentum == 0.0:
            def init(w):
                return ()

            def update(ws, gs, states, h):
                _fo.fused_sgd_update_hyper(ws, gs, h, out=(ws,))
            return init, update, hyper

        def init(w):
            return (torch.zeros_like(w),)

        def update(ws, gs, states, h):
            moms = [s[0] for s in states]
            _fo.fused_sgd_mom_update_hyper(ws, gs, moms, h, out=(ws, moms))
        return init, update, hyper

    raise MXNetError(f"no functional adapter for optimizer {type(opt).__name__}: "
                     f"the fused step ports SGD and Adam; the other optimizers are "
                     f"ROADMAP A5")


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
    inputs."""

    __slots__ = ("graph", "x", "y")

    def __init__(self):
        self.graph = None
        self.x = self.y = None


class PendingScalar:
    """A loss on the device that syncs only when read (reference
    ``engine/async_feed.py`` ``PendingScalar``): ``float()``, ``item()``
    and ``asnumpy()`` wait for it; holding it or ``repr()`` does not."""

    __slots__ = ("_raw",)

    def __init__(self, raw: torch.Tensor):
        self._raw = raw

    @property
    def raw(self) -> torch.Tensor:
        """The loss tensor on the device (no sync)."""
        return self._raw

    def __float__(self):
        return float(self._raw.float().item())

    def item(self):
        return self.__float__()

    def asnumpy(self):
        return self._raw.detach().float().cpu().numpy()

    def __array__(self, dtype=None, copy=None):
        out = self.asnumpy()
        return out.astype(dtype) if dtype is not None else out

    def __repr__(self):
        return f"PendingScalar({self._raw.dtype}, {self._raw.device})"


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
        self._hyper = torch.zeros((max(1, len(self._wd_order)), len(_fo.HYPER_FIELDS)),
                                  dtype=torch.float32, device=self.device.torch_device)
        self._graphs: Dict[tuple, _StepGraph] = {}
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
        if self._scaler is not None:
            return "float16"
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
        t = a._data if isinstance(a, NDArray) else torch.as_tensor(np.asarray(a))
        return t.to(self.device.torch_device)

    def _local(self, t: torch.Tensor, stacked: bool = False) -> torch.Tensor:
        """This rank's part of a global batch tensor under ``data_spec``
        (dims shift by one for a stacked run)."""
        if not self.mesh.distributed:
            return t
        for d, axes in self._data_axes:
            d += int(stacked)
            if d >= t.dim():
                continue
            t = shard_tensor(t, P(*([None] * d), axes), self.mesh)
        return t

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

    def _compress_reduce(self):
        """2-bit quantization with error feedback of every trainable floating
        gradient, then their mean over the batch axis (module docstring)."""
        thr = float(self._compression.get("threshold", 0.5))
        for p, r in zip(self._plist, self._comp_resid):
            if r is None:
                continue
            g = p._grad
            acc = g.float() + r
            q = torch.where(acc >= thr, thr, torch.where(acc <= -thr, -thr, 0.0))
            r.copy_(acc - q)
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

    def _unscale_finite(self, scale) -> bool:
        """Gradients times 1/scale in place; True if all are finite on every
        rank (syncs)."""
        grads = [p._grad for p, t in zip(self._plist, self._trainable)
                 if t and p._grad.is_floating_point()]
        found = torch.zeros((), dtype=torch.float32, device=self.device.torch_device)
        inv = torch.full((), 1.0 / scale, dtype=torch.float32,
                         device=self.device.torch_device)
        torch._amp_foreach_non_finite_check_and_unscale_(grads, found, inv)
        if self.mesh.distributed:
            dist.all_reduce(found, op=dist.ReduceOp.MAX,
                            group=self.mesh.group(self.mesh.axis_names))
        return not bool(found.item())

    def _update(self):
        with torch.no_grad():
            if self._zero_buckets and not self._overlap:
                self._reduce_zero()
            for k, wd in enumerate(self._wd_order):
                idx, segments = self._groups.get(wd, []), self._segments.get(wd, [])
                self._update_fn([self._plist[i]._param for i in idx] + [w for w, _, _ in segments],
                                [self._plist[i]._grad for i in idx] + [g for _, g, _ in segments],
                                [self._opt_state[i] for i in idx] + [s for _, _, s in segments],
                                self._hyper[k])
            if self._zero_buckets:
                self._gather_zero()

    def _body(self, x, y, scale) -> tuple:
        """The step's device work: forward, backward, the gradient buckets'
        reduction and the update (skipped after a float16 overflow)."""
        if self._overlap:
            lossv = self._forward_backward_overlap(x, y, scale)
        else:
            lossv = self._forward_backward(x, y, scale)
        finite = True
        if scale is not None:
            finite = self._unscale_finite(scale)
        if self._compression and finite:
            with torch.no_grad():
                self._compress_reduce()
        if finite:
            self._update()
        return lossv, finite

    def _one_step(self, x, y, scale) -> tuple:
        self._t += 1
        self.optimizer.num_update = self._t
        lr = _f32(self.optimizer.learning_rate)
        write_hyper(self._hyper, [self._hyper_fn(self._t, lr, wd) for wd in self._wd_order])
        if self._graph_reason is None:
            return self._graph_step(x, y), True
        return self._body(x, y, scale)

    # -- the captured step -------------------------------------------------------
    def _operand_ptrs(self):
        return tuple((p._param.data_ptr(), p._grad.data_ptr() if p._grad is not None else 0)
                     for p in self._plist)

    def _graph_step(self, x, y) -> torch.Tensor:
        """The step on the card: warm up at a signature's first step, capture
        at its second, replay from then on (module docstring)."""
        sig = (tuple(x.shape), x.dtype, tuple(y.shape), y.dtype)
        key = ("dp_step", id(self), self._program.fingerprint, sig)
        entry = self._graphs.get(sig)
        graph = engine.lookup(key) if entry is not None else None
        if graph is None:
            if entry is None or entry.graph is not None:     # new, or its graph went stale
                self._graphs[sig] = _StepGraph()
                with engine.side_stream(self.device.torch_device):
                    lossv, _ = self._body(x, y, None)
                return lossv
            entry.x, entry.y = x.clone(), y.clone()
            graph = entry.graph = engine.capture(
                lambda: (self._body(entry.x, entry.y, None)[0],), key, self.device.torch_device,
                owner=self, ptrs=DataParallelTrainer._operand_ptrs)
        entry.x.copy_(x)
        entry.y.copy_(y)
        return graph.replay()[0].clone()

    @property
    def captured(self) -> bool:
        """Whether this trainer's steps run as captured CUDA graphs."""
        return self._graph_reason is None

    def step(self, x, y, batch_size=None) -> PendingScalar:
        """One fused training step on the batch ``x``, ``y``."""
        self.optimizer.rescale_grad = 1.0
        scale = self._scaler.loss_scale if self._scaler is not None else None
        lossv, finite = self._one_step(self._local(self._raw(x)),
                                       self._local(self._raw(y)), scale)
        if self._scaler is not None:
            self._scaler.update_from_step(finite)
        return PendingScalar(lossv)

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
        scale = self._scaler.loss_scale if self._scaler is not None else None
        losses, all_finite = [], True
        for i in range(n):
            lossv, finite = self._one_step(xr[i] if stacked else xr,
                                           yr[i] if stacked else yr, scale)
            losses.append(lossv)
            all_finite = all_finite and finite
        if self._scaler is not None:
            self._scaler.update_from_step(all_finite)
        return NDArray(torch.stack(losses), self.device)

    def drain(self):
        """Wait until every step that was issued has finished on the device."""
        if self.device.device_type == "gpu":
            torch.cuda.synchronize(self.device.torch_device)

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


__all__ = ["DataParallelTrainer", "functional_optimizer", "PendingScalar"]
