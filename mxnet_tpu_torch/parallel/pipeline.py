"""Pipeline parallelism: the 1F1B schedule and ``PipelineTrainer``.

Counterpart of ``mxnet_tpu/parallel/pipeline.py``: ``pipeline_spec``,
``schedule_1f1b`` (:125-247) and ``PipelineTrainer`` (:250-1348) for the
composition ``dryrun_multichip`` runs (``__graft_entry__.py:160-179``):
1F1B with ``virtual_stages=1`` over a ``pp`` mesh axis, with an optional
``dp`` axis, in float32 or bfloat16 (float32 master weights), frozen lanes
(``grad_req='null'``), ``step``, ``drain``, ``sync``, ``num_update``,
``state_dict`` and ``load_state_dict`` (the ``pp`` snapshot kind of
``elastic/state.py``). ::

    embed, cells, head = net.pipeline_split()      # models/bert.py
    tr = PipelineTrainer(net, loss, "adam", {"learning_rate": 1e-4},
                         mesh=make_mesh({"pp": 2, "dp": 2}), dp_axis="dp",
                         num_microbatch=4)
    loss = tr.step(x, y)        # a PendingScalar of the global batch's mean

The reference runs the schedule as one ``lax.scan`` inside ``shard_map``.
Here every rank of a ``torch.distributed`` mesh (``parallel/mesh.py``) runs
its own stage of the same tick loop eagerly:

- **The ticks and lanes are the reference's.** M + 2(pp - 1) ticks; at tick
  t stage s runs the forward of microbatch t - s and the backward of
  microbatch t - 2(pp - 1) + s. The last stage turns a microbatch around
  within one tick. A lane outside [0, M) is skipped, where the reference
  computes it on zeros and masks it (:176-186).
- **Each in-flight microbatch keeps its autograd graph**, where the
  reference stashes the stage input and re-derives the vjp (:200-222). The
  numbers and the bound are the same: stage s holds at most
  min(M, 2(pp - 1 - s) + 1) microbatches, whatever M is (``last_stats``
  counts them), and no forward is run twice (K1 once a layer and
  microbatch, K2 and K3 once each in its backward).
- **The backward** of a microbatch is ``torch.autograd.grad`` of the head
  loss times 1 / (M dp) on the last stage, or of the stage output against
  the received cotangent elsewhere, with respect to the stage's trainable
  parameters and its input; the parameters' gradients are added into their
  buffers (microbatch sums of the 1 / (M dp)-scaled loss: the dp mean of the
  reference's sums over M, ``:930-935``), the input's goes to the previous
  stage.
- **The wires.** After each tick, one ``_dist_util.exchange`` round posts
  the activations to the next stage (tag ``FWD_TAG``) and the cotangents to
  the previous one (``BWD_TAG``). The reference's two cyclic ``ppermute``\\ s
  (:233-236) become the sends whose receive is live: both peers know the
  schedule, so a send is skipped exactly where the peer's receive is. At two
  stages both rings join the same pair of ranks; the tags keep them apart.
  At pp = 1 nothing is exchanged. The stages learn the shape and dtype of
  what they receive from the embed run once in predict mode (cached per
  batch signature; the reference's ``eval_shape``, :397).
- **The reductions** (reference :957-968): the embed's and the head's
  gradients (nonzero on stage 0 and on the last stage only) are summed over
  pp and dp in one all-reduce of a flat buffer, the stage's own layers' over
  dp in another; the loss over pp and dp. A group of one rank is skipped.
- **No stacked storage.** Every rank holds the model's Parameters; each
  updates its own stage's layers and the replicated embed and head, with one
  launch of the fused update (K5 for Adam, K4 for SGD, through
  ``functional_optimizer`` and its pointer table) for each weight decay,
  reading its scalars from the trainer's ``_hyper`` rows as the fused step
  does. The step runs eagerly on the card too: its tick loop of
  point-to-point rounds is not captured (ROADMAP A1b).
  Weight-decay indices follow the reference's convention (:551-556): embed
  leaves first, then the cell leaves (one index for a leaf of every layer),
  then the head, so a ``wd_mult`` set by index selects the same parameter in
  both packages. The embed and head stay bitwise equal across pp ranks: their
  reduced gradients and their Adam inputs are the same on every rank.
  ``sync()`` all-gathers each stage's layers over pp so that every rank's
  Parameters hold every weight, as the reference's single-controller
  ``sync`` (:1301-1326) leaves them.

Refused, as the reference refuses them (``tests/test_pipeline_1f1b.py``,
``tests/test_pipeline_parallel.py``): layers that do not divide into the
stages, cells that are not structurally identical, uninitialized
parameters, a batch that does not divide by M dp, a net without
``pipeline_split``, a stage block that keeps aux state (BatchNorm's running
statistics), a cell leaf frozen in some layers only. Not ported yet (ROADMAP
A2b, ``MXNetError``): ``schedule="gpipe"`` (also through
``MXNET_TPU_PP_SCHEDULE``), ``virtual_stages > 1``, ``zero_update``,
``comm_dtype``, ``tp_axis``, ``pipeline_apply`` and ``gpipe_schedule``. The
reference's ``remat``, ``bucket_bytes``, ``tp_mode`` and
``sequence_parallel`` serve those compositions only and are not taken.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..base import MXNetError, env, torch_dtype
from ..ndarray import NDArray
from .. import autograd
from .. import optimizer as opt_mod
from .. import _dist_util
from ..ops.cuda import fused_optimizer as _fo
from .data_parallel import (DataParallelTrainer, PendingScalar, functional_optimizer,
                            write_hyper)
from .mesh import current_mesh, require_axis
from .step_program import StepProgram, config_fingerprint, structural_fingerprint

__all__ = ["pipeline_spec", "pipeline_apply", "gpipe_schedule", "schedule_1f1b",
           "PipelineTrainer"]

env.declare("MXNET_TPU_PP_SCHEDULE", "1f1b", str,
            "Default PipelineTrainer schedule: '1f1b' (bounded activation "
            "memory) or 'gpipe' (grad-of-scan transpose)")

_A2B = ("not ported yet (ROADMAP A2b: the pipeline's other compositions, GPipe, "
        "interleaved virtual stages, ZeRO over dp, compressed wires and tensor "
        "parallelism; the port runs schedule='1f1b' over pp and dp)")

FWD_TAG = 1     # activations, stage s -> s + 1
BWD_TAG = 2     # cotangents, stage s -> s - 1


def pipeline_spec(num_stages: int, axis: str = "pp"):
    return {"num_stages": num_stages, "axis": axis}


def pipeline_apply(*args, **kwargs):
    """GPipe's differentiable schedule (reference :72-111)."""
    raise MXNetError(f"pipeline_apply: {_A2B}")


def gpipe_schedule(*args, **kwargs):
    """The reference's shim over ``pipeline_apply`` (:114-120)."""
    raise MXNetError(f"gpipe_schedule: {_A2B}")


def schedule_1f1b(embed_fn: Callable, stage_fn: Callable, head_loss_fn: Callable,
                  params: Sequence[torch.Tensor], grads: Sequence[torch.Tensor],
                  x_stack, y_stack, mesh=None, axis_name: str = "pp",
                  n_chunks: int = 1, act_meta=None, loss_scale: float = 1.0):
    """This rank's stage of the 1F1B schedule (reference :125-247), eager.

    ``embed_fn(x_mb, m) -> act`` (stage 0's entry), ``stage_fn(act, m) ->
    act`` (this stage's layers, shape-preserving), ``head_loss_fn(act, y_mb,
    m) -> scalar`` (the last stage's head and mean loss); ``x_stack`` and
    ``y_stack`` index microbatch m as ``x_stack[m]``. Run under
    ``torch.enable_grad()`` and ``autograd.record()``. The gradient of
    ``loss_scale`` times each microbatch's loss with respect to each of
    ``params`` that the stage reaches is added into ``grads`` (buffers of
    the same shapes). ``act_meta`` is ``(shape, dtype, device)`` of one
    activation (what the stages receive: activations and cotangents); a
    pipeline of more than one stage requires it.

    Returns ``(loss_sum, stats)``: the sum of the microbatches' losses (on
    the last stage; zero elsewhere) and ``{"ticks", "max_in_flight",
    "sends", "bytes"}`` of this rank (the sends from ``p2p_stats``)."""
    if n_chunks != 1:
        raise MXNetError(f"schedule_1f1b(n_chunks={n_chunks}): {_A2B}")
    n, s = (mesh.axis_size(axis_name), mesh.axis_index(axis_name)) if mesh else (1, 0)
    if n > 1 and act_meta is None:
        raise MXNetError("schedule_1f1b over more than one stage needs act_meta, "
                         "the (shape, dtype, device) of one activation")
    M = len(x_stack)
    group = mesh.group(axis_name) if n > 1 else None
    first, last = s == 0, s == n - 1
    params = list(params)
    stash: Dict[int, tuple] = {}
    loss_sum = None
    fwd_in = bwd_in = None
    stats = {"ticks": M + 2 * (n - 1), "max_in_flight": 0}
    sent = dict(_dist_util.p2p_stats)
    for t in range(stats["ticks"]):
        sends, recvs = [], []
        mf = t - s                        # the forward lane's microbatch
        if 0 <= mf < M:
            h_in = embed_fn(x_stack[mf], mf) if first else fwd_in.requires_grad_()
            h_out = stage_fn(h_in, mf)
            lossv = None
            if last:
                lossv = head_loss_fn(h_out, y_stack[mf], mf)
                part = lossv.detach().float()
                loss_sum = part if loss_sum is None else loss_sum + part
            else:
                sends.append((h_out.detach(), s + 1, FWD_TAG))
            stash[mf] = (h_in, h_out, lossv)
            stats["max_in_flight"] = max(stats["max_in_flight"], len(stash))
        mb = t - 2 * (n - 1) + s          # the backward lane's microbatch
        if 0 <= mb < M:
            h_in, h_out, lossv = stash.pop(mb)
            inputs = params if first else params + [h_in]
            if not inputs:              # stage 0 with every parameter frozen
                got = []
            elif last:
                got = torch.autograd.grad(lossv * loss_scale, inputs, allow_unused=True)
            else:
                got = torch.autograd.grad(h_out, inputs, bwd_in, allow_unused=True)
            pairs = [(b, g) for b, g in zip(grads, got) if g is not None]
            if pairs:
                torch._foreach_add_([b for b, _ in pairs], [g for _, g in pairs])
            if not first:
                sends.append((got[-1], s - 1, BWD_TAG))
            del got, h_in, h_out, lossv
        # the receives of the next tick's lanes: what the peers sent at this one
        fwd_in = bwd_in = None
        if not first and 0 <= t + 1 - s < M:
            fwd_in = torch.empty(act_meta[0], dtype=act_meta[1], device=act_meta[2])
            recvs.append((fwd_in, s - 1, FWD_TAG))
        if not last and 0 <= t + 1 - 2 * (n - 1) + s < M:
            bwd_in = torch.empty(act_meta[0], dtype=act_meta[1], device=act_meta[2])
            recvs.append((bwd_in, s + 1, BWD_TAG))
        if group is not None:
            _dist_util.exchange(sends, recvs, group)
    stats.update({k: _dist_util.p2p_stats[k] - sent[k] for k in ("sends", "bytes")})
    if loss_sum is None:
        dev = act_meta[2] if act_meta is not None else None
        loss_sum = torch.zeros((), dtype=torch.float32, device=dev)
    return loss_sum, stats


def _aux_blocks(block) -> List[str]:
    """The BatchNorm layers under ``block``: the port's blocks that write aux
    state (running statistics) in a training forward."""
    from ..gluon.nn import BatchNorm
    return [type(m).__name__ for m in block.modules() if isinstance(m, BatchNorm)]


class PipelineTrainer:
    """The 1F1B pipeline trainer over a ``pp`` axis (and an optional ``dp``
    axis) of a mesh of ranks; see the module docstring. ``net`` exposes
    ``pipeline_split() -> (embed, cells, head)``; ``loss`` is a Gluon
    ``Loss`` or a callable ``(pred, label) -> per-sample loss`` on tensors
    (its mean is the microbatch's loss)."""

    def __init__(self, net, loss, optimizer="sgd", optimizer_params=None, mesh=None,
                 num_microbatch: Optional[int] = None, pp_axis: str = "pp",
                 dp_axis: Optional[str] = None, tp_axis: Optional[str] = None, dtype=None,
                 schedule: Optional[str] = None, virtual_stages: int = 1,
                 zero_update: Optional[bool] = None, comm_dtype=None):
        self.net = net
        self.loss = loss
        self.mesh = mesh if mesh is not None else current_mesh()
        self.n_stages = require_axis(self.mesh, pp_axis, "pipeline stages")
        self.pp_axis, self.dp_axis, self.tp_axis = pp_axis, dp_axis, tp_axis
        self.n_dp = require_axis(self.mesh, dp_axis, "data parallelism") if dp_axis else 1
        if tp_axis is not None:
            raise MXNetError(f"PipelineTrainer(tp_axis={tp_axis!r}): {_A2B}")
        if schedule is None:
            schedule = env.get("MXNET_TPU_PP_SCHEDULE") or "1f1b"
        if schedule not in ("1f1b", "gpipe"):
            raise MXNetError(f"unknown pipeline schedule {schedule!r}; use '1f1b' or 'gpipe'")
        if schedule == "gpipe":
            raise MXNetError(f"PipelineTrainer(schedule='gpipe'): {_A2B}")
        self.schedule = schedule
        self.virtual_stages = int(virtual_stages)
        if self.virtual_stages < 1:
            raise MXNetError("virtual_stages must be >= 1")
        if self.virtual_stages > 1:
            raise MXNetError(f"PipelineTrainer(virtual_stages={virtual_stages}): {_A2B}")
        if zero_update is None:
            zero_update = bool(env.get("MXNET_TPU_ZERO"))
        if zero_update:
            raise MXNetError(f"PipelineTrainer(zero_update=True): {_A2B}")
        if comm_dtype is not None:
            raise MXNetError(f"PipelineTrainer(comm_dtype={comm_dtype!r}): {_A2B}")

        if not hasattr(net, "pipeline_split"):
            raise MXNetError(f"{type(net).__name__} has no pipeline_split(); implement it "
                             f"returning (embed_block, identical_cells, head_block)")
        embed, cells, head = net.pipeline_split()
        if len(cells) % self.n_stages != 0:
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

        self.compute_dtype: Optional[torch.dtype] = None
        if dtype is not None and torch_dtype(dtype) != torch.float32:
            self.compute_dtype = torch_dtype(dtype)
            if self.compute_dtype != torch.bfloat16:
                raise MXNetError(f"PipelineTrainer supports float32/bfloat16, got {dtype!r}")
        self.optimizer = optimizer if isinstance(optimizer, opt_mod.Optimizer) \
            else opt_mod.create(optimizer, **(optimizer_params or {}))
        self._init_fn, self._update_fn, self._hyper_fn = functional_optimizer(self.optimizer)
        self.num_microbatch = int(num_microbatch if num_microbatch is not None
                                  else self.n_stages)
        self.device = self.mesh.device
        everything = self._embed_plist + self._head_plist + [p for cp in self._cell_plists
                                                             for p in cp]
        elsewhere = [p.name for p in everything if p.list_ctx()[0] != self.device]
        if elsewhere:
            raise MXNetError(f"parameters {elsewhere[:3]} are not on the mesh's device "
                             f"{self.device}")

        # this rank's stage; the schedule order of the layers (v = 1: identity)
        self.stage = self.mesh.axis_index(pp_axis)
        L = self.layers_per_stage
        self._stack_order = list(range(self.n_layers))
        self._own = list(range(self.stage * L, (self.stage + 1) * L))
        # weight-decay indices: embed leaves, then the cell leaves, then the head
        nE, nS = len(self._embed_plist), len(ref)
        self._wd_e = [self.optimizer._get_wd(i) for i in range(nE)]
        self._wd_s = [self.optimizer._get_wd(nE + i) for i in range(nS)]
        self._wd_h = [self.optimizer._get_wd(nE + nS + i) for i in range(len(self._head_plist))]
        # optimizer state: the embed, this stage's layers (per layer), the head
        self._opt_e = [self._init_fn(p._param.detach()) if t else ()
                       for p, t in zip(self._embed_plist, self._tr_e)]
        self._opt_h = [self._init_fn(p._param.detach()) if t else ()
                       for p, t in zip(self._head_plist, self._tr_h)]
        self._opt_s = [[self._init_fn(self._cell_plists[m][i]._param.detach())
                        if self._tr_s[i] else () for m in self._own] for i in range(nS)]
        # gradient buffers: views into one flat buffer for the replicated
        # embed and head (summed over pp and dp) and one for the stage's own
        # layers (summed over dp)
        rep = [p for p, t in zip(self._embed_plist, self._tr_e) if t] + \
              [p for p, t in zip(self._head_plist, self._tr_h) if t]
        own = [self._cell_plists[m][i] for m in self._own for i in range(nS) if self._tr_s[i]]
        self._rep_flat = self._flat_grads(rep)
        self._own_flat = self._flat_grads(own)
        # what the schedule differentiates on this stage, and each weight
        # decay's update lists (weights, gradients, states)
        first, last = self.stage == 0, self.stage == self.n_stages - 1
        self._train = own + ([p for p, t in zip(self._embed_plist, self._tr_e) if t]
                             if first else []) + \
            ([p for p, t in zip(self._head_plist, self._tr_h) if t] if last else [])
        self._used = (self._embed_plist if first else []) + \
            [self._cell_plists[m][i] for m in self._own for i in range(nS)] + \
            (self._head_plist if last else [])
        self._groups: Dict[float, Tuple[list, list, list]] = {}

        def add(p, wd, state):
            ws, gs, ss = self._groups.setdefault(float(wd), ([], [], []))
            ws.append(p._param)
            gs.append(p._grad)
            ss.append(state)
        for p, t, wd, st in zip(self._embed_plist, self._tr_e, self._wd_e, self._opt_e):
            if t:
                add(p, wd, st)
        for i in range(nS):
            if self._tr_s[i]:
                for j, m in enumerate(self._own):
                    add(self._cell_plists[m][i], self._wd_s[i], self._opt_s[i][j])
        for p, t, wd, st in zip(self._head_plist, self._tr_h, self._wd_h, self._opt_h):
            if t:
                add(p, wd, st)

        dist_mesh = self.mesh.distributed
        self._pp_group = self.mesh.group(pp_axis) if dist_mesh and self.n_stages > 1 else None
        self._dp_group = self.mesh.group(dp_axis) if dist_mesh and self.n_dp > 1 else None
        rep_axes = tuple(a for a in (pp_axis, dp_axis) if a is not None)
        self._rep_group = self.mesh.group(rep_axes) if dist_mesh and \
            self.mesh.group_size(rep_axes) > 1 else None
        if self._pp_group is not None:
            # every rank of the pp group takes part in its first collective
            # (NCCL sets its communicator up there), before the first tick's
            # point-to-point round, which joins two of them only
            dist.all_reduce(torch.zeros(1, device=self.device.torch_device),
                            group=self._pp_group)
        self._hyper = torch.zeros((max(1, len(self._groups)), len(_fo.HYPER_FIELDS)),
                                  dtype=torch.float32, device=self.device.torch_device)
        self._t = 0
        self._act_meta: Dict[tuple, tuple] = {}
        self.last_stats: Optional[dict] = None
        self._program = StepProgram(f"pp.step[{type(net).__name__}]", (
            "pp_step", structural_fingerprint(net), config_fingerprint(
                optimizer=type(self.optimizer).__name__,
                opt_conf=tuple(sorted(
                    (k, repr(v)) for k, v in vars(self.optimizer).items()
                    if isinstance(v, (int, float, bool, str, type(None))))),
                wds=tuple(float(w) for w in self._wd_e + self._wd_s + self._wd_h),
                loss=self.loss, mesh=tuple(sorted(self.mesh.shape.items())),
                axis_order=self.mesh.axis_names, pp_axis=pp_axis, dp_axis=dp_axis,
                tp_axis=tp_axis, schedule=self.schedule,
                virtual_stages=self.virtual_stages, num_microbatch=self.num_microbatch,
                trainable=(tuple(self._tr_e), tuple(self._tr_s), tuple(self._tr_h)),
                compute_dtype=str(self.compute_dtype))))

    def _flat_grads(self, plist) -> Optional[torch.Tensor]:
        """One flat f32 buffer whose views, 64 elements apart, become the
        gradient buffers of ``plist``."""
        if not plist:
            return None
        align = 64
        counts = [-(-p._param.numel() // align) * align for p in plist]
        flat = torch.zeros(sum(counts), dtype=plist[0]._param.dtype,
                           device=self.device.torch_device)
        off = 0
        for p, n in zip(plist, counts):
            if p._param.dtype != flat.dtype:
                raise MXNetError(f"{p.name} is {p._param.dtype}, the other trained "
                                 f"parameters {flat.dtype}")
            p._grad = flat[off:off + p._param.numel()].view(p._param.shape)
            autograd._mark(p._param, p._grad, p.grad_req)
            off += n
        return flat

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

    def _embed_fn(self, x, m):
        return self._embed(NDArray(x, self.device))._data

    def _stage_fn(self, h, m):
        out = NDArray(h, self.device)
        for j in self._own:
            out = self._cells[j](out)
        return out._data

    def _head_loss_fn(self, h, y, m):
        return self._loss_mean(self._head(NDArray(h, self.device)), y)

    def _activation(self, xs) -> tuple:
        """``(shape, dtype, device)`` of one activation between stages: the
        shape of the embed's output on microbatch 0 in predict mode (no
        dropout draws), once for each batch signature; the dtype the compute
        dtype where one is set (the reference's ``_ppermute_stats``, :404)."""
        key = (tuple(xs.shape), xs.dtype)
        if key not in self._act_meta:
            with torch.no_grad(), autograd.pause(train_mode=False):
                a = self._embed_fn(xs[0], 0)
            self._act_meta[key] = (tuple(a.shape), self.compute_dtype or a.dtype, a.device)
        return self._act_meta[key]

    def _forward_backward(self, xs, ys) -> torch.Tensor:
        """The schedule's pass over the microbatches: the loss mean of the
        global batch (every rank), the reduced gradients in the buffers."""
        M = self.num_microbatch
        cdt = self.compute_dtype
        with torch.no_grad():
            for flat in (self._rep_flat, self._own_flat):
                if flat is not None:
                    flat.zero_()
        meta = self._activation(xs) if self.n_stages > 1 else None
        try:
            with torch.enable_grad(), autograd.record(train_mode=True):
                if cdt is not None:
                    for p in self._used:
                        if p._param.is_floating_point():
                            p._compute = p._param.to(cdt)
                loss_sum, self.last_stats = schedule_1f1b(
                    self._embed_fn, self._stage_fn, self._head_loss_fn,
                    [p._param for p in self._train], [p._grad for p in self._train],
                    xs, ys, mesh=self.mesh if self.n_stages > 1 else None,
                    axis_name=self.pp_axis, act_meta=meta,
                    loss_scale=1.0 / (M * self.n_dp))
        finally:
            for p in self._used:
                p._compute = None
        with torch.no_grad():
            lossv = loss_sum.to(self.device.torch_device) / M
            if self._rep_group is not None:
                lossv = lossv / self.n_dp
                dist.all_reduce(lossv, group=self._rep_group)
                if self._rep_flat is not None:
                    dist.all_reduce(self._rep_flat, group=self._rep_group)
            if self._dp_group is not None and self._own_flat is not None:
                dist.all_reduce(self._own_flat, group=self._dp_group)
        return lossv

    def step(self, x, y) -> PendingScalar:
        """One 1F1B training step on the global batch ``x``, ``y``."""
        xr, yr = self._raw(x), self._raw(y)
        M, B = self.num_microbatch, xr.shape[0]
        self.optimizer.rescale_grad = 1.0
        if B % (M * self.n_dp) != 0:
            raise MXNetError(f"batch {B} must divide by num_microbatch*dp = {M}*{self.n_dp}")
        xs, ys = self._stack(xr), self._stack(yr)
        self._t += 1
        self.optimizer.num_update = self._t
        lr = np.float32(self.optimizer.learning_rate)
        write_hyper(self._hyper, [self._hyper_fn(self._t, lr, wd) for wd in self._groups])
        lossv = self._forward_backward(xs, ys)
        with torch.no_grad():
            for k, (ws, gs, ss) in enumerate(self._groups.values()):
                self._update_fn(ws, gs, ss, self._hyper[k])
        return PendingScalar(lossv)

    def drain(self):
        """Wait until every step that was issued has finished on the device."""
        if self.device.device_type == "gpu":
            torch.cuda.synchronize(self.device.torch_device)

    def sync(self):
        """Leave every weight in every rank's Parameters: each cell leaf's
        layers all-gathered over pp from the stages that own them (a
        collective every rank of the mesh calls). The embed and head are the
        Parameters' own tensors on every rank."""
        self.drain()
        if self._pp_group is None:
            return
        L = self.layers_per_stage
        with torch.no_grad():
            for i in range(len(self._cell_plists[0])):
                mine = torch.stack([self._cell_plists[m][i]._param.detach() for m in self._own])
                full = torch.empty((self.n_layers,) + tuple(mine.shape[1:]),
                                   dtype=mine.dtype, device=mine.device)
                dist.all_gather_into_tensor(full, mine, group=self._pp_group)
                for m in range(self.n_layers):
                    if m // L != self.stage:
                        self._cell_plists[m][i]._param.detach().copy_(full[m])

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
