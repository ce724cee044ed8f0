"""Expert-parallel MoE training recipe.

Counterpart of ``mxnet_tpu/recipes/moe.py``. ``MoETrainer`` (:75) is a
``DataParallelTrainer`` over a ``{dp, ep}`` mesh of ranks:

- the batch is split over both axes (``data_spec=P((dp, ep))``): every rank
  gates, attends and computes the loss on its own token shard;
- the expert parameters (tagged ``_is_moe_expert`` by the model's cells)
  are placed over ``ep`` (``P(ep, None, None)``): each rank keeps E/ep
  experts and their Adam state, and the cells exchange slots with
  ``parallel.moe.expert_parallel_moe``. Their gradients already sum every
  ep peer's routed contribution (the exchange's backward), so their
  gradient buckets are summed over dp only (the reference's
  ``pmean(g, dp) / ep``, :237, since each rank's loss is weighted by its
  1/(dp*ep) share);
- the other parameters take ``zero_update``: their buckets are summed over
  ep and reduce-scattered over dp, the shard updated and all-gathered
  (:246-252). The experts join the update as whole tensors, so the update
  stays one launch of K5 for each weight decay;
- each rank's loss is its token mean plus ``aux_loss_weight`` times the sum
  of the cells' load-balancing losses (:215-222), weighted by its share; the
  returned loss is their sum over the mesh, the global mean.

The dropped-token count stays a device tensor on the trainer and is read at
``drain()`` (this rank's, ``dropped_tokens``) or summed over the mesh by
``global_dropped_tokens()`` (a collective every rank calls); with telemetry
on, each drain books that delta into ``mx_moe_dropped_tokens_total``
(reference :313-331), and a step books its all-to-all wire bytes
(``_a2a_step_bytes``, :359). ``last_assignments`` holds the last
step's routing on this rank (each cell's expert per token and choice, -1
where dropped). On the card the step is captured as a CUDA graph where
``DataParallelTrainer`` captures it (NCCL groups): the dropped count is
added on the device by each replay, and ``last_assignments`` are then the
capture's tensors, which each replay rewrites; at ep = 1 the all-to-alls
are not issued, and the buckets' all-reduces and the loss's are NCCL calls
inside the graph. ``_a2a_step_bytes`` gives a step's dispatch/combine wire
bytes as the reference books them. On a mesh of one device the cells run
``moe_ffn`` and every parameter is whole.
``token_cross_entropy``, ``make_model`` (the tiny preset: its size knobs
are fixed, so ``make_model(units=768)`` raises ``TypeError`` as in the
reference; build a larger model with ``models.MoETransformerLM``),
``make_oracle`` (``dense_ffn=True``) and ``make_trainer`` complete the
recipe.
"""
from __future__ import annotations

import contextlib
import functools

import numpy as _np
import torch
import torch.distributed as dist

from ..base import MXNetError
from .. import optimizer as opt_mod
from .. import telemetry as _telem
from ..parallel import moe as _moe
from ..parallel.data_parallel import DataParallelTrainer
from ..parallel.mesh import P, activate, current_mesh, require_axis
from ..parallel.step_program import StepProgram
from ..parallel.tensor_parallel import gather_tensor, spec_axes
from .long_context import token_cross_entropy

__all__ = ["MoETrainer", "token_cross_entropy", "make_model", "make_oracle", "make_trainer"]


def _moe_cells(block, out=None):
    """Every MoEPositionwiseFFN in the tree."""
    from ..models.moe_transformer import MoEPositionwiseFFN
    if out is None:
        out = []
    if isinstance(block, MoEPositionwiseFFN):
        out.append(block)
    for child in block._children.values():
        _moe_cells(child, out)
    return out


class MoETrainer(DataParallelTrainer):
    """The dp x ep step for MoE transformers (see the module docstring).
    ``net`` is initialized; its expert parameters carry ``_is_moe_expert``."""

    def __init__(self, net, loss, optimizer="adam", optimizer_params=None, mesh=None,
                 dp_axis="dp", ep_axis="ep", aux_loss_weight=1e-2, comm_dtype=None,
                 bucket_bytes=None):
        mesh = mesh if mesh is not None else current_mesh()
        require_axis(mesh, dp_axis, "MoETrainer data parallelism")
        self._ep_axis = ep_axis
        self._ep_degree = require_axis(mesh, ep_axis, "MoETrainer expert parallelism")
        self._aux_weight = float(aux_loss_weight)
        self._metrics = None
        n_expert = 0
        for p in net.collect_params().values():
            if getattr(p, "_is_moe_expert", False):
                if p.shape is None:
                    raise MXNetError(f"expert parameter {p.name} has no shape; initialize "
                                     f"the net first")
                if p.shape[0] % self._ep_degree:
                    raise MXNetError(f"expert parameter {p.name}: E={p.shape[0]} not "
                                     f"divisible by ep={self._ep_degree}")
                p.sharding = P(ep_axis, *([None] * (len(p.shape) - 1)))
                n_expert += 1
        if not n_expert:
            raise MXNetError("net has no _is_moe_expert parameters; MoETrainer expects a "
                             "MoE model (models/moe_transformer.py)")
        super().__init__(net, loss, optimizer=optimizer, optimizer_params=optimizer_params,
                         mesh=mesh, batch_axis_name=dp_axis, dtype="float32",
                         data_spec=P((dp_axis, ep_axis)), zero_update=True,
                         bucket_bytes=bucket_bytes, comm_dtype=comm_dtype,
                         overlap_grads=False)
        self._dropped = torch.zeros((), dtype=torch.int64, device=self.device.torch_device)
        self.dropped_tokens = 0
        self.last_assignments = []     # the last step's routing, one (N, K) tensor a cell
        # the step's identity gains the MoE terms (reference :122-127)
        self._program = StepProgram(
            f"moe.step[{type(net).__name__}]", self._program.key_base + (
                ("moe", ep_axis, self._ep_degree, self._aux_weight, self._comm_dtype),))

    def _expert(self, p) -> bool:
        return bool(getattr(p, "_is_moe_expert", False))

    # -- the parent's hooks ---------------------------------------------------------
    def _validate_zero(self):
        """Only the experts are sharded (over ep); the batch is split over
        both axes; LAMB and LARS raise (reference :129-153)."""
        bad = [p.name for p in self._plist if not self._expert(p) and spec_axes(p.sharding)]
        if bad:
            raise MXNetError(f"MoETrainer shards only expert parameters (over "
                             f"{self._ep_axis!r}); found other sharded params {bad[:3]}")
        if isinstance(self.optimizer, (opt_mod.LAMB, opt_mod.LARS)):
            raise MXNetError(f"{type(self.optimizer).__name__} per-tensor trust ratios do not "
                             f"decompose over flat bucket shards")

    def _may_shard_over_data(self, p) -> bool:
        return self._expert(p)

    def _zero_entries(self):
        """The parent's bucket entries less the experts (reference :155)."""
        return [e for e in super()._zero_entries() if not self._expert(self._plist[e[0]])]

    def _grad_axes(self, i) -> tuple:
        return (self.batch_axis,) if self._expert(self._plist[i]) else self._reduce_axes

    def _forward_scope(self):
        stack = contextlib.ExitStack()
        if self.mesh.distributed:
            stack.enter_context(activate(self.mesh))
            stack.enter_context(_moe.expert_axis(self._ep_axis, self._comm_dtype))
        self._metrics = stack.enter_context(_moe.collect_metrics())
        return stack

    def _loss_mean(self, pred, label):
        """The token mean plus the weighted aux loss of the cells run in the
        forward just before."""
        mc, self._metrics = self._metrics, None
        task = super()._loss_mean(pred, label)
        if mc is None:
            return task
        self._dropped += mc.dropped_total().to(self._dropped.device)
        self.last_assignments = mc.assignments
        return task + self._aux_weight * mc.aux_loss().to(task.device)

    # -- dropped tokens -----------------------------------------------------------
    def drain(self):
        """Wait for the issued steps; add this rank's dropped assignments
        since the last drain to ``dropped_tokens``."""
        super().drain()
        n = int(self._dropped.item())
        self.dropped_tokens += n
        self._dropped.zero_()
        if _telem._ENABLED:
            _telem.record_moe_dropped(n, source="moe")

    def global_dropped_tokens(self) -> int:
        """``dropped_tokens`` summed over the mesh (after a drain on every
        rank; a collective every rank calls)."""
        self.drain()
        if not self.mesh.distributed:
            return self.dropped_tokens
        group = self.mesh.group(self.mesh.axis_names)
        # gloo's CUDA all-reduce is not relied on for int64: it reduces on the host
        dev = "cpu" if dist.get_backend(group) == "gloo" else self.device.torch_device
        t = torch.tensor(self.dropped_tokens, dtype=torch.int64, device=dev)
        dist.all_reduce(t, group=group)
        return int(t.item())

    def gathered_grads(self):
        """The parent's, with the experts' gradients gathered over ep."""
        out = super().gathered_grads()
        paths = {id(p): k for k, p in self.net._collect_params_with_prefix().items()}
        for p, t in zip(self._plist, self._trainable):
            if t and self._expert(p) and p._mesh is not None:
                out[paths.get(id(p), p.name)] = gather_tensor(p._grad, p.sharding, p._mesh)
        return out

    # -- accounting ------------------------------------------------------------------
    def _a2a_step_bytes(self, x_shape):
        """(bytes, calls) of a step's all-to-all traffic on one rank: per MoE
        cell the dispatch and combine exchanges and their two mirrors in the
        backward, each ``all_to_all_wire_bytes`` (reference :335)."""
        n_local = int(_np.prod(x_shape)) // (self.mesh.axis_size(self.batch_axis)
                                              * self._ep_degree)
        total = calls = 0
        for cell in _moe_cells(self.net):
            total += 4 * _moe.all_to_all_wire_bytes(
                n_local, cell._units, n_experts=cell._num_experts, top_k=cell._top_k,
                capacity_factor=cell._capacity_factor, ep=self._ep_degree,
                comm_dtype=self._comm_dtype)
            calls += 4
        return total, calls

    def _record_telemetry(self, sig, examples, steps):
        if self._ep_degree > 1:
            n = self.mesh.axis_size(self.batch_axis) * self._ep_degree
            nbytes, calls = self._a2a_step_bytes((sig[0][0] * n,) + tuple(sig[0][1:]))
            _telem.record_comm("all_to_all", nbytes * steps, store="mesh",
                               calls=calls * steps, axis="ep")
        super()._record_telemetry(sig, examples, steps)


# -- the recipe triple ------------------------------------------------------------------

def make_model(vocab_size=512, num_experts=4, top_k=1, capacity_factor=2.0, dense_ffn=False,
               ctx=None, **kw):
    """The initialized tiny model (``models.moe_transformer_tiny``)."""
    from .. import context as _ctx
    from ..models import moe_transformer_tiny
    net = moe_transformer_tiny(vocab_size=vocab_size, num_experts=num_experts, top_k=top_k,
                               capacity_factor=capacity_factor, dense_ffn=dense_ffn, **kw)
    net.initialize(ctx=ctx or _ctx.current_context())
    return net


make_oracle = functools.partial(make_model, dense_ffn=True)


def make_trainer(net, mesh, dp_axis="dp", ep_axis="ep", learning_rate=1e-3, **kw):
    return MoETrainer(net, token_cross_entropy, optimizer="adam",
                      optimizer_params={"learning_rate": learning_rate}, mesh=mesh,
                      dp_axis=dp_axis, ep_axis=ep_axis, **kw)


from . import Recipe, register  # noqa: E402

register(Recipe("moe", make_model, make_trainer, make_oracle))
