"""Megatron-style tensor parallelism: the boundary collectives.

Counterpart of ``mxnet_tpu/parallel/megatron.py:93-200`` and ``:258``
(``vocab_parallel_embedding``). The reference runs these inside
``shard_map`` as ``jax.custom_vjp`` pairs; here each is a
``torch.autograd.Function`` over this rank's process group of one mesh
axis (``Mesh.group``), with the forward/backward pairs of the reference's
table (:36-43):

  ============== ==================== ====================
  op             forward              backward
  ============== ==================== ====================
  copy_to_tp     identity             all-reduce (sum)
  reduce_from_tp all-reduce (sum)     identity
  gather_from_sp all-gather along dim reduce-scatter along dim
  scatter_to_sp  reduce-scatter       all-gather
  partial_grad   identity             cotangent / axis size
  ============== ==================== ====================

Gradient convention. Every rank of a tensor-parallel group computes the
replicated parts of a layer (layer norms, residuals, row-parallel biases,
the MLM head) on the same tokens, and ``copy_to_tp``'s backward sums the
partial input gradients of a column-parallel layer, so each rank ends the
backward with the FULL gradient of every parameter it holds, sharded or
replicated. ``DataParallelTrainer`` therefore reduces gradients over the
data axes (``dp``, ``sp``) only, never over ``tp``: a sum over ``tp`` would
multiply every replicated parameter's gradient by the tp degree. The
reference's programs keep the other convention (:45-53: partial sums,
``partial_grad`` on replicated leaves, and a psum over tp in the trainer);
``partial_grad`` is ported for a program that keeps that convention, and
the port's own path does not use it.

Every function takes the axis name and a ``mesh`` (default: the active
mesh, ``with parallel.activate(mesh):``). On a group of one rank each is
the identity.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from ..base import MXNetError
from .mesh import Mesh, active_mesh

__all__ = ["copy_to_tp", "reduce_from_tp", "gather_from_sp", "scatter_to_sp",
           "partial_grad", "vocab_parallel_embedding"]


def _resolve(mesh: Optional[Mesh], axis: str) -> Mesh:
    mesh = mesh if mesh is not None else active_mesh()
    if mesh is None or not mesh.distributed:
        raise MXNetError(f"the {axis!r} collectives need a mesh of torch.distributed "
                         f"ranks (given or active), got {mesh}")
    mesh.axis_size(axis)
    return mesh


def _all_reduce(x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    out = x.contiguous().clone()
    dist.all_reduce(out, group=mesh.group(axis))
    return out


def _all_gather(x: torch.Tensor, mesh: Mesh, axis: str, dim: int) -> torch.Tensor:
    n = mesh.axis_size(axis)
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x, group=mesh.group(axis))
    return torch.cat(parts, dim=dim)


def _reduce_scatter(x: torch.Tensor, mesh: Mesh, axis: str, dim: int) -> torch.Tensor:
    n = mesh.axis_size(axis)
    if x.shape[dim] % n:
        raise MXNetError(f"reduce-scatter over {axis!r}: dim {dim} of "
                         f"{tuple(x.shape)} does not split {n} ways")
    stacked = x.movedim(dim, 0).contiguous()
    out = torch.empty((stacked.shape[0] // n,) + stacked.shape[1:], dtype=x.dtype,
                      device=x.device)
    dist.reduce_scatter_tensor(out, stacked, group=mesh.group(axis))
    return out.movedim(0, dim)


class _CopyToTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.mesh, ctx.axis), None, None


class _ReduceFromTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        return _all_reduce(x, mesh, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _GatherFromSP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        return _all_gather(x, mesh, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter(g, ctx.mesh, ctx.axis, ctx.dim), None, None, None


class _ScatterToSP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        return _reduce_scatter(x, mesh, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.mesh, ctx.axis, ctx.dim), None, None, None


class _PartialGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, n):
        ctx.n = n
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return (g / ctx.n if g.is_floating_point() else g), None


def copy_to_tp(x: torch.Tensor, axis: str = "tp", mesh: Optional[Mesh] = None):
    """Megatron's f: identity forward, all-reduce of the gradient backward
    (the entry of a column-parallel region)."""
    return _CopyToTP.apply(x, _resolve(mesh, axis), axis)


def reduce_from_tp(x: torch.Tensor, axis: str = "tp", mesh: Optional[Mesh] = None):
    """Megatron's g: all-reduce forward (row-parallel partial products ->
    the full activation), identity backward."""
    return _ReduceFromTP.apply(x, _resolve(mesh, axis), axis)


def gather_from_sp(x: torch.Tensor, axis: str = "sp", dim: int = 1,
                   mesh: Optional[Mesh] = None):
    """All-gather the sequence shards along ``dim`` (forward); reduce-scatter
    the gradient, each rank keeping its own shard's sum (backward)."""
    return _GatherFromSP.apply(x, _resolve(mesh, axis), axis, dim)


def scatter_to_sp(x: torch.Tensor, axis: str = "sp", dim: int = 1,
                  mesh: Optional[Mesh] = None):
    """Reduce-scatter partial products along ``dim`` (forward); all-gather
    the gradient shards (backward)."""
    return _ScatterToSP.apply(x, _resolve(mesh, axis), axis, dim)


def partial_grad(x: torch.Tensor, axis: str = "tp", mesh: Optional[Mesh] = None):
    """Identity whose backward divides the gradient by the axis size: turns
    the full gradient of a replicated leaf into the partial sum that a
    trainer summing over ``axis`` expects (the reference's convention)."""
    return _PartialGrad.apply(x, _resolve(mesh, axis).axis_size(axis))


def vocab_parallel_embedding(ids: torch.Tensor, table_local: torch.Tensor,
                             axis: str = "tp", mesh: Optional[Mesh] = None):
    """Partial lookup in this rank's rows of a vocab-sharded (V/n, C) table:
    ids outside them give zeros. The caller sums the partials over ``axis``
    (``reduce_from_tp``); the full table is never gathered."""
    mesh = _resolve(mesh, axis)
    v_local = table_local.shape[0]
    loc = ids.long() - mesh.axis_index(axis) * v_local
    ok = (loc >= 0) & (loc < v_local)
    emb = torch.nn.functional.embedding(loc.clamp(0, v_local - 1), table_local)
    return emb * ok.unsqueeze(-1).to(emb.dtype)
