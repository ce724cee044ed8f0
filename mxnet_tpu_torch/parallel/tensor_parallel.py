"""Tensor (Megatron-style) parallelism: partition specs on parameters.

Counterpart of ``mxnet_tpu/parallel/tensor_parallel.py:27-200``:
``column_parallel_spec``, ``row_parallel_spec``, ``tp_shard_dim`` and
``shard_params_megatron`` with the reference's default rules (:168-190),
matched against the same structural names (``Block._collect_params_with_prefix``,
``encoder.layers.0.attn.qkv.weight``). As in the reference,
``shard_params_megatron`` only annotates ``Parameter.sharding``; the
parameters are placed (each rank keeps its shard) when a
``DataParallelTrainer`` is built on a mesh of ranks.

Convention for Dense (weight (out, in), y = x W^T):
  column-parallel: shard the out dim -> P('tp', None): ``copy_to_tp``, then
  the local product with the local bias shard;
  row-parallel: shard the in dim -> P(None, 'tp'): the local product,
  ``reduce_from_tp``, then the (replicated) bias, added once.

``shard_tensor`` cuts a rank's shard out of a full tensor by a spec and a
mesh's coordinates (``convert.shard_arrays`` and the trainer's placement use
it); ``gather_tensor`` is its inverse, an all-gather.
"""
from __future__ import annotations

import re
from typing import Dict, Optional

import torch

from ..base import MXNetError
from .mesh import Mesh, PartitionSpec as P

__all__ = ["column_parallel_spec", "row_parallel_spec", "tp_shard_dim",
           "shard_params_megatron", "shard_tensor", "gather_tensor", "spec_axes"]


def column_parallel_spec(axis: str = "tp") -> P:
    return P(axis, None)


def row_parallel_spec(axis: str = "tp") -> P:
    return P(None, axis)


def spec_axes(spec: Optional[P]):
    """``(dim, axis names)`` for each sharded dimension of ``spec``."""
    if spec is None:
        return []
    out = []
    for d, ax in enumerate(spec):
        if ax is not None:
            out.append((d, tuple(ax) if isinstance(ax, tuple) else (ax,)))
    return out


def tp_shard_dim(spec: Optional[P], axis: str = "tp") -> Optional[int]:
    """Index of the dimension a Parameter's PartitionSpec shards over
    ``axis``, or None when the spec is absent or replicated. A spec naming
    another axis, or sharding two dimensions, raises (one sharded dim per
    leaf, the reference's rule)."""
    dim = None
    for d, axes in spec_axes(spec):
        if axes != (axis,):
            raise MXNetError(f"partition spec {spec} names mesh axis {axes}; the "
                             f"tensor-parallel layers take specs over {axis!r} only")
        if dim is not None:
            raise MXNetError(f"partition spec {spec} shards {axis!r} over two dims; "
                             f"one sharded dim per leaf")
        dim = d
    return dim


def shard_params_megatron(block, rules: Optional[Dict[str, P]] = None,
                          axis: str = "tp") -> int:
    """Attach tensor-parallel PartitionSpecs by name pattern; returns the
    number of parameters annotated. Default rules cover the transformer
    blocks in ``models.bert``: qkv/ffn-in column-parallel, proj/ffn-out
    row-parallel, the embedding sharded on vocab."""
    default_rules = {
        r".*(qkv|query|key|value|ffn1|inter|fc1).*weight$": column_parallel_spec(axis),
        r".*(proj|ffn2|output|fc2).*weight$": row_parallel_spec(axis),
        r".*(qkv|query|key|value|ffn1|inter|fc1).*bias$": P(axis),
        r".*word_embed.*weight$": P(axis, None),
    }
    compiled = [(re.compile(k), v) for k, v in (rules or default_rules).items()]
    n = 0
    for name, p in block._collect_params_with_prefix().items():
        for pat, spec in compiled:
            if pat.match(name):
                p.sharding = spec
                n += 1
                break
    return n


def _mesh_order(axes, mesh: Mesh):
    for a in axes:
        mesh.axis_size(a)
    return tuple(a for a in mesh.axis_names if a in axes)


def shard_tensor(t: torch.Tensor, spec: Optional[P], mesh: Mesh) -> torch.Tensor:
    """This rank's shard of the full tensor ``t`` under ``spec`` (a view; a
    dimension split over several axes is split in the mesh's axis order)."""
    for d, axes in spec_axes(spec):
        axes = _mesh_order(axes, mesh)
        n = 1
        idx = 0
        for a in axes:
            size = mesh.axis_size(a)
            idx = idx * size + mesh.axis_index(a)
            n *= size
        if t.shape[d] % n:
            raise MXNetError(f"dim {d} of {tuple(t.shape)} does not split {n} ways "
                             f"over {axes}")
        step = t.shape[d] // n
        t = t.narrow(d, idx * step, step)
    return t


def gather_tensor(t: torch.Tensor, spec: Optional[P], mesh: Optional[Mesh]) -> torch.Tensor:
    """The full tensor from every rank's shard ``t`` under ``spec`` (an
    all-gather over each sharded dim's axes, the inverse of
    ``shard_tensor``); ``t`` itself off a mesh of ranks or when replicated.
    Every rank of the mesh calls it."""
    if mesh is None or not mesh.distributed:
        return t
    import torch.distributed as dist
    for d, axes in spec_axes(spec):
        axes = _mesh_order(axes, mesh)
        parts = [torch.empty_like(t.contiguous()) for _ in range(mesh.group_size(axes))]
        dist.all_gather(parts, t.contiguous(), group=mesh.group(axes))
        t = torch.cat(parts, dim=d)
    return t
