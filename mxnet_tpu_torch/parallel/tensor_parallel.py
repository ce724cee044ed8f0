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

``gather_tp`` and ``slice_tp`` (reference :65-80) serve the weight-sharded
tensor parallelism of ``parallel.PipelineTrainer``: the all-gather of one
sharded dimension over the tp group, outside autograd, and this rank's slice
of a gradient that every rank of the group holds whole. ``shard_rules`` and
``apply_rules`` (:82-166) attach specs from a table of logical roles
(``DEFAULT_RULES``), refusing an unknown role or an axis the mesh lacks.
With telemetry on, both annotators set ``mx_tp_sharded_params`` and add the
annotated parameters' bytes to ``mx_tp_sharded_bytes_total`` (reference
:160-197).
"""
from __future__ import annotations

import re
from typing import Dict, Optional

import torch

from .. import telemetry as _telem
from ..base import MXNetError
from .mesh import Mesh, PartitionSpec as P, active_mesh

__all__ = ["column_parallel_spec", "row_parallel_spec", "tp_shard_dim",
           "shard_params_megatron", "shard_tensor", "gather_tensor", "spec_axes",
           "gather_tp", "slice_tp", "DEFAULT_RULES", "shard_rules", "apply_rules"]


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


def gather_tp(w: torch.Tensor, dim: int, axis: str = "tp",
              mesh: Optional[Mesh] = None) -> torch.Tensor:
    """A weight-sharded leaf's ``dim`` all-gathered over ``axis`` back to its
    full size, outside autograd: the gradients with respect to the gathered
    tensor are then the same on every rank, and ``slice_tp`` takes this
    rank's part of them with no collective. ``w`` itself on a mesh of one
    device or an axis of size 1."""
    mesh = mesh if mesh is not None else active_mesh()
    if mesh is None or not mesh.distributed or mesh.axis_size(axis) == 1:
        return w
    import torch.distributed as dist
    w = w.detach().contiguous()
    parts = [torch.empty_like(w) for _ in range(mesh.axis_size(axis))]
    dist.all_gather(parts, w, group=mesh.group(axis))
    return torch.cat(parts, dim=dim)


def slice_tp(g: torch.Tensor, dim: int, axis: str = "tp",
             mesh: Optional[Mesh] = None) -> torch.Tensor:
    """This rank's shard along ``dim`` of a full gradient that every rank of
    ``axis`` holds the same (a view): the inverse of ``gather_tp`` for the
    update."""
    mesh = mesh if mesh is not None else active_mesh()
    if mesh is None or not mesh.distributed:
        return g
    n = mesh.axis_size(axis)
    step = g.shape[dim] // n
    return g.narrow(dim, mesh.axis_index(axis) * step, step)


# Logical role -> the mesh axis that shards it (None: replicated). "batch" and
# "seq" are activation roles: checked against the mesh like the others, but
# apply_rules attaches only the parameter roles.
DEFAULT_RULES: Dict[str, Optional[str]] = {
    "batch": "dp",
    "vocab": "tp",
    "embed": None,
    "heads": "tp",
    "kv": "tp",
    "joined_kv": "tp",
    "mlp": "tp",
    "seq": "sp",
}

# name pattern -> the role of each dimension of the weight (Dense: (out, in))
_ROLE_PATTERNS = [
    (r".*(qkv|joined_qkv).*weight$", ("joined_kv", "embed")),
    (r".*(query|key|value|ffn1|inter|fc1).*weight$", ("kv", "embed")),
    (r".*(proj|ffn2|output|fc2).*weight$", ("embed", "mlp")),
    (r".*(qkv|joined_qkv).*bias$", ("joined_kv",)),
    (r".*(query|key|value|ffn1|inter|fc1).*bias$", ("kv",)),
    (r".*(word_embed|decoder).*weight$", ("vocab", "embed")),
    (r".*decoder.*bias$", ("vocab",)),
]


def shard_rules(overrides: Optional[Dict[str, Optional[str]]] = None
                ) -> Dict[str, Optional[str]]:
    """``DEFAULT_RULES`` with ``overrides`` applied; an unknown role raises."""
    rules = dict(DEFAULT_RULES)
    for k in overrides or {}:
        if k not in rules:
            raise MXNetError(f"shard_rules: unknown logical axis {k!r}; known roles: "
                             f"{sorted(rules)}")
    rules.update(overrides or {})
    return rules


def apply_rules(block, rules: Optional[Dict[str, Optional[str]]] = None,
                mesh: Optional[Mesh] = None) -> int:
    """Attach PartitionSpecs from a table of logical roles (``shard_rules``):
    each parameter whose structural name matches a pattern gets the spec of
    its dimensions' roles. A rule naming an axis ``mesh`` lacks raises (a
    silent no-op would train replicated). Returns the number of parameters
    given a spec that shards something."""
    rules = shard_rules(rules)
    if mesh is not None:
        for role, ax in rules.items():
            if ax is not None and ax not in mesh.axis_names:
                raise MXNetError(f"apply_rules: rule {role!r} -> {ax!r} names a mesh axis "
                                 f"that does not exist (mesh axes: {mesh.axis_names}); add "
                                 f"the axis to make_mesh or set the rule to None")
    compiled = [(re.compile(pat), roles) for pat, roles in _ROLE_PATTERNS]
    n = nbytes = 0
    for name, p in block._collect_params_with_prefix().items():
        for pat, roles in compiled:
            if pat.match(name):
                spec = P(*(rules.get(r) for r in roles))
                if any(s is not None for s in spec):
                    p.sharding = spec
                    n += 1
                    nbytes += _telem.payload_bytes(p._param)
                break
    _record_sharded(n, nbytes)
    return n


def _record_sharded(n: int, nbytes: int) -> None:
    if _telem._ENABLED:
        _telem.gauge("mx_tp_sharded_params",
                     "Parameters carrying TP PartitionSpecs").set(n)
        _telem.counter("mx_tp_sharded_bytes_total",
                       "Bytes of parameters annotated for TP sharding").inc(nbytes)


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
    n = nbytes = 0
    for name, p in block._collect_params_with_prefix().items():
        for pat, spec in compiled:
            if pat.match(name):
                p.sharding = spec
                n += 1
                nbytes += _telem.payload_bytes(p._param)
                break
    _record_sharded(n, nbytes)
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


def local_part(t: torch.Tensor, data_axes, mesh: Mesh, stacked: bool = False) -> torch.Tensor:
    """This rank's part of a global batch tensor whose dims ``data_axes``
    (``spec_axes`` of a data spec) split over ``mesh``, each dim one later
    for a stacked run; a dim past ``t``'s last is left whole. The one cut
    of a batch that both the trainers and ``DeviceFeed`` make."""
    for d, axes in data_axes:
        d += int(stacked)
        if d < t.dim():
            t = shard_tensor(t, P(*([None] * d), axes), mesh)
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
