"""ZeRO-style sharded weight update: fusion buckets, reduce-scatter, all-gather.

Counterpart of ``mxnet_tpu/parallel/zero.py`` (arXiv:2004.13336). The
replicated data-parallel step all-reduces every gradient and runs the whole
update on every rank. Here each rank reduce-scatters the gradients, so that
it owns the sum of 1/N of them, updates only that shard against its 1/N of
the optimizer state, and all-gathers the new weights back.

- ``canonical_comm_dtype`` (:58), ``BucketSpec`` (:76) and ``plan_buckets``
  (:107): parameters packed in declaration order into dtype-homogeneous
  flat buckets of at most ``bucket_bytes``, each padded to a multiple of the
  data degree; the plan equals the reference's field by field (``dtype`` is
  the dtype's name, ``"float32"``).
- ``flatten_bucket``, ``unflatten_bucket``, ``shard_slice`` and
  ``wd_vector`` (:173-209) on tensors (``wd_vector`` on numpy).
- ``reduce_scatter_bucket`` (:222): this rank's 1/N shard of the sum over
  the ranks of ``axis``, as float32. Native: ``reduce_scatter_tensor``.
  ``"bfloat16"``: the chunks cross the wire as bf16 (``all_to_all_single``)
  and are summed in f32. ``"int8"``: one f32 scale per chunk (max/127), the
  chunk rounded half to even and clipped to +-127, the int8 chunks and the
  scales exchanged, the dequantized chunks summed in f32.
- ``all_gather_bucket`` (:256): ``all_gather_into_tensor``.
- The wire-byte estimators (:266-289) and ``per_replica_state_bytes``
  (:291): the bytes of the state tensors a rank holds.

The collectives take the axis and a mesh (default: the active one) and call
``torch.distributed`` directly, under gloo on CUDA tensors too (ranks that
share one card). ``MXNET_TPU_BUCKET_BYTES`` is declared in ``_dist_util``.

Not ported: ``shard_map_compat``, ``_sharded_update_kernel`` and
``_k_bucket_reduce`` (:211, :318-345), the reference's jit, shard_map and
buffer-donation plumbing, which an eager step has no use for.
"""
from __future__ import annotations

import bisect
from dataclasses import dataclass
from typing import Any, List, Optional, Sequence, Tuple

import numpy as _np
import torch
import torch.distributed as dist

from ..base import MXNetError, env, torch_dtype
from .. import _dist_util  # noqa: F401  (declares MXNET_TPU_BUCKET_BYTES)

__all__ = ["BucketSpec", "plan_buckets", "flatten_bucket", "unflatten_bucket",
           "shard_slice", "wd_vector", "reduce_scatter_bucket", "all_gather_bucket",
           "reduce_scatter_wire_bytes", "all_gather_wire_bytes",
           "per_replica_state_bytes", "canonical_comm_dtype"]

env.declare("MXNET_TPU_ZERO", False, bool,
            "Default DataParallelTrainer(zero_update=...) to the sharded weight "
            "update (reduce-scatter + 1/N update + all-gather)")
env.declare("MXNET_TPU_COMM_DTYPE", "", str,
            "Wire dtype for the sharded-update reduce-scatter: '' (native), "
            "'bfloat16', or 'int8' (chunk-scaled, fp32 accumulation)")


def _dtype_name(dtype) -> str:
    if isinstance(dtype, torch.dtype):
        return str(dtype).rpartition(".")[2]
    if isinstance(dtype, str):
        return dtype
    return _np.dtype(dtype).name


def _itemsize(name: str) -> int:
    return torch_dtype(name).itemsize


def canonical_comm_dtype(dtype) -> Optional[str]:
    """Normalize a comm-dtype spec to None | 'bfloat16' | 'int8'."""
    if dtype is None:
        return None
    name = dtype if isinstance(dtype, str) else _dtype_name(dtype)
    name = name.strip().lower()
    if name in ("", "none", "float32", "fp32"):
        return None
    if name in ("bfloat16", "bf16"):
        return "bfloat16"
    if name == "int8":
        return "int8"
    raise MXNetError(f"unsupported comm dtype {dtype!r}; use 'bfloat16' or 'int8' "
                     f"(MXNET_TPU_COMM_DTYPE)")


@dataclass(frozen=True)
class BucketSpec:
    """One flat fusion bucket: which parameter slots it packs and where.
    ``padded_size`` is a multiple of ``ndp``, so the bucket splits into
    ``ndp`` equal contiguous shards; the tail pad holds zeros."""
    dtype: str
    indices: Tuple[int, ...]
    offsets: Tuple[int, ...]
    sizes: Tuple[int, ...]
    shapes: Tuple[Tuple[int, ...], ...]
    padded_size: int
    ndp: int

    @property
    def used_size(self) -> int:
        return self.offsets[-1] + self.sizes[-1]

    @property
    def pad(self) -> int:
        return self.padded_size - self.used_size

    @property
    def shard_size(self) -> int:
        return self.padded_size // self.ndp

    @property
    def nbytes(self) -> int:
        return self.padded_size * _itemsize(self.dtype)


def plan_buckets(entries: Sequence[Tuple[int, Sequence[int], Any]], ndp: int,
                 bucket_bytes: int, boundaries: Optional[Sequence[int]] = None
                 ) -> Tuple[BucketSpec, ...]:
    """Pack ``(slot_index, shape, dtype)`` entries into dtype-homogeneous
    buckets, greedily in order, of at most ``bucket_bytes`` (a larger tensor
    gets a bucket of its own), each padded to a multiple of ``ndp`` elements.
    ``boundaries``: increasing slot indices at which a bucket must close (no
    bucket packs entries from both sides of one)."""
    ndp = max(int(ndp), 1)
    bounds = tuple(sorted(int(b) for b in boundaries)) if boundaries else ()
    groups: List[Tuple[str, List[Tuple[int, Tuple[int, ...], int]]]] = []
    by_dtype = {}
    for idx, shape, dtype in entries:
        key = _dtype_name(dtype)
        if key not in by_dtype:
            by_dtype[key] = []
            groups.append((key, by_dtype[key]))
        shape = tuple(int(d) for d in shape)
        by_dtype[key].append((idx, shape, int(_np.prod(shape, dtype=_np.int64))))

    buckets: List[BucketSpec] = []

    def close(dtype, members):
        if not members:
            return
        offsets, off = [], 0
        for _, _, size in members:
            offsets.append(off)
            off += size
        buckets.append(BucketSpec(
            dtype=dtype, indices=tuple(i for i, _, _ in members),
            offsets=tuple(offsets), sizes=tuple(s for _, _, s in members),
            shapes=tuple(shp for _, shp, _ in members),
            padded_size=-(-off // ndp) * ndp, ndp=ndp))

    for dtype, members in groups:
        cap = max(int(bucket_bytes) // _itemsize(dtype), 1)
        cur, total, side = [], 0, None
        for idx, shape, size in members:
            s = bisect.bisect_right(bounds, idx) if bounds else 0
            if cur and (total + size > cap or s != side):
                close(dtype, cur)
                cur, total = [], 0
            cur.append((idx, shape, size))
            total += size
            side = s
        close(dtype, cur)
    return tuple(buckets)


def flatten_bucket(bucket: BucketSpec, arrays) -> torch.Tensor:
    """The bucket's slots of ``arrays`` (indexed by ``bucket.indices``) as one
    flat padded vector."""
    parts = [arrays[i].reshape(-1) for i in bucket.indices]
    if bucket.pad:
        parts.append(parts[0].new_zeros((bucket.pad,)))
    return parts[0] if len(parts) == 1 else torch.cat(parts)


def unflatten_bucket(bucket: BucketSpec, flat):
    """``(slot_index, view)`` pairs of ``flat`` in each parameter's shape
    (the pad is dropped)."""
    return [(i, flat[o:o + s].view(shp))
            for i, o, s, shp in zip(bucket.indices, bucket.offsets, bucket.sizes,
                                    bucket.shapes)]


def shard_slice(bucket: BucketSpec, flat, position: int):
    """Rank ``position``'s contiguous 1/ndp shard of a flat bucket (a view)."""
    return flat[position * bucket.shard_size:(position + 1) * bucket.shard_size]


def wd_vector(bucket: BucketSpec, wds) -> _np.ndarray:
    """Per-element weight decay of a bucket, 0 over the pad. (The port's
    update does not read it: it cuts each shard at parameter boundaries and
    gives each piece its parameter's wd, ``DataParallelTrainer``.)"""
    out = _np.zeros((bucket.padded_size,), _np.float32)
    for i, o, s in zip(bucket.indices, bucket.offsets, bucket.sizes):
        out[o:o + s] = float(wds[i])
    return out


# -- collectives ----------------------------------------------------------------

def _group(axis: str, mesh):
    from .megatron import _resolve
    return _resolve(mesh, axis).group(axis)


def reduce_scatter_bucket(flat: torch.Tensor, axis: str, ndp: int,
                          comm_dtype: Optional[str] = None, mesh=None) -> torch.Tensor:
    """This rank's 1/ndp shard of the sum of ``flat`` over the ranks of
    ``axis``, as float32 (see the module docstring for the wire dtypes)."""
    if ndp <= 1:
        return flat.float()
    group = _group(axis, mesh)
    flat = flat.contiguous()
    if comm_dtype is None:
        out = flat.new_empty((flat.numel() // ndp,))
        dist.reduce_scatter_tensor(out, flat, group=group)
        return out.float()
    chunks = flat.reshape(ndp, -1)
    if comm_dtype == "bfloat16":
        send = chunks.to(torch.bfloat16).contiguous()
        recv = torch.empty_like(send)
        dist.all_to_all_single(recv, send, group=group)
        return recv.float().sum(dim=0)
    if comm_dtype == "int8":
        chunks = chunks.float()
        amax = chunks.abs().amax(dim=1, keepdim=True)
        scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
        q = torch.clamp(torch.round(chunks / scale), -127, 127).to(torch.int8)
        recv, rscale = torch.empty_like(q), torch.empty_like(scale)
        dist.all_to_all_single(recv, q, group=group)
        dist.all_to_all_single(rscale, scale, group=group)
        return (recv.float() * rscale).sum(dim=0)
    raise MXNetError(f"unsupported comm dtype {comm_dtype!r}")


def all_gather_bucket(shard: torch.Tensor, axis: str, mesh=None) -> torch.Tensor:
    """Every rank's shard of ``axis``, concatenated in rank order: the full
    flat bucket."""
    group = _group(axis, mesh)
    n = dist.get_world_size(group)
    if n == 1:
        return shard
    shard = shard.contiguous()
    out = shard.new_empty((n * shard.numel(),))
    dist.all_gather_into_tensor(out, shard, group=group)
    return out


# -- accounting (ring schedule) ---------------------------------------------------

def reduce_scatter_wire_bytes(buckets, ndp: int, comm_dtype: Optional[str] = None) -> int:
    """Per-step wire bytes of the bucket reduce-scatters: each rank sends
    (n-1)/n of every bucket once (plus the int8 path's scales)."""
    if ndp <= 1:
        return 0
    total = 0
    for b in buckets:
        nbytes = b.padded_size * _itemsize(comm_dtype or b.dtype)
        if comm_dtype == "int8":
            nbytes += b.ndp * 4
        total += nbytes * (ndp - 1) // ndp
    return total


def all_gather_wire_bytes(buckets, ndp: int) -> int:
    """Per-step wire bytes of gathering the updated shards (in the weights'
    dtype)."""
    if ndp <= 1:
        return 0
    return sum(b.padded_size * _itemsize(b.dtype) * (ndp - 1) // ndp for b in buckets)


def per_replica_state_bytes(tree) -> int:
    """Bytes of the tensors in ``tree`` (nested lists, tuples and dicts): the
    optimizer state one rank holds, its shards only under ZeRO."""
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(per_replica_state_bytes(t) for t in tree)
    return 0
