"""Backward-overlapped gradient collectives: the segment plan and the bucket reduce.

Counterpart of ``mxnet_tpu/parallel/overlap.py``. The fused data-parallel
step runs the whole backward and then reduces every gradient bucket at its
tail, so all collective time is exposed. ``DataParallelTrainer(
overlap_grads=True)`` instead cuts the backward into segments and issues
each bucket's collective as soon as the last gradient feeding it is final,
while the backward of the earlier segments still runs. This module holds
the pieces the trainer composes with ``parallel/zero.py``:

- ``chain_blocks``: a linear list of child blocks whose application in turn
  is the net's forward (a ``pipeline_split()`` model, a ``HybridSequential``'s
  children, or the model zoo's ``features`` + ``output`` pair);
- ``plan_segments``: the chain grouped into K segments of about equal
  parameter bytes; the first owned slot of every segment but the first is a
  ``boundaries=`` hint to ``zero.plan_buckets``, so no bucket spans two
  segments;
- ``allreduce_bucket``: the sum of one flat gradient bucket over the batch
  axis when ZeRO is off (an ``all_reduce``, or the bf16/int8 wire of
  ``zero.reduce_scatter_bucket`` followed by ``zero.all_gather_bucket``),
  with ``allreduce_wire_bytes`` its per-step wire estimate;
- ``accumulate_segment_grads``: ``acc += seg_flat`` in place, for loops that
  add segment gradients up on the host's side.

The design on the card (the reference chains ``jax.vjp`` calls, one a
segment): the forward runs segment by segment, each segment's input a
detached tensor that requires grad, and the backward is one
``torch.autograd.grad`` a segment, newest first, with the previous
segment's output cotangent as ``grad_outputs``. After a segment's call the
gradients it owns are final: the trainer issues its buckets' collectives on
a side stream that forks from the current one (``wait_stream``) and joins
it again before the update, so they run while the older segments' backward
kernels run on the current stream, inside a captured CUDA graph too. A
parameter used by two segments is owned by its earliest user, whose backward
comes last; its gradient is the sum of the segments' contributions, in
another order than one backward's.

``MXNET_TPU_OVERLAP_GRADS`` makes overlap the trainer's default (a net with
no chain then falls back to the plain step with a warning);
``MXNET_TPU_OVERLAP_SEGMENTS`` is the default number of segments.
``engine/xla_flags.py``'s ``ensure_overlap_flags`` configures XLA and has no
counterpart here.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from ..base import MXNetError, env
from . import zero as _zero

__all__ = ["Segment", "SegmentPlan", "chain_blocks", "plan_segments",
           "allreduce_bucket", "allreduce_wire_bytes", "accumulate_segment_grads"]

env.declare("MXNET_TPU_OVERLAP_GRADS", False, bool,
            "Default DataParallelTrainer(overlap_grads=...) to the backward-overlapped "
            "collective schedule (segmented backward, per-bucket collectives issued as "
            "segments finalize). Nets without a linear block chain fall back to the plain "
            "step with a warning when enabled this way.")
env.declare("MXNET_TPU_OVERLAP_SEGMENTS", 4, int,
            "Target number of backward segments for the overlapped step (clamped to the "
            "net's chain length; >= 2 required)")


@dataclass(frozen=True)
class Segment:
    """One chunk of the backward: a run of chain blocks applied in order.
    ``uses`` are the parameter slots its forward reads, in first-use order;
    ``owned`` the slots whose gradient is final once its backward ran (a
    parameter shared across segments is owned by its earliest user)."""
    index: int
    names: Tuple[str, ...]
    blocks: Tuple[Any, ...] = field(compare=False)
    block_uses: Tuple[Tuple[int, ...], ...]
    uses: Tuple[int, ...]
    owned: Tuple[int, ...]


class SegmentPlan:
    """The segments plus the bucket boundaries the trainer needs."""

    def __init__(self, segments: Sequence[Segment]):
        self.segments: Tuple[Segment, ...] = tuple(segments)
        self.segment_of_slot: Dict[int, int] = {
            i: s.index for s in self.segments for i in s.owned}
        # cut before each later segment's first owned slot; owned slots are
        # contiguous runs in declaration order (plan_segments checks it)
        self.boundaries: Tuple[int, ...] = tuple(
            min(s.owned) for s in self.segments[1:] if s.owned)

    def __len__(self):
        return len(self.segments)

    @property
    def fingerprint(self):
        """A token for the step's fingerprint: two nets that segment
        differently are different configurations."""
        return tuple((s.index, s.names, s.uses, s.owned) for s in self.segments)


def chain_blocks(net) -> Optional[List[Tuple[str, Any]]]:
    """``[(name, block), ...]`` whose application in turn is ``net``'s
    forward, or None when the net has no such shape: a ``pipeline_split()``
    model (embed, cells, head), a ``HybridSequential``, or the model zoo's
    ``features`` (a ``HybridSequential``) + ``output`` pair."""
    from ..gluon import nn as _nn
    from ..gluon.block import HybridBlock
    split = getattr(net, "pipeline_split", None)
    if callable(split):
        embed, cells, head = split()
        return ([("embed", embed)] + [(f"cell{i}", c) for i, c in enumerate(cells)]
                + [("head", head)])
    if isinstance(net, _nn.HybridSequential):
        return [(f"[{i}]", b) for i, b in enumerate(net._children.values())]
    feats = getattr(net, "features", None)
    out = getattr(net, "output", None)
    if isinstance(feats, _nn.HybridSequential) and isinstance(out, HybridBlock):
        return ([(f"features[{i}]", b) for i, b in enumerate(feats._children.values())]
                + [("output", out)])
    return None


def _nbytes(p) -> int:
    t = p._param
    return 0 if t is None else t.numel() * t.element_size()


def plan_segments(net, plist: Sequence[Any], n_segments: int) -> SegmentPlan:
    """``net``'s chain grouped into ``n_segments`` segments of about equal
    owned parameter bytes. Raises ``MXNetError`` when the net has no chain,
    when the chain and ``plist`` cover different parameters, or when the
    segments' owned slots are not contiguous in declaration order."""
    chain = chain_blocks(net)
    if not chain:
        raise MXNetError(f"net {type(net).__name__} has no linear block chain "
                         f"(pipeline_split() / HybridSequential / features+output); "
                         f"overlap_grads needs one to segment the backward")
    slot_of = {id(p): i for i, p in enumerate(plist)}
    per_block_uses: List[Tuple[int, ...]] = []
    for name, blk in chain:
        uses: List[int] = []
        for p in blk.collect_params().values():
            i = slot_of.get(id(p))
            if i is None:
                raise MXNetError(f"chain block {name} holds parameter {p.name!r} that "
                                 f"the trainer's parameter list doesn't (initialize the "
                                 f"net before constructing the trainer)")
            if i not in uses:
                uses.append(i)
        per_block_uses.append(tuple(uses))
    covered = {i for uses in per_block_uses for i in uses}
    missing = [i for i in range(len(plist)) if i not in covered]
    if missing:
        raise MXNetError(f"net parameters outside the block chain (slots {missing[:4]}...): "
                         f"their gradients would never finalize in a segmented backward; "
                         f"overlap_grads requires the chain to cover every parameter")
    owner_block: Dict[int, int] = {}
    for j, uses in enumerate(per_block_uses):
        for i in uses:
            owner_block.setdefault(i, j)

    k = min(max(2, int(n_segments)), len(chain))
    sizes = [sum(_nbytes(plist[i]) for i in uses if owner_block[i] == j)
             for j, uses in enumerate(per_block_uses)]
    total = sum(sizes) or 1
    # cut at the cumulative-bytes thresholds i * total / k; a block heavier
    # than total / k swallows later thresholds (fewer, larger segments)
    groups: List[List[int]] = []
    cur: List[int] = []
    acc = 0
    for j in range(len(chain)):
        cur.append(j)
        acc += sizes[j]
        if len(groups) < k - 1 and acc >= total * (len(groups) + 1) / k:
            groups.append(cur)
            cur = []
    if cur:
        groups.append(cur)

    segments = []
    for s, grp in enumerate(groups):
        uses = []
        for j in grp:
            for i in per_block_uses[j]:
                if i not in uses:
                    uses.append(i)
        owned = tuple(sorted(i for i in uses if owner_block[i] in grp))
        segments.append(Segment(index=s, names=tuple(chain[j][0] for j in grp),
                                blocks=tuple(chain[j][1] for j in grp),
                                block_uses=tuple(per_block_uses[j] for j in grp),
                                uses=tuple(uses), owned=owned))
    prev_max = -1
    for seg in segments:
        if not seg.owned:
            continue
        if seg.owned[0] <= prev_max:
            raise MXNetError(f"segment ownership is not contiguous in parameter "
                             f"declaration order (segment {seg.index} owns slot "
                             f"{seg.owned[0]} after slot {prev_max}); declare parameters "
                             f"in chain order to use overlap_grads")
        prev_max = seg.owned[-1]
    return SegmentPlan(segments)


def allreduce_bucket(flat: torch.Tensor, axis: str, ndp: int,
                     comm_dtype: Optional[str] = None, mesh=None) -> torch.Tensor:
    """The sum of the flat gradient bucket ``flat`` over the ranks of
    ``axis``, written into ``flat`` (returned). ``comm_dtype`` None: one
    ``all_reduce``; ``"bfloat16"``/``"int8"``: the reduce-scatter of
    ``zero.reduce_scatter_bucket``'s wire (float32 sums) and an all-gather of
    the float32 partial sums."""
    if ndp <= 1:
        return flat
    if comm_dtype is None:
        dist.all_reduce(flat, group=_zero._group(axis, mesh))
        return flat
    shard = _zero.reduce_scatter_bucket(flat, axis, ndp, comm_dtype, mesh)
    flat.copy_(_zero.all_gather_bucket(shard, axis, mesh))
    return flat


def allreduce_wire_bytes(buckets, ndp: int, comm_dtype: Optional[str] = None) -> int:
    """Per-step wire bytes of the per-bucket all-reduces (ring estimate: 2(n-1)/n
    of each bucket; the compressed form is the reduce-scatter's wire plus the
    float32 all-gather)."""
    if ndp <= 1:
        return 0
    if comm_dtype is None:
        return sum(b.nbytes * 2 * (ndp - 1) // ndp for b in buckets)
    return (_zero.reduce_scatter_wire_bytes(buckets, ndp, comm_dtype)
            + _zero.all_gather_wire_bytes(buckets, ndp))


def accumulate_segment_grads(acc: torch.Tensor, seg_flat: torch.Tensor) -> torch.Tensor:
    """``acc += seg_flat`` in place (``seg_flat`` cast to ``acc``'s dtype);
    returns ``acc``. The reference donates the old accumulator to a jitted
    add; here the tensor is updated where it lies."""
    return acc.add_(seg_flat.to(acc.dtype))
