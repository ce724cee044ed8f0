"""Megatron-style tensor parallelism: the boundary collectives and the
compute-partitioned programs of ``PipelineTrainer(tp_mode="partitioned")``.

Counterpart of ``mxnet_tpu/parallel/megatron.py``. The reference runs the
collectives inside ``shard_map`` as ``jax.custom_vjp`` pairs; here each is a
``torch.autograd.Function`` over this rank's process group of one mesh axis
(``Mesh.group``), with the forward/backward pairs of the reference's table
(:36-43):

  ============== ==================== ====================
  op             forward              backward
  ============== ==================== ====================
  copy_to_tp     identity             all-reduce (sum)
  reduce_from_tp all-reduce (sum)     identity
  gather_from_sp all-gather along dim reduce-scatter along dim
  scatter_to_sp  reduce-scatter       all-gather
  partial_grad   identity             cotangent / axis size
  ============== ==================== ====================

Under ``create_graph`` each backward is recorded, so a second derivative
runs the transpose of that backward's collective, as JAX differentiates the
reference's backward rules (``tests/test_torch_second_order_comm.py``
holds it against the reference on 2 CPU devices): ``copy_to_tp``'s sum
again, ``gather_from_sp``'s and ``scatter_to_sp``'s duals.

Two gradient conventions. ``DataParallelTrainer``'s tensor parallelism keeps
FULL gradients on every rank: every rank of a tp group computes the
replicated parts of a layer on the same tokens and ``copy_to_tp``'s backward
sums the partial input gradients, so the trainer reduces over the data axes
only and never over ``tp``. The partitioned programs below keep the
reference's convention (:45-51): the trainer sums the gradients of
replicated leaves over ``tp``, so each program hands back PARTIAL sums; a
replicated leaf consumed by token-sharded compute (sequence parallelism) is
partial by nature, one consumed by replicated compute is wrapped in
``partial_grad``.

The partitioned programs (reference :200-777) keep every weight sharded
(Megatron-LM, arXiv:1909.08053) and move activations only:

- ``PartitionConfig`` (the tp axis, its degree, sequence parallelism, the
  mesh), ``view_shape``/``view_shard_dim``/``_merge_view``: a partitioned
  leaf is stored in a VIEW shape whose tp-sharded dim is a plain dim. The
  fused qkv (3C, C) in its default (3, H, d) layout is stored as (3, C, C)
  and sharded on the within-block dim, so rank r holds (q_r; k_r; v_r); the
  head-major layout shards the out dim as it is. The stored global shapes do
  not depend on the tp degree.
- ``plan_cell`` (BERT's ``TransformerEncoderCell``, long context's
  ``_LCCell``, ``MoETransformerCell``), ``plan_embed`` and ``plan_head``:
  which slot of a block's parameter list plays which role, and each leaf's
  layout ``(dim, blocks)`` or None (replicated).
- ``cell_forward``, ``embed_forward`` and ``head_loss_forward``: plain
  functions on this rank's local view shards. Column-parallel qkv/ffn1 and
  row-parallel proj/ffn2; attention on this rank's H/tp heads through
  ``ops.attention.flash_attention_op`` (K1-K3 on the card) under the
  reference's rule (:620-627): causal always, non-causal when the block
  uses it and T >= ``MXNET_FLASH_ATTENTION_MIN_SEQ``, else the plain
  ``batch_dot``/``softmax`` path; the vocab-parallel embedding and
  ``vocab_parallel_cross_entropy`` (the full-vocab logits never exist);
  under sequence parallelism the layer norms, dropout and residuals run on
  (B, T/tp, C) shards and the boundaries become all-gather/reduce-scatter
  pairs.
- Dropout draws each mask at the full (B, T, C) shape from a
  ``torch.Generator`` seeded by the call's key (the same on every tp rank of
  a stage: step, stage, layer, microbatch, site) and slices it to the local
  tokens under sequence parallelism, so sp and non-sp drop the same
  elements. The bits are not jax's.

Every collective adds to ``_dist_util.comm_stats`` under ``(op, axis)``:
``act_all_reduce``, ``act_all_gather``, ``act_reduce_scatter`` at the
region boundaries, ``ce_all_reduce`` and ``ce_all_reduce_max`` in the loss.

Every function takes the axis name and a ``mesh`` (default: the active
mesh, ``with parallel.activate(mesh):``). On a group of one rank each is
the identity.
"""
from __future__ import annotations

import hashlib
import math
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import torch
import torch.distributed as dist

from ..base import MXNetError, env
from .. import _dist_util
from ..ops import nn as _ops
from ..ops.matrix import batch_dot as _batch_dot
from .mesh import Mesh, active_mesh

__all__ = ["copy_to_tp", "reduce_from_tp", "gather_from_sp", "scatter_to_sp",
           "partial_grad", "vocab_parallel_embedding", "vocab_parallel_cross_entropy",
           "PartitionConfig", "view_shape", "view_shard_dim", "CellPlan", "EmbedPlan",
           "HeadPlan", "plan_cell", "plan_embed", "plan_head", "cell_forward",
           "embed_forward", "head_loss_forward"]


def _resolve(mesh: Optional[Mesh], axis: str) -> Mesh:
    mesh = mesh if mesh is not None else active_mesh()
    if mesh is None or not mesh.distributed:
        raise MXNetError(f"the {axis!r} collectives need a mesh of torch.distributed "
                         f"ranks (given or active), got {mesh}")
    mesh.axis_size(axis)
    return mesh


def _all_reduce(x: torch.Tensor, mesh: Mesh, axis: str, label: str = "act_all_reduce",
                op=dist.ReduceOp.SUM) -> torch.Tensor:
    out = x.contiguous().clone()
    dist.all_reduce(out, op=op, group=mesh.group(axis))
    _dist_util.count_comm(label, axis, out.numel() * out.element_size())
    return out


def _all_gather(x: torch.Tensor, mesh: Mesh, axis: str, dim: int) -> torch.Tensor:
    n = mesh.axis_size(axis)
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x, group=mesh.group(axis))
    _dist_util.count_comm("act_all_gather", axis, x.numel() * x.element_size())
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
    _dist_util.count_comm("act_reduce_scatter", axis, x.numel() * x.element_size())
    return out.movedim(0, dim)


# Under create_graph each boundary collective's backward is recorded, so a
# second derivative runs the transpose of that backward's collective, as JAX
# differentiates the reference's custom_vjp backward rules: psum's transpose
# is psum (``_AllReduce``), psum_scatter's all_gather and the reverse (the
# dual Function); reduce_from_tp's identity backward stays the identity.
# Without create_graph each runs as the plain collective.

class _AllReduce(torch.autograd.Function):
    """The sum over ``axis``, whose derivative is the sum again."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return _all_reduce(x, mesh, axis)

    @staticmethod
    def backward(ctx, g):
        return _AllReduce.apply(g, ctx.mesh, ctx.axis), None, None


class _CopyToTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _AllReduce.apply(g, ctx.mesh, ctx.axis), None, None


class _ReduceFromTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, label="act_all_reduce"):
        return _all_reduce(x, mesh, axis, label)

    @staticmethod
    def backward(ctx, g):
        return g, None, None, None


class _GatherFromSP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        return _all_gather(x, mesh, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return _ScatterToSP.apply(g, ctx.mesh, ctx.axis, ctx.dim), None, None, None


class _ScatterToSP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        return _reduce_scatter(x, mesh, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return _GatherFromSP.apply(g, ctx.mesh, ctx.axis, ctx.dim), None, None, None


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


# -- partition configuration and view layouts ----------------------------------------

@dataclass(frozen=True)
class PartitionConfig:
    """How the cell, embed and head programs partition: the tp axis, its
    degree, whether the non-matmul regions are sequence-sharded over the same
    ranks, and the mesh whose groups the collectives use."""
    axis: str
    n_tp: int
    sp: bool = False
    mesh: Optional[Mesh] = field(default=None, compare=False)


def view_shape(shape: Tuple[int, ...], layout) -> Tuple[int, ...]:
    """Storage shape of a partitioned leaf: ``layout`` None (replicated) or
    ``(dim, blocks)``; ``blocks`` > 1 stores ``dim`` as (blocks,
    size/blocks) and shards the within-block dim."""
    if layout is None or layout[1] <= 1:
        return tuple(shape)
    dim, blocks = layout
    return tuple(shape[:dim]) + (blocks, shape[dim] // blocks) + tuple(shape[dim + 1:])


def view_shard_dim(layout) -> Optional[int]:
    """Which dim of the view shape carries the tp sharding."""
    if layout is None:
        return None
    dim, blocks = layout
    return dim + 1 if blocks > 1 else dim


def _merge_view(w: torch.Tensor, layout) -> torch.Tensor:
    """A local view shard in the flat compute shape: (..., blocks, rows/tp,
    ...) -> (..., blocks * rows/tp, ...)."""
    if layout is None or layout[1] <= 1:
        return w
    dim = layout[0]
    return w.reshape(tuple(w.shape[:dim]) + (w.shape[dim] * w.shape[dim + 1],)
                     + tuple(w.shape[dim + 2:]))


def _tp_size(mesh: Optional[Mesh], axis: str) -> int:
    """The ranks of ``axis`` the collectives span: 1 off a mesh of ranks."""
    if mesh is None or not mesh.distributed:
        return 1
    return mesh.axis_size(axis)


def vocab_parallel_cross_entropy(h: torch.Tensor, w_local: torch.Tensor, b_local,
                                 labels: torch.Tensor, axis: str = "tp",
                                 mesh: Optional[Mesh] = None) -> torch.Tensor:
    """The decoder fused with the mean token cross entropy over a
    vocab-sharded (V/tp, C) decoder: local logits (B, T, V/tp) in f32, the
    global max (an all-reduce MAX of a detached tensor: a shift constant),
    the normalizer and the gold logit each summed over ``axis`` as (B, T);
    the full logits never exist. At one rank, the plain mean cross entropy."""
    mesh = mesh if mesh is not None else active_mesh()
    n = _tp_size(mesh, axis)
    logits = _ops.fully_connected(h, w_local, b_local, flatten=False).float()
    v_local = w_local.shape[0]
    off = mesh.axis_index(axis) * v_local if n > 1 else 0
    zmax = logits.detach().amax(dim=-1)
    if n > 1:
        zmax = _all_reduce(zmax, mesh, axis, "ce_all_reduce_max", dist.ReduceOp.MAX)
    sumexp = torch.exp(logits - zmax[..., None]).sum(dim=-1)
    loc = labels.long() - off
    ok = (loc >= 0) & (loc < v_local)
    gold = logits.gather(-1, loc.clamp(0, v_local - 1)[..., None])[..., 0]
    gold = torch.where(ok, gold, torch.zeros((), dtype=gold.dtype, device=gold.device))
    if n > 1:
        sumexp = _ReduceFromTP.apply(sumexp, mesh, axis, "ce_all_reduce")
        gold = _ReduceFromTP.apply(gold, mesh, axis, "ce_all_reduce")
    return torch.mean(zmax + torch.log(sumexp) - gold)


# -- layer plans: which slot plays which role, and each leaf's layout ---------------

@dataclass(frozen=True)
class _Dense:
    w: int
    b: Optional[int]


@dataclass(frozen=True)
class _MoE:
    gate_w: int
    w1: int
    w2: int
    top_k: int
    capacity_factor: float
    hidden: int
    n_experts: int


@dataclass(frozen=True)
class CellPlan:
    units: int
    heads: int
    head_major: bool
    use_blockwise: bool          # BERT SelfAttention's length-adaptive flash
    causal: bool                 # long context's RingSelfAttention
    dense_oracle: bool           # its dense_attention path
    attn_dropout: float
    ffn_dropout: float
    eps1: float
    eps2: float
    ln1: Tuple[int, int]
    ln2: Tuple[int, int]
    qkv: _Dense
    proj: _Dense
    ffn1: Optional[_Dense]
    ffn2: Optional[_Dense]
    moe: Optional[_MoE]
    layouts: Tuple[Optional[Tuple[int, int]], ...]


@dataclass(frozen=True)
class EmbedPlan:
    units: int
    word_w: int
    pos_w: int
    eps: float
    ln: Tuple[int, int]
    dropout: float
    layouts: Tuple[Optional[Tuple[int, int]], ...]


@dataclass(frozen=True)
class HeadPlan:
    units: int
    vocab: int
    eps: float
    ln: Tuple[int, int]
    mlm_dense: Optional[_Dense]      # BERT's MLM transform (dense + LN)
    mlm_ln: Optional[Tuple[int, int]]
    mlm_eps: float
    dec: _Dense
    layouts: Tuple[Optional[Tuple[int, int]], ...]


def _slot(slots, param, what) -> int:
    i = slots.get(id(param))
    if i is None:
        raise MXNetError(f"partitioned tp: {what} parameter is not in the stage's parameter "
                         f"list; pipeline stages must own their blocks")
    return i


def _require_divisible(value, n_tp, what):
    if value % n_tp != 0:
        raise MXNetError(f"partitioned tp: {what} ({value}) does not divide by tp={n_tp}")


def _ln_plan(slots, ln, what):
    eps = float(getattr(ln, "_epsilon", 1e-5))
    return (_slot(slots, ln.gamma, f"{what}.gamma"), _slot(slots, ln.beta, f"{what}.beta")), eps


def _drop_rate(block) -> float:
    return float(block._rate) if block is not None else 0.0


def plan_cell(cell, plist, n_tp: int) -> CellPlan:
    """The partition plan of one transformer cell: BERT's
    ``TransformerEncoderCell`` and long context's ``_LCCell`` (dense FFN) or
    ``MoETransformerCell`` (experts split over tp); anything else, or
    separate q/k/v projections, raises."""
    from ..models.bert import SelfAttention
    slots = {id(p): i for i, p in enumerate(plist)}
    attn = getattr(cell, "attn", None)
    ln1, ln2 = getattr(cell, "ln1", None), getattr(cell, "ln2", None)
    if attn is None or ln1 is None or ln2 is None:
        raise MXNetError(f"partitioned tp: cell {type(cell).__name__} is not a pre-LN "
                         f"transformer block (needs .ln1/.attn/.ln2 and an .ffn or .moe)")
    if getattr(attn, "qkv", None) is None:
        raise MXNetError("partitioned tp requires the fused qkv projection "
                         "(SelfAttention(fused_qkv=True)): separate q/k/v matmuls would "
                         "shard into three tp-unfriendly K-splits")
    units, heads = int(attn._units), int(attn._heads)
    _require_divisible(heads, n_tp, "attention heads")
    head_major = bool(getattr(attn, "_head_major", False))
    layouts: List[Optional[Tuple[int, int]]] = [None] * len(plist)
    qkv = _Dense(_slot(slots, attn.qkv.weight, "qkv.weight"),
                 _slot(slots, attn.qkv.bias, "qkv.bias"))
    # head-major keeps whole (q, k, v) triples of a head contiguous in the out
    # dim: a plain shard; the (3, H, d) default shards inside each block
    blocks = 1 if head_major else 3
    layouts[qkv.w] = (0, blocks)
    layouts[qkv.b] = (0, blocks)
    proj = _Dense(_slot(slots, attn.proj.weight, "proj.weight"),
                  _slot(slots, attn.proj.bias, "proj.bias"))
    layouts[proj.w] = (1, 1)
    ln1_idx, eps1 = _ln_plan(slots, ln1, "ln1")
    ln2_idx, eps2 = _ln_plan(slots, ln2, "ln2")
    ffn1 = ffn2 = moe = None
    ffn, moe_blk = getattr(cell, "ffn", None), getattr(cell, "moe", None)
    if ffn is not None:
        _require_divisible(ffn.ffn1.weight.shape[0], n_tp, "ffn hidden size")
        ffn1 = _Dense(_slot(slots, ffn.ffn1.weight, "ffn1.weight"),
                      _slot(slots, ffn.ffn1.bias, "ffn1.bias"))
        ffn2 = _Dense(_slot(slots, ffn.ffn2.weight, "ffn2.weight"),
                      _slot(slots, ffn.ffn2.bias, "ffn2.bias"))
        layouts[ffn1.w] = (0, 1)
        layouts[ffn1.b] = (0, 1)
        layouts[ffn2.w] = (1, 1)
        ffn_dropout = _drop_rate(getattr(ffn, "dropout", None))
    elif moe_blk is not None:
        if getattr(moe_blk, "_dense_ffn", False):
            raise MXNetError("partitioned tp: the MoE dense_ffn oracle uses expert 0 only, "
                             "which lives on one tp rank after expert sharding; run the "
                             "oracle with tp_mode='sharded'")
        n_experts = int(moe_blk._num_experts)
        _require_divisible(n_experts, n_tp, "MoE experts")
        moe = _MoE(_slot(slots, moe_blk.gate_w, "moe.gate_w"),
                   _slot(slots, moe_blk.w1, "moe.w1"), _slot(slots, moe_blk.w2, "moe.w2"),
                   int(moe_blk._top_k), float(moe_blk._capacity_factor),
                   int(moe_blk.w1.shape[2]), n_experts)
        layouts[moe.w1] = (0, 1)
        layouts[moe.w2] = (0, 1)
        ffn_dropout = 0.0
    else:
        raise MXNetError(f"partitioned tp: cell {type(cell).__name__} has neither .ffn "
                         f"(PositionwiseFFN) nor .moe (MoEPositionwiseFFN)")
    return CellPlan(
        units=units, heads=heads, head_major=head_major,
        use_blockwise=bool(getattr(attn, "_use_blockwise", False)),
        causal=not isinstance(attn, SelfAttention),
        dense_oracle=bool(getattr(attn, "_dense", False)),
        attn_dropout=_drop_rate(getattr(attn, "dropout", None)),
        ffn_dropout=ffn_dropout, eps1=eps1, eps2=eps2, ln1=ln1_idx, ln2=ln2_idx,
        qkv=qkv, proj=proj, ffn1=ffn1, ffn2=ffn2, moe=moe, layouts=tuple(layouts))


def plan_embed(embed, plist, n_tp: int) -> EmbedPlan:
    """The partition plan of the embedding stage: word and position tables,
    LN, optional dropout; the word table vocab-sharded. An unused table
    (BERT's ``seg_embed``) stays replicated with a zero gradient."""
    slots = {id(p): i for i, p in enumerate(plist)}
    word, pos = getattr(embed, "word_embed", None), getattr(embed, "pos_embed", None)
    ln = getattr(embed, "embed_ln", None)
    if word is None or pos is None or ln is None:
        raise MXNetError(f"partitioned tp: embed stage {type(embed).__name__} needs "
                         f".word_embed/.pos_embed/.embed_ln")
    vocab, units = word.weight.shape
    _require_divisible(vocab, n_tp, "vocab size")
    layouts: List[Optional[Tuple[int, int]]] = [None] * len(plist)
    word_w = _slot(slots, word.weight, "word_embed.weight")
    layouts[word_w] = (0, 1)
    ln_idx, eps = _ln_plan(slots, ln, "embed_ln")
    return EmbedPlan(units=int(units), word_w=word_w,
                     pos_w=_slot(slots, pos.weight, "pos_embed.weight"), eps=eps, ln=ln_idx,
                     dropout=_drop_rate(getattr(embed, "drop", None)),
                     layouts=tuple(layouts))


def plan_head(head, plist, n_tp: int) -> HeadPlan:
    """The partition plan of the head stage: the final LN (and BERT's MLM
    dense + LN transform), the vocab-sharded decoder fused into the loss."""
    slots = {id(p): i for i, p in enumerate(plist)}
    ln = getattr(head, "ln", None)
    dec = getattr(head, "mlm_decoder", None) or getattr(head, "decoder", None)
    if ln is None or dec is None:
        raise MXNetError(f"partitioned tp: head stage {type(head).__name__} needs .ln and "
                         f".decoder/.mlm_decoder")
    vocab, units = dec.weight.shape
    _require_divisible(vocab, n_tp, "decoder vocab size")
    layouts: List[Optional[Tuple[int, int]]] = [None] * len(plist)
    dec_idx = _Dense(_slot(slots, dec.weight, "decoder.weight"),
                     _slot(slots, dec.bias, "decoder.bias"))
    layouts[dec_idx.w] = (0, 1)
    layouts[dec_idx.b] = (0, 1)
    ln_idx, eps = _ln_plan(slots, ln, "head.ln")
    mlm_dense = mlm_ln = None
    mlm_eps = 1e-5
    if getattr(head, "mlm_dense", None) is not None:
        mlm_dense = _Dense(_slot(slots, head.mlm_dense.weight, "mlm_dense.weight"),
                           _slot(slots, head.mlm_dense.bias, "mlm_dense.bias"))
        mlm_ln, mlm_eps = _ln_plan(slots, head.mlm_ln, "mlm_ln")
    return HeadPlan(units=int(units), vocab=int(vocab), eps=eps, ln=ln_idx,
                    mlm_dense=mlm_dense, mlm_ln=mlm_ln, mlm_eps=mlm_eps, dec=dec_idx,
                    layouts=tuple(layouts))


# -- the programs (called from PipelineTrainer's schedule) --------------------------

def _rep_fn(cfg: PartitionConfig, token_sharded: bool):
    """Wrapper of a replicated leaf: identity when its compute is
    token-sharded (its gradient is partial by nature) or at tp 1, else
    ``partial_grad``."""
    if token_sharded or cfg.n_tp <= 1:
        return lambda w: w
    return lambda w: partial_grad(w, cfg.axis, cfg.mesh)


def _seed(key) -> int:
    """A 63-bit generator seed from a key tuple of ints."""
    digest = hashlib.blake2b(repr(tuple(int(k) for k in key)).encode(), digest_size=8)
    return int.from_bytes(digest.digest(), "little") >> 1


def _dropout(x: torch.Tensor, key, rate: float, cfg: PartitionConfig, full_shape):
    """Dropout whose mask is drawn at ``full_shape`` from a generator seeded
    by ``key`` and sliced to this rank's tokens when ``x`` is a sequence
    shard: sp and non-sp drop the same elements for the same key."""
    if rate <= 0.0:
        return x
    keep = 1.0 - rate
    gen = torch.Generator(device=x.device)
    gen.manual_seed(_seed(key))
    mask = torch.rand(tuple(full_shape), generator=gen, device=x.device) < keep
    if tuple(mask.shape) != tuple(x.shape):
        t = x.shape[1]
        mask = mask.narrow(1, cfg.mesh.axis_index(cfg.axis) * t, t)
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))


def _enter_tp(x, cfg: PartitionConfig):
    """Non-matmul region -> matmul region."""
    if cfg.n_tp <= 1:
        return x
    return gather_from_sp(x, cfg.axis, 1, cfg.mesh) if cfg.sp \
        else copy_to_tp(x, cfg.axis, cfg.mesh)


def _exit_tp(x, cfg: PartitionConfig):
    """Matmul region (partial products) -> non-matmul region."""
    if cfg.n_tp <= 1:
        return x
    return scatter_to_sp(x, cfg.axis, 1, cfg.mesh) if cfg.sp \
        else reduce_from_tp(x, cfg.axis, cfg.mesh)


def _attention(plan: CellPlan, cfg: PartitionConfig, x, leaves):
    """Self-attention of this rank's H/tp heads on the (B, T, C) input;
    returns the row-parallel proj's PARTIAL product without its bias. The
    math of ``models.bert.SelfAttention`` / long context's
    ``RingSelfAttention`` on the local heads."""
    from ..ops.attention import flash_attention_op
    h_local = plan.heads // cfg.n_tp
    d = plan.units // plan.heads
    wq = _merge_view(leaves[plan.qkv.w], plan.layouts[plan.qkv.w])
    bq = _merge_view(leaves[plan.qkv.b], plan.layouts[plan.qkv.b])
    qkv = _ops.fully_connected(x, wq, bq, flatten=False)          # (B, T, 3C/tp)
    B, T = qkv.shape[0], qkv.shape[1]
    if plan.head_major:
        qkv = qkv.reshape(B, T, h_local, 3, d)
        q, k, v = (qkv[:, :, :, i].permute(0, 2, 1, 3) for i in range(3))
    else:
        qkv = qkv.reshape(B, T, 3, h_local, d)
        q, k, v = (qkv[:, :, i].permute(0, 2, 1, 3) for i in range(3))
    if plan.causal:
        if plan.dense_oracle:
            s = torch.matmul(q.float(), k.float().transpose(-1, -2)) / math.sqrt(d)
            mask = torch.ones(T, T, dtype=torch.bool, device=s.device).tril()
            s = torch.where(mask, s, -1e30)
            out = torch.matmul(torch.softmax(s, dim=-1), v.float()).to(q.dtype)
        else:
            out = flash_attention_op(q, k, v, causal=True)
    elif plan.use_blockwise and T >= env.get("MXNET_FLASH_ATTENTION_MIN_SEQ"):
        out = flash_attention_op(q, k, v, causal=False)
    else:
        q2, k2, v2 = (a.reshape(B * h_local, T, d) for a in (q, k, v))
        att = _ops.softmax(_batch_dot(q2, k2, transpose_b=True) / math.sqrt(d), axis=-1)
        out = _batch_dot(att, v2).reshape(B, h_local, T, d)
    out = out.permute(0, 2, 1, 3).reshape(B, T, h_local * d)
    return _ops.fully_connected(out, leaves[plan.proj.w], None, flatten=False)


def _tp_moe(plan: _MoE, cfg: PartitionConfig, flat, gate_w, w1_local, w2_local):
    """Expert-partitioned MoE FFN: gating over the FULL token set on every
    rank (the single-shard ``moe_ffn``'s capacity and overflow), then this
    rank's E/tp experts of the dispatch and combine tensors. Returns the
    PARTIAL (N, C) combine product for the exit collective."""
    from . import moe as _moe
    from ..models.moe_transformer import _gelu
    N = flat.shape[0]
    e_local = w1_local.shape[0]
    capacity = _moe.moe_capacity(N, plan.top_k, plan.capacity_factor, plan.n_experts)
    dispatch, combine = _moe.topk_gating(flat @ gate_w, plan.top_k, capacity)
    combine = combine / torch.clamp_min(combine.sum(dim=(1, 2), keepdim=True), 1e-9)
    r = cfg.mesh.axis_index(cfg.axis) if cfg.n_tp > 1 else 0
    disp_l = dispatch.narrow(1, r * e_local, e_local)
    comb_l = combine.narrow(1, r * e_local, e_local)
    expert_in = torch.einsum("nd,nec->ecd", flat, disp_l)
    h = _gelu(torch.einsum("ecd,edh->ech", expert_in, w1_local))
    return torch.einsum("ecd,nec->nd", torch.einsum("ech,ehd->ecd", h, w2_local), comb_l)


def cell_forward(plan: CellPlan, cfg: PartitionConfig, leaves, h, key, train: bool = True):
    """One partitioned transformer cell. ``h`` is (B, T, C), or (B, T/tp, C)
    under sequence parallelism; ``leaves`` this rank's local view shards in
    the cell's parameter order; ``key`` a tuple of ints unique per (step,
    stage, layer, microbatch), the same on every tp rank."""
    rep = _rep_fn(cfg, cfg.sp)
    full_T = h.shape[1] * (cfg.n_tp if cfg.sp and cfg.n_tp > 1 else 1)
    full_act = (h.shape[0], full_T, h.shape[2])
    a = _ops.layer_norm(h, rep(leaves[plan.ln1[0]]), rep(leaves[plan.ln1[1]]),
                        eps=plan.eps1)
    att = _exit_tp(_attention(plan, cfg, _enter_tp(a, cfg), leaves), cfg)
    att = att + rep(leaves[plan.proj.b])
    if train and plan.attn_dropout:
        att = _dropout(att, tuple(key) + (1,), plan.attn_dropout, cfg, full_act)
    h = h + att
    b = _ops.layer_norm(h, rep(leaves[plan.ln2[0]]), rep(leaves[plan.ln2[1]]),
                        eps=plan.eps2)
    bf = _enter_tp(b, cfg)
    if plan.moe is not None:
        B, T, C = bf.shape
        y = _tp_moe(plan.moe, cfg, bf.reshape(B * T, C), leaves[plan.moe.gate_w],
                    leaves[plan.moe.w1], leaves[plan.moe.w2]).reshape(B, T, C)
        y = _exit_tp(y, cfg)
    else:
        hdn = _ops.activation(_ops.fully_connected(bf, leaves[plan.ffn1.w],
                                                   leaves[plan.ffn1.b], flatten=False),
                              act_type="gelu")
        y = _exit_tp(_ops.fully_connected(hdn, leaves[plan.ffn2.w], None, flatten=False), cfg)
        y = y + rep(leaves[plan.ffn2.b])
        if train and plan.ffn_dropout:
            y = _dropout(y, tuple(key) + (2,), plan.ffn_dropout, cfg, full_act)
    return h + y


def embed_forward(plan: EmbedPlan, cfg: PartitionConfig, leaves, tokens, key,
                  train: bool = True):
    """The vocab-parallel embedding stage: the partial word lookup summed
    over tp (reduce-scattered to sequence shards under sp), positions, LN,
    dropout. ``tokens``: (B, T), the whole sequence on every rank."""
    rep = _rep_fn(cfg, cfg.sp)
    T = tokens.shape[1]
    if cfg.n_tp > 1:
        emb = vocab_parallel_embedding(tokens, leaves[plan.word_w], cfg.axis, cfg.mesh)
    else:
        emb = _ops.embedding(tokens, leaves[plan.word_w])
    pos_w = leaves[plan.pos_w]
    if cfg.sp and cfg.n_tp > 1:
        x = scatter_to_sp(emb, cfg.axis, 1, cfg.mesh)             # (B, T/tp, C)
        t_local = T // cfg.n_tp
        start = cfg.mesh.axis_index(cfg.axis) * t_local
        pos = torch.arange(start, start + t_local, dtype=torch.int32, device=tokens.device)
        x = x + _ops.embedding(pos, pos_w)[None]       # this rank's rows: a partial grad
    else:
        x = reduce_from_tp(emb, cfg.axis, cfg.mesh) if cfg.n_tp > 1 else emb
        pos = torch.arange(T, dtype=torch.int32, device=tokens.device)
        x = x + _ops.embedding(pos, rep(pos_w))[None]
    x = _ops.layer_norm(x, rep(leaves[plan.ln[0]]), rep(leaves[plan.ln[1]]), eps=plan.eps)
    if train and plan.dropout:
        x = _dropout(x, tuple(key) + (0,), plan.dropout, cfg, (x.shape[0], T, x.shape[2]))
    return x


def head_loss_forward(plan: HeadPlan, cfg: PartitionConfig, leaves, h, labels, key=None,
                      train: bool = True):
    """The head stage fused with the vocab-parallel cross entropy: LN (and
    BERT's MLM transform) on the activations (sequence shards under sp),
    the entry to the tp region, then the loss that never forms the full
    logits. ``labels``: (B, T). Returns the mean token loss, the same on
    every tp rank."""
    rep = _rep_fn(cfg, cfg.sp)
    x = _ops.layer_norm(h, rep(leaves[plan.ln[0]]), rep(leaves[plan.ln[1]]), eps=plan.eps)
    if plan.mlm_dense is not None:
        x = _ops.activation(_ops.fully_connected(x, rep(leaves[plan.mlm_dense.w]),
                                                 rep(leaves[plan.mlm_dense.b]),
                                                 flatten=False), act_type="gelu")
        x = _ops.layer_norm(x, rep(leaves[plan.mlm_ln[0]]), rep(leaves[plan.mlm_ln[1]]),
                            eps=plan.mlm_eps)
    if cfg.n_tp > 1:
        # the loss backpropagates only this rank's vocab slice into x: the
        # entry's backward (all-reduce, or reduce-scatter) completes it
        x = gather_from_sp(x, cfg.axis, 1, cfg.mesh) if cfg.sp \
            else copy_to_tp(x, cfg.axis, cfg.mesh)
    return vocab_parallel_cross_entropy(x, leaves[plan.dec.w], leaves[plan.dec.b], labels,
                                        cfg.axis, cfg.mesh)
