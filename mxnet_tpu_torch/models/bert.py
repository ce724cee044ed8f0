"""BERT / transformer encoder, the flagship model, for inference.

Counterpart of ``mxnet_tpu/models/bert.py:38-273``: ``SelfAttention``,
``PositionwiseFFN``, ``TransformerEncoderCell`` (pre-LN), ``BertEncoder``,
``BertModel`` and ``bert_tiny/bert_base/bert_large``, with the same
parameter paths, the fused-QKV layout ``(0, 0, 3, H, d)`` and its
``head_major_qkv`` variant ``(0, 0, H, 3, d)``.

Attention takes the flash op ``_contrib_flash_attention`` (the CUDA kernel
on the card, its plain version on the CPU) when no mask is given and
T >= ``MXNET_FLASH_ATTENTION_MIN_SEQ`` (default 1024, read at every call,
the same variable and default as the reference, so both packages take the
same branch); otherwise the plain ``batch_dot``/``softmax`` path. The
reference's symbolic-export branch (no concrete shape) waits for a later
slice.

``BertModel.pipeline_split()`` (reference :205-263) gives
``parallel.PipelineTrainer`` its ``(embed, cells, head)``: fresh wrappers
``_BertEmbedStage`` (token and position embeddings, ``embed_ln``, the
embedding dropout; ``seg_embed`` is registered but, as in the reference,
not used) and ``_BertHeadStage`` (``encoder.ln``, ``mlm_dense``,
``mlm_ln``, ``mlm_decoder``) that re-register the model's own child blocks,
and the encoder's cells. No wrapper is stored on the model, so its
``collect_params()`` and ``load_jax_params`` see each parameter once.

On a mesh of ranks (``parallel.DataParallelTrainer``, the reference's
GSPMD step with ``shard_params_megatron`` and ``data_spec=P("dp", "sp")``):

- with the fused QKV projection column-parallel over ``tp``, each rank
  computes its H/tp heads. That needs ``head_major_qkv=True``, whose
  (H, 3, d) output layout puts whole (q, k, v) triples of heads in each
  rank's slice of the projection (the reference's comment at
  ``mxnet_tpu/models/bert.py:56-62``); the other layout raises;
- when the step shards the sequence (``parallel.sequence_axis()``, an axis
  of size > 1), each rank holds T/sp tokens: positions start at its first
  token, and attention is ``ops.attention.sequence_parallel_attention``
  (the flash kernels on the local query rows against the gathered keys);
  with a mask, the plain path on the local query rows against the gathered
  keys and values, the mask cut to those rows (the reference's global
  view, ``mxnet_tpu/models/bert.py:110-123``).
"""
from __future__ import annotations

import math

from ..base import MXNetError, env
from ..ndarray import NDArray
from ..gluon.block import HybridBlock
from ..gluon import nn

__all__ = ["TransformerEncoderCell", "BertEncoder", "BertModel", "bert_base",
           "bert_large", "bert_tiny"]


def _sequence_shard():
    """(mesh, axis) when the running step shards the sequence over an axis
    of size > 1, else None."""
    from ..parallel.mesh import active_mesh, sequence_axis
    axis = sequence_axis()
    if axis is None or active_mesh().axis_size(axis) == 1:
        return None
    return active_mesh(), axis


def _position_ids(token_ids):
    """Position indices (T,) on the tokens' device; under a sequence shard,
    those of this rank's tokens."""
    from .. import ndarray as nd
    T = token_ids.shape[1]
    shard = _sequence_shard()
    start = 0 if shard is None else shard[0].axis_index(shard[1]) * T
    return nd.arange(start, start + T, dtype="int32", ctx=token_ids.ctx)


def _plain_attention(F, q, k, v, d, H, mask):
    """softmax(q kᵀ / sqrt(d) + (1 - mask) * -1e9) v on (B, H, T, d) inputs,
    the keys possibly longer than the queries (reference :117-125)."""
    q2 = F.reshape(q, shape=(-3, 0, 0))         # (B*H, Tq, d)
    k2 = F.reshape(k, shape=(-3, 0, 0))         # (B*H, Tk, d)
    v2 = F.reshape(v, shape=(-3, 0, 0))
    scores = F.batch_dot(q2, k2, transpose_b=True) / math.sqrt(d)
    if mask is not None:
        scores = scores + (1.0 - mask) * -1e9
    att = F.softmax(scores, axis=-1)
    out = F.batch_dot(att, v2)
    return F.reshape(out, shape=(-4, -1, H, 0, 0))  # (B, H, Tq, d)


def _query_rows(F, mask, mesh, axis, t_local):
    """``mask`` (broadcast against the (B*H, T, T) scores) cut to this rank's
    ``t_local`` query rows where it has a query axis of the whole sequence;
    a query axis of 1 broadcasts, and the key axis stays whole."""
    n = mesh.axis_size(axis)
    if len(mask.shape) < 2 or mask.shape[-2] == 1:
        return mask
    if mask.shape[-2] != t_local * n:
        raise MXNetError(f"a mask under a sequence shard of {n} ranks needs a query axis "
                         f"of 1 or of the whole sequence ({t_local * n}), got "
                         f"{tuple(mask.shape)}")
    r = mesh.axis_index(axis)
    return F.slice_axis(mask, axis=len(mask.shape) - 2, begin=r * t_local,
                        end=(r + 1) * t_local)


class SelfAttention(HybridBlock):
    """Q/K/V ride ONE (C -> 3C) projection by default (fused_qkv=True)."""

    def __init__(self, units, num_heads, dropout=0.0, use_blockwise=True,
                 fused_qkv=True, head_major_qkv=False, **kwargs):
        super().__init__(**kwargs)
        assert units % num_heads == 0
        self._units = units
        self._heads = num_heads
        self._use_blockwise = use_blockwise
        self._fused_qkv = fused_qkv
        self._head_major = head_major_qkv
        if fused_qkv:
            self.qkv = nn.Dense(3 * units, flatten=False, in_units=units)
        else:
            self.q_proj = nn.Dense(units, flatten=False, in_units=units)
            self.k_proj = nn.Dense(units, flatten=False, in_units=units)
            self.v_proj = nn.Dense(units, flatten=False, in_units=units)
        self.proj = nn.Dense(units, flatten=False, in_units=units)
        self.dropout = nn.Dropout(dropout) if dropout else None

    def _local_heads(self) -> int:
        """The heads this rank computes: H, or H/tp under a column-parallel
        QKV projection."""
        w = (self.qkv if self._fused_qkv else self.q_proj).weight
        if w._mesh is None or w.sharding is None or w.sharding[0] is None:
            return self._heads
        tp = w._mesh.axis_size(w.sharding[0])
        if self._heads % tp:
            raise MXNetError(f"{self._heads} heads do not split over {tp} ranks")
        if self._fused_qkv and not self._head_major and tp > 1:
            raise MXNetError("a tensor-parallel fused QKV projection needs "
                             "head_major_qkv=True (whole heads on each rank)")
        return self._heads // tp

    def hybrid_forward(self, F, x, mask=None):
        # x: (B, T, C). Shapes go through MXNet reshape codes (0 copy,
        # -1 infer, -3 merge, -4 split), as in the reference.
        H = self._local_heads()
        d = self._units // self._heads
        if self._fused_qkv:
            qkv = self.qkv(x)  # (B, T, 3C)
            if self._head_major:
                qkv = F.reshape(qkv, shape=(0, 0, H, 3, d))
                slice_ax, merge = 3, (0, 0, 0, -3)      # merge the 1*d tail
            else:
                qkv = F.reshape(qkv, shape=(0, 0, 3, H, d))
                slice_ax, merge = 2, (0, 0, -3, 0)      # merge the 1*H pair
            q, k, v = (
                F.transpose(                            # (B, H, T, d)
                    F.reshape(                          # (B, T, H, d)
                        F.slice_axis(qkv, axis=slice_ax, begin=i, end=i + 1),
                        shape=merge),
                    axes=(0, 2, 1, 3))
                for i in range(3))
        else:
            q, k, v = (
                F.transpose(                            # split C -> (H, d)
                    F.reshape(proj(x), shape=(0, 0, -4, H, -1)),
                    axes=(0, 2, 1, 3))
                for proj in (self.q_proj, self.k_proj, self.v_proj))
        min_t = env.get("MXNET_FLASH_ATTENTION_MIN_SEQ")
        shard = _sequence_shard()
        if shard is not None and mask is None:
            from ..ops.attention import sequence_parallel_attention
            out = NDArray(sequence_parallel_attention(q._data, k._data, v._data,
                                                      shard[1], shard[0]), q.ctx)
        elif shard is not None:
            # the reference keeps a global view and adds the mask on the plain
            # path: this rank's query rows against the gathered keys and
            # values, the mask cut to those rows (the gradient of the gathered
            # K and V reduce-scattered back by gather_from_sp)
            from ..parallel.megatron import gather_from_sp
            mesh, axis = shard
            k, v = (NDArray(gather_from_sp(t._data, axis, 2, mesh), t.ctx) for t in (k, v))
            out = _plain_attention(F, q, k, v, d, H,
                                   _query_rows(F, mask, mesh, axis, q.shape[2]))
        elif self._use_blockwise and mask is None and x.shape[1] >= min_t:
            out = F._contrib_flash_attention(q, k, v, causal=False)
        else:
            out = _plain_attention(F, q, k, v, d, H, mask)
        out = F.reshape(F.transpose(out, axes=(0, 2, 1, 3)),
                        shape=(0, 0, -3))               # (B, T, C)
        out = self.proj(out)
        if self.dropout:
            out = self.dropout(out)
        return out


class PositionwiseFFN(HybridBlock):
    def __init__(self, units, hidden_size, dropout=0.0, **kwargs):
        super().__init__(**kwargs)
        self.ffn1 = nn.Dense(hidden_size, flatten=False, in_units=units)
        self.ffn2 = nn.Dense(units, flatten=False, in_units=hidden_size)
        self.dropout = nn.Dropout(dropout) if dropout else None

    def hybrid_forward(self, F, x):
        h = F.gelu(self.ffn1(x))
        h = self.ffn2(h)
        if self.dropout:
            h = self.dropout(h)
        return h


class TransformerEncoderCell(HybridBlock):
    """Pre-LN encoder block."""

    def __init__(self, units, hidden_size, num_heads, dropout=0.0,
                 fused_qkv=True, head_major_qkv=False, **kwargs):
        super().__init__(**kwargs)
        self.ln1 = nn.LayerNorm(in_channels=units)
        self.attn = SelfAttention(units, num_heads, dropout,
                                  fused_qkv=fused_qkv,
                                  head_major_qkv=head_major_qkv)
        self.ln2 = nn.LayerNorm(in_channels=units)
        self.ffn = PositionwiseFFN(units, hidden_size, dropout)

    def hybrid_forward(self, F, x):
        x = x + self.attn(self.ln1(x))
        x = x + self.ffn(self.ln2(x))
        return x


class BertEncoder(HybridBlock):
    def __init__(self, num_layers, units, hidden_size, num_heads, dropout=0.0,
                 fused_qkv=True, head_major_qkv=False, **kwargs):
        super().__init__(**kwargs)
        self.layers = nn.HybridSequential()
        for _ in range(num_layers):
            self.layers.add(TransformerEncoderCell(
                units, hidden_size, num_heads, dropout,
                fused_qkv=fused_qkv, head_major_qkv=head_major_qkv))
        self.ln = nn.LayerNorm(in_channels=units)

    def hybrid_forward(self, F, x):
        return self.ln(self.layers(x))


class BertModel(HybridBlock):
    """Token + position + segment embeddings -> encoder -> MLM head."""

    def __init__(self, vocab_size=30522, num_layers=12, units=768,
                 hidden_size=3072, num_heads=12, max_length=512,
                 dropout=0.0, fused_qkv=True, head_major_qkv=False, **kwargs):
        super().__init__(**kwargs)
        self._units = units
        self.word_embed = nn.Embedding(vocab_size, units)
        self.pos_embed = nn.Embedding(max_length, units)
        self.seg_embed = nn.Embedding(2, units)
        self.embed_ln = nn.LayerNorm(in_channels=units)
        self.embed_drop = nn.Dropout(dropout) if dropout else None
        self.encoder = BertEncoder(num_layers, units, hidden_size, num_heads,
                                   dropout, fused_qkv=fused_qkv,
                                   head_major_qkv=head_major_qkv)
        self.mlm_dense = nn.Dense(units, flatten=False, activation="gelu",
                                  in_units=units)
        self.mlm_ln = nn.LayerNorm(in_channels=units)
        self.mlm_decoder = nn.Dense(vocab_size, flatten=False, in_units=units)

    def pipeline_split(self):
        """(embed, cells, head) for ``parallel.PipelineTrainer``. The wrappers
        re-register this model's own child blocks, so the parameters are
        shared and the trainer's updates land in this model."""
        cells = [self.encoder.layers[i] for i in range(len(self.encoder.layers))]
        return _BertEmbedStage(self), cells, _BertHeadStage(self)

    def hybrid_forward(self, F, token_ids, segment_ids=None):
        pos = _position_ids(token_ids)
        x = self.word_embed(token_ids) + self.pos_embed(pos).expand_dims(axis=0)
        if segment_ids is not None:
            x = x + self.seg_embed(segment_ids)
        x = self.embed_ln(x)
        if self.embed_drop:
            x = self.embed_drop(x)
        x = self.encoder(x)
        h = self.mlm_ln(self.mlm_dense(x))
        return self.mlm_decoder(h)


class _BertEmbedStage(HybridBlock):
    """Pipeline stage 0's entry: the embedding section of BertModel's
    forward, on the parent model's child blocks (no new parameters)."""

    def __init__(self, bert, **kwargs):
        super().__init__(**kwargs)
        self.word_embed = bert.word_embed
        self.pos_embed = bert.pos_embed
        self.seg_embed = bert.seg_embed
        self.embed_ln = bert.embed_ln
        self.drop = bert.embed_drop

    def hybrid_forward(self, F, token_ids):
        pos = _position_ids(token_ids)
        x = self.word_embed(token_ids) + self.pos_embed(pos).expand_dims(axis=0)
        x = self.embed_ln(x)
        if self.drop:
            x = self.drop(x)
        return x


class _BertHeadStage(HybridBlock):
    """Pipeline last stage's tail: the encoder's final LayerNorm and the MLM
    head of BertModel, on the parent model's child blocks."""

    def __init__(self, bert, **kwargs):
        super().__init__(**kwargs)
        self.ln = bert.encoder.ln
        self.mlm_dense = bert.mlm_dense
        self.mlm_ln = bert.mlm_ln
        self.mlm_decoder = bert.mlm_decoder

    def hybrid_forward(self, F, x):
        h = self.mlm_ln(self.mlm_dense(self.ln(x)))
        return self.mlm_decoder(h)


def bert_tiny(vocab_size=8192, **kw):
    return BertModel(vocab_size, num_layers=2, units=128, hidden_size=512,
                     num_heads=2, **kw)


def bert_base(vocab_size=30522, **kw):
    return BertModel(vocab_size, num_layers=12, units=768, hidden_size=3072,
                     num_heads=12, **kw)


def bert_large(vocab_size=30522, **kw):
    return BertModel(vocab_size, num_layers=24, units=1024, hidden_size=4096,
                     num_heads=16, **kw)
