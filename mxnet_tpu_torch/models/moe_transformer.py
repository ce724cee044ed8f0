"""Sparse-MoE transformer LM, the expert-parallel recipe's model.

Counterpart of ``mxnet_tpu/models/moe_transformer.py``: a pre-LN
decoder-only transformer whose FFN is a capacity-gated mixture of experts
(``parallel/moe.py``), with the reference's parameter paths
(``cells.<i>.moe.gate_w``, ``.w1``, ``.w2``, ``cells.<i>.attn.qkv.weight``),
so ``convert.load_jax_params`` carries its weights unchanged.

- ``MoEPositionwiseFFN`` (:37): the expert weights are registered at full
  (E, ...) shapes and tagged ``_is_moe_expert``, so ``recipes.moe.MoETrainer``
  places them on its ``ep`` axis (each rank keeps its E/ep experts) and keeps
  them out of the dp ZeRO buckets. Under ``parallel.moe.expert_axis`` the
  cell dispatches with ``expert_parallel_moe`` over that axis of the active
  mesh; otherwise with ``moe_ffn``. Each gated forward reports its aux loss
  and dropped count (``parallel.moe.report_metrics``). The activation is the
  tanh GELU (the reference calls ``jax.nn.gelu``, whose default is the tanh
  form; BERT's registered ``gelu`` op is the erf form). ``dense_ffn=True``
  builds the parity oracle: expert 0 as a plain FFN, the gate ignored.
- ``MoETransformerCell`` (:93), ``MoETransformerLM`` (:114) and
  ``moe_transformer_tiny`` (:177). The attention is ``models.bert``'s
  ``SelfAttention``: the flash kernels (K1-K3 on the card) at T >=
  ``MXNET_FLASH_ATTENTION_MIN_SEQ``.

Unlike the reference's, the port's cell is differentiable by autograd
(``autograd.record()``), so the eager tape trains it too.
``MoETransformerLM.pipeline_split`` (:141-175) gives
``parallel.PipelineTrainer`` the embedding section (``_MoEEmbedStage``), the
cells and the final LN + decoder (``_MoEHeadStage``) on the model's own
child blocks. Under ``tp_mode="partitioned"`` the cells run
``parallel.megatron``'s ``_tp_moe`` (experts split over tp). The pipeline's
loss is the task loss, as the reference's: the aux values that
``report_metrics`` collects are not added to it, and the capacity is each
microbatch's.
"""
from __future__ import annotations

import torch

from ..gluon.block import HybridBlock
from ..gluon import nn
from ..ndarray import NDArray
from .bert import SelfAttention, _position_ids

__all__ = ["MoEPositionwiseFFN", "MoETransformerCell", "MoETransformerLM",
           "moe_transformer_tiny"]


def _gelu(x):
    return torch.nn.functional.gelu(x, approximate="tanh")


class MoEPositionwiseFFN(HybridBlock):
    """Capacity-gated top-k MoE FFN over (B, T, C) activations."""

    def __init__(self, units, hidden_size, num_experts, top_k=2, capacity_factor=1.5,
                 dense_ffn=False, **kwargs):
        super().__init__(**kwargs)
        from .. import initializer as init_mod
        self._units = units
        self._num_experts = num_experts
        self._top_k = top_k
        self._capacity_factor = capacity_factor
        self._dense_ffn = dense_ffn
        self.gate_w = self.params.get("gate_w", shape=(units, num_experts),
                                      init=init_mod.Normal(0.02))
        self.w1 = self.params.get("w1", shape=(num_experts, units, hidden_size),
                                  init=init_mod.Xavier())
        self.w2 = self.params.get("w2", shape=(num_experts, hidden_size, units),
                                  init=init_mod.Xavier())
        # the trainer places these on 'ep' and keeps them out of the dp buckets
        self.w1._is_moe_expert = True
        self.w2._is_moe_expert = True

    def hybrid_forward(self, F, x, gate_w, w1, w2):
        from ..parallel import moe as _moe
        xr, gw, w1r, w2r = x._data, gate_w._data, w1._data, w2._data
        B, T, C = xr.shape
        flat = xr.reshape(B * T, C)
        if self._dense_ffn:
            y = _gelu(flat @ w1r[0]) @ w2r[0]
            return NDArray(y.reshape(B, T, C), x.ctx)
        ctx = _moe.current_expert_axis()
        kw = dict(top_k=self._top_k, capacity_factor=self._capacity_factor,
                  activation=_gelu, normalize_gates=True, return_aux=True)
        if ctx is not None:
            # w1r/w2r are this rank's (E/ep, ...) shards, flat its token shard
            y, aux = _moe.expert_parallel_moe(flat, gw, w1r, w2r, axis_name=ctx.axis_name,
                                              comm_dtype=ctx.comm_dtype, **kw)
        else:
            y, aux = _moe.moe_ffn(flat, gw, w1r, w2r, **kw)
        _moe.report_metrics(aux)
        return NDArray(y.reshape(B, T, C), x.ctx)


class MoETransformerCell(HybridBlock):
    """Pre-LN block: attention + MoE FFN."""

    def __init__(self, units, hidden_size, num_heads, num_experts, top_k=2,
                 capacity_factor=1.5, dropout=0.0, dense_ffn=False, **kwargs):
        super().__init__(**kwargs)
        self.ln1 = nn.LayerNorm(in_channels=units)
        self.attn = SelfAttention(units, num_heads, dropout)
        self.ln2 = nn.LayerNorm(in_channels=units)
        self.moe = MoEPositionwiseFFN(units, hidden_size, num_experts, top_k=top_k,
                                      capacity_factor=capacity_factor, dense_ffn=dense_ffn)

    def hybrid_forward(self, F, x):
        x = x + self.attn(self.ln1(x))
        return x + self.moe(self.ln2(x))


class MoETransformerLM(HybridBlock):
    """Token + position embeddings -> N MoE cells -> LM head."""

    def __init__(self, vocab_size, num_layers=2, units=128, hidden_size=256, num_heads=2,
                 num_experts=4, top_k=2, capacity_factor=1.5, max_length=512, dropout=0.0,
                 dense_ffn=False, **kwargs):
        super().__init__(**kwargs)
        self._units = units
        self.word_embed = nn.Embedding(vocab_size, units)
        self.pos_embed = nn.Embedding(max_length, units)
        self.embed_ln = nn.LayerNorm(in_channels=units)
        self.cells = nn.HybridSequential()
        for _ in range(num_layers):
            self.cells.add(MoETransformerCell(units, hidden_size, num_heads, num_experts,
                                              top_k=top_k, capacity_factor=capacity_factor,
                                              dropout=dropout, dense_ffn=dense_ffn))
        self.ln = nn.LayerNorm(in_channels=units)
        self.decoder = nn.Dense(vocab_size, flatten=False, in_units=units)

    def hybrid_forward(self, F, token_ids):
        pos = _position_ids(token_ids)
        x = self.word_embed(token_ids) + self.pos_embed(pos).expand_dims(axis=0)
        x = self.embed_ln(x)
        x = self.cells(x)
        return self.decoder(self.ln(x))

    def pipeline_split(self):
        """(embed, cells, head) for ``parallel.PipelineTrainer``. The wrappers
        re-register this model's own child blocks, so the parameters are
        shared and the trainer's updates land in this model."""
        cells = [self.cells[i] for i in range(len(self.cells))]
        return _MoEEmbedStage(self), cells, _MoEHeadStage(self)


class _MoEEmbedStage(HybridBlock):
    """Pipeline stage 0's entry: MoETransformerLM's embedding section."""

    def __init__(self, lm, **kwargs):
        super().__init__(**kwargs)
        self.word_embed = lm.word_embed
        self.pos_embed = lm.pos_embed
        self.embed_ln = lm.embed_ln

    def hybrid_forward(self, F, token_ids):
        pos = _position_ids(token_ids)
        x = self.word_embed(token_ids) + self.pos_embed(pos).expand_dims(axis=0)
        return self.embed_ln(x)


class _MoEHeadStage(HybridBlock):
    """Pipeline last stage's tail: the final LN and the LM decoder."""

    def __init__(self, lm, **kwargs):
        super().__init__(**kwargs)
        self.ln = lm.ln
        self.decoder = lm.decoder

    def hybrid_forward(self, F, x):
        return self.decoder(self.ln(x))


def moe_transformer_tiny(vocab_size=1024, num_experts=4, top_k=2, capacity_factor=2.0,
                         dense_ffn=False, **kw):
    """The recipe/test-sized config: 2 layers, 64 units, E experts."""
    return MoETransformerLM(vocab_size, num_layers=2, units=64, hidden_size=128, num_heads=2,
                            num_experts=num_experts, top_k=top_k,
                            capacity_factor=capacity_factor, dense_ffn=dense_ffn, **kw)
