"""Long-context training recipe: a causal LM whose attention scales past 32k tokens.

Counterpart of ``mxnet_tpu/recipes/long_context.py``:

- ``LongContextLM`` (:149), pre-LN cells of ``RingSelfAttention`` (:89) and
  ``models.bert.PositionwiseFFN`` (``_LCCell`` :132). Attention has three
  paths over one parameter set: under ``sequence_axis`` (the trainer's
  forward) ``ops.attention.ring_attention`` over that mesh axis, each rank
  holding T/sp tokens whose positions start at ``sp_rank * T/sp``; by
  default ``flash_attention_op(q, k, v, causal=True)``, the flash kernels on
  the card (K1-K3, O(T) memory, which is what lets T = 32768 train); with
  ``dense_attention=True`` the O(T^2) softmax, the parity oracle.
- ``LongContextTrainer`` (:269): ``DataParallelTrainer`` over a ``{dp, sp}``
  mesh with ``data_spec=P(dp, sp)`` and ``zero_update=True``: each rank's
  loss is its mean over its (B/dp, T/sp) shard, weighted by its share; the
  bucket gradients are summed over sp and reduce-scattered over dp (so they
  are the mean over both axes, the reference's sum divided by dp*sp), the
  shard updated by one K5 launch and all-gathered (``parallel/zero.py``).
  ``_ring_step_bytes`` and ``_ring_cells`` (:409-431) estimate the ring's
  wire bytes as the reference does. On the card the step is captured as a
  CUDA graph where ``DataParallelTrainer`` captures it (NCCL groups). At
  sp = 1 the ring sends nothing and at dp = 1 ZeRO's reduce-scatter and
  all-gather are not issued; the buckets' sum over sp and the loss's
  all-reduce are NCCL calls inside the graph.
  ``_dist_util.p2p_stats`` counts replayed sends like the kernels' launches
  (``engine``).
- ``TokenWindows`` (:231), ``default_seq_len`` / ``MXNET_TPU_LONG_CONTEXT_SEQ``
  (:48-52), ``make_model``, ``make_oracle``, ``make_trainer``, and
  ``token_cross_entropy`` (the reference's ``recipes/moe.py:54``).

``LongContextLM.pipeline_split`` (:185-228) gives ``parallel.PipelineTrainer``
the embedding section (``_LCEmbedStage``, with the sequence axis's position
offset), the cells and the final LN + decoder (``_LCHeadStage``) on the
model's own child blocks; under ``tp_mode="partitioned"`` the cells run
``parallel.megatron``'s causal branch.

``make_feed(source, trainer)`` (:261-263) wraps ``TokenWindows`` (or any
source of (x, y) batches) in ``engine.async_feed.DeviceFeed.for_trainer``:
the batches are staged and copied on a side stream ahead of the step, each
rank's part of ``P(dp, sp)`` cut on the host. With telemetry on,
``_record_telemetry`` adds the ring's ``ppermute`` bytes (the reference's
estimate, :402-407) to the fused step's.

The kernels take head dims up to 256 (16, 32, 64, 128 and 256 instantiated,
others zero-padded by their wrappers): ``dryrun_multichip``'s shape, units
32 over 2 heads, runs at D = 16 on the card.
"""
from __future__ import annotations

import contextlib
import math
from typing import List

import numpy as _np
import torch

from ..base import MXNetError, env
from .. import telemetry as _telem
from ..engine import async_feed as _feed
from ..ndarray import NDArray
from ..gluon.block import HybridBlock
from ..gluon import nn
from ..parallel.data_parallel import DataParallelTrainer
from ..parallel.mesh import P, activate, active_mesh, current_mesh, require_axis

__all__ = ["LongContextLM", "LongContextTrainer", "TokenWindows", "RingSelfAttention",
           "sequence_axis", "current_sequence_axis", "default_seq_len",
           "token_cross_entropy", "make_model", "make_oracle", "make_trainer",
           "make_feed"]

env.declare("MXNET_TPU_LONG_CONTEXT_SEQ", 32768, int,
            "Default sequence length of the long-context recipe")


def default_seq_len() -> int:
    return int(env.get("MXNET_TPU_LONG_CONTEXT_SEQ"))


# -- which mesh axis shards the sequence -------------------------------------------

class _SeqCtx:
    __slots__ = ("axis_name",)

    def __init__(self, axis_name):
        self.axis_name = axis_name


_SEQ_STACK: List[_SeqCtx] = []


@contextlib.contextmanager
def sequence_axis(axis_name: str):
    """Inside it, ``LongContextLM``'s attention runs ``ring_attention`` over
    ``axis_name`` of the active mesh (``parallel.activate``), on (B, T/sp)
    local tokens."""
    _SEQ_STACK.append(_SeqCtx(axis_name))
    try:
        yield
    finally:
        _SEQ_STACK.pop()


def current_sequence_axis():
    return _SEQ_STACK[-1] if _SEQ_STACK else None


def _sequence_mesh(ctx):
    mesh = active_mesh()
    if mesh is None:
        raise MXNetError(f"sequence_axis({ctx.axis_name!r}) needs an active mesh "
                         f"(parallel.activate)")
    return mesh


# -- model --------------------------------------------------------------------------------

class RingSelfAttention(HybridBlock):
    """Causal self-attention with three paths over one parameter set: ring
    (under ``sequence_axis``), flash (default), dense softmax
    (``dense_attention=True``)."""

    def __init__(self, units, num_heads, dense_attention=False, **kwargs):
        super().__init__(**kwargs)
        assert units % num_heads == 0
        self._units = units
        self._heads = num_heads
        self._dense = dense_attention
        self.qkv = nn.Dense(3 * units, flatten=False, in_units=units)
        self.proj = nn.Dense(units, flatten=False, in_units=units)

    def hybrid_forward(self, F, x):
        from ..ops.attention import flash_attention_op, ring_attention
        H = self._heads
        d = self._units // H
        qkv = self.qkv(x)._data                          # (B, T, 3C)
        B, T, _ = qkv.shape
        q, k, v = (a.reshape(B, T, H, d).permute(0, 2, 1, 3)
                   for a in qkv.split(self._units, dim=-1))
        ctx = current_sequence_axis()
        if ctx is not None:
            out = ring_attention(q, k, v, ctx.axis_name, causal=True,
                                 mesh=_sequence_mesh(ctx))
        elif self._dense:
            s = torch.matmul(q.float(), k.float().transpose(-1, -2)) / math.sqrt(d)
            mask = torch.ones(T, T, dtype=torch.bool, device=s.device).tril()
            s = torch.where(mask, s, -1e30)
            out = torch.matmul(torch.softmax(s, dim=-1), v.float()).to(q.dtype)
        else:
            out = flash_attention_op(q, k, v, causal=True)
        out = out.permute(0, 2, 1, 3).reshape(B, T, H * d)
        return self.proj(NDArray(out, x.ctx))


class _LCCell(HybridBlock):
    def __init__(self, units, hidden_size, num_heads, dense_attention=False, **kwargs):
        super().__init__(**kwargs)
        from ..models.bert import PositionwiseFFN
        self.ln1 = nn.LayerNorm(in_channels=units)
        self.attn = RingSelfAttention(units, num_heads, dense_attention=dense_attention)
        self.ln2 = nn.LayerNorm(in_channels=units)
        self.ffn = PositionwiseFFN(units, hidden_size)

    def hybrid_forward(self, F, x):
        x = x + self.attn(self.ln1(x))
        x = x + self.ffn(self.ln2(x))
        return x


class LongContextLM(HybridBlock):
    """Pre-LN causal LM over ring/flash attention. Under ``sequence_axis``
    each rank holds a T/sp token slice whose positions are offset by
    ``sp_rank * T/sp``, so every shard sees its global positions."""

    def __init__(self, vocab_size, num_layers=2, units=64, hidden_size=128, num_heads=2,
                 max_length=None, dense_attention=False, **kwargs):
        super().__init__(**kwargs)
        self._units = units
        self._max_length = int(max_length if max_length is not None else default_seq_len())
        self.word_embed = nn.Embedding(vocab_size, units)
        self.pos_embed = nn.Embedding(self._max_length, units)
        self.embed_ln = nn.LayerNorm(in_channels=units)
        self.cells = nn.HybridSequential()
        for _ in range(num_layers):
            self.cells.add(_LCCell(units, hidden_size, num_heads,
                                   dense_attention=dense_attention))
        self.ln = nn.LayerNorm(in_channels=units)
        self.decoder = nn.Dense(vocab_size, flatten=False, in_units=units)

    def hybrid_forward(self, F, token_ids):
        x = _embed(self, token_ids)
        x = self.cells(x)
        return self.decoder(self.ln(x))

    def pipeline_split(self):
        """(embed, cells, head) for ``parallel.PipelineTrainer``. The wrappers
        re-register this model's own child blocks, so the parameters are
        shared and ``sync()`` writes back into this model."""
        cells = [self.cells[i] for i in range(len(self.cells))]
        return _LCEmbedStage(self), cells, _LCHeadStage(self)


def _embed(block, token_ids):
    """Token and position embeddings and LN of ``block``'s word_embed,
    pos_embed and embed_ln; under ``sequence_axis`` the positions start at
    ``sp_rank * T/sp``."""
    from .. import ndarray as nd
    Tl = token_ids.shape[1]
    start = 0
    ctx = current_sequence_axis()
    if ctx is not None:
        start = _sequence_mesh(ctx).axis_index(ctx.axis_name) * Tl
    pos = nd.arange(start, start + Tl, dtype="int32", ctx=token_ids.ctx)
    x = block.word_embed(token_ids) + block.pos_embed(pos).expand_dims(axis=0)
    return block.embed_ln(x)


class _LCEmbedStage(HybridBlock):
    """Pipeline stage 0's entry: LongContextLM's embedding section (keeps
    the sequence axis's position offset, so a ring run still sees global
    positions)."""

    def __init__(self, lm, **kwargs):
        super().__init__(**kwargs)
        self.word_embed = lm.word_embed
        self.pos_embed = lm.pos_embed
        self.embed_ln = lm.embed_ln

    def hybrid_forward(self, F, token_ids):
        return _embed(self, token_ids)


class _LCHeadStage(HybridBlock):
    """Pipeline last stage's tail: the final LN and the LM decoder."""

    def __init__(self, lm, **kwargs):
        super().__init__(**kwargs)
        self.ln = lm.ln
        self.decoder = lm.decoder

    def hybrid_forward(self, F, x):
        return self.decoder(self.ln(x))


# -- sequence chunking ----------------------------------------------------------------------

class TokenWindows:
    """Re-iterable (x, y) next-token windows of shape (batch_size, seq_len)
    over a flat token stream; y is x shifted by one."""

    def __init__(self, tokens, batch_size, seq_len):
        self._tokens = _np.asarray(tokens, dtype=_np.int32)
        self.batch_size = int(batch_size)
        self.seq_len = int(seq_len)
        span = self.batch_size * self.seq_len
        self.n_batches = max((len(self._tokens) - 1) // span, 0)
        if not self.n_batches:
            raise MXNetError(f"token stream too short: {len(self._tokens)} tokens < one "
                             f"({batch_size} x {seq_len}) window")

    def __len__(self):
        return self.n_batches

    def __iter__(self):
        span = self.batch_size * self.seq_len
        for b in range(self.n_batches):
            lo = b * span
            x = self._tokens[lo:lo + span]
            y = self._tokens[lo + 1:lo + span + 1]
            yield (x.reshape(self.batch_size, self.seq_len),
                   y.reshape(self.batch_size, self.seq_len))


def make_feed(source, trainer, depth=None):
    """Batches land on the trainer's device as this rank's part of its
    ``P(dp, sp)`` input spec, copied ahead of the step."""
    return _feed.DeviceFeed.for_trainer(source, trainer, depth=depth, name="long_context")


def token_cross_entropy(logits, labels):
    """Mean token-level cross entropy in f32 (tensors)."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    return torch.mean(logz - gold)


# -- the dp x sp trainer ---------------------------------------------------------------------

class LongContextTrainer(DataParallelTrainer):
    """The fused step over a ``{dp, sp}`` mesh: batch over dp, sequence over
    sp (``data_spec=P(dp, sp)``), ring attention in the cells, replicated
    parameters with the ZeRO-sharded update over dp; see the module
    docstring."""

    def __init__(self, net, loss, optimizer="adam", optimizer_params=None, mesh=None,
                 dp_axis="dp", sp_axis="sp", comm_dtype=None, bucket_bytes=None):
        mesh = mesh if mesh is not None else current_mesh()
        require_axis(mesh, dp_axis, "LongContextTrainer data parallelism")
        self._sp_axis = sp_axis
        self._sp_degree = require_axis(mesh, sp_axis, "LongContextTrainer sequence "
                                                      "parallelism")
        super().__init__(net, loss, optimizer=optimizer, optimizer_params=optimizer_params,
                         mesh=mesh, batch_axis_name=dp_axis, dtype="float32",
                         data_spec=P(dp_axis, sp_axis), zero_update=True,
                         bucket_bytes=bucket_bytes, comm_dtype=comm_dtype,
                         overlap_grads=False)

    def _validate_zero(self):
        """The parent's check with the data spec relaxed to P(dp, sp)
        (reference :298): replicated parameters."""
        from ..parallel.tensor_parallel import spec_axes
        bad = [p.name for p in self._plist if spec_axes(p.sharding)]
        if bad:
            raise MXNetError(f"LongContextTrainer requires replicated parameters; "
                             f"offending {bad[:3]}")

    def _forward_scope(self):
        stack = contextlib.ExitStack()
        stack.enter_context(activate(self.mesh, self._sp_axis))
        stack.enter_context(sequence_axis(self._sp_axis))
        return stack

    def _record_telemetry(self, sig, examples, steps):
        if self._sp_degree > 1:
            ndp = self.mesh.axis_size(self.batch_axis)
            nbytes, calls = self._ring_step_bytes(
                (sig[0][0] * ndp, sig[0][1] * self._sp_degree))
            _telem.record_comm("ppermute", nbytes * steps, store="mesh",
                               calls=calls * steps, axis="sp")
        super()._record_telemetry(sig, examples, steps)

    def _ring_step_bytes(self, x_shape):
        """The reference's estimate of a step's ppermute wire bytes a rank:
        each ring step rotates the local k and v shards (sp-1 hops an
        attention call), once forward and twice in the backward. (The port's
        backward sends one more hop, the dK/dV accumulators home.)"""
        B, T = x_shape[0], x_shape[1]
        n_attn = sum(1 for _ in self._ring_cells())
        nsp = self._sp_degree
        per_dev_tokens = (B // self.mesh.axis_size(self.batch_axis)) * (T // nsp)
        shard = 2 * per_dev_tokens * getattr(self.net, "_units", 0) * 4   # k + v, f32
        return 3 * n_attn * shard * (nsp - 1), 3 * n_attn * (nsp - 1)

    def _ring_cells(self):
        def walk(b):
            if isinstance(b, RingSelfAttention):
                yield b
            for c in b._children.values():
                yield from walk(c)
        return walk(self.net)


# -- the recipe triple -----------------------------------------------------------------------

def make_model(vocab_size=512, seq_len=None, dense_attention=False, ctx=None, **kw):
    from .. import context as _ctx
    net = LongContextLM(vocab_size, max_length=seq_len, dense_attention=dense_attention,
                        **kw)
    net.initialize(ctx=ctx or _ctx.current_context())
    return net


def make_oracle(vocab_size=512, seq_len=None, ctx=None, **kw):
    """Dense O(T^2) attention: the parity reference at moderate T."""
    return make_model(vocab_size, seq_len=seq_len, dense_attention=True, ctx=ctx, **kw)


def make_trainer(net, mesh, dp_axis="dp", sp_axis="sp", learning_rate=1e-3, **kw):
    return LongContextTrainer(net, token_cross_entropy, optimizer="adam",
                              optimizer_params={"learning_rate": learning_rate},
                              mesh=mesh, dp_axis=dp_axis, sp_axis=sp_axis, **kw)


from . import Recipe, register  # noqa: E402

register(Recipe("long_context", make_model, make_trainer, make_oracle))
