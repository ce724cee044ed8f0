"""Neural-network operators.

Counterpart of ``mxnet_tpu/ops/nn.py``. Ported: ``FullyConnected`` (:39),
``LayerNorm`` (:277), ``Activation`` (:340), ``softmax`` (:359),
``log_softmax`` (:380), ``Dropout`` (:470) and ``Embedding`` (:490). Convolution, pooling, the other norms, RNN
and CTC wait for the slices whose models use them.

``Embedding`` and out-of-range ids: the reference's ``jnp.take`` never
faults (it fills or clamps). A CUDA gather with an id outside
``[0, input_dim)`` stops the CUDA context with a device-side assert, and on
the CPU ``F.embedding`` raises ``IndexError``. Checking the ids on the card
would cost a device-to-host sync per call, so the port does not check:
callers pass ids in range, as ``chip_smoke.py`` and the tests do.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..base import MXNetError, torch_dtype
from .registry import register
from .. import random as _rng


@register("FullyConnected")
def fully_connected(data, weight, bias=None, *, num_hidden=None, no_bias=False,
                    flatten=True):
    """reference src/operator/nn/fully_connected.cc — weight is (num_hidden, in)."""
    # explicit product, not -1: a zero-size batch cannot infer the flat dim
    x = data.reshape(data.shape[0], math.prod(data.shape[1:])) \
        if flatten and data.ndim > 1 else data
    return F.linear(x, weight, None if no_bias else bias)


@register("LayerNorm")
def layer_norm(data, gamma, beta, *, axis=-1, eps=1e-5):
    """Normalised in f32 over ``axis`` and cast back (reference nn.py:277-288)."""
    ax = axis % data.ndim
    x32 = data.float().movedim(ax, -1)
    out = F.layer_norm(x32, (x32.shape[-1],), gamma.float(), beta.float(), eps)
    return out.movedim(-1, ax).to(data.dtype)


@register("Activation")
def activation(data, *, act_type):
    if act_type == "relu":
        return torch.relu(data)
    if act_type == "sigmoid":
        return torch.sigmoid(data)
    if act_type == "tanh":
        return torch.tanh(data)
    if act_type == "softrelu":
        return F.softplus(data)
    if act_type == "softsign":
        return F.softsign(data)
    if act_type == "gelu":
        return F.gelu(data, approximate="none")
    if act_type == "silu":
        return F.silu(data)
    raise MXNetError(f"Activation act_type {act_type}")


@register("softmax")
def softmax(data, length=None, *, axis=-1, temperature=None, use_length=False,
            dtype=None):
    """Softmax in f32, cast to ``dtype`` or the input's (reference nn.py:359)."""
    x = data.float()
    if temperature is not None and temperature != 1.0:
        x = x / temperature
    if use_length and length is not None:
        ax = axis % data.ndim
        shape = [1] * data.ndim
        shape[ax] = data.shape[ax]
        steps = torch.arange(data.shape[ax], device=data.device).reshape(shape)
        mask = steps < length.reshape(
            tuple(length.shape) + (1,) * (data.ndim - length.ndim)).to(torch.int32)
        out = torch.softmax(x.masked_fill(~mask, float("-inf")), dim=axis)
        out = out.masked_fill(~mask, 0.0)
    else:
        out = torch.softmax(x, dim=axis)
    return out.to(torch_dtype(dtype) if dtype else data.dtype)


@register("log_softmax")
def log_softmax(data, *, axis=-1, temperature=None, dtype=None):
    """Log-softmax in f32, cast to ``dtype`` or the input's (reference nn.py:380)."""
    x = data.float()
    if temperature is not None and temperature != 1.0:
        x = x / temperature
    out = torch.log_softmax(x, dim=axis)
    return out.to(torch_dtype(dtype) if dtype else data.dtype)


@register("Dropout")
def dropout(data, *, p=0.5, mode="training", axes=(), training=True,
            cudnn_off=False):
    """Identity outside training or at p=0. In training the keep-mask is
    drawn from the device's generator (``random.generator``); its bits differ
    from the reference's threefry mask, only its distribution matches."""
    if not training or p <= 0.0:
        return data
    shape = tuple(1 if i in axes else s for i, s in enumerate(data.shape))
    keep = 1.0 - p
    mask = torch.rand(shape, generator=_rng.generator(data.device),
                      device=data.device) < keep
    return torch.where(mask, data / keep, torch.zeros((), dtype=data.dtype,
                                                      device=data.device))


@register("Embedding")
def embedding(data, weight, *, input_dim=None, output_dim=None, dtype=None,
              sparse_grad=False):
    """Row gather (reference src/operator/tensor/indexing_op.cc Embedding).
    Ids must lie in ``[0, input_dim)``; see the module docstring."""
    if data.dtype not in (torch.int32, torch.int64):
        data = data.to(torch.int64)
    return F.embedding(data, weight)
