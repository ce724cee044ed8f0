"""Neural-network operators.

Counterpart of ``mxnet_tpu/ops/nn.py``. Ported: ``FullyConnected`` (:39),
``Convolution`` (:83, 1-D/2-D/3-D, grouped), ``Pooling`` (:146),
``BatchNorm`` (:250), ``LayerNorm`` (:277), ``Activation`` (:340),
``softmax`` (:359), ``log_softmax`` (:380), ``Dropout`` (:470),
``Embedding`` (:490) and ``CTCLoss`` (:638, by ``F.ctc_loss``: the
reference computes it outside any Pallas kernel). ``Deconvolution``,
``UpSampling``, the other norms and RNN wait for the slices whose models
use them.

Convolution, pooling and BatchNorm are the library's (cuDNN on the card),
as the reference leaves them to XLA. Where the two disagree the reference's
semantics win:

- ``Pooling`` with ``pooling_convention="full"`` pads the high side so that
  ``ceil((in + 2 pad - k) / stride) + 1`` windows fit, and keeps a last
  window that lies wholly in that padding (max gives -inf there, avg 0 or
  0/0). torch's ``ceil_mode`` drops such a window (k=3, s=3, p=1 on 5
  gives 3 windows here, 2 in torch), so "full" pads explicitly and pools
  with no padding of torch's own.
- ``BatchNorm`` returns ``(out, batch mean, biased batch variance)``, all
  from f32, and updates nothing: the Gluon layer blends the running stats
  (torch's own update would blend the unbiased variance).

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


_CONV = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}
_MAX_POOL = {1: F.max_pool1d, 2: F.max_pool2d, 3: F.max_pool3d}
_AVG_POOL = {1: F.avg_pool1d, 2: F.avg_pool2d, 3: F.avg_pool3d}


def _match_conv_dtypes(data, weight):
    """(data', weight', restore dtype or None) as the reference's
    (nn.py:64-72): float16 computes in f32 and rounds back; mixed dtypes
    promote to the wider one and the output keeps data's."""
    if torch.float16 in (data.dtype, weight.dtype):
        return data.float(), weight.float(), data.dtype
    if data.dtype != weight.dtype:
        wide = torch.promote_types(data.dtype, weight.dtype)
        return data.to(wide), weight.to(wide), data.dtype
    return data, weight, None


@register("Convolution")
def convolution(data, weight, bias=None, *, kernel, num_filter, stride=None,
                dilate=None, pad=None, num_group=1, no_bias=False, layout=None):
    """NC+spatial data, OI+spatial weight (reference nn.py:83-104)."""
    nd = len(kernel)
    if nd not in _CONV:
        raise MXNetError(f"Convolution: {nd}-D kernel {kernel}")
    data, weight, lo_dt = _match_conv_dtypes(data, weight)
    if no_bias:
        bias = None
    fuse = bias is not None and lo_dt is None and bias.dtype == data.dtype
    out = _CONV[nd](data, weight, bias if fuse else None,
                    stride=tuple(stride) if stride else 1,
                    padding=tuple(pad) if pad else 0,
                    dilation=tuple(dilate) if dilate else 1, groups=num_group)
    if lo_dt is not None:
        out = out.to(lo_dt)
    if bias is not None and not fuse:
        out = out + bias.reshape((1, -1) + (1,) * nd)
    return out


def _pad_spatial(x, lo, hi, value):
    """``x`` padded by ``lo``/``hi`` on each spatial dim with ``value``."""
    widths = []
    for a, b in zip(reversed(lo), reversed(hi)):   # F.pad: last dim first
        widths += [a, b]
    return F.pad(x, widths, value=value)


@register("Pooling")
def pooling(data, *, kernel=(), pool_type="max", global_pool=False, stride=None,
            pad=None, pooling_convention="valid", count_include_pad=True,
            p_value=2, layout=None):
    """max, avg and sum pooling over NC+spatial data (reference
    nn.py:146-203); see the module docstring on ``"full"``."""
    nd = data.ndim - 2
    if pool_type not in ("max", "avg", "sum"):
        raise MXNetError(f"Pooling pool_type {pool_type!r} (ported: max, avg, sum)")
    if global_pool:
        dims = tuple(range(2, data.ndim))
        if pool_type == "max":
            return data.amax(dim=dims, keepdim=True)
        red = torch.sum if pool_type == "sum" else torch.mean
        return red(data, dim=dims, keepdim=True)
    if nd not in _MAX_POOL:
        raise MXNetError(f"Pooling: {nd}-D data {tuple(data.shape)}")
    kernel = tuple(kernel)
    stride = tuple(stride) if stride else (1,) * nd
    pad = tuple(pad) if pad else (0,) * nd
    hi = pad
    if pooling_convention == "full":
        hi = []
        for i in range(nd):
            span = data.shape[2 + i] + 2 * pad[i] - kernel[i]
            out = -(-span // stride[i]) + 1
            hi.append(max((out - 1) * stride[i] + kernel[i] - data.shape[2 + i]
                          - pad[i], pad[i]))
        hi = tuple(hi)
    # torch pads by itself only symmetrically and by at most half a window
    native = hi == pad and all(2 * p <= k for p, k in zip(pad, kernel))
    if pool_type == "max":
        if native:
            return _MAX_POOL[nd](data, kernel, stride, pad)
        return _MAX_POOL[nd](_pad_spatial(data, pad, hi, float("-inf")),
                             kernel, stride)
    if pool_type == "avg" and native:
        return _AVG_POOL[nd](data, kernel, stride, pad,
                             count_include_pad=count_include_pad)
    # every position of the explicitly padded input counts as data
    avg = _AVG_POOL[nd](_pad_spatial(data, pad, hi, 0.0), kernel, stride)
    if pool_type == "sum":
        return avg * math.prod(kernel)
    if count_include_pad:
        return avg
    ones = torch.ones((1, 1) + tuple(data.shape[2:]), dtype=data.dtype,
                      device=data.device)
    share = _AVG_POOL[nd](_pad_spatial(ones, pad, hi, 0.0), kernel, stride)
    return avg / share


@register("BatchNorm")
def batch_norm(data, gamma, beta, moving_mean, moving_var, *, eps=1e-3,
               momentum=0.9, fix_gamma=True, use_global_stats=False,
               output_mean_var=False, axis=1, cudnn_off=False, training=True):
    """``(out, mean, var)``: in training the batch's mean and biased
    variance, else the moving ones; computed in f32, ``out`` cast to the
    data's dtype; ``fix_gamma`` means gamma is 1 (reference nn.py:250-274)."""
    ax = axis % data.ndim
    x32 = data.float().movedim(ax, 1)
    g = torch.ones_like(gamma, dtype=torch.float32) if fix_gamma else gamma.float()
    if training and not use_global_stats:
        red = [i for i in range(x32.ndim) if i != 1]
        var, mean = torch.var_mean(x32, dim=red, correction=0)
        # torch.batch_norm (not F.batch_norm, which refuses one value per
        # channel in training) with no running stats: normalised by the
        # batch's biased variance, and the running stats left alone
        out = torch.batch_norm(x32, g, beta.float(), None, None, True, 0.0, eps,
                               torch.backends.cudnn.enabled)
    else:
        mean, var = moving_mean.float(), moving_var.float()
        if mean.requires_grad or var.requires_grad:
            # torch.batch_norm has no gradient in the moving stats
            bshape = (-1,) + (1,) * (x32.ndim - 2)
            scale = g * torch.rsqrt(var + eps)
            out = torch.addcmul((beta.float() - mean * scale).reshape(bshape), x32,
                                scale.reshape(bshape))
        else:     # the Gluon layer's case (running stats): one library kernel
            out = torch.batch_norm(x32, g, beta.float(), mean, var, False, 0.0, eps,
                                   torch.backends.cudnn.enabled)
    return out.movedim(1, ax).to(data.dtype), mean, var


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


@register("CTCLoss", aliases=("ctc_loss",))
def ctc_loss(data, label, data_lengths=None, label_lengths=None, *,
             use_data_lengths=False, use_label_lengths=False, blank_label="first"):
    """The negative log-likelihood of each sequence's label under CTC:
    ``data`` (T, B, C) activations (softmax taken here), ``label`` (B, L)
    padded with -1 (``blank_label="last"``: blank is C - 1) or 0 ("first":
    blank is 0). Without ``label_lengths`` a label's length is its count of
    entries other than the padding, as the reference infers it."""
    T, B, C = data.shape
    blank = 0 if blank_label == "first" else C - 1
    lab = label.long()
    if use_label_lengths and label_lengths is not None:
        lab_len = label_lengths.long()
    else:
        lab_len = (lab != (0 if blank == 0 else -1)).sum(dim=1)
    if use_data_lengths and data_lengths is not None:
        seq_len = data_lengths.long()
    else:
        seq_len = torch.full((B,), T, dtype=torch.long, device=data.device)
    logp = F.log_softmax(data.float(), dim=-1)
    return F.ctc_loss(logp, lab.clamp_min(0), seq_len, lab_len, blank=blank,
                      reduction="none", zero_infinity=False)
