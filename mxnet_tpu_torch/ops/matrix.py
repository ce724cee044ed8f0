"""Shape and layout operators.

Counterpart of ``mxnet_tpu/ops/matrix.py``. Ported: ``Reshape`` with the
MXNet codes 0/-1/-2/-3/-4 (``matrix.py:23-73``; ``infer_reshape`` is a copy,
the port imports nothing of the reference package), ``transpose`` (:81),
``Flatten`` (:76), ``expand_dims`` (:88), ``slice_axis`` (:138), ``pick``
(:266), ``batch_dot`` (:409) and ``_arange`` (``mxnet_tpu/ops/extra.py:42``). Slicing
beyond ``slice_axis``, the other indexing ops, ordering and the other layout
ops wait for later slices.
"""
from __future__ import annotations

import math

import torch

from ..base import default_dtype, torch_dtype
from .registry import register


def infer_reshape(src_shape, target):
    """Implements MXNet reshape codes: 0 copy-dim, -1 infer, -2 copy-rest,
    -3 merge-two, -4 split-two (reference src/operator/tensor/matrix_op-inl.h:100)."""
    src = list(src_shape)
    tgt = list(target)
    out = []
    i = 0  # index into src
    j = 0
    while j < len(tgt):
        t = tgt[j]
        if t == 0:
            out.append(src[i]); i += 1
        elif t == -1:
            out.append(-1); i += 1
        elif t == -2:
            out.extend(src[i:]); i = len(src)
        elif t == -3:
            out.append(src[i] * src[i + 1]); i += 2
        elif t == -4:
            d1, d2 = tgt[j + 1], tgt[j + 2]
            cur = src[i]
            if d1 == -1:
                d1 = cur // d2
            if d2 == -1:
                d2 = cur // d1
            out.extend([d1, d2]); i += 1; j += 2
        else:
            out.append(t)
            if i < len(src):
                i += 1
        j += 1
    # resolve a single -1
    if -1 in out:
        known = 1
        for d in out:
            if d != -1:
                known *= d
        total = 1
        for d in src:
            total *= d
        out[out.index(-1)] = total // max(known, 1)
    return tuple(out)


@register("Reshape", aliases=("reshape",))
def reshape(x, *, shape=None, reverse=False):
    src = tuple(x.shape)
    tgt = infer_reshape(src[::-1] if reverse else src,
                        tuple(shape)[::-1] if reverse else tuple(shape))
    if reverse:
        tgt = tgt[::-1]
    return x.reshape(tgt)


@register("Flatten", aliases=("flatten",))
def flatten(x):
    """(N, ...) -> (N, prod(...)); the product is explicit, so a zero-size
    batch flattens too."""
    return x.reshape(x.shape[0], math.prod(x.shape[1:]))


@register("transpose")
def transpose(x, *, axes=None):
    if axes is None or len(axes) == 0:
        return x.permute(*reversed(range(x.ndim)))
    return x.permute(*axes)


@register("expand_dims")
def expand_dims(x, *, axis):
    return x.unsqueeze(axis)


@register("slice_axis")
def slice_axis(x, *, axis, begin, end):
    axis = axis % x.ndim
    n = x.shape[axis]
    if end is None:
        end = n
    # python-slice semantics of the reference (negative bounds count from
    # the end, out-of-range bounds clamp)
    begin, end, _ = slice(begin, end).indices(n)
    return x.narrow(axis, begin, max(end - begin, 0))


@register("pick")
def pick(x, index, *, axis=-1, keepdims=False, mode="clip"):
    """Elements of ``x`` at ``index`` along ``axis`` (reference matrix.py:266):
    ``mode="clip"`` clamps out-of-range indices, ``"wrap"`` wraps them."""
    ax = axis % x.ndim
    n = x.shape[ax]
    idx = index.to(torch.int64)
    idx = torch.remainder(idx, n) if mode == "wrap" else idx.clamp(0, n - 1)
    out = torch.gather(x, ax, idx.unsqueeze(ax))
    return out if keepdims else out.squeeze(ax)


@register("batch_dot")
def batch_dot(a, b, *, transpose_a=False, transpose_b=False):
    if transpose_a:
        a = a.transpose(-1, -2)
    if transpose_b:
        b = b.transpose(-1, -2)
    return torch.matmul(a, b)


@register("_arange", aliases=("arange",))
def _arange(*, start=0, stop=None, step=1.0, repeat=1, dtype=None,
            device="cpu"):
    if stop is None:
        start, stop = 0, start
    out = torch.arange(start, stop, step,
                       dtype=torch_dtype(dtype) if dtype else default_dtype(),
                       device=device)
    if repeat != 1:
        out = out.repeat_interleave(repeat)
    return out


@register("where")
def where(cond, x, y):
    return torch.where(cond.bool(), x, y)


@register("swapaxes", aliases=("SwapAxis",))
def swapaxes(x, *, dim1=0, dim2=0):
    return torch.swapaxes(x, dim1, dim2)
