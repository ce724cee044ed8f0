"""Shape and layout operators.

Counterpart of ``mxnet_tpu/ops/matrix.py``. Ported: ``Reshape`` with the
MXNet codes 0/-1/-2/-3/-4 (``matrix.py:23-73``; ``infer_reshape`` is a copy,
the port imports nothing of the reference package), ``transpose`` (:81),
``Flatten`` (:76), ``expand_dims`` (:88), ``squeeze``, ``broadcast_to``
(a 0 keeps the dim), ``broadcast_like`` (:93-110), ``slice`` (:128, with
Python's slice semantics, negative steps too) and ``slice_axis`` (:138),
``reverse`` (alias ``flip``), ``tile``, ``repeat`` (:180-197), ``Concat``,
``stack`` and ``SliceChannel`` (alias ``split``, :209-225), ``take``
(:260, ``mode`` "clip" or "wrap"), ``pick`` (:266), ``one_hot`` (:282, an
index out of range gives a row of ``off_value``), ``sort``, ``argsort``
(stable) and ``topk`` (:360-392), ``dot`` (:397: the last axis of a against
the first of b; ``transpose_*`` reverse all axes), ``batch_dot`` (:409) and
``_arange`` (``mxnet_tpu/ops/extra.py:42``). The other indexing ops
(``gather_nd``, ``scatter_nd``, the sequence ops) and layout ops wait for
ROADMAP A9.
"""
from __future__ import annotations

import math

import torch

from ..base import MXNetError, default_dtype, torch_dtype
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


@register("squeeze")
def squeeze(x, *, axis=None):
    if axis is None:
        return x.squeeze()
    return x.squeeze(tuple(axis) if isinstance(axis, (tuple, list)) else axis)


@register("broadcast_to")
def broadcast_to(x, *, shape):
    return x.expand(tuple(s if s != 0 else x.shape[i] for i, s in enumerate(shape)))


@register("broadcast_like")
def broadcast_like(x, y, *, lhs_axes=None, rhs_axes=None):
    if lhs_axes is None:
        return x.expand(y.shape)
    tgt = list(x.shape)
    for la, ra in zip(lhs_axes, rhs_axes):
        tgt[la] = y.shape[ra]
    return x.expand(tuple(tgt))


def slice_dim(x, dim, s: slice):
    """``x`` sliced on ``dim`` by ``s`` with Python's semantics; a negative
    step flips the dim first (torch takes positive steps only)."""
    n = x.shape[dim]
    start, stop, step = s.indices(n)
    if step > 0:
        return x.narrow(dim, start, 0) if stop <= start else \
            x[(slice(None),) * dim + (slice(start, stop, step),)]
    count = len(range(start, stop, step))
    first = n - 1 - start
    return x.flip(dim)[(slice(None),) * dim + (slice(first, first + count * -step, -step),)]


@register("slice")
def slice_op(x, *, begin, end, step=None):
    step = tuple(step or ())
    for d, (b, e) in enumerate(zip(begin, end)):
        st = step[d] if d < len(step) and step[d] not in (None, 0) else None
        x = slice_dim(x, d, slice(b, e, st))
    return x


@register("reverse", aliases=("flip",))
def reverse(x, *, axis):
    return torch.flip(x, (axis,) if isinstance(axis, int) else tuple(axis))


@register("tile")
def tile(x, *, reps):
    return torch.tile(x, tuple(reps))


@register("repeat")
def repeat(x, *, repeats, axis=None):
    return torch.repeat_interleave(x, repeats, dim=axis)


@register("Concat", aliases=("concat",))
def concat(*args, dim=1):
    return torch.cat(args, dim=dim)


@register("stack")
def stack(*args, axis=0):
    return torch.stack(args, dim=axis)


@register("SliceChannel", aliases=("split",))
def split(x, *, num_outputs, axis=1, squeeze_axis=False):
    if x.shape[axis] % num_outputs:
        raise MXNetError(f"split: axis {axis} of size {x.shape[axis]} does not "
                         f"divide into {num_outputs} parts")
    parts = torch.chunk(x, num_outputs, dim=axis)
    if squeeze_axis:
        parts = [p.squeeze(axis) for p in parts]
    return tuple(parts)


@register("take")
def take(a, indices, *, axis=0, mode="clip"):
    axis = axis % a.ndim
    n = a.shape[axis]
    idx = indices.to(torch.int64)
    idx = torch.remainder(idx, n) if mode == "wrap" else idx.clamp(0, n - 1)
    out = torch.index_select(a, axis, idx.reshape(-1))
    return out.reshape(a.shape[:axis] + tuple(idx.shape) + a.shape[axis + 1:])


@register("one_hot", differentiable=False)
def one_hot(indices, *, depth, on_value=1.0, off_value=0.0, dtype="float32"):
    hot = indices.to(torch.int64).unsqueeze(-1) == torch.arange(depth, device=indices.device)
    # a Python float times an int array is float32, as jax's weak types make it
    return hot.to(torch_dtype(dtype)) * (on_value - off_value) + off_value


@register("sort", differentiable=False)
def sort(x, *, axis=-1, is_ascend=True):
    out = torch.sort(x, dim=axis, stable=True).values
    return out if is_ascend else torch.flip(out, (axis,))


@register("argsort", differentiable=False)
def argsort(x, *, axis=-1, is_ascend=True, dtype="float32"):
    out = torch.argsort(x, dim=axis, stable=True)
    if not is_ascend:
        out = torch.flip(out, (axis,))
    return out.to(torch_dtype(dtype))


@register("topk", differentiable=False)
def topk(x, *, axis=-1, k=1, ret_typ="indices", is_ascend=False, dtype="float32"):
    if ret_typ not in ("indices", "value", "both"):
        raise MXNetError(f"topk ret_typ {ret_typ!r} is not supported")
    vals, idx = torch.topk(x, k, dim=axis, largest=not is_ascend, sorted=True)
    idx = idx.to(torch_dtype(dtype))
    if ret_typ == "indices":
        return idx
    if ret_typ == "value":
        return vals
    return vals, idx


@register("dot")
def dot(a, b, *, transpose_a=False, transpose_b=False):
    if transpose_a:
        a = a.permute(*reversed(range(a.ndim)))
    if transpose_b:
        b = b.permute(*reversed(range(b.ndim)))
    if a.ndim == 1 and b.ndim == 1:
        return torch.dot(a, b)
    return torch.tensordot(a, b, dims=([a.ndim - 1], [0]))
