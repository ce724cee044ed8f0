"""Reductions.

Counterpart of ``mxnet_tpu/ops/reduce.py:14-48``: ``sum`` (alias
``sum_axis``) and ``mean`` with MXNet's ``axis``/``keepdims``/``exclude``.
As in the reference, with ``MXNET_SAFE_ACCUMULATION`` on (the default),
bfloat16 and float16 inputs accumulate in float32 and the result is cast
back to the input's dtype; so does ``norm`` (:56, ``ord`` 1, 2 or p).
``prod``, ``max``, ``min``, ``arg*`` and the other reductions wait for the
slices that use them.
"""
from __future__ import annotations

import torch

from ..base import env
from .registry import register


def _norm_axis(axis, ndim, exclude=False):
    if axis is None:
        return None
    if isinstance(axis, int):
        axis = (axis,)
    axis = tuple(a % ndim for a in axis)
    if exclude:
        axis = tuple(a for a in range(ndim) if a not in axis)
    return axis


def _reduce(fn):
    def impl(x, *, axis=None, keepdims=False, exclude=False):
        ax = _norm_axis(axis, x.ndim, exclude)
        if ax == ():
            return x                       # jnp: an empty axis tuple is a no-op
        low = x.dtype in (torch.bfloat16, torch.float16)
        xx = x.float() if low and env.get("MXNET_SAFE_ACCUMULATION") else x
        out = fn(xx, dim=ax, keepdim=keepdims) if ax is not None else fn(xx)
        if ax is None and keepdims:
            out = out.reshape((1,) * x.ndim)
        if x.is_floating_point() or fn is torch.sum:
            out = out.to(x.dtype)          # int sums stay int32 (jax, x64 off)
        return out
    impl.__name__ = fn.__name__
    return impl


register("sum", aliases=("sum_axis",))(_reduce(torch.sum))


def _mean(x, dim=None, keepdim=False):
    x = x if x.is_floating_point() else x.float()   # jnp.mean of ints is f32
    return torch.mean(x) if dim is None else torch.mean(x, dim=dim, keepdim=keepdim)


_mean.__name__ = "mean"
register("mean")(_reduce(_mean))


@register("norm")
def norm(x, *, ord=2, axis=None, keepdims=False):
    ax = _norm_axis(axis, x.ndim)
    low = x.dtype in (torch.bfloat16, torch.float16) and env.get("MXNET_SAFE_ACCUMULATION")
    xx = x.float() if low else x

    def total(t):
        return torch.sum(t) if ax is None else torch.sum(t, dim=ax, keepdim=keepdims)
    if ord == 1:
        out = total(torch.abs(xx))
    elif ord == 2:
        out = torch.sqrt(total(torch.square(xx)))
    else:
        out = torch.pow(total(torch.pow(torch.abs(xx), ord)), 1.0 / ord)
    if ax is None and keepdims:
        out = out.reshape((1,) * x.ndim)
    return out.to(x.dtype) if low else out
