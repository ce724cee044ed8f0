"""Reductions.

Counterpart of ``mxnet_tpu/ops/reduce.py``: ``sum`` (alias ``sum_axis``),
``mean``, ``prod``, ``max`` (``max_axis``), ``min`` (``min_axis``),
``nansum`` and ``nanprod`` with MXNet's ``axis``/``keepdims``/``exclude``
(:14-53), ``norm`` (:56, ``ord`` 1, 2 or p), ``argmax``/``argmin`` (float32
indices by default, ``dtype`` for others) and ``argmax_channel``,
``logsumexp``, ``moments`` (mean and population variance) and
``_square_sum`` (:67-115). As in the reference, with
``MXNET_SAFE_ACCUMULATION`` on (the default), bfloat16 and float16 inputs
of ``sum``, ``mean``, ``prod``, ``norm`` and ``_square_sum`` accumulate in
float32 and the result is cast back to the input's dtype. Integer results
stay int32, as jax's with 64-bit types off.
"""
from __future__ import annotations

import torch

from ..base import env, torch_dtype
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


def _reduce(fn, acc=True):
    def impl(x, *, axis=None, keepdims=False, exclude=False):
        ax = _norm_axis(axis, x.ndim, exclude)
        if ax == ():
            return x                       # jnp: an empty axis tuple is a no-op
        low = acc and x.dtype in (torch.bfloat16, torch.float16)
        xx = x.float() if low and env.get("MXNET_SAFE_ACCUMULATION") else x
        out = fn(xx, dim=ax, keepdim=keepdims) if ax is not None else fn(xx)
        if ax is None and keepdims:
            out = out.reshape((1,) * x.ndim)
        if out.is_floating_point() == x.is_floating_point():
            out = out.to(x.dtype)          # int results stay int32 (jax, x64 off)
        return out
    impl.__name__ = fn.__name__
    return impl


register("sum", aliases=("sum_axis",))(_reduce(torch.sum))


def _mean(x, dim=None, keepdim=False):
    x = x if x.is_floating_point() else x.float()   # jnp.mean of ints is f32
    return torch.mean(x) if dim is None else torch.mean(x, dim=dim, keepdim=keepdim)


_mean.__name__ = "mean"
register("mean")(_reduce(_mean))


def _over_dims(fn):
    """``fn`` of one dim applied over a tuple of dims, last first."""
    def many(x, dim=None, keepdim=False):
        if dim is None:
            return fn(x.reshape(-1), dim=0)
        for d in sorted(dim, reverse=True):
            x = fn(x, dim=d, keepdim=keepdim)
        return x
    return many


def _nanprod(x, dim=None, keepdim=False):
    return _over_dims(torch.prod)(torch.where(torch.isnan(x), torch.ones_like(x), x),
                                  dim, keepdim)


def _amax(x, dim=None, keepdim=False):
    return torch.amax(x) if dim is None else torch.amax(x, dim=dim, keepdim=keepdim)


def _amin(x, dim=None, keepdim=False):
    return torch.amin(x) if dim is None else torch.amin(x, dim=dim, keepdim=keepdim)


_prod = _over_dims(torch.prod)
for _name, _fn, _alias, _acc in (("prod", _prod, (), True), ("max", _amax, ("max_axis",), False),
                                 ("min", _amin, ("min_axis",), False),
                                 ("nansum", torch.nansum, (), False),
                                 ("nanprod", _nanprod, (), False)):
    _impl = _reduce(_fn, acc=_acc)
    _impl.__name__ = _name
    register(_name, aliases=_alias)(_impl)


def _arg(fn):
    def impl(x, *, axis=None, keepdims=False, dtype="float32"):
        out = fn(x.reshape(-1), dim=0) if axis is None else fn(x, dim=axis, keepdim=keepdims)
        if axis is None and keepdims:
            out = out.reshape((1,) * x.ndim)
        return out.to(torch_dtype(dtype))
    return impl


register("argmax", differentiable=False)(_arg(torch.argmax))
register("argmin", differentiable=False)(_arg(torch.argmin))


@register("argmax_channel", differentiable=False)
def argmax_channel(x):
    return torch.argmax(x, dim=1).to(torch.float32)


@register("logsumexp")
def logsumexp(x, *, axis=None, keepdims=False):
    ax = _norm_axis(axis, x.ndim)
    if ax is None:
        out = torch.logsumexp(x.reshape(-1), dim=0)
        return out.reshape((1,) * x.ndim) if keepdims else out
    return torch.logsumexp(x, dim=ax, keepdim=keepdims)


@register("moments")
def moments(x, *, axes=None, keepdims=False):
    ax = _norm_axis(axes, x.ndim)
    if ax is None:
        ax = tuple(range(x.ndim))
    var, mean = torch.var_mean(x, dim=ax, correction=0, keepdim=keepdims)
    return mean, var


@register("_square_sum", aliases=("square_sum",))
def square_sum(x, *, axis=None, keepdims=False, exclude=False):
    """Sum of squares (the reference's ``_square_sum``)."""
    return _reduce(_sum_sq)(x, axis=axis, keepdims=keepdims, exclude=exclude)


def _sum_sq(x, dim=None, keepdim=False):
    return torch.sum(torch.square(x)) if dim is None else \
        torch.sum(torch.square(x), dim=dim, keepdim=keepdim)


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
