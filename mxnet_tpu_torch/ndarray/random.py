"""`mx.nd.random`: sampling functions.

Counterpart of ``mxnet_tpu/ndarray/random.py``. Every draw comes from
``random.generator(ctx)``, the explicit ``torch.Generator`` of the device,
so ``mx.random.seed(n)`` makes every draw repeat. Scalar parameters draw
``shape`` on ``ctx`` (default: the current context); an NDArray parameter
routes the call to the multisample op ``_sample_<dist>`` (reference
``_random_helper``), which draws ``params.shape + shape`` on the
parameters' device. The reference's conventions hold: ``gamma``'s ``beta``
is the scale, ``exponential`` takes the scale (its NDArray form passes the
rate ``1/scale`` to ``_sample_exponential``), ``randn(*shape)`` takes the
shape positionally, ``randint`` draws in ``[low, high)``, ``multinomial``
draws category indices from probability rows (``get_prob``: with their log
probabilities) and ``shuffle`` permutes the first axis. ``out=`` (where the
reference has it) writes the draw into an existing array.
"""
from __future__ import annotations

import torch

from ..base import default_dtype, torch_dtype
from ..context import current_context
from .. import random as _random
from ..ops.random_sample import multinomial_draws
from .ndarray import NDArray, array, invoke


def _shape(shape):
    if shape is None:
        return ()
    return (shape,) if isinstance(shape, int) else tuple(shape)


def _make(raw, ctx, out=None):
    if out is not None:
        out._write(raw.to(out._data.device, out.dtype))
        return out
    return NDArray(raw, ctx)


def _ctx_gen(ctx):
    ctx = ctx or current_context()
    return ctx, ctx.torch_device, _random.generator(ctx)


def _dt(dtype):
    return torch_dtype(dtype) if dtype is not None else default_dtype()


def _sample_op(op_name, params, shape, dtype, out=None):
    """An NDArray-parameterized draw: the multisample op on the
    parameters' device."""
    like = next(p for p in params if isinstance(p, NDArray))
    nds = [p if isinstance(p, NDArray) else array(p, ctx=like.ctx) for p in params]
    res = invoke(op_name, nds, {"shape": shape, "dtype": str(_dt(dtype)).rpartition(".")[2]})
    return _make(res._data, res.ctx, out)


def uniform(low=0.0, high=1.0, shape=None, dtype=None, ctx=None, out=None):
    if isinstance(low, NDArray) or isinstance(high, NDArray):
        return _sample_op("_sample_uniform", [low, high], shape, dtype, out)
    ctx, dev, gen = _ctx_gen(ctx)
    u = torch.rand(_shape(shape), generator=gen, device=dev, dtype=torch.float32)
    return _make((low + (high - low) * u).to(_dt(dtype)), ctx, out)


def normal(loc=0.0, scale=1.0, shape=None, dtype=None, ctx=None, out=None):
    if isinstance(loc, NDArray) or isinstance(scale, NDArray):
        return _sample_op("_sample_normal", [loc, scale], shape, dtype, out)
    ctx, dev, gen = _ctx_gen(ctx)
    z = torch.randn(_shape(shape), generator=gen, device=dev, dtype=torch.float32)
    return _make((loc + scale * z).to(_dt(dtype)), ctx, out)


def randn(*shape, loc=0.0, scale=1.0, dtype=None, ctx=None, out=None):
    return normal(loc=loc, scale=scale, shape=shape or None, dtype=dtype, ctx=ctx, out=out)


def randint(low, high=None, shape=None, dtype="int32", ctx=None, out=None):
    if high is None:
        low, high = 0, low
    ctx, dev, gen = _ctx_gen(ctx)
    raw = torch.randint(int(low), int(high), _shape(shape), generator=gen, device=dev)
    return _make(raw.to(torch_dtype(dtype)), ctx, out)


def poisson(lam=1.0, shape=None, dtype=None, ctx=None, out=None):
    if isinstance(lam, NDArray):
        return _sample_op("_sample_poisson", [lam], shape, dtype, out)
    ctx, dev, gen = _ctx_gen(ctx)
    raw = torch.poisson(torch.full(_shape(shape), float(lam), device=dev), generator=gen)
    return _make(raw.to(_dt(dtype)), ctx, out)


def exponential(scale=1.0, shape=None, dtype=None, ctx=None, out=None):
    if isinstance(scale, NDArray):
        return _sample_op("_sample_exponential", [1.0 / scale], shape, dtype, out)
    ctx, dev, gen = _ctx_gen(ctx)
    raw = torch.empty(_shape(shape), device=dev).exponential_(1.0, generator=gen) * scale
    return _make(raw.to(_dt(dtype)), ctx, out)


def _gamma(alpha, shape, dev, gen):
    return torch._standard_gamma(torch.full(shape, float(alpha), device=dev), generator=gen)


def gamma(alpha=1.0, beta=1.0, shape=None, dtype=None, ctx=None, out=None):
    if isinstance(alpha, NDArray) or isinstance(beta, NDArray):
        return _sample_op("_sample_gamma", [alpha, beta], shape, dtype, out)
    ctx, dev, gen = _ctx_gen(ctx)
    raw = beta * _gamma(alpha, _shape(shape), dev, gen)
    return _make(raw.to(_dt(dtype)), ctx, out)


def negative_binomial(k=1, p=1, shape=None, dtype=None, ctx=None, out=None):
    if isinstance(k, NDArray) or isinstance(p, NDArray):
        return _sample_op("_sample_negative_binomial", [k, p], shape, dtype, out)
    ctx, dev, gen = _ctx_gen(ctx)
    rate = _gamma(k, _shape(shape), dev, gen) * (1 - p) / p
    return _make(torch.poisson(rate, generator=gen).to(_dt(dtype)), ctx, out)


def generalized_negative_binomial(mu=1.0, alpha=1.0, shape=None, dtype=None, ctx=None,
                                  out=None):
    if isinstance(mu, NDArray) or isinstance(alpha, NDArray):
        return _sample_op("_sample_generalized_negative_binomial", [mu, alpha], shape,
                          dtype, out)
    r = 1.0 / alpha
    return negative_binomial(r, r / (r + mu), shape, dtype, ctx, out)


def multinomial(data, shape=None, get_prob=False, dtype="int32"):
    """Category indices drawn from the probability rows of ``data`` (1-D or
    2-D): ``shape`` draws a row, one with no extra axis for None."""
    n = 1
    for d in _shape(shape):
        n *= d
    gen = _random.generator(data.ctx)
    out = multinomial_draws(data._data, n, gen)
    if shape is None:
        out = out[..., 0]
    res = NDArray(out.to(torch_dtype(dtype)), data.ctx)
    if get_prob:
        logp = torch.log_softmax(torch.log(torch.clamp_min(data._data.float(), 1e-30)), dim=-1)
        idx = out.reshape(data.shape[:-1] + (-1,))
        lp = torch.gather(logp, -1, idx).reshape(out.shape)
        return res, NDArray(lp, data.ctx)
    return res


def shuffle(data):
    gen = _random.generator(data.ctx)
    idx = torch.randperm(data.shape[0], generator=gen, device=data._data.device)
    return NDArray(data._data[idx], data.ctx)


def bernoulli(p=0.5, shape=None, dtype=None, ctx=None, out=None):
    ctx, dev, gen = _ctx_gen(ctx)
    raw = torch.bernoulli(torch.full(_shape(shape), float(p), device=dev), generator=gen)
    return _make(raw.to(_dt(dtype)), ctx, out)
