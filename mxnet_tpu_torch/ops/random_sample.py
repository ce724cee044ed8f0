"""Random-sampling ops: ``_random_*`` and the multisample ``_sample_*``.

Counterpart of ``mxnet_tpu/ops/random_sample.py`` (reference
``src/operator/random/sample_op.cc`` and ``multisample_op.cc``). The
reference's ops take a threefry key as an input; here every draw comes from
``random.generator`` of the device the op runs on (the inputs' device, or
``ctx``, default the current context, for the ops without inputs), an
explicit ``torch.Generator`` that ``mx.random.seed`` reseeds. The two
streams cannot be matched: the tests hold these ops by their moments and a
Kolmogorov-Smirnov test, not by values.

- ``_random_uniform``/``_random_normal`` draw ``shape``;
  ``_random_uniform_like``/``_random_normal_like`` the shape and dtype of
  their input.
- ``_sample_multinomial(data)``: category indices from the probability rows
  of ``data``, ``data.shape[:-1] + shape`` (``shape=None``: one, no extra
  axis).
- The multisample family, ``_sample_uniform(low, high)``,
  ``_sample_normal(mu, sigma)``, ``_sample_gamma(alpha, beta)`` (beta the
  scale), ``_sample_exponential(lam)`` (lam the rate),
  ``_sample_poisson(lam)``, ``_sample_negative_binomial(k, p)`` (Poisson of
  a Gamma(k, (1-p)/p) rate) and
  ``_sample_generalized_negative_binomial(mu, alpha)`` (Poisson of a
  Gamma(1/alpha, mu alpha) rate, alpha clamped at 1e-8): the parameter
  arrays broadcast to one shape, and ``shape`` draws of each distribution
  are trailing axes, ``params.shape + shape``.
"""
from __future__ import annotations

import torch

from ..base import default_dtype, torch_dtype
from .registry import register


def _gen(device):
    from .. import random as _random
    return _random.generator(device)


def _device(ctx):
    from ..context import current_context
    return (ctx or current_context()).torch_device


def _shape(shape):
    if shape is None:
        return ()
    return (int(shape),) if isinstance(shape, (int, float)) else tuple(int(s) for s in shape)


def _dt(dtype):
    return torch_dtype(dtype) if dtype is not None else default_dtype()


@register("_random_uniform", aliases=("random_uniform",), differentiable=False)
def random_uniform(*, low=0.0, high=1.0, shape=(1,), dtype="float32", ctx=None):
    dev = _device(ctx)
    u = torch.rand(_shape(shape), generator=_gen(dev), device=dev, dtype=torch.float32)
    return (low + (high - low) * u).to(_dt(dtype))


@register("_random_normal", aliases=("random_normal",), differentiable=False)
def random_normal(*, loc=0.0, scale=1.0, shape=(1,), dtype="float32", ctx=None):
    dev = _device(ctx)
    z = torch.randn(_shape(shape), generator=_gen(dev), device=dev, dtype=torch.float32)
    return (loc + scale * z).to(_dt(dtype))


@register("_random_uniform_like", aliases=("random_uniform_like",), differentiable=False)
def random_uniform_like(data, *, low=0.0, high=1.0):
    u = torch.rand(data.shape, generator=_gen(data.device), device=data.device,
                   dtype=torch.float32)
    return (low + (high - low) * u).to(data.dtype)


@register("_random_normal_like", aliases=("random_normal_like",), differentiable=False)
def random_normal_like(data, *, loc=0.0, scale=1.0):
    z = torch.randn(data.shape, generator=_gen(data.device), device=data.device,
                    dtype=torch.float32)
    return (loc + scale * z).to(data.dtype)


def multinomial_draws(probs, n, gen):
    """``n`` category indices a row of ``probs`` (..., K) -> (..., n), int64."""
    rows = probs.reshape(-1, probs.shape[-1]).float().clamp_min(0)
    out = torch.multinomial(rows, n, replacement=True, generator=gen)
    return out.reshape(probs.shape[:-1] + (n,))


@register("_sample_multinomial", aliases=("sample_multinomial",), differentiable=False)
def sample_multinomial(data, *, shape=None, get_prob=False, dtype="int32"):
    draw = _shape(shape)
    n = 1
    for d in draw:
        n *= d
    out = multinomial_draws(data, n, _gen(data.device))
    out = out[..., 0] if shape is None else out.reshape(data.shape[:-1] + draw)
    return out.to(torch_dtype(dtype))


def _multisample(params, shape, draw_fn, dtype):
    """Broadcast the parameter arrays, give each a trailing axis per draw
    dim, and draw ``params.shape + shape``."""
    draw = _shape(shape)
    params = torch.broadcast_tensors(*params)
    full = tuple(params[0].shape) + draw
    expanded = [p.reshape(tuple(p.shape) + (1,) * len(draw)).float() for p in params]
    out = draw_fn(_gen(params[0].device), full, *expanded)
    return out.to(_dt(dtype))


def _gamma(gen, full, alpha):
    return torch._standard_gamma(alpha.expand(full).contiguous(), generator=gen)


@register("_sample_uniform", aliases=("sample_uniform",), differentiable=False)
def sample_uniform(low, high, *, shape=None, dtype="float32"):
    def draw(gen, full, lo, hi):
        return lo + (hi - lo) * torch.rand(full, generator=gen, device=lo.device)
    return _multisample((low, high), shape, draw, dtype)


@register("_sample_normal", aliases=("sample_normal",), differentiable=False)
def sample_normal(mu, sigma, *, shape=None, dtype="float32"):
    def draw(gen, full, m, s):
        return m + s * torch.randn(full, generator=gen, device=m.device)
    return _multisample((mu, sigma), shape, draw, dtype)


@register("_sample_gamma", aliases=("sample_gamma",), differentiable=False)
def sample_gamma(alpha, beta, *, shape=None, dtype="float32"):
    def draw(gen, full, a, b):
        return b * _gamma(gen, full, a)
    return _multisample((alpha, beta), shape, draw, dtype)


@register("_sample_exponential", aliases=("sample_exponential",), differentiable=False)
def sample_exponential(lam, *, shape=None, dtype="float32"):
    def draw(gen, full, rate):
        e = torch.empty(full, device=rate.device).exponential_(1.0, generator=gen)
        return e / rate
    return _multisample((lam,), shape, draw, dtype)


@register("_sample_poisson", aliases=("sample_poisson",), differentiable=False)
def sample_poisson(lam, *, shape=None, dtype="float32"):
    def draw(gen, full, rate):
        return torch.poisson(rate.expand(full).contiguous(), generator=gen)
    return _multisample((lam,), shape, draw, dtype)


@register("_sample_negative_binomial", aliases=("sample_negative_binomial",),
          differentiable=False)
def sample_negative_binomial(k, p, *, shape=None, dtype="float32"):
    def draw(gen, full, kk, pp):
        return torch.poisson(_gamma(gen, full, kk) * (1.0 - pp) / pp, generator=gen)
    return _multisample((k, p), shape, draw, dtype)


@register("_sample_generalized_negative_binomial",
          aliases=("sample_generalized_negative_binomial",), differentiable=False)
def sample_generalized_negative_binomial(mu, alpha, *, shape=None, dtype="float32"):
    def draw(gen, full, m, a):
        a = a.clamp_min(1e-8)
        return torch.poisson(_gamma(gen, full, 1.0 / a) * (m * a), generator=gen)
    return _multisample((mu, alpha), shape, draw, dtype)
