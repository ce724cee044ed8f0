"""Elementwise, broadcast and scalar operators.

Counterpart of ``mxnet_tpu/ops/elemwise.py``. Ported: the four broadcast
binary ops and their scalar forms, ``negative``, ``Cast``, ``gelu`` in its
exact erf form (the reference's default ``approximate=False``,
``elemwise.py:137-139``), the unary ops ``square``, ``abs``, ``relu``,
``log``, ``exp``, ``sign``, ``sqrt``, ``sigmoid``, ``tanh``, ``round``
(half to even, as ``jnp.round``), ``floor``, ``ceil`` (:25-50),
``zeros_like``/``ones_like``, ``clip`` (:103, in its where-form: the
gradient passes at the bounds), ``broadcast_mod``/``broadcast_power`` and
``_maximum``/``_minimum`` (:161-170, where-forms: a tie's gradient goes
to the first argument), their scalar forms (:220-225; ``mod`` is the floor
modulo of ``jnp.mod``), and the comparisons, broadcast (:177-187, the
result in the inputs' promoted dtype) and scalar (:241-252, in the
tensor's dtype). The other unary and activation families wait for ROADMAP
A9.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..base import torch_dtype
from .registry import register

_BINARY = {
    "broadcast_add": torch.add, "broadcast_sub": torch.sub,
    "broadcast_mul": torch.mul, "broadcast_div": torch.true_divide,
    "broadcast_mod": torch.remainder, "broadcast_power": torch.pow,
    "_maximum": lambda x, y: torch.where(x >= y, x, y),
    "_minimum": lambda x, y: torch.where(x <= y, x, y),
}
for _name, _f in _BINARY.items():
    register(_name)(_f)

_SCALAR = {
    "_plus_scalar": lambda x, s: x + s,
    "_minus_scalar": lambda x, s: x - s,
    "_rminus_scalar": lambda x, s: s - x,
    "_mul_scalar": lambda x, s: x * s,
    "_div_scalar": lambda x, s: x / s,
    "_rdiv_scalar": lambda x, s: s / x,
    "_mod_scalar": lambda x, s: torch.remainder(x, s),
    "_rmod_scalar": lambda x, s: torch.remainder(torch.full_like(x, s), x),
    "_power_scalar": lambda x, s: torch.pow(x, s),
    "_rpower_scalar": lambda x, s: torch.pow(s, x),
    "_maximum_scalar": lambda x, s: torch.maximum(x, torch.full_like(x, s)),
    "_minimum_scalar": lambda x, s: torch.minimum(x, torch.full_like(x, s)),
}
for _name, _f in _SCALAR.items():
    def _sfn(x, *, scalar, _f=_f):
        # reference semantics (elemwise_binary_scalar_op.h): the scalar is
        # first cast to the TENSOR's dtype and the result stays in it, so
        # int32 / 2 truncates and a bf16 tensor sees the bf16-rounded scalar
        s = torch.tensor(scalar, dtype=x.dtype).item()
        return _f(x, s).to(x.dtype)
    register(_name)(_sfn)


@register("negative")
def negative(x):
    return torch.neg(x)


@register("Cast", aliases=("cast",))
def cast(x, *, dtype):
    return x.to(torch_dtype(dtype))


@register("gelu")
def gelu(x, *, approximate=False):
    return F.gelu(x, approximate="tanh" if approximate else "none")


_UNARY = {"square": torch.square, "abs": torch.abs, "relu": torch.relu, "log": torch.log,
          "exp": torch.exp, "sign": torch.sign, "sqrt": torch.sqrt,
          "sigmoid": torch.sigmoid, "tanh": torch.tanh, "round": torch.round,
          "floor": torch.floor, "ceil": torch.ceil}
for _name, _f in _UNARY.items():
    register(_name)(_f)

register("zeros_like")(torch.zeros_like)
register("ones_like")(torch.ones_like)


@register("clip")
def clip(x, *, a_min, a_max):
    lo = torch.full_like(x, a_min)
    hi = torch.full_like(x, a_max)
    return torch.where(x < a_min, lo, torch.where(x > a_max, hi, x))

_BINARY_CMP = {
    "broadcast_equal": torch.eq, "broadcast_not_equal": torch.ne,
    "broadcast_greater": torch.gt, "broadcast_greater_equal": torch.ge,
    "broadcast_lesser": torch.lt, "broadcast_lesser_equal": torch.le,
}
for _name, _f in _BINARY_CMP.items():
    def _cmp(x, y, _f=_f):
        return _f(x, y).to(torch.promote_types(x.dtype, y.dtype))
    register(_name, differentiable=False)(_cmp)

_SCALAR_CMP = {
    "_equal_scalar": torch.eq, "_not_equal_scalar": torch.ne,
    "_greater_scalar": torch.gt, "_greater_equal_scalar": torch.ge,
    "_lesser_scalar": torch.lt, "_lesser_equal_scalar": torch.le,
}
for _name, _f in _SCALAR_CMP.items():
    def _scmp(x, *, scalar, _f=_f):
        return _f(x, scalar).to(x.dtype)
    register(_name, differentiable=False)(_scmp)
