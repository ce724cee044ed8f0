"""`mx.nd` namespace: NDArray, creation functions and every registered op.

Counterpart of ``mxnet_tpu/ndarray/__init__.py``: ``nd.<op>(*arrays,
**params)`` wrappers made on first access (PEP 562) from the op registry,
for example ``nd.FullyConnected``, ``nd.softmax`` and
``nd._contrib_flash_attention``. ``Dropout`` reads its ``training`` default
from ``autograd.is_training()``. ``nd.save``/``nd.load`` read and write the
reference's file format (``serialization.py``); ``nd.random`` and
``nd.linalg`` are the sampling and linear-algebra namespaces. The
``sparse`` submodule waits for ROADMAP A9.
"""
from __future__ import annotations

from .. import ops as _ops  # noqa: F401  (registers every op)
from ..ops.registry import all_ops, get_op
from .ndarray import (NDArray, invoke, array, zeros, ones, full, empty, arange,
                      eye, linspace, concat, stack, waitall, from_numpy)
from . import random  # noqa: F401
from . import linalg  # noqa: F401

__all__ = ["NDArray", "invoke", "array", "zeros", "ones", "full", "empty",
           "arange", "eye", "linspace", "concat", "stack", "waitall", "from_numpy",
           "zeros_like", "ones_like", "maximum", "minimum", "save", "load",
           "random", "linalg"]


def zeros_like(a):
    return invoke("zeros_like", [a], {})


def ones_like(a):
    return invoke("ones_like", [a], {})


def _extremum(lhs, rhs, pair_op, scalar_op, py):
    """Elementwise max/min with the reference's dispatch: the array op for
    two arrays, the scalar op when one side is a Python number."""
    if isinstance(lhs, NDArray) and isinstance(rhs, NDArray):
        return invoke(pair_op, [lhs, rhs], {})
    if isinstance(lhs, NDArray):
        return invoke(scalar_op, [lhs], {"scalar": float(rhs)})
    if isinstance(rhs, NDArray):
        return invoke(scalar_op, [rhs], {"scalar": float(lhs)})
    return py(lhs, rhs)


def maximum(lhs, rhs):
    return _extremum(lhs, rhs, "_maximum", "_maximum_scalar", max)


def minimum(lhs, rhs):
    return _extremum(lhs, rhs, "_minimum", "_minimum_scalar", min)


def save(fname, data):
    """Write an NDArray, a list or a dict of them (reference format)."""
    from ..serialization import save_ndarrays
    save_ndarrays(fname, data)


def load(fname, ctx=None):
    """Read a file of ``save`` (either package's) onto ``ctx`` (default: the
    current context)."""
    from ..serialization import load_ndarrays
    return load_ndarrays(fname, ctx)


_WRAPPERS = {}


def _make_wrapper(op_name: str):
    op = get_op(op_name)

    def wrapper(*args, **kwargs):
        inputs = []
        for a in args:
            if a is None:
                continue
            if not isinstance(a, NDArray):
                ctx = inputs[0].ctx if inputs else None
                a = array(a, ctx=ctx)
            inputs.append(a)
        if op.name == "Dropout":
            from .. import autograd
            kwargs.setdefault("training", autograd.is_training())
        # an array given by keyword (``_adamw_update``'s rescale_grad) reaches
        # the op as its tensor
        kwargs = {k: v._data if isinstance(v, NDArray) else v for k, v in kwargs.items()}
        return invoke(op, inputs, kwargs)

    wrapper.__name__ = op_name
    wrapper.__doc__ = op.doc
    return wrapper


def __getattr__(name):
    if name.startswith("__"):
        raise AttributeError(name)
    if name in all_ops():
        w = _WRAPPERS.get(name)
        if w is None:
            w = _WRAPPERS[name] = _make_wrapper(name)
        return w
    raise AttributeError(f"module 'mxnet_tpu_torch.ndarray' has no attribute {name!r}")
