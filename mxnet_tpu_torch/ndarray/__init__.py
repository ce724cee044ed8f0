"""`mx.nd` namespace: NDArray, creation functions and every registered op.

Counterpart of ``mxnet_tpu/ndarray/__init__.py``: ``nd.<op>(*arrays,
**params)`` wrappers made on first access (PEP 562) from the op registry,
for example ``nd.FullyConnected``, ``nd.softmax`` and
``nd._contrib_flash_attention``. ``Dropout`` reads its ``training`` default
from ``autograd.is_training()``. The ``random``, ``linalg`` and ``sparse``
submodules wait for later slices.
"""
from __future__ import annotations

from .. import ops as _ops  # noqa: F401  (registers every op)
from ..ops.registry import all_ops, get_op
from .ndarray import NDArray, invoke, array, zeros, arange, waitall

__all__ = ["NDArray", "invoke", "array", "zeros", "arange", "waitall"]

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
