"""NDArray: the imperative array, a thin holder of a ``torch.Tensor``.

Counterpart of ``mxnet_tpu/ndarray/ndarray.py``. The reference's NDArray
holds an immutable ``jax.Array`` in ``_data`` (:78-103); here ``_data`` is
a ``torch.Tensor`` on the NDArray's context. Every operator call goes through
``invoke`` (:495): tensors in, the registered torch function, NDArrays out.

Autograd: while ``autograd.is_recording()``, ``invoke`` runs a
differentiable op with grad enabled, so torch records it; otherwise, and
always for an op registered ``differentiable=False``, under
``torch.no_grad()``. ``attach_grad`` (:228) makes the array a variable with
its own gradient buffer, read back by ``.grad`` (:141); ``backward``
(:234) fills the buffers of the variables the array reaches
(``autograd.backward``), and ``detach`` cuts the array from the graph.
``dtype`` is a ``torch.dtype``; ``asnumpy()`` returns a float32 array for
bfloat16 data, which numpy cannot hold. The comparisons (``==``, ``<``...)
give 0/1 arrays in the input's dtype, as the reference's do (:269-280), so
an NDArray hashes by identity; ``bool()`` of one element reads it, of more
raises, and ``len()`` is the first dimension.

Left for later slices: indexing, in-place operators and ``__setitem__``,
sparse storage, the rest of the op-backed methods,
``ones``/``full``/``empty`` and the other creation functions, dlpack.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple, Union

import numpy as _np
import torch

from ..base import MXNetError, default_dtype, torch_dtype
from ..context import Context, current_context
from ..ops.registry import Op, get_op

__all__ = ["NDArray", "invoke", "array", "zeros", "arange", "waitall"]


def waitall():
    """Block until all queued device work is done (reference Engine::WaitForAll)."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


class NDArray:
    __slots__ = ("_data", "_ctx", "__weakref__")

    __array_priority__ = 1000.0

    def __init__(self, data, ctx: Optional[Context] = None):
        if isinstance(data, NDArray):
            data = data._data
        if not isinstance(data, torch.Tensor):
            raise MXNetError(f"NDArray holds a torch.Tensor, got {type(data)}; "
                             f"use nd.array() to convert")
        self._data = data
        self._ctx = ctx or Context.from_device(data.device)

    # -- basic properties ----------------------------------------------------
    @property
    def shape(self) -> Tuple[int, ...]:
        return tuple(self._data.shape)

    @property
    def dtype(self) -> torch.dtype:
        return self._data.dtype

    @property
    def size(self) -> int:
        return self._data.numel()

    @property
    def ndim(self) -> int:
        return self._data.dim()

    @property
    def ctx(self) -> Context:
        return self._ctx

    context = ctx

    # -- transfer ----------------------------------------------------------------
    def asnumpy(self) -> _np.ndarray:
        t = self._data.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.cpu().numpy().copy()

    def as_in_context(self, ctx: Context) -> "NDArray":
        if ctx == self._ctx:
            return self
        return NDArray(self._data.to(ctx.torch_device), ctx)

    as_in_ctx = as_in_context

    def astype(self, dtype, copy=True) -> "NDArray":
        if not copy and torch_dtype(dtype) == self.dtype:
            return self
        return invoke("Cast", [self], {"dtype": dtype})

    def __repr__(self):
        return (f"\n{self.asnumpy()}\n<NDArray "
                f"{'x'.join(map(str, self.shape))} @{self._ctx}>")

    # -- elementwise dunders -------------------------------------------------
    def _binary(self, other, op_name, scalar_op_name, reverse=False):
        if isinstance(other, NDArray):
            a, b = (other, self) if reverse else (self, other)
            return invoke(op_name, [a, b], {})
        if isinstance(other, (int, float, bool, _np.number)):
            return invoke(scalar_op_name, [self], {"scalar": float(other)})
        if isinstance(other, _np.ndarray):
            o = array(other, ctx=self._ctx)
            a, b = (o, self) if reverse else (self, o)
            return invoke(op_name, [a, b], {})
        return NotImplemented

    def __add__(self, o): return self._binary(o, "broadcast_add", "_plus_scalar")
    def __radd__(self, o): return self._binary(o, "broadcast_add", "_plus_scalar")
    def __sub__(self, o): return self._binary(o, "broadcast_sub", "_minus_scalar")
    def __rsub__(self, o): return self._binary(o, "broadcast_sub", "_rminus_scalar", reverse=True)
    def __mul__(self, o): return self._binary(o, "broadcast_mul", "_mul_scalar")
    def __rmul__(self, o): return self._binary(o, "broadcast_mul", "_mul_scalar")
    def __truediv__(self, o): return self._binary(o, "broadcast_div", "_div_scalar")
    def __rtruediv__(self, o): return self._binary(o, "broadcast_div", "_rdiv_scalar", reverse=True)
    def __neg__(self): return invoke("negative", [self], {})

    def __eq__(self, o):
        if o is None:
            return False
        return self._binary(o, "broadcast_equal", "_equal_scalar")

    def __ne__(self, o):
        if o is None:
            return True
        return self._binary(o, "broadcast_not_equal", "_not_equal_scalar")

    def __gt__(self, o): return self._binary(o, "broadcast_greater", "_greater_scalar")
    def __ge__(self, o): return self._binary(o, "broadcast_greater_equal", "_greater_equal_scalar")
    def __lt__(self, o): return self._binary(o, "broadcast_lesser", "_lesser_scalar")
    def __le__(self, o): return self._binary(o, "broadcast_lesser_equal", "_lesser_equal_scalar")

    def __hash__(self):
        return id(self)

    def __bool__(self):
        if self.size == 0:
            return False
        if self.size == 1:
            return bool(self.asscalar())
        raise MXNetError("ambiguous truth value of multi-element NDArray")

    def __len__(self):
        if self.ndim == 0:
            raise TypeError("len() of 0-d array")
        return self.shape[0]

    # in place (reference ``__iadd__``... with ``_set_data``): the result is
    # written into this array's tensor, outside the tape
    def _assign(self, out):
        if out is NotImplemented:
            return out
        with torch.no_grad():
            if out._data.shape == self._data.shape and out._data.dtype == self._data.dtype:
                self._data.copy_(out._data)
            else:
                self._data = out._data
        return self

    def __iadd__(self, o): return self._assign(self.__add__(o))
    def __isub__(self, o): return self._assign(self.__sub__(o))
    def __imul__(self, o): return self._assign(self.__mul__(o))

    # -- op-backed methods ---------------------------------------------------
    def reshape(self, *shape, **kwargs):
        if len(shape) == 1 and isinstance(shape[0], (tuple, list)):
            shape = tuple(shape[0])
        if not shape and "shape" in kwargs:
            shape = tuple(kwargs["shape"])
        return invoke("Reshape", [self], {"shape": shape,
                                          "reverse": kwargs.get("reverse", False)})

    def sum(self, axis=None, keepdims=False, exclude=False):
        return invoke("sum", [self], {"axis": axis, "keepdims": keepdims,
                                      "exclude": exclude})

    def mean(self, axis=None, keepdims=False, exclude=False):
        return invoke("mean", [self], {"axis": axis, "keepdims": keepdims,
                                       "exclude": exclude})

    def asscalar(self):
        if self.size != 1:
            raise MXNetError("The current array is not a scalar")
        return self.asnumpy().reshape(()).item()

    def expand_dims(self, axis):
        return invoke("expand_dims", [self], {"axis": axis})

    def transpose(self, *axes):
        if len(axes) == 1 and isinstance(axes[0], (tuple, list)):
            axes = tuple(axes[0])
        return invoke("transpose", [self], {"axes": axes or None})

    # -- autograd ------------------------------------------------------------
    @property
    def grad(self) -> Optional["NDArray"]:
        g = getattr(self._data, "_mx_grad", None)
        return NDArray(g, self._ctx) if g is not None else None

    def attach_grad(self, grad_req: str = "write", stype=None):
        from .. import autograd
        autograd.mark_variables([self], grad_reqs=grad_req)

    def backward(self, out_grad=None, retain_graph=False, train_mode=True):
        from .. import autograd
        autograd.backward([self], [out_grad] if out_grad is not None else None,
                          retain_graph=retain_graph, train_mode=train_mode)

    def detach(self) -> "NDArray":
        return NDArray(self._data.detach(), self._ctx)


# ---------------------------------------------------------------------------
# Eager dispatch
# ---------------------------------------------------------------------------

def invoke(op: Union[str, Op], inputs: Sequence[NDArray], params: Dict[str, Any]):
    """The imperative path (reference MXImperativeInvokeEx -> here a call of
    the registered torch function, recorded by torch while autograd records)."""
    from .. import autograd
    if isinstance(op, str):
        op = get_op(op)
    if None in params.values():
        params = {k: v for k, v in params.items() if v is not None}
    raw = [x._data for x in inputs]
    with torch.set_grad_enabled(op.differentiable and autograd.is_recording()):
        outs = op(*raw, **params)
    pairs = op.state_inputs(raw, params) if callable(op.state_inputs) else op.state_inputs
    if pairs:
        with torch.no_grad():
            for i, o in pairs:
                raw[i].copy_(outs[o])
        dropped = {o for _, o in pairs}
        outs = tuple(t for j, t in enumerate(outs) if j not in dropped)
        if len(outs) == 1:
            outs = outs[0]
    ctx = inputs[0]._ctx if inputs else None
    if isinstance(outs, tuple):
        return [NDArray(o, ctx) for o in outs]
    return NDArray(outs, ctx)


# ---------------------------------------------------------------------------
# Creation functions
# ---------------------------------------------------------------------------

def _dtype_of(source: _np.ndarray, dtype):
    if dtype is not None:
        return torch_dtype(dtype)
    # the reference runs jax with 64-bit types off: f64 -> the default
    # float dtype, i64 -> int32
    if source.dtype == _np.float64:
        return default_dtype()
    if source.dtype == _np.int64:
        return torch.int32
    return torch_dtype(source.dtype)


def array(source, ctx: Optional[Context] = None, dtype=None) -> NDArray:
    ctx = ctx or current_context()
    if isinstance(source, NDArray):
        source = source._data
    # always a copy, as in the reference: an array never shares memory with
    # its source, which an in-place gradient or optimizer write would change
    if isinstance(source, torch.Tensor):
        t = source.detach().to(ctx.torch_device, copy=True,
                               dtype=torch_dtype(dtype) if dtype else source.dtype)
        return NDArray(t, ctx)
    src = _np.asarray(source)
    t = torch.from_numpy(_np.ascontiguousarray(src)).to(
        ctx.torch_device, dtype=_dtype_of(src, dtype), copy=True)
    return NDArray(t, ctx)


def zeros(shape, ctx=None, dtype=None) -> NDArray:
    ctx = ctx or current_context()
    if isinstance(shape, int):
        shape = (shape,)
    return NDArray(torch.zeros(shape, dtype=torch_dtype(dtype or default_dtype()),
                               device=ctx.torch_device), ctx)


def arange(start, stop=None, step=1.0, repeat=1, ctx=None, dtype=None) -> NDArray:
    ctx = ctx or current_context()
    raw = get_op("_arange")(start=start, stop=stop, step=step, repeat=repeat,
                            dtype=dtype, device=ctx.torch_device)
    return NDArray(raw, ctx)
