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

Writes (``+=``, ``-=``, ``*=``, ``/=``, ``x[key] = value``, ``copyto``).
The reference swaps an immutable payload (``_set_data``, :97-99), so a
recorded graph keeps the values it saw. Here the write goes into the
array's own tensor whenever that tensor is a leaf of the graph (a
variable, a parameter, a constant): the fused optimizer's pointer tables,
the kvstore's buffers and the captured CUDA graphs read that storage by
address and see the new value. A graph that saved the tensor keeps the
old value all the same: while ``autograd.record()`` is on, every leaf
tensor an op saves for its backward is held through
``autograd``'s saved-tensor hooks, and the write first gives each such
live hold a copy of the old value (``autograd.preserve_saved``). The
result of a recorded op (a tensor with a history) is swapped instead,
as the reference does. ``version`` counts the writes (:101).

Indexing (:190-215): ``x[key]`` takes ints, slices, ``None``, ``...``,
tuples of them and NDArray indices (as integer arrays); an int out of
range raises ``IndexError``, so ``for row in x`` ends. The result is a
new array, never a view of ``x``'s storage (the reference's arrays share
nothing), and is recorded while autograd records, differentiable again
under ``grad(create_graph=True)``. ``x[key] = value`` takes a scalar, an
NDArray, a numpy array or a tensor, broadcast to the indexed shape.

Left for later slices: sparse storage (``tostype``) and dlpack.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple, Union

import numpy as _np
import torch

from ..base import MXNetError, default_dtype, torch_dtype
from ..context import Context, current_context
from ..ops.registry import Op, get_op

__all__ = ["NDArray", "invoke", "array", "zeros", "ones", "full", "empty",
           "arange", "eye", "linspace", "concat", "stack", "waitall", "from_numpy"]


def waitall():
    """Block until all queued device work is done (reference Engine::WaitForAll)."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


class NDArray:
    __slots__ = ("_data", "_ctx", "_vbase", "__weakref__")

    __array_priority__ = 1000.0

    def __init__(self, data, ctx: Optional[Context] = None):
        if isinstance(data, NDArray):
            data = data._data
        if not isinstance(data, torch.Tensor):
            raise MXNetError(f"NDArray holds a torch.Tensor, got {type(data)}; "
                             f"use nd.array() to convert")
        self._data = data
        self._ctx = ctx or Context.from_device(data.device)
        self._vbase = 0

    @property
    def version(self) -> int:
        """The number of writes into this array (reference :101): the
        tensor's own counter, carried over when a write swaps the tensor."""
        return self._vbase + self._data._version

    def _swap(self, tensor: torch.Tensor) -> None:
        v = self.version
        self._data = tensor
        self._vbase = v + 1 - tensor._version

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

    @property
    def stype(self) -> str:
        return "default"

    @property
    def T(self) -> "NDArray":
        return self.transpose()

    @property
    def handle(self):
        return self._data

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

    def as_nd_ndarray(self):
        return self

    def wait_to_read(self):
        if self._data.is_cuda:
            torch.cuda.current_stream(self._data.device).synchronize()

    wait_to_write = wait_to_read

    def tolist(self):
        return self.asnumpy().tolist()

    def item(self):
        return self.asscalar()

    def __float__(self):
        return float(self.asscalar())

    def __int__(self):
        return int(self.asscalar())

    def __array__(self, dtype=None, copy=None):
        a = self.asnumpy()
        return a.astype(dtype) if dtype else a

    def copy(self) -> "NDArray":
        """A new array with its own storage (reference :160)."""
        return NDArray(self._data.detach().clone(), self._ctx)

    def copyto(self, other) -> "NDArray":
        """Write this array into ``other`` (cast to its dtype, moved to its
        device), or to a new array on a Context (reference :163)."""
        if isinstance(other, Context):
            return NDArray(self._data.detach().to(other.torch_device, copy=True), other)
        if not isinstance(other, NDArray):
            raise MXNetError(f"copyto: expected an NDArray or a Context, got {type(other)}")
        if other.shape != self.shape:
            raise MXNetError(f"copyto: shape {self.shape} into {other.shape}")
        other._write(self._data.detach().to(other._data.device, other.dtype))
        return other

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
    def __mod__(self, o): return self._binary(o, "broadcast_mod", "_mod_scalar")
    def __rmod__(self, o): return self._binary(o, "broadcast_mod", "_rmod_scalar", reverse=True)
    def __pow__(self, o): return self._binary(o, "broadcast_power", "_power_scalar")
    def __rpow__(self, o): return self._binary(o, "broadcast_power", "_rpower_scalar", reverse=True)
    def __neg__(self): return invoke("negative", [self], {})
    def __abs__(self): return invoke("abs", [self], {})

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

    # -- writes (module docstring) -------------------------------------------
    def _write(self, value: torch.Tensor, key=None) -> None:
        """Write ``value`` into this array, at ``key`` if given: in place into
        a leaf tensor (the graphs that saved it keep a copy of the old
        value), else as a new tensor (a tensor with a history)."""
        from .. import autograd
        t = self._data
        if t.grad_fn is None:
            autograd.preserve_saved(t)
            with torch.no_grad():
                if key is None:
                    t.copy_(value)
                else:
                    t[key] = value
            return
        with torch.set_grad_enabled(autograd.is_recording()):
            if key is None:
                new = value.to(t.dtype).expand(t.shape).clone()
            else:
                new = t.clone()
                new[key] = value
        self._swap(new)

    def _assign(self, out):
        if out is NotImplemented:
            return out
        if out._data.shape == self._data.shape and out._data.dtype == self._data.dtype:
            self._write(out._data)
        else:
            self._swap(out._data)
        return self

    def __iadd__(self, o): return self._assign(self.__add__(o))
    def __isub__(self, o): return self._assign(self.__sub__(o))
    def __imul__(self, o): return self._assign(self.__mul__(o))
    def __itruediv__(self, o): return self._assign(self.__truediv__(o))

    # -- indexing --------------------------------------------------------------
    def _index(self, key):
        def one(k):
            if isinstance(k, NDArray):
                k = k._data
            if isinstance(k, torch.Tensor):
                k = k.to(self._data.device)
                return k if k.dtype == torch.bool else k.to(torch.int64)
            if isinstance(k, _np.ndarray):
                return torch.from_numpy(k.astype(_np.int64)).to(self._data.device)
            if isinstance(k, _np.integer):
                return int(k)
            return k
        return tuple(one(k) for k in key) if isinstance(key, tuple) else one(key)

    def __getitem__(self, key):
        from .. import autograd
        key = self._index(key)
        if isinstance(key, int):
            # python iteration (``for row in x``) ends on IndexError
            n = self.shape[0] if self.ndim else 0
            if not -n <= key < n:
                raise IndexError(f"index {key} is out of bounds for axis 0 "
                                 f"with size {n}")
        with torch.set_grad_enabled(autograd.is_recording()):
            src, key = _positive_steps(self._data, key, flip=True)
            out = src[key]
            if out._is_view():
                out = out.clone()
        return NDArray(out, self._ctx)

    def __setitem__(self, key, value):
        key = self._index(key)
        if isinstance(value, NDArray):
            value = value._data
        if isinstance(value, torch.Tensor):
            value = value.to(self._data.device, self.dtype)
        else:
            value = torch.as_tensor(_np.asarray(value), device=self._data.device).to(self.dtype)
        if isinstance(key, slice) and key == slice(None):
            key = None
        elif key is not None:
            key = _positive_steps(self._data, key, flip=False)[1]
        self._write(value, key)

    # -- op-backed methods (reference :351-482) -----------------------------
    def reshape(self, *shape, **kwargs):
        if len(shape) == 1 and isinstance(shape[0], (tuple, list)):
            shape = tuple(shape[0])
        if not shape and "shape" in kwargs:
            shape = tuple(kwargs["shape"])
        return invoke("Reshape", [self], {"shape": shape,
                                          "reverse": kwargs.get("reverse", False)})

    def reshape_like(self, other):
        return self.reshape(other.shape)

    def asscalar(self):
        if self.size != 1:
            raise MXNetError("The current array is not a scalar")
        return self.asnumpy().reshape(()).item()

    def expand_dims(self, axis):
        return invoke("expand_dims", [self], {"axis": axis})

    def squeeze(self, axis=None):
        return invoke("squeeze", [self], {"axis": axis})

    def transpose(self, *axes):
        if len(axes) == 1 and isinstance(axes[0], (tuple, list)):
            axes = tuple(axes[0])
        return invoke("transpose", [self], {"axes": axes or None})

    def flatten(self):
        return invoke("Flatten", [self], {})

    def broadcast_to(self, shape):
        return invoke("broadcast_to", [self], {"shape": tuple(shape)})

    def broadcast_like(self, other):
        return invoke("broadcast_like", [self, other], {})

    def slice(self, begin, end, step=None):
        return invoke("slice", [self], {"begin": tuple(begin), "end": tuple(end),
                                        "step": tuple(step) if step else None})

    def slice_axis(self, axis, begin, end):
        return invoke("slice_axis", [self], {"axis": axis, "begin": begin, "end": end})

    def take(self, indices, axis=0, mode="clip"):
        return invoke("take", [self, indices], {"axis": axis, "mode": mode})

    def one_hot(self, depth, **kw):
        return invoke("one_hot", [self], {"depth": depth, **kw})

    def pick(self, index, axis=-1, keepdims=False):
        return invoke("pick", [self, index], {"axis": axis, "keepdims": keepdims})

    def clip(self, a_min, a_max):
        return invoke("clip", [self], {"a_min": a_min, "a_max": a_max})

    def abs(self): return invoke("abs", [self], {})
    def sign(self): return invoke("sign", [self], {})
    def sqrt(self): return invoke("sqrt", [self], {})
    def square(self): return invoke("square", [self], {})
    def exp(self): return invoke("exp", [self], {})
    def log(self): return invoke("log", [self], {})
    def relu(self): return invoke("relu", [self], {})
    def sigmoid(self): return invoke("sigmoid", [self], {})
    def tanh(self): return invoke("tanh", [self], {})
    def softmax(self, axis=-1): return invoke("softmax", [self], {"axis": axis})
    def log_softmax(self, axis=-1): return invoke("log_softmax", [self], {"axis": axis})
    def round(self): return invoke("round", [self], {})
    def floor(self): return invoke("floor", [self], {})
    def ceil(self): return invoke("ceil", [self], {})

    def _reduce(self, name, axis=None, keepdims=False, **kw):
        return invoke(name, [self], {"axis": axis, "keepdims": keepdims, **kw})

    def sum(self, axis=None, keepdims=False, exclude=False):
        return self._reduce("sum", axis, keepdims, exclude=exclude)

    def mean(self, axis=None, keepdims=False, exclude=False):
        return self._reduce("mean", axis, keepdims, exclude=exclude)

    def prod(self, axis=None, keepdims=False):
        return self._reduce("prod", axis, keepdims)

    def max(self, axis=None, keepdims=False):
        return self._reduce("max", axis, keepdims)

    def min(self, axis=None, keepdims=False):
        return self._reduce("min", axis, keepdims)

    def norm(self, ord=2, axis=None, keepdims=False):
        return invoke("norm", [self], {"ord": ord, "axis": axis, "keepdims": keepdims})

    def argmax(self, axis=None, keepdims=False):
        return self._reduce("argmax", axis, keepdims)

    def argmin(self, axis=None, keepdims=False):
        return self._reduce("argmin", axis, keepdims)

    def argsort(self, axis=-1, is_ascend=True):
        return invoke("argsort", [self], {"axis": axis, "is_ascend": is_ascend})

    def sort(self, axis=-1, is_ascend=True):
        return invoke("sort", [self], {"axis": axis, "is_ascend": is_ascend})

    def topk(self, axis=-1, k=1, ret_typ="indices", is_ascend=False):
        return invoke("topk", [self], {"axis": axis, "k": k, "ret_typ": ret_typ,
                                       "is_ascend": is_ascend})

    def dot(self, other, transpose_a=False, transpose_b=False):
        return invoke("dot", [self, other], {"transpose_a": transpose_a,
                                             "transpose_b": transpose_b})

    def zeros_like(self): return invoke("zeros_like", [self], {})
    def ones_like(self): return invoke("ones_like", [self], {})

    def tile(self, reps): return invoke("tile", [self], {"reps": tuple(reps)})

    def repeat(self, repeats, axis=None):
        return invoke("repeat", [self], {"repeats": repeats, "axis": axis})

    def flip(self, axis): return invoke("reverse", [self], {"axis": axis})

    def swapaxes(self, dim1, dim2):
        return invoke("swapaxes", [self], {"dim1": dim1, "dim2": dim2})

    def split(self, num_outputs, axis=1, squeeze_axis=False):
        return invoke("SliceChannel", [self], {"num_outputs": num_outputs,
                                               "axis": axis,
                                               "squeeze_axis": squeeze_axis})

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


def _positive_steps(t: torch.Tensor, key, flip: bool):
    """(tensor, key) with no negative slice step, which torch refuses: with
    ``flip`` the dims of such slices are flipped and the slices rewritten on
    the flipped tensor (a read); without it each becomes an index tensor
    (a write; one of them at most)."""
    parts = list(key) if isinstance(key, tuple) else [key]
    if not any(isinstance(k, slice) and k.step is not None and k.step < 0 for k in parts):
        return t, key
    consumed = sum(1 for k in parts if k is not None and k is not Ellipsis)
    dims, d = [], 0
    for k in parts:                      # the dim each part of the key indexes
        dims.append(d)
        if k is Ellipsis:
            d += t.dim() - consumed
        elif k is not None:
            d += 1
    flips, tensors = [], 0
    for i, (k, d) in enumerate(zip(parts, dims)):
        if not (isinstance(k, slice) and k.step is not None and k.step < 0):
            continue
        n = t.shape[d]
        r = range(*k.indices(n))
        if flip:
            flips.append(d)
            first = n - 1 - r.start if len(r) else 0
            parts[i] = slice(first, first + len(r) * -k.step, -k.step)
        else:
            tensors += 1
            if tensors > 1:
                raise MXNetError("x[key] = value: one slice with a negative step at most")
            parts[i] = torch.tensor(list(r), dtype=torch.int64, device=t.device)
    if flips:
        t = t.flip(flips)
    return t, tuple(parts) if isinstance(key, tuple) else parts[0]


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


def from_numpy(a: _np.ndarray, ctx=None) -> NDArray:
    return array(a, ctx=ctx)


def _filled(shape, value, ctx, dtype) -> NDArray:
    ctx = ctx or current_context()
    if isinstance(shape, int):
        shape = (shape,)
    return NDArray(torch.full(tuple(shape), value, dtype=torch_dtype(dtype or default_dtype()),
                              device=ctx.torch_device), ctx)


def ones(shape, ctx=None, dtype=None) -> NDArray:
    return _filled(shape, 1, ctx, dtype)


def full(shape, val, ctx=None, dtype=None) -> NDArray:
    return _filled(shape, val, ctx, dtype)


def empty(shape, ctx=None, dtype=None) -> NDArray:
    """Zeros, as the reference's ``empty`` (:615)."""
    return zeros(shape, ctx=ctx, dtype=dtype)


def eye(N, M=0, k=0, ctx=None, dtype=None) -> NDArray:
    ctx = ctx or current_context()
    M = M if M else N
    i = torch.arange(max(0, -k), min(N, M - k), device=ctx.torch_device)
    raw = torch.zeros(N, M, dtype=torch_dtype(dtype or default_dtype()), device=ctx.torch_device)
    raw[i, i + k] = 1
    return NDArray(raw, ctx)


def linspace(start, stop, num, endpoint=True, ctx=None, dtype=None) -> NDArray:
    ctx = ctx or current_context()
    dt = torch_dtype(dtype or default_dtype())
    if endpoint:
        raw = torch.linspace(start, stop, num, dtype=torch.float64)
    else:
        raw = torch.linspace(start, stop, num + 1, dtype=torch.float64)[:num]
    return NDArray(raw.to(ctx.torch_device, dt), ctx)


def concat(*arrays, dim=1):
    return invoke("Concat", list(arrays), {"dim": dim})


def stack(*arrays, axis=0):
    return invoke("stack", list(arrays), {"axis": axis})
