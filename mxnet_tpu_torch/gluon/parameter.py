"""Parameter / ParameterDict.

Counterpart of ``mxnet_tpu/gluon/parameter.py:27-334``. A ``Parameter``
holds its value as a ``torch.nn.Parameter``. Assigned as an attribute of a
``Block`` (``self.weight = self.params.get("weight", ...)``), it is also
registered in that module's ``_parameters`` under the same attribute name,
so ``state_dict()`` keys equal the reference's structural paths
(``encoder.layers.0.attn.qkv.weight``). The ``nn.Parameter`` keeps its
identity for the life of the ``Parameter``: ``set_data`` copies into it and
``cast`` swaps its ``.data``, as ``torch.nn.Module.to`` does.

Gradients (reference :104-179): a parameter whose ``grad_req`` is not
``"null"`` gets its gradient buffer when it is initialized (or first given
data), a tensor of its shape and dtype on its device, and its
``nn.Parameter`` becomes an autograd variable with that buffer
(``autograd.mark_variables``): ``autograd.backward`` writes or adds into
it, never into torch's ``.grad``. ``grad()`` and ``list_grad()`` return it,
``zero_grad()`` zeroes it, and setting ``grad_req`` allocates or drops it.
Optimizer updates write into the ``nn.Parameter`` in place.

Deferred initialization (reference :48, :83-94): ``initialize()`` on a
parameter whose shape has a 0 dim and that allows it
(``allow_deferred_init=True``, as every layer's parameters do) records the
initializer and context and returns; ``data()`` then raises
``DeferredInitializationError``, and the layer's first forward sets the
shape from its input (``HybridBlock.infer_shape``) and calls
``_finish_deferred_init``. An incomplete shape without
``allow_deferred_init`` still raises at ``initialize()``.
``ParameterDict.save``/``load`` write and read the reference's file
format (``serialization.py``). ``Constant`` waits for a later slice.

A compute copy (``_compute``) stands in for the value while it is set:
``data()`` returns it. ``parallel.DataParallelTrainer`` sets it to the
parameter cast to its compute dtype (bfloat16, float16) for the forward of
a step, so the layers compute in that dtype while autograd carries the
gradient through the cast to the float32 value (the reference swaps the
cast arrays into the parameters, ``_make_apply_fn``).

Storage: giving a parameter's value or gradient buffer new storage (first
materialization, ``cast``, ``_place``, a gradient buffer made anew) moves
``engine.storage_epoch()``. A CUDA graph reads tensors by address, so the
engine then compares a captured block's or step's addresses with the
capture's and drops the graph if one changed; ``set_data`` and
``initialize(force_reinit=True)`` copy in place and keep the graphs.

Sharding: ``sharding`` is a ``PartitionSpec`` (``parallel.P``), None for a
replicated parameter; ``parallel.shard_params_megatron`` sets it and nothing
else, as in the reference. A ``DataParallelTrainer`` on a mesh of ranks then
places the parameter (``_place``): its value becomes this rank's shard, a
contiguous tensor of its own (a row-parallel weight's slice of dim 1 is
copied), with a gradient buffer of the shard's shape, and ``_mesh`` names
the mesh. ``shape`` stays the full shape.
"""
from __future__ import annotations

import weakref
from collections import OrderedDict
from typing import Dict, List, Optional

import numpy as _np
import torch

from ..base import MXNetError, torch_dtype
from ..context import Context, current_context
from ..ndarray import NDArray
from .. import engine
from .. import initializer as init_mod
from ..initializer import InitDesc


class DeferredInitializationError(MXNetError):
    """A parameter's shape waits for the first forward (reference
    gluon/parameter.py DeferredInitializationError)."""


class Parameter:
    def __init__(self, name, grad_req="write", shape=None, dtype="float32",
                 lr_mult=1.0, wd_mult=1.0, init=None, allow_deferred_init=False,
                 differentiable=True, stype="default", grad_stype="default"):
        self.name = name
        if grad_req not in ("write", "add", "null"):
            raise MXNetError(f"invalid grad_req {grad_req}")
        self._grad_req = grad_req if differentiable else "null"
        if isinstance(shape, int):
            shape = (shape,)
        self.shape = tuple(shape) if shape is not None else None
        self.dtype = dtype
        self.lr_mult = lr_mult
        self.wd_mult = wd_mult
        self.init = init
        self.allow_deferred_init = allow_deferred_init
        self.stype = stype
        self.grad_stype = grad_stype
        self.attrs: Dict[str, str] = {}
        self._param: Optional[torch.nn.Parameter] = None
        self._grad: Optional[torch.Tensor] = None
        self._deferred_init = None   # (init, ctx, default_init) until the shape is known
        self._compute: Optional[torch.Tensor] = None   # stands in for the value in data()
        self.sharding = None     # PartitionSpec over mesh axes, None: replicated
        self._mesh = None        # the mesh whose rank's shard the value is, once placed
        # (block, attribute name) pairs whose _parameters entry is this value
        self._owners: List[tuple] = []

    @property
    def grad_req(self):
        return self._grad_req

    @grad_req.setter
    def grad_req(self, req):
        if req not in ("write", "add", "null"):
            raise MXNetError(f"invalid grad_req {req}")
        self._grad_req = req
        if self._param is not None:
            self._init_grad()

    def _shape_complete(self):
        return self.shape is not None and all(s > 0 for s in self.shape)

    # -- ownership by modules --------------------------------------------------
    def _attach(self, block, name):
        self._owners.append((weakref.ref(block), name))
        block._parameters[name] = self._param

    def _adopt(self, tensor: torch.Tensor):
        """Make ``tensor`` this parameter's value (first materialization)."""
        self._param = torch.nn.Parameter(tensor,
                                         requires_grad=self._grad_req != "null")
        engine.note_storage_change()
        for ref, name in self._owners:
            block = ref()
            if block is not None:
                block._parameters[name] = self._param
        self._init_grad()

    def _init_grad(self):
        """Allocate (or drop, for ``"null"``) the gradient buffer and make the
        ``nn.Parameter`` a variable with it (reference :118-127)."""
        from .. import autograd
        if self._grad_req == "null":
            self._grad = None
        elif self._grad is None or self._grad.shape != self._param.shape \
                or self._grad.dtype != self._param.dtype:
            self._grad = torch.zeros_like(self._param, requires_grad=False)
            engine.note_storage_change()
        autograd._mark(self._param, self._grad, self._grad_req)

    def _place(self, mesh) -> None:
        """Keep this rank's shard of the value under ``sharding`` on ``mesh``,
        in storage of its own, with a gradient buffer of its shape."""
        from ..parallel.tensor_parallel import shard_tensor
        self._check_initialized()
        if self._mesh is not None:
            raise MXNetError(f"parameter '{self.name}' is already placed on {self._mesh}")
        shard = shard_tensor(self._param.detach(), self.sharding, mesh)
        self._param.data = shard.clone(memory_format=torch.contiguous_format)
        engine.note_storage_change()
        self._mesh = mesh
        self._init_grad()

    # -- init ----------------------------------------------------------------
    def initialize(self, init=None, ctx=None, default_init=None,
                   force_reinit=False):
        if self._param is not None and not force_reinit:
            return
        if isinstance(ctx, (list, tuple)):
            if len(ctx) != 1:
                raise MXNetError(f"parameter '{self.name}': one context per "
                                 f"parameter (multi-device replicas come with "
                                 f"the data-parallel slice), got {ctx}")
            ctx = ctx[0]
        ctx = ctx or current_context()
        if not self._shape_complete():
            if self.allow_deferred_init:
                ctx.torch_device   # an unusable context raises now, not at the forward
                self._deferred_init = (init, ctx, default_init)
                return
            raise MXNetError(
                f"cannot initialize parameter '{self.name}' with incomplete "
                f"shape {self.shape}: give the layer its input width "
                f"(in_units/in_channels) or allow_deferred_init")
        self._deferred_init = None
        data = NDArray(torch.zeros(self.shape, dtype=torch_dtype(self.dtype),
                                   device=ctx.torch_device), ctx)
        initializer = init_mod.create(
            init if init is not None else
            (self.init if self.init is not None else
             (default_init or init_mod.Uniform())))
        initializer(InitDesc(self.name, self.attrs), data)
        if self._param is None:
            self._adopt(data._data)
        else:
            with torch.no_grad():
                self._param.copy_(data._data)

    def _finish_deferred_init(self):
        """Initialize with the initializer and context recorded by
        ``initialize()``, now that the first forward has set the shape."""
        if self._deferred_init is None:
            return
        init, ctx, default_init = self._deferred_init
        if not self._shape_complete():
            raise MXNetError(f"parameter '{self.name}': shape {self.shape} is "
                             f"still incomplete after shape inference")
        self.initialize(init, ctx, default_init)

    # -- access --------------------------------------------------------------
    def _check_initialized(self):
        if self._param is None and self._deferred_init is not None:
            raise DeferredInitializationError(
                f"parameter '{self.name}' has shape {self.shape}, deferred "
                f"until the first forward; call the block on an input or give "
                f"the layer its input width (in_units/in_channels)")
        if self._param is None:
            raise MXNetError(f"parameter '{self.name}' has not been "
                             f"initialized; call .initialize() first")

    def data(self, ctx=None) -> NDArray:
        self._check_initialized()
        return NDArray(self._param if self._compute is None else self._compute)

    def grad(self, ctx=None) -> NDArray:
        self._check_initialized()
        if self._grad is None:
            raise MXNetError(f"parameter '{self.name}' has grad_req='null'")
        return NDArray(self._grad)

    def list_grad(self):
        return [self.grad()]

    def list_ctx(self):
        self._check_initialized()
        return [Context.from_device(self._param.device)]

    def zero_grad(self):
        if self._grad is not None:
            self._grad.zero_()

    def set_data(self, data):
        """Copy ``data`` (NDArray, torch.Tensor or numpy array) in, cast to
        this parameter's dtype and moved to its device."""
        if isinstance(data, NDArray):
            data = data._data
        elif not isinstance(data, torch.Tensor):
            data = torch.from_numpy(_np.ascontiguousarray(_np.asarray(data)))
        if self._shape_complete() and tuple(data.shape) != tuple(self.shape):
            raise MXNetError(f"shape mismatch for '{self.name}': "
                             f"{tuple(data.shape)} vs {self.shape}")
        self.shape = tuple(data.shape)
        if self._param is None and self._deferred_init is not None:
            self._finish_deferred_init()
        if self._param is None:
            device = data.device if data.device.type != "cpu" \
                else current_context().torch_device
            self._adopt(data.to(device, torch_dtype(self.dtype), copy=True))
        else:
            with torch.no_grad():
                self._param.copy_(data)

    def cast(self, dtype):
        self.dtype = dtype
        if self._param is not None:
            self._param.data = self._param.data.to(torch_dtype(dtype))
            engine.note_storage_change()
            self._init_grad()

    def __repr__(self):
        return f"Parameter {self.name} (shape={self.shape}, dtype={self.dtype})"


class ParameterDict:
    def __init__(self, prefix="", shared=None):
        self._prefix = prefix
        self._params: "OrderedDict[str, Parameter]" = OrderedDict()
        self._shared = shared

    @property
    def prefix(self):
        return self._prefix

    def items(self):
        return self._params.items()

    def keys(self):
        return self._params.keys()

    def values(self):
        return self._params.values()

    def __iter__(self):
        return iter(self._params)

    def __len__(self):
        return len(self._params)

    def __getitem__(self, key):
        return self._params[key]

    def __contains__(self, key):
        return key in self._params

    def get(self, name, **kwargs) -> Parameter:
        full = self._prefix + name
        if full in self._params:
            return self._params[full]
        if self._shared is not None and full in self._shared:
            p = self._params[full] = self._shared[full]
            return p
        p = self._params[full] = Parameter(full, **kwargs)
        return p

    def update(self, other):
        for k, v in other.items():
            if k in self._params and self._params[k] is not v:
                raise MXNetError(f"duplicate parameter name {k}")
            self._params[k] = v

    def initialize(self, init=None, ctx=None, verbose=False, force_reinit=False):
        for p in self._params.values():
            p.initialize(init=None, ctx=ctx,
                         default_init=init or init_mod.Uniform(),
                         force_reinit=force_reinit)

    def zero_grad(self):
        for p in self._params.values():
            p.zero_grad()

    def save(self, filename, strip_prefix=""):
        """The parameters under ``arg:<name>`` (``strip_prefix`` taken off
        the names that start with it) in the reference's file format
        (reference parameter.py:308)."""
        from ..serialization import save_ndarrays
        d = {}
        for name, p in self._params.items():
            key = name[len(strip_prefix):] if name.startswith(strip_prefix) else name
            d["arg:" + key] = p.data()
        save_ndarrays(filename, d)

    def load(self, filename, ctx=None, allow_missing=False, ignore_extra=False,
             restore_prefix=""):
        """Load a file of ``save`` (either package's), ``restore_prefix``
        put before each name (reference :316)."""
        from ..serialization import load_tensors
        loaded = load_tensors(filename)
        loaded = {restore_prefix + (k.split(":", 1)[1] if ":" in k else k): v
                  for k, v in loaded.items()}
        for name, p in self._params.items():
            if name in loaded:
                p.set_data(loaded[name])
            elif not allow_missing:
                raise MXNetError(f"parameter {name} missing from {filename}")
        if not ignore_extra:
            extra = set(loaded) - set(self._params)
            if extra:
                raise MXNetError(f"extra parameters in file: {sorted(extra)[:5]}")

    def __repr__(self):
        lines = [f"  {p}" for p in self._params.values()]
        return "ParameterDict(\n" + "\n".join(lines) + "\n)"
