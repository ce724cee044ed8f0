"""Block / HybridBlock.

Counterpart of ``mxnet_tpu/gluon/block.py``. ``Block`` is a
``torch.nn.Module``:

- child blocks live in the module's ``_modules`` (``_children`` is that
  dict), so ``named_modules()``, ``state_dict()`` and ``.to()`` see them;
- a Gluon ``Parameter`` assigned as an attribute is kept in ``_reg_params``
  (for ``hybrid_forward``) and its ``nn.Parameter`` in ``_parameters`` under
  the same name, so ``state_dict()`` keys equal the structural names of
  ``_collect_params_with_prefix`` (``block.py:227-237``);
- forward hooks are torch's own (same ``hook(block, args[, out])``
  signature), returned as a ``HookHandle`` with the reference's ``detach()``.

``HybridBlock.forward`` calls ``hybrid_forward(F, *args, **params)`` with
``F`` the port's ``nd`` (``block.py:417-449``). ``hybridize()`` is accepted
and runs eagerly: no ``torch.compile`` and no CUDA graphs yet (ROADMAP A4).

Deferred shape inference (reference :377-447): a layer whose parameter
still waits for its shape resolves it at its first forward, eagerly and
block by block: ``infer_shape(*args)`` sets the shapes from the input, the
parameters initialize as ``initialize()`` asked, and the forward runs. The
reference's abstract shape probe of the whole tree has no counterpart:
the first forward is a real one.

``defer_aux_update(param, value)`` (reference :57-64) writes a new value
into a parameter that is state, not weight (BatchNorm's running stats): in
place, under ``torch.no_grad()``, into the parameter's own tensor in its
own dtype, also while a compute copy stands in for it.

Left for later slices: symbolic tracing and ``export``, ``SymbolBlock``,
``name_scope`` prefixes nested under a parent (each block takes a
process-wide ``<class><n>_`` prefix), ``summary``.

``save_parameters`` writes ``{structural name: tensor}`` with
``torch.save``; files in the reference's MXNet ``.params`` format wait for
the slice that ports ``serialization.py`` (``convert.load_jax_params`` takes
the reference's weights as numpy arrays).
"""
from __future__ import annotations

import re
import threading
from collections import OrderedDict
from typing import Dict, Optional

import torch

from ..base import MXNetError
from ..ndarray import NDArray
from .. import ndarray as nd
from .parameter import DeferredInitializationError, Parameter, ParameterDict


def defer_aux_update(param: Parameter, new_value: torch.Tensor) -> None:
    """Write ``new_value`` into ``param``'s tensor in place, outside autograd."""
    param._check_initialized()
    with torch.no_grad():
        param._param.copy_(new_value)


class _NameManager:
    _lock = threading.Lock()
    _counters: Dict[str, int] = {}

    @classmethod
    def fresh(cls, hint: str) -> str:
        with cls._lock:
            i = cls._counters.get(hint, 0)
            cls._counters[hint] = i + 1
        return f"{hint}{i}_"


class HookHandle:
    """Detachable hook registration (reference gluon/utils.py HookHandle)."""

    def __init__(self, handle):
        self._handle = handle

    def detach(self):
        self._handle.remove()

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.detach()
        return False


class Block(torch.nn.Module):
    """Base container (reference gluon/block.py:228) as a torch Module."""

    def __init__(self, prefix: Optional[str] = None,
                 params: Optional[ParameterDict] = None):
        super().__init__()
        self._prefix = prefix if prefix is not None \
            else _NameManager.fresh(type(self).__name__.lower())
        self._params = ParameterDict(self._prefix, shared=params)
        self._reg_params: "OrderedDict[str, Parameter]" = OrderedDict()

    # -- naming / params -----------------------------------------------------
    @property
    def prefix(self):
        return self._prefix

    @property
    def name(self):
        return self._prefix[:-1] if self._prefix.endswith("_") else self._prefix

    @property
    def params(self) -> ParameterDict:
        return self._params

    @property
    def _children(self):
        return self._modules

    def __setattr__(self, name, value):
        reg = self.__dict__.get("_reg_params")
        if isinstance(value, Parameter):
            if reg is None:
                raise MXNetError("Block.__init__ must run before a Parameter "
                                 "is assigned")
            self._modules.pop(name, None)
            reg[name] = value
            object.__setattr__(self, name, value)
            value._attach(self, name)
            return
        if reg is not None and name in reg:
            # rebinding a parameter attribute: drop both registrations
            del reg[name]
            del self._parameters[name]
            object.__delattr__(self, name)
        super().__setattr__(name, value)

    def register_child(self, block, name=None):
        self.add_module(name or str(len(self._modules)), block)

    def register_forward_hook(self, hook):
        return HookHandle(super().register_forward_hook(hook))

    def register_forward_pre_hook(self, hook):
        return HookHandle(super().register_forward_pre_hook(hook))

    def collect_params(self, select: Optional[str] = None) -> ParameterDict:
        ret = ParameterDict(self._params.prefix)
        if select is None:
            ret.update(self._params)
        else:
            pattern = re.compile(select)
            ret.update({k: v for k, v in self._params.items() if pattern.match(k)})
        for child in self._modules.values():
            if isinstance(child, Block):
                ret.update(child.collect_params(select))
        return ret

    def _collect_params_with_prefix(self, prefix="") -> "OrderedDict[str, Parameter]":
        """Structural names ('encoder.layers.0.attn.qkv.weight'), stable across
        instances whatever the global name counters say."""
        if prefix:
            prefix += "."
        ret = OrderedDict()
        for name, p in self._reg_params.items():
            ret[prefix + name] = p
        for cname, child in self._modules.items():
            if isinstance(child, Block):
                ret.update(child._collect_params_with_prefix(prefix + cname))
        return ret

    # -- lifecycle -----------------------------------------------------------
    def initialize(self, init=None, ctx=None, verbose=False, force_reinit=False):
        from .. import initializer as init_mod
        self.collect_params().initialize(init or init_mod.Uniform(), ctx,
                                         verbose, force_reinit)

    def hybridize(self, active=True, **kwargs):
        for child in self._modules.values():
            if isinstance(child, Block):
                child.hybridize(active, **kwargs)

    def cast(self, dtype):
        for child in self._modules.values():
            if isinstance(child, Block):
                child.cast(dtype)
        for p in self._reg_params.values():
            p.cast(dtype)

    # -- checkpointing ---------------------------------------------------------
    def save_parameters(self, filename):
        params = self._collect_params_with_prefix()
        torch.save({k: p.data()._data.detach().cpu() for k, p in params.items()},
                   filename)

    def load_parameters(self, filename, ctx=None, allow_missing=False,
                        ignore_extra=False):
        loaded = torch.load(filename, map_location="cpu", weights_only=True)
        params = self._collect_params_with_prefix()
        for key, p in params.items():
            if key in loaded:
                p.set_data(loaded[key])
            elif not allow_missing:
                raise MXNetError(f"parameter {p.name} ({key}) missing in {filename}")
        if not ignore_extra:
            extra = set(loaded) - set(params)
            if extra:
                raise MXNetError(f"extra parameters in file: {sorted(extra)[:5]}")

    save_params = save_parameters
    load_params = load_parameters

    def forward(self, *args, **kwargs):
        raise NotImplementedError


class HybridBlock(Block):
    """reference gluon/block.py:341; hybridize() is accepted, runs eagerly."""

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix, params)
        self._active = False

    def hybridize(self, active=True, **kwargs):
        self._active = active
        super().hybridize(active, **kwargs)

    def infer_shape(self, *args):
        """Layers override this to set deferred parameter shapes from the
        inputs of their first forward."""

    def forward(self, *args, **kwargs):
        if not args or not isinstance(args[0], NDArray):
            raise MXNetError(f"{type(self).__name__}.forward expects NDArray "
                             f"input (symbolic tracing is not ported yet)")
        for name, p in self._reg_params.items():
            try:
                kwargs[name] = p.data()
            except DeferredInitializationError:
                self.infer_shape(*args)
                p._finish_deferred_init()
                kwargs[name] = p.data()
        return self.hybrid_forward(nd, *args, **kwargs)

    def hybrid_forward(self, F, x, *args, **kwargs):
        raise NotImplementedError
