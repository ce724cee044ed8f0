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
``F`` the port's ``nd`` (``block.py:417-449``).

``hybridize(active, static_alloc, static_shape)`` is the reference's
CachedOp boundary (:351-375, :420-520) with CUDA graphs for compiled
programs. A hybridized block keeps ``_cached_graphs``, keyed by the
reference's ``_signature``: the inputs' (shape, dtype) and the train flag.
On a CUDA input, in predict mode (not recording, not training) and outside
a capture, the first call of a signature runs the forward eagerly on the
engine's side stream (deferred shapes, kernel builds, cuBLAS handles) and
returns its result, then captures the forward with its inputs in static
buffers (``engine.capture``, one graph memory pool a block); each later call
copies the inputs in, replays the graph and returns fresh outputs (clones:
a later replay never overwrites what a caller holds). The entry of every
other signature records why it runs the eager forward:

- ``"record"`` under ``autograd.record()`` and ``"train"`` in training
  mode: the reference's training pair (``fwd_res``/``bwd``) as a graph
  pair is ROADMAP A1b's next item;
- ``"cpu"`` for inputs on the CPU, where the kernels' plain versions run;
- ``"mesh"`` for parameters placed on a mesh of ranks, or under an active
  mesh of ranks.

Inside another capture (``engine.capturing()``), and inside a hybridized
parent's call, a block folds into the enclosing graph and adds no entry,
as the reference's folds into an enclosing trace (:428). A capture that
fails raises ``MXNetError`` with the CUDA error. ``hybridize()``,
``clear_cache()`` and ``cast()`` drop the entries, as the reference's do;
so does a call that finds a parameter's storage replaced since the capture
(``Parameter.cast``, ``_place``: the engine's ``storage_epoch`` and the
addresses), while ``set_data`` and ``initialize(force_reinit=True)`` write
in place and keep the graphs. Each call of a signature looks its graph up
in ``engine``'s cache under ``("gluon", id(block), structural fingerprint,
signature)`` (a hit or a miss in ``engine.cache_stats()``): one capture per
instance and signature.

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
from typing import Any, Dict, Optional

import torch

from .. import autograd
from .. import engine
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


class _Folding(threading.local):
    depth = 0


_FOLDING = _Folding()


class _Fold:
    """Inside it, hybridized blocks run their eager forward and add no entry:
    they fold into the call that is being run or captured."""

    def __enter__(self):
        _FOLDING.depth += 1

    def __exit__(self, *exc):
        _FOLDING.depth -= 1
        return False


def _flatten_out(out):
    """(tensors, structure) of a forward's output: an NDArray or nested
    tuples and lists of them."""
    if isinstance(out, NDArray):
        return [out._data], ("nd", out._ctx)
    if isinstance(out, (tuple, list)):
        flat, parts = [], []
        for o in out:
            f, st = _flatten_out(o)
            flat += f
            parts.append((len(f), st))
        return flat, (type(out), parts)
    raise MXNetError(f"a hybridized block returns NDArrays or tuples and lists of "
                     f"them, got {type(out).__name__}")


def _rebuild_out(flat, structure):
    kind, body = structure
    if kind == "nd":
        return NDArray(flat[0], body)
    out, i = [], 0
    for n, st in body:
        out.append(_rebuild_out(flat[i:i + n], st))
        i += n
    return kind(out)


class _CachedGraph:
    """One signature's entry: the captured graph (``graph``, an
    ``engine.GraphEntry``, held here so that the engine's weak cache keeps
    it) with its static input buffers and the output's structure, or
    ``graph`` None and ``eager`` the reason the signature runs the eager
    forward."""

    __slots__ = ("graph", "inputs", "structure", "eager")

    def __init__(self, graph=None, inputs=(), structure=None, eager=None):
        self.graph = graph
        self.inputs = inputs
        self.structure = structure
        self.eager = eager


class HybridBlock(Block):
    """reference gluon/block.py:341; ``hybridize()`` captures the predict
    forward into CUDA graphs (see the module docstring)."""

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix, params)
        self._active = False
        self._flags: Dict[str, Any] = {}
        self._cached_graphs: Dict[Any, _CachedGraph] = {}
        self._fingerprint_memo: Optional[str] = None

    def hybridize(self, active=True, static_alloc=False, static_shape=False, **kwargs):
        self._active = active
        self._flags = dict(static_alloc=static_alloc, static_shape=static_shape)
        self._drop_graphs()
        super().hybridize(active, static_alloc=static_alloc, static_shape=static_shape,
                          **kwargs)

    def clear_cache(self):
        self._drop_graphs()
        for c in self._children.values():
            if isinstance(c, HybridBlock):
                c.clear_cache()

    def cast(self, dtype):
        self._drop_graphs()
        super().cast(dtype)

    def _drop_graphs(self):
        engine.clear_compilation_cache(id(self))
        self._cached_graphs.clear()
        self._fingerprint_memo = None

    def infer_shape(self, *args):
        """Layers override this to set deferred parameter shapes from the
        inputs of their first forward."""

    def forward(self, *args, **kwargs):
        if not args or not isinstance(args[0], NDArray):
            raise MXNetError(f"{type(self).__name__}.forward expects NDArray "
                             f"input (symbolic tracing is not ported yet)")
        if self._active and not kwargs and not _FOLDING.depth and not engine.capturing():
            return self._call_cached(*args)
        return self._forward_unhybridized(*args, **kwargs)

    def _forward_unhybridized(self, *args, **kwargs):
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

    # -- the CachedOp path ------------------------------------------------------
    def _signature(self, raws):
        """The reference's: each input's (shape, dtype), and the train flag."""
        return (tuple((tuple(r.shape), str(r.dtype)) if isinstance(r, torch.Tensor)
                      else ("const", repr(r)) for r in raws), autograd.is_training())

    def _fingerprint(self) -> str:
        if self._fingerprint_memo is None:
            from ..parallel.step_program import structural_fingerprint
            self._fingerprint_memo = structural_fingerprint(self)
        return self._fingerprint_memo

    def _eager_reason(self, raws, placed: bool) -> Optional[str]:
        """Why this call runs the eager forward, or None to capture it
        (``placed``: look for a mesh of ranks too)."""
        tensors = [r for r in raws if isinstance(r, torch.Tensor)]
        if not tensors or any(t.device.type != "cuda" for t in tensors):
            return "cpu"
        if autograd.is_recording():
            return "record"
        if autograd.is_training():
            return "train"
        if placed:
            from ..parallel.mesh import active_mesh
            mesh = active_mesh()
            if (mesh is not None and mesh.distributed) or any(
                    p._mesh is not None for p in self.collect_params().values()):
                return "mesh"
        return None

    def _param_ptrs(self):
        return tuple(p._param.data_ptr() for p in self.collect_params().values()
                     if p._param is not None)

    def _call_cached(self, *args):
        raws = [a._data if isinstance(a, NDArray) else a for a in args]
        sig = self._signature(raws)
        reason = self._eager_reason(raws, placed=False)
        if reason is None:
            if engine.lookup(("gluon", id(self), self._fingerprint(), sig)) is not None:
                entry = self._cached_graphs[sig]
                for buf, r in zip(entry.inputs, raws):
                    if isinstance(r, torch.Tensor):
                        buf.copy_(r)
                outs = entry.graph.replay()
                return _rebuild_out([o.clone() for o in outs], entry.structure)
            reason = self._eager_reason(raws, placed=True)
        if reason is not None:
            self._cached_graphs.setdefault(sig, _CachedGraph(eager=reason))
            with _Fold():
                return self._forward_unhybridized(*args)
        return self._capture(sig, args, raws)

    def _capture(self, sig, args, raws):
        """The first call of ``sig`` (or the first after its graph went
        stale): the eager forward on the side stream (returned), then the
        capture of the forward on static inputs."""
        device = next(r.device for r in raws if isinstance(r, torch.Tensor))
        with _Fold(), engine.side_stream(device):
            out = self._forward_unhybridized(*args)
        _, structure = _flatten_out(out)
        static = [r.clone() if isinstance(r, torch.Tensor) else r for r in raws]
        self._fingerprint_memo = None           # deferred shapes are known now

        def run():
            with _Fold():
                o = self._forward_unhybridized(*[NDArray(t) if isinstance(t, torch.Tensor)
                                                 else t for t in static])
            return _flatten_out(o)[0]
        graph = engine.capture(run, ("gluon", id(self), self._fingerprint(), sig), device,
                               owner=self, ptrs=HybridBlock._param_ptrs)
        self._cached_graphs[sig] = _CachedGraph(graph, static, structure)
        return out
