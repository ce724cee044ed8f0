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
reference's ``_signature`` (the inputs' (shape, dtype) and the train flag)
with, under ``autograd.record()``, which inputs need a gradient and whether
``MXNET_TPU_REMAT_BWD`` is on. On a CUDA input and outside a capture:

- a forward outside ``record()`` (predict or training mode): the first call
  of a signature runs the forward eagerly on the engine's side stream
  (deferred shapes, kernel builds, cuBLAS handles) and returns its result,
  then captures the forward with its inputs in static buffers
  (``engine.capture``, one graph memory pool a block); each later call
  copies the inputs in, replays the graph and returns fresh outputs (clones:
  a later replay never overwrites what a caller holds). In training mode
  BatchNorm's batch statistics and its running-stat update
  (``defer_aux_update``) and Dropout's draws run inside the graph;
- under ``record()``, the reference's training pair ``fwd_res``/``bwd``
  (:499-713) as a pair of graphs: the first calls run eagerly on the side
  stream until a backward has run through one of them (the entry's reason is
  ``"backward"``: the backward's kernels, handles and workspaces are set up
  by that run, as the forward's are by the first call). The next call
  captures a forward graph (the forward recorded by autograd, its
  activations in a pool of the pair's own) and a backward graph
  (``torch.autograd.grad`` of the outputs against the inputs that need a
  gradient and the parameters that take one), then replays the forward;
  each call after that copies the inputs in and replays the forward, and
  its outputs join the tape through one ``torch.autograd.Function``, whose
  backward copies the head gradients in and replays the backward graph.
  The tape then lands the parameters' gradients by each one's ``grad_req``
  (``write``, ``add``) and an input's (``attach_grad``) in its buffer.
  A replay overwrites the activations the previous one left: while the
  Function of a replay may still run its backward (its saved state is not
  released: no backward yet, or one with ``retain_graph=True``), the next
  call takes another slot, a pair of graphs in a pool of its own, captured
  at its first use; ``_MAX_IN_FLIGHT`` slots a signature, a call beyond them
  runs eagerly (reason ``"in_flight"``). With ``MXNET_TPU_REMAT_BWD=1``
  (read at each call, as the reference reads it) the forward graph runs the
  forward under non-reentrant ``torch.utils.checkpoint`` and keeps no
  activations, and the backward graph runs the forward again (no running
  statistics written the second time; the device generator is set back to
  where the forward replay started, so Dropout draws the same masks).

A signature's FLOPs are counted once (``engine.count_flops``), as the
reference takes the cost of its compiled forward and vjp once (:527-587).
Where a graph is captured they are counted whatever telemetry's flag, since
a replay runs no Python: the forward over its eager first call, a training
pair's backward over the capture of its backward graph (the recompute of a
rematerialized one included). An eager call counts them with telemetry on:
the forward over the signature's first call, under ``record()`` the
backward by ``engine.count_backward`` over that call's graph. Each replay or
eager call adds them to the engine's ``flops_executed``
(``engine.record_execution``): the forward at the call, the backward when
the backward reaches the outputs. The warm call's backward, which runs
before its count exists, is booked at twice its forward and flagged
``estimated``, the reference's fallback. Inside a trainer's step
(``parallel``) blocks fold into the step, which counts and books the whole.

The entry of a signature that runs the eager forward records why (the
last call's reason, ``eager``):

- ``"cpu"`` for inputs on the CPU, where the kernels' plain versions run;
- ``"mesh"`` for parameters placed on a mesh of ranks, or under an active
  mesh of ranks;
- ``"backward"``, ``"in_flight"`` (above), and ``"compute"``: a trainer's
  compute copy (``Parameter._compute``, made anew each step) stands in for
  a parameter.

Inside another capture (``engine.capturing()``), and inside a hybridized
parent's call, a block folds into the enclosing graph and adds no entry,
as the reference's folds into an enclosing trace (:428). A capture or a
replay that fails raises ``MXNetError`` with the CUDA error; nothing is
retried eagerly. ``hybridize()``, ``clear_cache()`` and ``cast()`` drop the
entries, as the reference's do; so does a call that finds a parameter's
storage replaced since the capture (``Parameter.cast``, ``_place``: the
engine's ``storage_epoch`` and the addresses), while ``set_data`` and
``initialize(force_reinit=True)`` write in place and keep the graphs. Each
call of a signature looks its graph up in ``engine``'s cache under
``("gluon", id(block), structural fingerprint, signature)`` (with the
slot's index and ``"fwd"``/``"bwd"`` for a pair; a hit or a miss in
``engine.cache_stats()``): one capture per instance and signature.

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

Naming: a block made inside a parent's ``with self.name_scope():`` takes
the parent's prefix and counters (``_BlockScope``, reference :79-120);
outside every scope the process-wide ``<class><n>_``. The structural names
of ``_collect_params_with_prefix`` (which ``convert``, the tensor-parallel
roles and the elastic manifests key by) do not depend on either.

``save_parameters``/``load_parameters`` read and write the reference's
``.params`` file (``serialization.py``, keys ``arg:<structural name>``);
a file of either package loads in the other.

Left for later slices: symbolic tracing and ``export``, ``SymbolBlock``,
``summary``.
"""
from __future__ import annotations

import contextlib
import os
import re
import threading
import weakref
from collections import OrderedDict
from typing import Any, Dict, Optional

import torch

from .. import autograd
from .. import engine
from .. import telemetry as _telem
from ..base import MXNetError
from ..ndarray import NDArray
from .. import ndarray as nd
from .parameter import DeferredInitializationError, Parameter, ParameterDict


class _AuxFrozen(threading.local):
    depth = 0


_AUX_FROZEN = _AuxFrozen()


def defer_aux_update(param: Parameter, new_value: torch.Tensor) -> None:
    """Write ``new_value`` into ``param``'s tensor in place, outside autograd
    (not in the rematerialized backward's second run of a forward)."""
    param._check_initialized()
    if _AUX_FROZEN.depth:
        return
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


class _BlockScope:
    """Nested naming (reference ``_BlockScope``, block.py:79-120): a block
    made inside a parent's ``with self.name_scope():`` takes the parent's
    prefix before its own and its counter from the parent's counters, so
    ``Net(prefix='mynet_')`` yields ``mynet_dense0_weight``; outside every
    scope a block takes the process-wide ``<class><n>_``."""

    _tls = threading.local()

    def __init__(self, block: "Block"):
        self._block = weakref.ref(block)
        self._counters: Dict[str, int] = {}

    @classmethod
    def _stack(cls):
        st = getattr(cls._tls, "stack", None)
        if st is None:
            st = cls._tls.stack = []
        return st

    @classmethod
    def create_prefix(cls, prefix: Optional[str], hint: str) -> str:
        st = cls._stack()
        if not st:
            return prefix if prefix is not None else _NameManager.fresh(hint)
        scope = st[-1]
        if prefix is None:
            i = scope._counters.get(hint, 0)
            scope._counters[hint] = i + 1
            prefix = f"{hint}{i}_"
        return scope._block().prefix + prefix

    def __enter__(self):
        self._stack().append(self)
        return self

    def __exit__(self, *a):
        self._stack().pop()
        return False


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
        self._prefix = _BlockScope.create_prefix(prefix, type(self).__name__.lower())
        self._params = ParameterDict(self._prefix, shared=params)
        self._reg_params: "OrderedDict[str, Parameter]" = OrderedDict()
        self._scope = _BlockScope(self)

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

    def name_scope(self):
        return self._scope

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
    def save_parameters(self, filename, deduplicate=False):
        """The parameters under ``arg:<structural name>`` in the reference's
        file format (``serialization.py``; reference block.py:239)."""
        from ..serialization import save_ndarrays
        save_ndarrays(filename, {"arg:" + k: p.data()
                                 for k, p in self._collect_params_with_prefix().items()})

    def load_parameters(self, filename, ctx=None, allow_missing=False,
                        ignore_extra=False, cast_dtype=False, dtype_source="current"):
        """Load a file of ``save_parameters`` (either package's), copied into
        each parameter in its dtype and on its device (reference :246)."""
        from ..serialization import load_tensors
        loaded = load_tensors(filename)
        loaded = {k.split(":", 1)[1] if ":" in k else k: v for k, v in loaded.items()}
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


class _FreezeAux:
    """Inside it ``defer_aux_update`` writes nothing: the rematerialized
    backward's second run of a forward."""

    def __enter__(self):
        _AUX_FROZEN.depth += 1

    def __exit__(self, *exc):
        _AUX_FROZEN.depth -= 1
        return False


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
    """One signature's entry: the captured forward graph (``graph``, an
    ``engine.GraphEntry``, held here so that the engine's weak cache keeps
    it) with its static input buffers and the output's structure; or, under
    ``record()``, the training pair's state (``pair``, a ``_Pair``); and
    ``eager``, the reason the last call ran the eager forward (None when it
    replayed)."""

    __slots__ = ("graph", "inputs", "structure", "eager", "pair", "flops", "bwd_flops")

    def __init__(self, graph=None, inputs=(), structure=None, eager=None, pair=None,
                 flops=None):
        self.graph = graph
        self.inputs = inputs
        self.structure = structure
        self.eager = eager
        self.pair = pair
        self.flops = flops            # the forward's and the backward's, None until
        self.bwd_flops = None         # counted


_MAX_IN_FLIGHT = 4
_REMAT_ENV = "MXNET_TPU_REMAT_BWD"


def _remat_on() -> bool:
    return os.environ.get(_REMAT_ENV, "") not in ("", "0")


class _Slot:
    """One pair of graphs of a signature, in a memory pool of its own:
    ``fwd`` (the static tensor ``inputs`` -> outputs, activations kept in the
    pool) and ``bwd`` (head gradients in ``gouts`` -> the gradients of the
    inputs at ``wrt_inputs`` and of the parameters that take one; None
    where the forward does not reach one). ``used_inputs`` and ``used``
    (indices into those parameters, whose tensors are ``leaves``) name the
    gradients that are not None: only those join the tape. ``ctx`` refers
    weakly to the autograd node of the last forward replay, which holds the
    slot while its saved state lives (``busy``). Indices count tensor
    inputs only."""

    __slots__ = ("index", "fwd", "bwd", "inputs", "wrt_inputs", "used_inputs", "out_diff",
                 "gouts", "leaves", "used", "remat", "gen", "gen_state", "token", "ctx",
                 "flops", "bwd_flops")

    def __init__(self, index):
        self.index = index
        self.ctx = None
        self.gen_state = None
        self.flops = self.bwd_flops = 0.0     # counted at the warm call and the capture

    def busy(self) -> bool:
        node = self.ctx() if self.ctx is not None else None
        if node is None:
            return False
        try:
            node.saved_tensors
        except RuntimeError:          # released: its backward ran without retain_graph
            return False
        return True


class _Pair:
    """The training pair's state of one signature: ``warm`` once a backward
    ran through an eager call, the structure of the outputs, the parameters
    (with the ``requires_grad`` flags the slots were captured with) and the
    slots."""

    __slots__ = ("warm", "structure", "params", "reqs", "slots", "flops", "__weakref__")

    def __init__(self):
        self.warm = False
        self.structure = None
        self.params = None
        self.reqs = None
        self.slots = []
        self.flops = None             # the forward's, counted at the warm call


class _PairCall(torch.autograd.Function):
    """A replay of a slot's forward graph on the tape: ``apply(slot, *inputs,
    *leaves)``; the backward replays the slot's backward graph. Under
    ``grad(create_graph=True)`` it raises the reference's ``MXNetError``
    (hybridized-block forwards have no re-differentiable form)."""

    @staticmethod
    def forward(ctx, slot, *tensors):
        for buf, t in zip(slot.inputs, tensors):
            buf.copy_(t)
        if slot.remat:
            slot.gen_state = slot.gen.get_state()
        outs = [o.clone() for o in slot.fwd.replay()]
        engine.record_execution("fwd", slot.flops)
        ctx.slot = slot
        ctx.save_for_backward(slot.token)
        slot.ctx = weakref.ref(ctx)
        ctx.mark_non_differentiable(*[o for o, d in zip(outs, slot.out_diff) if not d])
        return tuple(outs)

    @staticmethod
    def backward(ctx, *grads):
        if torch.is_grad_enabled():         # create_graph: a replay has no derivative
            raise MXNetError(autograd._NO_SECOND_ORDER)
        ctx.saved_tensors         # raises after a backward that released them, as eager does
        slot = ctx.slot
        for buf, g in zip(slot.gouts, [g for g, d in zip(grads, slot.out_diff) if d]):
            if g is None:
                buf.zero_()
            else:
                buf.copy_(g)
        if slot.remat:                # the recompute draws the forward replay's masks
            now = slot.gen.get_state()
            slot.gen.set_state(slot.gen_state)
            try:
                got = slot.bwd.replay()
            finally:
                slot.gen.set_state(now)
        else:
            got = slot.bwd.replay()
        engine.record_execution("bwd", slot.bwd_flops)
        got = [g.clone() if g is not None else None for g in got]
        n = len(slot.wrt_inputs)
        out = [None] * (1 + len(slot.inputs))
        for i, g in zip(slot.wrt_inputs, got[:n]):
            out[1 + i] = g
        return tuple(out + [got[n + k] for k in slot.used])


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
        """The reference's (each input's (shape, dtype), and the train flag),
        and under ``record()`` which inputs need a gradient and whether the
        backward rematerializes."""
        ins = tuple((tuple(r.shape), str(r.dtype)) if isinstance(r, torch.Tensor)
                    else ("const", repr(r)) for r in raws)
        if not autograd.is_recording():
            return ins, autograd.is_training(), None, False
        needs = tuple(isinstance(r, torch.Tensor) and r.requires_grad for r in raws)
        return ins, autograd.is_training(), needs, _remat_on()

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
        if sig[2] is not None:
            return self._call_recorded(sig, args, raws)
        reason = self._eager_reason(raws, placed=False)
        if reason is None:
            if engine.lookup(("gluon", id(self), self._fingerprint(), sig)) is not None:
                entry = self._cached_graphs[sig]
                for buf, r in zip(entry.inputs, raws):
                    if isinstance(r, torch.Tensor):
                        buf.copy_(r)
                outs = entry.graph.replay()
                engine.record_execution("fwd", entry.flops)
                return _rebuild_out([o.clone() for o in outs], entry.structure)
            reason = self._eager_reason(raws, placed=True)
        if reason is not None:
            entry = self._cached_graphs.setdefault(sig, _CachedGraph(eager=reason))
            return self._eager(entry, args, raws)
        return self._capture(sig, args, raws)

    def _capture(self, sig, args, raws):
        """The first call of ``sig`` (or the first after its graph went
        stale): the eager forward on the side stream (returned), then the
        capture of the forward on static inputs."""
        device = next(r.device for r in raws if isinstance(r, torch.Tensor))
        with _Fold(), engine.side_stream(device), engine.count_flops() as fc:
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
        self._cached_graphs[sig] = _CachedGraph(graph, static, structure, flops=fc.total)
        return out

    # -- the training pair ---------------------------------------------------------
    def _call_recorded(self, sig, args, raws):
        """A call under ``record()`` (see the module docstring)."""
        entry = self._cached_graphs.get(sig)
        if entry is None:
            entry = self._cached_graphs[sig] = _CachedGraph()
        reason = self._eager_reason(raws, placed=entry.pair is None)
        if reason is None:
            if entry.pair is None:
                entry.pair = _Pair()
            pair = entry.pair
            if not pair.warm:
                reason = "backward"
            elif any(p._compute is not None
                     for p in pair.params or self.collect_params().values()):
                reason = "compute"
            else:
                slot = self._pair_slot(sig, pair, raws)
                if slot is None:
                    reason = "in_flight"
        entry.eager = reason
        if reason == "backward":
            return self._warm_call(entry.pair, args, raws)
        if reason is not None:
            return self._eager(entry, args, raws, recorded=True)
        tensors = [t if k in slot.used_inputs else t.detach() for k, t in
                   enumerate(r for r in raws if isinstance(r, torch.Tensor))]
        with torch.enable_grad():
            outs = _PairCall.apply(slot, *tensors, *slot.leaves)
        return _rebuild_out(list(outs), pair.structure)

    def _warm_call(self, pair, args, raws):
        """An eager call on the side stream before the signature's first
        backward, its forward's FLOPs counted; a hook on an output marks the
        pair warm when a backward reaches it (and books that backward at the
        reference's estimate: its count comes with the capture)."""
        device = next(r.device for r in raws if isinstance(r, torch.Tensor))
        with _Fold(), engine.side_stream(device), engine.count_flops() as fc:
            out = self._forward_unhybridized(*args)
        pair.flops = fwd = fc.total
        engine.record_execution("fwd", fwd)
        flat, pair.structure = _flatten_out(out)
        head = next((t for t in flat if t.requires_grad), None)
        if head is None:
            pair.warm = True          # nothing to differentiate: a backward graph of nothing
        else:
            ref = weakref.ref(pair)

            def warmed(grad):
                p = ref()
                if p is not None:
                    p.warm = True
                engine.record_execution("bwd", 2.0 * fwd, estimated=True)
            head.register_hook(warmed)
        self._fingerprint_memo = None           # deferred shapes are known now
        return out

    def _eager(self, entry, args, raws, recorded=False):
        """The eager forward; with telemetry on its FLOPs booked: the
        forward's counted at the signature's first such call, under
        ``record()`` the backward's too (``engine.count_backward``), each
        added at every call, the backward's by a hook on an output when the
        backward reaches it."""
        if not _telem._ENABLED:
            with _Fold():
                return self._forward_unhybridized(*args)
        with _Fold(), (engine.count_flops() if entry.flops is None
                       else contextlib.nullcontext()) as fc:
            out = self._forward_unhybridized(*args)
        if fc is not None:
            entry.flops = fc.total
        engine.record_execution("fwd", entry.flops)
        flat = _flatten_out(out)[0] if recorded else []
        head = next((t for t in flat if t.requires_grad), None)
        if head is not None:
            if entry.bwd_flops is None:
                entry.bwd_flops = engine.count_backward(
                    flat, [r for r in raws if isinstance(r, torch.Tensor)]
                    + [p._param for p in self.collect_params().values() if p._param is not None])
            bwd = entry.bwd_flops
            head.register_hook(lambda g: engine.record_execution("bwd", bwd))
        return out

    def _pair_slot(self, sig, pair, raws):
        """A slot whose activations nobody needs, its graphs current (captured
        anew if they went stale or the parameters' gradient flags changed),
        or a new one; None when ``_MAX_IN_FLIGHT`` slots are busy."""
        reqs = tuple(p._param.requires_grad for p in pair.params) \
            if pair.params is not None else None
        if reqs != pair.reqs:
            for slot in pair.slots:
                slot.fwd.valid = slot.bwd.valid = False
            pair.slots = []
        for slot in pair.slots:
            if slot.busy():
                continue
            if engine.lookup(self._slot_key(sig, slot.index, "fwd")) is not None \
                    and slot.bwd.live():
                return slot
            return self._capture_slot(sig, pair, raws, slot.index)
        if len(pair.slots) >= _MAX_IN_FLIGHT:
            return None
        engine.lookup(self._slot_key(sig, len(pair.slots), "fwd"))      # a miss
        return self._capture_slot(sig, pair, raws, len(pair.slots))

    def _slot_key(self, sig, index, kind):
        return ("gluon", id(self), self._fingerprint(), sig, index, kind)

    def _capture_slot(self, sig, pair, raws, index):
        """Capture slot ``index`` of ``sig``: the forward recorded by autograd
        on static inputs, then the backward of its outputs, into one pool."""
        from .. import random as _random
        device = next(r.device for r in raws if isinstance(r, torch.Tensor))
        training, needs, remat = sig[1], sig[2], sig[3]
        pair.params = [p for p in self.collect_params().values() if p._param is not None]
        pair.reqs = tuple(p._param.requires_grad for p in pair.params)
        slot = _Slot(index)
        slot.flops = pair.flops
        slot.remat = remat
        slot.gen = _random.generator(device)
        slot.token = torch.empty(0, device=device)
        static = [r.detach().clone().requires_grad_(n) if isinstance(r, torch.Tensor) else r
                  for r, n in zip(raws, needs)]
        slot.inputs = [t for t in static if isinstance(t, torch.Tensor)]
        slot.wrt_inputs = [k for k, t in enumerate(slot.inputs) if t.requires_grad]
        leaves = [p._param for p in pair.params if p._param.requires_grad]
        wrapped = [NDArray(t) if isinstance(t, torch.Tensor) else t for t in static]
        block = self

        def forward(*_ins):
            with autograd._RecordingScope(True, training), _Fold():
                return tuple(_flatten_out(block._forward_unhybridized(*wrapped))[0])

        def body(*ins):           # under checkpoint: its second run is the recompute
            if not first[0]:
                first[0] = True
                return forward(*ins)
            with autograd._RecordingScope(True, training), _Fold(), _FreezeAux():
                return tuple(_flatten_out(block._forward_unhybridized(*wrapped))[0])
        first = [False]

        def run_fwd():
            with torch.enable_grad():
                if remat:
                    from torch.utils.checkpoint import checkpoint
                    return list(checkpoint(body, *slot.inputs, use_reentrant=False,
                                           preserve_rng_state=False))
                return list(forward())
        pool = torch.cuda.graph_pool_handle()
        slot.fwd = engine.capture(run_fwd, self._slot_key(sig, index, "fwd"), device,
                                  owner=self, ptrs=HybridBlock._param_ptrs, pool=pool)
        outs = slot.fwd.outputs
        slot.out_diff = [o.requires_grad for o in outs]
        heads = [o for o, d in zip(outs, slot.out_diff) if d]
        slot.gouts = [torch.zeros_like(o) for o in heads]
        wrt = [slot.inputs[k] for k in slot.wrt_inputs] + leaves

        def run_bwd():
            if not heads or not wrt:
                return [None] * len(wrt)
            with torch.enable_grad():
                return list(torch.autograd.grad(heads, wrt, slot.gouts, allow_unused=True))
        with engine.count_flops() as fc:        # what each replay of it does
            slot.bwd = engine.capture(run_bwd, self._slot_key(sig, index, "bwd"), device,
                                      owner=self, ptrs=HybridBlock._param_ptrs, pool=pool)
        slot.bwd_flops = fc.total
        got = slot.bwd.outputs
        n = len(slot.wrt_inputs)
        slot.used_inputs = {k for k, g in zip(slot.wrt_inputs, got[:n]) if g is not None}
        slot.used = [k for k, g in enumerate(got[n:]) if g is not None]
        slot.leaves = [leaves[k] for k in slot.used]
        if index < len(pair.slots):
            pair.slots[index] = slot
        else:
            pair.slots.append(slot)
        return slot
