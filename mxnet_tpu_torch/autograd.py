"""Imperative autograd: record/pause scopes, mark_variables, backward, grad.

Counterpart of ``mxnet_tpu/autograd.py:99-304``. The reference keeps its own
tape of ``jax.vjp`` closures; here the tape is ``torch.autograd``'s graph.
While ``is_recording()``, ``ndarray.invoke`` runs every differentiable op
with grad enabled, so the graph grows from the variables that
``mark_variables`` (or ``NDArray.attach_grad``, or a ``Parameter``) made
leaves that require a gradient. Outside ``record()``, and under ``pause()``,
ops run under ``no_grad`` and nothing is recorded.

MXNet's gradient buffers, not torch's ``.grad``: each variable's tensor
carries its own buffer (``_mx_grad``) and request (``_mx_grad_req``).
``backward`` walks the graph from the heads to the marked leaves it reaches,
takes their gradients with ``torch.autograd.grad`` (which never touches
``.grad``), and then, per variable: ``"write"`` overwrites the buffer,
``"add"`` adds into it, and a variable the heads do not reach keeps its
buffer unchanged, as the reference's tape walk does (:187-211).

Higher order (reference :268-403): ``grad(create_graph=True)`` is
``torch.autograd.grad(create_graph=True)`` run with recording on, as the
reference runs its walk, so every op of the backward (a ``Function``'s
backward too) is recorded and the returned gradients are differentiable
again. ``retain_graph`` defaults to ``create_graph``. The port's own
Functions that cannot be differentiated twice raise the reference's
``MXNetError`` (``_NO_SECOND_ORDER``, :366-370) when a backward runs them
under ``create_graph``: a hybridized block's training pair
(``gluon/block.py``'s ``_PairCall``), the ring attention, and a third order
through the flash-attention kernels.

``Function`` (reference :414-471): ``forward``/``backward`` on NDArrays,
``save_for_backward``. A call while recording runs ``forward`` recorded and
joins its outputs to the tape through one ``torch.autograd.Function``
(``_FunctionCall``) whose backward is the user's ``backward``: run under
``pause()`` for a first-order gradient, recorded under ``create_graph``, so
its ops are differentiable again (reference :451). The saved arrays go
through ``ctx.save_for_backward``, so an output saved by ``forward`` comes
back as the Function's output, as the reference's record keeps it, and no
reference cycle holds the graph.

Writes into saved leaves (``ndarray.py``): while ``record()`` is on, every
leaf tensor (a variable, a parameter, a constant: no ``grad_fn``) that an
op saves for its backward is held by a ``_Saved`` through torch's
saved-tensor hooks, pushed by the outermost recording scope unless other
hooks are active (a ``torch.utils.checkpoint`` region keeps its own).
``preserve_saved(t)``, which ``NDArray`` calls before it writes into ``t``
in place, gives every live hold of ``t`` a copy of its value; the backward
then reads that copy (under ``create_graph`` joined to ``t`` by an
identity, so a second derivative still reaches the variable).
A graph thus keeps the values it was recorded with, as the reference's
immutable payloads do, while the write goes into the tensor's own storage.
"""
from __future__ import annotations

import threading
import weakref

import torch

from .base import MXNetError


class _State(threading.local):
    def __init__(self):
        self.recording = False
        self.training = False


_STATE = _State()


class _Saved:
    """A leaf tensor saved for a backward, and its value at record time once
    the tensor is written (``preserve_saved``)."""

    __slots__ = ("t", "old", "__weakref__")

    def __init__(self, t):
        self.t = t
        self.old = None


def _pack(t):
    if t.grad_fn is not None:
        return t
    hold = _Saved(t)
    live = getattr(t, "_mx_saved", None)
    if live is None:
        live = t._mx_saved = weakref.WeakSet()
    live.add(hold)
    return hold


class _AsRecorded(torch.autograd.Function):
    """``old``'s value, with the gradient of ``live`` (the tensor it was)."""

    @staticmethod
    def forward(ctx, live, old):
        return old.view_as(old)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def _unpack(hold):
    if not isinstance(hold, _Saved):
        return hold
    if hold.old is None:
        return hold.t
    if hold.t.requires_grad and torch.is_grad_enabled():
        return _AsRecorded.apply(hold.t, hold.old)
    return hold.old


def preserve_saved(t: torch.Tensor) -> None:
    """Before ``t`` is written in place: every recorded graph that saved it
    keeps a copy of its current value."""
    live = getattr(t, "_mx_saved", None)
    if not live:
        return
    copy = None
    for hold in list(live):
        if hold.old is None:
            if copy is None:
                copy = t.detach().clone()
            hold.old = copy
    live.clear()


def _no_saved_hooks() -> bool:
    """No saved-tensor hooks are active: neither an outer recording scope's
    nor another owner's (a checkpoint's forward or recomputation, which
    must see every tensor saved inside it)."""
    top = getattr(torch._C._autograd, "_top_saved_tensors_default_hooks", None)
    return top is None or top(False) is None


class _RecordingScope:
    def __init__(self, recording, training):
        self._rec = recording
        self._train = training
        self._prev = None
        self._hooks = None

    def __enter__(self):
        self._prev = (_STATE.recording, _STATE.training)
        if self._rec is not None:
            _STATE.recording = self._rec
        if self._train is not None:
            _STATE.training = self._train
        if self._rec and _no_saved_hooks():
            self._hooks = torch.autograd.graph.saved_tensors_hooks(_pack, _unpack)
            self._hooks.__enter__()
        return self

    def __exit__(self, *exc):
        if self._hooks is not None:
            self._hooks.__exit__(*exc)
            self._hooks = None
        _STATE.recording, _STATE.training = self._prev


def record(train_mode: bool = True):
    return _RecordingScope(True, train_mode)


def pause(train_mode: bool = False):
    return _RecordingScope(False, train_mode)


def train_mode():
    return _RecordingScope(None, True)


def predict_mode():
    return _RecordingScope(None, False)


def is_recording() -> bool:
    return _STATE.recording


def is_training() -> bool:
    return _STATE.training


def set_recording(flag: bool) -> bool:
    prev, _STATE.recording = _STATE.recording, flag
    return prev


def set_training(flag: bool) -> bool:
    prev, _STATE.training = _STATE.training, flag
    return prev


# ---------------------------------------------------------------------------
# Variables and the backward walk
# ---------------------------------------------------------------------------

def _mark(tensor: torch.Tensor, grad_buf, grad_req: str) -> None:
    """Make ``tensor`` (a leaf) a variable with buffer ``grad_buf``."""
    tensor.requires_grad_(grad_req != "null")
    tensor._mx_grad = grad_buf if grad_req != "null" else None
    tensor._mx_grad_req = grad_req


def mark_variables(variables, gradients=None, grad_reqs="write"):
    """Attach gradient buffers to arrays (reference autograd.py:137). An
    array that is the output of a recorded op is cut from its history and
    becomes a leaf, as in the reference, where marking replaces its node."""
    from .ndarray import NDArray, zeros
    if isinstance(variables, NDArray):
        variables = [variables]
        gradients = [gradients] if gradients is not None else None
    if isinstance(grad_reqs, str):
        grad_reqs = [grad_reqs] * len(variables)
    for i, v in enumerate(variables):
        req = grad_reqs[i]
        if req not in ("write", "add", "null"):
            raise MXNetError(f"invalid grad_req {req}")
        if not v._data.is_leaf:
            v._data = v._data.detach()
        g = gradients[i] if gradients is not None else None
        if g is None and req != "null":
            g = zeros(v.shape, ctx=v.ctx, dtype=v.dtype)
        _mark(v._data, g._data if g is not None else None, req)


def _heads_and_grads(heads, head_grads):
    from .ndarray import NDArray
    if isinstance(heads, NDArray):
        heads = [heads]
    if head_grads is not None and not isinstance(head_grads, (list, tuple)):
        head_grads = [head_grads]
    outs, grads = [], []
    for i, h in enumerate(heads):
        t = h._data
        if not t.requires_grad:
            raise MXNetError("head array is not part of the recorded graph "
                             "(was it computed under autograd.record()?)")
        hg = head_grads[i] if head_grads is not None else None
        if hg is None:
            hg = torch.ones_like(t)
        elif isinstance(hg, NDArray):
            hg = hg._data
        else:
            hg = torch.as_tensor(hg, dtype=t.dtype, device=t.device)
        outs.append(t)
        grads.append(hg)
    return outs, grads


def _reached_variables(heads):
    """The marked leaves the graph of ``heads`` reaches, in walk order."""
    found, seen = {}, set()
    stack = []
    for h in heads:
        if h.grad_fn is None:
            if getattr(h, "_mx_grad_req", "null") != "null":
                found[id(h)] = h
        else:
            stack.append(h.grad_fn)
    while stack:
        fn = stack.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        var = getattr(fn, "variable", None)   # AccumulateGrad: a leaf
        if var is not None:
            if getattr(var, "_mx_grad_req", "null") != "null":
                found[id(var)] = var
            continue
        stack.extend(nxt for nxt, _ in fn.next_functions)
    return list(found.values())


_NO_SECOND_ORDER = ("create_graph=True: an op on the path has no re-differentiable "
                    "form (hybridized-block forwards, Custom ops); run the net "
                    "un-hybridized / restructure with registered ops")


def backward(heads, head_grads=None, retain_graph=False, train_mode=True):
    """Gradients of ``heads`` into the buffers of the variables they reach
    (reference Imperative::Backward, autograd.py:187)."""
    outs, grads = _heads_and_grads(heads, head_grads)
    variables = _reached_variables(outs)
    if not variables:
        return
    with _RecordingScope(False, train_mode), torch.enable_grad():
        got = torch.autograd.grad(outs, variables, grads,
                                  retain_graph=retain_graph, allow_unused=True)
    with torch.no_grad():
        for var, g in zip(variables, got):
            buf = var._mx_grad
            if var._mx_grad_req == "add":
                if g is not None:
                    buf.add_(g)
            elif g is None:
                buf.zero_()
            else:
                buf.copy_(g)


def grad(heads, variables, head_grads=None, retain_graph=None,
         create_graph=False, train_mode=True):
    """Gradients of ``heads`` with respect to ``variables``, returned as new
    arrays; no buffer is written (reference autograd.py:268). With
    ``create_graph`` the backward is recorded: the gradients are
    differentiable again."""
    from .ndarray import NDArray
    single = isinstance(variables, NDArray)
    if single:
        variables = [variables]
    if retain_graph is None:
        retain_graph = create_graph
    outs, grads = _heads_and_grads(heads, head_grads)
    for v in variables:
        if not v._data.requires_grad:
            raise MXNetError("grad: a variable was not marked "
                             "(attach_grad / mark_variables)")
    with _RecordingScope(bool(create_graph), train_mode), torch.enable_grad():
        got = torch.autograd.grad(outs, [v._data for v in variables], grads,
                                  retain_graph=bool(retain_graph),
                                  create_graph=bool(create_graph), allow_unused=True)
    result = []
    for v, g in zip(variables, got):
        if g is None:
            raise MXNetError("one of the variables does not receive gradient "
                             "(not on any path from heads)")
        result.append(NDArray(g, v.ctx))
    return result[0] if single else result


class _FunctionCall(torch.autograd.Function):
    """A ``Function`` call on the tape: ``apply(fn, call, *inputs)`` returns
    the outputs ``forward`` computed (``call``); the backward runs the user's
    ``backward``."""

    @staticmethod
    def forward(ctx, fn, call, *tensors):
        from .ndarray import NDArray
        ctx.fn = fn
        ctx.mask = call["mask"]
        ctx.meta = [(o.shape, o.dtype, o.device) for o in call["outs"]]
        outs = [o.detach() for o in call["outs"]]
        # the saved arrays: an output as the output tensor returned here,
        # others as they are (an input comes back as the variable)
        tags, saved = [], []
        for s in call["saved"]:
            k = next((j for j, o in enumerate(call["outs"]) if getattr(s, "_data", None) is o), None)
            if k is not None:
                tags.append(("nd", len(saved)))
                saved.append(outs[k])
            elif isinstance(s, NDArray):
                tags.append(("nd", len(saved)))
                saved.append(s._data)
            else:
                tags.append(("raw", s))
        ctx.tags = tags
        ctx.save_for_backward(*saved)
        return tuple(outs)

    @staticmethod
    def backward(ctx, *grads):
        from .ndarray import NDArray
        fn = ctx.fn
        saved = ctx.saved_tensors
        fn.saved_tensors = tuple(NDArray(saved[v]) if tag == "nd" else v for tag, v in ctx.tags)
        cots = [NDArray(g if g is not None else torch.zeros(shape, dtype=dt, device=dev))
                for g, (shape, dt, dev) in zip(grads, ctx.meta)]
        try:
            with _RecordingScope(torch.is_grad_enabled(), None):
                in_grads = fn.backward(*cots)
        finally:
            fn.saved_tensors = ()
        if not isinstance(in_grads, (list, tuple)):
            in_grads = (in_grads,)
        return (None, None) + tuple(g._data if isinstance(g, NDArray) else g
                                    for g, nd in zip(in_grads, ctx.mask) if nd)


class Function:
    """User-defined differentiable function (reference autograd.py:414)::

        class Sigmoid(autograd.Function):
            def forward(self, x):
                y = 1 / (1 + nd.exp(-x))
                self.save_for_backward(y)
                return y

            def backward(self, dy):
                y, = self.saved_tensors
                return dy * y * (1 - y)

    See the module docstring for how a call joins the tape.
    """

    def __init__(self):
        self.saved_tensors = ()

    def save_for_backward(self, *args):
        self.saved_tensors = args

    def forward(self, *inputs):
        raise NotImplementedError

    def backward(self, *output_grads):
        raise NotImplementedError

    def __call__(self, *inputs):
        from .ndarray import NDArray
        outs = self.forward(*inputs)
        if not is_recording():
            return outs
        single = not isinstance(outs, (list, tuple))
        outs_t = [outs] if single else list(outs)
        call = {"outs": [o._data for o in outs_t], "saved": self.saved_tensors,
                "mask": [isinstance(x, NDArray) for x in inputs]}
        self.saved_tensors = ()
        tensors = [x._data for x in inputs if isinstance(x, NDArray)]
        with torch.enable_grad():
            new = _FunctionCall.apply(self, call, *tensors)
        for o, t in zip(outs_t, new):
            o._data = t
        return outs
