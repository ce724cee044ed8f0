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

``grad(create_graph=True)`` (higher-order gradients) and the custom
``Function`` wait for a later slice and raise ``MXNetError``.
"""
from __future__ import annotations

import threading

import torch

from .base import MXNetError


class _State(threading.local):
    def __init__(self):
        self.recording = False
        self.training = False


_STATE = _State()


class _RecordingScope:
    def __init__(self, recording, training):
        self._rec = recording
        self._train = training
        self._prev = None

    def __enter__(self):
        self._prev = (_STATE.recording, _STATE.training)
        if self._rec is not None:
            _STATE.recording = self._rec
        if self._train is not None:
            _STATE.training = self._train
        return self

    def __exit__(self, *exc):
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
    arrays; no buffer is written (reference autograd.py:268)."""
    from .ndarray import NDArray
    if create_graph:
        raise MXNetError("autograd.grad(create_graph=True): higher-order "
                         "gradients are not ported yet")
    single = isinstance(variables, NDArray)
    if single:
        variables = [variables]
    outs, grads = _heads_and_grads(heads, head_grads)
    for v in variables:
        if not v._data.requires_grad:
            raise MXNetError("grad: a variable was not marked "
                             "(attach_grad / mark_variables)")
    with _RecordingScope(False, train_mode), torch.enable_grad():
        got = torch.autograd.grad(outs, [v._data for v in variables], grads,
                                  retain_graph=bool(retain_graph),
                                  allow_unused=True)
    result = []
    for v, g in zip(variables, got):
        if g is None:
            raise MXNetError("one of the variables does not receive gradient "
                             "(not on any path from heads)")
        result.append(NDArray(g, v.ctx))
    return result[0] if single else result


class Function:
    """User-defined differentiable function (reference autograd.py:414).
    Not ported yet: constructing one raises ``MXNetError``."""

    def __init__(self):
        raise MXNetError("autograd.Function is not ported yet")
