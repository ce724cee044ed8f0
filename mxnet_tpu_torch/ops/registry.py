"""Operator registry.

Counterpart of ``mxnet_tpu/ops/registry.py:65-140``. Every operator is one
plain PyTorch function ``fn(*tensors, **params) -> tensor | tuple``, looked
up by its MXNet name. The reference wraps each op in a per-parameter
``jax.jit`` cache; PyTorch runs eagerly, so here an op is called as it is.
Shape inference, where a later slice needs it, runs the same function on
``device="meta"`` tensors in place of ``jax.eval_shape``.

Each ``Op`` counts its calls (``Op.calls``, a plain integer): a test or a
run can read how often the main path reached an operator, for example the
flash-attention op once per BERT layer. It counts Python dispatches only: a
replayed CUDA graph (``engine``) runs no Python and adds nothing here, where
the kernels' launch counters do count replays.

``differentiable=False`` marks an op that ``invoke`` always runs under
``torch.no_grad()``, recording or not (the optimizer updates, reference
``ops/optimizer_ops.py:106``). ``state_inputs`` pairs ``(input index,
output index)``, or a function ``(inputs, params) -> pairs`` for an op
whose layout follows its params (the ``multi_*`` updates): ``invoke``
copies those outputs into the input tensors in place and returns the
rest, as the reference's nd wrappers write an optimizer op's updated
states back (reference ``ndarray.py:531-543``).
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

from ..base import MXNetError

_OP_REGISTRY: Dict[str, "Op"] = {}


class Op:
    """A registered operator: one plain torch function + metadata."""

    __slots__ = ("name", "fn", "aliases", "doc", "calls", "differentiable",
                 "state_inputs")

    def __init__(self, name: str, fn: Callable, aliases: Tuple[str, ...] = (),
                 doc: str = "", differentiable: bool = True,
                 state_inputs: Tuple[Tuple[int, int], ...] = ()):
        self.name = name
        self.fn = fn
        self.aliases = aliases
        self.differentiable = differentiable
        self.state_inputs = state_inputs if callable(state_inputs) else tuple(state_inputs)
        self.doc = doc or (fn.__doc__ or "")
        self.calls = 0

    def __call__(self, *tensors, **params):
        self.calls += 1
        return self.fn(*tensors, **params)

    def __repr__(self):
        return f"<Op {self.name}>"


def register(name: str, aliases: Tuple[str, ...] = (),
             differentiable: bool = True,
             state_inputs: Tuple[Tuple[int, int], ...] = ()):
    """Decorator: register a plain torch function as an operator."""
    def deco(fn: Callable) -> Callable:
        op = Op(name, fn, aliases=tuple(aliases), differentiable=differentiable,
                state_inputs=state_inputs)
        _OP_REGISTRY[name] = op
        for a in aliases:
            _OP_REGISTRY[a] = op
        return fn
    return deco


def get_op(name: str) -> Op:
    try:
        return _OP_REGISTRY[name]
    except KeyError:
        raise MXNetError(f"operator '{name}' is not registered") from None


def list_ops():
    return sorted({op.name for op in _OP_REGISTRY.values()})


def all_ops() -> Dict[str, Op]:
    return dict(_OP_REGISTRY)
