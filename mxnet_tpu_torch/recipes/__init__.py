"""Large-model training recipes (counterpart of ``mxnet_tpu/recipes/``).

A recipe is a (model-factory, trainer-config, parity-oracle) triple
registered under a name: ``get_recipe("long_context")`` is the long-context
causal LM of ``recipes.long_context`` (``LongContextLM`` trained by
``LongContextTrainer`` over a ``{dp, sp}`` mesh with ring attention and the
ZeRO-sharded update; oracle: the same model with dense attention).
``recipes.moe`` (the expert-parallel MoE recipe) is not ported:
``get_recipe("moe")`` raises and ROADMAP.md lists it. The submodules load
when first touched.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

from ..base import MXNetError

__all__ = ["Recipe", "get_recipe", "list_recipes", "register", "long_context"]

_PORTED = ("long_context",)


class Recipe(NamedTuple):
    """The (model-factory, trainer-config, parity-oracle) triple."""
    name: str
    build_model: Callable[..., Any]     # -> initialized HybridBlock
    build_trainer: Callable[..., Any]   # (net, mesh, **kw) -> trainer
    build_oracle: Callable[..., Any]    # -> the parity-reference model


_REGISTRY = {}


def _lazy(name):
    import importlib
    mod = importlib.import_module(f".{name}", __name__)
    globals()[name] = mod
    return mod


def __getattr__(name):
    if name in _PORTED:
        return _lazy(name)
    raise AttributeError(f"module 'mxnet_tpu_torch.recipes' has no attribute {name!r}")


def get_recipe(name: str) -> Recipe:
    if name not in _REGISTRY:
        if name in _PORTED:
            _lazy(name)  # registers itself at import
        elif name == "moe":
            raise MXNetError("recipe 'moe' is not ported yet (ROADMAP: recipes/moe.py, "
                             "models/moe_transformer.py and parallel/moe.py)")
        else:
            raise KeyError(f"unknown recipe {name!r}; have {list_recipes()}")
    return _REGISTRY[name]


def list_recipes():
    """The recipes this package has (the reference's also lists ``moe``)."""
    return list(_PORTED)


def register(recipe: Recipe):
    _REGISTRY[recipe.name] = recipe
    return recipe
