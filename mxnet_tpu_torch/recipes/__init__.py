"""Large-model training recipes (counterpart of ``mxnet_tpu/recipes/``).

A recipe is a (model-factory, trainer-config, parity-oracle) triple
registered under a name:

- ``get_recipe("moe")``: the sparse-MoE transformer of ``recipes.moe``
  (``MoETransformerLM`` trained by ``MoETrainer`` over a ``{dp, ep}`` mesh
  with the experts sharded over ep and the ZeRO-sharded update of the rest;
  oracle: the same model with a dense FFN, which E = 1 gating matches);
- ``get_recipe("long_context")``: the long-context causal LM of
  ``recipes.long_context`` (``LongContextLM`` trained by
  ``LongContextTrainer`` over a ``{dp, sp}`` mesh with ring attention and
  the ZeRO-sharded update; oracle: the same model with dense attention).

The submodules load when first touched.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

__all__ = ["Recipe", "get_recipe", "list_recipes", "register", "moe", "long_context"]

_PORTED = ("moe", "long_context")


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
        else:
            raise KeyError(f"unknown recipe {name!r}; have {list_recipes()}")
    return _REGISTRY[name]


def list_recipes():
    return list(_PORTED)


def register(recipe: Recipe):
    _REGISTRY[recipe.name] = recipe
    return recipe
