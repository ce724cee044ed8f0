"""The fused step's configuration fingerprint: ``StepProgram``.

Counterpart of ``mxnet_tpu/parallel/step_program.py`` (``StepProgram`` and
its ``fingerprint``) and of the three helpers of
``mxnet_tpu/engine/__init__.py:417-458`` it is built on:
``structural_fingerprint`` (a digest of a Block tree), ``config_fingerprint``
(a token tuple of a trainer configuration) and ``region_digest``. A trainer
keys its program as

    key_base = ("dp_step", structural_fingerprint(net), config_fingerprint(**config))

(``recipes.moe.MoETrainer`` appends ``("moe", ep axis, ep degree, aux weight,
wire dtype)``, the reference's ``recipes/moe.py:122-127``), and
``parallel.PipelineTrainer`` keys its program ``("pp_step", ...)`` with the
reference's pipeline configuration (``parallel/pipeline.py:583-616``: the
schedule, M, the pp and dp axes, the virtual stages, the trainable lanes of
the embed, the cells and the head, the compute dtype, zero); elastic
snapshots record ``program.fingerprint``: ``elastic.resume_or_init``
calls a boot "resumed" when the saved fingerprint and mesh equal the new
trainer's, "resharded" otherwise.

The reference's program also resolves compiled executables through the
process-wide engine cache and captures XLA's cost model; the port keeps the
fingerprint only. A trainer's captured CUDA graphs live in ``engine``'s
cache under its own key (the instance, the fingerprint, the batch's
signature): whether a step is captured is no part of the configuration's
identity, so a snapshot of a captured step restores into an eager trainer
and back. The digest is the
port's own and differs from the reference's: module and class names are part
of it. Opaque configuration values (callables, objects) enter by type name,
where the reference takes their identity, so that two instances of one model
and one configuration (a trainer rebuilt after a kill) give one fingerprint.
"""
from __future__ import annotations

import hashlib
from typing import Tuple

import torch

__all__ = ["StepProgram", "structural_fingerprint", "config_fingerprint", "region_digest"]

# per-instance bookkeeping of a Block (and of torch.nn.Module under it) that
# does not change the computation; parameters and children are walked apart
_SKIP_ATTRS = frozenset(vars(torch.nn.Module())) | {
    "_prefix", "_params", "_reg_params", "_scope", "_active", "_flags",
    "_fingerprint_memo"}

_SCALARS = (int, float, bool, str, bytes, type(None))


def _stable_value(v) -> str:
    """A deterministic token of a configuration value: scalars and containers
    of scalars by value, anything else by its type's name."""
    if isinstance(v, _SCALARS):
        return repr(v)
    if isinstance(v, (tuple, list)):
        return "(" + ",".join(_stable_value(x) for x in v) + ")"
    if isinstance(v, dict):
        return "{" + ",".join(f"{k!r}:{_stable_value(v[k])}" for k in sorted(v, key=repr)) + "}"
    if isinstance(v, torch.dtype):
        return str(v)
    return f"type:{type(v).__module__}.{type(v).__qualname__}"


def _block_config_items(block):
    items = []
    for k in sorted(vars(block)):
        if k in _SKIP_ATTRS or k.startswith("_cached"):
            continue
        v = vars(block)[k]
        if isinstance(v, torch.Tensor) or hasattr(v, "_deferred_init") or \
                isinstance(v, torch.nn.Module):
            continue          # parameters and children are walked below
        items.append((k, _stable_value(v)))
    return items


def structural_fingerprint(block) -> str:
    """Digest of a Block tree: class, scalar configuration, parameter shapes
    and dtypes, children (recursively); names and prefixes are left out, so
    two instances of one model definition give the same digest."""
    h = hashlib.sha1()

    def walk(b):
        h.update(f"<{type(b).__module__}.{type(b).__qualname__}".encode())
        for k, v in _block_config_items(b):
            h.update(f"|{k}={v}".encode())
        for k, p in getattr(b, "_reg_params", {}).items():
            h.update(f"|p:{k}:{tuple(p.shape or ())}:{p.dtype}".encode())
        for k, c in getattr(b, "_children", {}).items():
            h.update(f"|c:{k}".encode())
            walk(c)
        h.update(b">")

    walk(block)
    return h.hexdigest()


def config_fingerprint(**config) -> Tuple:
    """Deterministic token tuple of a trainer configuration."""
    return tuple((k, _stable_value(config[k])) for k in sorted(config))


def region_digest(*parts) -> str:
    """Stable short digest of a key tuple."""
    return hashlib.sha1(repr(parts).encode()).hexdigest()[:6]


class StepProgram:
    """A trainer configuration's identity. ``label``: readable prefix, e.g.
    ``dp.step[BertModel]``; ``key_base``: the tuple of the module docstring."""

    __slots__ = ("label", "key_base")

    def __init__(self, label: str, key_base: Tuple):
        self.label = label
        self.key_base = key_base

    @property
    def fingerprint(self) -> str:
        """Stable digest of the configuration (network structure and trainer
        configuration, not the placement of one run)."""
        return region_digest(self.key_base, "program")
