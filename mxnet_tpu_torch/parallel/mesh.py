"""Device meshes, for one device.

Counterpart of ``mxnet_tpu/parallel/mesh.py``: ``make_mesh``, ``local_mesh``,
``current_mesh``, ``set_default_mesh`` and ``P``. The reference's mesh is a
``jax.sharding.Mesh`` whose axes (``dp``, ``tp``, ``sp``, ...) XLA maps
collectives onto. Here a ``Mesh`` names its axes over ``Context``s, and only
a mesh of one device is ported: every axis has size 1, and a mesh of more
devices raises ``MXNetError`` (more devices over ``torch.distributed`` are
ROADMAP item A2). ``P`` (``PartitionSpec``) is a tuple of axis names, one
for each dimension of an array, or None for a dimension not split.
"""
from __future__ import annotations

import math
from collections import OrderedDict
from typing import Dict, Optional, Sequence, Union

from ..base import MXNetError
from ..context import Context, current_context, num_gpus

MULTI_DEVICE = ("a mesh of more than one device is not ported yet "
                "(ROADMAP A2: kvstore and DataParallelTrainer over more devices)")


class PartitionSpec(tuple):
    """``P("dp")``: how each dimension of an array is split over mesh axes."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self):
        return f"P{tuple.__repr__(self)}"


P = PartitionSpec


class Mesh:
    """Named axes over devices (here: one device, every axis of size 1)."""

    def __init__(self, devices: Sequence[Context], axis_names: Sequence[str],
                 shape: Sequence[int]):
        self.devices = list(devices)
        self.axis_names = tuple(axis_names)
        self.shape: Dict[str, int] = OrderedDict(zip(self.axis_names, shape))

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def device(self) -> Context:
        return self.devices[0]

    def __repr__(self):
        return f"Mesh({dict(self.shape)}, devices={self.devices})"


_DEFAULT_MESH: Optional[Mesh] = None


def _local_devices():
    """The local devices: the CUDA devices, or the CPU without any."""
    n = num_gpus()
    return [Context("gpu", i) for i in range(n)] if n else [current_context()]


def make_mesh(axes: Union[Dict[str, int], Sequence[int]],
              names: Optional[Sequence[str]] = None, devices=None) -> Mesh:
    """``make_mesh({'dp': 1})`` or ``make_mesh((1,), ('dp',))``."""
    if isinstance(axes, dict):
        names, shape = tuple(axes.keys()), tuple(axes.values())
    else:
        shape = tuple(axes)
        names = tuple(names or [f"axis{i}" for i in range(len(shape))])
    n = math.prod(shape)
    if n > 1:
        raise MXNetError(f"mesh {dict(zip(names, shape))}: {MULTI_DEVICE}")
    devices = list(devices) if devices is not None else _local_devices()
    if n > len(devices) or not devices:
        raise MXNetError(f"mesh needs {n} devices, have {len(devices)}")
    return Mesh(devices[:1], names, shape)


def local_mesh(dp: Optional[int] = None, name: str = "dp") -> Mesh:
    """1-D data-parallel mesh over all local devices."""
    devs = _local_devices()
    return make_mesh({name: dp or len(devs)}, devices=devs)


def set_default_mesh(mesh: Optional[Mesh]):
    global _DEFAULT_MESH
    _DEFAULT_MESH = mesh


def current_mesh() -> Mesh:
    global _DEFAULT_MESH
    if _DEFAULT_MESH is None:
        _DEFAULT_MESH = local_mesh()
    return _DEFAULT_MESH


__all__ = ["Mesh", "PartitionSpec", "P", "make_mesh", "local_mesh",
           "set_default_mesh", "current_mesh", "MULTI_DEVICE"]
