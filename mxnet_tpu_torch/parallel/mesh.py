"""Device meshes: one device, or the ranks of a ``torch.distributed`` job.

Counterpart of ``mxnet_tpu/parallel/mesh.py:20-83``: ``make_mesh``,
``local_mesh``, ``current_mesh``, ``set_default_mesh``, ``require_axis``,
``axis_size``, ``axis_index`` and ``P``. The reference's mesh is a
``jax.sharding.Mesh`` whose axes (``dp``, ``tp``, ``sp``, ...) XLA maps
collectives onto. Here a ``Mesh`` names axes over devices in one of two
forms:

- without a process group, a mesh of one device, every axis of size 1 (the
  one-device fused step runs on it);
- with ``torch.distributed`` set up (``_dist_util.init_process_group``), a
  mesh over the world's ranks, one device each, whose axis sizes multiply to
  the world size. Rank r sits at the coordinates of r in the axes' row-major
  order (the reference's ``devices.reshape(shape)``). At construction every
  rank creates one process group for every non-empty set of axes (in the
  axes' order), the groups of ranks that differ only on those axes, all in
  the same order on every rank (``new_group`` deadlocks otherwise), and keeps
  the ones it belongs to: ``mesh.group(("dp", "sp"))`` is this rank's group
  of the gradient reduction.

``with activate(mesh, "sp"):`` makes a mesh the active one, with the axis
that shards the data's sequence dimension (the role of ``with mesh:`` for a
``jax`` mesh): ``DataParallelTrainer`` runs its forward under it, and the
layers that partition their work read ``active_mesh()`` and
``sequence_axis()``.
``P`` (``PartitionSpec``) is a tuple of axis names, one for each dimension
of an array, or None for a dimension not split.
"""
from __future__ import annotations

import itertools
import math
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple, Union

from ..base import MXNetError
from ..context import Context, current_context, num_gpus


class PartitionSpec(tuple):
    """``P("dp")``: how each dimension of an array is split over mesh axes."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self):
        return f"P{tuple.__repr__(self)}"


P = PartitionSpec

# (mesh, sequence axis) of the steps running, innermost last
_ACTIVE: List[Tuple["Mesh", Optional[str]]] = []


class Mesh:
    """Named axes over devices: one device, or one rank's view of a mesh of
    ``torch.distributed`` ranks (``rank``, ``coords``, ``group(axes)``)."""

    def __init__(self, devices: Sequence[Context], axis_names: Sequence[str],
                 shape: Sequence[int], rank: int = 0, distributed: bool = False):
        self.devices = list(devices)
        self.axis_names = tuple(axis_names)
        self.shape: Dict[str, int] = OrderedDict(zip(self.axis_names, shape))
        self.distributed = distributed
        self.rank = rank
        self.coords: Dict[str, int] = OrderedDict(
            zip(self.axis_names, _unravel(rank, tuple(shape))))
        self._groups: Dict[Tuple[str, ...], object] = {}
        if distributed:
            self._make_groups()

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    @property
    def device(self) -> Context:
        """This rank's device."""
        return self.devices[0]

    def axis_size(self, name: str) -> int:
        return require_axis(self, name)

    def axis_index(self, name: str) -> int:
        require_axis(self, name)
        return self.coords[name]

    def _axes(self, axes) -> Tuple[str, ...]:
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        for a in axes:
            require_axis(self, a)
        return tuple(a for a in self.axis_names if a in axes)

    def group(self, axes):
        """This rank's process group over ``axes`` (a name or a tuple)."""
        if not self.distributed:
            raise MXNetError(f"{self} is a mesh of one device: it has no process groups")
        return self._groups[self._axes(axes)]

    def group_size(self, axes) -> int:
        return math.prod(self.shape[a] for a in self._axes(axes))

    def _make_groups(self):
        import torch.distributed as dist
        names = self.axis_names
        shape = tuple(self.shape.values())
        for k in range(1, len(names) + 1):
            for axes in itertools.combinations(names, k):
                inner = [i for i, a in enumerate(names) if a in axes]
                outer = [i for i, a in enumerate(names) if a not in axes]
                for fixed in itertools.product(*(range(shape[i]) for i in outer)):
                    ranks = []
                    for varied in itertools.product(*(range(shape[i]) for i in inner)):
                        coord = [0] * len(names)
                        for i, v in zip(outer, fixed):
                            coord[i] = v
                        for i, v in zip(inner, varied):
                            coord[i] = v
                        ranks.append(_ravel(coord, shape))
                    group = dist.new_group(ranks)
                    if self.rank in ranks:
                        self._groups[axes] = group

    def __repr__(self):
        where = f"rank {self.rank} at {dict(self.coords)}, " if self.distributed else ""
        return f"Mesh({dict(self.shape)}, {where}devices={self.devices})"


class _Activation:
    """``with`` block that makes ``mesh`` active with a sequence axis."""

    def __init__(self, mesh: Mesh, seq_axis: Optional[str]):
        self.entry = (mesh, seq_axis)

    def __enter__(self):
        _ACTIVE.append(self.entry)
        return self.entry[0]

    def __exit__(self, *exc):
        _ACTIVE.pop()


def activate(mesh: Mesh, seq_axis: Optional[str] = None) -> _Activation:
    """``with activate(mesh, "sp"):`` the mesh is active and the data's
    sequence dimension (dim 1) is sharded over ``"sp"``."""
    if seq_axis is not None:
        require_axis(mesh, seq_axis, "the sequence dimension")
    return _Activation(mesh, seq_axis)


def active_mesh() -> Optional[Mesh]:
    """The mesh of the step running, or None."""
    return _ACTIVE[-1][0] if _ACTIVE else None


def sequence_axis() -> Optional[str]:
    """The axis over which the running step's data is sharded along the
    sequence (dim 1), or None."""
    return _ACTIVE[-1][1] if _ACTIVE else None


def _unravel(rank: int, shape: Tuple[int, ...]) -> List[int]:
    out = []
    for n in reversed(shape):
        out.append(rank % n)
        rank //= n
    return out[::-1]


def _ravel(coord: Sequence[int], shape: Tuple[int, ...]) -> int:
    r = 0
    for c, n in zip(coord, shape):
        r = r * n + c
    return r


_DEFAULT_MESH: Optional[Mesh] = None


def _local_devices():
    """The local devices: the CUDA devices, or the CPU without any."""
    n = num_gpus()
    return [Context("gpu", i) for i in range(n)] if n else [current_context()]


def make_mesh(axes: Union[Dict[str, int], Sequence[int]],
              names: Optional[Sequence[str]] = None, devices=None) -> Mesh:
    """``make_mesh({'dp': 2, 'tp': 2, 'sp': 2})`` or ``make_mesh((2, 2), ('dp',
    'tp'))``. With a process group set up the axis sizes must multiply to its
    world size, and this rank's device is ``devices[local_rank %
    len(devices)]`` (default: the CUDA devices); without one the mesh is of
    one device."""
    import torch.distributed as dist
    from .._dist_util import env_local_rank
    if isinstance(axes, dict):
        names, shape = tuple(axes.keys()), tuple(axes.values())
    else:
        shape = tuple(axes)
        names = tuple(names or [f"axis{i}" for i in range(len(shape))])
    n = math.prod(shape)
    devices = list(devices) if devices is not None else _local_devices()
    if not devices:
        raise MXNetError("make_mesh: no devices")
    if dist.is_initialized():
        world = dist.get_world_size()
        if n != world:
            raise MXNetError(f"mesh {dict(zip(names, shape))} has {n} ranks, the "
                             f"process group {world}")
        device = devices[env_local_rank() % len(devices)]
        return Mesh([device], names, shape, rank=dist.get_rank(), distributed=True)
    if n > 1:
        raise MXNetError(f"mesh {dict(zip(names, shape))} spans {n} ranks: set up "
                         f"torch.distributed first (_dist_util.init_process_group, "
                         f"or _dist_util.launch_local)")
    return Mesh(devices[:1], names, shape)


def local_mesh(dp: Optional[int] = None, name: str = "dp") -> Mesh:
    """1-D data-parallel mesh: over the world's ranks, or one local device."""
    import torch.distributed as dist
    n = dp or (dist.get_world_size() if dist.is_initialized() else 1)
    return make_mesh({name: n})


def require_axis(mesh: Mesh, name: str, role: str = "this trainer") -> int:
    """Check that ``name`` is an axis of ``mesh``; returns its size."""
    if name not in mesh.shape:
        raise MXNetError(f"mesh has no {name!r} axis for {role}: {dict(mesh.shape)}")
    return mesh.shape[name]


def axis_size(name: str, mesh: Optional[Mesh] = None) -> int:
    """Size of axis ``name`` of ``mesh`` (default: the active mesh)."""
    return _mesh_or_active(mesh).axis_size(name)


def axis_index(name: str, mesh: Optional[Mesh] = None) -> int:
    """This rank's index along axis ``name`` of ``mesh`` (default: the
    active mesh)."""
    return _mesh_or_active(mesh).axis_index(name)


def _mesh_or_active(mesh: Optional[Mesh]) -> Mesh:
    mesh = mesh if mesh is not None else active_mesh()
    if mesh is None:
        raise MXNetError("no mesh given and none active (`with activate(mesh):`)")
    return mesh


def set_default_mesh(mesh: Optional[Mesh]):
    global _DEFAULT_MESH
    _DEFAULT_MESH = mesh


def current_mesh() -> Mesh:
    global _DEFAULT_MESH
    if _DEFAULT_MESH is None:
        _DEFAULT_MESH = local_mesh()
    return _DEFAULT_MESH


__all__ = ["Mesh", "PartitionSpec", "P", "make_mesh", "local_mesh",
           "set_default_mesh", "current_mesh", "require_axis", "axis_size",
           "axis_index", "activate", "active_mesh", "sequence_axis"]
