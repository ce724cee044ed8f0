"""Key-value stores for gradients and weights.

Counterpart of ``mxnet_tpu/kvstore/kvstore.py:36-739``: ``KVStore`` with
``init``, ``push``, ``pull``, ``pushpull`` (one key, a list of keys, or a
list reduced by buckets, :165), ``broadcast``, ``set_optimizer`` /
``set_updater``, ``barrier`` and ``save_optimizer_states`` /
``load_optimizer_states``; ``KVStoreLocal`` and ``KVStoreDevice``, whose
reduction of a list of values pushed for one key is their sum (:84), and
``KVStoreNCCL`` for the ``nccl`` / ``tpu`` names (:713-724), the same sum;
``KVStoreDist`` in sync mode; and ``create`` (:727).

A store keeps its own copy of every value (``init`` clones). A push with no
updater replaces the stored value by the reduced one; with an updater
(``set_optimizer``: the optimizer's ``Updater``, the reference's
server-side optimizer) it calls ``updater(key, reduced, stored)``, which
updates the stored weight in place. ``pull`` copies the stored value out.

``KVStoreDist`` (``dist``, ``dist_sync``, ``dist_sync_device``,
``dist_device_sync``) joins the ``torch.distributed`` job of the reference's
environment names (``_dist_util.init_process_group`` on the card, unless a
process group is already set up) and sums a pushed value over the workers
with one ``all_reduce`` in float32, per key (``_cross``, :691) or per flat
bucket of a list (``_cross_bucket``, :675). ``init`` broadcasts rank 0's
value, as the reference's server keeps the first worker's.

What waits for later slices raises ``MXNetError`` naming its ROADMAP item:
``dist_async`` (the parameter server of ``kvstore/ps.py``), gradient
compression (:282-322), and values of one key on several devices within a
process.
"""
from __future__ import annotations

import pickle
from typing import Callable, Dict, List, Optional, Union

import torch

from ..base import MXNetError, env
from ..ndarray import NDArray
from .. import optimizer as opt_mod
from .. import _dist_util

_ASYNC = ("dist_async: the asynchronous parameter server (kvstore/ps.py) is not "
          "ported yet (ROADMAP A2)")
_COMPRESSION = ("gradient compression (2-bit, kvstore.py:282-322) is not ported "
                "yet (ROADMAP A2)")
_MULTI_DEVICE = ("values of one key on several devices in one process are not "
                 "ported (ROADMAP A2: one device per process)")


def _tensor(v) -> torch.Tensor:
    if not isinstance(v, NDArray):
        raise MXNetError(f"kvstore values are NDArrays, got {type(v).__name__}")
    return v._data


class KVStore:
    """The in-process store (the reference's base class)."""

    def __init__(self):
        self._store: Dict[Union[int, str], NDArray] = {}
        self._updater: Optional[Callable] = None
        self._opt_updater: Optional[opt_mod.Updater] = None

    # -- identity ----------------------------------------------------------
    @property
    def type(self):
        return "local"

    @property
    def rank(self):
        return 0

    @property
    def num_workers(self):
        return 1

    def get_rank(self):
        return self.rank

    def get_group_size(self):
        return self.num_workers

    # -- data ----------------------------------------------------------------
    @staticmethod
    def _normalize(key, value):
        if isinstance(key, (list, tuple)):
            if not isinstance(value, (list, tuple)) or len(value) != len(key):
                raise MXNetError(f"{len(key)} keys need as many values")
            return list(key), list(value)
        return [key], [value]

    def init(self, key, value):
        keys, values = self._normalize(key, value)
        for k, v in zip(keys, values):
            if k in self._store:
                raise MXNetError(f"key {k} already initialized")
            v = v[0] if isinstance(v, (list, tuple)) else v
            self._store[k] = NDArray(_tensor(v).detach().clone(), v.ctx)

    def _reduce(self, vals: List[NDArray]) -> torch.Tensor:
        """The sum of the values pushed for one key (one per device in the
        reference; all on one device here)."""
        ts = [_tensor(v) for v in vals]
        if len({t.device for t in ts}) > 1:
            raise MXNetError(_MULTI_DEVICE)
        acc = ts[0]
        for t in ts[1:]:
            acc = acc + t
        return acc

    def _cross(self, merged: torch.Tensor) -> torch.Tensor:
        """The sum over workers; the identity in one process."""
        return merged

    def _cross_bucket(self, flat: torch.Tensor) -> torch.Tensor:
        """The sum over workers of one flat bucket; the identity in one process."""
        return flat

    def _apply(self, k, merged: torch.Tensor) -> NDArray:
        """Store the reduced value ``merged`` of key ``k`` (by the updater,
        or replacing it) and return what a pull then gives."""
        if k not in self._store:
            raise MXNetError(f"key {k} not initialized")
        stored = self._store[k]
        if self._updater is not None:
            self._updater(k, NDArray(merged, stored.ctx), stored)
        else:
            with torch.no_grad():
                stored._data.copy_(merged)
        return stored

    @staticmethod
    def _write(out, src: torch.Tensor):
        for t in (out if isinstance(out, (list, tuple)) else [out]):
            with torch.no_grad():
                _tensor(t).copy_(src)

    def push(self, key, value, priority=0):
        keys, values = self._normalize(key, value)
        for k, v in zip(keys, values):
            vlist = v if isinstance(v, (list, tuple)) else [v]
            self._apply(k, self._cross(self._reduce(vlist)))

    def pull(self, key, out=None, priority=0, ignore_sparse=True):
        keys, outs = self._normalize(key, out)
        for k, o in zip(keys, outs):
            if k not in self._store:
                raise MXNetError(f"key {k} not initialized")
            self._write(o, self._store[k]._data)

    def pushpull(self, key, value, out=None, priority=0):
        """Push, then pull into ``out`` (reference ``MXKVStorePushPullEx``).
        A list of keys with no updater is reduced by buckets: the values are
        flattened into float32 buckets of at most ``MXNET_TPU_BUCKET_BYTES``
        and summed over the workers with one collective each (:165)."""
        keys, values = self._normalize(key, value)
        outs = self._normalize(key, out)[1] if out is not None else [None] * len(keys)
        if self._updater is None and len(keys) > 1:
            self._pushpull_bucketed(keys, values, outs)
            return
        for k, v, o in zip(keys, values, outs):
            vlist = v if isinstance(v, (list, tuple)) else [v]
            merged = self._cross(self._reduce(vlist))
            src = self._apply(k, merged)._data if k in self._store else merged
            if o is not None:
                self._write(o, src)

    def _pushpull_bucketed(self, keys, values, outs):
        merged = [self._reduce(v if isinstance(v, (list, tuple)) else [v]) for v in values]
        if not all(m.is_floating_point() for m in merged):
            raise MXNetError("a bucketed pushpull takes floating-point values")
        sizes = [(i, m.numel() * 4) for i, m in enumerate(merged)]
        for idx in _dist_util.plan_buckets(sizes, int(env.get("MXNET_TPU_BUCKET_BYTES"))):
            flat = torch.cat([merged[i].reshape(-1).float() for i in idx])
            flat = self._cross_bucket(flat)
            off = 0
            for i in idx:
                n = merged[i].numel()
                part = flat[off:off + n].view(merged[i].shape).to(merged[i].dtype)
                off += n
                k = keys[i]
                src = self._apply(k, part)._data if k in self._store else part
                if outs[i] is not None:
                    self._write(outs[i], src)

    def broadcast(self, key, value, out, priority=0):
        self.init(key, value)
        self.pull(key, out, priority)

    # -- optimizer -----------------------------------------------------------
    def set_optimizer(self, optimizer: "opt_mod.Optimizer"):
        self._opt_updater = opt_mod.get_updater(optimizer)
        self._updater = self._opt_updater

    def set_updater(self, updater: Callable):
        self._updater = updater

    @property
    def updater(self):
        return self._updater

    def set_gradient_compression(self, compression_params):
        raise MXNetError(_COMPRESSION)

    # -- sync / lifecycle ------------------------------------------------------
    def barrier(self):
        pass

    def save_optimizer_states(self, fname, dump_optimizer=False):
        if self._opt_updater is None:
            raise MXNetError("no optimizer set on kvstore")
        with open(fname, "wb") as f:
            f.write(self._opt_updater.get_states(dump_optimizer))

    def load_optimizer_states(self, fname):
        """Load states this program saved (the file is unpickled)."""
        if self._opt_updater is None:
            raise MXNetError("no optimizer set on kvstore")
        with open(fname, "rb") as f:
            self._opt_updater.set_states(f.read())

    def get_num_dead_node(self, node_id=0):
        return 0


class KVStoreLocal(KVStore):
    @property
    def type(self):
        return "local"


class KVStoreDevice(KVStore):
    @property
    def type(self):
        return "device"


class KVStoreNCCL(KVStore):
    """The ``nccl`` / ``tpu`` names: in one process with one device the same
    sum as ``device`` (the reference's ``KVStoreTPU``)."""

    @property
    def type(self):
        return "nccl"


class KVStoreDist(KVStore):
    """``dist_sync``: the sum over the workers of a ``torch.distributed``
    job, one ``all_reduce`` in float32 per key or per bucket."""

    def __init__(self):
        super().__init__()
        import torch.distributed as dist
        if not dist.is_initialized():
            _dist_util.init_process_group()
        self._dist = dist

    @property
    def type(self):
        return "dist_sync"

    @property
    def rank(self):
        return self._dist.get_rank()

    @property
    def num_workers(self):
        return self._dist.get_world_size()

    def init(self, key, value):
        """Rank 0's value wins and is broadcast to every worker."""
        super().init(key, value)
        for k in self._normalize(key, value)[0]:
            self._dist.broadcast(self._store[k]._data, src=0)

    def _all_reduce_f32(self, t: torch.Tensor) -> torch.Tensor:
        acc = t.float().contiguous().clone()
        self._dist.all_reduce(acc)
        return acc

    def _cross(self, merged):
        return self._all_reduce_f32(merged).to(merged.dtype)

    def _cross_bucket(self, flat):
        return self._all_reduce_f32(flat)

    def barrier(self):
        self._dist.barrier()


_KVSTORE_TYPES = {
    "local": KVStoreLocal,
    "local_allreduce_cpu": KVStoreLocal,
    "local_allreduce_device": KVStoreDevice,
    "device": KVStoreDevice,
    "nccl": KVStoreNCCL,
    "tpu": KVStoreNCCL,
    "dist": KVStoreDist,
    "dist_sync": KVStoreDist,
    "dist_device_sync": KVStoreDist,
    "dist_sync_device": KVStoreDist,
}
_DEFERRED = {"dist_async": _ASYNC, "dist_async_device": _ASYNC,
             "dist_device_async": _ASYNC}


def check_type(name) -> str:
    """The lower-cased store name; raises for an unknown or deferred one."""
    if not isinstance(name, str):
        raise MXNetError("kvstore name must be a string")
    key = name.lower()
    if key in _DEFERRED:
        raise MXNetError(f"kvstore {name!r}: {_DEFERRED[key]}")
    if key not in _KVSTORE_TYPES:
        raise MXNetError(f"unknown kvstore type {name!r}")
    return key


def create(name="local") -> KVStore:
    """reference src/kvstore/kvstore.cc:40 factory."""
    return _KVSTORE_TYPES[check_type(name)]()


__all__ = ["KVStore", "KVStoreLocal", "KVStoreDevice", "KVStoreNCCL", "KVStoreDist",
           "create"]
