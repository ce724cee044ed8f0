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

``dist_async`` (and ``dist_async_device``, ``dist_device_async``; reference
:380-640, ``create`` :727) is a real parameter server (``kvstore/ps.py``):
on a job of several workers every process runs a server thread for the keys
whose home it is (``_home``: crc32 of the key, modulo the workers); ``init``
seeds the home with rank 0's value and every rank waits until it is there;
``push`` sends the (reduced, compressed) value to the key's home, which
applies its updater on arrival with no barrier; ``pull`` fetches the home's
current value. ``set_optimizer``/``set_updater`` must run on every rank (each
hosts a server that needs the updater): each posts that it did to the job's
store and waits, up to 120 s, for every other rank's post. With one worker
it is the in-process store.

``set_gradient_compression({"type": "2bit", "threshold": t})`` (:282-322) on
a dist store quantizes each pushed value, plus the key's residual, to {-t,
0, +t} before the sum over workers, and keeps the quantization error as the
residual (error feedback); the in-process stores raise, as the reference's
``kvstore_local.h`` does. Values of one key on several devices within a
process raise (one device per process).
"""
from __future__ import annotations

import datetime
import zlib
from typing import Callable, Dict, List, Optional, Union

import torch

from ..base import MXNetError, env
from ..ndarray import NDArray
from .. import optimizer as opt_mod
from .. import _dist_util

_MULTI_DEVICE = ("values of one key on several devices in one process are not "
                 "supported: one device per process, a rank a device")


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
        self._compression: dict = {}
        self._comp_residual: Dict = {}

    def _supports_compression(self) -> bool:
        return False

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
            # device reduce, then the 2-bit quantization, then the sum over
            # workers: the compressed value is what crosses the wire
            self._apply(k, self._cross(self._compress(k, self._reduce(vlist))))

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
        if self._updater is None and not self._compression and len(keys) > 1:
            self._pushpull_bucketed(keys, values, outs)
            return
        for k, v, o in zip(keys, values, outs):
            vlist = v if isinstance(v, (list, tuple)) else [v]
            merged = self._cross(self._compress(k, self._reduce(vlist)))
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
        """2-bit gradient compression with error feedback (reference
        ``gradient_compression.cc:60`` ``SetTwoBitCompression``): dist stores
        only (module docstring); ``{"type": "none"}`` turns it off."""
        if not self._supports_compression():
            raise MXNetError(f"gradient compression is only supported on dist kvstore "
                             f"types (got {type(self).__name__}); use "
                             f"kv.create('dist_sync') or DataParallelTrainer(..., "
                             f"compression=...) for the fused step")
        params = dict(compression_params)
        ctype = params.get("type", "2bit")
        if ctype not in ("2bit", "none"):
            raise MXNetError(f"unsupported gradient compression {ctype!r}")
        self._compression = params if ctype != "none" else {}
        self._comp_residual = {}

    def _compress(self, key, merged: torch.Tensor) -> torch.Tensor:
        """``merged`` plus the key's residual, quantized to {-t, 0, +t}; the
        quantization error becomes the key's residual."""
        if not self._compression:
            return merged
        thr = float(self._compression.get("threshold", 0.5))
        res = self._comp_residual.get(key)
        g = merged + res if res is not None else merged
        q = torch.where(g >= thr, thr, torch.where(g <= -thr, -thr, 0.0)).to(g.dtype)
        self._comp_residual[key] = g - q
        return q.to(merged.dtype)

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
    job, one ``all_reduce`` in float32 per key or per bucket; ``dist_async``
    (``sync=False``): the parameter server of ``kvstore/ps.py``."""

    def __init__(self, sync: bool = True):
        super().__init__()
        import torch.distributed as dist
        if not dist.is_initialized():
            _dist_util.init_process_group()
        self._dist = dist
        self._sync = bool(sync)
        self._ps_server = self._ps_client = None
        self._updater_gen = 0
        self._updater_pub = set()
        if not self._sync and self.num_workers > 1:
            from . import ps as _ps
            self._ps_server = _ps.PSServer(lambda: self._updater)
            _ps.publish_address(self.rank, self._ps_server.port)
            self._ps_client = _ps.PSClient(_ps.resolve_address)

    def _supports_compression(self) -> bool:
        return True

    @property
    def type(self):
        return "dist_sync" if self._sync else "dist_async"

    @property
    def rank(self):
        return self._dist.get_rank()

    @property
    def num_workers(self):
        return self._dist.get_world_size()

    def _home(self, key) -> int:
        """The rank whose server holds ``key`` (reference ``EncodeDefaultKey``)."""
        return zlib.crc32(str(key).encode()) % self.num_workers

    def init(self, key, value):
        """Rank 0's value wins and is broadcast to every worker; under
        ``dist_async`` it also seeds the key's home, and every rank waits
        until the home has it."""
        super().init(key, value)
        keys = self._normalize(key, value)[0]
        for k in keys:
            self._dist.broadcast(self._store[k]._data, src=0)
        if self._ps_client is None:
            return
        from .ps import _pack
        for k in keys:
            if self.rank == 0:
                resp = self._ps_client.request(self._home(k),
                                               ("init", k, _pack(self._store[k]._data)))
                if resp[0] != "ok":
                    raise MXNetError(f"dist_async init of key {k} failed at its home "
                                     f"server: {resp}")
            self._ps_client.wait_ready(self._home(k), k)

    # -- the parameter server's paths ------------------------------------------------
    def push(self, key, value, priority=0):
        if self._ps_client is None:
            return super().push(key, value, priority)
        from .ps import _pack
        keys, values = self._normalize(key, value)
        for k, v in zip(keys, values):
            if k not in self._store:
                raise MXNetError(f"key {k} not initialized")
            vlist = v if isinstance(v, (list, tuple)) else [v]
            merged = self._compress(k, self._reduce(vlist))
            resp = self._ps_client.request(self._home(k), ("push", k, _pack(merged),
                                                           "default"))
            if resp[0] != "ok":
                raise MXNetError(f"dist_async push of key {k} failed: {resp}")

    def pull(self, key, out=None, priority=0, ignore_sparse=True):
        if self._ps_client is None:
            return super().pull(key, out, priority, ignore_sparse)
        keys, outs = self._normalize(key, out)
        for k, o in zip(keys, outs):
            cur = self._ps_client.pull_blocking(self._home(k), k)
            self._write(o, torch.from_numpy(cur))

    def pushpull(self, key, value, out=None, priority=0):
        if self._ps_client is None:
            return super().pushpull(key, value, out, priority)
        self.push(key, value, priority)
        if out is not None:
            self.pull(key, out, priority)

    # -- the server-side optimizer -------------------------------------------------
    def set_optimizer(self, optimizer: "opt_mod.Optimizer"):
        super().set_optimizer(optimizer)
        self._updater_installed_barrier()

    def set_updater(self, updater: Callable):
        super().set_updater(updater)
        self._updater_installed_barrier()

    def _updater_installed_barrier(self):
        """Under ``dist_async`` no rank may push before every home server has
        its updater (reference :589-634): each rank posts call number ``gen``
        to the job's store and waits for every rank's post; a rank that never
        calls fails the others after 120 s, naming it."""
        if self._ps_client is None:
            return
        from .ps import coordinator_kv
        st = coordinator_kv()
        gen = self._updater_gen + 1
        if gen not in self._updater_pub:
            st.set(f"mxtpu_ps_updater/{gen}/{self.rank}", "1")
            self._updater_pub.add(gen)
        for r in range(self.num_workers):
            try:
                st.wait([f"mxtpu_ps_updater/{gen}/{r}"], datetime.timedelta(seconds=120))
            except Exception as e:  # noqa: BLE001 - the store's timeout error
                raise MXNetError(f"dist_async set_optimizer/set_updater must run on EVERY "
                                 f"rank (each process hosts a server needing its updater); "
                                 f"rank {r} did not install call #{gen} within 120s") from e
        self._updater_gen = gen

    # -- the synchronous sum -------------------------------------------------------
    def _all_reduce_f32(self, t: torch.Tensor) -> torch.Tensor:
        acc = t.float().contiguous().clone()
        self._dist.all_reduce(acc)
        return acc

    def _cross(self, merged):
        if not self._sync:
            return merged
        return self._all_reduce_f32(merged).to(merged.dtype)

    def _cross_bucket(self, flat):
        if not self._sync:
            return flat
        return self._all_reduce_f32(flat)

    def barrier(self):
        self._dist.barrier()

    def close(self):
        """Stop this rank's parameter server and drop its connections."""
        if self._ps_client is not None:
            self._ps_client.close()
        if self._ps_server is not None:
            self._ps_server.close()


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
_ASYNC_TYPES = ("dist_async", "dist_async_device", "dist_device_async")


def check_type(name) -> str:
    """The lower-cased store name; raises for an unknown one."""
    if not isinstance(name, str):
        raise MXNetError("kvstore name must be a string")
    key = name.lower()
    if key not in _KVSTORE_TYPES and key not in _ASYNC_TYPES:
        raise MXNetError(f"unknown kvstore type {name!r}")
    return key


def create(name="local") -> KVStore:
    """reference src/kvstore/kvstore.cc:40 factory."""
    key = check_type(name)
    if key in _ASYNC_TYPES:
        return KVStoreDist(sync=False)
    return _KVSTORE_TYPES[key]()


__all__ = ["KVStore", "KVStoreLocal", "KVStoreDevice", "KVStoreNCCL", "KVStoreDist",
           "create"]
