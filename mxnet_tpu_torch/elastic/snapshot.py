"""Asynchronous sharded snapshots: ``SnapshotManager``.

Counterpart of ``mxnet_tpu/elastic/snapshot.py``. ``save`` sits between
training steps and must not hold the step path:

1. Copy on the device. The fused step updates the weights and the optimizer
   state in place (K4/K5), so a snapshot that read the live tensors while the
   next step runs would tear. ``save`` copies every device leaf this process
   owns into one fresh flat buffer per device, with one multi-tensor copy
   (``torch._foreach_copy_``) on the current stream: ordered after the step
   that produced the values and before the next one. It returns as soon as
   that copy is queued; no host transfer, no sync on the caller's thread.
   (The reference dispatches one ``jnp.copy`` per leaf, :96-139.)
2. Copy to the host off the step path. A side stream waits for the current
   one (``wait_stream``), copies each flat buffer into one pinned host buffer
   (``non_blocking=True``, reused from save to save) and records an event.
   The writer thread waits on that event only, never on
   ``torch.cuda.synchronize()``, which would wait for the steps after it too;
   then it drops the device buffer.
3. Write and commit in the background: the writer thread writes this
   process's owned chunks (``state.Chunk.owner``: a tensor-parallel shard
   once, each data-parallel rank its ZeRO shard, a replicated leaf from rank
   0) as ``shard-<rank>.npz``, and rank 0 commits the manifest once every
   rank's index landed (``manifest.commit`` with the world size), then
   prunes.
4. One write in flight: a new ``save`` first joins the previous writer, so
   the copies never exceed one model-and-optimizer footprint, and a failure
   of the background write re-raises at the next ``save`` or
   ``wait_until_finished``.

``last_stats`` holds the last save's numbers: ``wait_s`` (the time ``save``
waited for the previous write, the stall of an interval shorter than a
write), ``return_s`` (the time it then held the caller), ``copy_bytes``,
``device_extra_bytes`` (device memory the copy holds while in flight),
``d2d_ms`` and ``d2h_ms`` (CUDA events around each copy, summed over
devices), ``host_alloc_s``, ``write_s`` and ``nbytes``;
``save_seconds`` and ``bytes_written`` are the reference's. The reference's
telemetry (``mx_checkpoint_save_seconds``) and tracing spans wait for the
telemetry slice (ROADMAP A7).

With a ``coordinator`` (``elastic/coordinator.py``; reference :150-260) the
manager is one participant of the two-phase cross-host commit: this host's
index is the coordinator's rank; it writes only the chunks it owns (a
replicated leaf: rank 0's, or under ``partition_ownership`` the leaves
``coord.owns`` gives it) and its ready marker, and whoever the group view
makes leader writes the generation-stamped manifest once every live
member's marker landed (``commit_snapshot``); the leader prunes.
"""
from __future__ import annotations

import os
import threading
import time
from typing import Any, Dict, List, Optional

import numpy as _np
import torch

from ..base import MXNetError, env
from . import manifest as _manifest
from .state import Chunk

__all__ = ["SnapshotManager"]

env.declare("MXNET_TPU_SNAPSHOT_EVERY", 0, int,
            "Default SnapshotManager save interval in steps (0 = only explicit or "
            "forced saves); elastic.run() consults should_save")

_ALIGN = 256      # bytes between leaves in a flat copy buffer


def _process():
    """(this process's index, the number of processes) of the snapshot."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


class _DeviceCopy:
    """One device's leaves, copied into one flat buffer on the current
    stream, then to pinned host memory on a side stream."""

    def __init__(self, device, items, side_stream):
        self.device = device
        self.names = [n for n, _ in items]
        offs, off = [], 0
        for _, t in items:
            offs.append(off)
            off += -(-t.numel() * t.element_size() // _ALIGN) * _ALIGN
        self.specs = [(o, t.shape, t.dtype, t.numel() * t.element_size())
                      for o, (_, t) in zip(offs, items)]
        self.nbytes = off
        cur = torch.cuda.current_stream(device)
        self.start, self.mid = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        self.flat = torch.empty(off, dtype=torch.uint8, device=device)
        views = self._views(self.flat)
        self.start.record(cur)
        torch._foreach_copy_(views, [t for _, t in items])
        self.mid.record(cur)
        self.side = side_stream
        self.side.wait_stream(cur)

    def _views(self, flat) -> List[torch.Tensor]:
        return [flat[o:o + n].view(dt).view(shape) for o, shape, dt, n in self.specs]

    def to_host(self, host: torch.Tensor):
        """Queue the copy into ``host`` (pinned, ``nbytes``) on the side
        stream, between two events."""
        self.d2h_start, self.end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        with torch.cuda.stream(self.side):
            self.d2h_start.record(self.side)
            host.copy_(self.flat, non_blocking=True)
            self.end.record(self.side)

    def finish(self, host: torch.Tensor) -> Dict[str, _np.ndarray]:
        """Wait for the host copy, free the device buffer, and give each
        leaf's host array (views into ``host``)."""
        self.end.synchronize()
        self.flat = None
        arr = host.numpy()
        return {name: arr[o:o + n].view(_np.dtype(str(dt).rpartition(".")[2]))
                .reshape(tuple(shape))
                for name, (o, shape, dt, n) in zip(self.names, self.specs)}


class SnapshotManager:
    """Step-indexed asynchronous sharded snapshots with retention and an
    atomic commit; see the module docstring. ``save(step, snapshot)`` takes
    ``{"leaves": {name: value}, "meta": {...}}`` (``elastic.state.capture``):
    a value is a tensor (a replicated leaf), a ``state.Chunk`` or a host
    array; meta must be JSON-serializable."""

    def __init__(self, directory: str, max_to_keep: int = 3,
                 save_interval_steps: Optional[int] = None, coordinator=None):
        self.coordinator = coordinator
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.max_to_keep = int(max_to_keep)
        self.save_interval_steps = int(env.get("MXNET_TPU_SNAPSHOT_EVERY")
                                       if save_interval_steps is None
                                       else save_interval_steps)
        self._writer: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._last_saved: Optional[int] = None
        self._side: Dict[torch.device, Any] = {}
        self._pinned: Dict[torch.device, torch.Tensor] = {}
        self.save_seconds = 0.0
        self.bytes_written = 0
        self.last_stats: Dict[str, Any] = {}

    # -- policy ----------------------------------------------------------------
    def should_save(self, step) -> bool:
        """Save every ``save_interval_steps`` steps, never one step twice."""
        k = self.save_interval_steps
        return k > 0 and step > 0 and step % k == 0 and step != self._last_saved

    # -- the step path -----------------------------------------------------------
    def save(self, step, snapshot: Dict[str, Any], wait: bool = False):
        """Snapshot asynchronously: returns once the device copies are queued
        (and, with ``wait=True``, once this process's shard is written and, on
        process 0, the snapshot committed)."""
        t_wait = time.perf_counter()
        self.wait_until_finished()
        t0 = time.perf_counter()
        meta = dict(snapshot.get("meta") or {})
        meta.setdefault("step", step)
        host, devices, stats = self._copy_leaves(snapshot["leaves"])
        self._last_saved = step
        self._writer = threading.Thread(target=self._write,
                                        args=(step, host, devices, meta, t0, stats),
                                        daemon=True, name=f"mx-snapshot-{step}")
        self._writer.start()
        stats["return_s"] = time.perf_counter() - t0
        stats["wait_s"] = t0 - t_wait
        self.last_stats = stats
        if wait:
            self.wait_until_finished()

    def _copy_leaves(self, leaves: Dict[str, Any]):
        """``(host, devices, stats)``: the host leaves copied now (arrays, the
        chunks of CPU tensors), and a ``_DeviceCopy`` per CUDA device for the
        owned device leaves. Leaves this process does not own are not
        copied."""
        host: Dict[str, Any] = {}
        on_device: Dict[torch.device, list] = {}
        coord = self.coordinator
        partition = coord is not None and coord.partition_ownership
        for name, v in leaves.items():
            chunk = v if isinstance(v, Chunk) else None
            data = chunk.data if chunk is not None else v
            if chunk is not None and not chunk.owner:
                continue
            if chunk is None and partition and not coord.owns(name):
                continue
            if isinstance(data, torch.Tensor) and data.device.type == "cuda":
                on_device.setdefault(data.device, []).append((name, v))
                continue
            if isinstance(data, torch.Tensor):
                data = data.detach().to("cpu", copy=True).numpy()
            else:
                data = _np.array(data)      # a copy: the caller may mutate it
            host[name] = Chunk(data, chunk.shape, chunk.index, True) \
                if chunk is not None else data
        stats = {"copy_bytes": 0, "device_extra_bytes": 0}
        devices = []
        for device, items in on_device.items():
            side = self._side.get(device)
            if side is None:
                side = self._side[device] = torch.cuda.Stream(device)
            before = torch.cuda.memory_allocated(device)
            tensors = [(n, (v.data if isinstance(v, Chunk) else v).detach())
                       for n, v in items]
            with torch.cuda.device(device):
                dc = _DeviceCopy(device, tensors, side)
            dc.leaves = dict(items)
            stats["device_extra_bytes"] += torch.cuda.memory_allocated(device) - before
            stats["copy_bytes"] += dc.nbytes
            devices.append(dc)
        return host, devices, stats

    # -- the background writer ---------------------------------------------------
    def _host_buffer(self, device, nbytes) -> torch.Tensor:
        buf = self._pinned.get(device)
        if buf is None or buf.numel() < nbytes:
            buf = self._pinned[device] = torch.empty(nbytes, dtype=torch.uint8,
                                                     pin_memory=True)
        return buf[:nbytes]

    def _write(self, step, host, devices, meta, t0, stats):
        try:
            t_alloc = time.perf_counter()
            bufs = [self._host_buffer(dc.device, dc.nbytes) for dc in devices]
            stats["host_alloc_s"] = time.perf_counter() - t_alloc
            for dc, buf in zip(devices, bufs):
                dc.to_host(buf)
            d2d = d2h = 0.0
            for dc, buf in zip(devices, bufs):
                arrays = dc.finish(buf)
                d2d += dc.start.elapsed_time(dc.mid)
                d2h += dc.d2h_start.elapsed_time(dc.end)
                for name, arr in arrays.items():
                    v = dc.leaves[name]
                    host[name] = Chunk(arr, v.shape, v.index, True) \
                        if isinstance(v, Chunk) else arr
            stats.update(d2d_ms=d2d, d2h_ms=d2h)
            del devices
            t_w = time.perf_counter()
            nbytes, sdir, proc, nproc = self._write_entries(step, host)
            stats["write_s"] = time.perf_counter() - t_w
            stats["nbytes"] = nbytes
            if self.coordinator is not None:
                self._commit_coordinated(sdir, step, meta, nbytes)
            elif proc == 0:
                _manifest.commit(sdir, step, meta, expected_processes=nproc)
                _manifest.prune(self.directory, self.max_to_keep)
            self.save_seconds = time.perf_counter() - t0
            self.bytes_written += int(nbytes)
        except BaseException as e:  # surfaced at the next save() or wait
            self._error = e

    def _commit_coordinated(self, sdir, step, meta, nbytes):
        """The two-phase commit: this host's ready marker, then the
        leader-written manifest; the leader prunes (``prune`` skips a
        directory a live peer is still writing)."""
        coord = self.coordinator
        coord.write_marker(sdir, step, nbytes)
        coord.commit_snapshot(sdir, step, meta)
        if coord.view(bump=False).leader == coord.rank:
            _manifest.prune(self.directory, self.max_to_keep)

    def _write_entries(self, step, host):
        sdir = _manifest.step_path(self.directory, step)
        os.makedirs(sdir, exist_ok=True)
        proc, nproc = _process()
        coord = self.coordinator
        if coord is not None:
            proc = coord.rank        # the control plane names this host
        partition = coord is not None and coord.partition_ownership
        entries = []
        for name, v in host.items():
            if isinstance(v, Chunk):
                entries.append((name, v.index, v.data, v.shape, v.data.dtype))
            elif partition or proc == 0:
                arr = _np.asarray(v)
                entries.append((name, [(0, d) for d in arr.shape], arr, arr.shape,
                                arr.dtype))
        nbytes = _manifest.write_shard(sdir, proc, entries)
        return nbytes, sdir, proc, nproc

    # -- lifecycle ---------------------------------------------------------------
    def wait_until_finished(self):
        """Join the writer in flight; re-raises its failure (a snapshot that
        failed silently is worse than a save that raised)."""
        w = self._writer
        if w is not None:
            w.join()
            self._writer = None
        if self._error is not None:
            err, self._error = self._error, None
            raise MXNetError(f"async snapshot write failed: {err!r}") from err

    def close(self):
        self.wait_until_finished()

    def __del__(self):
        w = getattr(self, "_writer", None)
        if w is not None:
            w.join(timeout=10)

    # -- introspection -----------------------------------------------------------
    def latest_step(self) -> Optional[int]:
        return _manifest.latest_complete_step(self.directory)

    def all_steps(self):
        return _manifest.all_complete_steps(self.directory)
