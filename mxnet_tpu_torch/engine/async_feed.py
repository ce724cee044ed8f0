"""The async device feed and the bounded in-flight step window.

Counterpart of ``mxnet_tpu/engine/async_feed.py``, the reference's analog of
MXNet's asynchronous dependency engine: Python issues work and does not
wait; what it must not do is serialize the loop around the step (batch
assembly, the host-to-device copy, a loss read every iteration). Three
parts, with the reference's names and knobs:

- **DeviceFeed** (reference :344) wraps a ``DataIter``, a Gluon
  ``DataLoader`` or any re-iterable of batches and runs one producer
  thread. On a CUDA device the producer stages each array leaf in pinned
  host memory and copies it with ``non_blocking=True`` on a copy stream of
  its own, which then records an event. ``next()`` makes the consumer's
  current stream wait on that event (the host does not wait) and calls
  ``record_stream`` on each leaf, so the caching allocator does not hand
  the batch's memory to another copy while the step still reads it. So
  batch i+1's copy overlaps step i. On the CPU the leaves are copied into
  tensors of their own. The queue holds ``MXNET_TPU_FEED_DEPTH`` batches
  (default 2). The batch order is exactly the wrapped iterator's (one
  producer, a FIFO), across ``reset()`` and a mid-epoch ``StopIteration``.
  ``for_trainer`` gives each rank of a trainer's mesh of ranks its part of
  the global batch under the trainer's ``data_spec`` (its ``dp`` rows, and
  under ``LongContextTrainer``'s ``P(dp, sp)`` its ``sp`` columns), cut on
  the host before the copy by the rule the trainer applies to a whole batch
  (``tensor_parallel.shard_tensor``); the trainer then takes the leaves as
  they are (``is_local``).
- **DispatchWindow** (reference :184): ``admit()`` records a CUDA event on
  the current stream after each issued step and, once more than
  ``MXNET_TPU_INFLIGHT_STEPS`` (default 2) are outstanding, blocks on the
  oldest step's event; depth 0 is synchronous. ``drain()`` is the
  boundary sync. ``wait_seconds`` accumulates the time blocked.
- **PendingScalar** (reference :105) is a loss or metric left on the
  device: ``float()``, ``.item()`` and ``.asnumpy()`` sync when it is read;
  holding it or ``repr()`` does not. ``drain(values)`` reads a collection
  of them at a boundary.

Telemetry (while ``telemetry`` is enabled): ``mx_feed_queue_depth``,
``mx_feed_stall_seconds_total``, ``mx_inflight_steps``,
``mx_dispatch_wait_seconds_total``, the producer's restarts and leaks; with
tracing armed, the spans ``mx.feed.produce``, ``mx.feed.put``,
``mx.window.admit`` and ``mx.window.drain``. A supervised producer
(``MXNET_TPU_FEED_RESTARTS``) re-opens its source after a transient error
or an injected fault at ``feed.produce`` and fast-forwards past what it
delivered.
"""
from __future__ import annotations

import queue
import threading
import time
from collections import deque
from typing import Any, Optional

import numpy as _np
import torch

from ..base import MXNetError, env
from ..telemetry import tracing as _tracing

__all__ = ["DeviceFeed", "DispatchWindow", "PendingScalar", "drain",
           "feed_depth", "inflight_steps", "maybe_wrap", "is_local"]

env.declare("MXNET_TPU_FEED_DEPTH", 2, int,
            "DeviceFeed prefetch queue depth (batches staged on device "
            "ahead of the consumer); 0 disables the async feed wrap in "
            "fit loops")
env.declare("MXNET_TPU_INFLIGHT_STEPS", 2, int,
            "Max dispatched-but-incomplete training steps before the "
            "trainer blocks on the oldest one (0 = fully synchronous)")
env.declare("MXNET_TPU_FEED_GIL_INTERVAL", 0.001, float,
            "sys.setswitchinterval applied when a DeviceFeed producer "
            "starts (never raised, only lowered); 0 leaves the interpreter "
            "setting untouched")
env.declare("MXNET_TPU_FEED_RESTARTS", 0, int,
            "Bounded DeviceFeed producer restarts on transient source errors "
            "(OSError/ConnectionError/TimeoutError and injected faults); 0 "
            "surfaces the first error at next()")
env.declare("MXNET_TPU_FEED_JOIN_TIMEOUT", 5.0, float,
            "Seconds to wait (per drain round, two rounds) for a DeviceFeed "
            "producer thread to exit at stop/reset/close before abandoning it "
            "(counted in mx_feed_producer_leaks_total)")


def feed_depth() -> int:
    return int(env.get("MXNET_TPU_FEED_DEPTH"))


def inflight_steps() -> int:
    return int(env.get("MXNET_TPU_INFLIGHT_STEPS"))


# ---------------------------------------------------------------------------
# Lazy scalar handles
# ---------------------------------------------------------------------------

def _raw_of(v):
    """The tensor under an NDArray or PendingScalar (``v`` otherwise)."""
    if isinstance(v, PendingScalar):
        return v._raw
    data = getattr(v, "_data", None)
    return data if isinstance(data, torch.Tensor) else v


class PendingScalar:
    """A loss on the device that syncs only when read: ``float()``,
    ``item()``, ``asnumpy()`` and ``np.asarray`` wait for it; holding it or
    ``repr()`` does not. The fused trainers' ``step()`` returns one."""

    __slots__ = ("_raw",)

    def __init__(self, raw):
        self._raw = _raw_of(raw)

    @property
    def raw(self) -> torch.Tensor:
        """The tensor on the device (no sync)."""
        return self._raw

    def value(self):
        return self._raw

    def block_until_ready(self):
        _sync_tensor(self._raw)
        return self

    def __float__(self):
        v = float(self._raw.float().item())
        if _tracing._ENABLED:
            # the nonfinite-loss watchdog rides the sync the caller asked for
            _tracing.check_loss(v, source="pending_scalar")
        return v

    def item(self):
        return self.__float__()

    def asnumpy(self):
        return self._raw.detach().float().cpu().numpy()

    def __array__(self, dtype=None, copy=None):
        out = self.asnumpy()
        return out.astype(dtype) if dtype is not None else out

    @property
    def shape(self):
        return tuple(self._raw.shape)

    @property
    def dtype(self):
        return self._raw.dtype

    def __repr__(self):
        return f"PendingScalar({self._raw.dtype}, {self._raw.device})"


def _sync_tensor(t) -> None:
    if isinstance(t, torch.Tensor) and t.device.type == "cuda":
        torch.cuda.current_stream(t.device).synchronize()


def drain(values):
    """Wait for a (possibly nested) collection of pending step outputs and
    return the 0-d ones (and every ``PendingScalar``) as floats: the
    boundary sync of a loop that collected ``PendingScalar``s."""
    if isinstance(values, (list, tuple)):
        return type(values)(drain(v) for v in values)
    raw = _raw_of(values)
    if not isinstance(raw, torch.Tensor):
        return raw
    _sync_tensor(raw)
    if raw.dim() == 0 or isinstance(values, PendingScalar):
        v = float(raw.float().reshape(-1)[0].item())
        if _tracing._ENABLED:
            _tracing.check_loss(v, source="drain")
        return v
    return raw


# ---------------------------------------------------------------------------
# Bounded in-flight dispatch window
# ---------------------------------------------------------------------------

def _first_tensor(h):
    if isinstance(h, (list, tuple)):
        for v in h:
            t = _first_tensor(v)
            if t is not None:
                return t
        return None
    raw = _raw_of(h)
    return raw if isinstance(raw, torch.Tensor) else None


class DispatchWindow:
    """At most ``depth`` issued steps in flight (default
    ``MXNET_TPU_INFLIGHT_STEPS``): ``admit(handles)`` records a CUDA event
    on the current stream of the handles' device and blocks on the oldest
    admitted step's event once more than ``depth`` are outstanding, never
    on the step just admitted unless ``depth`` is 0. A step on the CPU has
    finished when it returns and records nothing."""

    def __init__(self, depth: Optional[int] = None, name: str = "step"):
        self.depth = inflight_steps() if depth is None else int(depth)
        self.name = name
        self._pending: "deque[Any]" = deque()
        self.retired = 0
        self.wait_seconds = 0.0
        self.max_inflight = 0

    def __len__(self):
        return len(self._pending)

    @staticmethod
    def _event(handles):
        t = _first_tensor(handles)
        if t is None or t.device.type != "cuda":
            return None
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(t.device))
        return ev

    def admit(self, handles):
        """Register one issued step; block on the oldest in flight while
        more than ``depth`` are."""
        self._pending.append(self._event(handles))
        wait0 = self.wait_seconds
        retired = 0
        t_first = 0.0
        while len(self._pending) > max(self.depth, 0):
            ev = self._pending.popleft()
            t0 = time.perf_counter()
            if retired == 0:
                t_first = t0
            if ev is not None:
                ev.synchronize()
            self.wait_seconds += time.perf_counter() - t0
            self.retired += 1
            retired += 1
        self.max_inflight = max(self.max_inflight, len(self._pending))
        if _tracing._ENABLED and retired:
            _tracing.record_span("mx.window.admit", t_first,
                                 t_first + (self.wait_seconds - wait0),
                                 source=self.name, retired=retired,
                                 inflight=len(self._pending))
        from .. import telemetry as _telem
        if _telem._ENABLED:
            _telem.record_inflight(len(self._pending), source=self.name)
            _telem.record_dispatch_wait(self.wait_seconds, source=self.name)

    def drain(self):
        """Block until every admitted step finished (a boundary)."""
        t_d0 = time.perf_counter() if _tracing._ENABLED else 0.0
        drained = 0
        while self._pending:
            ev = self._pending.popleft()
            t0 = time.perf_counter()
            if ev is not None:
                ev.synchronize()
            self.wait_seconds += time.perf_counter() - t0
            self.retired += 1
            drained += 1
        if _tracing._ENABLED:
            _tracing.record_span("mx.window.drain", t_d0,
                                 time.perf_counter(), source=self.name,
                                 drained=drained)
        from .. import telemetry as _telem
        if _telem._ENABLED:
            _telem.record_inflight(0, source=self.name)
            _telem.record_dispatch_wait(self.wait_seconds, source=self.name)


# ---------------------------------------------------------------------------
# The background device feed
# ---------------------------------------------------------------------------

_END = object()


def _bounded_put(q: "queue.Queue", item, stop: threading.Event) -> bool:
    """put() that gives up once the consumer asked the producer to stop."""
    while not stop.is_set():
        try:
            q.put(item, timeout=0.1)
            return True
        except queue.Full:
            continue
    return False


def is_local(t) -> bool:
    """Whether ``t`` is a rank's part of a batch that a ``DeviceFeed`` cut
    for a mesh of ranks (the trainer takes it as it is)."""
    return getattr(t, "_mx_feed_local", False)


def _torch_device(device) -> torch.device:
    if device is None:
        from ..context import current_context
        device = current_context()
    dev = getattr(device, "torch_device", device)
    dev = torch.device(dev)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


class DeviceFeed:
    """Wrap a batch source; deliver batches already on the device (see the
    module docstring).

    ``source`` is a ``DataIter`` (``next()``/``reset()``/``provide_data``),
    a Gluon ``DataLoader`` or any re-iterable of batches. Each item keeps
    its structure (``DataBatch``, tuples, single arrays); every array leaf
    (NDArray, tensor, numpy array) lands on ``device`` (a ``Context`` or
    ``torch.device``; default the current context), an NDArray as an
    NDArray, the others as tensors. With ``mesh`` and ``data_spec`` (what
    ``for_trainer`` passes) a leaf is first cut to this rank's part.

    The producer starts at the first ``next()``, keeps the source's order,
    passes exceptions on, and is joined by ``reset()``, ``close()`` and
    garbage collection."""

    def __init__(self, source, device=None, mesh=None, data_spec=None,
                 depth: Optional[int] = None, name: str = "feed",
                 restarts: Optional[int] = None):
        self._source = source
        self._device = _torch_device(device if device is not None
                                     else getattr(mesh, "device", None))
        self._mesh = mesh
        self._data_axes = ()
        if mesh is not None and getattr(mesh, "distributed", False) \
                and data_spec is not None:
            from ..parallel.tensor_parallel import spec_axes
            self._data_axes = tuple(spec_axes(data_spec))
        self._depth = max(feed_depth() if depth is None else int(depth), 1)
        self._max_restarts = int(env.get("MXNET_TPU_FEED_RESTARTS")
                                 if restarts is None else restarts)
        self.name = name
        self.batch_size = getattr(source, "batch_size", 0)
        self.restarts = 0            # producer restarts taken (supervised)
        self.producer_leaks = 0      # producer threads abandoned at join
        self._q: Optional[queue.Queue] = None
        self._stop: Optional[threading.Event] = None
        self._producer: Optional[threading.Thread] = None
        self._copy_stream = None
        self._eof = False
        self._peek = None
        self.stall_seconds = 0.0
        self.batches_delivered = 0
        # the resumable cursor: reset() calls on the source, batches handed
        # out this epoch, and a fast-forward the next producer consumes
        self._epoch = 0
        self._epoch_delivered = 0
        self._skip = 0

    @classmethod
    def for_trainer(cls, source, trainer, depth: Optional[int] = None,
                    name: str = "feed"):
        """A feed whose leaves land on the trainer's device as this rank's
        part of the batch under ``trainer.data_spec`` (the whole batch off a
        mesh of ranks)."""
        return cls(source, device=trainer.device.torch_device, mesh=trainer.mesh,
                   data_spec=getattr(trainer, "data_spec", None), depth=depth,
                   name=name)

    # -- placement -----------------------------------------------------------
    def _local(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's part of a host tensor (the trainer's ``_local``)."""
        if not self._data_axes:
            return t
        from ..parallel.tensor_parallel import local_part
        return local_part(t, self._data_axes, self._mesh)

    def _put_tensor(self, t: torch.Tensor) -> torch.Tensor:
        t = self._local(t if t.device.type == "cpu" else t.cpu())
        if self._device.type == "cuda":
            t = t.contiguous().pin_memory()
            out = t.to(self._device, non_blocking=True)
        else:
            out = t.clone()
        if self._data_axes:
            out._mx_feed_local = True
        return out

    def _place_leaf(self, v):
        from ..ndarray import NDArray
        from ..context import Context
        if isinstance(v, NDArray):
            return NDArray(self._put_tensor(v._data), Context.from_device(self._device))
        if isinstance(v, torch.Tensor):
            return self._put_tensor(v)
        if isinstance(v, _np.ndarray) or (hasattr(v, "__array__")
                                         and not isinstance(v, (str, bytes))):
            return self._put_tensor(torch.from_numpy(_np.ascontiguousarray(v)))
        return v

    def _place(self, item):
        from ..io.io import DataBatch
        if isinstance(item, DataBatch):
            return DataBatch(
                [self._place_leaf(d) for d in (item.data or [])] or None,
                [self._place_leaf(l) for l in (item.label or [])] or None,
                pad=item.pad, index=item.index, bucket_key=item.bucket_key,
                provide_data=item.provide_data,
                provide_label=item.provide_label)
        if isinstance(item, (list, tuple)):
            return type(item)(self._place_leaf(v) for v in item)
        return self._place_leaf(item)

    def _stage(self, item):
        """``(placed item, event)``: on a CUDA device the copies run on the
        feed's copy stream, whose event the consumer's stream waits on."""
        if self._device.type != "cuda":
            return self._place(item), None
        with torch.cuda.device(self._device), torch.cuda.stream(self._copy_stream):
            placed = self._place(item)
            ev = torch.cuda.Event()
            ev.record(self._copy_stream)
        return placed, ev

    # -- producer ------------------------------------------------------------
    _TRANSIENT = (OSError, ConnectionError, TimeoutError)

    def _produce(self, stop: threading.Event, q: "queue.Queue"):
        """The producer's body. With restarts budgeted, a transient source
        error (or an injected fault) re-opens the iterator and fast-forwards
        on the host past what was already queued, so every batch is
        delivered once, in order, and the restart is counted; any other
        error, or a spent budget, surfaces at the consumer's next()."""
        from .. import faults as _faults
        restarts_left = self._max_restarts
        produced = 0
        skip, self._skip = self._skip, 0
        root = _tracing.new_root(self.name) if _tracing._ENABLED else None
        while True:
            try:
                it = iter(self._source)
                for _ in range(skip + produced):
                    next(it)
                while not stop.is_set():
                    if _faults._ACTIVE:
                        _faults.check("feed.produce")
                    if _tracing._ENABLED:
                        t0 = time.perf_counter()
                        item = next(it)
                        t1 = time.perf_counter()
                        staged = self._stage(item)
                        t2 = time.perf_counter()
                        _tracing.record_span("mx.feed.produce", t0, t1,
                                             parent=root, source=self.name,
                                             batch=produced)
                        _tracing.record_span("mx.feed.put", t1, t2,
                                             parent=root, source=self.name,
                                             batch=produced)
                    else:
                        item = next(it)
                        staged = self._stage(item)
                    if not _bounded_put(q, staged, stop):
                        return
                    produced += 1
                return
            except StopIteration:
                _bounded_put(q, _END, stop)
                return
            except Exception as e:
                if restarts_left > 0 and not stop.is_set() and \
                        isinstance(e, self._TRANSIENT + (_faults.FaultInjected,)):
                    restarts_left -= 1
                    self.restarts += 1
                    from .. import telemetry as _telem
                    if _telem._ENABLED:
                        _telem.record_feed_producer_restart(self.name)
                    continue
                _bounded_put(q, e, stop)
                return

    def _ensure_producer(self):
        if self._producer is not None and self._producer.is_alive():
            return
        if self._q is None or self._producer is None:
            import sys
            iv = float(env.get("MXNET_TPU_FEED_GIL_INTERVAL"))
            if iv > 0 and sys.getswitchinterval() > iv:
                # producer and consumer share the GIL; the default 5 ms switch
                # interval stalls the issuing loop behind a producer mid-batch
                sys.setswitchinterval(iv)
            if self._device.type == "cuda" and self._copy_stream is None:
                self._copy_stream = torch.cuda.Stream(self._device)
            self._stop = threading.Event()
            self._q = queue.Queue(maxsize=self._depth)
            self._producer = threading.Thread(
                target=self._produce, args=(self._stop, self._q),
                daemon=True, name=f"mx-device-feed-{self.name}")
            self._producer.start()

    def _stop_producer(self):
        if self._producer is not None and self._stop is not None:
            self._stop.set()
            timeout = max(float(env.get("MXNET_TPU_FEED_JOIN_TIMEOUT")), 0.01)
            # unblock a producer stuck in put(), then join; drain again in
            # case it completed one more put before seeing the stop flag
            for _ in range(2):
                try:
                    while True:
                        self._q.get_nowait()
                except queue.Empty:
                    pass
                self._producer.join(timeout=timeout)
                if not self._producer.is_alive():
                    break
            if self._producer.is_alive():
                import warnings
                self.producer_leaks += 1
                warnings.warn(
                    f"DeviceFeed {self.name!r}: producer thread did not "
                    f"exit within {2 * timeout:.1f}s and was abandoned "
                    "(blocked inside the wrapped source?); the thread "
                    "leaks until the source unblocks; booked in "
                    "mx_feed_producer_leaks_total "
                    "(MXNET_TPU_FEED_JOIN_TIMEOUT tunes the wait)",
                    RuntimeWarning, stacklevel=3)
                from .. import telemetry as _telem
                if _telem._ENABLED:
                    _telem.record_feed_producer_leak(self.name)
        self._producer = None
        self._q = None
        self._stop = None

    # -- consumer protocol ---------------------------------------------------
    def _adopt(self, placed, ev):
        """Order the consumer's current stream after the batch's copies and
        tell the allocator that stream uses the batch."""
        stream = torch.cuda.current_stream(self._device)
        stream.wait_event(ev)

        def mark(v):
            t = v._data if hasattr(v, "_data") and isinstance(v._data, torch.Tensor) else v
            if isinstance(t, torch.Tensor) and t.device.type == "cuda":
                t.record_stream(stream)
        from ..io.io import DataBatch
        if isinstance(placed, DataBatch):
            for v in list(placed.data or []) + list(placed.label or []):
                mark(v)
        elif isinstance(placed, (list, tuple)):
            for v in placed:
                mark(v)
        else:
            mark(placed)
        return placed

    def next(self):
        if self._eof:
            raise StopIteration
        self._ensure_producer()
        t0 = None
        try:
            item = self._q.get_nowait()
        except queue.Empty:
            t0 = time.perf_counter()
            while True:
                try:
                    item = self._q.get(timeout=1.0)
                    break
                except queue.Empty:
                    if self._producer is None or not self._producer.is_alive():
                        raise MXNetError(
                            "DeviceFeed producer thread died without "
                            "delivering a batch or an error")
            self.stall_seconds += time.perf_counter() - t0
        from .. import telemetry as _telem
        if _telem._ENABLED:
            if t0 is not None:
                _telem.record_feed_stall(self.stall_seconds, source=self.name)
            _telem.record_feed_depth(self._q.qsize(), source=self.name)
        if item is _END:
            self._eof = True
            # the producer exited on its own; forget it so reset() restarts
            self._producer = None
            self._q = None
            self._stop = None
            raise StopIteration
        if isinstance(item, Exception):
            self._stop_producer()
            raise item
        placed, ev = item
        if ev is not None:
            placed = self._adopt(placed, ev)
        self.batches_delivered += 1
        self._epoch_delivered += 1
        return placed

    def __next__(self):
        return self.next()

    def __iter__(self):
        return self

    def iter_next(self):
        if self._peek is not None:
            return True
        try:
            self._peek = self.next()
            return True
        except StopIteration:
            return False

    def getdata(self):
        return self._peek.data if self._peek is not None else None

    def getlabel(self):
        return self._peek.label if self._peek is not None else None

    def getpad(self):
        return getattr(self._peek, "pad", 0) if self._peek is not None else 0

    def reset(self):
        """Stop and join the producer, reset the wrapped source, start a new
        epoch: one inner ``reset()`` a call, so seeded shuffles advance as
        they would without the wrapper."""
        self._stop_producer()
        self._peek = None
        self._eof = False
        self._epoch += 1
        self._epoch_delivered = 0
        self._skip = 0
        if hasattr(self._source, "reset"):
            self._source.reset()

    # -- resumable input -------------------------------------------------------
    def state_dict(self):
        """The cursor: the source's epoch and the batches consumed this epoch
        (a peeked, unused batch does not count), with the source's own state
        where it has one."""
        d = {"epoch": self._epoch,
             "cursor": self._epoch_delivered - (1 if self._peek is not None else 0),
             "delivered": self.batches_delivered}
        if hasattr(self._source, "state_dict"):
            d["source"] = self._source.state_dict()
        return d

    def load_state_dict(self, d):
        """Rewind to a saved cursor: the source's state (or as many resets
        as epochs), then a host-side fast-forward of ``cursor`` batches when
        the producer starts."""
        self._stop_producer()
        self._peek = None
        self._eof = False
        self._epoch = int(d.get("epoch", 0))
        src = d.get("source")
        if src is not None and hasattr(self._source, "load_state_dict"):
            self._source.load_state_dict(src)
        else:
            for _ in range(self._epoch):
                if hasattr(self._source, "reset"):
                    self._source.reset()
        self._skip = int(d.get("cursor", 0))
        self._epoch_delivered = int(d.get("cursor", 0))
        self.batches_delivered = int(d.get("delivered", self._epoch_delivered))

    def close(self):
        self._stop_producer()

    def __del__(self):
        try:
            self._stop_producer()
        except Exception:
            pass

    def __len__(self):
        return len(self._source)

    @property
    def provide_data(self):
        return getattr(self._source, "provide_data", None)

    @property
    def provide_label(self):
        return getattr(self._source, "provide_label", None)


def maybe_wrap(source, device=None, mesh=None, data_spec=None,
               name: str = "feed"):
    """``source`` in a DeviceFeed when the feed is on
    (``MXNET_TPU_FEED_DEPTH`` > 0), it is not one already, and the process
    is not one of several ranks; ``source`` otherwise."""
    if isinstance(source, DeviceFeed) or feed_depth() <= 0:
        return source
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1:
        return source
    return DeviceFeed(source, device=device, mesh=mesh, data_spec=data_spec,
                      name=name)
