"""Deterministic fault injection and bounded IO retry.

Counterpart of ``mxnet_tpu/faults/__init__.py``. Named injection points are
threaded through the elastic snapshot IO (``elastic/manifest.py``:
``elastic.write_shard``, ``elastic.commit``, ``elastic.read``) and the
multi-host coordinator's (``elastic/coordinator.py``: ``elastic.heartbeat``,
``elastic.barrier``, ``elastic.marker``); ``points()`` is the catalog, and fire ``FaultInjected`` on the attempts their schedules
name (``faults/schedule.py``), so every recovery path runs in exact,
replayable tests.

- Off by default: call sites guard with ``if faults._ACTIVE:
  faults.check(point)``, one attribute load and a branch when disarmed.
- Deterministic: a schedule is a function of the per-point attempt counter
  (and of a private seeded stream for ``p:``).
- Process-wide: armed by ``MXNET_TPU_FAULTS=<spec>`` at import, or by
  ``inject(point, schedule)`` / the ``injected(...)`` context manager.

``io_retry`` is the bounded exponential-backoff retry with full jitter for
transient IO (``OSError`` and injected faults) that the elastic writer and
reader run under; a non-transient ``MXNetError`` (a lost commit fence, a
validation error) is never retried. With telemetry on, a fired fault books
``mx_faults_injected_total{point}`` and a retry ``mx_io_retries_total{point}``;
with tracing armed, each is a flight-recorder event (``mx.fault``,
``mx.io_retry``) and each attempt a span ``mx.io.<point>`` (reference
:144-276).
"""
from __future__ import annotations

import random
import threading
import time
from contextlib import contextmanager
from typing import Dict, Optional, Union

from ..base import MXNetError, env
from .schedule import (Schedule, EveryNth, FirstK, SeededProbability,
                       parse_schedule, parse_spec)

__all__ = ["FaultInjected", "Schedule", "EveryNth", "FirstK",
           "SeededProbability", "parse_schedule", "parse_spec",
           "declare_point", "points", "inject", "injected", "clear",
           "armed", "check", "attempts", "fired", "install_from_env",
           "io_retry"]

env.declare("MXNET_TPU_FAULTS", "", str,
            "Arm the fault-injection plane at import: point=schedule[;point=schedule...] "
            "where schedule is every_nth:N, first_k:K, or p:P[:seedS]; empty = disarmed")
env.declare("MXNET_TPU_IO_RETRIES", 3, int,
            "Bounded retries for transient elastic IO failures (OSError + injected "
            "faults) around each io_retry-wrapped operation; 0 disables retry")
env.declare("MXNET_TPU_IO_BACKOFF", 0.05, float,
            "Base delay (seconds) for io_retry exponential backoff; the k-th retry "
            "sleeps uniform(0, min(cap, base*2^k)) (full jitter)")
env.declare("MXNET_TPU_IO_BACKOFF_MAX", 1.0, float,
            "Backoff delay cap (seconds) for io_retry")


class FaultInjected(MXNetError):
    """Raised by an armed injection point. A transient-style error: the retry
    layers treat it as an ``OSError`` from the real world, so injected faults
    exercise the recovery path real ones take."""

    def __init__(self, point: str, attempt: int):
        super().__init__(f"injected fault at {point!r} (attempt {attempt})")
        self.point = point
        self.attempt = attempt


# the disarmed-path guard: call sites read this module attribute before
# calling check()
_ACTIVE = False

_LOCK = threading.Lock()
_POINTS: Dict[str, str] = {}       # name -> where it is threaded
_SCHEDULES: Dict[str, Schedule] = {}
_ATTEMPTS: Dict[str, int] = {}     # 1-based check() count per point
_FIRED: Dict[str, int] = {}


def declare_point(name: str, doc: str = ""):
    """Register an injection point in the catalog (idempotent). Sites may
    check undeclared points too; ``inject`` adds them."""
    with _LOCK:
        _POINTS.setdefault(name, doc)


for _name, _doc in (
    ("elastic.write_shard", "shard .npz/.json payload+index write "
                            "(elastic/manifest.py write_shard)"),
    ("elastic.commit", "manifest merge + atomic rename (elastic/manifest.py commit)"),
    ("elastic.read", "snapshot manifest/chunk reads "
                     "(elastic/manifest.py load + SnapshotReader)"),
    ("feed.produce", "DeviceFeed producer next() on the wrapped source "
                     "(engine/async_feed.py)"),
    ("elastic.heartbeat", "coordinator membership heartbeat write "
                          "(elastic/coordinator.py heartbeat)"),
    ("elastic.barrier", "coordinator generation/stop barrier IO "
                        "(elastic/coordinator.py generation epoch, stop intent + acks)"),
    ("elastic.marker", "per-host ready-marker write in the two-phase cross-host commit "
                       "(elastic/coordinator.py write_marker)"),
):
    declare_point(_name, _doc)


def points() -> Dict[str, str]:
    """The injection-point catalog: name -> where it is threaded."""
    with _LOCK:
        return dict(_POINTS)


def check(point: str):
    """Count one attempt at ``point`` and raise ``FaultInjected`` if the
    armed schedule says this attempt fires."""
    with _LOCK:
        n = _ATTEMPTS.get(point, 0) + 1
        _ATTEMPTS[point] = n
        sched = _SCHEDULES.get(point)
        fire = sched is not None and sched.fires(n)
        if fire:
            _FIRED[point] = _FIRED.get(point, 0) + 1
    if fire:
        from .. import telemetry as _telem
        if _telem._ENABLED:
            _telem.record_fault_injected(point)
        from ..telemetry import tracing as _tracing
        if _tracing._ENABLED:
            # every injected fault is a flight-recorder event
            _tracing.event("mx.fault", point=point, attempt=n)
        raise FaultInjected(point, n)


def inject(point: str, schedule: Union[Schedule, str]):
    """Arm ``point`` with a schedule (instance or spec string)."""
    global _ACTIVE
    if isinstance(schedule, str):
        schedule = parse_schedule(schedule)
    if not isinstance(schedule, Schedule):
        raise MXNetError(f"inject needs a Schedule or spec string, "
                         f"got {type(schedule).__name__}")
    with _LOCK:
        _POINTS.setdefault(point, "")
        _SCHEDULES[point] = schedule
        _ACTIVE = True


def clear(point: Optional[str] = None):
    """Disarm one point, or the whole plane (and reset the counters) when
    called without arguments."""
    global _ACTIVE
    with _LOCK:
        if point is None:
            _SCHEDULES.clear()
            _ATTEMPTS.clear()
            _FIRED.clear()
        else:
            _SCHEDULES.pop(point, None)
        _ACTIVE = bool(_SCHEDULES)


@contextmanager
def injected(point: str, schedule: Union[Schedule, str]):
    """Arm ``point`` for the block, disarm on exit."""
    inject(point, schedule)
    try:
        yield
    finally:
        clear(point)


def armed() -> Dict[str, str]:
    """Currently armed points -> schedule spec."""
    with _LOCK:
        return {p: s.spec() for p, s in _SCHEDULES.items()}


def attempts(point: str) -> int:
    with _LOCK:
        return _ATTEMPTS.get(point, 0)


def fired(point: str) -> int:
    with _LOCK:
        return _FIRED.get(point, 0)


def install_from_env():
    """Arm the plane from ``MXNET_TPU_FAULTS`` (called at import; a bad spec
    fails here rather than running without the faults it asked for)."""
    spec = str(env.get("MXNET_TPU_FAULTS") or "").strip()
    if not spec:
        return
    for point, sched in parse_spec(spec):
        inject(point, sched)


def io_retry(point: str, fn, *args, retries: Optional[int] = None,
             backoff: Optional[float] = None, **kwargs):
    """``fn(*args, **kwargs)`` with ``point`` checked on every attempt and the
    transient failures (``OSError`` and injected faults) retried.

    The budget is ``MXNET_TPU_IO_RETRIES`` (or ``retries``); the k-th retry
    sleeps ``uniform(0, min(cap, base * 2**(k-1)))`` with base
    ``MXNET_TPU_IO_BACKOFF`` (or ``backoff``) and cap
    ``MXNET_TPU_IO_BACKOFF_MAX``: full jitter, so writers contending for one
    filesystem decorrelate. ``MXNetError``s other than ``FaultInjected`` are
    never retried: retrying a fenced-out writer is the interleaving the
    commit lease exists to prevent."""
    budget = int(env.get("MXNET_TPU_IO_RETRIES")) if retries is None else int(retries)
    base = float(env.get("MXNET_TPU_IO_BACKOFF")) if backoff is None else float(backoff)
    cap = float(env.get("MXNET_TPU_IO_BACKOFF_MAX"))
    from ..telemetry import tracing as _tracing
    attempt = 0
    while True:
        t0 = time.perf_counter() if _tracing._ENABLED else 0.0
        try:
            if _ACTIVE:
                check(point)
            out = fn(*args, **kwargs)
            if _tracing._ENABLED:
                _tracing.record_span("mx.io." + point, t0, time.perf_counter(),
                                     attempt=attempt, status="ok")
            return out
        except FaultInjected:
            if _tracing._ENABLED:
                _tracing.record_span("mx.io." + point, t0, time.perf_counter(),
                                     attempt=attempt, status="fault")
            if attempt >= budget:
                raise
        except MXNetError:
            raise               # permanent by design (fence, validation)
        except OSError as e:
            if _tracing._ENABLED:
                _tracing.record_span("mx.io." + point, t0, time.perf_counter(),
                                     attempt=attempt, status="error",
                                     error=type(e).__name__)
            if attempt >= budget:
                raise
        attempt += 1
        from .. import telemetry as _telem
        if _telem._ENABLED:
            _telem.record_io_retry(point)
        if _tracing._ENABLED:
            _tracing.event("mx.io_retry", point=point, attempt=attempt)
        delay = min(cap, base * (2 ** (attempt - 1)))
        if delay > 0:
            time.sleep(random.uniform(0, delay))


install_from_env()
