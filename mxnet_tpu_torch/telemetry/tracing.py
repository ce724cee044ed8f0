"""Span tracing and the flight recorder.

Counterpart of ``mxnet_tpu/telemetry/tracing.py``: the metrics registry
answers *how much*, this module *which step* and *which request*. An
off-by-default tracing plane: disarmed, every call site is one module-flag
check (``if _tracing._ENABLED:``), with no allocation, clock read or lock on
the hot path.

Armed, the layers that carry telemetry hooks record **spans** (named
intervals with process-unique trace and span ids and parent links) and
**events** (instants: fault firings, IO retries, anomalies) into one bounded
ring. The ring is the flight recorder: on preemption (``elastic.run``) or
an unhandled exception (the ``sys.excepthook``/``threading.excepthook``
chain that :func:`enable` installs) its last entries are dumped as NDJSON.

- :func:`dump_chrome_trace`: Chrome trace-event JSON (Perfetto). The span
  names are the ``telemetry.annotate`` region names (``mx.dp.step``, ...),
  so host spans line up by name with ``telemetry.trace_steps(n)``'s trace.
- :func:`dump_flight_recorder`: NDJSON, a meta line with the wall-clock and
  ``perf_counter`` anchor, then one entry a line.
- ``telemetry.statusz()`` holds the last ``MXNET_TPU_STATUSZ_EVENTS``
  entries.

A worker thread adopts a parent with ``with tracing.attach(ctx):`` or
``parent=ctx``. The anomaly watchdog reads host values only (step seconds
from ``telemetry.record_step``, losses where a ``PendingScalar`` is read),
so arming it adds no device sync; findings book ``mx_anomalies_total{kind}``
and recorder events.
"""
from __future__ import annotations

import contextlib
import itertools
import json
import math
import os
import sys
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

from ..base import env

__all__ = [
    "enable", "disable", "is_enabled",
    "span", "record_span", "event",
    "current", "attach", "new_root",
    "spans", "recent", "set_max_spans", "reset",
    "dump_chrome_trace", "dump_flight_recorder",
    "watch_step_time", "check_loss", "install_crash_hooks",
]

env.declare("MXNET_TPU_TRACING", False, bool,
            "Arm the span-tracing plane at import (tracing.enable() at "
            "runtime). Disarmed call sites are a single flag check.")
env.declare("MXNET_TPU_TRACING_MAX_SPANS", 100_000, int,
            "Flight-recorder ring capacity (completed spans + events).")
env.declare("MXNET_TPU_FLIGHT_RECORDER", "mx_flight_recorder.ndjson", str,
            "Default path for the NDJSON flight-recorder dump (preemption, "
            "crash hook, dump_flight_recorder() without a path).")
env.declare("MXNET_TPU_STATUSZ_EVENTS", 32, int,
            "How many trailing recorder entries /statusz reports.")
env.declare("MXNET_TPU_ANOMALY_STEP_RATIO", 2.5, float,
            "Watchdog: a step slower than ratio x EWMA (after warmup) books "
            "mx_anomalies_total{kind=step_time_regression}.")
env.declare("MXNET_TPU_ANOMALY_WARMUP", 10, int,
            "Watchdog: steps per source before regression checks arm "
            "(EWMA needs a baseline; compile steps would false-positive).")

_ENABLED = bool(env.get("MXNET_TPU_TRACING"))
_LOCK = threading.Lock()
_RING: "deque[Dict[str, Any]]" = deque(
    maxlen=max(int(env.get("MXNET_TPU_TRACING_MAX_SPANS")), 0))
_TLS = threading.local()
_IDS = itertools.count(1)
# Process-unique prefix: pid + 4 random bytes so ids from different
# processes (or restarts of the same pid) never collide in merged dumps.
_PREFIX = "%x-%08x" % (os.getpid(),
                       int.from_bytes(os.urandom(4), "big"))

# EWMA smoothing for the step-time watchdog.
_WD_ALPHA = 0.1
_WD: Dict[str, List[float]] = {}  # source -> [count, ewma]

_NULL = contextlib.nullcontext()  # shared, reusable, reentrant


# ---------------------------------------------------------------------------
# Arming
# ---------------------------------------------------------------------------

def enable() -> None:
    """Arm tracing and install the crash-dump excepthook chain."""
    global _ENABLED
    _ENABLED = True
    install_crash_hooks()


def disable() -> None:
    global _ENABLED
    _ENABLED = False


def is_enabled() -> bool:
    return _ENABLED


# ---------------------------------------------------------------------------
# Ids and thread-local context
# ---------------------------------------------------------------------------

def _next_id() -> str:
    return format(next(_IDS), "x")


def new_root(name: str = "") -> Tuple[str, str]:
    """Allocate a fresh (trace_id, span_id) root context without recording
    anything. Use when the root span's duration is only known later (e.g. a
    serving request records its root at completion) or as a grouping parent
    for a worker thread's spans."""
    trace_id = "%s-%s" % (_PREFIX, _next_id())
    if name:
        trace_id = "%s-%s" % (trace_id, name)
    return (trace_id, _next_id())


def current() -> Optional[Tuple[str, str]]:
    """The innermost open (trace_id, span_id) on this thread, or None."""
    stack = getattr(_TLS, "stack", None)
    return stack[-1] if stack else None


@contextlib.contextmanager
def attach(ctx: Optional[Tuple[str, str]]):
    """Adopt a context captured on another thread: spans opened inside the
    block parent under ``ctx``. No-op when disarmed or ``ctx`` is None."""
    if not _ENABLED or ctx is None:
        yield None
        return
    stack = getattr(_TLS, "stack", None)
    if stack is None:
        stack = _TLS.stack = []
    stack.append((ctx[0], ctx[1]))
    try:
        yield ctx
    finally:
        stack.pop()


def _resolve_parent(parent) -> Tuple[str, Optional[str]]:
    """(trace_id, parent_span_id) from an explicit parent, the thread-local
    stack, or a fresh root trace."""
    if parent is not None:
        if isinstance(parent, _Span):
            return parent.trace_id, parent.span_id
        return parent[0], parent[1]
    cur = current()
    if cur is not None:
        return cur[0], cur[1]
    return "%s-%s" % (_PREFIX, _next_id()), None


# ---------------------------------------------------------------------------
# Spans
# ---------------------------------------------------------------------------

class _Span:
    """An open span; context manager. Completed on exit into the ring."""

    __slots__ = ("name", "trace_id", "span_id", "parent_id", "attrs", "_t0")

    def __init__(self, name: str, trace_id: str, span_id: str,
                 parent_id: Optional[str], attrs: Dict[str, Any]):
        self.name = name
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.attrs = attrs
        self._t0 = 0.0

    @property
    def context(self) -> Tuple[str, str]:
        return (self.trace_id, self.span_id)

    def set_attr(self, key: str, value: Any) -> None:
        self.attrs[key] = value

    def __enter__(self) -> "_Span":
        stack = getattr(_TLS, "stack", None)
        if stack is None:
            stack = _TLS.stack = []
        stack.append((self.trace_id, self.span_id))
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        t1 = time.perf_counter()
        stack = getattr(_TLS, "stack", None)
        if stack:
            stack.pop()
        if exc_type is not None:
            self.attrs["error"] = exc_type.__name__
        _append({"kind": "span", "name": self.name,
                 "trace_id": self.trace_id, "span_id": self.span_id,
                 "parent_id": self.parent_id, "ts": self._t0,
                 "dur": t1 - self._t0, "thread": threading.get_ident(),
                 "attrs": self.attrs})


def span(name: str, parent=None, **attrs):
    """Context manager recording a span on exit. Disarmed: returns a shared
    nullcontext (no allocation). ``parent`` is an explicit (trace_id,
    span_id) tuple or open span; default is the thread-local current span,
    else a fresh root trace."""
    if not _ENABLED:
        return _NULL
    trace_id, parent_id = _resolve_parent(parent)
    return _Span(name, trace_id, _next_id(), parent_id, attrs)


def record_span(name: str, t_start: float, t_end: float, parent=None,
                ctx: Optional[Tuple[str, str]] = None,
                **attrs) -> Optional[Tuple[str, str]]:
    """Record a completed span from timestamps already in hand (no clock
    reads here — callers on measured paths reuse stamps they already took).
    ``ctx`` pre-assigns this span's own (trace_id, span_id) — used when the
    id was allocated earlier (e.g. a serving request's root span). Returns
    the span's context for chaining children."""
    if not _ENABLED:
        return None
    if ctx is not None:
        trace_id, span_id = ctx
        parent_id = parent[1] if parent is not None else None
    else:
        trace_id, parent_id = _resolve_parent(parent)
        span_id = _next_id()
    _append({"kind": "span", "name": name, "trace_id": trace_id,
             "span_id": span_id, "parent_id": parent_id, "ts": t_start,
             "dur": t_end - t_start, "thread": threading.get_ident(),
             "attrs": attrs})
    return (trace_id, span_id)


def event(name: str, parent=None, **attrs) -> Optional[Tuple[str, str]]:
    """Record an instant recorder event (fault firing, io retry, anomaly)."""
    if not _ENABLED:
        return None
    trace_id, parent_id = _resolve_parent(parent)
    span_id = _next_id()
    _append({"kind": "event", "name": name, "trace_id": trace_id,
             "span_id": span_id, "parent_id": parent_id,
             "ts": time.perf_counter(), "dur": 0.0,
             "thread": threading.get_ident(), "attrs": attrs})
    return (trace_id, span_id)


def _append(entry: Dict[str, Any]) -> None:
    # Deliberately lock-free: deque.append with maxlen is atomic under the
    # GIL, and this is the armed hot path — serving records ~6 entries per
    # request from 3+ threads, so a shared lock here turns the recorder
    # into a contention point (measured ~25% closed-loop throughput loss).
    # Readers (spans()) retry on the concurrent-mutation RuntimeError.
    _RING.append(entry)  # GIL-atomic


# ---------------------------------------------------------------------------
# Ring access
# ---------------------------------------------------------------------------

def spans() -> List[Dict[str, Any]]:
    """Snapshot of the recorder ring (oldest first). Writers are lock-free
    (see _append), so a snapshot taken mid-append can raise "deque mutated
    during iteration" — retry; the window is a single append."""
    for _ in range(64):
        try:
            return list(_RING)
        except RuntimeError:
            continue
    return []  # writer storm: the flight recorder prefers empty to hanging


def recent(n: Optional[int] = None) -> List[Dict[str, Any]]:
    """The trailing ``n`` entries (default MXNET_TPU_STATUSZ_EVENTS)."""
    if n is None:
        n = int(env.get("MXNET_TPU_STATUSZ_EVENTS"))
    entries = spans()
    if n <= 0 or n >= len(entries):
        return entries
    return entries[-n:]


def set_max_spans(n: int) -> None:
    """Re-cap the ring, keeping the newest entries."""
    global _RING
    with _LOCK:  # excludes concurrent re-cap/reset; appends are atomic
        _RING = deque(spans(), maxlen=max(int(n), 0))


def reset() -> None:
    """Drop recorded entries and watchdog state (telemetry.reset() calls
    this; arming state and ids are untouched)."""
    with _LOCK:
        _RING.clear()
        _WD.clear()


# ---------------------------------------------------------------------------
# Export surfaces
# ---------------------------------------------------------------------------

def dump_chrome_trace(path: str) -> str:
    """Write the ring as Chrome trace-event JSON (Perfetto-loadable).

    Span names are the track names; the trainer's dispatch spans reuse the
    ``telemetry.annotate`` region names (``mx.dp.step``, ``mx.dp.run_steps``)
    so this file and the ``trace_steps(n)`` trace line up by name.
    Timestamps are perf_counter microseconds."""
    events = []
    for e in spans():
        out = {"name": e["name"], "cat": "mx." + e["kind"],
               "ts": e["ts"] * 1e6, "pid": 0, "tid": e["thread"],
               "args": dict(e["attrs"], trace_id=e["trace_id"],
                            span_id=e["span_id"],
                            parent_id=e["parent_id"])}
        if e["kind"] == "span":
            out["ph"] = "X"
            out["dur"] = e["dur"] * 1e6
        else:
            out["ph"] = "i"
            out["s"] = "t"
        events.append(out)
    with open(path, "w") as f:
        json.dump({"traceEvents": events, "displayTimeUnit": "ms"}, f)
    return path


def dump_flight_recorder(path: Optional[str] = None,
                         reason: str = "manual") -> str:
    """Write the ring as NDJSON: a meta line (reason, pid, wall-clock ↔
    perf_counter anchor), then one entry per line, oldest first. This is
    the black-box dump taken on preemption and by the crash hooks."""
    if path is None:
        path = str(env.get("MXNET_TPU_FLIGHT_RECORDER"))
    entries = spans()
    with open(path, "w") as f:
        f.write(json.dumps({"kind": "meta", "reason": reason,
                            "pid": os.getpid(), "wall_time": time.time(),
                            "perf_counter": time.perf_counter(),
                            "entries": len(entries)}) + "\n")
        for e in entries:
            f.write(json.dumps(e, default=str) + "\n")
    return path


# ---------------------------------------------------------------------------
# Crash hooks (unhandled-step-exception dump)
# ---------------------------------------------------------------------------

_HOOKS_INSTALLED = [False]


def install_crash_hooks() -> None:
    """Chain sys.excepthook + threading.excepthook to dump the flight
    recorder on an unhandled exception (main thread or any worker —
    dispatcher, producer, snapshot writer). Idempotent; previous hooks
    still run."""
    with _LOCK:
        if _HOOKS_INSTALLED[0]:
            return
        _HOOKS_INSTALLED[0] = True
    prev_sys = sys.excepthook

    def _sys_hook(exc_type, exc, tb):
        _crash_dump("unhandled:%s" % getattr(exc_type, "__name__", "?"))
        prev_sys(exc_type, exc, tb)

    sys.excepthook = _sys_hook
    prev_thread = threading.excepthook

    def _thread_hook(args):
        _crash_dump("thread:%s" % getattr(args.exc_type, "__name__", "?"))
        prev_thread(args)

    threading.excepthook = _thread_hook


def _crash_dump(reason: str) -> None:
    try:
        if _ENABLED and len(_RING):
            dump_flight_recorder(reason=reason)
    except Exception:  # never let the dump mask the original failure
        pass


# ---------------------------------------------------------------------------
# Anomaly watchdog
# ---------------------------------------------------------------------------

def watch_step_time(seconds: float, source: str = "step") -> None:
    """EWMA step-time regression detector. Fed per-step host-side seconds
    from telemetry.record_step — values the metrics plane already computed,
    so no new syncs or clock reads. After MXNET_TPU_ANOMALY_WARMUP samples
    per source, a step slower than MXNET_TPU_ANOMALY_STEP_RATIO x EWMA
    books an anomaly; the sample still updates the EWMA so a genuine
    regime change (bigger batch) stops alerting after a few steps."""
    if not _ENABLED:
        return
    warmup = int(env.get("MXNET_TPU_ANOMALY_WARMUP"))
    ratio = env.get("MXNET_TPU_ANOMALY_STEP_RATIO")
    with _LOCK:
        state = _WD.get(source)
        if state is None:
            state = _WD[source] = [0.0, 0.0]
        count, ewma = state
        fire = count >= warmup and ewma > 0.0 and seconds > ratio * ewma
        state[0] = count + 1.0
        state[1] = seconds if count == 0.0 \
            else ewma + _WD_ALPHA * (seconds - ewma)
    if fire:
        _anomaly("step_time_regression", source=source,
                 seconds=seconds, ewma=ewma, ratio=ratio)


def check_loss(value: float, source: str = "step") -> None:
    """Nonfinite-loss detector. Called at PendingScalar/drain sync points
    with a host float the caller already materialised — detection piggybacks
    on syncs that were happening anyway."""
    if not _ENABLED:
        return
    try:
        if math.isfinite(value):
            return
    except (TypeError, ValueError):
        return
    _anomaly("nonfinite_loss", source=source, value=repr(value))


def _anomaly(kind: str, **attrs) -> None:
    event("mx.anomaly." + kind, kind=kind, **attrs)
    from .. import telemetry as _telem
    _telem.counter(
        "mx_anomalies_total",
        "Anomalies flagged by the tracing watchdog (EWMA step-time "
        "regression, nonfinite loss)", ("kind",)).labels(kind).inc()


if _ENABLED:
    install_crash_hooks()
