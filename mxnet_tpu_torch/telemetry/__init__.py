"""Telemetry: a process-wide metrics registry every subsystem reports into,
with Prometheus-text and JSON export.

Counterpart of ``mxnet_tpu/telemetry/__init__.py``, with the same names,
metric families and labels:

- **training-step metrics**: step time, examples a second and MFU.
  ``record_step`` (reference :609) keeps the reference's clock: the wall
  time since the last call for the same ``source``, recorded by the
  trainers after their in-flight window admitted the step, so it runs at
  completion pace and adds no host sync. FLOPs come from
  ``flops_per_step`` or from the engine's ``flops_executed`` counter
  (``engine.record_execution``), which the trainers feed with each
  signature's FLOPs, counted once (``engine.count_flops``);
- **communication accounting**: ``record_comm``, ``comm_scope``,
  ``instrument_comm``, ``payload_bytes``, ``comm_overlap_ratio`` and
  ``comm_axis_bytes``, with the reference's op labels (``allreduce``,
  ``reduce_scatter``, ``all_gather``, ``ppermute``, the kvstore's ``push``,
  ``pull`` and ``pushpull``);
- **memory**: ``sample_memory`` on ``torch.cuda.memory_allocated`` and
  ``max_memory_allocated`` (nothing on a process that has not initialised
  CUDA);
- **device traces**: ``trace_steps(n)`` runs a ``torch.profiler`` session
  over the next ``n`` recorded steps and writes a Chrome trace. On the H100
  host a session loses its first device records, so the session opens with
  ``TRACE_PAD`` spin kernels (``torch.cuda._sleep``); readers leave out
  what precedes the last of them;
- **export**: ``scrape()`` (Prometheus text), ``scrape_json()``,
  ``report()``, ``statusz()`` and ``start_http_server()`` for ``GET
  /metrics``, ``/metrics.json``, ``/statusz`` and ``/healthz``;
- ``annotate(name)``: a ``torch.profiler.record_function`` region while
  telemetry is on, so host spans and device kernels line up by name. It is
  safe inside a CUDA-graph capture.

``peak_flops`` / ``peak_bytes_per_second`` / ``ridge_point`` (reference
:471-543) resolve in the reference's order: the ``MXNET_TELEMETRY_PEAK_FLOPS``
/ ``_BYTES`` override, then a table keyed on ``torch.cuda.get_device_name()``,
then the 1 TFLOP/s and 50 GB/s CPU anchors, which keep CPU runs comparable
and claim nothing about the hardware. The table holds the H100 SXM's dense
bf16 peak and HBM3 bandwidth from NVIDIA's datasheet (989e12 FLOP/s,
3.35e12 B/s), not measured figures.

The registry is off by default. Every instrumentation site guards on the
module attribute ``_ENABLED``, so the disabled path costs one attribute load
and a branch. No hook adds a host sync, and none runs its host code inside a
CUDA-graph capture: a captured step's replay calls ``record_step`` on the
host as an eager step does.

Not ported here: the reference's ``roofline`` (per-region bytes from XLA's
cost model) and ``goodput`` (an on-disk ledger merged over the
coordinator's root) modules; ``reset()`` resets what exists.
"""
from __future__ import annotations

import contextlib
import functools
import json
import sys
import threading
import time
from bisect import bisect_left
from collections import OrderedDict
from contextlib import contextmanager
from typing import Any, Dict, List, Optional, Sequence, Tuple

from ..base import MXNetError, env

__all__ = [
    "enable", "disable", "is_enabled", "counter", "gauge", "histogram",
    "get_metric", "reset", "collect", "scrape", "scrape_json", "report",
    "record_step", "record_comm", "comm_scope", "instrument_comm",
    "record_optimizer_state", "payload_bytes", "sample_memory", "peak_flops",
    "peak_bytes_per_second", "ridge_point", "trace_steps", "trace_active",
    "record_feed_depth", "record_feed_stall", "record_inflight",
    "record_dispatch_wait",
    "record_checkpoint_save", "record_resume", "record_moe_dropped",
    "set_epoch", "timed", "annotate", "start_http_server",
    "stop_http_server", "DEFAULT_LATENCY_BUCKETS", "record_serving_enqueue",
    "record_serving_queue_depth", "record_serving_dispatch",
    "record_serving_completion", "record_fault_injected", "record_io_retry",
    "record_request_shed", "record_feed_producer_leak",
    "record_feed_producer_restart", "record_serving_queue_wait",
    "record_hosts_live", "record_commit_barrier", "record_hang_watchdog",
    "comm_overlap_ratio", "comm_axis_bytes", "statusz", "tracing",
]

env.declare("MXNET_TELEMETRY", False, bool,
            "Enable the telemetry registry at import")
env.declare("MXNET_TELEMETRY_MAX_SERIES", 512, int,
            "Max label combinations kept per metric family; excess series "
            "are dropped and counted in mx_telemetry_dropped_series_total")
env.declare("MXNET_TELEMETRY_PEAK_FLOPS", 0.0, float,
            "Peak FLOP/s the MFU gauge divides by; overrides the device "
            "table (set it on the CPU, which has no meaningful peak)")
env.declare("MXNET_TELEMETRY_PEAK_BYTES", 0.0, float,
            "Peak memory bandwidth (bytes/s); overrides the device table")
env.declare("MXNET_TPU_TRACE_DIR", "", str,
            "Default directory of telemetry.trace_steps()'s Chrome trace")

_LOCK = threading.RLock()
_FAMILIES: "OrderedDict[str, MetricFamily]" = OrderedDict()

# the one flag every instrumentation site checks
_ENABLED = bool(env.get("MXNET_TELEMETRY"))


def enable():
    """Turn instrumentation on (all sites start reporting)."""
    global _ENABLED
    _ENABLED = True


def disable():
    global _ENABLED
    _ENABLED = False


def is_enabled() -> bool:
    return _ENABLED


# process-rank label for multi-process scrapes: "" (one process) leaves every
# family's label set as on one host; a rank is appended as a trailing "host"
# label, so MetricFamily.get()'s prefix aggregation keeps readers working
_HOST_LABEL: List[Optional[str]] = [None]


def _host_label() -> str:
    """The process-rank label value, resolved once: the rank of an
    initialised ``torch.distributed`` group of more than one process."""
    v = _HOST_LABEL[0]
    if v is None:
        v = ""
        dist = sys.modules.get("torch.distributed")
        try:
            if dist is not None and dist.is_available() and dist.is_initialized() \
                    and dist.get_world_size() > 1:
                v = str(dist.get_rank())
        except Exception:
            v = ""
        with _LOCK:
            _HOST_LABEL[0] = v
    return v


# ---------------------------------------------------------------------------
# Metric model: family (name + label names) -> labeled series
# ---------------------------------------------------------------------------

def _escape(v: str) -> str:
    return str(v).replace("\\", r"\\").replace("\n", r"\n").replace('"', r'\"')


def _escape_help(v: str) -> str:
    # HELP-line escaping per the exposition format: backslash and newline
    # only (quotes are legal in help text). A doc with a raw newline would
    # otherwise split the HELP line and corrupt the whole scrape.
    return str(v).replace("\\", r"\\").replace("\n", r"\n")


def _fmt_labels(names: Tuple[str, ...], values: Tuple[str, ...],
                extra: str = "") -> str:
    parts = [f'{n}="{_escape(v)}"' for n, v in zip(names, values)]
    if extra:
        parts.append(extra)
    return "{" + ",".join(parts) + "}" if parts else ""


class _NullSeries:
    """Returned past the cardinality cap: absorbs writes silently."""

    def inc(self, n=1):
        pass

    def dec(self, n=1):
        pass

    def set(self, v):
        pass

    def set_max(self, v):
        pass

    def observe(self, v):
        pass


_NULL = _NullSeries()


class _CounterSeries:
    __slots__ = ("label_values", "value")

    def __init__(self, label_values):
        self.label_values = label_values
        self.value = 0.0

    def inc(self, n=1):
        if n < 0:
            raise MXNetError("counters only go up; use a gauge")
        with _LOCK:
            self.value += n


class _GaugeSeries:
    __slots__ = ("label_values", "value")

    def __init__(self, label_values):
        self.label_values = label_values
        self.value = 0.0

    def set(self, v):
        with _LOCK:
            self.value = float(v)

    def set_max(self, v):
        """Watermark update: keep the running maximum."""
        with _LOCK:
            self.value = max(self.value, float(v))

    def inc(self, n=1):
        with _LOCK:
            self.value += n

    def dec(self, n=1):
        with _LOCK:
            self.value -= n


class _HistogramSeries:
    __slots__ = ("label_values", "buckets", "counts", "sum", "count")

    def __init__(self, label_values, buckets):
        self.label_values = label_values
        self.buckets = buckets            # sorted upper bounds, no +Inf
        self.counts = [0] * (len(buckets) + 1)
        self.sum = 0.0
        self.count = 0

    def observe(self, v):
        v = float(v)
        with _LOCK:
            self.counts[bisect_left(self.buckets, v)] += 1
            self.sum += v
            self.count += 1


class MetricFamily:
    kind = "untyped"
    _series_cls = _GaugeSeries

    def __init__(self, name: str, doc: str = "",
                 labelnames: Sequence[str] = (),
                 max_series: Optional[int] = None):
        self.name = name
        self.doc = doc
        self.labelnames = tuple(labelnames)
        self.max_series = max_series if max_series is not None \
            else int(env.get("MXNET_TELEMETRY_MAX_SERIES"))
        self._series: Dict[Tuple[str, ...], Any] = {}
        self.dropped = 0

    def labels(self, *values, **kv):
        if kv:
            if values:
                raise MXNetError("pass label values positionally OR by name")
            try:
                values = tuple(str(kv[n]) for n in self.labelnames)
            except KeyError as e:
                raise MXNetError(
                    f"metric {self.name} missing label {e}") from None
        else:
            values = tuple(str(v) for v in values)
        if len(values) != len(self.labelnames):
            raise MXNetError(
                f"metric {self.name} takes labels {self.labelnames}, "
                f"got {values}")
        s = self._series.get(values)
        if s is None:
            with _LOCK:
                s = self._series.get(values)
                if s is None:
                    if len(self._series) >= self.max_series:
                        # cap label cardinality: drop (and count) instead of
                        # letting a runaway label explode scrape size
                        self.dropped += 1
                        return _NULL
                    s = self._make_series(values)
                    self._series[values] = s
        return s

    def _make_series(self, values):
        return self._series_cls(values)

    def _default(self):
        return self.labels(*(("",) * len(self.labelnames))) \
            if self.labelnames else self.labels()

    # family-level convenience for label-less metrics
    def inc(self, n=1):
        self._default().inc(n)

    def dec(self, n=1):
        self._default().dec(n)

    def set(self, v):
        self._default().set(v)

    def set_max(self, v):
        self._default().set_max(v)

    def observe(self, v):
        self._default().observe(v)

    def get(self, *values) -> float:
        """Exact series value — or, with FEWER label values than the family
        has labelnames, the sum over every series matching that label
        prefix (Prometheus-style aggregation over the remaining labels, so
        readers written before a family grew a label keep working)."""
        values = tuple(str(v) for v in values)
        if len(values) < len(self.labelnames):
            with _LOCK:
                series = list(self._series.items())
            return sum(getattr(s, "value", getattr(s, "sum", 0.0))
                       for lv, s in series if lv[:len(values)] == values)
        s = self._series.get(values)
        if s is None:
            return 0.0
        return getattr(s, "value", getattr(s, "sum", 0.0))

    def _render(self, out: List[str]):
        out.append(f"# HELP {self.name} {_escape_help(self.doc)}")
        out.append(f"# TYPE {self.name} {self.kind}")
        with _LOCK:
            series = list(self._series.values())
        for s in series:
            out.append(f"{self.name}"
                       f"{_fmt_labels(self.labelnames, s.label_values)}"
                       f" {s.value}")

    def _as_dict(self):
        with _LOCK:
            return {
                "type": self.kind, "doc": self.doc,
                "series": [
                    {"labels": dict(zip(self.labelnames, s.label_values)),
                     "value": s.value}
                    for s in self._series.values()],
            }


class CounterFamily(MetricFamily):
    kind = "counter"
    _series_cls = _CounterSeries


class GaugeFamily(MetricFamily):
    kind = "gauge"
    _series_cls = _GaugeSeries


# seconds-scale spacing: 50us .. ~100s
_DEFAULT_BUCKETS = tuple(5e-5 * (2.5 ** i) for i in range(13))


class HistogramFamily(MetricFamily):
    kind = "histogram"

    def __init__(self, name, doc="", labelnames=(), buckets=None,
                 max_series=None):
        super().__init__(name, doc, labelnames, max_series)
        self.buckets = sorted(float(b) for b in (buckets or _DEFAULT_BUCKETS))

    def _make_series(self, values):
        return _HistogramSeries(values, self.buckets)

    def _render(self, out: List[str]):
        out.append(f"# HELP {self.name} {_escape_help(self.doc)}")
        out.append(f"# TYPE {self.name} histogram")
        with _LOCK:
            series = [(s.label_values, list(s.counts), s.sum, s.count)
                      for s in self._series.values()]
        for lv, counts, total, count in series:
            acc = 0
            for ub, c in zip(self.buckets, counts):
                acc += c
                le = 'le="%g"' % ub
                out.append(f"{self.name}_bucket"
                           f"{_fmt_labels(self.labelnames, lv, le)} {acc}")
            inf = 'le="+Inf"'
            out.append(f"{self.name}_bucket"
                       f"{_fmt_labels(self.labelnames, lv, inf)} {count}")
            out.append(f"{self.name}_sum"
                       f"{_fmt_labels(self.labelnames, lv)} {total}")
            out.append(f"{self.name}_count"
                       f"{_fmt_labels(self.labelnames, lv)} {count}")

    def _as_dict(self):
        with _LOCK:
            return {
                "type": "histogram", "doc": self.doc,
                "buckets": self.buckets,
                "series": [
                    {"labels": dict(zip(self.labelnames, s.label_values)),
                     "counts": list(s.counts), "sum": s.sum, "count": s.count}
                    for s in self._series.values()],
            }


def _family(cls, name, doc, labelnames, **kw):
    with _LOCK:
        fam = _FAMILIES.get(name)
        if fam is None:
            fam = _FAMILIES[name] = cls(name, doc, labelnames, **kw)
        elif type(fam) is not cls:
            raise MXNetError(
                f"metric {name!r} already registered as {fam.kind}")
        return fam


def counter(name, doc="", labelnames=(), max_series=None) -> CounterFamily:
    """Get-or-create a monotonically increasing counter family."""
    return _family(CounterFamily, name, doc, labelnames,
                   max_series=max_series)


def gauge(name, doc="", labelnames=(), max_series=None) -> GaugeFamily:
    return _family(GaugeFamily, name, doc, labelnames, max_series=max_series)


def histogram(name, doc="", labelnames=(), buckets=None,
              max_series=None) -> HistogramFamily:
    with _LOCK:
        fam = _FAMILIES.get(name)
        if fam is None:
            fam = _FAMILIES[name] = HistogramFamily(
                name, doc, labelnames, buckets, max_series)
        elif not isinstance(fam, HistogramFamily):
            raise MXNetError(
                f"metric {name!r} already registered as {fam.kind}")
        return fam


def get_metric(name) -> Optional[MetricFamily]:
    return _FAMILIES.get(name)


def reset():
    """Drop every registered family and the step and memory bookkeeping, and
    the tracing ring (tests; a long-lived server should scrape, not reset)."""
    global _mem_peak
    with _LOCK:
        _FAMILIES.clear()
        _STEP_ANCHOR.clear()
        _mem_peak = 0.0
        _HOST_LABEL[0] = None
    tracing.reset()


# ---------------------------------------------------------------------------
# Peaks for the MFU gauge
# ---------------------------------------------------------------------------

# NVIDIA's datasheet figures for the H100 SXM (80 GB HBM3), keyed by a
# substring of torch.cuda.get_device_name(): the dense bf16 tensor-core peak
# and the HBM3 bandwidth. Not measured; the same figures PERF.md's bounds use.
_PEAK_TABLE = (("h100", 989e12),)
_BW_TABLE = (("h100", 3.35e12),)
# With no override and no recognized device (the CPU), MFU is reported
# against this nominal anchor so the gauge exists and A/B deltas are
# comparable; the absolute value is not a utilization claim
_FALLBACK_PEAK = 1e12
_FALLBACK_BYTES_PER_S = 50e9
_peak_cache: List[Optional[float]] = [None]
_peak_bw_cache: List[Optional[float]] = [None]


def _device_kind() -> str:
    torch = sys.modules.get("torch")
    try:
        if torch is not None and torch.cuda.is_available():
            return torch.cuda.get_device_name(0).lower()
    except Exception:
        pass
    return ""


def _from_table(table, fallback, cache) -> float:
    with _LOCK:
        if cache[0] is None:
            kind = _device_kind()
            cache[0] = next((v for sub, v in table if sub in kind), fallback)
        return cache[0]


def peak_flops() -> float:
    """Peak FLOP/s the MFU gauge divides by: the env override, else the
    device table, else the 1 TFLOP/s CPU anchor."""
    ov = float(env.get("MXNET_TELEMETRY_PEAK_FLOPS"))
    if ov > 0:
        return ov
    return _from_table(_PEAK_TABLE, _FALLBACK_PEAK, _peak_cache)


def peak_bytes_per_second() -> float:
    """Peak memory bandwidth: ``MXNET_TELEMETRY_PEAK_BYTES``, else the
    device table, else the 50 GB/s CPU anchor."""
    ov = float(env.get("MXNET_TELEMETRY_PEAK_BYTES"))
    if ov > 0:
        return ov
    return _from_table(_BW_TABLE, _FALLBACK_BYTES_PER_S, _peak_bw_cache)


def ridge_point() -> float:
    """Arithmetic intensity (FLOP/byte) where the roofline's bandwidth slope
    meets the compute ceiling."""
    return peak_flops() / peak_bytes_per_second()


# ---------------------------------------------------------------------------
# Device traces over recorded steps
# ---------------------------------------------------------------------------

TRACE_PAD = 1024        # spin kernels that open a session (see the docstring)

# [steps remaining, active directory, profiler]; armed by trace_steps(),
# counted down by record_step(), which stops the session after n steps
_TRACE: List[Any] = [0, None, None]


def trace_steps(n: int, logdir: Optional[str] = None) -> str:
    """Start a ``torch.profiler`` session (CPU and, where there is one, CUDA
    activity) and stop it after the next ``n`` recorded steps, writing
    ``<logdir>/trace.json`` (Chrome trace). ``logdir`` defaults to
    ``MXNET_TPU_TRACE_DIR``, else a temporary directory. The ``annotate``
    regions (``mx.dp.step``, ``mx.comm.*``) land in the trace by name.
    Returns the directory."""
    import os
    import tempfile

    import torch
    from torch.profiler import ProfilerActivity, profile
    d = logdir or str(env.get("MXNET_TPU_TRACE_DIR")) or None
    if not d:
        d = tempfile.mkdtemp(prefix="mx_trace_")
    os.makedirs(d, exist_ok=True)
    cuda = torch.cuda.is_available() and torch.cuda.is_initialized()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with _LOCK:
        if _TRACE[1] is not None:
            raise MXNetError(f"a trace is already active in {_TRACE[1]}")
        prof = profile(activities=acts)
        prof.__enter__()
        if cuda:
            for _ in range(TRACE_PAD):
                torch.cuda._sleep(100)
        _TRACE[0], _TRACE[1], _TRACE[2] = max(int(n), 1), d, prof
    return d


def trace_active() -> Optional[str]:
    """The active session's directory, or None."""
    return _TRACE[1]


def _trace_tick(steps: int = 1):
    """Count recorded steps against an armed session; stop and write it when
    they are spent (the stop waits for the device, a sync of the traced
    run's own)."""
    prof = None
    with _LOCK:
        if _TRACE[1] is None:
            return
        _TRACE[0] -= steps
        if _TRACE[0] <= 0:
            prof, d = _TRACE[2], _TRACE[1]
            _TRACE[0], _TRACE[1], _TRACE[2] = 0, None, None
    if prof is not None:
        import os
        torch = sys.modules.get("torch")
        if torch is not None and torch.cuda.is_available() and torch.cuda.is_initialized():
            torch.cuda.synchronize()        # the last step's kernels into the session
        prof.__exit__(None, None, None)
        prof.export_chrome_trace(os.path.join(d, "trace.json"))


# ---------------------------------------------------------------------------
# Training-step recording
# ---------------------------------------------------------------------------

# source -> (last perf_counter stamp, engine flops_executed at that stamp)
_STEP_ANCHOR: Dict[str, Tuple[float, float]] = {}


def _engine_flops() -> float:
    try:
        from .. import engine as _engine
        return float(_engine.cache_stats().get("flops_executed", 0.0))
    except Exception:
        return 0.0


def record_step(examples: int, source: str = "trainer", steps: int = 1,
                seconds: Optional[float] = None,
                flops_per_step: Optional[float] = None,
                lr: Optional[float] = None,
                dispatch_wait_seconds: Optional[float] = None):
    """Record ``steps`` completed training steps covering ``examples``
    examples (reference :609).

    With ``seconds=None`` the duration is the wall time since the previous
    call for the same ``source`` (the first call only anchors the clock).
    ``flops_per_step`` defaults to the delta of the engine's
    ``flops_executed`` counter, which gives the MFU estimate.
    ``dispatch_wait_seconds`` (the caller's cumulative window block time) is
    what the reference's goodput ledger reads; with no ledger here it is
    accepted and unused."""
    now = time.perf_counter()
    eng_flops = _engine_flops() if flops_per_step is None else 0.0
    with _LOCK:
        prev = _STEP_ANCHOR.get(source)
        _STEP_ANCHOR[source] = (now, eng_flops)
    if seconds is None:
        if prev is None:
            return
        seconds = now - prev[0]
    if flops_per_step is None:
        flops = eng_flops - (prev[1] if prev else eng_flops)
    else:
        flops = flops_per_step * steps

    counter("mx_train_steps_total", "Completed training steps",
            ("source",)).labels(source).inc(steps)
    counter("mx_train_examples_total", "Examples consumed by training",
            ("source",)).labels(source).inc(examples)
    histogram("mx_train_step_seconds", "Wall time per training step",
              ("source",)).labels(source).observe(seconds / max(steps, 1))
    host = _host_label()
    if host:
        histogram("mx_step_seconds",
                  "Training-step latency on the documented "
                  "DEFAULT_LATENCY_BUCKETS ladder",
                  ("source", "host"), buckets=DEFAULT_LATENCY_BUCKETS) \
            .labels(source, host).observe(seconds / max(steps, 1))
    else:
        histogram("mx_step_seconds",
                  "Training-step latency on the documented "
                  "DEFAULT_LATENCY_BUCKETS ladder",
                  ("source",), buckets=DEFAULT_LATENCY_BUCKETS) \
            .labels(source).observe(seconds / max(steps, 1))
    _trace_tick(steps)
    if tracing._ENABLED:
        tracing.watch_step_time(seconds / max(steps, 1), source=source)
    if seconds > 0:
        gauge("mx_train_examples_per_second",
              "Training throughput over the last recorded window",
              ("source",)).labels(source).set(examples / seconds)
    if flops > 0:
        counter("mx_flops_total",
                "Estimated FLOPs executed (cost_analysis accounting)",
                ("source",)).labels(source).inc(flops)
        if seconds > 0:
            fps = flops / seconds
            gauge("mx_model_flops_per_second",
                  "Estimated achieved FLOP/s", ("source",)).labels(source) \
                .set(fps)
            gauge("mx_mfu",
                  "Estimated model FLOPs utilization vs peak_flops() "
                  "(see docs/observability.md for CPU caveats)",
                  ("source",)).labels(source).set(fps / peak_flops())
    if lr is not None:
        gauge("mx_learning_rate", "Optimizer learning rate",
              ("source",)).labels(source).set(lr)
    sample_memory()


def set_epoch(epoch: int, source: str = "module"):
    gauge("mx_epoch", "Current training epoch", ("source",)) \
        .labels(source).set(epoch)


@contextmanager
def timed(phase: str, source: str = ""):
    """Time a coarse phase (fit/eval/export) into mx_phase_seconds."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        histogram("mx_phase_seconds", "Coarse phase wall time",
                  ("phase", "source"),
                  buckets=tuple(1e-3 * (4 ** i) for i in range(10))) \
            .labels(phase, source).observe(time.perf_counter() - t0)


# ---------------------------------------------------------------------------
# Communication accounting
# ---------------------------------------------------------------------------

_tls = threading.local()


def payload_bytes(x) -> int:
    """Bytes in an NDArray, tensor, array or (nested) list/tuple of them."""
    if x is None:
        return 0
    if isinstance(x, (list, tuple)):
        return sum(payload_bytes(v) for v in x)
    data = getattr(x, "_data", None)
    if data is not None and hasattr(data, "element_size"):
        x = data
    if hasattr(x, "element_size") and hasattr(x, "numel"):
        return int(x.numel()) * int(x.element_size())
    size = getattr(x, "size", None)
    dtype = getattr(x, "dtype", None)
    if size is None or dtype is None or callable(size):
        return 0
    try:
        import numpy as _np
        return int(size) * _np.dtype(str(dtype)).itemsize
    except Exception:
        return int(size) * 4


def record_comm(op: str, nbytes: int, store: str = "",
                seconds: Optional[float] = None, calls: int = 1,
                overlapped: bool = False, axis: str = ""):
    """Account one communication op: bytes, calls and (given) seconds,
    labelled by ``op``, ``store``, ``overlap`` (issued while the backward
    still ran) and the mesh ``axis`` it crosses (reference :741); on a
    multi-process job the rank rides as a trailing ``host`` label."""
    ov = "1" if overlapped else "0"
    h = _host_label()
    names = ("op", "store", "overlap", "axis", "host") if h \
        else ("op", "store", "overlap", "axis")
    vals = (op, store, ov, axis, h) if h else (op, store, ov, axis)
    counter("mx_comm_bytes_total", "Bytes moved by comm/collective ops",
            names).labels(*vals).inc(max(int(nbytes), 0))
    counter("mx_comm_calls_total", "Comm/collective operations",
            names).labels(*vals).inc(calls)
    if seconds is not None:
        counter("mx_comm_seconds_total", "Wall seconds inside comm ops",
                names).labels(*vals).inc(seconds)


# the collectives a backward could overlap: the ratio's denominator
_OVERLAP_OPS = frozenset({
    "allreduce", "reduce_scatter", "all_gather", "tp_weight_all_gather",
    "tp_act_psum", "tp_act_all_gather", "tp_act_psum_scatter"})


def comm_overlap_ratio(axis: Optional[str] = None) -> float:
    """Byte-weighted fraction of the ``_OVERLAP_OPS`` traffic issued
    overlapped with the backward, over one mesh axis if given; 0.0 when
    nothing was recorded."""
    fam = get_metric("mx_comm_bytes_total")
    if fam is None:
        return 0.0
    with _LOCK:
        series = list(fam._series.items())
    total = overlapped = 0.0
    for lv, s in series:
        if not lv or lv[0] not in _OVERLAP_OPS:
            continue
        if axis is not None and (len(lv) < 4 or lv[3] != axis):
            continue
        v = getattr(s, "value", 0.0)
        total += v
        if len(lv) > 2 and lv[2] == "1":
            overlapped += v
    return overlapped / total if total else 0.0


def comm_axis_bytes(axis: str, overlapped: Optional[bool] = None) -> float:
    """Total mx_comm_bytes_total on one mesh axis, optionally only the
    (non-)overlapped traffic."""
    fam = get_metric("mx_comm_bytes_total")
    if fam is None:
        return 0.0
    with _LOCK:
        series = list(fam._series.items())
    total = 0.0
    for lv, s in series:
        if len(lv) < 4 or lv[3] != axis:
            continue
        if overlapped is not None and (lv[2] == "1") != overlapped:
            continue
        total += getattr(s, "value", 0.0)
    return total


def record_optimizer_state(nbytes: int, source: str = "trainer"):
    """Per-replica optimizer-state bytes (the ZeRO update reports ~1/dp)."""
    gauge("mx_optimizer_state_per_replica_bytes",
          "Optimizer-state bytes held per replica",
          ("source",)).labels(source).set(int(nbytes))


# ---------------------------------------------------------------------------
# Input pipeline and dispatch window (engine/async_feed)
# ---------------------------------------------------------------------------

def record_feed_depth(depth: int, source: str = "feed"):
    """Batches a DeviceFeed has staged ahead of the consumer."""
    gauge("mx_feed_queue_depth",
          "Device-resident batches staged ahead by the async feed",
          ("source",)).labels(source).set(int(depth))


def record_feed_stall(total_seconds: float, source: str = "feed"):
    """Cumulative consumer seconds waiting on an empty feed queue: growth
    means the input pipeline, not the device, bounds throughput."""
    gauge("mx_feed_stall_seconds_total",
          "Cumulative seconds the consumer stalled on an empty feed queue",
          ("source",)).labels(source).set(float(total_seconds))


def record_inflight(n: int, source: str = "step"):
    """Steps issued but not retired in a DispatchWindow."""
    gauge("mx_inflight_steps",
          "Training steps dispatched but not yet retired by the bounded "
          "in-flight window", ("source",)).labels(source).set(int(n))


def record_dispatch_wait(total_seconds: float, source: str = "step"):
    """Cumulative seconds a DispatchWindow blocked on step completion."""
    gauge("mx_dispatch_wait_seconds_total",
          "Cumulative seconds the bounded in-flight window blocked on "
          "step completion", ("source",)).labels(source) \
        .set(total_seconds)


# ---------------------------------------------------------------------------
# Elastic fault tolerance
# ---------------------------------------------------------------------------

def record_checkpoint_save(seconds: float, nbytes: int,
                           source: str = "elastic"):
    """Booked by the snapshot writer on commit (its thread, never the step
    path): seconds from save() to the manifest's commit, and the bytes this
    process wrote."""
    h = _host_label()
    if h:
        gauge("mx_checkpoint_save_seconds",
              "Wall seconds of the last snapshot, dispatch to manifest "
              "commit", ("source", "host")).labels(source, h) \
            .set(float(seconds))
    else:
        gauge("mx_checkpoint_save_seconds",
              "Wall seconds of the last snapshot, dispatch to manifest "
              "commit", ("source",)).labels(source).set(float(seconds))
    counter("mx_checkpoint_save_seconds_total",
            "Cumulative snapshot wall seconds written by this process",
            ("source",)).labels(source).inc(max(float(seconds), 0.0))
    counter("mx_checkpoint_bytes_total",
            "Cumulative snapshot payload bytes written by this process",
            ("source",)).labels(source).inc(int(nbytes))


def record_resume(outcome: str, source: str = "elastic"):
    """Boot outcome: ``fresh``, ``resumed`` or ``resharded``."""
    counter("mx_resume_total",
            "Worker boots by restore outcome",
            ("outcome", "source")).labels(outcome, source).inc()


def record_moe_dropped(n: int, source: str = "moe"):
    """Capacity-overflow assignments dropped by top-k gating, booked at
    drain()/sync() from counts the step kept on the device."""
    counter("mx_moe_dropped_tokens_total",
            "Tokens dropped by MoE capacity overflow",
            ("source",)).labels(source).inc(max(int(n), 0))


# ---------------------------------------------------------------------------
# Serving (their callers come with the serving front door)
# ---------------------------------------------------------------------------

# the request-latency ladder: 1 ms .. 10 s, roughly log-spaced
DEFAULT_LATENCY_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
                           0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0)


def record_serving_enqueue(model: str, rows: int = 1):
    counter("mx_serving_requests_total", "Inference requests enqueued",
            ("model",)).labels(model).inc()
    counter("mx_serving_request_rows_total",
            "Rows (examples) across enqueued inference requests",
            ("model",)).labels(model).inc(max(int(rows), 0))


def record_serving_queue_depth(model: str, depth: int):
    gauge("mx_serving_queue_depth",
          "Requests waiting in the serving queue",
          ("model",)).labels(model).set(int(depth))


def record_serving_queue_wait(model: str, seconds: float):
    histogram("mx_serving_queue_wait_seconds",
              "Request queue wait (enqueue to batch take)",
              ("model",), buckets=DEFAULT_LATENCY_BUCKETS) \
        .labels(model).observe(float(seconds))


def record_serving_dispatch(model: str, bucket: int, rows: int):
    bucket = max(int(bucket), 1)
    rows = max(int(rows), 0)
    counter("mx_serving_batches_total", "Batches dispatched to the device",
            ("model", "bucket")).labels(model, str(bucket)).inc()
    counter("mx_serving_batch_rows_total",
            "Real (non-padding) rows dispatched",
            ("model", "bucket")).labels(model, str(bucket)).inc(rows)
    counter("mx_serving_padded_rows_total",
            "Padding rows dispatched (bucket size minus real rows)",
            ("model", "bucket")).labels(model, str(bucket)) \
        .inc(max(bucket - rows, 0))
    gauge("mx_serving_batch_occupancy",
          "Real-row fraction of the last dispatched bucket",
          ("model", "bucket")).labels(model, str(bucket)) \
        .set(rows / bucket)


def record_serving_completion(model: str, seconds: float, rows: int = 1,
                              status: str = "ok"):
    histogram("mx_serving_request_seconds",
              "End-to-end request latency (enqueue to result on host)",
              ("model",), buckets=DEFAULT_LATENCY_BUCKETS) \
        .labels(model).observe(float(seconds))
    counter("mx_serving_responses_total", "Completed inference requests",
            ("model", "status")).labels(model, status).inc()
    counter("mx_serving_response_rows_total",
            "Rows returned across completed requests",
            ("model",)).labels(model).inc(max(int(rows), 0))


def record_request_shed(model: str, reason: str = "queue_full"):
    counter("mx_requests_shed_total",
            "Serving requests shed by admission control or deadlines",
            ("model", "reason")).labels(model, reason).inc()


# ---------------------------------------------------------------------------
# Reliability plane (faults, the feed's producer, the coordinator)
# ---------------------------------------------------------------------------

def record_fault_injected(point: str):
    """One fault fired by the injection plane."""
    counter("mx_faults_injected_total",
            "Faults fired by the injection plane (mxnet_tpu.faults)",
            ("point",)).labels(point).inc()


def record_io_retry(point: str):
    """One transient-IO retry at a named fault point."""
    counter("mx_io_retries_total",
            "Transient IO failures retried with exponential backoff",
            ("point",)).labels(point).inc()


def record_feed_producer_leak(source: str = "feed"):
    """One DeviceFeed producer thread abandoned after the join timeout."""
    counter("mx_feed_producer_leaks_total",
            "DeviceFeed producer threads abandoned after join timeout",
            ("source",)).labels(source).inc()


def record_feed_producer_restart(source: str = "feed"):
    """One bounded DeviceFeed producer restart after a transient error."""
    counter("mx_feed_producer_restarts_total",
            "Bounded DeviceFeed producer restarts on transient errors",
            ("source",)).labels(source).inc()


def record_hosts_live(n: int, generation: int, source: str = "elastic"):
    """Hosts with a fresh coordinator lease, and the generation epoch."""
    gauge("mx_hosts_live",
          "Hosts with a fresh coordinator membership lease",
          ("source",)).labels(source).set(int(n))
    gauge("mx_coordinator_generation",
          "Monotonic group-membership generation epoch",
          ("source",)).labels(source).set(int(generation))


def record_commit_barrier(seconds: float, source: str = "elastic"):
    """One host's wait in the two-phase cross-host commit barrier."""
    histogram("mx_commit_barrier_seconds",
              "Cross-host snapshot commit barrier wait per host",
              ("source",), buckets=DEFAULT_LATENCY_BUCKETS) \
        .labels(source).observe(float(seconds))


def record_hang_watchdog(what: str):
    """One hang-watchdog firing (``drain``, ``commit``, ``heartbeat``)."""
    counter("mx_hang_watchdog_fires_total",
            "Hang-watchdog firings (flight recorder dumped, process exited)",
            ("what",)).labels(what).inc()


@contextmanager
def comm_scope(op: str, nbytes: int, store: str = ""):
    """Time and count a comm region, annotated into the device trace as
    ``mx.comm.<op>``. Re-entrant: nested scopes (pushpull -> push -> pull)
    count once."""
    if getattr(_tls, "in_comm", False):
        yield
        return
    _tls.in_comm = True
    t0 = time.perf_counter()
    try:
        with _record_function(f"mx.comm.{op}"):
            yield
    finally:
        t1 = time.perf_counter()
        _tls.in_comm = False
        record_comm(op, nbytes, store, seconds=t1 - t0)


def _record_function(name: str):
    try:
        from torch.profiler import record_function
        return record_function(name)
    except Exception:
        return contextlib.nullcontext()


def annotate(name: str):
    """A ``torch.profiler.record_function`` region while telemetry is on
    (it lands in ``trace_steps``' trace); a nullcontext otherwise."""
    if not _ENABLED:
        return contextlib.nullcontext()
    return _record_function(name)


def instrument_comm(op: str):
    """Decorator for kvstore entry points ``fn(self, key, value, ...)``:
    bytes, time and a trace region while telemetry is on, one flag check
    while it is off."""
    def deco(fn):
        @functools.wraps(fn)
        def wrapper(self, *args, **kw):
            if not _ENABLED:
                return fn(self, *args, **kw)
            payload = args[1] if len(args) > 1 \
                else kw.get("value", kw.get("out"))
            nbytes = payload_bytes(payload) or payload_bytes(kw.get("out"))
            with comm_scope(op, nbytes, getattr(self, "type", "")):
                return fn(self, *args, **kw)
        return wrapper
    return deco


# ---------------------------------------------------------------------------
# Memory watermarks
# ---------------------------------------------------------------------------

_mem_peak = 0.0


def sample_memory():
    """Sample the caching allocator's allocated bytes into
    mx_device_live_bytes and its peak into mx_device_peak_bytes. Called per
    recorded step; a no-op in a process that has not initialised CUDA."""
    global _mem_peak
    torch = sys.modules.get("torch")
    try:
        if torch is None or not torch.cuda.is_initialized():
            return
        live = float(torch.cuda.memory_allocated())
        peak_now = float(torch.cuda.max_memory_allocated())
    except Exception:
        return
    with _LOCK:
        _mem_peak = max(_mem_peak, live, peak_now)
        peak = _mem_peak
    gauge("mx_device_live_bytes",
          "Live device-buffer bytes at the last sample").set(live)
    gauge("mx_device_peak_bytes",
          "Peak sampled device-buffer bytes").set(peak)


# ---------------------------------------------------------------------------
# Export
# ---------------------------------------------------------------------------

def _sync_engine_stats():
    """Mirror the engine's counters into gauges at scrape time, and the
    overlap ratio, so one scrape carries the whole picture."""
    if get_metric("mx_comm_bytes_total") is not None:
        gauge("mx_comm_overlap_ratio",
              "Fraction of gradient-collective wire bytes (equivalently, "
              "estimated collective seconds at the roofline bandwidth "
              "peak) issued overlapped with backward compute") \
            .set(comm_overlap_ratio())
        fam = get_metric("mx_comm_bytes_total")
        with _LOCK:
            axes = sorted({lv[3] for lv in fam._series
                           if len(lv) > 3 and lv[3]})
        for ax in axes:
            gauge("mx_comm_overlap_ratio_axis",
                  "Per-mesh-axis fraction of collective wire bytes issued "
                  "overlapped with backward compute",
                  ("axis",)).labels(ax).set(comm_overlap_ratio(axis=ax))
    try:
        from .. import engine as _engine
        st = _engine.cache_stats()
    except Exception:
        return
    for k, v in st.items():
        if isinstance(v, (int, float)):
            gauge(f"mx_compilation_{k}",
                  "Compilation-engine counter (engine.cache_stats)").set(v)
    total_dropped = sum(f.dropped for f in _FAMILIES.values())
    if total_dropped:
        gauge("mx_telemetry_dropped_series_total",
              "Series dropped by the per-family cardinality cap") \
            .set(total_dropped)


def collect() -> Dict[str, Any]:
    _sync_engine_stats()
    with _LOCK:
        fams = list(_FAMILIES.items())
    return {name: fam._as_dict() for name, fam in fams}


def scrape() -> str:
    """Prometheus text exposition of every registered metric, with the
    engine's counters mirrored from engine.cache_stats()."""
    _sync_engine_stats()
    lines: List[str] = []
    with _LOCK:
        fams = list(_FAMILIES.values())
    for fam in fams:
        fam._render(lines)
    return "\n".join(lines) + "\n"


def scrape_json(indent=None) -> str:
    return json.dumps(collect(), indent=indent, sort_keys=True)


def report() -> str:
    """Human-readable status: every series, then the engine's counters (the
    reference's profiler table waits for the profiler module)."""
    lines = ["=== telemetry ==="]
    for name, d in sorted(collect().items()):
        for s in d["series"]:
            lab = ",".join(f"{k}={v}" for k, v in s["labels"].items() if v)
            key = f"{name}{{{lab}}}" if lab else name
            if d["type"] == "histogram":
                cnt = s["count"]
                avg = s["sum"] / cnt if cnt else 0.0
                lines.append(f"{key:<56}count={cnt:<10}avg={avg:.6g}")
            else:
                lines.append(f"{key:<56}{s['value']:.6g}")
    lines.append("")
    lines.append("=== engine (engine.cache_stats) ===")
    from .. import engine as _engine
    lines.append(json.dumps(_engine.cache_stats(), sort_keys=True, default=str))
    return "\n".join(lines)


def _family_snapshot(name: str) -> Dict[str, float]:
    """{joined label values: value} for one family (statusz)."""
    fam = get_metric(name)
    if fam is None:
        return {}
    with _LOCK:
        series = list(fam._series.items())
    return {",".join(lv) or "_": getattr(s, "value", getattr(s, "sum", 0.0))
            for lv, s in series}


def statusz(extra: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """The /statusz snapshot (reference :1314): every declared MXNET_* knob
    whose live value differs from its default, the engine's counters, the
    fault plane's arming, the in-flight and queue gauges, anomaly counts,
    the trailing flight-recorder entries and, where the coordinator is in
    use, its group view. ``extra`` merges caller sections."""
    config = {}
    for name, (default, _typ, _doc) in sorted(env.items().items()):
        live = env.get(name)
        if live != default:
            config[name] = live
    try:
        from .. import engine as _engine
        compilation = {k: v for k, v in _engine.cache_stats().items()
                       if isinstance(v, (int, float, str))}
    except Exception:
        compilation = {}
    try:
        from .. import faults as _faults
        fault_plane = {"active": bool(_faults._ACTIVE),
                       "armed": _faults.armed()}
    except Exception:
        fault_plane = {}
    coordinator: Dict[str, Any] = {}
    _coord_mod = sys.modules.get(__name__.rpartition(".")[0] + ".elastic.coordinator")
    if _coord_mod is not None:
        try:
            coordinator = _coord_mod.statusz_view()
        except Exception:
            coordinator = {}
    d: Dict[str, Any] = {
        "telemetry_enabled": _ENABLED,
        "tracing_enabled": tracing._ENABLED,
        "device_trace_active": trace_active(),
        "config": config,
        "compilation": compilation,
        "faults": fault_plane,
        "serving_queue_depth": _family_snapshot("mx_serving_queue_depth"),
        "inflight_steps": _family_snapshot("mx_inflight_steps"),
        "anomalies": _family_snapshot("mx_anomalies_total"),
        "recorder_events": tracing.recent(),
        "coordinator": coordinator,
    }
    if extra:
        d.update(extra)
    return d


# ---------------------------------------------------------------------------
# HTTP endpoint (Prometheus scrape target)
# ---------------------------------------------------------------------------

_http_server = [None]


def start_http_server(port: int = 0, addr: str = "127.0.0.1") -> int:
    """Serve GET /metrics (Prometheus text), /metrics.json, /statusz and
    /healthz on a daemon thread; returns the bound port (0 picks one)."""
    import http.server

    class Handler(http.server.BaseHTTPRequestHandler):
        def do_GET(self):
            if self.path.startswith("/metrics.json"):
                body = scrape_json().encode()
                ctype = "application/json"
            elif self.path.startswith("/metrics"):
                body = scrape().encode()
                ctype = "text/plain; version=0.0.4"
            elif self.path.startswith("/statusz"):
                body = json.dumps(statusz(), default=str).encode()
                ctype = "application/json"
            elif self.path.startswith("/healthz"):
                body = b'{"status": "ok"}'
                ctype = "application/json"
            else:
                self.send_response(404)
                self.end_headers()
                return
            self.send_response(200)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *a):
            pass

    srv = http.server.ThreadingHTTPServer((addr, port), Handler)
    t = threading.Thread(target=srv.serve_forever, daemon=True,
                         name="mx-telemetry-http")
    t.start()
    with _LOCK:
        _http_server[0] = srv
    return srv.server_address[1]


def stop_http_server():
    with _LOCK:
        srv, _http_server[0] = _http_server[0], None
    if srv is not None:
        srv.shutdown()
        srv.server_close()


# the span-tracing plane and flight recorder (record_step and statusz()
# above reference it at call time)
from . import tracing  # noqa: E402
