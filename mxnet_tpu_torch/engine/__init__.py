"""The graph cache: CUDA graphs in place of the reference's compiled programs.

Counterpart of ``mxnet_tpu/engine/__init__.py:121-211, :330``. The reference
compiles its fused training step and each hybridized block's forward into
XLA executables and keeps them in one process-wide cache. The port runs
PyTorch eagerly; on the card it captures the same two hot paths into
``torch.cuda.CUDAGraph``s and replays them, so a step or a request costs
Python one graph launch and a few copies instead of hundreds to thousands of
kernel launches. The names and meanings kept:

- ``lookup(key)``, ``insert(key, entry)``, ``clear_compilation_cache(
  fingerprint=None)`` and ``cache_size()``: the cache of captured graphs. A
  key is ``(kind, id(instance), structural fingerprint, signature)``: a
  graph binds the addresses of one instance's tensors, so N instances of a
  model capture N graphs, where the reference compiles N instances once.
  The cache holds its entries weakly: an entry lives as long as its owner
  (a block's ``_cached_graphs``, a trainer's ``_graphs``) keeps it, and its
  graph's memory goes with it. ``clear_compilation_cache`` marks the entries
  it drops invalid, and their owner captures again at its next call;
- ``cache_stats()``: ``captures``, ``replays``, ``hits``, ``misses``,
  ``capture_seconds`` and ``pool_bytes`` (the growth of the caching
  allocator's reserved memory during each capture: the graph pools'
  segments), with ``artifacts`` (live entries); ``reset_stats()`` zeroes
  them; ``compile_timer()`` times one capture into them;
- ``capturing()``, the counterpart of ``in_trace()``: whether the current
  CUDA stream is capturing. Work issued then folds into the enclosing
  graph, as the reference's folds into an enclosing trace.

The reference's persistent compilation cache, buffer donation and
``estimate_cost`` are XLA's and have no counterpart here. In place of XLA's
cost model a signature's FLOPs are counted once, over its eager warm-up
step or the capture of its graph (``count_flops``:
``torch.utils.flop_counter.FlopCounterMode`` over torch's ops, plus what the
hand kernels' wrappers add by their formulas through ``add_flops``, since
the mode sees nothing inside a kernel launched through ctypes; ``count_once``
keeps a trainer's count by signature, ``count_backward`` measures a
backward), and ``record_execution(kind, flops, steps)`` adds them at
each replay or step: ``cache_stats()``'s ``flops_executed`` is telemetry's
MFU numerator (``flops_estimated`` its share booked by a heuristic), and
``step_executions``, ``fwd_executions`` and ``bwd_executions`` count what
ran.

The async feed (``engine.async_feed``: ``DeviceFeed``, ``DispatchWindow``,
``PendingScalar``) is imported at its first use, as in the reference.

``capture(fn, key, device, owner, ptrs)`` captures ``fn()`` into a graph
on the device's side stream (``side_stream``), after the caller ran it
there at least once as the warm-up (torch's recipe: deferred shapes, kernel
builds, the fused optimizer's pointer tables, cuBLAS handles and
workspaces, autograd's streams are set up by that run), inserts it under
``key`` and returns the ``GraphEntry``: ``replay()``, the static
``outputs`` of ``fn`` (overwritten by every replay), and the deltas of the
launch counters. The graphs of one ``owner`` share one memory pool: they
replay on one stream, one at a time, and none keeps data from one replay to
the next. Graphs that do (a hybridized block's training pair: the forward
leaves its activations for the backward) pass a ``pool`` of their own.

When a graph is stale: it reads its tensors by address, so an entry keeps
``ptrs(owner)`` (the addresses of the tensors its owner may give new
storage) as they were at the capture. ``storage_epoch()`` moves whenever a
parameter's value or gradient buffer gets new storage
(``note_storage_change``); ``lookup`` then compares ``ptrs(owner)`` with
the capture's, and an entry whose addresses moved, or whose owner is gone,
is dropped (a miss), so its owner warms up and captures again. Where the storage is written in place
(``set_data``, the elastic restore) the graph stays.

Launch counters under replay: every kernel wrapper counts its launches in
Python (``flash_attention_fwd.launches``, ``fused_adam_update.launches``
...), which a replay does not run. The wrappers register their counters
here (``register_counter``); a capture records what they counted while it
ran, takes that back (capture itself runs nothing on the card), and each
replay adds it again. So a counter keeps meaning "launches executed on the
card". ``ops.registry``'s ``Op.calls`` is not registered: it counts Python
dispatches only.

A capture registers the device's generator (``random.generator``) with the
graph (``CUDAGraph.register_generator_state``), so a replay draws the
numbers the eager step would have drawn at that point of the stream.

What is kept alive for a graph: ``keep_alive(obj)`` called while a capture
runs adds ``obj`` to its entry (the fused optimizer's pointer tables, which
the captured launches read by address).
"""
from __future__ import annotations

import threading
import time
import weakref
from contextlib import contextmanager
from typing import Any, Dict, List, Optional, Tuple

import torch

from ..base import MXNetError

__all__ = ["lookup", "insert", "clear_compilation_cache", "cache_size", "cache_stats",
           "reset_stats", "compile_timer", "capturing", "capture", "side_stream",
           "GraphEntry", "register_counter", "keep_alive", "storage_epoch",
           "note_storage_change", "record_execution", "count_flops", "count_once",
           "count_backward", "add_flops", "attention_flops", "async_feed", "DeviceFeed",
           "DispatchWindow", "PendingScalar"]


def __getattr__(name):
    # the feed is imported at its first use (PEP 562, the reference's idiom)
    if name == "async_feed":
        import importlib
        mod = importlib.import_module(".async_feed", __name__)
        globals()[name] = mod
        return mod
    if name in ("DeviceFeed", "DispatchWindow", "PendingScalar"):
        from . import async_feed as _af
        val = getattr(_af, name)
        globals()[name] = val
        return val
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")

_LOCK = threading.RLock()
_CACHE: "weakref.WeakValueDictionary[Tuple, GraphEntry]" = weakref.WeakValueDictionary()
_STATS: Dict[str, Any] = {"captures": 0, "replays": 0, "hits": 0, "misses": 0,
                          "capture_seconds": 0.0, "pool_bytes": 0,
                          "step_executions": 0, "fwd_executions": 0,
                          "bwd_executions": 0, "flops_executed": 0.0,
                          "flops_estimated": 0.0}
_COUNTERS: List[Tuple[Any, str]] = []
_STREAMS: Dict[int, "torch.cuda.Stream"] = {}
_POOLS: "weakref.WeakKeyDictionary[Any, Any]" = weakref.WeakKeyDictionary()
_ACTIVE = threading.local()
_EPOCH = [0]


def storage_epoch() -> int:
    """Moves whenever some parameter's value or gradient gets new storage."""
    return _EPOCH[0]


def note_storage_change() -> None:
    """Move ``storage_epoch``: the caller gave tensors that a graph may read
    new storage."""
    _EPOCH[0] += 1


def lookup(key: Tuple) -> Optional["GraphEntry"]:
    """The entry under ``key`` if it may replay (see the module docstring:
    a stale entry is dropped); counts a hit or a miss."""
    with _LOCK:
        ent = _CACHE.get(key)
        if ent is not None and not ent.live():
            _CACHE.pop(key, None)
            ent = None
        _STATS["hits" if ent is not None else "misses"] += 1
        return ent


def insert(key: Tuple, entry: "GraphEntry") -> "GraphEntry":
    with _LOCK:
        _CACHE[key] = entry
    return entry


def clear_compilation_cache(fingerprint=None) -> None:
    """Drop every entry, or those whose key holds ``fingerprint``; their
    owners capture again at their next call."""
    with _LOCK:
        victims = [k for k in list(_CACHE.keys()) if fingerprint is None or fingerprint in k]
        for k in victims:
            ent = _CACHE.pop(k, None)
            if ent is not None:
                ent.valid = False


def cache_size() -> int:
    with _LOCK:
        return len(_CACHE)


def cache_stats() -> Dict[str, Any]:
    with _LOCK:
        return dict(_STATS, artifacts=len(_CACHE))


def reset_stats() -> None:
    with _LOCK:
        for k in _STATS:
            _STATS[k] = 0.0 if isinstance(_STATS[k], float) else 0


def _bump(key, n=1) -> None:
    with _LOCK:
        _STATS[key] += n


def record_execution(kind: str, flops: float = 0.0, steps: int = 1,
                     estimated: bool = False) -> None:
    """Account ``steps`` executions of a step (``kind`` "step"), a forward
    ("fwd") or a backward (any other) and the ``flops`` they did (reference
    ``engine.record_execution``): host arithmetic only. ``estimated`` flags
    a heuristic count (a backward booked at twice its forward), which
    ``flops_estimated`` also adds."""
    with _LOCK:
        key = {"step": "step_executions", "fwd": "fwd_executions"}.get(kind, "bwd_executions")
        _STATS[key] += steps
        if flops:
            _STATS["flops_executed"] += flops
            if estimated:
                _STATS["flops_estimated"] += flops


# the open count_flops() accumulators: global, not per thread, since a CUDA
# backward runs the kernels' wrappers on autograd's device thread
_FLOP_STACK: List["FlopCount"] = []


class FlopCount:
    """What ``count_flops`` counted: ``total`` (set when the block ends),
    ``kernels`` (the hand kernels' share, by their formulas)."""

    __slots__ = ("total", "kernels")

    def __init__(self):
        self.total = 0.0
        self.kernels = 0.0


@contextmanager
def count_flops():
    """Count the FLOPs of the work issued in the block:
    ``FlopCounterMode`` over torch's ops plus ``add_flops`` from the hand
    kernels' wrappers. Yields a ``FlopCount`` whose ``total`` is set at the
    end. The mode runs the ops unchanged."""
    from torch.utils.flop_counter import FlopCounterMode
    fc = FlopCount()
    mode = FlopCounterMode(display=False)
    with _LOCK:
        _FLOP_STACK.append(fc)
    try:
        with mode:
            yield fc
    finally:
        with _LOCK:
            _FLOP_STACK.remove(fc)
        fc.total = float(mode.get_total_flops()) + fc.kernels


def count_once(counts: Dict, sig, fn, *args):
    """``fn(*args)``, its FLOPs counted into ``counts[sig]`` at the
    signature's first call (``count_flops``); a later call runs ``fn``
    alone. A trainer calls it at each signature's eager warm-up, whatever
    telemetry's flag, since a replay runs no Python to count."""
    if sig in counts:
        return fn(*args)
    with count_flops() as fc:
        out = fn(*args)
    counts[sig] = fc.total
    return out


def count_backward(outputs, inputs) -> float:
    """The FLOPs of the backward from ``outputs`` to ``inputs`` (those that
    need a gradient): one ``torch.autograd.grad`` under ``count_flops``, with
    unit cotangents, the graph kept and the gradients dropped; the kernels'
    launch counters are set back after it, as it is a measurement and not a
    step."""
    heads = [o for o in outputs if o.requires_grad]
    wrt = [t for t in inputs if t.requires_grad]
    if not heads or not wrt:
        return 0.0
    before = _snapshot()
    try:
        with count_flops() as fc:
            torch.autograd.grad(heads, wrt, [torch.ones_like(o) for o in heads],
                                allow_unused=True, retain_graph=True)
    finally:
        _restore(before)
    return fc.total


def add_flops(n: float) -> None:
    """A hand kernel's FLOPs, by its formula, into the open counts."""
    if _FLOP_STACK:
        with _LOCK:
            for fc in _FLOP_STACK:
                fc.kernels += n


def attention_flops(kind: str, bh: int, tq: int, tk: int, d: int, causal: bool) -> float:
    """FLOPs of K1 (``"fwd"``: QK^T and PV, 4 a pair and head dim), K2
    (``"dq"``: S, dP and dQ, 6) or K3 (``"dkv"``: S, dP, dV and dK, 8) over
    the (query, key) pairs the kernel keeps: every pair, or under ``causal``
    the key at or before the query (T(T+1)/2 pairs at T = Tk). The
    formula PERF.md's bounds use."""
    per = {"fwd": 4, "dq": 6, "dkv": 8}[kind]
    if causal:
        m = min(tq, tk)
        pairs = m * (m + 1) // 2 + max(tq - tk, 0) * tk
    else:
        pairs = tq * tk
    return float(per) * bh * pairs * d


@contextmanager
def compile_timer():
    """Times one capture into ``captures`` and ``capture_seconds``."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        with _LOCK:
            _STATS["captures"] += 1
            _STATS["capture_seconds"] += time.perf_counter() - t0


def capturing() -> bool:
    """Whether the current CUDA stream is capturing a graph (the reference's
    ``in_trace()``)."""
    return torch.cuda.is_available() and torch.cuda.is_current_stream_capturing()


# -- launch counters ---------------------------------------------------------------

def register_counter(owner, attr: str) -> None:
    """Count ``owner.<attr>`` (an int, or a dict of ints) under replay."""
    _COUNTERS.append((owner, attr))


def _snapshot():
    out = []
    for owner, attr in _COUNTERS:
        v = getattr(owner, attr)
        out.append(dict(v) if isinstance(v, dict) else v)
    return out


def _deltas(before, after):
    deltas = []
    for (owner, attr), b, a in zip(_COUNTERS, before, after):
        if isinstance(a, dict):
            d = {k: n - b.get(k, 0) for k, n in a.items() if n != b.get(k, 0)}
        else:
            d = a - b
        if d:
            deltas.append((owner, attr, d))
    return tuple(deltas)


def _apply(deltas) -> None:
    for owner, attr, d in deltas:
        if isinstance(d, dict):
            v = getattr(owner, attr)
            for k, n in d.items():
                v[k] = v.get(k, 0) + n
        else:
            setattr(owner, attr, getattr(owner, attr) + d)


def _restore(before) -> None:
    """Set every counter back to its ``_snapshot()`` (dicts in place)."""
    for (owner, attr), b in zip(_COUNTERS, before):
        if isinstance(b, dict):
            v = getattr(owner, attr)
            v.clear()
            v.update(b)
        else:
            setattr(owner, attr, b)


def keep_alive(obj) -> None:
    """Keep ``obj`` alive as long as the graph being captured, if any."""
    keep = getattr(_ACTIVE, "keep", None)
    if keep is not None:
        keep.append(obj)


# -- capture and replay ------------------------------------------------------------

def _device(device) -> torch.device:
    device = torch.device(device)
    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def _stream(device: torch.device) -> "torch.cuda.Stream":
    """The device's side stream, on which warm-ups and captures run."""
    with _LOCK:
        s = _STREAMS.get(device.index)
        if s is None:
            s = _STREAMS[device.index] = torch.cuda.Stream(device)
        return s


@contextmanager
def side_stream(device):
    """Run the block on ``device``'s side stream, ordered after the work
    issued so far on the current stream; the current stream waits for it at
    the end."""
    device = _device(device)
    s = _stream(device)
    current = torch.cuda.current_stream(device)
    s.wait_stream(current)
    try:
        with torch.cuda.stream(s):
            yield s
    finally:
        current.wait_stream(s)


class GraphEntry:
    """One captured graph: ``replay()`` runs it on the current stream and
    adds its launch counts; ``outputs`` are its static outputs; ``live()``
    whether it may replay (valid, its owner alive, and ``ptrs(owner)`` as at
    the capture). The owner is held weakly: an owner that keeps its entries
    makes no reference cycle through them."""

    __slots__ = ("graph", "outputs", "deltas", "keep", "capture_seconds", "pool_bytes",
                 "valid", "owner", "ptrs_fn", "ptrs", "epoch", "__weakref__")

    def __init__(self, graph, outputs, deltas, keep, seconds, pool_bytes, owner=None,
                 ptrs=None):
        self.graph = graph
        self.outputs = outputs
        self.deltas = deltas
        self.keep = keep
        self.capture_seconds = seconds
        self.pool_bytes = pool_bytes
        self.valid = True
        self.owner = weakref.ref(owner) if owner is not None else None
        self.ptrs_fn = ptrs
        self.ptrs = ptrs(owner) if ptrs is not None else ()
        self.epoch = _EPOCH[0]

    def live(self) -> bool:
        if self.valid and self.epoch != _EPOCH[0]:
            owner = self.owner() if self.owner is not None else None
            if self.ptrs_fn is not None and (owner is None or self.ptrs_fn(owner) != self.ptrs):
                self.valid = False
            else:
                self.epoch = _EPOCH[0]
        return self.valid

    def replay(self):
        try:
            self.graph.replay()
        except RuntimeError as e:
            raise MXNetError(f"CUDA graph replay failed: {e}") from e
        _apply(self.deltas)
        _bump("replays")
        return self.outputs


def capture(fn, key: Tuple, device, owner, ptrs=None, pool=None) -> GraphEntry:
    """Capture ``fn()`` on ``device``'s side stream into a new graph in
    ``owner``'s memory pool (or in ``pool``, a ``graph_pool_handle()``) and
    insert it under ``key``; ``ptrs(owner)``: the addresses that make it
    stale when they move. Raises ``MXNetError`` with the CUDA error if the
    capture fails. Run ``fn`` once on ``side_stream(device)`` first."""
    from .. import random as _random
    device = _device(device)
    graph = torch.cuda.CUDAGraph()
    gen = _random.generator(device)
    if not hasattr(graph, "register_generator_state"):
        raise MXNetError(f"torch {torch.__version__} has no "
                         f"CUDAGraph.register_generator_state: a captured graph cannot "
                         f"draw from the port's generators")
    graph.register_generator_state(gen)
    with _LOCK:
        if pool is None:
            pool = _POOLS.get(owner)
            if pool is None:
                pool = _POOLS[owner] = torch.cuda.graph_pool_handle()
    before = _snapshot()
    keep: List[Any] = []
    prev, _ACTIVE.keep = getattr(_ACTIVE, "keep", None), keep
    s = _stream(device)
    torch.cuda.synchronize(device)
    torch.cuda.empty_cache()    # as torch.cuda.graph does: the growth below is the pool's
    reserved = torch.cuda.memory_reserved(device)
    try:
        with compile_timer():
            t0 = time.perf_counter()
            with torch.cuda.device(device):
                s.wait_stream(torch.cuda.current_stream(device))
                with torch.cuda.graph(graph, pool=pool, stream=s,
                                      capture_error_mode="thread_local"):
                    outputs = fn()
                torch.cuda.current_stream(device).wait_stream(s)
            seconds = time.perf_counter() - t0
    except MXNetError:
        raise
    except Exception as e:
        raise MXNetError(f"CUDA graph capture of {key[0]} failed: {e}") from e
    finally:
        _ACTIVE.keep = prev
        deltas = _deltas(before, _snapshot())
        _restore(before)        # the capture ran nothing: each replay counts instead
    pool_bytes = max(0, torch.cuda.memory_reserved(device) - reserved)
    _bump("pool_bytes", pool_bytes)
    return insert(key, GraphEntry(graph, outputs, deltas, keep, seconds, pool_bytes, owner,
                                  ptrs))
