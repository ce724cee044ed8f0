"""The port's tracing plane and flight recorder against the reference's.

Following the cases of ``tests/test_tracing.py`` (less its serving cases,
whose front door is not ported): each sequence of span, event and
watchdog calls runs in ``mxnet_tpu.telemetry.tracing`` and in the port's,
and the rings must hold the same entries (kinds, names, attributes, and the
same parent links once each package's process-unique ids are numbered in
order of appearance), the same Chrome-trace and NDJSON structure, and the
same ``mx_anomalies_total`` counts:

- disarmed, ``span()`` is one shared nullcontext and nothing is recorded;
  armed, ids nest and attributes, an exception's ``error`` attribute, a
  context adopted on another thread (``attach``/``new_root``), a
  preallocated context (``record_span(ctx=)``), the ring's bound
  (``set_max_spans``, ``recent``);
- ``dump_chrome_trace`` and ``dump_flight_recorder``, also while another
  thread records; ``telemetry.reset()`` clears the ring; ``/statusz`` and
  ``/healthz``;
- the watchdog: an EWMA step-time regression after the warm-up, nonfinite
  losses, and a ``PendingScalar`` read of a NaN step loss;
- the hooks: a fault's firing is a recorder event, ``io_retry`` records a
  span an attempt and an event a retry; ``elastic.run`` under SIGTERM dumps
  the flight recorder with the final steps' ``mx.dp.step`` spans, the
  preemption event and the snapshot writer's spans, and dumps on a step's
  exception; the feed's producer spans and the window's.
"""
import contextlib
import json
import os
import signal
import threading
import urllib.request

import numpy as np
import pytest
import torch

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import telemetry
from mxnet_tpu_torch.telemetry import tracing
from torch_threads import one_torch_thread  # noqa: F401


@pytest.fixture
def rtr():
    """The reference's tracing, fresh and disarmed, as the port's."""
    from mxnet_tpu import telemetry as rtelem
    from mxnet_tpu.telemetry import tracing as rtracing
    for t, tl in ((telemetry, tracing), (rtelem, rtracing)):
        t.reset()
        tl.disable()
        t.disable()
    yield rtelem, rtracing
    for t, tl in ((telemetry, tracing), (rtelem, rtracing)):
        tl.disable()
        t.disable()
        t.stop_http_server()
        t.reset()


@contextlib.contextmanager
def _armed(*planes):
    for t, tl in planes:
        t.enable()
        tl.enable()
    try:
        yield
    finally:
        for t, tl in planes:
            tl.disable()


def _shape(entries):
    """The ring with ids numbered by first appearance, times dropped."""
    ids = {}

    def num(x):
        if x is None:
            return None
        return ids.setdefault(x, len(ids))
    out = []
    for e in entries:
        out.append((e["kind"], e["name"], num(e["trace_id"]), num(e["span_id"]),
                    num(e["parent_id"]), {k: v for k, v in e["attrs"].items()
                                          if k not in ("seconds", "ewma")}))
    return out


def _both(rtr, fn):
    """Run ``fn(tracing, telemetry)`` armed in each package; return both
    rings' shapes."""
    rtelem, rtracing = rtr
    shapes = []
    for t, tl in ((telemetry, tracing), (rtelem, rtracing)):
        with _armed((t, tl)):
            fn(tl, t)
            shapes.append(_shape(tl.spans()))
    return shapes


# -- the span API ----------------------------------------------------------------------

def test_disarmed_span_is_shared_nullcontext(rtr):
    assert not tracing.is_enabled()
    a, b = tracing.span("x"), tracing.span("y", rows=3)
    assert a is b is tracing._NULL
    with a:
        pass
    assert tracing.record_span("x", 0.0, 1.0) is None and tracing.event("x") is None
    assert tracing.spans() == []


def test_nesting_attrs_and_errors_match_reference(rtr):
    def run(tl, t):
        with tl.span("outer", step=1) as s_out:
            assert tl.current() == s_out.context
            with tl.span("inner") as s_in:
                s_in.set_attr("rows", 8)
        assert tl.current() is None
        with pytest.raises(ValueError):
            with tl.span("boom"):
                raise ValueError("x")
        tl.event("mx.fault", point="p")
    got, want = _both(rtr, run)
    assert got == want
    assert [e[1] for e in got] == ["inner", "outer", "boom", "mx.fault"]
    assert got[0][4] == got[1][3] and got[1][4] is None
    assert got[2][5] == {"error": "ValueError"}
    (e,) = [e for e in tracing.spans() if e["name"] == "outer"]
    assert e["trace_id"].startswith(tracing._PREFIX)


def test_cross_thread_attach_and_preallocated_ctx(rtr):
    def run(tl, t):
        ctx = tl.new_root("producer")
        done = threading.Event()

        def worker():
            with tl.attach(ctx):
                with tl.span("work"):
                    pass
            done.set()
        threading.Thread(target=worker).start()
        assert done.wait(5)
        req = tl.new_root("req")
        assert tl.record_span("root", 1.0, 2.0, ctx=req, status="ok") == req
        tl.record_span("child", 1.2, 1.5, parent=req)
    got, want = _both(rtr, run)
    assert got == want
    assert got[0][2] != got[1][2] and got[2][4] == got[1][3]


def test_ring_bound_and_set_max_spans(rtr):
    def run(tl, t):
        tl.set_max_spans(8)
        try:
            for i in range(32):
                tl.event("e", i=i)
            assert [e["attrs"]["i"] for e in tl.recent(3)] == [29, 30, 31]
            assert len(tl.spans()) == 8
        finally:
            tl.set_max_spans(100_000)
    got, want = _both(rtr, run)
    assert [e[5]["i"] for e in got] == [e[5]["i"] for e in want] == list(range(24, 32))


# -- export surfaces ---------------------------------------------------------------------

def test_chrome_trace_and_flight_recorder(rtr, tmp_path):
    rtelem, rtracing = rtr
    out = {}
    for name, t, tl in (("port", telemetry, tracing), ("ref", rtelem, rtracing)):
        with _armed((t, tl)):
            with tl.span("mx.dp.step", step=1):
                tl.event("mx.fault", point="p")
            tl.dump_chrome_trace(str(tmp_path / f"{name}.json"))
            tl.dump_flight_recorder(str(tmp_path / f"{name}.ndjson"), reason="test")
        data = json.loads((tmp_path / f"{name}.json").read_text())
        lines = [json.loads(ln) for ln in (tmp_path / f"{name}.ndjson").read_text()
                 .splitlines()]
        out[name] = (data, lines)
    for name in out:
        data, lines = out[name]
        assert data["displayTimeUnit"] == "ms"
        by = {e["name"]: e for e in data["traceEvents"]}
        assert by["mx.dp.step"]["ph"] == "X" and by["mx.fault"]["ph"] == "i"
        assert by["mx.fault"]["args"]["parent_id"] == by["mx.dp.step"]["args"]["span_id"]
        meta, entries = lines[0], lines[1:]
        assert meta["kind"] == "meta" and meta["reason"] == "test"
        assert meta["pid"] == os.getpid() and meta["entries"] == len(entries) == 2
    for k in ("ph", "cat"):
        assert [e[k] for e in out["port"][0]["traceEvents"]] == \
            [e[k] for e in out["ref"][0]["traceEvents"]]
    assert sorted(out["port"][1][0]) == sorted(out["ref"][1][0])


def test_concurrent_dump_while_recording_is_consistent(rtr, tmp_path):
    with _armed((telemetry, tracing)):
        tracing.set_max_spans(2000)
        stop = threading.Event()
        errs = []

        def writer():
            i = 0
            try:
                while not stop.is_set():
                    with tracing.span("w", i=i):
                        pass
                    i += 1
            except Exception as e:        # the race under test
                errs.append(e)
        th = threading.Thread(target=writer, daemon=True)
        th.start()
        try:
            for k in range(10):
                path = tmp_path / f"fr{k}.ndjson"
                tracing.dump_flight_recorder(str(path), reason="race")
                lines = [json.loads(ln) for ln in path.read_text().splitlines()]
                assert lines[0]["entries"] == len(lines) - 1
        finally:
            stop.set()
            th.join(5)
            tracing.set_max_spans(100_000)
        assert errs == []


def test_reset_clears_ring_and_statusz_over_http(rtr):
    port = telemetry.start_http_server(0)
    with _armed((telemetry, tracing)):
        tracing.event("x")
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/statusz", timeout=30) as r:
            st = json.loads(r.read())
        assert st["telemetry_enabled"] is True and st["tracing_enabled"] is True
        assert [e["name"] for e in st["recorder_events"]] == ["x"]
        telemetry.reset()
        assert tracing.spans() == []
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz", timeout=30) as r:
        assert json.loads(r.read())["status"] == "ok"


# -- the watchdog ------------------------------------------------------------------------

def _anomalies(t, kind):
    fam = t.get_metric("mx_anomalies_total")
    return fam.get(kind) if fam is not None else 0.0


def test_watchdog_matches_reference(rtr):
    def run(tl, t):
        tl.watch_step_time(5.0, source="w")          # a capture step, in the warm-up
        for _ in range(15):
            tl.watch_step_time(0.01, source="t")
        tl.watch_step_time(0.2, source="t")          # 20x the EWMA
        tl.check_loss(1.25, source="drain")
        tl.check_loss(float("nan"), source="drain")
        tl.check_loss(float("inf"), source="drain")
    got, want = _both(rtr, run)
    assert [(e[1], e[5].get("kind")) for e in got] == \
        [(e[1], e[5].get("kind")) for e in want] == [
            ("mx.anomaly.step_time_regression", "step_time_regression"),
            ("mx.anomaly.nonfinite_loss", "nonfinite_loss"),
            ("mx.anomaly.nonfinite_loss", "nonfinite_loss")]
    for kind, n in (("step_time_regression", 1), ("nonfinite_loss", 2)):
        assert _anomalies(telemetry, kind) == _anomalies(rtr[0], kind) == n


def _trainer():
    from mxnet_tpu_torch.parallel import DataParallelTrainer, make_mesh
    mt.random.seed(7)
    net = mt.gluon.nn.HybridSequential()
    net.add(mt.gluon.nn.Dense(16, activation="relu", in_units=8),
            mt.gluon.nn.Dense(4, in_units=16))
    net.initialize(ctx=mt.cpu())

    def loss(logits, labels):
        return torch.logsumexp(logits, -1) - logits.gather(-1, labels.long()[:, None])[:, 0]
    return DataParallelTrainer(net, loss, optimizer="sgd",
                               optimizer_params={"learning_rate": 0.01},
                               mesh=make_mesh({"dp": 1}, devices=[mt.cpu()]))


def test_pending_scalar_read_feeds_the_loss_watchdog(rtr):
    tr = _trainer()
    x = np.full((8, 8), np.nan, np.float32)
    y = np.zeros((8,), np.int32)
    with _armed((telemetry, tracing)):
        v = float(tr.step(x, y))
        tr.drain()
    assert not np.isfinite(v)
    assert _anomalies(telemetry, "nonfinite_loss") >= 1


# -- the hooks ---------------------------------------------------------------------------

def test_faults_and_io_retry_match_reference(rtr):
    from mxnet_tpu import faults as rfaults
    from mxnet_tpu_torch import faults

    def run(tl, t):
        pkg = faults if tl is tracing else rfaults
        with pkg.injected("elastic.read", "first_k:1"):
            with pytest.raises(pkg.FaultInjected):
                pkg.check("elastic.read")
        calls = {"n": 0}

        def flaky():
            calls["n"] += 1
            if calls["n"] < 3:
                raise OSError("transient")
            return "ok"
        assert pkg.io_retry("elastic.write_shard", flaky, backoff=0.0) == "ok"
        with pkg.injected("elastic.commit", "first_k:1"):
            assert pkg.io_retry("elastic.commit", lambda: 1, backoff=0.0) == 1
    got, want = _both(rtr, run)
    key = [(e[0], e[1], {k: v for k, v in e[5].items() if k != "error"}) for e in got]
    assert key == [(e[0], e[1], {k: v for k, v in e[5].items() if k != "error"})
                   for e in want]
    attempts = [e for e in got if e[1] == "mx.io.elastic.write_shard"]
    assert [a[5]["status"] for a in attempts] == ["error", "error", "ok"]
    for name in ("mx_faults_injected_total", "mx_io_retries_total"):
        for point in ("elastic.read", "elastic.write_shard", "elastic.commit"):
            fam, rfam = telemetry.get_metric(name), rtr[0].get_metric(name)
            assert fam.get(point) == rfam.get(point), (name, point)


class _Feed:
    def __init__(self, n=64):
        self.n = n

    def __iter__(self):
        rs = np.random.RandomState(0)
        x = rs.uniform(-1, 1, (8, 8)).astype(np.float32)
        y = rs.randint(0, 4, (8,)).astype(np.int32)
        return iter([(x, y)] * self.n)

    def reset(self):
        pass


def test_sigterm_kill_dumps_flight_recorder(rtr, tmp_path, monkeypatch):
    from mxnet_tpu_torch import elastic
    fr = tmp_path / "black_box.ndjson"
    monkeypatch.setenv("MXNET_TPU_FLIGHT_RECORDER", str(fr))
    tr = _trainer()

    def kill_at_3(step, loss):
        if step == 3:
            os.kill(os.getpid(), signal.SIGTERM)
    with _armed((telemetry, tracing)):
        out = elastic.run(tr, _Feed(), num_steps=10, directory=str(tmp_path / "ck"),
                          save_every=100, on_step=kill_at_3)
        assert out["preempted"] and out["step"] == 3
    lines = [json.loads(ln) for ln in fr.read_text().splitlines()]
    meta, entries = lines[0], lines[1:]
    assert meta["reason"] == "preemption" and meta["entries"] == len(entries)
    assert {e["attrs"]["step"] for e in entries if e["name"] == "mx.dp.step"} == {1, 2, 3}
    assert any(e["name"] == "mx.preemption" for e in entries)
    names = {e["name"] for e in tracing.spans()}
    assert {"mx.elastic.snapshot_write", "mx.elastic.commit"} <= names
    assert telemetry.get_metric("mx_checkpoint_bytes_total").get("elastic") > 0


def test_elastic_run_step_exception_hook(rtr, tmp_path, monkeypatch):
    from mxnet_tpu_torch import elastic
    fr = tmp_path / "hook.ndjson"
    monkeypatch.setenv("MXNET_TPU_FLIGHT_RECORDER", str(fr))
    tr = _trainer()
    tr.step(*next(iter(_Feed())))
    orig, n = tr.step, {"n": 0}

    def bad_step(x, y):
        n["n"] += 1
        if n["n"] >= 2:
            raise RuntimeError("device fell over")
        return orig(x, y)
    tr.step = bad_step
    with _armed((telemetry, tracing)):
        with pytest.raises(RuntimeError):
            elastic.run(tr, _Feed(), num_steps=10, directory=str(tmp_path / "ck"),
                        save_every=100)
    assert json.loads(fr.read_text().splitlines()[0])["reason"] == "step_exception"


def test_feed_and_window_spans(rtr):
    from mxnet_tpu_torch.engine.async_feed import DeviceFeed, DispatchWindow
    rs = np.random.RandomState(1)
    src = [(rs.randn(2, 3).astype(np.float32), i) for i in range(4)]
    with _armed((telemetry, tracing)):
        feed = DeviceFeed(src, device=mt.cpu(), name="spantest")
        assert len(list(feed)) == 4
        feed.close()
        w = DispatchWindow(depth=1, name="spantest")
        for i in range(3):
            w.admit(torch.tensor(float(i)))
        w.drain()
    names = [e["name"] for e in tracing.spans()]
    assert names.count("mx.feed.produce") == names.count("mx.feed.put") == 4
    assert names.count("mx.window.admit") == 2 and names.count("mx.window.drain") == 1
    produce = [e for e in tracing.spans() if e["name"] == "mx.feed.produce"]
    assert len({e["trace_id"] for e in produce}) == 1        # one root a producer
