"""The port's telemetry registry and its hooks against the reference's.

Following the cases of ``tests/test_telemetry.py``, each runs
``mxnet_tpu.telemetry`` and the port's ``telemetry`` on the same calls:

- the registry: counters, gauges and histograms with labels, label
  validation, the cardinality cap, Prometheus text (every line parses),
  ``scrape_json``/``collect``, ``report``, the HTTP endpoint (``/metrics``,
  ``/metrics.json``, ``/statusz``, ``/healthz``), hostile label values and
  docs escaped, the disabled path recording nothing, nested comm scopes
  counting once, ``record_step``'s explicit values, the trailing ``host``
  label of a multi-process job, ``record_dispatch_wait`` set-style;
- the same sequence of every ``record_*`` call into both packages gives
  equal ``scrape_json()``, exactly (one process: no host label; the peaks
  set by the environment's override in both). The ``mx_compilation_*``
  mirrors of each engine's counters are left out: the two engines count
  different things (XLA compiles, CUDA-graph captures);
- the peaks: the override, the H100 row of the device table (989e12 FLOP/s,
  3.35e12 B/s, NVIDIA's datasheet), the CPU anchors (1e12, 50e9);
- the hooks: a small BERT's fused steps with telemetry on give the
  reference's metric families (less the ones the port does not keep: the
  roofline's, XLA's cost-capture and donation counters) with the same label
  sets, step and example counts; on 2 gloo ranks the data-parallel step's
  comm bytes (the all-reduce, and ZeRO's reduce-scatter and all-gather)
  equal the reference's on 2 CPU devices; the kvstore's push, pull and
  pushpull bytes; ``gluon.Trainer``'s steps and the bytes its updates
  write in place (``mx_donation_saved_bytes_total``);
- the FLOP count: the port counts a signature's FLOPs once with
  ``FlopCounterMode`` (matrix products only), the reference takes XLA's cost
  model (elementwise work too: softmax, layer norm, GELU, the optimizer).
  Below ``MXNET_FLASH_ATTENTION_MIN_SEQ`` both take the plain attention, and
  the port's count of a step lies between 0.6 and 1.0 of the reference's
  ``flops_executed`` delta (measured 0.751 on this BERT), and equals six
  times the tokens times the dense layers' weights plus the attention's
  six products a layer, exactly. A hybridized block books its own calls:
  the forward at each, the backward (counted once: on the CPU by
  ``engine.count_backward``, on the card at the capture of the pair's
  backward graph) when it runs; a Dense stack's backward is its three
  products, not twice the forward, and a hybridized BERT's forward and
  backward lie between 0.6 and 1.0 of the reference's hybridized BERT's
  (measured 0.752 and 0.836). K1-K3's formulas equal
  ``FlopCounterMode``'s count of the plain attention's products: K1 the
  forward's two, K2 + K3 the backward's four plus the three it recomputes;
- ``trace_steps(n)`` writes a Chrome trace and stops itself after n steps;
  ``sample_memory`` does nothing without CUDA.
"""
import json
import pathlib
import re
import sys
import urllib.request

import numpy as np
import pytest
import torch

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import _dist_util
from mxnet_tpu_torch import telemetry as telem
from torch_threads import one_torch_thread  # noqa: F401

MODULE = "test_torch_telemetry"
TESTS_DIR = str(pathlib.Path(__file__).resolve().parent)
_PROM_LINE = re.compile(
    r'^[a-zA-Z_:][a-zA-Z0-9_:]*(\{[a-zA-Z0-9_]+="[^"]*"'
    r'(,[a-zA-Z0-9_+]+="[^"]*")*\})? [-+]?[0-9.eE+-]+(inf|nan)?$')
BERT = dict(vocab_size=256, num_layers=2, units=32, hidden_size=64, num_heads=2,
            max_length=64)


@pytest.fixture
def rt():
    """The reference's telemetry, fresh; the port's too."""
    from mxnet_tpu import telemetry as rtelem
    for t in (telem, rtelem):
        t.reset()
        t.disable()
    yield rtelem
    for t in (telem, rtelem):
        t.stop_http_server()
        t.reset()
        t.disable()


def _registry(t, drop=("mx_compilation_", "mx_device_")):
    d = json.loads(t.scrape_json())
    return {k: v for k, v in d.items() if not k.startswith(drop)}


# -- the registry --------------------------------------------------------------------

def test_counter_gauge_histogram_basics(rt):
    for t in (telem, rt):
        c = t.counter("mx_t_total", "doc", ("op",))
        c.labels("x").inc()
        c.labels(op="x").inc(2)
        t.gauge("mx_g", "doc").set(3.5)
        t.gauge("mx_g", "doc").set_max(2.0)
        h = t.histogram("mx_h", "doc", buckets=(0.1, 1.0))
        for v in (0.05, 0.5, 5.0):
            h.observe(v)
    assert telem.get_metric("mx_t_total").get("x") == 3
    assert telem.get_metric("mx_g").get() == 3.5
    assert _registry(telem) == _registry(rt)
    with pytest.raises(mt.MXNetError):
        telem.counter("mx_t_total").inc(-1)
    with pytest.raises(mt.MXNetError):
        telem.gauge("mx_t_total")


def test_label_validation_and_cardinality_cap(rt):
    for t in (telem, rt):
        c = t.counter("mx_lv_total", "doc", ("a", "b"))
        with pytest.raises(Exception):
            c.labels("only-one")
        with pytest.raises(Exception):
            c.labels(a="x")
        capped = t.counter("mx_cap_total", "doc", ("k",), max_series=3)
        for i in range(10):
            capped.labels(str(i)).inc()
    assert telem.get_metric("mx_cap_total").dropped == rt.get_metric("mx_cap_total").dropped \
        == 7
    assert _registry(telem) == _registry(rt)


def test_scrape_is_parseable_prometheus_text(rt):
    telem.counter("mx_a_total", "a counter", ("op",)).labels("x").inc(2)
    telem.gauge("mx_b", "a gauge").set(1.5)
    telem.histogram("mx_c", "a histogram", buckets=(0.1, 1.0)).observe(0.5)
    text = telem.scrape()
    assert text.endswith("\n")
    for line in text.strip().splitlines():
        if line.startswith("#"):
            assert line.startswith(("# HELP ", "# TYPE "))
        else:
            assert _PROM_LINE.match(line), line
    assert 'mx_c_bucket{le="+Inf"} 1' in text
    assert "mx_c_sum 0.5" in text and "mx_c_count 1" in text
    assert "mx_compilation_captures" in text      # the engine's counters mirrored


def test_scrape_json_report_and_http(rt):
    telem.counter("mx_j_total", "doc").inc(4)
    assert json.loads(telem.scrape_json())["mx_j_total"]["series"][0]["value"] == 4
    rep = telem.report()
    assert "=== telemetry ===" in rep and "=== engine (engine.cache_stats) ===" in rep
    assert "mx_j_total" in rep
    port = telem.start_http_server(0)
    url = f"http://127.0.0.1:{port}"
    body = urllib.request.urlopen(f"{url}/metrics", timeout=5).read().decode()
    assert "mx_j_total 4" in body
    js = json.loads(urllib.request.urlopen(f"{url}/metrics.json", timeout=5).read())
    assert js["mx_j_total"]["series"][0]["value"] == 4
    st = json.loads(urllib.request.urlopen(f"{url}/statusz", timeout=5).read())
    assert st["telemetry_enabled"] is False and "compilation" in st
    assert json.loads(urllib.request.urlopen(f"{url}/healthz", timeout=5).read()) == \
        {"status": "ok"}
    telem.stop_http_server()


def test_scrape_escapes_hostile_labels_and_docs(rt):
    for t in (telem, rt):
        t.counter("mx_hostile_total", "doc", ("k",)).labels('a"b\\c\nd').inc()
        t.counter("mx_hostile_help_total", 'line1\nline2 "q" \\b').inc()
    text = telem.scrape()
    lines = [ln for ln in text.splitlines() if ln.startswith("mx_hostile_total{")]
    assert len(lines) == 1 and lines[0].endswith(" 1.0")
    assert '\\"' in lines[0] and "\\\\" in lines[0] and "\\n" in lines[0]
    helps = [ln for ln in text.splitlines() if ln.startswith("# HELP mx_hostile_help_total ")]
    assert len(helps) == 1 and "\\n" in helps[0]
    ref_text = rt.scrape()
    for ln in text.splitlines():
        if ln.startswith(("mx_hostile", "# HELP mx_hostile")):
            assert ln in ref_text, ln


def test_disabled_instrumentation_records_nothing(rt):
    assert not telem.is_enabled()
    kv = mt.kv.create("local")
    kv.init(0, mt.nd.array(np.ones((4, 4), "float32"), ctx=mt.cpu()))
    kv.push(0, mt.nd.array(np.ones((4, 4), "float32"), ctx=mt.cpu()))
    assert telem.get_metric("mx_comm_bytes_total") is None
    assert telem.get_metric("mx_train_steps_total") is None


def test_comm_bytes_and_reentrancy(rt):
    import mxnet_tpu as mx
    telem.enable()
    rt.enable()
    kv, rkv = mt.kv.create("local"), mx.kv.create("local")
    kv.init(0, mt.nd.array(np.ones((4, 4), "float32"), ctx=mt.cpu()))
    rkv.init(0, mx.nd.ones((4, 4)))
    kv.push(0, mt.nd.array(np.ones((4, 4), "float32"), ctx=mt.cpu()))
    rkv.push(0, mx.nd.ones((4, 4)))
    out = mt.nd.array(np.zeros((4, 4), "float32"), ctx=mt.cpu())
    kv.pull(0, out=out)
    rkv.pull(0, out=mx.nd.zeros((4, 4)))
    kv.pushpull(0, mt.nd.array(np.ones((4, 4), "float32"), ctx=mt.cpu()), out=out)
    rkv.pushpull(0, mx.nd.ones((4, 4)), out=mx.nd.zeros((4, 4)))
    for t in (telem, rt):
        with t.comm_scope("outer", 100):
            with t.comm_scope("inner", 50):
                pass
    for op in ("push", "pull", "pushpull"):
        for name in ("mx_comm_bytes_total", "mx_comm_calls_total"):
            assert telem.get_metric(name).get(op, "local") == \
                rt.get_metric(name).get(op, "local"), (op, name)
    fam = telem.get_metric("mx_comm_bytes_total")
    assert fam.get("push", "local") == 64
    assert fam.get("outer", "") == 100 and fam.get("inner", "") == 0


def test_record_step_explicit_values_and_peaks(rt, monkeypatch):
    for t in (telem, rt):
        t.enable()
        t.record_step(32, source="unit", seconds=0.5, flops_per_step=1e9, lr=0.1)
    assert telem.get_metric("mx_train_examples_per_second").get("unit") == 64
    assert telem.get_metric("mx_mfu").get("unit") == pytest.approx(2e9 / 1e12)
    assert telem.peak_flops() == 1e12 and telem.peak_bytes_per_second() == 50e9
    assert telem.ridge_point() == 20.0
    assert _registry(telem) == _registry(rt)
    monkeypatch.setenv("MXNET_TELEMETRY_PEAK_FLOPS", "123.0")
    monkeypatch.setenv("MXNET_TELEMETRY_PEAK_BYTES", "4.0")
    assert telem.peak_flops() == rt.peak_flops() == 123.0
    assert telem.peak_bytes_per_second() == rt.peak_bytes_per_second() == 4.0


def test_peak_table_holds_the_h100(monkeypatch):
    monkeypatch.setattr(telem, "_device_kind", lambda: "nvidia h100 80gb hbm3")
    monkeypatch.setattr(telem, "_peak_cache", [None])
    monkeypatch.setattr(telem, "_peak_bw_cache", [None])
    assert telem.peak_flops() == 989e12
    assert telem.peak_bytes_per_second() == 3.35e12


def _every_record(t):
    """One call of every record_* function, with explicit values."""
    t.record_step(16, source="a", seconds=0.25, flops_per_step=2e9, lr=0.01)
    t.record_step(16, source="a", seconds=0.5, flops_per_step=2e9, steps=2)
    t.record_comm("allreduce", 4096, store="mesh", calls=2, axis="dp")
    t.record_comm("reduce_scatter", 1000, store="mesh", overlapped=True, axis="dp",
                  seconds=0.01)
    t.record_optimizer_state(12345, source="data_parallel")
    t.record_feed_depth(2, source="feed")
    t.record_feed_stall(0.125, source="feed")
    t.record_inflight(1, source="dp")
    t.record_dispatch_wait(0.5, source="dp")
    t.record_checkpoint_save(1.5, 2048)
    t.record_resume("resumed")
    t.record_resume("fresh")
    t.record_moe_dropped(7)
    t.record_serving_enqueue("m", rows=3)
    t.record_serving_queue_depth("m", 4)
    t.record_serving_queue_wait("m", 0.003)
    t.record_serving_dispatch("m", 8, 5)
    t.record_serving_completion("m", 0.02, rows=3)
    t.record_request_shed("m", "deadline")
    t.record_fault_injected("elastic.read")
    t.record_io_retry("elastic.read")
    t.record_feed_producer_leak("feed")
    t.record_feed_producer_restart("feed")
    t.record_hosts_live(3, 7)
    t.record_commit_barrier(0.2)
    t.record_hang_watchdog("drain")
    t.set_epoch(2)
    t.gauge("mx_x", "doc").set(t.comm_overlap_ratio() + t.comm_axis_bytes("dp"))


def test_every_record_call_matches_the_reference_exactly(rt, monkeypatch):
    monkeypatch.setenv("MXNET_TELEMETRY_PEAK_FLOPS", "1e13")
    monkeypatch.setenv("MXNET_TELEMETRY_PEAK_BYTES", "1e11")
    for t in (telem, rt):
        t.enable()
        _every_record(t)
    got, want = _registry(telem), _registry(rt)
    assert set(got) == set(want)
    for name in want:
        assert got[name] == want[name], name
    assert telem.comm_overlap_ratio() == rt.comm_overlap_ratio() == 1000 / 5096
    assert telem.comm_overlap_ratio(axis="dp") == rt.comm_overlap_ratio(axis="dp")
    assert telem.comm_axis_bytes("dp", overlapped=False) == 4096


def test_host_label_trails_and_aggregates(rt):
    assert telem._host_label() == ""
    telem._HOST_LABEL[0] = "3"
    telem.record_step(8, source="t", seconds=0.01)
    telem.record_comm("allreduce", 2048, store="mesh", axis="dp")
    telem.record_checkpoint_save(0.5, 100)
    text = telem.scrape()
    assert ('mx_comm_bytes_total{op="allreduce",store="mesh",'
            'overlap="0",axis="dp",host="3"} 2048') in text
    assert 'mx_step_seconds_count{source="t",host="3"} 1' in text
    assert 'mx_checkpoint_save_seconds{source="elastic",host="3"} 0.5' in text
    assert telem.get_metric("mx_comm_bytes_total").get("allreduce", "mesh") == 2048
    assert telem.comm_axis_bytes("dp") == 2048


def test_record_dispatch_wait_is_set_style(rt):
    telem.record_dispatch_wait(1.5, source="step")
    telem.record_dispatch_wait(2.25, source="step")
    assert telem.get_metric("mx_dispatch_wait_seconds_total").get("step") == 2.25


def test_statusz_view(rt, monkeypatch):
    from mxnet_tpu_torch import faults
    monkeypatch.setenv("MXNET_TPU_INFLIGHT_STEPS", "3")
    telem.enable()
    telem.record_inflight(2, source="dp")
    with faults.injected("elastic.read", "first_k:1"):
        st = telem.statusz(extra={"who": "test"})
    keys = set(rt.statusz()) - {"hlo_audit", "goodput"}
    assert keys <= set(st)
    assert st["config"]["MXNET_TPU_INFLIGHT_STEPS"] == 3
    assert st["inflight_steps"] == {"dp": 2.0}
    assert st["faults"]["armed"] == {"elastic.read": "first_k:1"}
    assert st["who"] == "test" and st["telemetry_enabled"] is True


# -- the hooks -------------------------------------------------------------------------

def _bert_pair(seed=3):
    import mxnet_tpu as mx
    from mxnet_tpu.models.bert import BertModel as RefBert
    from mxnet_tpu_torch.convert import load_jax_params, seeded_params
    from mxnet_tpu_torch.models import BertModel
    weights = seeded_params(BertModel(**BERT), seed=seed)
    port = BertModel(**BERT)
    port.initialize(ctx=mt.cpu())
    load_jax_params(port, weights)
    refnet = RefBert(**BERT)
    refnet.initialize(ctx=mx.cpu())
    for key, p in refnet._collect_params_with_prefix().items():
        p.set_data(mx.nd.array(weights[key], ctx=mx.cpu()))
    return port, refnet


def _bert_batch(B=2, T=32):
    rs = np.random.RandomState(12)
    return (rs.randint(0, 256, size=(B, T)).astype(np.int32),
            rs.randint(0, 256, size=(B, T)).astype(np.int32))


# the reference's families the port does not keep: XLA's cost model and
# buffer donation, the roofline ledger's gauges
_REF_ONLY = ("mx_compilation_", "mx_device_", "mx_roofline", "mx_cost_", "mx_donation",
             "mx_region", "mx_hlo")


def test_data_parallel_step_hooks_match_reference(rt):
    import mxnet_tpu as mx
    from mxnet_tpu.parallel import DataParallelTrainer as RefDPT, make_mesh as ref_mesh
    from mxnet_tpu_torch.parallel import DataParallelTrainer, make_mesh
    port, refnet = _bert_pair()
    x, y = _bert_batch()
    telem.enable()
    rt.enable()
    pt = DataParallelTrainer(port, mt.gluon.loss.SoftmaxCrossEntropyLoss(), "adam",
                             {"learning_rate": 1e-3},
                             mesh=make_mesh({"dp": 1}, devices=[mt.cpu()]))
    rtr = RefDPT(refnet, mx.gluon.loss.SoftmaxCrossEntropyLoss(), "adam",
                 {"learning_rate": 1e-3}, mesh=ref_mesh({"dp": 1}))
    xp, yp = mt.nd.array(x, ctx=mt.cpu()), mt.nd.array(y, ctx=mt.cpu(), dtype="int32")
    for _ in range(3):
        pt.step(xp, yp)
        rtr.step(mx.nd.array(x), mx.nd.array(y, dtype="int32"))
    pt.run_steps(xp, yp, 2)
    rtr.run_steps(mx.nd.array(x), mx.nd.array(y, dtype="int32"), 2)
    pt.drain()
    rtr.drain()
    got, want = _registry(telem), _registry(rt, drop=_REF_ONLY)
    assert set(got) == set(want)
    for name, fam in want.items():
        assert [s["labels"] for s in got[name]["series"]] == \
            [s["labels"] for s in fam["series"]], name
        assert got[name]["type"] == fam["type"], name
    for name in ("mx_train_steps_total", "mx_train_examples_total"):
        assert telem.get_metric(name).get("data_parallel") == \
            rt.get_metric(name).get("data_parallel")
    assert telem.get_metric("mx_train_steps_total").get("data_parallel") == 4
    assert telem.get_metric("mx_train_examples_total").get("data_parallel") == 2 + 2 * 2 + 2
    assert telem.get_metric("mx_inflight_steps").get("dp") == 0
    assert telem.get_metric("mx_mfu").get("data_parallel") > 0


def rank_comm(zero):
    """One of 2 ranks: 3 BERT steps at dp 2 with telemetry on -> the comm
    series (op, store, overlap, axis, host) and their bytes and calls."""
    from mxnet_tpu_torch.models import BertModel
    from mxnet_tpu_torch.parallel import DataParallelTrainer, make_mesh
    telem.enable()
    net = BertModel(**BERT)
    net.initialize(ctx=mt.cpu())
    net(mt.nd.array(np.zeros((1, 8), np.int32), ctx=mt.cpu(), dtype="int32"))
    mesh = make_mesh({"dp": 2}, devices=[mt.cpu()])
    tr = DataParallelTrainer(net, mt.gluon.loss.SoftmaxCrossEntropyLoss(), "adam",
                             {"learning_rate": 1e-3}, mesh=mesh, zero_update=zero)
    x, y = _bert_batch(B=4)
    for _ in range(3):
        tr.step(mt.nd.array(x, ctx=mt.cpu()), mt.nd.array(y, ctx=mt.cpu(), dtype="int32"))
    tr.drain()
    out = {}
    for name in ("mx_comm_bytes_total", "mx_comm_calls_total"):
        fam = telem.get_metric(name)
        out[name] = [[list(lv), s.value] for lv, s in fam._series.items()]
    out["modules"] = sorted(m for m in sys.modules
                            if m.split(".")[0] in ("jax", "jaxlib", "mxnet_tpu"))
    return out


@pytest.mark.parametrize("zero", [False, True], ids=["allreduce", "zero"])
def test_comm_bytes_on_two_ranks_match_reference(rt, tmp_path, zero):
    import jax
    import mxnet_tpu as mx
    from mxnet_tpu.models.bert import BertModel as RefBert
    from mxnet_tpu.parallel import DataParallelTrainer as RefDPT, make_mesh as ref_mesh
    ranks = _dist_util.launch_local(f"{MODULE}:rank_comm", 2, {"zero": zero},
                                    device="cpu", timeout=180, pythonpath=[TESTS_DIR],
                                    workdir=str(tmp_path / "launch"))
    rt.enable()
    refnet = RefBert(**BERT)
    refnet.initialize(ctx=mx.cpu())
    refnet(mx.nd.array(np.zeros((1, 8), np.int32), dtype="int32"))
    rtr = RefDPT(refnet, mx.gluon.loss.SoftmaxCrossEntropyLoss(), "adam",
                 {"learning_rate": 1e-3}, zero_update=zero,
                 mesh=ref_mesh({"dp": 2}, devices=jax.devices("cpu")[:2]))
    x, y = _bert_batch(B=4)
    for _ in range(3):
        rtr.step(mx.nd.array(x), mx.nd.array(y, dtype="int32"))
    rtr.drain()
    for name in ("mx_comm_bytes_total", "mx_comm_calls_total"):
        want = {tuple(lv): s.value for lv, s in rt.get_metric(name)._series.items()}
        assert want
        for r, rank in enumerate(ranks):
            assert rank["modules"] == []
            got = {tuple(lv[:4]): v for lv, v in rank[name]}
            assert all(lv[4] == str(r) for lv, _ in rank[name])    # the trailing host
            assert got == want, (name, r)


def test_gluon_trainer_records_steps(rt):
    telem.enable()
    net = mt.gluon.nn.Dense(8, in_units=4)
    net.initialize(ctx=mt.cpu())
    x = mt.nd.array(np.random.RandomState(0).uniform(-1, 1, (16, 4)).astype(np.float32),
                    ctx=mt.cpu())
    y = mt.nd.array(np.zeros(16, np.float32), ctx=mt.cpu())
    loss_fn = mt.gluon.loss.SoftmaxCrossEntropyLoss()
    trainer = mt.gluon.Trainer(net.collect_params(), "sgd", {"learning_rate": 0.01})
    for _ in range(4):
        with mt.autograd.record():
            loss = loss_fn(net(x), y).mean()
        loss.backward()
        trainer.step(16)
    assert telem.get_metric("mx_train_steps_total").get("trainer") == 3
    assert telem.get_metric("mx_train_examples_total").get("trainer") == 48
    assert telem.get_metric("mx_learning_rate").get("trainer") == pytest.approx(0.01)
    assert telem.get_metric("mx_inflight_steps").get("trainer") <= 2
    # every update writes its weight in place (SGD keeps no state): the
    # reference's donated bytes
    assert telem.get_metric("mx_donation_saved_bytes_total").get() == 4 * (8 * 4 + 8) * 4


# -- FLOPs -----------------------------------------------------------------------------

def test_flop_count_against_reference_cost_model(rt):
    import mxnet_tpu as mx
    from mxnet_tpu import engine as rengine
    from mxnet_tpu.parallel import DataParallelTrainer as RefDPT, make_mesh as ref_mesh
    from mxnet_tpu_torch import engine
    from mxnet_tpu_torch.parallel import DataParallelTrainer, make_mesh
    port, refnet = _bert_pair()
    B, T = 2, 32
    x, y = _bert_batch(B, T)
    telem.enable()
    rt.enable()
    pt = DataParallelTrainer(port, mt.gluon.loss.SoftmaxCrossEntropyLoss(), "adam",
                             {"learning_rate": 1e-3},
                             mesh=make_mesh({"dp": 1}, devices=[mt.cpu()]))
    rtr = RefDPT(refnet, mx.gluon.loss.SoftmaxCrossEntropyLoss(), "adam",
                 {"learning_rate": 1e-3}, mesh=ref_mesh({"dp": 1}))
    xp, yp = mt.nd.array(x, ctx=mt.cpu()), mt.nd.array(y, ctx=mt.cpu(), dtype="int32")
    pt.step(xp, yp)
    rtr.step(mx.nd.array(x), mx.nd.array(y, dtype="int32"))
    f0, r0 = engine.cache_stats()["flops_executed"], rengine.cache_stats()["flops_executed"]
    for _ in range(2):
        pt.step(xp, yp)
        rtr.step(mx.nd.array(x), mx.nd.array(y, dtype="int32"))
    got = (engine.cache_stats()["flops_executed"] - f0) / 2
    want = (rengine.cache_stats()["flops_executed"] - r0) / 2
    assert 0.6 * want <= got <= 1.0 * want, (got, want)
    # the port's count, exactly: 6 x tokens x the dense layers' weights
    # (qkv, proj, ffn1, ffn2 a layer, the MLM dense and decoder) plus the
    # attention's six products a layer (QK^T and PV forward, four backward)
    L, U, H, V = BERT["num_layers"], BERT["units"], BERT["hidden_size"], BERT["vocab_size"]
    dense = L * (4 * U * U + 2 * U * H) + U * U + V * U
    assert got == 6 * B * T * dense + L * 12 * B * T * T * U
    assert list(pt._flops.values()) == [got]


def _booked(eng, fn):
    """What ``fn()`` added to an engine's ``flops_executed``."""
    f0 = eng.cache_stats()["flops_executed"]
    out = fn()
    return out, eng.cache_stats()["flops_executed"] - f0


def _dense_stack(ctx):
    net = mt.gluon.nn.HybridSequential()
    net.add(mt.gluon.nn.Dense(16, in_units=8, activation="relu"),
            mt.gluon.nn.Dense(4, in_units=16))
    net.initialize(ctx=ctx)
    for i, p in enumerate(net.collect_params().values()):
        p.set_data(mt.nd.array(np.random.RandomState(i).randn(*p.shape).astype(np.float32),
                               ctx=ctx))
    net.hybridize()
    return net


def test_hybridized_block_books_its_forward_and_backward(rt):
    """A hybridized block's calls book their own counts: on the CPU (the
    eager path, telemetry on) the forward's at each call and the backward's,
    counted once by ``engine.count_backward``, when the backward runs. A
    Dense stack whose input needs no gradient: the forward's two products,
    the backward's three (no input gradient for the first layer), not twice
    the forward. BERT against the reference's hybridized BERT: the forward
    and the backward each between 0.6 and 1.0 of the reference's
    ``flops_executed`` delta (XLA counts elementwise work too; measured
    0.752 and 0.836), their sum the DataParallelTrainer step's formula."""
    import mxnet_tpu as mx
    from mxnet_tpu import engine as rengine
    from mxnet_tpu_torch import engine
    telem.enable()
    rt.enable()
    net = _dense_stack(mt.cpu())
    x = mt.nd.array(np.random.RandomState(9).randn(5, 8).astype(np.float32), ctx=mt.cpu())
    fwd = 2 * 5 * (8 * 16 + 16 * 4)
    for _ in range(3):
        with mt.autograd.record():
            loss, f = _booked(engine, lambda: (net(x) ** 2).sum())
        _, b = _booked(engine, loss.backward)
        assert (f, b) == (fwd, fwd + 2 * 5 * 16 * 4)

    port, refnet = _bert_pair()
    port.hybridize()
    refnet.hybridize()
    x, _ = _bert_batch()
    booked = {}
    for name, net, nd, ag, eng in (
            ("port", port, lambda a: mt.nd.array(a, ctx=mt.cpu(), dtype="int32"),
             mt.autograd, engine),
            ("ref", refnet, lambda a: mx.nd.array(a, dtype="int32"), mx.autograd, rengine)):
        for _ in range(2):            # the second call's: the reference compiles at its first
            with ag.record():
                out, f = _booked(eng, lambda: net(nd(x)))
                out = out[0] if isinstance(out, (tuple, list)) else out
                loss = (out * out).mean()
            _, b = _booked(eng, loss.backward)
        booked[name] = (f, b)
    (pf, pb), (rf, rb) = booked["port"], booked["ref"]
    assert 0.6 * rf <= pf <= rf and 0.6 * rb <= pb <= rb, booked
    B, T = x.shape
    L, U, H, V = BERT["num_layers"], BERT["units"], BERT["hidden_size"], BERT["vocab_size"]
    dense = L * (4 * U * U + 2 * U * H) + U * U + V * U
    assert pf + pb == 6 * B * T * dense + L * 12 * B * T * T * U


@pytest.mark.gpu
def test_hybridized_pair_books_its_captured_backward():
    """On the card the training pair's warm call books its forward and its
    backward at the reference's 2x estimate (``flops_estimated``); each
    replay books the forward and the backward graph's count taken at its
    capture, the Dense stack's three products, whatever telemetry's flag at
    the capture."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run on the card")
    from mxnet_tpu_torch import engine
    torch.backends.cuda.matmul.allow_tf32 = False
    gpu = mt.gpu(0)
    net = _dense_stack(gpu)
    x = mt.nd.array(np.random.RandomState(9).randn(5, 8).astype(np.float32), ctx=gpu)
    fwd = 2 * 5 * (8 * 16 + 16 * 4)
    booked = []
    for _ in range(4):
        e0 = engine.cache_stats()["flops_estimated"]
        with mt.autograd.record():
            loss, f = _booked(engine, lambda: (net(x) ** 2).sum())
        _, b = _booked(engine, loss.backward)
        booked.append((f, b, engine.cache_stats()["flops_estimated"] - e0))
    torch.cuda.synchronize()
    assert booked[0] == (fwd, 2 * fwd, 2 * fwd)
    assert booked[1:] == [(fwd, fwd + 2 * 5 * 16 * 4, 0.0)] * 3
    entry = next(e for e in net._cached_graphs.values() if e.pair is not None)
    assert entry.pair.slots and entry.eager is None


@pytest.mark.parametrize("causal", [False, True])
def test_kernel_formulas_against_flop_counter(causal):
    """K1's formula equals FlopCounterMode's count of the plain forward's
    two products; K2 + K3's equal the plain backward's four products plus
    the three the kernels recompute (S twice, dP once), without the mask;
    under the mask the kernels keep T(T+1)/2 of the T^2 pairs."""
    from torch.utils.flop_counter import FlopCounterMode
    from mxnet_tpu_torch import engine
    from mxnet_tpu_torch.ops.cuda.flash_attention import attention_grads_plain
    BH, T, D = 6, 40, 16
    rs = np.random.RandomState(1)
    q, k, v, do = (torch.from_numpy(rs.randn(BH, T, D).astype(np.float32))
                   for _ in range(4))
    with FlopCounterMode(display=False) as fc:
        p = torch.softmax(q @ k.transpose(-1, -2), -1)
        p @ v
    fwd = fc.get_total_flops()
    with FlopCounterMode(display=False) as fc:
        attention_grads_plain(q, k, v, do, False, 0.25)
    grads = fc.get_total_flops()          # S, O (recomputed), dP, dQ, dK, dV: 6 products
    per = 2 * BH * T * T * D              # one product
    assert fwd == 2 * per and grads == 6 * per
    f = {kind: engine.attention_flops(kind, BH, T, T, D, causal) for kind in ("fwd", "dq", "dkv")}
    scale = (T * (T + 1) / 2) / (T * T) if causal else 1.0
    assert f["fwd"] == pytest.approx(fwd * scale)
    assert f["dq"] + f["dkv"] == pytest.approx((4 * per + 3 * per) * scale)
    assert engine.attention_flops("fwd", 96, 1024, 1024, 64, False) == pytest.approx(25.77e9,
                                                                                       rel=1e-3)


# -- traces and memory ------------------------------------------------------------------

def test_trace_steps_writes_a_chrome_trace(rt, tmp_path):
    telem.enable()
    d = telem.trace_steps(2, logdir=str(tmp_path / "tr"))
    assert telem.trace_active() == d
    with pytest.raises(mt.MXNetError):
        telem.trace_steps(1)
    for i in range(3):
        with telem.annotate("mx.unit.step"):
            torch.ones(8) @ torch.ones(8)
        telem.record_step(4, source="unit", seconds=0.01)
    assert telem.trace_active() is None
    trace = json.loads((tmp_path / "tr" / "trace.json").read_text())
    names = [e.get("name") for e in trace["traceEvents"]]
    assert names.count("mx.unit.step") == 2
    assert telem.statusz()["device_trace_active"] is None


def test_sample_memory_needs_cuda(rt):
    telem.enable()
    telem.sample_memory()
    assert telem.get_metric("mx_device_live_bytes") is None
