"""The port's async feed (``engine/async_feed.py``) against the reference's.

Each case runs ``mxnet_tpu.engine.async_feed`` and the port's on the same
numpy inputs (made from a seed) and compares what comes out, following the
cases of ``tests/test_async_feed.py``:

- ``DeviceFeed``: order and values, a second epoch after ``reset()``, a
  mid-epoch reset, ``StopIteration`` then reset, a shuffled stream (the
  wrapper draws nothing: the reference's bare iterator under the same
  ``np.random`` seed gives the same batches), tuple and raw-array sources
  (Python scalars pass through), a producer exception at ``next()``, the
  producer thread joined on reset and close, restarts under a
  ``feed.produce`` fault schedule (the batches delivered once each, in
  order, as many restarts in both packages), and ``state_dict`` /
  ``load_state_dict`` (the rest of the epoch replayed after a rewind):
  values exact, since a feed copies and never computes;
- ``DispatchWindow``: its bound (at most ``depth`` in flight, the same
  ``retired`` and ``max_inflight`` as the reference's for the same
  admissions), depth 0 synchronous, the environment's default;
  ``PendingScalar`` reads lazily;
- a small BERT's 10 ``DataParallelTrainer`` steps fed through each
  package's ``DeviceFeed.for_trainer`` (losses within 1e-5 relative, the
  float32 tolerance of ``tests/test_torch_data_parallel.py``);
- ``recipes.long_context.make_feed``: a small ``LongContextTrainer`` fed by
  it at world 1, and on 4 gloo ranks at dp2 x sp2 (one spawn), against the
  reference's trainer fed by its own ``make_feed`` on one and on 4 CPU
  devices: each rank's batch is exactly the reference's shard of the global
  batch at the rank's (dp, sp) coordinates, the losses within 1e-5;
- ``gluon.Trainer``'s window and ``DataParallelTrainer.run_steps``' entry,
  the feed's and window's gauges, the ``DataLoader``'s ``device_feed`` (to a
  device, and to a trainer as the reference's ``trainer=`` shortcut does)
  and ``maybe_wrap``.
"""
import pathlib
import sys
import threading

import numpy as np
import pytest
import torch

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import _dist_util
from mxnet_tpu_torch.engine.async_feed import (DeviceFeed, DispatchWindow, PendingScalar,
                                               drain, maybe_wrap)
from torch_threads import one_torch_thread  # noqa: F401

MODULE = "test_torch_async_feed"
TESTS_DIR = str(pathlib.Path(__file__).resolve().parent)
TOL_LOSS = 1e-5
LC_CFG = dict(num_layers=1, units=16, hidden_size=32, num_heads=2)
LC_VOCAB, LC_B, LC_T, LC_STEPS = 64, 4, 32, 3


@pytest.fixture(scope="module")
def ref():
    import mxnet_tpu as mx
    from mxnet_tpu.engine import async_feed as rfeed
    return mx, rfeed


def _arrays(n=32, feat=3):
    rs = np.random.RandomState(7)
    return rs.randn(n, feat).astype("float32"), rs.randn(n).astype("float32")


def _iters(ref, batch=4, shuffle=False, n=32):
    """The same NDArrayIter in both packages."""
    mx, _ = ref
    x, y = _arrays(n)
    with mt.cpu():
        port = mt.io.NDArrayIter(x, y, batch_size=batch, shuffle=shuffle)
    return port, mx.io.NDArrayIter(x, y, batch_size=batch, shuffle=shuffle)


def _collect(it, n=None):
    out = []
    for b in it:
        out.append((np.array(b.data[0].asnumpy()), np.array(b.label[0].asnumpy())))
        if n is not None and len(out) == n:
            break
    return out


def _same(a, b):
    assert len(a) == len(b)
    for (ax, ay), (bx, by) in zip(a, b):
        np.testing.assert_array_equal(ax, bx)
        np.testing.assert_array_equal(ay, by)


def _feeds(ref, **kw):
    port, refit = _iters(ref, **kw)
    return DeviceFeed(port, device=mt.cpu()), ref[1].DeviceFeed(refit)


# -- DeviceFeed ----------------------------------------------------------------------

def test_feed_preserves_order_and_values(ref):
    pf, rf = _feeds(ref)
    got, want = _collect(pf), _collect(rf)
    assert len(got) == 8
    _same(got, want)
    pf.close()
    rf.close()
    pf = DeviceFeed(_iters(ref)[0], device=mt.cpu())
    assert all(isinstance(b, mt.NDArray) for b in pf.next().data)
    pf.close()


def test_feed_reset_and_second_epoch_identical(ref):
    pf, rf = _feeds(ref)
    p1, r1 = _collect(pf), _collect(rf)
    pf.reset()
    rf.reset()
    _same(_collect(pf), _collect(rf))
    _same(p1, r1)
    pf.close()
    rf.close()


def test_feed_mid_epoch_reset_restarts_from_beginning(ref):
    pf, rf = _feeds(ref)
    _same(_collect(pf, n=3), _collect(rf, n=3))
    pf.reset()
    rf.reset()
    got, want = _collect(pf), _collect(rf)
    assert len(got) == 8
    _same(got, want)
    pf.close()
    rf.close()


def test_feed_stopiteration_then_reset_reiterates(ref):
    pf, rf = _feeds(ref)
    _same(_collect(pf), _collect(rf))
    with pytest.raises(StopIteration):
        pf.next()
    with pytest.raises(StopIteration):
        rf.next()
    pf.reset()
    rf.reset()
    got = _collect(pf)
    assert len(got) == 8
    _same(got, _collect(rf))
    pf.close()
    rf.close()


def test_feed_shuffled_stream_matches_reference_same_seed(ref):
    def epochs(make):
        np.random.seed(123)
        src = make()
        out = []
        for _ in range(3):
            src.reset()
            out.append([np.array(b.data[0].asnumpy()) for b in src])
        return out

    def port():
        with mt.cpu():
            it = mt.io.NDArrayIter(np.arange(64, dtype="float32").reshape(64, 1),
                                   np.zeros(64, "float32"), batch_size=8, shuffle=True)
        return DeviceFeed(it, device=mt.cpu())

    def bare():
        return ref[0].io.NDArrayIter(np.arange(64, dtype="float32").reshape(64, 1),
                                     np.zeros(64, "float32"), batch_size=8, shuffle=True)
    got, want = epochs(port), epochs(bare)
    for eg, ew in zip(got, want):
        assert len(eg) == len(ew) == 8
        for a, b in zip(eg, ew):
            np.testing.assert_array_equal(a, b)


def test_feed_tuple_and_raw_array_sources(ref):
    rs = np.random.RandomState(3)
    data = [(rs.randn(2, 2).astype("float32"), i) for i in range(5)]
    got = list(DeviceFeed(data, device=mt.cpu()))
    want = list(ref[1].DeviceFeed(data))
    assert len(got) == len(want) == 5
    for i, ((gx, gy), (wx, wy)) in enumerate(zip(got, want)):
        assert isinstance(gx, torch.Tensor) and gy == wy == i
        np.testing.assert_array_equal(gx.numpy(), np.asarray(wx))
        assert gx.data_ptr() != torch.from_numpy(data[i][0]).data_ptr()    # a copy


def test_feed_propagates_producer_exception(ref):
    class Boom:
        def __iter__(self):
            def gen():
                yield (np.zeros((2, 2), "float32"),)
                raise RuntimeError("decode failed")
            return gen()

    for feed in (DeviceFeed(Boom(), device=mt.cpu()), ref[1].DeviceFeed(Boom())):
        feed.next()
        with pytest.raises(RuntimeError, match="decode failed"):
            feed.next()


def test_feed_threads_join_on_close_and_reset(ref):
    def live():
        return [t for t in threading.enumerate()
                if t.name == "mx-device-feed-jointest" and t.is_alive()]
    feed = DeviceFeed(_iters(ref)[0], device=mt.cpu(), name="jointest")
    feed.next()
    assert len(live()) >= 1
    for _ in range(3):
        feed.reset()
        feed.next()
    assert len(live()) == 1
    feed.close()
    assert live() == []


def test_feed_restarts_under_a_fault_schedule(ref):
    """``feed.produce`` firing every third attempt: a supervised producer
    re-opens the source and skips what it delivered, in both packages."""
    from mxnet_tpu import faults as rfaults
    from mxnet_tpu_torch import faults
    assert "feed.produce" in faults.points()
    x, y = _arrays()
    src = [(x[i:i + 4], y[i:i + 4]) for i in range(0, 32, 4)]     # re-iterable
    results = []
    for pkg, feed in ((faults, DeviceFeed(src, device=mt.cpu(), restarts=8)),
                      (rfaults, ref[1].DeviceFeed(src, restarts=8))):
        pkg.clear()
        pkg.inject("feed.produce", "every_nth:3")
        try:
            results.append(([(np.asarray(a), np.asarray(b)) for a, b in feed],
                            feed.restarts, pkg.fired("feed.produce")))
        finally:
            feed.close()
            pkg.clear()
    (got, g_restarts, g_fired), (want, w_restarts, w_fired) = results
    assert len(got) == 8
    _same(got, want)
    _same(got, src)
    assert g_restarts == w_restarts == g_fired == w_fired == 4


def test_feed_state_dict_rewinds(ref):
    pf, rf = _feeds(ref)
    _same(_collect(pf, n=3), _collect(rf, n=3))
    ps, rs = pf.state_dict(), rf.state_dict()
    assert {k: ps[k] for k in ("epoch", "cursor", "delivered")} == \
        {k: rs[k] for k in ("epoch", "cursor", "delivered")} == \
        {"epoch": 0, "cursor": 3, "delivered": 3}
    rest_p, rest_r = _collect(pf), _collect(rf)
    pf2, rf2 = _feeds(ref)
    pf2.load_state_dict(ps)
    rf2.load_state_dict(rs)
    _same(_collect(pf2), rest_p)
    _same(rest_p, rest_r)
    for f in (pf, rf, pf2, rf2):
        f.close()


# -- the window and lazy scalars -------------------------------------------------------

def test_dispatch_window_bounds_inflight(ref):
    import jax.numpy as jnp
    w, rw = DispatchWindow(depth=2), ref[1].DispatchWindow(depth=2)
    for i in range(6):
        w.admit(torch.tensor(float(i)))
        rw.admit(jnp.float32(i))
        assert len(w) == len(rw) <= 2
    assert (w.retired, w.max_inflight) == (rw.retired, rw.max_inflight) == (4, 2)
    w.drain()
    rw.drain()
    assert len(w) == 0 and w.retired == rw.retired == 6


def test_dispatch_window_depth_zero_is_synchronous(ref):
    w = DispatchWindow(depth=0)
    w.admit(torch.tensor(1.0))
    assert len(w) == 0 and w.retired == 1


def test_dispatch_window_env_default(monkeypatch):
    monkeypatch.setenv("MXNET_TPU_INFLIGHT_STEPS", "5")
    assert DispatchWindow().depth == 5
    monkeypatch.delenv("MXNET_TPU_INFLIGHT_STEPS")
    assert DispatchWindow().depth == 2


def test_pending_scalar_lazy_read(ref):
    import jax.numpy as jnp
    p, rp = PendingScalar(torch.tensor(2.5)), ref[1].PendingScalar(jnp.float32(2.5))
    assert "PendingScalar" in repr(p)
    assert float(p) == float(rp) == 2.5 and p.item() == 2.5
    np.testing.assert_array_equal(np.asarray(p), 2.5)
    assert p.shape == () and p.block_until_ready() is p
    assert drain([p]) == ref[1].drain([rp]) == [2.5]
    from mxnet_tpu_torch.parallel import data_parallel
    assert data_parallel.PendingScalar is PendingScalar


# -- trainers fed by the feed ----------------------------------------------------------

BERT = dict(vocab_size=256, num_layers=2, units=32, hidden_size=64, num_heads=2,
            max_length=64)


def test_trajectory_parity_through_each_feed(ref):
    """10 fused BERT steps, each package's trainer fed by its own feed."""
    mx, rfeed = ref
    from mxnet_tpu.models.bert import BertModel as RefBert
    from mxnet_tpu.parallel import DataParallelTrainer as RefDPT, make_mesh as ref_mesh
    from mxnet_tpu_torch.convert import load_jax_params, seeded_params
    from mxnet_tpu_torch.models import BertModel
    from mxnet_tpu_torch.parallel import DataParallelTrainer, make_mesh
    weights = seeded_params(BertModel(**BERT), seed=4)
    port = BertModel(**BERT)
    port.initialize(ctx=mt.cpu())
    load_jax_params(port, weights)
    refnet = RefBert(**BERT)
    refnet.initialize(ctx=mx.cpu())
    for key, p in refnet._collect_params_with_prefix().items():
        p.set_data(mx.nd.array(weights[key], ctx=mx.cpu()))
    rs = np.random.RandomState(9)
    x = rs.randint(0, 256, size=(20, 32)).astype(np.int32)
    y = rs.randint(0, 256, size=(20, 32)).astype(np.int32)
    pt = DataParallelTrainer(port, mt.gluon.loss.SoftmaxCrossEntropyLoss(), "adam",
                             {"learning_rate": 1e-3}, mesh=make_mesh({"dp": 1},
                                                                     devices=[mt.cpu()]))
    rt = RefDPT(refnet, mx.gluon.loss.SoftmaxCrossEntropyLoss(), "adam",
                {"learning_rate": 1e-3}, mesh=ref_mesh({"dp": 1}))
    with mt.cpu():
        pit = mt.io.NDArrayIter(x, y, batch_size=2)
    pfeed = DeviceFeed.for_trainer(pit, pt)
    rfd = rfeed.DeviceFeed.for_trainer(mx.io.NDArrayIter(x, y, batch_size=2), rt)
    got = [pt.step(b.data[0], b.label[0]) for b in pfeed]
    want = [float(rt.step(b.data[0], b.label[0])) for b in rfd]
    pt.drain()
    got = [float(g) for g in got]
    assert len(got) == len(want) == 10
    np.testing.assert_allclose(got, want, rtol=TOL_LOSS)
    assert got[-1] < got[0]
    assert pt._window.max_inflight >= 1 and len(pt._window) == 0
    pfeed.close()
    rfd.close()


def _lc_tokens():
    rs = np.random.RandomState(21)
    return rs.randint(0, LC_VOCAB, size=LC_B * LC_T * LC_STEPS + 1).astype(np.int32)


def _lc_weights():
    from mxnet_tpu_torch.convert import seeded_params
    from mxnet_tpu_torch.recipes import long_context as lc
    net = lc.LongContextLM(LC_VOCAB, max_length=LC_T, **LC_CFG)
    net.initialize(ctx=mt.cpu())
    return seeded_params(net, seed=5)


def _lc_port_run(weights, mesh):
    """(batches this rank got, losses) of the port's trainer fed by make_feed."""
    from mxnet_tpu_torch.convert import load_jax_params
    from mxnet_tpu_torch.recipes import long_context as lc
    net = lc.make_model(LC_VOCAB, seq_len=LC_T, ctx=mt.cpu(), **LC_CFG)
    load_jax_params(net, weights)
    tr = lc.make_trainer(net, mesh, learning_rate=1e-3)
    feed = lc.make_feed(lc.TokenWindows(_lc_tokens(), LC_B, LC_T), tr)
    batches, losses = [], []
    for x, y in feed:
        batches.append((x.numpy().tolist(), y.numpy().tolist()))
        losses.append(tr.step(x, y))
    tr.drain()
    feed.close()
    return batches, [float(v) for v in losses]


def rank_make_feed(workdir):
    """One of 4 ranks at dp2 x sp2: its coordinates, batches and losses."""
    from mxnet_tpu_torch.parallel import make_mesh
    weights = dict(np.load(f"{workdir}/weights.npz"))
    mesh = make_mesh({"dp": 2, "sp": 2}, devices=[mt.cpu()])
    batches, losses = _lc_port_run(weights, mesh)
    return {"coords": dict(mesh.coords), "batches": batches, "losses": losses,
            "modules": sorted(m for m in sys.modules
                              if m.split(".")[0] in ("jax", "jaxlib", "mxnet_tpu"))}


def _lc_ref_run(ref, weights, ndev):
    """The reference's trainer fed by its make_feed on ``ndev`` CPU devices
    (dp x sp = 2 x 2 for 4): (global batches, losses)."""
    import jax
    mx = ref[0]
    from mxnet_tpu.parallel.mesh import make_mesh as ref_mesh
    from mxnet_tpu.recipes import long_context as rlc
    net = rlc.make_model(LC_VOCAB, seq_len=LC_T, ctx=mx.cpu(), **LC_CFG)
    for key, p in net._collect_params_with_prefix().items():
        p.set_data(mx.nd.array(weights[key], ctx=mx.cpu()))
    axes = {"dp": 2, "sp": 2} if ndev == 4 else {"dp": 1, "sp": 1}
    tr = rlc.make_trainer(net, ref_mesh(axes, devices=jax.devices("cpu")[:ndev]),
                          learning_rate=1e-3)
    feed = rlc.make_feed(rlc.TokenWindows(_lc_tokens(), LC_B, LC_T), tr)
    batches, losses = [], []
    for x, y in feed:
        batches.append((np.asarray(x), np.asarray(y)))
        losses.append(float(tr.step(x, y)))
    feed.close()
    return batches, losses


def test_make_feed_at_world_1_matches_reference(ref):
    from mxnet_tpu_torch.parallel import make_mesh
    weights = _lc_weights()
    batches, losses = _lc_port_run(weights, make_mesh({"dp": 1, "sp": 1},
                                                      devices=[mt.cpu()]))
    ref_batches, ref_losses = _lc_ref_run(ref, weights, 1)
    assert len(batches) == len(ref_batches) == LC_STEPS
    for (x, y), (rx, ry) in zip(batches, ref_batches):
        np.testing.assert_array_equal(np.asarray(x), rx)
        np.testing.assert_array_equal(np.asarray(y), ry)
    np.testing.assert_allclose(losses, ref_losses, rtol=TOL_LOSS)


def test_make_feed_on_4_ranks_matches_reference_shards(ref, tmp_path):
    weights = _lc_weights()
    np.savez(tmp_path / "weights.npz", **weights)
    ranks = _dist_util.launch_local(f"{MODULE}:rank_make_feed", 4,
                                    {"workdir": str(tmp_path)}, device="cpu",
                                    timeout=180, pythonpath=[TESTS_DIR],
                                    workdir=str(tmp_path / "launch"))
    ref_batches, ref_losses = _lc_ref_run(ref, weights, 4)
    seen = set()
    for rank in ranks:
        dp, sp = rank["coords"]["dp"], rank["coords"]["sp"]
        seen.add((dp, sp))
        assert rank["modules"] == []
        assert len(rank["batches"]) == LC_STEPS
        for (x, y), (rx, ry) in zip(rank["batches"], ref_batches):
            rows = slice(dp * LC_B // 2, (dp + 1) * LC_B // 2)
            cols = slice(sp * LC_T // 2, (sp + 1) * LC_T // 2)
            np.testing.assert_array_equal(np.asarray(x), rx[rows, cols])
            np.testing.assert_array_equal(np.asarray(y), ry[rows, cols])
        np.testing.assert_allclose(rank["losses"], ref_losses, rtol=TOL_LOSS)
    assert seen == {(0, 0), (0, 1), (1, 0), (1, 1)}


def test_run_steps_and_gluon_trainer_join_the_window():
    from mxnet_tpu_torch.parallel import DataParallelTrainer, make_mesh
    mt.random.seed(5)
    net = mt.gluon.nn.Dense(4, in_units=8)
    net.initialize(ctx=mt.cpu())
    x = mt.nd.array(np.ones((8, 8), "float32"), ctx=mt.cpu())
    with mt.autograd.record():
        out = net(x)
    out.backward()
    trainer = mt.gluon.Trainer(net.collect_params(), "sgd", {"learning_rate": 0.1})
    trainer.step(8)
    assert len(trainer._window) == 1
    trainer.drain()
    assert len(trainer._window) == 0
    dpt = DataParallelTrainer(net, lambda p, y: ((p - y) ** 2).mean(dim=-1), "sgd",
                              {"learning_rate": 0.05},
                              mesh=make_mesh({"dp": 1}, devices=[mt.cpu()]))
    y = mt.nd.array(np.zeros((8, 4), "float32"), ctx=mt.cpu())
    losses = dpt.run_steps(x, y, 3)
    assert len(dpt._window) == 1 and dpt._window.retired == 0
    dpt.drain()
    assert len(dpt._window) == 0
    assert np.all(np.isfinite(losses.asnumpy()))


def test_feed_and_window_gauges_exported(ref):
    from mxnet_tpu_torch import telemetry
    telemetry.reset()
    telemetry.enable()
    try:
        feed = DeviceFeed(_iters(ref)[0], device=mt.cpu(), name="gaugetest")
        list(feed)
        feed.close()
        w = DispatchWindow(depth=1, name="gaugetest")
        w.admit(torch.tensor(1.0))
        w.admit(torch.tensor(2.0))
        w.drain()
        scrape = telemetry.scrape()
    finally:
        telemetry.disable()
        telemetry.reset()
    for fam in ("mx_feed_queue_depth", "mx_feed_stall_seconds_total", "mx_inflight_steps",
                "mx_dispatch_wait_seconds_total"):
        assert fam in scrape, fam


def test_dataloader_device_feed_and_maybe_wrap(ref, monkeypatch):
    from mxnet_tpu_torch.gluon.data import ArrayDataset, DataLoader
    x, y = _arrays(16)
    with mt.cpu():
        loader = DataLoader(ArrayDataset(x, y), batch_size=4)
        want = [(a.asnumpy(), b.asnumpy()) for a, b in loader]
    feed = loader.device_feed(device=mt.cpu())
    got = [(a.asnumpy(), b.asnumpy()) for a, b in feed]
    _same(got, want)
    feed.close()
    assert isinstance(maybe_wrap([1, 2], device=mt.cpu()), DeviceFeed)
    f = DeviceFeed([1], device=mt.cpu())
    assert maybe_wrap(f) is f
    monkeypatch.setenv("MXNET_TPU_FEED_DEPTH", "0")
    src = [1, 2]
    assert maybe_wrap(src) is src


def test_dataloader_device_feed_for_a_trainer(ref):
    """``DataLoader.device_feed(trainer=...)``, the reference's shortcut for
    ``DeviceFeed.for_trainer`` (its ``gluon/data/dataloader.py:66-77``,
    ``docs/input_pipeline.md``): the batches of the reference's loader fed
    to its trainer, exactly, on the trainer's device."""
    mx, _ = ref
    from mxnet_tpu.gluon.data import ArrayDataset as RefDataset, DataLoader as RefLoader
    from mxnet_tpu.parallel import DataParallelTrainer as RefDPT, make_mesh as ref_mesh
    from mxnet_tpu_torch.gluon.data import ArrayDataset, DataLoader
    from mxnet_tpu_torch.parallel import DataParallelTrainer, make_mesh
    x, y = _arrays(16)
    net = mt.gluon.nn.Dense(2, in_units=3)
    net.initialize(ctx=mt.cpu())
    tr = DataParallelTrainer(net, mt.gluon.loss.L2Loss(), "sgd", {"learning_rate": 0.1},
                             mesh=make_mesh({"dp": 1}, devices=[mt.cpu()]))
    rnet = mx.gluon.nn.Dense(2, in_units=3)
    rnet.initialize(ctx=mx.cpu())
    rtr = RefDPT(rnet, mx.gluon.loss.L2Loss(), "sgd", {"learning_rate": 0.1},
                 mesh=ref_mesh({"dp": 1}))
    with mt.cpu():
        feed = DataLoader(ArrayDataset(x, y), batch_size=4).device_feed(trainer=tr)
    rfeed = RefLoader(RefDataset(x, y), batch_size=4).device_feed(trainer=rtr)
    batches = list(feed)
    assert all(t._data.device == tr.device.torch_device for b in batches for t in b)
    _same([(a.asnumpy(), b.asnumpy()) for a, b in batches],
          [(np.asarray(a), np.asarray(b)) for a, b in rfeed])
    feed.close()
    rfeed.close()


@pytest.mark.gpu
def test_make_feed_matches_hand_fed_steps_on_the_card():
    """The long-context trainer (captured on the card) fed by ``make_feed``
    against the same trainer fed TokenWindows' batches by hand: losses and
    weights bitwise (deterministic algorithms: the embedding's gradient adds
    with atomics otherwise), the feed's leaves on the card, causal K1-K3
    once a layer and step and K5 once a step in both, at most 2 steps in
    flight."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run on the card")
    from mxnet_tpu_torch.convert import load_jax_params
    from mxnet_tpu_torch.ops.cuda import flash_attention as fa
    from mxnet_tpu_torch.ops.cuda import fused_optimizer as fo
    from mxnet_tpu_torch.parallel import make_mesh
    from mxnet_tpu_torch.recipes import long_context as lc
    torch.backends.cuda.matmul.allow_tf32 = False
    gpu = mt.gpu(0)
    weights = _lc_weights()
    counters = (fa.flash_attention_fwd, fa.flash_attention_bwd_dq, fa.flash_attention_bwd_dkv)
    runs = {}
    prev = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        for mode in ("feed", "hand"):
            net = lc.make_model(LC_VOCAB, seq_len=LC_T, ctx=gpu, **LC_CFG)
            load_jax_params(net, weights)
            tr = lc.make_trainer(net, make_mesh({"dp": 1, "sp": 1}, devices=[gpu]),
                                 learning_rate=1e-3)
            windows = lc.TokenWindows(_lc_tokens(), LC_B, LC_T)
            before = [c.launches_by_mask.get("causal", 0) for c in counters]
            k5 = fo.fused_adam_update.launches
            losses = []
            if mode == "feed":
                feed = lc.make_feed(windows, tr)
                for x, y in feed:
                    assert x.is_cuda and y.is_cuda
                    losses.append(tr.step(x, y))
                feed.close()
            else:
                for x, y in windows:
                    losses.append(tr.step(mt.nd.array(x, ctx=gpu, dtype="int32"),
                                          mt.nd.array(y, ctx=gpu, dtype="int32")))
            tr.drain()
            runs[mode] = ([float(v) for v in losses],
                          {k: p._param.detach().cpu().numpy()
                           for k, p in net._collect_params_with_prefix().items()},
                          [c.launches_by_mask.get("causal", 0) - b
                           for c, b in zip(counters, before)],
                          fo.fused_adam_update.launches - k5, tr._window.max_inflight,
                          tr.captured)
    finally:
        torch.use_deterministic_algorithms(prev)
    (fl, fw, fk, f5, finf, fcap), (hl, hw, hk, h5, hinf, hcap) = runs["feed"], runs["hand"]
    assert fl == hl and len(fl) == LC_STEPS
    for k, w in hw.items():
        np.testing.assert_array_equal(fw[k], w)
    assert fk == hk == [LC_CFG["num_layers"] * LC_STEPS] * 3
    assert f5 == h5 == LC_STEPS
    assert max(finf, hinf) <= 2 and fcap and hcap
