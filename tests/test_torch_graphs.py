"""The compiled paths of the port: the fused step's device scalars, the
CachedOp's entries, and the graph cache's bookkeeping.

On the CPU (the kernels' plain versions; no graph is captured here):

- K4/K5's device-scalar form (``fused_*_update_hyper``): the plain versions
  reading the 10-value ``hyper`` tensor equal the by-value plain versions
  bitwise, and the fused step that now goes through them matches the
  reference's ``DataParallelTrainer`` (``sgd_mom_update`` and
  ``adam_update`` on ``make_mesh({"dp": 1})``) over 10 steps of a
  ``FactorScheduler`` that changes lr every 2 steps, at
  ``test_torch_data_parallel.py``'s tolerances (loss 1e-5 relative, weights
  1e-5 of each tensor's max);
- a pointer-table miss while a graph is being captured raises;
- ``HybridBlock.hybridize()``: the same calls on a hybridized 2-layer BERT
  (batch 1, 2, 1, then one under ``autograd.record()``) leave as many
  ``_cached_graphs`` entries in the port as in the reference (3), and
  ``hybridize()``, ``clear_cache()`` and ``cast()`` drop them in both;
  hybridized outputs equal the port's unhybridized ones bitwise and the
  reference's hybridized ones at ``test_torch_bert.py``'s 1e-4;
- the engine's cache (weak entries, invalidation by key, an entry dropped
  when its addresses moved) and the replay of launch counts, on stand-in
  graphs; the rules' by-value signatures go through the hyper form;
- the generators keep their identity through ``seed`` and
  ``set_state_raw``, so a registered graph goes on drawing from them.

On the card (``gpu``-marked: ``pytest -m gpu --noconftest``), the
counterparts of ``tests/test_retrace_stability.py:56/:72/:93`` and
``tests/test_engine_compilation.py:53/:169``: one capture per signature,
none when lr changes, captured steps bitwise equal to eager ones, a
replayed forward equal to the eager one with fresh outputs, the cache
cleared on ``cast``, the launch counters under replay, and a dropout model
whose captured steps equal its eager ones after the same seed.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import engine
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.convert import load_jax_params, seeded_params
from mxnet_tpu_torch.models import BertModel
from mxnet_tpu_torch.ops.cuda import fused_optimizer as fo
from mxnet_tpu_torch.parallel import DataParallelTrainer, make_mesh
from torch_threads import one_torch_thread  # noqa: F401

BERT = dict(vocab_size=64, num_layers=2, units=32, hidden_size=64, num_heads=2,
            max_length=32)
TOL_LOSS = 1e-5      # test_torch_data_parallel.py's
TOL_W = 1e-5         # of each tensor's max, its SGD weights'
TOL_LOGITS = 1e-4    # test_torch_bert.py's


@pytest.fixture(scope="module")
def ref():
    import mxnet_tpu as mx
    from mxnet_tpu.parallel import DataParallelTrainer as RefDPT, make_mesh as ref_mesh
    return mx, RefDPT, ref_mesh


def _rel(a, b):
    return float(np.abs(a - b).max()) / max(float(np.abs(b).max()), 1e-30)


def _lists(seed, shapes, dtype=torch.float32):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(s, generator=g).to(dtype) for s in shapes]


SHAPES = [(7,), (33, 5), (130,), (2, 3, 4)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rule", ["sgd", "sgd_mom", "adam"])
def test_hyper_plain_equals_by_value_plain(rule, dtype):
    """The plain version reading the hyper tensor is the by-value plain
    version on the same 10 values: bitwise."""
    ws, gs, ms, vs = (_lists(s, SHAPES, dtype) for s in (1, 2, 3, 4))
    vs = [v.abs() for v in vs]
    kw = dict(lr=0.037, momentum=0.9, wd=1e-3, beta1=0.9, beta2=0.999, epsilon=1e-8,
              rescale_grad=0.5, clip_gradient=0.8)
    hyper = torch.tensor(fo.hyper_values(**kw))
    if rule == "sgd":
        got = fo.fused_sgd_update_hyper(ws, gs, hyper)
        want = fo.fused_sgd_update_plain(ws, gs, kw["lr"], kw["wd"], 0.5, 0.8)
    elif rule == "sgd_mom":
        got = fo.fused_sgd_mom_update_hyper(ws, gs, ms, hyper)
        want = fo.fused_sgd_mom_update_plain(ws, gs, ms, kw["lr"], 0.9, kw["wd"], 0.5, 0.8)
    else:
        got = fo.fused_adam_update_hyper(ws, gs, ms, vs, hyper)
        want = fo.fused_adam_update_plain(ws, gs, ms, vs, kw["lr"], 0.9, 0.999, 1e-8,
                                          kw["wd"], 0.5, 0.8)
    for g_list, w_list in zip(got, want):
        for a, b in zip(g_list, w_list):
            assert a.dtype == b.dtype and torch.equal(a, b)


def test_hyper_values_layout():
    assert fo.HYPER_FIELDS[0] == "lr" and len(fo.HYPER_FIELDS) == 10
    v = fo.hyper_values(lr=0.1, wd=1e-4)
    assert v[fo.HYPER_FIELDS.index("c1")] == v[fo.HYPER_FIELDS.index("c2")] == 1.0
    assert v[fo.HYPER_FIELDS.index("clip_gradient")] == -1.0
    assert v[0] == float(np.float32(0.1))
    with pytest.raises(MXNetError, match="unknown fields"):
        fo.hyper_values(learning_rate=0.1)
    with pytest.raises(MXNetError, match="10 float32"):
        fo.fused_sgd_update_hyper(_lists(0, [(3,)]), _lists(1, [(3,)]), torch.zeros(9))


def _mlp(nn_mod):
    net = nn_mod.HybridSequential()
    net.add(nn_mod.Dense(16, in_units=8, activation="relu"), nn_mod.Dense(5, in_units=16))
    return net


@pytest.mark.parametrize("optimizer,params", [
    ("sgd", {"learning_rate": 0.2, "momentum": 0.9, "wd": 1e-3}),
    ("adam", {"learning_rate": 0.05, "wd": 1e-3})], ids=["sgd_mom_update", "adam_update"])
def test_hyper_step_matches_reference_under_factor_scheduler(ref, optimizer, params):
    """10 steps of the fused step (the hyper form on the CPU) against the
    reference's, lr halved every 2 updates."""
    mx, RefDPT, ref_mesh = ref
    port, refnet = _mlp(mt.gluon.nn), _mlp(mx.gluon.nn)
    port.initialize(ctx=mt.cpu())
    refnet.initialize(ctx=mx.cpu())
    weights = seeded_params(port, seed=11)
    load_jax_params(port, weights)
    for key, p in refnet._collect_params_with_prefix().items():
        p.set_data(mx.nd.array(weights[key], ctx=mx.cpu()))
    pt = DataParallelTrainer(port, mt.gluon.loss.SoftmaxCrossEntropyLoss(), optimizer,
                             dict(params, lr_scheduler=mt.lr_scheduler.FactorScheduler(2, 0.5)),
                             mesh=make_mesh({"dp": 1}, devices=[mt.cpu()]))
    rt = RefDPT(refnet, mx.gluon.loss.SoftmaxCrossEntropyLoss(), optimizer,
                dict(params, lr_scheduler=mx.lr_scheduler.FactorScheduler(2, 0.5)),
                mesh=ref_mesh({"dp": 1}))
    assert pt._eager_reason() == pt._graph_reason == "cpu" and not pt.captured
    rs = np.random.RandomState(12)
    x = rs.normal(size=(6, 8)).astype(np.float32)
    y = (np.arange(6) % 5).astype(np.int32)
    p_loss = [float(pt.step(mt.nd.array(x, ctx=mt.cpu()),
                            mt.nd.array(y, ctx=mt.cpu(), dtype="int32"))) for _ in range(10)]
    r_loss = [float(rt.step(mx.nd.array(x), mx.nd.array(y, dtype="int32"))) for _ in range(10)]
    rt.sync()
    assert pt.optimizer.learning_rate == rt.optimizer.learning_rate
    np.testing.assert_allclose(p_loss, r_loss, rtol=TOL_LOSS)
    rw = {k: p.data().asnumpy() for k, p in refnet._collect_params_with_prefix().items()}
    for key, p in port._collect_params_with_prefix().items():
        assert _rel(p.data().asnumpy(), rw[key]) <= TOL_W, key


def test_by_value_rules_go_through_the_hyper_form(monkeypatch):
    """The rules' by-value signatures are the hyper form on a tensor of
    their floats: one path, bitwise."""
    ws, gs, ms = (_lists(s, SHAPES) for s in (30, 31, 32))
    seen = []
    real = fo.fused_sgd_mom_update_hyper

    def spy(w, g, m, hyper, out=None):
        seen.append(hyper.tolist())
        return real(w, g, m, hyper, out)
    monkeypatch.setattr(fo, "fused_sgd_mom_update_hyper", spy)
    got = fo.fused_sgd_mom_update(ws, gs, ms, 0.037, momentum=0.9, wd=1e-3, clip_gradient=0.8)
    want = fo.fused_sgd_mom_update_plain(ws, gs, ms, 0.037, 0.9, 1e-3, 1.0, 0.8)
    assert seen == [fo.hyper_values(lr=0.037, momentum=0.9, wd=1e-3, clip_gradient=0.8)]
    for g_list, w_list in zip(got, want):
        for a, b in zip(g_list, w_list):
            assert torch.equal(a, b)


def test_table_miss_during_capture_raises(monkeypatch):
    """The warm-up builds the update's pointer tables; a new list met while
    a graph is being captured raises instead of copying a table."""
    ws, gs, ms = (_lists(s, [(5,), (9,)]) for s in (20, 21, 22))
    names = ["weights", "grads", "moms", "out weights", "out moms"]
    ops = [ws, gs, ms, None, ws, ms, None]
    fo._table("test", torch.device("cpu"), ops, names)
    monkeypatch.setattr(engine, "capturing", lambda: True)
    keep = []
    monkeypatch.setattr(engine._ACTIVE, "keep", keep, raising=False)
    fo._table("test", torch.device("cpu"), ops, names)          # a hit: kept alive
    assert len(keep) == 1
    with pytest.raises(MXNetError, match="no pointer table.*captured"):
        fo._table("test", torch.device("cpu"),
                  [[w.clone() for w in ws], gs, ms, None, ws, ms, None], names)


# -- the CachedOp -------------------------------------------------------------------

def _bert_pair(ref, seed):
    mx = ref[0]
    from mxnet_tpu.models.bert import BertModel as RefBert
    port = BertModel(**BERT)
    port.initialize(ctx=mt.cpu())
    weights = seeded_params(port, seed=seed)
    load_jax_params(port, weights)
    refnet = RefBert(**BERT)
    refnet.initialize(ctx=mx.cpu())
    for key, p in refnet._collect_params_with_prefix().items():
        p.set_data(mx.nd.array(weights[key], ctx=mx.cpu()))
    return port, refnet


def test_cached_entries_match_reference(ref):
    """Batch 1, 2, 1 in predict mode, then batch 1 under record: one entry a
    (signature, train flag) in both packages, none in the children (they
    fold into the parent's call); hybridize(), clear_cache() and cast()
    drop them."""
    mx = ref[0]
    port, refnet = _bert_pair(ref, seed=3)
    port.hybridize(static_alloc=True, static_shape=True)
    refnet.hybridize(static_alloc=True, static_shape=True)
    rs = np.random.RandomState(4)
    ids = {b: rs.randint(0, BERT["vocab_size"], size=(b, 16)).astype(np.int32) for b in (1, 2)}
    for b in (1, 2, 1):
        port(mt.nd.array(ids[b], ctx=mt.cpu(), dtype="int32"))
        refnet(mx.nd.array(ids[b], dtype="int32"))
    with mt.autograd.record():
        port(mt.nd.array(ids[1], ctx=mt.cpu(), dtype="int32"))
    with mx.autograd.record():
        refnet(mx.nd.array(ids[1], dtype="int32"))
    assert len(port._cached_graphs) == len(refnet._cached_graphs) == 3
    assert sorted(sig[1] for sig in port._cached_graphs) == [False, False, True]
    assert {e.eager for e in port._cached_graphs.values()} == {"cpu"}
    assert not port.encoder._cached_graphs and not refnet.encoder._cached_graphs
    assert port._flags == {"static_alloc": True, "static_shape": True}
    for drop in (lambda n: n.hybridize(), lambda n: n.clear_cache(),
                 lambda n: n.cast("float32")):
        for net, nd in ((port, mt.nd), (refnet, mx.nd)):
            kw = {"ctx": mt.cpu()} if net is port else {}
            net(nd.array(ids[2], dtype="int32", **kw))
            assert len(net._cached_graphs) >= 1
            drop(net)
            assert len(net._cached_graphs) == 0


def test_hybridized_outputs_match(ref):
    """Hybridized logits: bitwise the port's unhybridized ones (the CPU runs
    the eager forward), within 1e-4 of the reference's hybridized ones."""
    mx = ref[0]
    port, refnet = _bert_pair(ref, seed=5)
    ids = np.random.RandomState(6).randint(0, BERT["vocab_size"], size=(2, 24)).astype(np.int32)
    eager = port(mt.nd.array(ids, ctx=mt.cpu(), dtype="int32")).asnumpy()
    port.hybridize()
    refnet.hybridize()
    got = port(mt.nd.array(ids, ctx=mt.cpu(), dtype="int32")).asnumpy()
    again = port(mt.nd.array(ids, ctx=mt.cpu(), dtype="int32")).asnumpy()
    expect = refnet(mx.nd.array(ids, dtype="int32")).asnumpy()
    np.testing.assert_array_equal(got, eager)
    np.testing.assert_array_equal(again, eager)
    np.testing.assert_allclose(got, expect, rtol=TOL_LOGITS, atol=TOL_LOGITS)


# -- the engine's bookkeeping ---------------------------------------------------------

class _FakeGraph:
    def __init__(self):
        self.replays = 0

    def replay(self):
        self.replays += 1


def _counter():
    def launched():
        pass
    launched.launches = 0
    launched.launches_by_dtype = {}
    return launched


def test_replay_adds_the_captured_launch_counts(monkeypatch):
    """What the wrappers counted during a capture is taken back and added at
    each replay (stand-in graph: the bookkeeping of ``engine.capture``)."""
    c = _counter()
    monkeypatch.setattr(engine, "_COUNTERS", [(c, "launches"), (c, "launches_by_dtype")])
    c.launches, c.launches_by_dtype = 5, {"float32": 5}
    before = engine._snapshot()
    c.launches += 12                                   # the capture's Python launches
    c.launches_by_dtype["float32"] += 12
    c.launches_by_dtype["bfloat16"] = 1
    deltas = engine._deltas(before, engine._snapshot())
    engine._restore(before)
    assert (c.launches, c.launches_by_dtype) == (5, {"float32": 5})
    entry = engine.GraphEntry(_FakeGraph(), ("out",), deltas, [], 0.0, 0)
    stats = engine.cache_stats()["replays"]
    for _ in range(3):
        assert entry.replay() == ("out",)
    assert c.launches == 5 + 3 * 12
    assert c.launches_by_dtype == {"float32": 5 + 3 * 12, "bfloat16": 3}
    assert entry.graph.replays == 3
    assert engine.cache_stats()["replays"] - stats == 3


def test_cache_holds_entries_weakly_and_invalidates_by_key():
    key_a, key_b = ("gluon", 101, "fp-a", ((1, 2),)), ("dp_step", 102, "fp-b", ((3,),))
    a = engine.insert(key_a, engine.GraphEntry(_FakeGraph(), (), (), [], 0.0, 0))
    b = engine.insert(key_b, engine.GraphEntry(_FakeGraph(), (), (), [], 0.0, 0))
    hits, misses = engine.cache_stats()["hits"], engine.cache_stats()["misses"]
    assert engine.lookup(key_a) is a and engine.lookup(("gluon", 0)) is None
    assert engine.cache_stats()["hits"] - hits == 1
    assert engine.cache_stats()["misses"] - misses == 1
    engine.clear_compilation_cache(101)
    assert not a.valid and b.valid and engine.lookup(key_a) is None
    size = engine.cache_size()
    del b                                # its owner let it go: the cache forgets it
    assert engine.cache_size() == size - 1 and engine.lookup(key_b) is None
    assert not engine.capturing()


def test_entry_goes_stale_when_its_addresses_move():
    """``lookup`` checks an entry's addresses when the storage epoch moved:
    the same addresses keep it (a hit), new ones or a gone owner drop it (a
    miss)."""
    class Owner:
        ptrs = [(1, 2)]
    owner = Owner()
    ptrs = owner.ptrs
    key = ("dp_step", 103, "fp-c", ((4,),))
    entry = engine.insert(key, engine.GraphEntry(_FakeGraph(), (), (), [], 0.0, 0, owner,
                                                 lambda o: tuple(o.ptrs)))
    hits, misses = engine.cache_stats()["hits"], engine.cache_stats()["misses"]
    engine.note_storage_change()                      # written in place: same addresses
    assert engine.lookup(key) is entry and entry.live()
    ptrs.append(3)
    assert engine.lookup(key) is entry                # the epoch did not move
    engine.note_storage_change()
    assert engine.lookup(key) is None and not entry.live()
    assert engine.lookup(key) is None                 # dropped from the cache
    st = engine.cache_stats()
    assert (st["hits"] - hits, st["misses"] - misses) == (2, 2)
    # the entry holds its owner weakly: a gone owner makes it stale
    other = engine.GraphEntry(_FakeGraph(), (), (), [], 0.0, 0, Owner(),
                              lambda o: tuple(o.ptrs))
    engine.note_storage_change()
    assert not other.live()


def test_generators_keep_their_identity():
    """``seed`` and ``set_state_raw`` reseed the generator objects in place,
    with the streams that new ones would have."""
    gen = mt.random.generator(mt.cpu())
    mt.random.seed(7)
    assert mt.random.generator(mt.cpu()) is gen
    a = torch.rand(4, generator=gen)
    state = mt.random.get_state_raw()
    b = torch.rand(4, generator=gen)
    mt.random.seed(7)
    np.testing.assert_array_equal(torch.rand(4, generator=gen).numpy(), a.numpy())
    mt.random.set_state_raw(state)
    assert mt.random.generator(mt.cpu()) is gen
    np.testing.assert_array_equal(torch.rand(4, generator=gen).numpy(), b.numpy())
    fresh = torch.Generator().manual_seed(7)
    mt.random.seed(7)
    np.testing.assert_array_equal(torch.rand(4, generator=gen).numpy(),
                                  torch.rand(4, generator=fresh).numpy())


# -- on the card ----------------------------------------------------------------------

def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run on the card")
    return mt.gpu(0)


def _gpu_mlp(ctx, seed=0, dropout=0.0):
    net = mt.gluon.nn.HybridSequential()
    net.add(mt.gluon.nn.Dense(64, in_units=32, activation="relu"))
    if dropout:
        net.add(mt.gluon.nn.Dropout(dropout))
    net.add(mt.gluon.nn.Dense(10, in_units=64))
    net.initialize(ctx=ctx)
    load_jax_params(net, seeded_params(net, seed))
    return net


def _gpu_trainer(net, ctx, optimizer="adam", params=None, captured=True):
    tr = DataParallelTrainer(net, mt.gluon.loss.SoftmaxCrossEntropyLoss(), optimizer,
                             params or {"learning_rate": 1e-2},
                             mesh=make_mesh({"dp": 1}, devices=[ctx]))
    if not captured:
        tr._graph_reason = "eager yardstick"   # the same body, run eagerly every step
    return tr


def _gpu_batch(ctx, n, seed=1):
    rs = np.random.RandomState(seed)
    return (mt.nd.array(rs.normal(size=(n, 32)).astype(np.float32), ctx=ctx),
            mt.nd.array((np.arange(n) % 10).astype(np.int32), ctx=ctx, dtype="int32"))


@pytest.mark.gpu
def test_gpu_one_capture_per_signature():
    """test_retrace_stability.py:56's counterpart: a second batch shape
    captures once more, a repeated one never."""
    ctx = _cuda()
    tr = _gpu_trainer(_gpu_mlp(ctx), ctx)
    assert tr.captured
    engine.reset_stats()
    for n in (8, 8, 8, 8, 16, 16, 16, 8, 16):
        tr.step(*_gpu_batch(ctx, n))
    tr.sync()
    st = engine.cache_stats()
    # each signature: a warm-up step, then a capture and a replay every step
    assert st["captures"] == 2 and st["replays"] == 3 + 2 + 2, st


@pytest.mark.gpu
@pytest.mark.parametrize("optimizer,params", [
    ("adam", {"learning_rate": 1e-2, "wd": 1e-4}),
    ("sgd", {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4})])
def test_gpu_captured_steps_equal_eager_under_changing_lr(optimizer, params):
    """test_retrace_stability.py:72/:93's: lr changes every step, no capture
    follows, and every loss and weight is bitwise the eager step's."""
    ctx = _cuda()
    runs = []
    for captured in (True, False):
        net = _gpu_mlp(ctx)
        tr = _gpu_trainer(net, ctx, optimizer, dict(
            params, lr_scheduler=mt.lr_scheduler.FactorScheduler(1, 0.8)), captured)
        x, y = _gpu_batch(ctx, 8)
        engine.reset_stats()
        losses = [float(tr.step(x, y)) for _ in range(10)]
        assert engine.cache_stats()["captures"] == (1 if captured else 0)
        runs.append((losses, {k: p.data().asnumpy()
                              for k, p in net._collect_params_with_prefix().items()}))
    assert runs[0][0] == runs[1][0]
    for k, w in runs[1][1].items():
        np.testing.assert_array_equal(runs[0][1][k], w)


@pytest.mark.gpu
def test_gpu_counters_count_replays():
    ctx = _cuda()
    tr = _gpu_trainer(_gpu_mlp(ctx), ctx)
    x, y = _gpu_batch(ctx, 8)
    fo.fused_adam_update.launches = 0
    engine.reset_stats()
    for _ in range(6):
        tr.step(x, y)
    tr.sync()
    assert fo.fused_adam_update.launches == 6
    st = engine.cache_stats()
    assert (st["captures"], st["replays"], st["hits"], st["misses"]) == (1, 5, 4, 1), st


@pytest.mark.gpu
def test_gpu_hybridized_replay_equals_eager_and_is_fresh():
    """test_engine_compilation.py:53's: one capture a signature; a replay
    returns new tensors equal to the eager forward's."""
    ctx = _cuda()
    net = _gpu_mlp(ctx)
    x1, _ = _gpu_batch(ctx, 4, seed=2)
    x2, _ = _gpu_batch(ctx, 4, seed=3)
    eager = [net(x)._data.clone() for x in (x1, x2)]
    net.hybridize(static_alloc=True, static_shape=True)
    engine.reset_stats()
    first = net(x1)                    # eager, then captured
    second = net(x2)                   # a replay
    third = net(x1)                    # another replay: must not overwrite `second`
    assert engine.cache_stats()["captures"] == 1
    assert engine.cache_stats()["replays"] == 2
    assert torch.equal(first._data, eager[0]) and torch.equal(third._data, eager[0])
    assert torch.equal(second._data, eager[1])
    assert [e.graph is not None for e in net._cached_graphs.values()] == [True]


@pytest.mark.gpu
def test_gpu_cache_cleared_on_cast():
    """test_engine_compilation.py:169's: cast drops the graphs, the next
    call captures again in the new dtype."""
    ctx = _cuda()
    net = _gpu_mlp(ctx)
    net.hybridize()
    x, _ = _gpu_batch(ctx, 4)
    net(x)
    net(x)
    assert len(net._cached_graphs) == 1
    net.cast("bfloat16")
    assert len(net._cached_graphs) == 0
    engine.reset_stats()
    xb = mt.nd.array(x._data.to(torch.bfloat16))
    out = net(xb)
    net(xb)
    assert out.dtype == torch.bfloat16 and engine.cache_stats()["captures"] == 1


@pytest.mark.gpu
def test_gpu_dropout_captured_equals_eager():
    """Dropout 0.1: 3 captured steps equal 3 eager steps after the same
    seed (the generator registered with the graph)."""
    ctx = _cuda()
    runs = []
    for captured in (True, False):
        mt.random.seed(42)
        net = _gpu_mlp(ctx, dropout=0.1)
        tr = _gpu_trainer(net, ctx, captured=captured)
        x, y = _gpu_batch(ctx, 8)
        runs.append([float(tr.step(x, y)) for _ in range(3)])
    assert runs[0] == runs[1]
