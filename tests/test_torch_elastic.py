"""The port's elastic kill-and-resume against the reference's, on the CPU.

``mxnet_tpu_torch.elastic`` (manifest, ``SnapshotManager``, state, run) and
``parallel/step_program.py`` against ``mxnet_tpu.elastic``, the counterparts
of ``tests/test_elastic.py``:

- the format both ways: a snapshot written by the reference's
  ``SnapshotManager`` reads in the port's ``SnapshotReader`` with the same
  leaves and meta, and the reverse;
- a reference ``DataParallelTrainer`` snapshot (the narrow BERT of
  ``tests/test_torch_data_parallel.py``, Adam, a one-device CPU mesh,
  replicated and ``zero_update``) installs into the port's trainer, whose
  next 3 losses match the reference's next 3 at that file's tolerance (1e-5
  relative); and the port's snapshot installs into the reference's trainer;
  the ZeRO lanes of a reference snapshot pin their order (wd, then Adam's m
  and v);
- kill-and-resume parity in the port: SGD with momentum and wd (K4's rules)
  and Adam, replicated and ``zero_update``: the resumed losses equal the
  uninterrupted run's at rtol 1e-6 (the reference's bound), every restored
  tensor bitwise the saved leaf, and install copies in place (every
  tensor's ``data_ptr`` kept: the ZeRO segments, the gradient buckets and the
  fused update's pointer table hold them);
- ``_revector`` / ``_restore_zero_carry`` against the reference's on the same
  numpy lanes, for dp2 -> dp1, dp1 -> dp2 and dp2 -> dp4 plans; and over
  gloo in spawned CPU ranks: a dp2 snapshot resumed on dp1 (a mesh of one
  device) and on dp4, a dp1 snapshot resumed on dp2, every rank's Adam
  lanes bitwise the reference's ``_revector`` of the saved lanes, "resharded",
  and the next loss and weights against the saving run's (the native wire's
  tolerances of ``tests/test_torch_zero.py``: loss 1e-5 relative, weights
  2e-5);
- the lr scheduler's and the loss scaler's state surviving a resume (lr
  parity at step K+1; the scheduler fields equal the reference's after the
  same calls);
- retention and incomplete snapshots, partial chunks, an unsupported
  format, a background write failure surfacing at the next ``save``, an
  architecture and an optimizer mismatch, a weight-decay lane that differs,
  a ``rng`` leaf of the other package, the ``pp`` kind refused, and with
  ``coordinator=`` a manifest without a commit fence refused;
- ``PreemptionGuard``; a subprocess killed with SIGKILL while it trains,
  whose resume continues the uninterrupted losses, and one sent SIGTERM,
  which ends in a final snapshot;
- the step fingerprint: equal for two builds of one configuration, another
  for another configuration, and the mesh and fingerprint deciding
  "resumed" or "resharded".
"""
import json
import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import _dist_util, elastic
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.convert import gather_params, load_jax_params, seeded_params
from mxnet_tpu_torch.elastic import manifest as _manifest
from mxnet_tpu_torch.elastic import state as es
from mxnet_tpu_torch.lr_scheduler import FactorScheduler
from mxnet_tpu_torch.models import BertModel
from mxnet_tpu_torch.parallel import DataParallelTrainer, make_mesh
from mxnet_tpu_torch.parallel import zero as zero_mod
from torch_threads import one_torch_thread  # noqa: F401

CFG = dict(vocab_size=1024, num_layers=2, units=128, hidden_size=512, num_heads=2,
           max_length=256)
B, T = 2, 64
TOL_LOSS = 1e-5           # tests/test_torch_data_parallel.py's, across the packages
TOL_RESUME = 1e-6         # the reference's (tests/test_elastic.py)
TOL_W = 2e-5
MODULE = "test_torch_elastic"
TESTS_DIR = os.path.dirname(os.path.abspath(__file__))


@pytest.fixture(scope="module")
def ref():
    import jax.numpy as jnp
    import mxnet_tpu as mx
    from mxnet_tpu import elastic as ref_elastic
    from mxnet_tpu.parallel import DataParallelTrainer as RefDPT, make_mesh as ref_mesh
    return mx, ref_elastic, RefDPT, ref_mesh, jnp


def _cpu_mesh(axes=None):
    return make_mesh(axes or {"dp": 1}, devices=[mt.cpu()])


def _batch(seed=1, b=B):
    rs = np.random.RandomState(seed)
    return (rs.randint(0, CFG["vocab_size"], size=(b, T)).astype(np.int32),
            rs.randint(0, CFG["vocab_size"], size=(b, T)).astype(np.int32))


WEIGHTS = {}


def _weights():
    if not WEIGHTS:
        WEIGHTS.update(seeded_params(BertModel(**CFG), seed=0))
    return WEIGHTS


def _bert_trainer(optimizer="adam", zero=False, params=None, weights=True, seed=None, **kw):
    if seed is not None:
        mt.random.seed(seed)
    net = BertModel(**CFG)
    net.initialize(ctx=mt.cpu())
    if weights:
        load_jax_params(net, _weights())
    params = params if params is not None else (
        {"learning_rate": 1e-3} if optimizer == "adam"
        else {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4})
    return DataParallelTrainer(net, mt.gluon.loss.SoftmaxCrossEntropyLoss(), optimizer,
                               params, mesh=kw.pop("mesh", None) or _cpu_mesh(),
                               zero_update=zero, **kw)


def _xy(x, y):
    return mt.nd.array(x, ctx=mt.cpu()), mt.nd.array(y, ctx=mt.cpu(), dtype="int32")


def _ref_trainer(ref, zero):
    mx, _, RefDPT, ref_mesh, _ = ref
    from mxnet_tpu.models.bert import BertModel as RefBert
    net = RefBert(**CFG)
    net.initialize(ctx=mx.cpu())
    for key, p in net._collect_params_with_prefix().items():
        p.set_data(mx.nd.array(_weights()[key], ctx=mx.cpu()))
    return RefDPT(net, mx.gluon.loss.SoftmaxCrossEntropyLoss(), "adam",
                  {"learning_rate": 1e-3}, mesh=ref_mesh({"dp": 1}), zero_update=zero)


def _tiny_leaves(v=1.0):
    return {"w": torch.full((4, 2), v), "b": np.arange(3, dtype=np.float32)}


# -- the format, both ways --------------------------------------------------------------

def test_reference_snapshot_reads_in_the_port(tmp_path, ref):
    jnp = ref[4]
    rs = np.random.RandomState(0)
    leaves = {"w": rs.standard_normal((5, 3)).astype(np.float32),
              "i": np.arange(7, dtype=np.int32), "s": np.float32(2.5),
              "u": np.arange(6, dtype=np.uint32).reshape(2, 3)}
    meta = {"kind": "raw", "nested": {"a": [1, 2]}}
    mgr = ref[1].SnapshotManager(str(tmp_path))
    mgr.save(4, {"leaves": {k: jnp.asarray(v) if k == "w" else v for k, v in leaves.items()},
                 "meta": meta}, wait=True)
    assert elastic.latest_complete_step(str(tmp_path)) == 4
    man = _manifest.load(str(tmp_path), 4)
    assert man["meta"] == dict(meta, step=4)
    with elastic.SnapshotReader(str(tmp_path), 4) as rd:
        assert rd.names == set(leaves)
        for k, v in leaves.items():
            got = rd(k)
            assert got.dtype == np.asarray(v).dtype and np.array_equal(got, v), k


def test_port_snapshot_reads_in_the_reference(tmp_path, ref):
    rs = np.random.RandomState(1)
    w = rs.standard_normal((6, 4)).astype(np.float32)
    shard = es.Chunk(torch.from_numpy(w[2:4]).clone(), (6, 4), [(2, 4), (0, 4)], True)
    leaves = {"full": torch.from_numpy(w), "host": np.arange(5, dtype=np.int64),
              "chunk": shard}
    mgr = elastic.SnapshotManager(str(tmp_path))
    mgr.save(9, {"leaves": leaves, "meta": {"kind": "raw"}}, wait=True)
    man = ref[1].manifest.load(str(tmp_path), 9)
    assert man["meta"] == {"kind": "raw", "step": 9} and man["format"] == 1
    with ref[1].SnapshotReader(str(tmp_path), 9) as rd:
        np.testing.assert_array_equal(rd("full"), w)
        np.testing.assert_array_equal(rd("host"), np.arange(5))
        np.testing.assert_array_equal(rd.read_region("chunk", [(2, 4), (0, 4)]), w[2:4])
        with pytest.raises(Exception, match="chunks cover 8 of 24"):
            rd("chunk")     # a partial leaf: only rows 2-4 were written


@pytest.mark.parametrize("zero", [False, True], ids=["replicated", "zero"])
def test_reference_trainer_snapshot_resumes_in_the_port(tmp_path, ref, zero):
    mx = ref[0]
    x, y = _batch()
    rt = _ref_trainer(ref, zero)
    xr, yr = mx.nd.array(x), mx.nd.array(y, dtype="int32")
    for _ in range(3):
        rt.step(xr, yr)
    ref[1].save_trainer(ref[1].SnapshotManager(str(tmp_path)), rt, wait=True)
    ref_next = [float(rt.step(xr, yr)) for _ in range(3)]
    man = _manifest.load(str(tmp_path), 3)
    if zero:   # the lanes' order: the wd vector, then Adam's m and v
        with elastic.SnapshotReader(str(tmp_path), 3) as rd:
            plan = [es._bucket_from(d) for d in man["meta"]["zero_plan"]]
            assert len(plan) == 1 and plan[0].ndp == 1
            assert {"opt.b0.0", "opt.b0.1", "opt.b0.2"} <= rd.names
            assert "opt.b0.3" not in rd.names
            np.testing.assert_array_equal(rd("opt.b0.0"), zero_mod.wd_vector(plan[0], [0.0] * 64))
            assert (rd("opt.b0.2") >= 0).all() and (rd("opt.b0.1") < 0).any()
    pt = _bert_trainer(zero=zero, weights=False, seed=5)
    with elastic.SnapshotReader(str(tmp_path), 3) as rd:
        with pytest.raises(MXNetError, match="another format"):
            es.install(_bert_trainer(zero=zero), man["meta"], rd, rd.names)
        es.install(pt, man["meta"], rd, rd.names - {"rng"})
    assert pt._t == 3 and pt.optimizer.num_update == 3
    got = [float(pt.step(*_xy(x, y))) for _ in range(3)]
    np.testing.assert_allclose(got, ref_next, rtol=TOL_LOSS)


@pytest.mark.parametrize("zero", [False, True], ids=["replicated", "zero"])
def test_port_trainer_snapshot_resumes_in_the_reference(tmp_path, ref, zero):
    mx = ref[0]
    x, y = _batch()
    pt = _bert_trainer(zero=zero)
    for _ in range(3):
        pt.step(*_xy(x, y))
    elastic.save_trainer(elastic.SnapshotManager(str(tmp_path)), pt, wait=True)
    port_next = [float(pt.step(*_xy(x, y))) for _ in range(3)]
    rt = _ref_trainer(ref, zero)
    man = ref[1].manifest.load(str(tmp_path), 3)
    with ref[1].SnapshotReader(str(tmp_path), 3) as rd:
        ref[1].install(rt, man["meta"], rd, set(rd.names) - {"rng"})
    got = [float(rt.step(mx.nd.array(x), mx.nd.array(y, dtype="int32"))) for _ in range(3)]
    np.testing.assert_allclose(got, port_next, rtol=TOL_LOSS)


# -- kill-and-resume parity in the port --------------------------------------------------

def _tensors(trainer):
    """Every tensor install writes: parameters, gradient buffers, states, shards."""
    out = [p._param for p in trainer._plist] + [p._grad for p in trainer._plist
                                                if p._grad is not None]
    out += [s for st in trainer._opt_state for s in st]
    for zb in trainer._zero_buckets:
        out += [zb["gflat"], zb["wshard"], zb["gshard"], *zb["state"]]
    return out


@pytest.mark.parametrize("zero", [False, True], ids=["replicated", "zero"])
@pytest.mark.parametrize("optimizer", ["sgd", "adam"])
def test_kill_resume_parity(tmp_path, optimizer, zero):
    x, y = _xy(*_batch())
    ref_tr = _bert_trainer(optimizer, zero)
    ref_losses = [float(ref_tr.step(x, y)) for _ in range(6)]
    tr = _bert_trainer(optimizer, zero)
    for _ in range(3):
        tr.step(x, y)
    mgr = elastic.SnapshotManager(str(tmp_path))
    elastic.save_trainer(mgr, tr, wait=True)
    assert mgr.latest_step() == 3
    made = {}

    def rebuild():
        made["tr"] = _bert_trainer(optimizer, zero, weights=False, seed=3)
        made["ptrs"] = [t.data_ptr() for t in _tensors(made["tr"])]
        return made["tr"]

    _, tr2, start, outcome = elastic.resume_or_init(str(tmp_path), rebuild)
    assert (start, outcome) == (3, "resumed")
    assert [t.data_ptr() for t in _tensors(tr2)] == made["ptrs"]     # copied in place
    with elastic.SnapshotReader(str(tmp_path), 3) as rd:
        for name, leaf in es.capture(tr2)["leaves"].items():
            if name != "rng":
                data = leaf.data.numpy() if isinstance(leaf, es.Chunk) else leaf
                assert np.array_equal(data, rd(name)), name
    got = [float(tr2.step(x, y)) for _ in range(3)]
    np.testing.assert_allclose(got, ref_losses[3:], rtol=TOL_RESUME, atol=1e-7)
    assert [t.data_ptr() for t in _tensors(tr2)] == made["ptrs"]


def test_scheduler_and_scaler_survive_resume(tmp_path, ref):
    def make(dtype=None, seed=None):
        return _bert_trainer("sgd", params={"learning_rate": 0.1, "momentum": 0.9,
                                            "lr_scheduler": FactorScheduler(step=2, factor=0.5)},
                             weights=seed is None, seed=seed, dtype=dtype)

    x, y = _xy(*_batch())
    ref_tr = make()
    ref_losses = [float(ref_tr.step(x, y)) for _ in range(8)]
    tr = make()
    for _ in range(5):
        tr.step(x, y)
    elastic.save_trainer(elastic.SnapshotManager(str(tmp_path / "a")), tr, wait=True)
    _, tr2, start, outcome = elastic.resume_or_init(str(tmp_path / "a"), lambda: make(seed=4))
    assert (start, outcome) == (5, "resumed")
    assert es.sched_state(tr2.optimizer) == es.sched_state(tr.optimizer)
    assert tr2.optimizer.lr_scheduler.base_lr == tr.optimizer.lr_scheduler.base_lr != 0.1
    got = [float(tr2.step(x, y)) for _ in range(3)]
    np.testing.assert_allclose(got, ref_losses[5:], rtol=TOL_RESUME, atol=1e-7)
    # the scheduler's fields are the reference's after the same calls
    from mxnet_tpu.lr_scheduler import FactorScheduler as RefFactor
    mine, theirs = FactorScheduler(step=2, factor=0.5, base_lr=0.1), \
        RefFactor(step=2, factor=0.5, base_lr=0.1)
    for n in range(1, 9):
        assert mine(n) == theirs(n)
        assert mine.state_dict() == theirs.state_dict()
    # float16: the loss scaler's state
    tr = make(dtype="float16")
    for _ in range(2):
        tr.step(x, y)
    tr._scaler.loss_scale, tr._scaler._unskipped = 1024.0, 17
    elastic.save_trainer(elastic.SnapshotManager(str(tmp_path / "b")), tr, wait=True)
    _, tr3, start, _ = elastic.resume_or_init(str(tmp_path / "b"),
                                              lambda: make(dtype="float16", seed=5))
    assert start == 2 and tr3._scaler.loss_scale == 1024.0 and tr3._scaler._unskipped == 17
    expect = [float(tr.step(x, y)) for _ in range(2)]
    np.testing.assert_allclose([float(tr3.step(x, y)) for _ in range(2)], expect,
                               rtol=TOL_RESUME, atol=1e-7)


# -- ZeRO re-canonicalisation -------------------------------------------------------------

ENTRIES = [(0, (6, 5), "float32"), (1, (7,), "float32"), (2, (3, 3), "float32"),
           (3, (40,), "float32"), (4, (2, 2), "float32")]


@pytest.mark.parametrize("old_n,new_n", [(2, 1), (1, 2), (2, 4)])
def test_revector_and_restore_carry_equal_reference(ref, old_n, new_n):
    import jax.numpy as jnp
    from mxnet_tpu.elastic import state as ref_state
    from mxnet_tpu.parallel import zero as ref_zero
    old = zero_mod.plan_buckets(ENTRIES, old_n, 25 * 4)
    new = zero_mod.plan_buckets(ENTRIES, new_n, 32 * 4)
    ref_old = ref_zero.plan_buckets([(i, s, jnp.float32) for i, s, _ in ENTRIES], old_n, 25 * 4)
    ref_new = ref_zero.plan_buckets([(i, s, jnp.float32) for i, s, _ in ENTRIES], new_n, 32 * 4)
    rs = np.random.RandomState(old_n * 10 + new_n)
    wds = [0.0, 0.1, 0.2, 0.0, 0.3]
    leaves = {}
    for j, b in enumerate(old):
        leaves[f"opt.b{j}.0"] = zero_mod.wd_vector(b, wds)
        for k in (1, 2):
            lane = rs.standard_normal(b.padded_size).astype(np.float32)
            lane[b.used_size:] = 0
            leaves[f"opt.b{j}.{k}"] = lane
    for k in range(3):
        got = es._revector(old, [leaves[f"opt.b{j}.{k}"] for j in range(len(old))], new[0])
        want = ref_state._revector(ref_old, [leaves[f"opt.b{j}.{k}"]
                                             for j in range(len(old))], ref_new[0])
        np.testing.assert_array_equal(got, want)
    names = set(leaves)
    assert es._bucket_lane_count(names, "opt.b0") == ref_state._bucket_lane_count(names,
                                                                                   "opt.b0") == 3
    got = es._restore_zero_carry("opt.b{j}", old, list(new), leaves.__getitem__, names, 3)
    templates = [(np.zeros(b.padded_size, np.float32),
                  (np.zeros(b.padded_size, np.float32), np.zeros(b.padded_size, np.float32)))
                 for b in ref_new]
    want = ref_state._restore_zero_carry("opt.b{j}", ref_old, list(ref_new), templates,
                                         leaves.__getitem__, names)
    assert len(got) == len(want) == len(new)
    for g, (w0, (w1, w2)) in zip(got, want):
        for a, b in zip(g, (w0, w1, w2)):
            np.testing.assert_array_equal(a, np.asarray(b))
    for b, lanes in zip(new, got):
        np.testing.assert_array_equal(lanes[0], zero_mod.wd_vector(b, wds))


def rank_zero_elastic(workdir, mode, src=None):
    """A rank of the reshard test: ``save`` trains 2 steps with zero_update on
    this world's dp, snapshots into ``<workdir>/dp<n>`` and takes step 3;
    ``resume`` boots from ``src`` and takes step 3, writing its Adam lane
    shards. Rank 0 writes the weights after step 3."""
    import torch.distributed as dist
    n = dist.get_world_size()
    mesh = make_mesh({"dp": n}, devices=[mt.cpu()])
    x, y = _xy(*_batch(b=4))
    out = {"rank": mesh.rank}
    if mode == "save":
        tr = _bert_trainer(zero=True, mesh=mesh, bucket_bytes=1 << 19)
        for _ in range(2):
            tr.step(x, y)
        elastic.save_trainer(elastic.SnapshotManager(os.path.join(workdir, f"dp{n}")), tr,
                             wait=True)
        out["outcome"] = "saved"
    else:
        _, tr, start, out["outcome"] = elastic.resume_or_init(
            src, lambda: _bert_trainer(zero=True, mesh=mesh, bucket_bytes=1 << 19,
                                       weights=False, seed=9))
        lanes = {f"b{j}.{k + 1}": s.numpy() for j, zb in enumerate(tr._zero_buckets)
                 for k, s in enumerate(zb["state"])}
        np.savez(os.path.join(workdir, f"lanes_dp{n}_rank{mesh.rank}.npz"), **lanes)
        out["plan"] = [es._bucket_dict(b) for b in tr._zero_plan]
    out["loss3"] = float(tr.step(x, y))
    params = gather_params(tr.net)
    if mesh.rank == 0:
        np.savez(os.path.join(workdir, f"w_{mode}_dp{n}.npz"), **params)
    return out


def _spawn(workdir, n, mode, src=None):
    return _dist_util.launch_local(f"{MODULE}:rank_zero_elastic", n,
                                   {"workdir": workdir, "mode": mode, "src": src},
                                   device="cpu", timeout=180, pythonpath=[TESTS_DIR],
                                   workdir=os.path.join(workdir, f"launch_{mode}{n}"))


def test_zero_reshard_across_data_degrees_in_ranks(tmp_path, ref):
    """dp2 -> dp1 (a mesh of one device, in this process), dp2 -> dp4 and
    dp1 -> dp2 over gloo."""
    from mxnet_tpu.elastic import state as ref_state
    work = str(tmp_path)
    saved2 = _spawn(work, 2, "save")
    # dp1 from scratch in this process (whole-parameter state on one device)
    x, y = _xy(*_batch(b=4))
    tr1 = _bert_trainer(zero=True, bucket_bytes=1 << 19)
    for _ in range(2):
        tr1.step(x, y)
    elastic.save_trainer(elastic.SnapshotManager(os.path.join(work, "dp1")), tr1, wait=True)
    loss3_dp1 = float(tr1.step(x, y))
    w_dp1 = {k: p.data().asnumpy() for k, p in tr1.net._collect_params_with_prefix().items()}
    # dp2 -> dp1 in this process
    _, tr, start, outcome = elastic.resume_or_init(
        os.path.join(work, "dp2"), lambda: _bert_trainer(zero=True, bucket_bytes=1 << 19,
                                                         weights=False, seed=8))
    assert (start, outcome) == (2, "resharded")
    got = float(tr.step(x, y))
    assert abs(got - saved2[0]["loss3"]) <= TOL_LOSS * abs(saved2[0]["loss3"])
    w2 = dict(np.load(os.path.join(work, "w_save_dp2.npz")))
    for k, p in tr.net._collect_params_with_prefix().items():
        assert np.abs(p.data().asnumpy() - w2[k]).max() <= TOL_W, k
    runs = {"dp4": (_spawn(work, 4, "resume", os.path.join(work, "dp2")), "dp2",
                    saved2[0]["loss3"], w2),
            "dp2": (_spawn(work, 2, "resume", os.path.join(work, "dp1")), "dp1",
                    loss3_dp1, w_dp1)}
    for label, (ranks, src, loss3, w_src) in runs.items():
        n = len(ranks)
        with elastic.SnapshotReader(os.path.join(work, src), 2) as rd:
            old = [ref_state._bucket_from(d) for d in rd.manifest["meta"]["zero_plan"]]
            new = [ref_state._bucket_from(d) for d in ranks[0]["plan"]]
            for r in ranks:
                assert r["outcome"] == "resharded"
                assert abs(r["loss3"] - loss3) <= TOL_LOSS * abs(loss3), (label, r)
                lanes = np.load(os.path.join(work, f"lanes_dp{n}_rank{r['rank']}.npz"))
                for j, b in enumerate(new):
                    for k in (1, 2):
                        full = ref_state._revector(
                            old, [rd(f"opt.b{jo}.{k}") for jo in range(len(old))], b)
                        want = full[r["rank"] * b.shard_size:(r["rank"] + 1) * b.shard_size]
                        np.testing.assert_array_equal(lanes[f"b{j}.{k}"], want)
        w = dict(np.load(os.path.join(work, f"w_resume_dp{n}.npz")))
        for k, v in w_src.items():
            assert np.abs(w[k] - v).max() <= TOL_W, (label, k)


# -- refusals, retention, failures ---------------------------------------------------------

def test_retention_keeps_newest_and_prunes_incomplete(tmp_path):
    mgr = elastic.SnapshotManager(str(tmp_path), max_to_keep=2)
    for s in (1, 2, 3):
        mgr.save(s, {"leaves": _tiny_leaves(s), "meta": {"kind": "raw"}}, wait=True)
    assert mgr.all_steps() == [2, 3]
    stale = _manifest.step_path(str(tmp_path), 2)
    import shutil
    shutil.rmtree(stale)
    os.makedirs(stale)
    open(os.path.join(stale, "shard-00000.npz"), "wb").close()
    assert mgr.all_steps() == [3]
    mgr.save(4, {"leaves": _tiny_leaves(4), "meta": {"kind": "raw"}}, wait=True)
    assert not os.path.isdir(stale)
    assert mgr.all_steps() == [3, 4]


def test_incomplete_snapshot_is_invisible(tmp_path):
    mgr = elastic.SnapshotManager(str(tmp_path))
    assert mgr.latest_step() is None
    os.makedirs(_manifest.step_path(str(tmp_path), 7))
    assert mgr.latest_step() is None
    with pytest.raises(MXNetError, match="no complete snapshot"):
        _manifest.load(str(tmp_path), 7)
    _, _, start, outcome = elastic.resume_or_init(str(tmp_path), lambda: None)
    assert (start, outcome) == (0, "fresh")


def test_should_save_interval_policy(tmp_path):
    mgr = elastic.SnapshotManager(str(tmp_path), save_interval_steps=2)
    assert [s for s in range(7) if mgr.should_save(s)] == [2, 4, 6]
    mgr.save(4, {"leaves": _tiny_leaves(), "meta": {}}, wait=True)
    assert not mgr.should_save(4)
    assert elastic.SnapshotManager(str(tmp_path)).should_save(100) is False


def _rewrite_manifest(tmp_path, step, edit):
    mpath = os.path.join(_manifest.step_path(str(tmp_path), step), _manifest.MANIFEST)
    with open(mpath) as f:
        man = json.load(f)
    edit(man)
    with open(mpath, "w") as f:
        json.dump(man, f)


def test_partial_chunks_rejected_on_read(tmp_path):
    mgr = elastic.SnapshotManager(str(tmp_path))
    mgr.save(1, {"leaves": _tiny_leaves(), "meta": {}}, wait=True)
    _rewrite_manifest(tmp_path, 1, lambda m: m["chunks"].update(w=[]))
    with elastic.SnapshotReader(str(tmp_path), 1) as rd:
        np.testing.assert_array_equal(rd("b"), np.arange(3, dtype=np.float32))
        with pytest.raises(MXNetError, match="chunks cover 0 of 8"):
            rd("w")
        with pytest.raises(MXNetError, match="chunks cover 0 of 2"):
            rd.read_region("w", [(0, 1), (0, 2)])


def test_unsupported_format_rejected(tmp_path):
    mgr = elastic.SnapshotManager(str(tmp_path))
    mgr.save(1, {"leaves": _tiny_leaves(), "meta": {}}, wait=True)
    _rewrite_manifest(tmp_path, 1, lambda m: m.update(format=99))
    with pytest.raises(MXNetError, match="format 99"):
        _manifest.load(str(tmp_path), 1)


def test_background_write_failure_surfaces_at_next_save(tmp_path):
    mgr = elastic.SnapshotManager(str(tmp_path))
    mgr.save(1, {"leaves": _tiny_leaves(), "meta": {"oops": {1, 2}}})  # a set: not JSON
    with pytest.raises(MXNetError, match="async snapshot write failed"):
        mgr.save(2, {"leaves": _tiny_leaves(), "meta": {}})
    assert mgr.latest_step() is None
    mgr.save(3, {"leaves": _tiny_leaves(), "meta": {}}, wait=True)
    assert mgr.latest_step() == 3


def _saved(tmp_path, trainer):
    x, y = _xy(*_batch())
    trainer.step(x, y)
    elastic.save_trainer(elastic.SnapshotManager(str(tmp_path)), trainer, wait=True)
    return str(tmp_path)


def test_architecture_and_optimizer_mismatch_rejected(tmp_path):
    d = _saved(tmp_path, _bert_trainer("sgd"))

    def other():
        net = mt.gluon.nn.Dense(4, in_units=16)
        net.initialize(ctx=mt.cpu())
        return DataParallelTrainer(net, mt.gluon.loss.SoftmaxCrossEntropyLoss(), "sgd",
                                   {"learning_rate": 0.1}, mesh=_cpu_mesh())

    with pytest.raises(MXNetError, match="parameters"):
        elastic.resume_or_init(d, other)
    with pytest.raises(MXNetError, match="optimizer"):
        elastic.resume_or_init(d, lambda: _bert_trainer("adam"))
    with pytest.raises(MXNetError, match="zero_update"):
        elastic.resume_or_init(d, lambda: _bert_trainer("sgd", zero=True))
    wide = dict(CFG, hidden_size=256)

    def narrower():
        net = BertModel(**wide)
        net.initialize(ctx=mt.cpu())
        return DataParallelTrainer(net, mt.gluon.loss.SoftmaxCrossEntropyLoss(), "sgd",
                                   {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4},
                                   mesh=_cpu_mesh())

    with pytest.raises(MXNetError, match="architecture mismatch"):
        elastic.resume_or_init(d, narrower)


def test_weight_decay_lane_mismatch_rejected(tmp_path):
    d = _saved(tmp_path, _bert_trainer(zero=True, params={"learning_rate": 1e-3, "wd": 0.01}))
    with pytest.raises(MXNetError, match=r"weight-decay lane \(0.01\) differs from the trainer's \(0\)"):
        elastic.resume_or_init(d, lambda: _bert_trainer(zero=True))


def test_foreign_rng_leaf_refused_and_port_rng_restored(tmp_path, ref):
    mt.random.seed(42)
    gen = mt.random.generator(mt.cpu())
    torch.rand(3, generator=gen)
    d = _saved(tmp_path, _bert_trainer())
    after = torch.rand(4, generator=gen)
    mt.random.seed(1)
    _, tr, _, _ = elastic.resume_or_init(d, lambda: _bert_trainer())
    assert torch.equal(torch.rand(4, generator=mt.random.generator(mt.cpu())), after)
    import jax
    raw = np.asarray(jax.random.key_data(jax.random.PRNGKey(0)))
    with elastic.SnapshotReader(d, 1) as rd:
        with pytest.raises(MXNetError, match="threefry"):
            es.install(tr, rd.manifest["meta"], lambda n: raw if n == "rng" else rd(n),
                       rd.names)


def test_pipeline_kind_and_coordinator_refused(tmp_path):
    """A ``pp`` snapshot does not install into a dp trainer; with a
    coordinator the entry points take it, and a coordinated resume refuses a
    manifest without a commit fence (one a pre-coordinator writer made)."""
    with pytest.raises(MXNetError, match="pipeline"):
        es.install(_bert_trainer(), {"kind": "pp"}, {}.__getitem__, set())
    from mxnet_tpu_torch.elastic.coordinator import Coordinator
    coord = Coordinator(str(tmp_path), 0, lease_timeout=30.0)
    coord.join()
    assert elastic.SnapshotManager(str(tmp_path), coordinator=coord).coordinator is coord
    sdir = _manifest.step_path(str(tmp_path), 1)
    _manifest.write_shard(sdir, 0, [("w", [(0, 2)], np.zeros(2, np.float32), (2,),
                                    np.float32)])
    man = _manifest.commit(sdir, 1, {"step": 1})
    man["fence"] = None
    with open(os.path.join(sdir, _manifest.MANIFEST), "w") as f:
        json.dump(man, f)
    with pytest.raises(MXNetError, match="coordinator"):
        elastic.resume_or_init(str(tmp_path), lambda: None, coordinator=coord)
    coord.leave()


def test_duck_typed_hooks(tmp_path):
    class Toy:
        def __init__(self):
            self.w = np.zeros(3, np.float32)
            self._t = 0

        def elastic_state(self):
            return {"leaves": {"w": self.w}, "meta": {"kind": "toy", "step": self._t}}

        def elastic_install(self, meta, fetch, names):
            self.w[:] = fetch("w")
            self._t = meta["step"]

    toy = Toy()
    toy.w += 2.5
    toy._t = 4
    elastic.save_trainer(elastic.SnapshotManager(str(tmp_path)), toy, wait=True)
    _, toy2, start, outcome = elastic.resume_or_init(str(tmp_path), Toy)
    assert (start, outcome) == (4, "resumed") and np.array_equal(toy2.w, toy.w)


# -- the step fingerprint -----------------------------------------------------------------

def test_fingerprint_classifies_resumed_and_resharded(tmp_path):
    a, b = _bert_trainer(), _bert_trainer(weights=False, seed=2)
    assert a._program.fingerprint == b._program.fingerprint
    assert a._program.key_base[1] == b._program.key_base[1]
    assert _bert_trainer(params={"learning_rate": 2e-3})._program.fingerprint != \
        a._program.fingerprint
    assert _bert_trainer(dtype="bfloat16")._program.fingerprint != a._program.fingerprint
    d = _saved(tmp_path, a)
    assert elastic.resume_or_init(d, lambda: _bert_trainer(params={
        "learning_rate": 2e-3}))[3] == "resharded"
    assert elastic.resume_or_init(d, lambda: _bert_trainer(
        mesh=make_mesh({"dp": 1, "sp": 1}, devices=[mt.cpu()])))[3] == "resharded"
    assert elastic.resume_or_init(d, _bert_trainer)[3] == "resumed"


# -- preemption and real signals ---------------------------------------------------------

def test_preemption_guard_sets_flag_and_restores_handlers():
    prev = signal.getsignal(signal.SIGTERM)
    with elastic.PreemptionGuard() as g:
        assert not g.triggered
        os.kill(os.getpid(), signal.SIGTERM)
        assert g.triggered
    assert signal.getsignal(signal.SIGTERM) is prev


class _Feed:
    """A feed with a cursor (``state_dict``) and epochs (``reset``)."""

    def __init__(self, n=4):
        self.n, self.pos, self.epoch = n, 0, 0

    def __iter__(self):
        while self.pos < self.n:
            self.pos += 1
            yield _xy(*_batch(seed=self.pos))

    def reset(self):
        self.pos, self.epoch = 0, self.epoch + 1

    def state_dict(self):
        return {"pos": self.pos, "epoch": self.epoch}

    def load_state_dict(self, d):
        self.pos, self.epoch = d["pos"], d["epoch"]


def test_run_feed_cursor_and_resume(tmp_path):
    ref_feed = _Feed()
    ref = elastic.run(_bert_trainer(), ref_feed, num_steps=7, directory=str(tmp_path / "r"))
    ref_losses = [float(v) for v in ref["losses"]]
    assert ref["step"] == 7 and ref_feed.epoch == 1
    feed = _Feed()
    out = elastic.run(_bert_trainer(), feed, num_steps=5, directory=str(tmp_path / "k"),
                      save_every=2)
    assert out["step"] == 5 and _manifest.all_complete_steps(str(tmp_path / "k")) == [2, 4, 5]
    feed2 = _Feed()
    mgr, tr, start, outcome = elastic.resume_or_init(str(tmp_path / "k"), _bert_trainer,
                                                     feed=feed2)
    assert (start, outcome, feed2.state_dict()) == (5, "resumed", {"pos": 1, "epoch": 1})
    out2 = elastic.run(tr, feed2, num_steps=7, manager=mgr)
    np.testing.assert_allclose([float(v) for v in out2["losses"]], ref_losses[5:],
                               rtol=TOL_RESUME, atol=1e-7)


def child_train(directory, num_steps, save_every, losses_path):
    """A subprocess's training run (SIGKILL/SIGTERM tests)."""
    x, y = _xy(*_batch())
    mgr, tr, start, outcome = elastic.resume_or_init(directory, _bert_trainer,
                                                     save_interval_steps=save_every)
    with open(losses_path, "a") as f:
        res = elastic.run(tr, [(x, y)] * num_steps, num_steps=num_steps, manager=mgr,
                          on_step=lambda t, loss: f.write(f"{t} {float(loss)!r}\n") or
                          f.flush())
    print(json.dumps({"start": start, "outcome": outcome, "step": res["step"],
                      "preempted": res["preempted"]}))


def _child(directory, num_steps, save_every, losses_path):
    code = (f"import sys; sys.path.insert(0, {TESTS_DIR!r}); import {MODULE} as t; "
            f"t.child_train({directory!r}, {num_steps}, {save_every}, {losses_path!r})")
    env = dict(os.environ, OMP_NUM_THREADS="2")
    return subprocess.Popen([sys.executable, "-c", code], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, env=env)


def _lines(path):
    if not os.path.exists(path):
        return []
    with open(path) as f:
        return [ln.split() for ln in f if ln.endswith("\n")]


def _wait_for(cond, proc, timeout=120):
    deadline = time.monotonic() + timeout
    while not cond():
        if proc.poll() is not None:
            raise AssertionError(f"the child exited ({proc.returncode}): "
                                 f"{proc.stderr.read()[-2000:]}")
        if time.monotonic() > deadline:
            proc.kill()
            raise AssertionError("the child took too long")
        time.sleep(0.01)


def test_sigkill_then_resume_and_sigterm_final_snapshot(tmp_path):
    x, y = _xy(*_batch())
    ref_tr = _bert_trainer()
    ref_losses = [float(ref_tr.step(x, y)) for _ in range(6)]
    d = str(tmp_path / "kill")
    proc = _child(d, 50, 2, str(tmp_path / "kill.losses"))
    _wait_for(lambda: _manifest.latest_complete_step(d) == 4, proc)
    proc.send_signal(signal.SIGKILL)
    proc.wait()
    assert proc.returncode == -signal.SIGKILL
    latest = _manifest.latest_complete_step(d)
    assert latest is not None and latest >= 4
    _, tr, start, outcome = elastic.resume_or_init(d, _bert_trainer)
    assert (start, outcome) == (latest, "resumed")
    if start < 6:
        got = [float(tr.step(x, y)) for _ in range(6 - start)]
        np.testing.assert_allclose(got, ref_losses[start:], rtol=TOL_RESUME, atol=1e-7)
    d2 = str(tmp_path / "term")
    proc = _child(d2, 500, 0, str(tmp_path / "term.losses"))
    _wait_for(lambda: len(_lines(str(tmp_path / "term.losses"))) >= 2, proc)
    proc.send_signal(signal.SIGTERM)
    out, err = proc.communicate(timeout=120)
    assert proc.returncode == 0, err[-2000:]
    res = json.loads(out.strip().splitlines()[-1])
    assert res["preempted"] and res["outcome"] == "fresh" and res["step"] >= 2
    assert _manifest.all_complete_steps(d2) == [res["step"]]
    ran = [float(v) for _, v in _lines(str(tmp_path / "term.losses"))]
    np.testing.assert_allclose(ran[:2], ref_losses[:2], rtol=TOL_RESUME, atol=1e-7)
