"""The port's fault-injection plane and the elastic IO it hardens, against the reference's.

``mxnet_tpu_torch.faults`` and ``mxnet_tpu_torch.elastic.manifest`` against
``mxnet_tpu.faults`` and ``mxnet_tpu.elastic.manifest``, the counterparts of
the tests of ``tests/test_faults.py`` that concern them:

- schedules: the same fire patterns attempt by attempt as the reference's
  (``every_nth``, ``first_k``, and ``p:P:seedS``, whose private stream gives
  the same bits in both packages), the spec grammar and its errors, the
  ``MXNET_TPU_FAULTS`` environment, the catalog of threaded points and the
  counters;
- ``io_retry``: transient failures (``OSError``, injected faults) retried
  within the budget, under each of the reference's schedules with the same
  outcome and the same number of calls and fires as the reference's
  ``io_retry``; the full-jitter backoff's caps; a non-transient
  ``MXNetError`` never retried;
- the manifest: fence token and lease release, a shard write through an
  injected fault, a commit fault that exhausts its budget and releases the
  lease, a torn shard, two committers racing (exactly one wins), a stale
  lease taken over with an incremented token, a live lease fencing out a
  second writer, prune sparing a directory a live writer is in;
- the port's fused step resumed from a snapshot written through injected
  shard-write and read faults, replaying the uninterrupted losses
  (rtol 1e-6, the reference's), and an interval snapshot that fails, warns
  and lets training go on.

Everything is exact (schedules are deterministic, snapshots bitwise) but
the resumed losses, held at the reference's rtol 1e-6.
"""
import json
import os
import threading
import time

import numpy as np
import pytest

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import elastic, faults
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.elastic import manifest as _manifest
from mxnet_tpu_torch.parallel import DataParallelTrainer, make_mesh
from torch_threads import one_torch_thread  # noqa: F401

SPECS = ["every_nth:1", "every_nth:3", "first_k:0", "first_k:2", "p:0.4:seed11",
         "p:0.9:seed3"]


@pytest.fixture(autouse=True)
def _clean_plane():
    faults.clear()
    yield
    faults.clear()


@pytest.fixture(scope="module")
def ref():
    from mxnet_tpu import faults as ref_faults
    from mxnet_tpu.base import MXNetError as RefError
    from mxnet_tpu.elastic import manifest as ref_manifest
    return ref_faults, ref_manifest, RefError


# -- schedules ---------------------------------------------------------------------

@pytest.mark.parametrize("spec", SPECS)
def test_schedules_fire_as_the_reference(ref, spec):
    ref_faults = ref[0]
    mine, theirs = faults.parse_schedule(spec), ref_faults.parse_schedule(spec)
    assert mine.spec() == theirs.spec()
    assert [mine.fires(i) for i in range(1, 201)] == [theirs.fires(i) for i in range(1, 201)]


def test_schedule_fire_patterns():
    nth = faults.EveryNth(3)
    assert [nth.fires(i) for i in range(1, 7)] == [False, False, True, False, False, True]
    fk = faults.FirstK(2)
    assert [fk.fires(i) for i in range(1, 5)] == [True, True, False, False]
    assert not faults.FirstK(0).fires(1)


def test_seeded_probability_replays_exactly():
    a = faults.SeededProbability(0.4, seed=11)
    b = faults.SeededProbability(0.4, seed=11)
    seq_a = [a.fires(i) for i in range(1, 101)]
    assert seq_a == [b.fires(i) for i in range(1, 101)]
    assert any(seq_a) and not all(seq_a)
    c = faults.SeededProbability(0.4, seed=12)
    assert [c.fires(i) for i in range(1, 101)] != seq_a


@pytest.mark.parametrize("bad", ["nope", "every_nth", "every_nth:x", "first_k:-1",
                                 "p:1.5", ""])
def test_parse_schedule_errors_as_the_reference(ref, bad):
    with pytest.raises(MXNetError):
        faults.parse_schedule(bad)
    with pytest.raises(ref[2]):
        ref[0].parse_schedule(bad)


def test_parse_spec_multi_point_and_duplicates(ref):
    spec = "elastic.write_shard=first_k:1; elastic.read=every_nth:3"
    pairs = faults.parse_spec(spec)
    assert [(p, s.spec()) for p, s in pairs] == [("elastic.write_shard", "first_k:1"),
                                                 ("elastic.read", "every_nth:3")]
    assert [(p, s.spec()) for p, s in pairs] == \
        [(p, s.spec()) for p, s in ref[0].parse_spec(spec)]
    with pytest.raises(MXNetError, match="twice"):
        faults.parse_spec("a=first_k:1;a=first_k:2")
    with pytest.raises(MXNetError):
        faults.parse_spec("just-a-point")


def test_env_spec_arms_the_plane(monkeypatch):
    monkeypatch.setenv("MXNET_TPU_FAULTS", "elastic.read=first_k:2;elastic.commit=every_nth:5")
    faults.install_from_env()
    assert faults.armed() == {"elastic.read": "first_k:2", "elastic.commit": "every_nth:5"}
    monkeypatch.setenv("MXNET_TPU_FAULTS", "elastic.read=bogus")
    with pytest.raises(MXNetError):
        faults.install_from_env()


def test_catalog_covers_every_threaded_point(ref):
    cat = faults.points()
    for point in ("elastic.write_shard", "elastic.commit", "elastic.read"):
        assert point in cat and cat[point], point
        assert point in ref[0].points()


def test_off_by_default_and_counting():
    assert faults._ACTIVE is False and faults.armed() == {}
    faults.check("elastic.read")   # disarmed: counts, never raises
    with faults.injected("elastic.read", faults.EveryNth(2)):
        assert faults._ACTIVE is True
        fired = 0
        for _ in range(4):
            try:
                faults.check("elastic.read")
            except faults.FaultInjected as e:
                assert e.point == "elastic.read"
                fired += 1
        assert fired == 2
        assert faults.fired("elastic.read") == 2
        assert faults.attempts("elastic.read") == 5
    assert faults._ACTIVE is False


# -- io_retry ----------------------------------------------------------------------

def test_io_retry_absorbs_transient_oserror():
    calls = []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise OSError("disk hiccup")
        return "ok"

    assert faults.io_retry("elastic.read", flaky, retries=3, backoff=0.0) == "ok"
    assert len(calls) == 3


def test_io_retry_exhausts_budget():
    def always():
        raise OSError("dead disk")
    with pytest.raises(OSError):
        faults.io_retry("elastic.read", always, retries=1, backoff=0.0)


def test_io_retry_never_retries_permanent_mxnet_error():
    calls = []

    def fenced():
        calls.append(1)
        raise MXNetError("commit fenced out")

    with pytest.raises(MXNetError, match="fenced"):
        faults.io_retry("elastic.commit", fenced, retries=5, backoff=0.0)
    assert len(calls) == 1


def test_io_retry_absorbs_injected_faults():
    calls = []
    with faults.injected("elastic.read", faults.FirstK(2)):
        out = faults.io_retry("elastic.read", lambda: calls.append(1) or 7, retries=3,
                              backoff=0.0)
    assert out == 7 and len(calls) == 1
    assert faults.fired("elastic.read") == 2


def _retry_run(plane, spec, retries):
    """(outcome, calls, fires, attempts) of io_retry under ``spec``."""
    plane.clear()
    calls = []
    with plane.injected("elastic.write_shard", spec):
        try:
            outcome = plane.io_retry("elastic.write_shard", lambda: calls.append(1) or "ok",
                                     retries=retries, backoff=0.0)
        except plane.FaultInjected as e:
            outcome = f"raised at attempt {e.attempt}"
    return outcome, len(calls), plane.fired("elastic.write_shard"), \
        plane.attempts("elastic.write_shard")


@pytest.mark.parametrize("spec", SPECS)
@pytest.mark.parametrize("retries", [0, 2, 5])
def test_io_retry_under_the_reference_schedules(ref, spec, retries):
    ref_faults = ref[0]
    try:
        assert _retry_run(faults, spec, retries) == _retry_run(ref_faults, spec, retries)
    finally:
        ref_faults.clear()


def test_io_retry_backoff_is_capped_full_jitter(monkeypatch):
    """The k-th retry sleeps uniform(0, min(cap, base * 2**(k-1)))."""
    monkeypatch.setenv("MXNET_TPU_IO_BACKOFF_MAX", "0.3")
    bounds = []
    monkeypatch.setattr(faults.random, "uniform", lambda a, b: bounds.append((a, b)) or 0.0)
    monkeypatch.setattr(faults.time, "sleep", lambda s: None)
    with faults.injected("elastic.read", faults.FirstK(5)):
        assert faults.io_retry("elastic.read", lambda: 3, retries=5, backoff=0.05) == 3
    assert bounds == [(0, 0.05), (0, 0.1), (0, 0.2), (0, 0.3), (0, 0.3)]


# -- the manifest --------------------------------------------------------------------

def _entries(seed=0):
    rs = np.random.RandomState(seed)
    arr = rs.uniform(-1, 1, (4, 3)).astype(np.float32)
    return arr, [("w", [(0, 4), (0, 3)], arr, arr.shape, arr.dtype)]


def test_clean_cycle_fence_token_and_lease_release(tmp_path, ref):
    sdir = _manifest.step_path(str(tmp_path), 3)
    arr, entries = _entries()
    _manifest.write_shard(sdir, 0, entries)
    man = _manifest.commit(sdir, 3, {"step": 3})
    assert man["fence"] == 1
    assert not (tmp_path / "step-00000003" / _manifest.LEASE).exists()
    with _manifest.SnapshotReader(str(tmp_path), 3) as rd:
        np.testing.assert_array_equal(rd("w"), arr)
    with ref[1].SnapshotReader(str(tmp_path), 3) as rd:
        np.testing.assert_array_equal(rd("w"), arr)


def test_write_shard_recovers_from_injected_fault(tmp_path, monkeypatch):
    monkeypatch.setenv("MXNET_TPU_IO_BACKOFF", "0.001")
    sdir = _manifest.step_path(str(tmp_path), 1)
    arr, entries = _entries(1)
    with faults.injected("elastic.write_shard", faults.FirstK(1)):
        _manifest.write_shard(sdir, 0, entries)
        _manifest.commit(sdir, 1, {"step": 1})
    assert faults.fired("elastic.write_shard") == 1
    assert _manifest.latest_complete_step(str(tmp_path)) == 1
    with _manifest.SnapshotReader(str(tmp_path), 1) as rd:
        np.testing.assert_array_equal(rd("w"), arr)


def test_commit_fault_exhausts_and_releases_lease(tmp_path, monkeypatch):
    monkeypatch.setenv("MXNET_TPU_IO_RETRIES", "1")
    monkeypatch.setenv("MXNET_TPU_IO_BACKOFF", "0.001")
    sdir = _manifest.step_path(str(tmp_path), 2)
    _, entries = _entries(2)
    _manifest.write_shard(sdir, 0, entries)
    with faults.injected("elastic.commit", faults.EveryNth(1)):
        with pytest.raises(faults.FaultInjected):
            _manifest.commit(sdir, 2, {"step": 2})
    assert _manifest.latest_complete_step(str(tmp_path)) is None
    assert not (tmp_path / "step-00000002" / _manifest.LEASE).exists()
    assert _manifest.commit(sdir, 2, {"step": 2})["fence"] == 1


def test_truncated_shard_crash_sim(tmp_path):
    for step in (1, 2):
        sdir = _manifest.step_path(str(tmp_path), step)
        _, entries = _entries(step)
        _manifest.write_shard(sdir, 0, entries)
        if step == 1:
            _manifest.commit(sdir, 1, {"step": 1})
    shard = tmp_path / "step-00000002" / "shard-00000.npz"
    shard.write_bytes(shard.read_bytes()[:16])     # a torn write
    assert _manifest.all_complete_steps(str(tmp_path)) == [1]
    _manifest.prune(str(tmp_path), max_to_keep=3)
    assert (tmp_path / "step-00000002").exists()   # newer than the newest commit: kept
    sdir3 = _manifest.step_path(str(tmp_path), 3)
    _, entries = _entries(3)
    _manifest.write_shard(sdir3, 0, entries)
    _manifest.commit(sdir3, 3, {"step": 3})
    _manifest.prune(str(tmp_path), max_to_keep=3)
    assert not (tmp_path / "step-00000002").exists()
    assert _manifest.all_complete_steps(str(tmp_path)) == [1, 3]


def test_two_writer_commit_race_exactly_one_wins(tmp_path):
    sdir = _manifest.step_path(str(tmp_path), 7)
    _, entries = _entries(7)
    _manifest.write_shard(sdir, 0, entries)
    barrier = threading.Barrier(2)
    outcomes = {}

    def committer(tag):
        barrier.wait()
        try:
            outcomes[tag] = ("won", _manifest.commit(sdir, 7, {"step": 7}))
        except MXNetError as e:
            outcomes[tag] = ("lost", str(e))

    threads = [threading.Thread(target=committer, args=(t,)) for t in ("a", "b")]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert sorted(v[0] for v in outcomes.values()) == ["lost", "won"], outcomes
    loser = next(v[1] for v in outcomes.values() if v[0] == "lost")
    assert "race" in loser or "fence" in loser or "already committed" in loser
    man = _manifest.load(str(tmp_path), 7)
    assert man["step"] == 7 and man["fence"] >= 1


def test_stale_lease_takeover_increments_fence(tmp_path):
    sdir = _manifest.step_path(str(tmp_path), 4)
    _, entries = _entries(4)
    _manifest.write_shard(sdir, 0, entries)
    with open(_manifest._lease_path(sdir), "w") as f:
        json.dump({"owner": "dead-proc", "token": 5, "ts": time.time() - 1000.0}, f)
    assert _manifest.commit(sdir, 4, {"step": 4}, lease_timeout=1.0)["fence"] == 6


def test_fresh_lease_holder_fences_out_second_writer(tmp_path):
    sdir = _manifest.step_path(str(tmp_path), 5)
    _, entries = _entries(5)
    _manifest.write_shard(sdir, 0, entries)
    with open(_manifest._lease_path(sdir), "w") as f:
        json.dump({"owner": "live-proc", "token": 1, "ts": time.time()}, f)
    with pytest.raises(MXNetError, match="lost the race"):
        _manifest.commit(sdir, 5, {"step": 5}, lease_timeout=30.0)
    assert not (tmp_path / "step-00000005" / _manifest.MANIFEST).exists()


def test_prune_skips_dirs_a_live_writer_is_in(tmp_path):
    root = str(tmp_path)
    for step in (1, 5):
        sdir = _manifest.step_path(root, step)
        _, entries = _entries(step)
        _manifest.write_shard(sdir, 0, entries)
        _manifest.commit(sdir, step, {"step": step})
    sdir3 = _manifest.step_path(root, 3)
    _, entries = _entries(3)
    _manifest.write_shard(sdir3, 0, entries)
    marker = tmp_path / "step-00000003" / "ready-00001.json"
    marker.write_text(json.dumps({"rank": 1, "step": 3, "ts": time.time()}))
    _manifest.prune(root, max_to_keep=1)
    assert (tmp_path / "step-00000003").exists()
    assert not (tmp_path / "step-00000001").exists()
    assert _manifest.all_complete_steps(root) == [5]
    marker.write_text(json.dumps({"rank": 1, "step": 3, "ts": time.time() - 3600.0}))
    _manifest.prune(root, max_to_keep=1)
    assert not (tmp_path / "step-00000003").exists()
    sdir4 = _manifest.step_path(root, 4)
    _, entries = _entries(4)
    _manifest.write_shard(sdir4, 0, entries)
    _manifest._write_lease_to(os.path.join(sdir4, _manifest.LEASE), "live-committer", 1)
    _manifest.prune(root, max_to_keep=1)
    assert (tmp_path / "step-00000004").exists()


# -- the fused step through injected faults -----------------------------------------------

def _mlp_trainer(seed=7):
    mt.random.seed(seed)
    net = mt.gluon.nn.HybridSequential()
    net.add(mt.gluon.nn.Dense(32, in_units=16), mt.gluon.nn.Activation("relu"),
            mt.gluon.nn.Dense(4, in_units=32))
    net.initialize(ctx=mt.cpu())
    return DataParallelTrainer(net, mt.gluon.loss.SoftmaxCrossEntropyLoss(), "adam",
                               {"learning_rate": 0.01},
                               mesh=make_mesh({"dp": 1}, devices=[mt.cpu()]))


def _mlp_batch(seed=0, n=16):
    rs = np.random.RandomState(seed)
    return (mt.nd.array(rs.uniform(-1, 1, (n, 16)).astype(np.float32), ctx=mt.cpu()),
            mt.nd.array(rs.randint(0, 4, (n,)), ctx=mt.cpu(), dtype="int32"))


def test_kill_resume_parity_under_injected_write_faults(tmp_path, monkeypatch):
    monkeypatch.setenv("MXNET_TPU_IO_BACKOFF", "0.001")
    x, y = _mlp_batch()
    ref_tr = _mlp_trainer()
    ref_losses = [float(ref_tr.step(x, y)) for _ in range(10)]
    tr = _mlp_trainer()
    for _ in range(5):
        tr.step(x, y)
    mgr = elastic.SnapshotManager(str(tmp_path))
    with faults.injected("elastic.write_shard", faults.FirstK(1)):
        elastic.save_trainer(mgr, tr, wait=True)
    assert faults.fired("elastic.write_shard") == 1
    assert mgr.latest_step() == 5
    with faults.injected("elastic.read", faults.FirstK(1)):
        _, tr2, start, outcome = elastic.resume_or_init(str(tmp_path),
                                                        lambda: _mlp_trainer(seed=99))
    assert (start, outcome) == (5, "resumed")
    assert faults.fired("elastic.read") == 1
    got = [float(tr2.step(x, y)) for _ in range(5)]
    np.testing.assert_allclose(got, ref_losses[5:], rtol=1e-6, atol=1e-7)


def test_run_interval_snapshot_failure_warns_and_continues(tmp_path, monkeypatch):
    monkeypatch.setenv("MXNET_TPU_IO_RETRIES", "0")
    tr = _mlp_trainer()
    feed = [_mlp_batch(seed=i) for i in range(10)]
    with faults.injected("elastic.write_shard", faults.FirstK(1)):
        with pytest.warns(RuntimeWarning, match="interval snapshot"):
            out = elastic.run(tr, feed, num_steps=6, directory=str(tmp_path), save_every=2)
    assert out["step"] == 6 and not out["preempted"]
    # step 2's write failed in the background and surfaced at step 4's save,
    # which it skipped (as the reference's run does); the final one landed
    assert _manifest.all_complete_steps(str(tmp_path)) == [6]
