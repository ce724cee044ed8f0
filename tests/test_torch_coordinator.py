"""The multi-host control plane and its drills, against the reference's.

``mxnet_tpu_torch.elastic.coordinator`` and ``.drill`` against
``mxnet_tpu.elastic``'s, with real spawned processes over a shared directory
(``drill.run_drill``: pure-numpy float64 hosts, no process group):

- the five drill scenarios (clean then a resume onto another world size, a
  non-leader killed mid-run, the leader killed mid-commit, two hosts that
  both believe they lead, a straggler's marker past the deadline), each
  ending in exactly one valid generation-stamped manifest and a resume that
  replays the one-process trajectory exactly;
- ``reference_losses`` bitwise the reference's;
- a drill snapshot written by either package resumes in the other, and a
  coordinator directory written by the port's hosts is read by the
  reference's ``Coordinator.view()`` / ``validate_manifest``, and the reverse;
- ``HangWatchdog``'s flag mode, ``statusz_view``, ``owns``' partition, the
  coordinator's injection points, and ``SnapshotManager`` / ``resume_or_init``
  / ``run`` with ``coordinator=``.

Load: the reference's own drills failed under ``-n 6`` (their 1 s leases
expired while a loaded host stalled). Here every lease is 4-5 s, every
deadline scaled for a loaded 6-worker host, and each drill's processes are
joined within 180 s and killed after it. Trajectories are compared exactly
(float64, in place).
"""
import os
import time

import numpy as np
import pytest

from mxnet_tpu_torch import faults
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.elastic import drill
from mxnet_tpu_torch.elastic import manifest as _manifest
from mxnet_tpu_torch.elastic import coordinator as coord_mod
from mxnet_tpu_torch.elastic.coordinator import Coordinator, HangWatchdog, StragglerTimeout
from torch_threads import one_torch_thread  # noqa: F401

LEASE = 4.0
JOIN_S = 180.0
COMMON = dict(lease_timeout=LEASE, straggler_timeout=20.0, timeout=JOIN_S,
              rendezvous_timeout=120.0)


def _parity(reports, start, count=10):
    ref = drill.reference_losses(start + count)
    for rank, rep in sorted(reports.items()):
        got = [rep["losses"][str(t)] for t in range(start + 1, start + count + 1)]
        assert got == ref[start:start + count], (rank, got[:3], ref[start:start + 3])


def test_reference_losses_bitwise_the_reference():
    from mxnet_tpu.elastic import drill as ref_drill
    assert drill.reference_losses(25) == ref_drill.reference_losses(25)
    x, y = drill.toy_batch(7)
    rx, ry = ref_drill.toy_batch(7)
    assert np.array_equal(x, rx) and np.array_equal(y, ry)


def test_clean_run_then_resume_resharded(tmp_path):
    root = str(tmp_path)
    res = drill.run_drill(root, world=3, num_steps=8, save_every=4, report_tag="clean",
                          **COMMON)
    assert res["exitcodes"] == [0, 0, 0], res["exitcodes"]
    assert _manifest.all_complete_steps(root) == [4, 8]
    for rep in res["reports"].values():
        assert rep["outcome"] == "fresh" and rep["final_step"] == 8
        assert not rep["preempted"]
    man = _manifest.load(root, 8)
    assert man["meta"]["members"] == [0, 1, 2] and int(man["fence"]) >= 1
    res2 = drill.run_drill(root, world=2, num_steps=18, save_every=1000,
                           report_tag="resume", **COMMON)
    assert res2["exitcodes"] == [0, 0], res2["exitcodes"]
    for rep in res2["reports"].values():
        assert rep["outcome"] == "resharded" and rep["start"] == 8
        assert rep["final_step"] == 18
    _parity(res2["reports"], 8)


def test_kill_nonleader_mid_run_then_resume(tmp_path):
    root = str(tmp_path)
    res = drill.run_drill(root, world=3, num_steps=2000, save_every=50, report_tag="kill",
                          scenario={2: {"die_at_step": 5}}, step_sleep=0.03, **COMMON)
    assert res["exitcodes"][2] == 3, res["exitcodes"]
    assert res["exitcodes"][0] == 0 and res["exitcodes"][1] == 0, res["exitcodes"]
    r0, r1 = res["reports"][0], res["reports"][1]
    assert r0["preempted"] and r1["preempted"]
    assert r0["stop"]["reason"] == "peer_dead"
    assert r0["final_step"] == r1["final_step"]
    s = r0["final_step"]
    assert s < 2000 and s in _manifest.all_complete_steps(root)
    assert _manifest.load(root, s)["meta"]["members"] == [0, 1]
    res2 = drill.run_drill(root, world=2, num_steps=s + 10, save_every=1000,
                           report_tag="resume", **COMMON)
    assert res2["exitcodes"] == [0, 0], res2["exitcodes"]
    for rep in res2["reports"].values():
        assert not rep["preempted"], rep["stop"]
        assert rep["final_step"] == s + 10
    _parity(res2["reports"], s)


def test_kill_leader_mid_commit_then_resume(tmp_path):
    root = str(tmp_path)
    res = drill.run_drill(root, world=3, num_steps=2000, save_every=4,
                          report_tag="killlead", scenario={0: {"die_in_commit_step": 4}},
                          step_sleep=0.03, **COMMON)
    assert res["exitcodes"][0] == 40, res["exitcodes"]
    assert res["exitcodes"][1] == 0 and res["exitcodes"][2] == 0, res["exitcodes"]
    r1, r2 = res["reports"][1], res["reports"][2]
    assert r1["preempted"] and r2["preempted"]
    assert r1["final_step"] == r2["final_step"]
    s = r1["final_step"]
    steps = _manifest.all_complete_steps(root)
    assert s in steps, (s, steps)
    assert _manifest.load(root, s)["meta"]["members"] == [1, 2]
    if 4 in steps:
        man4 = _manifest.load(root, 4)
        assert int(man4["fence"]) >= 2, (man4["fence"], man4["meta"])
        assert set(man4["meta"]["members"]) in ({0, 1, 2}, {1, 2})
    res2 = drill.run_drill(root, world=2, num_steps=s + 10, save_every=1000,
                           report_tag="resume", **COMMON)
    assert res2["exitcodes"] == [0, 0], res2["exitcodes"]
    _parity(res2["reports"], s)


def test_commit_race_exactly_one_manifest(tmp_path):
    root = str(tmp_path)
    res = drill.run_drill(root, world=2, num_steps=12, save_every=4, report_tag="race",
                          force_leader=True, **COMMON)
    assert res["exitcodes"] == [0, 0], res["exitcodes"]
    steps = _manifest.all_complete_steps(root)
    assert steps == [4, 8, 12], steps
    for s in steps:
        assert _manifest.load(root, s)["meta"]["members"] == [0, 1]
        names = [n for n in os.listdir(_manifest.step_path(root, s))
                 if n.startswith("manifest")]
        assert names == [_manifest.MANIFEST], names
    _parity(res["reports"], 0, count=12)


def test_straggler_timeout_aborts_then_recovers(tmp_path):
    """Rank 1 posts its final marker 3 s late; the 2 s commit deadline
    aborts rank 0's barrier (no manifest hole), and the final save's retry
    commits once the marker lands."""
    root = str(tmp_path)
    res = drill.run_drill(root, world=2, num_steps=6, save_every=1000, report_tag="strag",
                          scenario={1: {"marker_delay": (6, 3.0)}}, lease_timeout=5.0,
                          straggler_timeout=2.0, timeout=JOIN_S, rendezvous_timeout=120.0)
    assert res["exitcodes"] == [0, 0], res["exitcodes"]
    assert sum(rep["straggler_aborts"] for rep in res["reports"].values()) >= 1
    assert 6 in _manifest.all_complete_steps(root)


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_drill_snapshot_resumes_in_the_other_package(tmp_path, writer):
    from mxnet_tpu.elastic import drill as ref_drill
    root = str(tmp_path)
    first, second = (drill, ref_drill) if writer == "port" else (ref_drill, drill)
    kw = dict(lease_timeout=LEASE, straggler_timeout=20.0, timeout=JOIN_S)
    res = first.run_drill(root, world=2, num_steps=4, save_every=4, report_tag="w",
                          **(kw if first is ref_drill else COMMON))
    assert res["exitcodes"] == [0, 0], res["exitcodes"]
    assert _manifest.load(root, 4)["meta"]["members"] == [0, 1]
    res2 = second.run_drill(root, world=2, num_steps=14, save_every=1000, report_tag="r",
                            **(kw if second is ref_drill else COMMON))
    assert res2["exitcodes"] == [0, 0], res2["exitcodes"]
    for rep in res2["reports"].values():
        assert rep["start"] == 4 and rep["outcome"] == "resumed"
    _parity(res2["reports"], 4)


def test_coordinator_directory_read_across_packages(tmp_path):
    """The port's hosts' files read by the reference's ``view()`` and
    ``validate_manifest``, and the reverse."""
    from mxnet_tpu.elastic.coordinator import Coordinator as RefCoordinator
    root = str(tmp_path)
    port = Coordinator(root, 0, lease_timeout=30.0)
    ref = RefCoordinator(root, 1, lease_timeout=30.0)
    port.join()
    ref.join()
    port.heartbeat(step=3, force=True)
    ref.heartbeat(step=5, force=True)
    for c in (port, ref):
        v = c.view(bump=False)
        assert v.live == [0, 1] and v.leader == 0
        assert v.as_dict()["steps"] == {"0": 3, "1": 5}
    assert port.view(bump=False).generation == ref.view(bump=False).generation == 2
    # a two-phase commit: the port's marker and the reference's, the port leads
    sdir = _manifest.step_path(root, 7)
    os.makedirs(sdir)
    for rank in (0, 1):
        _manifest.write_shard(sdir, rank, [(f"leaf{rank}", [(0, 2)],
                                            np.arange(2.0) + rank, (2,), np.float64)])
    port.write_marker(sdir, 7, 16)
    ref.write_marker(sdir, 7, 16)
    man = port.commit_snapshot(sdir, 7, {"step": 7})
    assert man["meta"]["members"] == [0, 1] and man["meta"]["generation"] == 2
    ref.validate_manifest(_manifest.load(root, 7), 7)
    port.validate_manifest(_manifest.load(root, 7), 7)
    # the owner partition agrees leaf by leaf
    for name in ("param.0", "param.1", "opt.m", "rng"):
        assert port.owns(name) != ref.owns(name)
    # a tampered manifest is refused by both
    bad = dict(man, fence=0)
    for c in (port, ref):
        with pytest.raises(Exception, match="fence"):
            c.validate_manifest(bad, 7)
    ref.leave()
    port.leave()
    assert Coordinator(root, 2).view(bump=False).live == []


def test_hang_watchdog_flag_mode():
    with HangWatchdog(0.05, what="drain", action="flag") as wd:
        time.sleep(0.2)
    assert wd.fired
    with HangWatchdog(5.0, what="drain", action="flag") as wd2:
        pass
    assert not wd2.fired


def test_statusz_view_and_injection_points(tmp_path):
    c = Coordinator(str(tmp_path), 3, lease_timeout=30.0)
    c.join()
    d = coord_mod.statusz_view()
    assert d["rank"] == 3 and d["live"] == [3] and d["leader"] == 3
    for point in ("elastic.heartbeat", "elastic.barrier", "elastic.marker"):
        assert point in faults.points()
    with faults.injected("elastic.heartbeat", "first_k:99"):
        assert c.heartbeat(step=1, force=True) is False
    assert c.heartbeat(step=2, force=True) is True
    c.leave()


def test_straggler_abort_leaves_no_manifest(tmp_path):
    root = str(tmp_path)
    a = Coordinator(root, 0, lease_timeout=30.0, straggler_timeout=0.3)
    b = Coordinator(root, 1, lease_timeout=30.0)
    a.join()
    b.join()
    sdir = _manifest.step_path(root, 2)
    os.makedirs(sdir)
    a.write_marker(sdir, 2, 0)
    with pytest.raises(StragglerTimeout, match="missing ready markers from ranks \\[1\\]"):
        a.commit_snapshot(sdir, 2, {"step": 2})
    assert a.straggler_aborts == 1
    assert not os.path.exists(os.path.join(sdir, _manifest.MANIFEST))


def test_coordinated_stop_resolves_to_the_largest_ack(tmp_path):
    root = str(tmp_path)
    a = Coordinator(root, 0, lease_timeout=30.0, straggler_timeout=10.0)
    b = Coordinator(root, 1, lease_timeout=30.0, straggler_timeout=10.0)
    a.join()
    b.join()
    a.view()
    b.view()
    stop = a.post_stop(5, reason="preempted")
    assert b.step_poll(7)["id"] == stop["id"]
    import threading
    out = {}
    t = threading.Thread(target=lambda: out.setdefault("b", b.resolve_stop(7)))
    t.start()
    out["a"] = a.resolve_stop(5)
    t.join(30)
    assert out == {"a": 7, "b": 7}


def test_elastic_entry_points_take_a_coordinator(tmp_path):
    """``SnapshotManager`` / ``resume_or_init`` / ``run`` with one host's
    coordinator: a coordinated snapshot and a resume validated by it."""
    from mxnet_tpu_torch import elastic
    root = str(tmp_path)
    c = Coordinator(root, 0, lease_timeout=30.0, partition_ownership=True)
    c.join()
    mgr, tr, start, outcome = elastic.resume_or_init(root, drill.ToyTrainer, coordinator=c)
    assert (start, outcome) == (0, "fresh") and mgr.coordinator is c
    feed = drill.ToyFeed()
    res = elastic.run(tr, feed, 6, manager=mgr, save_every=3, coordinator=c)
    assert res["step"] == 6 and not res["preempted"]
    assert _manifest.all_complete_steps(root) == [3, 6]
    assert _manifest.load(root, 6)["meta"]["members"] == [0]
    _, tr2, start2, outcome2 = elastic.resume_or_init(root, drill.ToyTrainer, coordinator=c)
    assert (start2, outcome2) == (6, "resumed")
    for p, q in zip(tr.params, tr2.params):
        assert np.array_equal(p, q)
    c.leave()
    # a manifest with no fence is refused on a coordinated resume
    man_path = os.path.join(_manifest.step_path(root, 6), _manifest.MANIFEST)
    import json
    with open(man_path) as f:
        man = json.load(f)
    man["fence"] = 0
    with open(man_path, "w") as f:
        json.dump(man, f)
    c2 = Coordinator(root, 0, lease_timeout=30.0)
    c2.join()
    with pytest.raises(MXNetError, match="fence"):
        elastic.resume_or_init(root, drill.ToyTrainer, coordinator=c2)
    c2.leave()


def test_control_plane_worker(tmp_path, monkeypatch):
    monkeypatch.setenv("MXNET_TPU_RANK", "0")
    monkeypatch.setenv("MXNET_TPU_NUM_WORKERS", "1")
    assert drill.control_plane_worker(str(tmp_path), beats=2) == 0
    assert os.path.exists(tmp_path / "ok_0")
    assert drill._main(["--control-plane", "--root", str(tmp_path), "--beats", "1"]) == 0
