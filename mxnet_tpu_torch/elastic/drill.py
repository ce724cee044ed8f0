"""Real multi-process drills of the multi-host control plane.

Counterpart of ``mxnet_tpu/elastic/drill.py``. ``run_drill`` spawns N
processes (``multiprocessing``'s spawn start method, never fork, so a parent
that has touched CUDA is safe) over a shared directory; each trains a
deterministic pure-numpy float64 toy model and coordinates only through
``elastic/coordinator.py``'s files. No process group and no device: the
drill isolates the control plane. Scenarios (``tests/test_torch_coordinator.py``):

    clean        N hosts train and snapshot to the end, then resume onto
                 another world size; the losses equal the one-process
                 reference exactly
    kill_host    a non-leader ``_exit()``s mid-run; the survivors see its
                 lease expire, post a ``peer_dead`` stop, converge on one
                 final step S and snapshot it together
    kill_leader  the leader ``_exit()``s mid-commit, after its ready marker
                 and with a fresh commit lease left behind; the next live rank
                 takes the stale lease over (its fence token incremented) and
                 finishes the commit
    commit_race  every host believes it leads (``debug_force_leader``): the
                 commit lease lets one manifest a step land
    straggler    one host's final marker comes after the straggler deadline:
                 the peers abort cleanly (``Coordinator.straggler_aborts``) and
                 retry until it lands

The toy trainer keeps everything float64 and in place, so a snapshot round
trip is bit-exact and the trajectories are compared with no tolerance.

``control_plane_worker`` is the launcher's smoke mode: rendezvous through the
coordinator until every rank is live, heartbeat, leave. The reference's
goodput ledger and telemetry of the drill wait for ROADMAP A7.
"""
from __future__ import annotations

import argparse
import json
import multiprocessing
import os
import sys
import time
from typing import Any, Dict, List, Optional

import numpy as _np

from .coordinator import Coordinator
from .run import resume_or_init, run

__all__ = ["ToyTrainer", "ToyFeed", "toy_batch", "reference_losses", "run_drill",
           "control_plane_worker"]

_DIM = 8
_HIDDEN = 16
_BATCH = 16
_LR = 0.05


def toy_batch(cursor: int):
    """Batch ``cursor`` of the deterministic stream every host and the
    one-process reference read."""
    rng = _np.random.RandomState(10_000 + int(cursor))
    x = rng.randn(_BATCH, _DIM)
    w = _np.sin(_np.arange(_DIM))
    y = _np.tanh(x @ w)[:, None] + 0.1 * rng.randn(_BATCH, 1)
    return x, y


class ToyTrainer:
    """A pure-numpy MLP with analytic gradients and SGD in place: the
    surface ``elastic.run`` and the snapshots need (``step(x, y) -> float``,
    ``drain()``, ``_t``, the duck-typed ``elastic_state()`` /
    ``elastic_install()`` of ``elastic/state.py``), float64 throughout."""

    def __init__(self, seed: int = 0):
        rng = _np.random.RandomState(seed)
        self.params: List[_np.ndarray] = [
            rng.randn(_DIM, _HIDDEN) * 0.3,
            _np.zeros(_HIDDEN),
            rng.randn(_HIDDEN, 1) * 0.3,
            _np.zeros(1),
        ]
        self._t = 0

    def step(self, x, y) -> float:
        w1, b1, w2, b2 = self.params
        h = _np.tanh(x @ w1 + b1)
        pred = h @ w2 + b2
        err = pred - y
        loss = float(_np.mean(err * err))
        n = x.shape[0]
        gpred = 2.0 * err / n
        gw2 = h.T @ gpred
        gb2 = gpred.sum(axis=0)
        gh = gpred @ w2.T * (1.0 - h * h)
        gw1 = x.T @ gh
        gb1 = gh.sum(axis=0)
        for p, g in zip(self.params, (gw1, gb1, gw2, gb2)):
            p -= _LR * g
        self._t += 1
        return loss

    def drain(self):
        pass

    def elastic_state(self) -> Dict[str, Any]:
        return {"leaves": {f"param.{i}": p for i, p in enumerate(self.params)},
                "meta": {"format": 1, "kind": "toy", "step": self._t,
                         "dims": [_DIM, _HIDDEN]}}

    def elastic_install(self, meta, fetch, names):
        if meta.get("dims") != [_DIM, _HIDDEN]:
            raise ValueError(f"toy snapshot dims {meta.get('dims')} do not match this "
                             f"build ({[_DIM, _HIDDEN]})")
        for i in range(len(self.params)):
            self.params[i][...] = fetch(f"param.{i}")
        self._t = int(meta["step"])


class ToyFeed:
    """An endless feed over ``toy_batch`` whose cursor rides the snapshot
    (``state_dict``/``load_state_dict``), so a resume replays the exact
    batches."""

    def __init__(self):
        self._cursor = 0

    def __iter__(self):
        while True:
            batch = toy_batch(self._cursor)
            self._cursor += 1
            yield batch

    def state_dict(self):
        return {"cursor": int(self._cursor)}

    def load_state_dict(self, state):
        self._cursor = int(state["cursor"])


def reference_losses(num_steps: int, seed: int = 0) -> List[float]:
    """The one-process trajectory every drill's resume is held to."""
    trainer = ToyTrainer(seed=seed)
    feed = iter(ToyFeed())
    losses = []
    for _ in range(int(num_steps)):
        x, y = next(feed)
        losses.append(trainer.step(x, y))
    return losses


def _host_main(cfg: Dict[str, Any]):
    """One drill host (the spawn target): join, resume or start under the
    shared root, train under ``elastic.run`` with the coordinator, write a
    JSON report."""
    rank = int(cfg["rank"])
    root = cfg["root"]
    coord = Coordinator(root, rank, lease_timeout=float(cfg.get("lease_timeout", 1.0)),
                        straggler_timeout=float(cfg.get("straggler_timeout", 8.0)),
                        heartbeat_interval=0.0, partition_ownership=True,
                        poll_interval=0.01)
    if cfg.get("die_in_commit_step") is not None:
        coord.debug_exit_after_marker = int(cfg["die_in_commit_step"])
    if cfg.get("marker_delay") is not None:
        coord.debug_marker_delay = (int(cfg["marker_delay"][0]),
                                    float(cfg["marker_delay"][1]))
    coord.debug_force_leader = bool(cfg.get("force_leader"))
    coord.join()
    # rendezvous: step only once the whole world is live, so the generation
    # and the ownership start alike on every host
    deadline = time.monotonic() + float(cfg.get("rendezvous_timeout", 30.0))
    while len(coord.view().live) < int(cfg["world"]):
        if time.monotonic() >= deadline:
            os._exit(7)
        time.sleep(0.02)
    feed = ToyFeed()
    mgr, trainer, start, outcome = resume_or_init(
        root, ToyTrainer, feed=feed, max_to_keep=int(cfg.get("max_to_keep", 10)),
        save_interval_steps=int(cfg["save_every"]), coordinator=coord)
    die_at = cfg.get("die_at_step")
    step_sleep = float(cfg.get("step_sleep", 0.0))
    losses: Dict[str, float] = {}

    def on_step(t, loss):
        losses[str(t)] = float(loss)
        if die_at is not None and t >= int(die_at):
            os._exit(3)         # a hard host loss: no clean-up
        if step_sleep:
            time.sleep(step_sleep)

    res = run(trainer, feed, int(cfg["num_steps"]), manager=mgr, on_step=on_step,
              coordinator=coord)
    report = {"rank": rank, "start": int(start), "outcome": outcome,
              "final_step": int(res["step"]), "preempted": bool(res["preempted"]),
              "stop": res["stop"], "losses": losses, "generation": int(coord.generation),
              "fence": int(coord.fence), "straggler_aborts": coord.straggler_aborts}
    path = os.path.join(cfg["report_dir"], f"report-{rank:05d}.json")
    with open(path + ".tmp", "w") as f:
        json.dump(report, f)
    os.replace(path + ".tmp", path)
    coord.leave()


def run_drill(root: str, world: int, num_steps: int, save_every: int = 5,
              scenario: Optional[Dict[int, Dict[str, Any]]] = None, timeout: float = 120.0,
              report_tag: str = "r0", **overrides) -> Dict[str, Any]:
    """Spawn ``world`` processes over ``root`` and run one drill phase.
    ``scenario`` maps per-rank settings (``{2: {"die_at_step": 6}}``);
    ``overrides`` apply to every host (``lease_timeout``,
    ``straggler_timeout``, ``step_sleep``, ``rendezvous_timeout``, ...).
    Every process is joined within ``timeout`` seconds and killed after it.
    Returns ``{"exitcodes": [...], "reports": {rank: {...}}}``; a rank that
    died has its exit code and no report."""
    report_dir = os.path.join(root, f"reports-{report_tag}")
    os.makedirs(report_dir, exist_ok=True)
    ctx = multiprocessing.get_context("spawn")
    procs = []
    for r in range(int(world)):
        cfg = {"root": root, "rank": r, "world": int(world), "num_steps": int(num_steps),
               "save_every": int(save_every), "report_dir": report_dir}
        cfg.update(overrides)
        cfg.update((scenario or {}).get(r, {}))
        p = ctx.Process(target=_host_main, args=(cfg,), name=f"mx-drill-host-{r}")
        p.start()
        procs.append(p)
    deadline = time.monotonic() + float(timeout)
    try:
        for p in procs:
            p.join(timeout=max(0.1, deadline - time.monotonic()))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(timeout=5.0)
    reports: Dict[int, Dict[str, Any]] = {}
    for name in os.listdir(report_dir):
        if name.startswith("report-") and name.endswith(".json"):
            with open(os.path.join(report_dir, name)) as f:
                rec = json.load(f)
            reports[int(rec["rank"])] = rec
    return {"exitcodes": [p.exitcode for p in procs], "reports": reports}


def control_plane_worker(root: str, beats: int = 5, rendezvous_timeout: float = 60.0) -> int:
    """Boot, rendezvous, heartbeat and leave through the control plane only;
    the rank and world come from ``MXNET_TPU_RANK`` /
    ``MXNET_TPU_NUM_WORKERS``. Writes ``ok_<rank>`` into ``root`` on
    success; returns a shell exit code."""
    rank = int(os.environ.get("MXNET_TPU_RANK", "0"))
    world = int(os.environ.get("MXNET_TPU_NUM_WORKERS", "1"))
    coord = Coordinator(root, rank, lease_timeout=10.0, poll_interval=0.02)
    coord.join()
    deadline = time.monotonic() + float(rendezvous_timeout)
    while len(coord.view().live) < world:
        if time.monotonic() >= deadline:
            print(f"rank {rank}: rendezvous timed out "
                  f"({len(coord.view(bump=False).live)}/{world} live)", file=sys.stderr)
            return 2
        time.sleep(0.02)
    for i in range(int(beats)):
        coord.heartbeat(i, force=True)
        time.sleep(0.01)
    view = coord.view(bump=False)
    with open(os.path.join(root, f"ok_{rank}"), "w") as f:
        json.dump({"rank": rank, "world": world, "generation": view.generation,
                   "live": view.live}, f)
    coord.leave()
    return 0


def _main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="multi-host control-plane drill worker")
    ap.add_argument("--control-plane", action="store_true",
                    help="run the launcher smoke mode (rendezvous only)")
    ap.add_argument("--root", required=True, help="shared control-plane/snapshot directory")
    ap.add_argument("--beats", type=int, default=5)
    args = ap.parse_args(argv)
    if args.control_plane:
        return control_plane_worker(args.root, beats=args.beats)
    ap.error("only --control-plane mode has a CLI; use run_drill() from Python for full "
             "drills")
    return 2


if __name__ == "__main__":
    sys.exit(_main())
