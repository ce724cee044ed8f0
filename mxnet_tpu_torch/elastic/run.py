"""Supervised elastic training: boot from the latest snapshot, preemption, run loop.

Counterpart of ``mxnet_tpu/elastic/run.py``. A preemptible job is

    mgr, trainer, start, outcome = elastic.resume_or_init(directory, make_trainer,
                                                          feed=feed)
    elastic.run(trainer, feed, num_steps, manager=mgr)

Every worker calls ``resume_or_init`` at boot: it finds the latest complete
snapshot (a committed manifest), installs it into the trainer that
``make_trainer`` builds for this job's mesh, in place (``elastic/state.py``),
and calls the boot "resumed" (same mesh and ``StepProgram`` fingerprint) or
"resharded" (another mesh or configuration: the ZeRO lanes re-packed), or
"fresh" without a snapshot. A feed with ``state_dict``/``load_state_dict``
is rewound to its saved cursor (``engine/async_feed.DeviceFeed`` itself waits
for ROADMAP A7). ``run`` drives the steps with an interval snapshot policy
and a SIGTERM/SIGINT ``PreemptionGuard``: on a signal it finishes the step
in flight, drains the device, writes a final synchronous snapshot and returns
``{"preempted": True}``, and the relaunched job continues the same
trajectory. Losses stay ``PendingScalar``s: nothing in the loop syncs.

On a ``torch.distributed`` mesh every rank calls both; the ranks agree on the
step to resume from (rank 0's latest, broadcast). ``coordinator=`` raises
(ROADMAP A2, ``elastic/coordinator.py``); the reference's resume counter and
restart-downtime record wait for the telemetry slice (ROADMAP A7).
"""
from __future__ import annotations

import signal
import threading
import warnings
from typing import Any, Callable, Dict, Optional

from ..base import MXNetError
from . import manifest as _manifest
from . import state as _state
from .snapshot import _COORD, SnapshotManager

__all__ = ["capture_trainer", "save_trainer", "resume_or_init", "PreemptionGuard", "run"]


def capture_trainer(trainer, feed=None) -> Dict[str, Any]:
    """The trainer's snapshot (``elastic/state.py``), with the feed's cursor
    in meta so that a restore rewinds the data stream too."""
    snap = _state.capture(trainer)
    if feed is not None and hasattr(feed, "state_dict"):
        snap["meta"]["feed"] = feed.state_dict()
    return snap


def save_trainer(manager: SnapshotManager, trainer, feed=None, wait: bool = False):
    """Capture and save at the trainer's current step."""
    manager.save(trainer._t, capture_trainer(trainer, feed), wait=wait)


def _agreed_latest(mgr: SnapshotManager) -> Optional[int]:
    """The latest complete step, rank 0's on a process group of several."""
    import torch
    import torch.distributed as dist
    step = mgr.latest_step()
    if not (dist.is_available() and dist.is_initialized()) or dist.get_world_size() == 1:
        return step
    device = "cuda" if dist.get_backend() == "nccl" else "cpu"
    t = torch.tensor([-1 if step is None else step], dtype=torch.int64, device=device)
    dist.broadcast(t, src=0)
    step = int(t.item())
    return None if step < 0 else step


def resume_or_init(directory: str, make_trainer: Callable[[], Any], feed=None,
                   max_to_keep: int = 3, save_interval_steps: Optional[int] = None,
                   coordinator=None):
    """Boot a worker: install the latest complete snapshot, or start fresh.

    Returns ``(manager, trainer, start_step, outcome)``, outcome ``"fresh"``,
    ``"resumed"`` or ``"resharded"``."""
    if coordinator is not None:
        raise MXNetError(f"resume_or_init(coordinator=...): {_COORD}")
    mgr = SnapshotManager(directory, max_to_keep=max_to_keep,
                          save_interval_steps=save_interval_steps)
    step = _agreed_latest(mgr)
    trainer = make_trainer()
    if step is None:
        return mgr, trainer, 0, "fresh"
    man = _manifest.load(mgr.directory, step)
    meta = man["meta"]
    with _manifest.SnapshotReader(mgr.directory, step, manifest=man) as rd:
        _state.install(trainer, meta, rd, rd.names)
    if feed is not None and meta.get("feed") is not None and \
            hasattr(feed, "load_state_dict"):
        feed.load_state_dict(meta["feed"])
    outcome = "resumed"
    if hasattr(trainer, "mesh") and hasattr(trainer, "_program"):
        mesh_now = {str(a): int(s) for a, s in trainer.mesh.shape.items()}
        if mesh_now != meta.get("mesh") or \
                trainer._program.fingerprint != meta.get("program"):
            outcome = "resharded"
    return mgr, trainer, int(meta["step"]), outcome


class PreemptionGuard:
    """SIGTERM/SIGINT as a flag the training loop polls.

    The handler only sets an event (no IO, nothing raised into the frame it
    interrupts), so the step in flight completes and the loop stops at a step
    boundary, where a consistent snapshot can be taken. ``__exit__`` restores
    the previous handlers. Off the main thread, where Python refuses signal
    handlers, it is a flag that ``request_stop`` sets."""

    def __init__(self, signals=(signal.SIGTERM, signal.SIGINT)):
        self.signals = tuple(signals)
        self._flag = threading.Event()
        self._prev: Dict[int, Any] = {}

    def _handle(self, signum, frame):
        self._flag.set()

    def request_stop(self):
        self._flag.set()

    @property
    def triggered(self) -> bool:
        return self._flag.is_set()

    def __enter__(self):
        for s in self.signals:
            try:
                self._prev[s] = signal.signal(s, self._handle)
            except ValueError:  # not the main thread
                pass
        return self

    def __exit__(self, *exc):
        for s, h in self._prev.items():
            signal.signal(s, h)
        self._prev.clear()
        return False


def _xy(batch):
    data = getattr(batch, "data", None)
    if data is not None:  # io.DataBatch
        label = getattr(batch, "label", None)
        return data[0], (label[0] if label else None)
    x, y = batch
    return x, y


def run(trainer, feed, num_steps: int, directory: Optional[str] = None,
        manager: Optional[SnapshotManager] = None, save_every: Optional[int] = None,
        guard: Optional[PreemptionGuard] = None, on_step=None,
        coordinator=None) -> Dict[str, Any]:
    """``trainer.step`` over ``feed`` until the trainer's step counter reaches
    ``num_steps`` (a resumed trainer does the remainder), a snapshot every
    ``save_every`` steps and one at the end.

    ``feed`` yields ``(x, y)`` pairs or ``DataBatch`` items; its end calls
    ``feed.reset()`` (or ends the run without one). On SIGTERM/SIGINT the loop
    finishes the step, drains the device, writes a final synchronous snapshot
    and returns ``{"preempted": True}``. A failed interval snapshot warns and
    training goes on (resume falls back to the previous one); the final one
    raises. Returns ``{"step", "losses", "preempted", "stop"}``, the losses as
    ``PendingScalar``s."""
    if coordinator is not None:
        raise MXNetError(f"elastic.run(coordinator=...): {_COORD}")
    if manager is None:
        if directory is None:
            raise MXNetError("elastic.run needs directory= or manager=")
        manager = SnapshotManager(directory, save_interval_steps=save_every)
    elif save_every is not None:
        manager.save_interval_steps = int(save_every)
    losses = []
    preempted = False
    own_guard = guard is None
    g = PreemptionGuard() if own_guard else guard
    if own_guard:
        g.__enter__()
    try:
        it = iter(feed)
        while trainer._t < num_steps:
            if g.triggered:
                preempted = True
                break
            try:
                batch = next(it)
            except StopIteration:
                if not hasattr(feed, "reset"):
                    break
                feed.reset()
                it = iter(feed)
                continue
            x, y = _xy(batch)
            losses.append(trainer.step(x, y))
            if manager.should_save(trainer._t):
                try:
                    save_trainer(manager, trainer, feed)
                except MXNetError as e:
                    warnings.warn(f"elastic.run: interval snapshot at step {trainer._t} "
                                  f"failed and was skipped ({e}); training continues, "
                                  f"resume falls back to the previous snapshot",
                                  RuntimeWarning)
            if on_step is not None:
                on_step(trainer._t, losses[-1])
        trainer.drain()
        if trainer._t != manager._last_saved:
            save_trainer(manager, trainer, feed, wait=True)
        else:
            manager.wait_until_finished()
    finally:
        if own_guard:
            g.__exit__(None, None, None)
    return {"step": trainer._t, "losses": losses, "preempted": preempted, "stop": None}
