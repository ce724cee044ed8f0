"""mxnet_tpu_torch.elastic: snapshot, kill and resume a fused training step.

Counterpart of ``mxnet_tpu/elastic/__init__.py``: asynchronous sharded
snapshots (no gather, no host sync on the step path), restore onto the
same mesh or another data degree (the ZeRO state re-canonicalised),
resumable input feeds and SIGTERM-clean preemption.

    manifest.py     on-disk layout, atomic manifest commit, chunk reader
    snapshot.py     SnapshotManager: device copy, then write off the step path
    state.py        trainer capture/install, ZeRO re-canonicalisation
    run.py          resume_or_init / PreemptionGuard / the supervised run loop
    coordinator.py  heartbeat membership, coordinated stop, the two-phase
                    cross-host commit, the hang watchdog
    drill.py        the multi-process kill/race/straggler drills
"""
from .manifest import SnapshotReader, all_complete_steps, latest_complete_step
from .snapshot import SnapshotManager
from .state import capture, install
from .run import PreemptionGuard, capture_trainer, resume_or_init, run, save_trainer
from .coordinator import Coordinator, GroupView, HangWatchdog, StragglerTimeout

__all__ = ["SnapshotManager", "SnapshotReader", "all_complete_steps",
           "latest_complete_step", "capture", "install", "capture_trainer",
           "save_trainer", "resume_or_init", "PreemptionGuard", "run",
           "Coordinator", "GroupView", "HangWatchdog", "StragglerTimeout"]
