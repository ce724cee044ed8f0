"""Step-indexed checkpoints of a state tree, and the trainer's save/restore hooks.

Counterpart of ``mxnet_tpu/checkpoint.py``, which wraps orbax. The port adds
no package: a checkpoint is a snapshot in ``elastic/manifest.py``'s format
(``<directory>/step-<K>/`` with the shard files and an atomically committed
``manifest.json``), written synchronously, plus the reference's sidecar
``mx-leaves-<step>.json``: the tree's containers with each array leaf's
shape and dtype, from which ``restore`` with no target rebuilds the tree.
Without the sidecar the tree is rebuilt from the manifest's leaf paths (all
containers as dicts), with a ``DeprecationWarning``. The first-class path is
``mxnet_tpu_torch.elastic`` (asynchronous sharded snapshots, ZeRO reshard,
coordinated commits).

- ``CheckpointManager(directory, max_to_keep=3, save_interval_steps=1)``:
  ``save(step, state)`` (tensors, numpy arrays and numpy scalars in nested
  dicts, lists and tuples; a step off the interval is skipped unless
  ``force``), ``restore(step=None, like=None)``, ``latest_step``,
  ``all_steps``, retention by ``manifest.prune``. A restored array leaf is a
  CPU tensor, a 0-d numpy leaf a 0-d numpy array; with ``like`` each leaf
  takes the target's device and dtype: save on one device, restore onto
  another (the reference's reshard on restore).
- ``resume_or_init(directory, init_fn)``: the newest checkpoint restored
  like ``init_fn()``'s tree, or ``init_fn()``; returns ``(manager, state,
  start_step)``.
- ``trainer_state`` / ``load_trainer_state`` / ``save_trainer`` /
  ``restore_trainer`` for ``parallel.DataParallelTrainer``: positional keys
  (``"p3"``), the optimizer state, the ZeRO shards of this rank (``zero``),
  the step, the RNG state, the schedule counters and the loss scaler.

On a ``torch.distributed`` job rank 0 writes and commits (the trees are
replicated; a ZeRO rank's shards are its own: use ``elastic`` there).
"""
from __future__ import annotations

import json
import os
import warnings
from typing import Any, Dict, Optional

import numpy as _np
import torch

from .base import MXNetError
from .elastic import manifest as _manifest

__all__ = ["CheckpointManager", "resume_or_init", "trainer_state", "load_trainer_state",
           "save_trainer", "restore_trainer"]


def _is_leaf(v) -> bool:
    return isinstance(v, (torch.Tensor, _np.ndarray, _np.generic))


def _host(v) -> _np.ndarray:
    if isinstance(v, torch.Tensor):
        return v.detach().to("cpu").numpy()
    return _np.asarray(v)


def _leaf_spec_of(tree):
    """The sidecar: containers kept, array leaves as shape and dtype, other
    values opaque."""
    if isinstance(tree, dict):
        return {str(k): _leaf_spec_of(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_leaf_spec_of(v) for v in tree]
    if _is_leaf(tree):
        a = _host(tree)
        return {"__leaf__": True, "shape": [int(d) for d in a.shape], "dtype": str(a.dtype)}
    return {"__opaque__": True}


def _flatten(tree, prefix=""):
    """``{path: leaf}`` of the array leaves (paths joined by "/")."""
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}/"))
    elif _is_leaf(tree):
        out[prefix[:-1]] = tree
    return out


def _restored(arr: _np.ndarray, spec_dtype: str, like=None):
    if like is not None and isinstance(like, torch.Tensor):
        return torch.from_numpy(arr).to(device=like.device, dtype=like.dtype)
    if like is not None and isinstance(like, (_np.ndarray, _np.generic)):
        return _np.asarray(arr, dtype=_np.asarray(like).dtype)
    return _np.asarray(arr) if arr.ndim == 0 else torch.from_numpy(arr)


def _build(spec, read, prefix=""):
    """The tree of a sidecar spec, each leaf from ``read(path)``."""
    if isinstance(spec, list):
        return [_build(v, read, f"{prefix}{i}/") for i, v in enumerate(spec)]
    if spec.get("__leaf__"):
        return _restored(read(prefix[:-1]), spec["dtype"])
    if spec.get("__opaque__"):
        return None
    return {k: _build(v, read, f"{prefix}{k}/") for k, v in spec.items()}


def _build_like(like, read, prefix=""):
    """``like``'s tree, each array leaf read and placed like its target."""
    if isinstance(like, dict):
        return {k: _build_like(v, read, f"{prefix}{k}/") for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        out = [_build_like(v, read, f"{prefix}{i}/") for i, v in enumerate(like)]
        return type(like)(out) if isinstance(like, tuple) else out
    if _is_leaf(like):
        return _restored(read(prefix[:-1]), None, like)
    return like


def _rank() -> int:
    import torch.distributed as dist
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


class CheckpointManager:
    """Step-indexed checkpoints with retention and an atomic commit."""

    def __init__(self, directory: str, max_to_keep: int = 3, save_interval_steps: int = 1):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.max_to_keep = int(max_to_keep)
        self.save_interval_steps = max(1, int(save_interval_steps))

    def _sidecar(self, step: int) -> str:
        return os.path.join(self.directory, f"mx-leaves-{int(step)}.json")

    def save(self, step: int, state: Dict[str, Any], force: bool = False,
             wait: bool = False) -> bool:
        """Write ``state`` as step ``step`` (synchronously: ``wait`` is
        accepted for the reference's signature). Returns whether it saved."""
        step = int(step)
        if not force and step % self.save_interval_steps:
            return False
        if _rank() != 0:
            return True
        sdir = _manifest.step_path(self.directory, step)
        entries = []
        for name, v in _flatten(state).items():
            a = _host(v)
            entries.append((name, [(0, d) for d in a.shape], a, a.shape, a.dtype))
        _manifest.write_shard(sdir, 0, entries)
        _manifest.commit(sdir, step, {"step": step, "kind": "checkpoint"})
        tmp = self._sidecar(step) + ".tmp"
        with open(tmp, "w") as f:
            json.dump(_leaf_spec_of(state), f)
        os.replace(tmp, self._sidecar(step))
        for gone in _manifest.prune(self.directory, self.max_to_keep):
            try:
                os.unlink(self._sidecar(gone))
            except OSError:
                pass
        return True

    def restore(self, step: Optional[int] = None,
                like: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
        """Restore ``step`` (default the latest). With ``like`` (a tree of
        tensors or arrays) each leaf takes its target's device and dtype."""
        if step is None:
            step = self.latest_step()
            if step is None:
                raise MXNetError(f"no checkpoint found in {self.directory}")
        with _manifest.SnapshotReader(self.directory, int(step)) as rd:
            if like is not None:
                return _build_like(like, rd)
            side = self._sidecar(step)
            if os.path.exists(side):
                with open(side) as f:
                    return _build(json.load(f), rd)
            warnings.warn("restoring a checkpoint without its mx-leaves sidecar: the tree "
                          "is rebuilt from the manifest's leaf paths (containers as "
                          "dicts). Re-save with this build (or use mxnet_tpu_torch.elastic "
                          "snapshots) for the sidecar-driven restore.", DeprecationWarning,
                          stacklevel=2)
            tree: Dict[str, Any] = {}
            for name in sorted(rd.names):
                node = tree
                *parents, leaf = name.split("/")
                for p in parents:
                    node = node.setdefault(p, {})
                arr = rd(name)
                node[leaf] = _restored(arr, str(arr.dtype))
            return tree

    def latest_step(self) -> Optional[int]:
        return _manifest.latest_complete_step(self.directory)

    def all_steps(self):
        return _manifest.all_complete_steps(self.directory)

    def wait_until_finished(self):
        pass

    def close(self):
        pass


def resume_or_init(directory: str, init_fn, max_to_keep: int = 3):
    """The newest checkpoint restored like ``init_fn()``'s tree, else
    ``init_fn()``; returns ``(manager, state, start_step)``."""
    mgr = CheckpointManager(directory, max_to_keep=max_to_keep)
    step = mgr.latest_step()
    if step is not None:
        return mgr, mgr.restore(step, like=init_fn()), int(step) + 1
    return mgr, init_fn(), 0


# -- DataParallelTrainer ---------------------------------------------------------------

def trainer_state(trainer) -> Dict[str, Any]:
    """A ``DataParallelTrainer``'s training state by position (``"p3"``:
    parameter names carry process-wide counters): the parameters, their
    optimizer state, this rank's ZeRO state shards (``zero``), the step,
    the RNG state, the schedule counters (``sched``, JSON in a uint8 leaf)
    and the loss scaler."""
    from . import random as _rng
    from .elastic import state as _estate
    state = {
        "params": {f"p{i}": p._param.detach() for i, p in enumerate(trainer._plist)},
        "opt_state": {f"p{i}": tuple(s) for i, s in enumerate(trainer._opt_state)},
        "step": _np.int64(trainer._t),
        "rng": _np.asarray(_rng.get_state_raw()),
        # the counters' keys vary from run to run: one JSON leaf
        "sched": _np.frombuffer(json.dumps(_estate.sched_state(trainer.optimizer)).encode(),
                                dtype=_np.uint8).copy(),
    }
    if trainer._zero_buckets:
        state["zero"] = {f"b{k}": tuple(zb["state"])
                         for k, zb in enumerate(trainer._zero_buckets)}
    if trainer._scaler is not None:
        state["loss_scale"] = _np.float64(trainer._scaler.loss_scale)
        state["scaler_unskipped"] = _np.int64(trainer._scaler._unskipped)
    return state


def _copy_into(dst: torch.Tensor, src):
    with torch.no_grad():
        dst.copy_(torch.as_tensor(_host(src)) if not isinstance(src, torch.Tensor) else src)


def load_trainer_state(trainer, state: Dict[str, Any]):
    """Install a restored state into a trainer built the same way, in place
    (the step's pointer tables and captured graphs keep their storage)."""
    params, opt = state["params"], state["opt_state"]
    n = len(trainer._plist)
    if len(params) != n:
        raise MXNetError(f"checkpoint has {len(params)} parameters, trainer has {n}: "
                         f"architecture mismatch")
    for i, p in enumerate(trainer._plist):
        _copy_into(p._param.detach(), params[f"p{i}"])
        for dst, src in zip(trainer._opt_state[i], opt.get(f"p{i}", ())):
            _copy_into(dst, src)
    for k, zb in enumerate(trainer._zero_buckets):
        for dst, src in zip(zb["state"], state.get("zero", {}).get(f"b{k}", ())):
            _copy_into(dst, src)
    trainer._t = int(_np.asarray(state["step"]))
    sched = state.get("sched")
    if sched is not None:
        from .elastic import state as _estate
        _estate.install_sched(trainer.optimizer,
                              json.loads(_host(sched).astype(_np.uint8).tobytes().decode()))
    else:
        trainer.optimizer.num_update = trainer._t
    if "rng" in state:
        from . import random as _rng
        _rng.set_state_raw(_host(state["rng"]))
    if trainer._scaler is not None and "loss_scale" in state:
        trainer._scaler.loss_scale = float(_np.asarray(state["loss_scale"]))
        trainer._scaler._unskipped = int(_np.asarray(state.get("scaler_unskipped", 0)))
    trainer.sync()
    return trainer


def save_trainer(mgr: CheckpointManager, trainer, force: bool = False, wait: bool = True):
    return mgr.save(trainer._t, trainer_state(trainer), force=force, wait=wait)


def restore_trainer(mgr: CheckpointManager, trainer, step: Optional[int] = None):
    state = mgr.restore(step, like=trainer_state(trainer))
    return load_trainer_state(trainer, state)
