"""On-disk snapshot layout and atomic manifest commit.

Counterpart of ``mxnet_tpu/elastic/manifest.py``, the same format
(``FORMAT = 1``): a snapshot written by either package reads in the other.
A snapshot of training step K is a directory

    <root>/step-<K>/shard-<p>.npz     per-process chunk payloads
    <root>/step-<K>/shard-<p>.json    per-process chunk index
    <root>/step-<K>/manifest.json     commit marker (merged index + meta)

Each process writes only the chunks it owns (``elastic/snapshot.py``: a
tensor-parallel shard once, by the rank at coordinate 0 of every other axis;
a ZeRO shard by its data-parallel rank; a replicated leaf by rank 0), so no
host gathers the model. ``manifest.json`` is the commit token: it is written
to a temporary file and ``os.replace``d into place only after every expected
shard file landed, so a directory without it is incomplete (a preempted
writer), invisible to restore and pruned by retention.

The manifest holds what restore needs without the saving process:
``leaves`` (global shape and dtype per named leaf), ``chunks`` (for each
leaf the ``[[start, stop], ...]`` region each npz entry covers; the chunks
tile the leaf exactly, so a restore onto another mesh assembles any region
it needs) and ``meta`` (the trainer's host state, ``elastic/state.py``).

Every write fsyncs the file before its ``os.replace`` and the directory
after; all IO runs under ``faults.io_retry``; ``commit`` serializes
concurrent committers through a lease file with a fencing token, so exactly
one writer finalizes a step, a fenced-out writer raises ``MXNetError`` and a
crashed committer's stale lease is taken over with an incremented token.
The reference's multi-host parts (``commit(ranks=...)``, the reader's
generation and fence checks, the coordinator's reuse of the lease under
other names) wait for ``elastic/coordinator.py`` (ROADMAP A2).
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
import uuid
from typing import Any, Dict, List, Optional

import numpy as _np

from .. import faults as _faults
from ..base import MXNetError, env

__all__ = ["step_dirname", "step_path", "parse_step", "all_complete_steps",
           "latest_complete_step", "write_shard", "commit", "load", "prune",
           "SnapshotReader"]

FORMAT = 1
_STEP_PREFIX = "step-"
MANIFEST = "manifest.json"
LEASE = "commit.lease"
READY_PREFIX = "ready-"

env.declare("MXNET_TPU_PRUNE_GRACE", 30.0, float,
            "Retention liveness grace in seconds: prune skips an incomplete "
            "snapshot directory whose commit lease or ready markers were written "
            "within this window, another live writer may still be in it (0 "
            "disables the check)")


def _fsync_file(f):
    f.flush()
    os.fsync(f.fileno())


def _fsync_dir(path: str):
    """Make a completed rename durable: fsync the containing directory.
    Best-effort no-op on platforms where directories can't be opened."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def step_dirname(step: int) -> str:
    return f"{_STEP_PREFIX}{int(step):08d}"


def step_path(root: str, step: int) -> str:
    return os.path.join(root, step_dirname(step))


def parse_step(name: str) -> Optional[int]:
    if not name.startswith(_STEP_PREFIX):
        return None
    try:
        return int(name[len(_STEP_PREFIX):])
    except ValueError:
        return None


def all_complete_steps(root: str) -> List[int]:
    """Steps whose manifest committed (incomplete dirs are invisible)."""
    if not os.path.isdir(root):
        return []
    steps = []
    for name in os.listdir(root):
        step = parse_step(name)
        if step is not None and \
                os.path.exists(os.path.join(root, name, MANIFEST)):
            steps.append(step)
    return sorted(steps)


def latest_complete_step(root: str) -> Optional[int]:
    steps = all_complete_steps(root)
    return steps[-1] if steps else None


# ---------------------------------------------------------------------------
# Writer side (runs on the background snapshot thread, never the step path)
# ---------------------------------------------------------------------------

def write_shard(sdir: str, process_index: int, entries) -> int:
    """Write one process's chunk payloads + index.

    ``entries``: iterable of ``(leaf_name, index, array, global_shape,
    dtype)`` where ``index`` is ``[[start, stop], ...]`` per dim of the
    global leaf and ``array`` is the host chunk covering exactly that
    region. Returns the payload byte count."""
    os.makedirs(sdir, exist_ok=True)
    payload: Dict[str, _np.ndarray] = {}
    chunks, leaves = [], {}
    nbytes = 0
    for i, (name, index, arr, gshape, dtype) in enumerate(entries):
        key = f"c{i}"
        arr = _np.asarray(arr)
        payload[key] = arr
        nbytes += arr.nbytes
        chunks.append({"name": name, "key": key,
                       "index": [[int(a), int(b)] for a, b in index]})
        leaves[name] = {"shape": [int(d) for d in gshape],
                        "dtype": str(dtype)}
    base = os.path.join(sdir, f"shard-{int(process_index):05d}")

    def _write_payload():
        tmp = base + ".npz.tmp"
        with open(tmp, "wb") as f:
            _np.savez(f, **payload)
            _fsync_file(f)
        os.replace(tmp, base + ".npz")

    def _write_index():
        tmp = base + ".json.tmp"
        with open(tmp, "w") as f:
            json.dump({"process": int(process_index), "chunks": chunks,
                       "leaves": leaves, "nbytes": int(nbytes)}, f)
            _fsync_file(f)
        os.replace(tmp, base + ".json")

    _faults.io_retry("elastic.write_shard", _write_payload)
    _faults.io_retry("elastic.write_shard", _write_index)
    _fsync_dir(sdir)
    return nbytes


# -- commit lease: exactly one concurrent committer finalizes a step --------

def _lease_path(sdir: str) -> str:
    return os.path.join(sdir, LEASE)


def _read_lease(sdir: str) -> Dict[str, Any]:
    try:
        with open(_lease_path(sdir)) as f:
            return json.load(f)
    except (OSError, ValueError):
        return {}


def _write_lease_to(path: str, owner: str, token: int):
    with open(path, "w") as f:
        json.dump({"owner": owner, "token": int(token), "ts": time.time()}, f)
        _fsync_file(f)


def _acquire_lease(sdir: str, owner: str, stale_after: float) -> int:
    """Take the step directory's commit lease; returns this holder's fencing
    token. Exactly one of N concurrent committers wins the ``O_EXCL``
    create; the others raise ``MXNetError``. A lease older than
    ``stale_after`` seconds (its holder died) is taken over with an
    incremented token, and ``commit`` checks owner and token again just
    before the manifest's rename, so the stale holder never finalizes."""
    path = _lease_path(sdir)
    try:
        fd = os.open(path, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
    except FileExistsError:
        pass
    else:
        with os.fdopen(fd, "w") as f:
            json.dump({"owner": owner, "token": 1, "ts": time.time()}, f)
            _fsync_file(f)
        return 1
    holder = _read_lease(sdir)
    age = time.time() - float(holder.get("ts", 0.0))
    if age <= stale_after and holder:
        raise MXNetError(f"snapshot commit lease for {sdir} is held by "
                         f"{holder.get('owner')!r} (age {age:.1f}s, token "
                         f"{holder.get('token')}): exactly one committer may finalize "
                         f"a step; this writer lost the race")
    token = int(holder.get("token", 0)) + 1
    tmp = path + f".{owner}.tmp"
    _write_lease_to(tmp, owner, token)
    os.replace(tmp, path)
    # concurrent takeovers race on the replace; the last write wins
    if _read_lease(sdir).get("owner") != owner:
        raise MXNetError(f"lost the stale-lease takeover race for {sdir}")
    return token


def _verify_lease(sdir: str, owner: str, token: int):
    cur = _read_lease(sdir)
    if cur.get("owner") != owner or int(cur.get("token", -1)) != int(token):
        raise MXNetError(f"commit fenced out: lease for {sdir} now held by "
                         f"{cur.get('owner')!r} (token {cur.get('token')}, ours {token}): "
                         f"a newer committer took over; this manifest must not land")


def _release_lease(sdir: str, owner: str):
    if _read_lease(sdir).get("owner") == owner:
        try:
            os.unlink(_lease_path(sdir))
        except OSError:
            pass


def commit(sdir: str, step: int, meta: Dict[str, Any], expected_processes: int = 1,
           timeout: float = 120.0, lease_timeout: float = 30.0) -> Dict[str, Any]:
    """Merge the per-process chunk indexes and atomically write
    ``manifest.json``: the snapshot exists once this returns.

    Process 0 calls it after writing its own shard and polls (up to
    ``timeout`` seconds) for the other processes' index files. Concurrent
    committers are serialized by the lease: the winner's token goes into the
    manifest (``fence``), a loser raises ``MXNetError`` without touching the
    manifest, and a lease older than ``lease_timeout`` seconds is taken
    over."""
    deadline = time.monotonic() + timeout
    while True:
        shard_jsons = sorted(n for n in os.listdir(sdir)
                             if n.startswith("shard-") and n.endswith(".json"))
        if len(shard_jsons) >= expected_processes:
            break
        if time.monotonic() >= deadline:
            raise MXNetError(f"snapshot commit timed out: {len(shard_jsons)}/"
                             f"{expected_processes} shard indexes present in {sdir}")
        time.sleep(0.05)
    owner = f"{os.getpid()}.{threading.get_ident()}.{uuid.uuid4().hex[:8]}"
    token = _acquire_lease(sdir, owner, lease_timeout)
    try:
        if os.path.exists(os.path.join(sdir, MANIFEST)):
            raise MXNetError(f"step {step} is already committed in {sdir}: another "
                             f"writer won the fence; exactly one committer finalizes a "
                             f"snapshot")
        leaves: Dict[str, Any] = {}
        chunks: Dict[str, List[Dict[str, Any]]] = {}
        nbytes = 0
        for name in shard_jsons:
            with open(os.path.join(sdir, name)) as f:
                shard = json.load(f)
            npz = name[:-len(".json")] + ".npz"
            nbytes += int(shard.get("nbytes", 0))
            leaves.update(shard["leaves"])
            for c in shard["chunks"]:
                chunks.setdefault(c["name"], []).append(
                    {"file": npz, "key": c["key"], "index": c["index"]})
        man = {"format": FORMAT, "step": int(step), "meta": meta, "leaves": leaves,
               "chunks": chunks, "nbytes": int(nbytes), "fence": int(token)}

        def _write_manifest():
            tmp = os.path.join(sdir, MANIFEST + ".tmp")
            with open(tmp, "w") as f:
                json.dump(man, f)
                _fsync_file(f)
            # the fencing check: a stale holder that slept past its lease is
            # caught here, after its payload write and before the rename
            _verify_lease(sdir, owner, token)
            os.replace(tmp, os.path.join(sdir, MANIFEST))
            _fsync_dir(sdir)

        _faults.io_retry("elastic.commit", _write_manifest)
        return man
    finally:
        _release_lease(sdir, owner)


def load(root: str, step: int) -> Dict[str, Any]:
    path = os.path.join(step_path(root, step), MANIFEST)
    if not os.path.exists(path):
        raise MXNetError(f"no complete snapshot for step {step} in {root}")

    def _read():
        with open(path) as f:
            return json.load(f)

    man = _faults.io_retry("elastic.read", _read)
    if man.get("format") != FORMAT:
        raise MXNetError(f"snapshot format {man.get('format')!r} unsupported (this "
                         f"build reads format {FORMAT})")
    return man


def _writer_active(sdir: str, grace: float) -> bool:
    """Whether a writer may still be in a manifest-less directory: a commit
    lease or a ``ready-*`` marker stamped within ``grace`` seconds (their
    recorded ``ts``, not file mtimes, so a crashed writer's debris ages
    out)."""
    if grace <= 0.0:
        return False
    now = time.time()
    holder = _read_lease(sdir)
    if holder and now - float(holder.get("ts", 0.0)) <= grace:
        return True
    try:
        names = os.listdir(sdir)
    except OSError:
        return False
    for name in names:
        if not (name.startswith(READY_PREFIX) and name.endswith(".json")):
            continue
        try:
            with open(os.path.join(sdir, name)) as f:
                rec = json.load(f)
        except (OSError, ValueError):
            continue
        if now - float(rec.get("ts", 0.0)) <= grace:
            return True
    return False


def prune(root: str, max_to_keep: int, active_grace: Optional[float] = None) -> List[int]:
    """Retention: drop the oldest complete snapshots beyond ``max_to_keep``
    and every incomplete directory older than the newest complete one (a
    preempted writer's leftovers). Never the newest snapshot, and never an
    incomplete directory a writer may still be in (``_writer_active`` within
    ``active_grace``, default ``MXNET_TPU_PRUNE_GRACE``)."""
    grace = float(env.get("MXNET_TPU_PRUNE_GRACE") if active_grace is None
                  else active_grace)
    complete = all_complete_steps(root)
    removed = []
    if max_to_keep > 0 and len(complete) > max_to_keep:
        for step in complete[:-max_to_keep]:
            shutil.rmtree(step_path(root, step), ignore_errors=True)
            removed.append(step)
    if complete:
        for name in os.listdir(root):
            step = parse_step(name)
            sdir = os.path.join(root, name)
            if step is not None and step < complete[-1] and \
                    not os.path.exists(os.path.join(sdir, MANIFEST)) and \
                    not _writer_active(sdir, grace):
                shutil.rmtree(sdir, ignore_errors=True)
    return removed


# ---------------------------------------------------------------------------
# Reader side (restore)
# ---------------------------------------------------------------------------

class SnapshotReader:
    """Assemble host arrays for named leaves of one snapshot: ``reader(name)``
    is the global numpy array of a leaf, stitched from however many chunks
    the saving mesh wrote; ``read_region(name, region)`` assembles one index
    region, opening only the chunk files that intersect it (a rank reads what
    it holds). A leaf whose chunks do not cover it raises ``MXNetError``."""

    def __init__(self, root: str, step: int, manifest: Optional[Dict[str, Any]] = None):
        self._dir = step_path(root, step)
        self.manifest = manifest if manifest is not None else load(root, step)
        self._npz: Dict[str, Any] = {}

    @property
    def names(self):
        return set(self.manifest["leaves"])

    def _file(self, npz_name: str):
        f = self._npz.get(npz_name)
        if f is None:
            f = self._npz[npz_name] = _faults.io_retry(
                "elastic.read", _np.load, os.path.join(self._dir, npz_name))
        return f

    def read_region(self, name: str, region) -> _np.ndarray:
        """Only ``region`` (``[[start, stop], ...]`` per dim) of leaf ``name``."""
        spec = self.manifest["leaves"].get(name)
        if spec is None:
            raise KeyError(name)
        region = [(int(a), int(b)) for a, b in region]
        out = _np.empty(tuple(b - a for a, b in region), dtype=_np.dtype(spec["dtype"]))
        covered = 0
        for c in self.manifest["chunks"].get(name, ()):
            lo = [max(a, ca) for (a, _), (ca, _) in zip(region, c["index"])]
            hi = [min(b, cb) for (_, b), (_, cb) in zip(region, c["index"])]
            if any(l >= h for l, h in zip(lo, hi)):
                continue
            chunk = self._file(c["file"])[c["key"]]
            src = tuple(slice(l - ca, h - ca) for l, h, (ca, _) in zip(lo, hi, c["index"]))
            dst = tuple(slice(l - a, h - a) for l, h, (a, _) in zip(lo, hi, region))
            out[dst] = chunk[src]
            covered += int(_np.prod([h - l for l, h in zip(lo, hi)]))
        if covered != out.size:
            raise MXNetError(f"snapshot leaf {name!r} region {region}: chunks cover "
                             f"{covered} of {out.size} elements: corrupt or partial "
                             f"snapshot")
        return out

    def __call__(self, name: str) -> _np.ndarray:
        spec = self.manifest["leaves"].get(name)
        if spec is None:
            raise KeyError(name)
        out = _np.empty(tuple(spec["shape"]), dtype=_np.dtype(spec["dtype"]))
        covered = 0
        for c in self.manifest["chunks"].get(name, ()):
            chunk = self._file(c["file"])[c["key"]]
            out[tuple(slice(a, b) for a, b in c["index"])] = chunk
            covered += int(chunk.size)
        if covered != out.size:
            raise MXNetError(f"snapshot leaf {name!r}: chunks cover {covered} of "
                             f"{out.size} elements: corrupt or partial snapshot")
        return out

    def close(self):
        for f in self._npz.values():
            f.close()
        self._npz.clear()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
