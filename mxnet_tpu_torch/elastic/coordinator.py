"""The shared-filesystem control plane of a multi-host job.

Counterpart of ``mxnet_tpu/elastic/coordinator.py``. A job of N equal hosts
has no scheduler; what stands in for one is a little fenced state on the
snapshot filesystem, which an elastic fleet shares anyway. It gives the
hosts membership, a leader, a coordinated stop and a two-phase cross-host
snapshot commit, all as host-side file IO, so it runs the same on a cluster
and in a CPU-only test (``elastic/drill.py`` drives it with real processes).

Layout under ``<root>/coord/``, byte-compatible with the reference's so
either package's hosts read the other's:

    members/host-<rank>.json   heartbeat {rank, pid, generation, fence, step,
                               ts}, rewritten atomically; a record older
                               than ``lease_timeout`` is a dead host
    generation.json            the group epoch {generation, live, ts, fence}:
                               every observed change of membership (join,
                               leave, lease expiry) bumps ``generation`` under
                               the ``generation.lock`` lease
    stop.json                  the coordinated stop's intent (written whole,
                               published by a link: the first poster wins)
    stop-ack-<rank>.json       the quiesce acks; the final step S is the
                               largest ack of the live members

and in each snapshot's step directory, next to the shards:

    ready-<rank>.json          the commit marker {rank, step, generation,
                               fence, chunk_index, file, nbytes, live, ts}

The two-phase commit: every host writes only the chunks it owns and its
marker; the leader (the lowest live rank, fenced by ``manifest.py``'s commit
lease) writes the global manifest once every member of the live set stamped
in its marker posted a marker for the same (step, generation). A straggler
deadline aborts the snapshot (``StragglerTimeout``) rather than committing a
hole: the step directory stays without a manifest, invisible to restore.

All the coordinator's IO runs under ``faults.io_retry`` with three
injection points (``elastic.heartbeat``, ``elastic.barrier``,
``elastic.marker``). With telemetry on (reference :183-768): ``view``
books ``mx_hosts_live`` and the generation, a commit's wait
``mx_commit_barrier_seconds``, a straggler abort
``mx_snapshot_failures_total{source="straggler"}`` (and
``straggler_aborts``, which counts them always), a watchdog firing
``mx_hang_watchdog_fires_total``; with tracing armed, the stop, its
resolution, the straggler abort and the watchdog are recorder events, the
commit barrier a span, and a firing watchdog dumps the flight recorder. The
reference's goodput ledger waits for its slice.
"""
from __future__ import annotations

import json
import os
import sys
import threading
import time
import weakref
import zlib
from typing import Any, Callable, Dict, List, Optional

from ..base import MXNetError, env
from .. import faults as _faults
from .. import telemetry as _telem
from ..telemetry import tracing as _tracing
from . import manifest as _manifest

__all__ = ["Coordinator", "GroupView", "StragglerTimeout", "HangWatchdog", "statusz_view"]

COORD_DIR = "coord"
MEMBERS_DIR = "members"
GENERATION = "generation.json"
GEN_LOCK = "generation.lock"
STOP = "stop.json"
READY_PREFIX = "ready-"

env.declare("MXNET_TPU_COORD_LEASE", 10.0, float,
            "Coordinator membership lease in seconds: a host whose heartbeat record is "
            "older than this is declared dead (its departure bumps the group generation)")
env.declare("MXNET_TPU_COORD_STRAGGLER", 60.0, float,
            "Cross-host snapshot commit deadline in seconds: a live member whose ready "
            "marker does not land within this aborts the snapshot cleanly instead of "
            "committing a hole")


class StragglerTimeout(MXNetError):
    """A cross-host snapshot commit was aborted: a member of the
    generation's live set posted no ready marker (or one of another
    generation) within the straggler deadline. The step directory has no
    manifest: restore never sees a hole."""


def _host_name(rank: int) -> str:
    return f"host-{int(rank):05d}.json"


def _ready_name(rank: int) -> str:
    return f"{READY_PREFIX}{int(rank):05d}.json"


def _ack_name(rank: int) -> str:
    return f"stop-ack-{int(rank):05d}.json"


def _write_json_atomic(path: str, payload: Dict[str, Any]):
    # the temporary name is per thread: the run loop and the snapshot writer
    # both heartbeat, and one must not truncate the other's record
    tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
    with open(tmp, "w") as f:
        json.dump(payload, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def _read_json(path: str) -> Dict[str, Any]:
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError):
        return {}


class GroupView:
    """One generation-stamped observation of the group: who is live (a fresh
    heartbeat), who is dead (lease expired), and the leader (the lowest live
    rank)."""

    def __init__(self, generation: int, members: Dict[int, Dict[str, Any]],
                 live: List[int], dead: List[int]):
        self.generation = int(generation)
        self.members = members
        self.live = sorted(int(r) for r in live)
        self.dead = sorted(int(r) for r in dead)

    @property
    def leader(self) -> Optional[int]:
        return self.live[0] if self.live else None

    def as_dict(self) -> Dict[str, Any]:
        return {"generation": self.generation, "live": self.live, "dead": self.dead,
                "leader": self.leader,
                "steps": {str(r): m.get("step") for r, m in sorted(self.members.items())}}


class HangWatchdog:
    """A wall-clock deadline on a blocking section (a drain, a commit
    barrier, heartbeat IO that stopped completing). On expiry it prints a
    one-line diagnosis, calls ``on_fire(what)``, and with ``action="exit"``
    (the default) ends the process (exit code 86) rather than hang the
    fleet; ``action="flag"`` only sets ``fired``."""

    def __init__(self, timeout: float, what: str = "drain", action: str = "exit",
                 on_fire: Optional[Callable] = None):
        self.timeout = float(timeout)
        self.what = str(what)
        self.action = action
        self.on_fire = on_fire
        self.fired = False
        self._done = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def _watch(self):
        if not self._done.wait(self.timeout):
            self._fire()

    def _fire(self):
        self.fired = True
        if _telem._ENABLED:
            _telem.record_hang_watchdog(self.what)
        if _tracing._ENABLED:
            _tracing.event("mx.hang_watchdog", what=self.what, timeout=self.timeout)
            try:
                _tracing.dump_flight_recorder(reason=f"hang:{self.what}")
            except Exception:       # the dump must never mask the diagnosis
                pass
        print(f"mx_hang_watchdog: {self.what!r} exceeded its {self.timeout:.1f}s "
              f"wall-clock deadline; exiting rather than hanging the fleet",
              file=sys.stderr, flush=True)
        if self.on_fire is not None:
            self.on_fire(self.what)
        if self.action == "exit":
            os._exit(86)

    def __enter__(self):
        self._done.clear()
        self.fired = False
        self._thread = threading.Thread(target=self._watch, daemon=True,
                                        name=f"mx-hang-watchdog-{self.what}")
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._done.set()
        if self._thread is not None:
            self._thread.join(timeout=1.0)
            self._thread = None
        return False


class _NullWatchdog:
    fired = False

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


# live coordinators for statusz_view (weak: a finished job's coordinator is
# not kept alive by it)
_REGISTRY: "weakref.WeakValueDictionary[int, Coordinator]" = weakref.WeakValueDictionary()
_REGISTRY_LOCK = threading.Lock()
_REGISTRY_SEQ = [0]


def statusz_view() -> Dict[str, Any]:
    """The group view of the most recently made live coordinator (read
    only: it never bumps the generation); ``{}`` when there is none."""
    with _REGISTRY_LOCK:
        items = sorted(_REGISTRY.items())
    if not items:
        return {}
    coord = items[-1][1]
    d = coord.view(bump=False).as_dict()
    d["rank"] = coord.rank
    d["fence"] = coord.fence
    return d


class Coordinator:
    """One host's handle on the control plane under ``root``.

    ``rank`` is the host's stable worker index; ``lease_timeout`` the
    membership lease (default ``MXNET_TPU_COORD_LEASE``);
    ``heartbeat_interval`` throttles the heartbeat and stop poll of the step
    path (0: every call); ``straggler_timeout`` the commit deadline (default
    ``MXNET_TPU_COORD_STRAGGLER``); ``watchdog_timeout`` arms
    ``watchdog()``. ``partition_ownership=True`` makes this host write only
    the snapshot leaves ``owns`` gives it (replicated models, the drill);
    sharded trainers keep it False, their chunks have an owner already.

    The heartbeat is written on the caller's thread at each step boundary
    (``step_poll``) and in the commit's wait loops, not by a thread of its
    own: a step or a host section longer than ``lease_timeout`` makes peers
    see this host dead, so size the lease above the longest step."""

    def __init__(self, root: str, rank: int, *, lease_timeout: Optional[float] = None,
                 heartbeat_interval: float = 0.0, straggler_timeout: Optional[float] = None,
                 watchdog_timeout: Optional[float] = None, partition_ownership: bool = False,
                 poll_interval: float = 0.02, clock: Callable[[], float] = time.time):
        self.root = os.path.abspath(root)
        self.rank = int(rank)
        self.lease_timeout = float(env.get("MXNET_TPU_COORD_LEASE")
                                   if lease_timeout is None else lease_timeout)
        self.heartbeat_interval = float(heartbeat_interval)
        self.straggler_timeout = float(env.get("MXNET_TPU_COORD_STRAGGLER")
                                       if straggler_timeout is None else straggler_timeout)
        self.watchdog_timeout = watchdog_timeout
        self.partition_ownership = bool(partition_ownership)
        self.poll_interval = float(poll_interval)
        self._clock = clock
        self.generation = 0
        self.fence = 0           # the generation at (re)join: monotonic under a root
        self.straggler_aborts = 0
        self._joined = False
        self._last_beat = float("-inf")           # throttle (the clock's domain)
        self._last_beat_ok: Optional[float] = None  # staleness (monotonic)
        self._stop_seen: Optional[Dict[str, Any]] = None
        self._dead_seen: set = set()
        self._live_seen: set = set()
        # drill hooks (elastic/drill.py): crash and delay simulation
        self.debug_exit_after_marker: Optional[int] = None
        self.debug_marker_delay: Optional[tuple] = None   # (step, seconds)
        self.debug_force_leader = False
        self._cdir = os.path.join(self.root, COORD_DIR)
        self._mdir = os.path.join(self._cdir, MEMBERS_DIR)
        os.makedirs(self._mdir, exist_ok=True)
        with _REGISTRY_LOCK:
            _REGISTRY_SEQ[0] += 1
            _REGISTRY[_REGISTRY_SEQ[0]] = self

    # -- the generation epoch (a fenced read-modify-write) ----------------------------
    def _gen_record(self) -> Dict[str, Any]:
        rec = _read_json(os.path.join(self._cdir, GENERATION))
        return {"generation": int(rec.get("generation", 0)),
                "live": [int(r) for r in rec.get("live", [])]}

    def _update_generation(self, mutate) -> Dict[str, Any]:
        """``generation.json`` updated under the ``generation.lock`` lease:
        ``mutate(cur)`` gives the new record, or None to leave it. Racing
        observers' bumps coalesce instead of interleaving."""
        owner = f"{self.rank}.{os.getpid()}.{threading.get_ident()}"

        def _locked_update():
            token = _manifest._acquire_lease(self._cdir, owner, self.lease_timeout,
                                             lease_name=GEN_LOCK)
            try:
                cur = self._gen_record()
                new = mutate(cur)
                if new is None:
                    return cur
                new["generation"] = max(int(new["generation"]), cur["generation"])
                new["ts"] = self._clock()
                new["fence"] = int(token)
                _write_json_atomic(os.path.join(self._cdir, GENERATION), new)
                return new
            finally:
                _manifest._release_lease(self._cdir, owner, lease_name=GEN_LOCK)

        deadline = time.monotonic() + max(2.0, 2 * self.lease_timeout)
        while True:
            try:
                return _faults.io_retry("elastic.barrier", _locked_update)
            except MXNetError:
                # a peer holds the lock: its update is as good as ours; retry
                # the mutation against the newer record until the deadline
                if time.monotonic() >= deadline:
                    raise
                time.sleep(self.poll_interval)

    # -- membership ----------------------------------------------------------------
    def join(self) -> int:
        """Register this host: bump the generation (fenced), take the new
        value as this incarnation's fence, write the first heartbeat. A
        rejoin after being declared dead bumps it again."""
        def _mutate(cur):
            return {"generation": cur["generation"] + 1,
                    "live": sorted(set(cur["live"]) | {self.rank})}

        rec = self._update_generation(_mutate)
        self.generation = rec["generation"]
        self.fence = rec["generation"]
        self._joined = True
        self._sweep_expired_members()
        self.heartbeat(step=None, force=True)
        return self.generation

    def _sweep_expired_members(self):
        """Delete heartbeat files whose lease already expired (debris of a
        previous incarnation); a slow host rewrites its file at its next
        heartbeat."""
        now = self._clock()
        try:
            names = os.listdir(self._mdir)
        except OSError:
            return
        for name in names:
            if not name.startswith("host-") or not name.endswith(".json"):
                continue
            path = os.path.join(self._mdir, name)
            rec = _read_json(path)
            if rec and now - float(rec.get("ts", 0.0)) > self.lease_timeout:
                try:
                    os.unlink(path)
                except OSError:
                    pass

    def leave(self):
        """Clean shutdown: drop the heartbeat record and this rank from the
        live set (peers would otherwise wait a lease for the expiry)."""
        if not self._joined:
            return
        self._joined = False
        try:
            os.unlink(os.path.join(self._mdir, _host_name(self.rank)))
        except OSError:
            pass

        def _mutate(cur):
            if self.rank not in cur["live"]:
                return None
            return {"generation": cur["generation"] + 1,
                    "live": [r for r in cur["live"] if r != self.rank]}

        try:
            self._update_generation(_mutate)
        except MXNetError:
            pass            # best effort: the lease's expiry covers a lost leave

    def heartbeat(self, step: Optional[int] = None, force: bool = False) -> bool:
        """Refresh this host's lease (throttled to ``heartbeat_interval``). A
        write that fails after its retries does not raise (the host trains on
        while peers see a stale lease) but returns False and ages
        ``heartbeat_staleness()``. A host the peers declared dead rejoins
        under a new generation."""
        now = self._clock()
        if not force and now - self._last_beat < self.heartbeat_interval:
            return True
        self._last_beat = now
        payload = {"rank": self.rank, "pid": os.getpid(), "generation": self.generation,
                   "fence": self.fence, "step": None if step is None else int(step),
                   "ts": now}
        path = os.path.join(self._mdir, _host_name(self.rank))
        try:
            _faults.io_retry("elastic.heartbeat", _write_json_atomic, path, payload)
        except (OSError, MXNetError):
            return False
        self._last_beat_ok = time.monotonic()
        rec = self._gen_record()
        if self._joined and rec["generation"] > 0 and self.rank not in rec["live"]:
            self.join()
        return True

    def heartbeat_staleness(self) -> float:
        """Seconds since this host's last successful heartbeat write."""
        if self._last_beat_ok is None:
            return float("inf")
        return time.monotonic() - self._last_beat_ok

    def view(self, bump: bool = True) -> GroupView:
        """Every member record, live or dead by lease. When the live set
        differs from the epoch's and ``bump`` is True the generation is
        bumped (fenced), once however many hosts observe the change."""
        now = self._clock()
        members: Dict[int, Dict[str, Any]] = {}
        try:
            names = os.listdir(self._mdir)
        except OSError:
            names = []
        for name in names:
            if not name.startswith("host-") or not name.endswith(".json"):
                continue
            rec = _read_json(os.path.join(self._mdir, name))
            if "rank" in rec:
                members[int(rec["rank"])] = rec
        live = [r for r, m in members.items()
                if now - float(m.get("ts", 0.0)) <= self.lease_timeout]
        dead = [r for r in members if r not in live]
        rec = self._gen_record()
        generation = rec["generation"]
        if bump and sorted(live) != sorted(rec["live"]):
            def _mutate(cur):
                if sorted(cur["live"]) == sorted(live):
                    return None              # a peer recorded it already
                return {"generation": cur["generation"] + 1, "live": sorted(live)}

            generation = self._update_generation(_mutate)["generation"]
        if self._joined and self.rank in live:
            self.generation = generation
        self._live_seen.update(live)
        v = GroupView(generation, members, live, dead)
        if _telem._ENABLED:
            _telem.record_hosts_live(len(v.live), generation)
        return v

    def is_leader(self) -> bool:
        return self.view(bump=False).leader == self.rank

    # -- leaf ownership --------------------------------------------------------------
    def owns(self, name: str) -> bool:
        """Whether this host writes leaf ``name``: a partition over the
        current epoch's live set that every host of a generation computes
        alike (crc32 of the name), so chunks neither overlap nor leave a
        hole."""
        live = sorted(self._gen_record()["live"]) or [self.rank]
        return live[zlib.crc32(name.encode()) % len(live)] == self.rank

    # -- the coordinated stop ----------------------------------------------------------
    def _stop_stale(self, rec: Dict[str, Any]) -> bool:
        """A stop intent of a previous incarnation (its generation predates
        this host's join fence) is history, not an instruction."""
        return int(rec.get("generation", 0)) < self.fence

    def post_stop(self, step: int, reason: str = "preempted") -> Dict[str, Any]:
        """Post the stop intent (the first poster wins; a later post returns
        the existing one). Its ``id`` is generation-scoped, and the acks name
        it.

        The intent is written whole to a file of this thread's own and then
        published by ``os.link``, which never replaces an existing file: a
        reader of ``stop.json`` sees either no file or a complete one. (A
        file created empty and written after, the reference's way, let a
        second poster read it empty in between and overwrite it with its own
        id, so the survivors acked two intents and none resolved.) A stale
        intent of a finished incarnation is moved aside under a name of this
        thread's own; moved by mistake, a fresh one is linked back. An empty
        or partial file (a reference host writes it after creating it) is
        read again for a second before it counts as stale."""
        path = os.path.join(self._cdir, STOP)
        payload = {"step": int(step), "rank": self.rank, "generation": self.generation,
                   "reason": str(reason), "id": f"g{self.generation}.r{self.rank}",
                   "ts": self._clock()}
        mine = f"{path}.{os.getpid()}.{threading.get_ident()}"

        def _post():
            tmp = mine + ".post"
            with open(tmp, "w") as f:
                json.dump(payload, f)
                f.flush()
                os.fsync(f.fileno())
            try:
                while True:
                    try:
                        os.link(tmp, path)
                        return payload
                    except FileExistsError:
                        pass
                    cur = _read_json(path)
                    until = time.monotonic() + max(1.0, self.poll_interval)
                    while not cur and os.path.exists(path) and time.monotonic() < until:
                        time.sleep(0.005)   # being written
                        cur = _read_json(path)
                    if cur and not self._stop_stale(cur):
                        return cur
                    aside = mine + ".stale"
                    try:
                        os.rename(path, aside)
                    except FileNotFoundError:
                        continue
                    moved = _read_json(aside)
                    if moved and not self._stop_stale(moved):
                        try:                # a peer's fresh intent: put it back
                            os.link(aside, path)
                            return moved
                        except FileExistsError:
                            pass
                        finally:
                            os.unlink(aside)
                    else:
                        os.unlink(aside)
            finally:
                os.unlink(tmp)

        out = _faults.io_retry("elastic.barrier", _post)
        self._stop_seen = out
        if _tracing._ENABLED:
            _tracing.event("mx.coord.stop", step=int(out.get("step", step)),
                           rank=int(out.get("rank", self.rank)),
                           reason=str(out.get("reason", reason)))
        return out

    def stop_posted(self) -> Optional[Dict[str, Any]]:
        if self._stop_seen is not None:
            return self._stop_seen
        rec = _read_json(os.path.join(self._cdir, STOP))
        if rec and not self._stop_stale(rec):
            self._stop_seen = rec
        return self._stop_seen

    def step_poll(self, step: int) -> Optional[Dict[str, Any]]:
        """The step-boundary hook of ``elastic.run``: refresh the heartbeat,
        see a posted stop, and detect dead peers (a peer this incarnation saw
        live whose lease expired posts a ``peer_dead`` stop). Throttled by
        ``heartbeat_interval``; returns the stop intent or None."""
        throttled = self._clock() - self._last_beat < self.heartbeat_interval
        self.heartbeat(step)
        stop = self._stop_seen
        if stop is None and not throttled:
            stop = self.stop_posted()
        if stop is None and not throttled:
            v = self.view()
            newly_dead = [r for r in v.dead if r in self._live_seen
                          and r not in self._dead_seen]
            if newly_dead:
                self._dead_seen.update(newly_dead)
                stop = self.post_stop(step, reason="peer_dead")
        return stop

    def resolve_stop(self, step: int, timeout: Optional[float] = None) -> int:
        """The quiesce: post this host's ack at ``step`` and wait until every
        live member acked the same intent (dead peers drop out as their
        leases expire). Returns ``S = max(acks, the intent's step)``: a host
        with ``step < S`` runs ``S - step`` more steps before the final
        snapshot, so every survivor snapshots the same S."""
        deadline = time.monotonic() + (self.straggler_timeout if timeout is None
                                       else float(timeout))
        stop = self.stop_posted() or {}
        stop_id = stop.get("id")
        _faults.io_retry("elastic.barrier", _write_json_atomic,
                         os.path.join(self._cdir, _ack_name(self.rank)),
                         {"rank": self.rank, "step": int(step), "stop_id": stop_id,
                          "generation": self.generation, "ts": self._clock()})
        while True:
            self.heartbeat(step)
            v = self.view()
            acks = {}
            for r in v.live:
                rec = _read_json(os.path.join(self._cdir, _ack_name(r)))
                if rec and rec.get("stop_id") == stop_id:
                    acks[r] = int(rec.get("step", 0))
            if v.live and all(r in acks for r in v.live):
                s = max(list(acks.values()) + [int(stop.get("step", 0))])
                if _tracing._ENABLED:
                    _tracing.event("mx.coord.stop_resolved", step=s, generation=v.generation)
                return s
            if time.monotonic() >= deadline:
                missing = [r for r in v.live if r not in acks]
                raise MXNetError(f"coordinated stop did not resolve: live members "
                                 f"{missing} never acked within the deadline")
            self._check_self_stale()
            time.sleep(self.poll_interval)

    # -- the two-phase cross-host commit -------------------------------------------
    def write_marker(self, sdir: str, step: int, nbytes: int) -> int:
        """Phase 1: after writing its owned chunks a host posts
        ``ready-<rank>.json``, stamped with the (step, generation) it wrote
        under, its fence and the live set its ownership was computed from.
        Returns the generation. A step that has a manifest already is left
        as it is."""
        if os.path.exists(os.path.join(sdir, _manifest.MANIFEST)):
            return self.generation
        v = self.view()
        if self.debug_marker_delay is not None and \
                int(self.debug_marker_delay[0]) == int(step):
            time.sleep(float(self.debug_marker_delay[1]))
        payload = {"rank": self.rank, "step": int(step), "generation": v.generation,
                   "fence": self.fence, "chunk_index": int(self.rank),
                   "file": f"shard-{self.rank:05d}.npz", "nbytes": int(nbytes),
                   "live": v.live, "ts": self._clock()}
        _faults.io_retry("elastic.marker", _write_json_atomic,
                         os.path.join(sdir, _ready_name(self.rank)), payload)
        if self.debug_exit_after_marker is not None and \
                int(self.debug_exit_after_marker) == int(step):
            # the kill-leader drill: leave a fresh commit lease behind, as a
            # holder that died between the lease and the manifest's rename
            tmp = os.path.join(sdir, _manifest.LEASE + ".crash.tmp")
            _manifest._write_lease_to(tmp, f"crashed-{self.rank}", 1)
            os.replace(tmp, os.path.join(sdir, _manifest.LEASE))
            os._exit(40 + self.rank)
        return v.generation

    def _markers(self, sdir: str) -> Dict[int, Dict[str, Any]]:
        out = {}
        try:
            names = os.listdir(sdir)
        except OSError:
            return out
        for name in names:
            if name.startswith(READY_PREFIX) and name.endswith(".json"):
                rec = _read_json(os.path.join(sdir, name))
                if "rank" in rec:
                    out[int(rec["rank"])] = rec
        return out

    def commit_snapshot(self, sdir: str, step: int, meta: Dict[str, Any],
                        timeout: Optional[float] = None) -> Dict[str, Any]:
        """Phase 2: converge on one generation-stamped manifest. Every host
        calls it after ``write_marker``; whoever the current view makes
        leader writes the manifest once every required marker for (step,
        generation) exists, so a leader that dies mid-commit is replaced by
        the next live rank (the manifest's lease fences the dead one out).
        Raises ``StragglerTimeout`` when a required marker is still missing,
        or from another generation, at the deadline, and at once when a
        required host whose marker is missing is dead (its lease expired):
        that marker can never land. (The reference waits out the deadline
        there; a host blocked on such a commit could not ack a coordinated
        stop, whose wait has the same deadline, and the two deadlines raced.)"""
        t0 = time.perf_counter()
        deadline = t0 + (self.straggler_timeout if timeout is None else float(timeout))
        my_gen = None
        while True:
            self.heartbeat(step)
            if os.path.exists(os.path.join(sdir, _manifest.MANIFEST)):
                man = _manifest.load(self.root, int(step))
                self.validate_manifest(man, int(step))
                seconds = time.perf_counter() - t0
                if _telem._ENABLED:
                    _telem.record_commit_barrier(seconds)
                if _tracing._ENABLED:
                    _tracing.record_span("mx.coord.commit_barrier", t0, time.perf_counter(),
                                         step=int(step),
                                         generation=man["meta"].get("generation"))
                return man
            markers = self._markers(sdir)
            mine = markers.get(self.rank)
            if my_gen is None and mine is not None:
                my_gen = int(mine.get("generation", self.generation))
            v = self.view()
            if mine is not None:
                lost = [r for r in (int(x) for x in mine.get("live", []))
                        if r not in markers and r in v.dead]
                if lost:
                    self._abort_straggler(sdir, step, f"ranks {lost} died (lease expired) "
                                                      f"before posting their ready markers")
            if mine is not None and (v.leader == self.rank or self.debug_force_leader):
                required = [int(r) for r in mine.get("live", v.live)]
                have = {r: m for r, m in markers.items() if r in required}
                gens = {int(m.get("generation", -1)) for m in have.values()}
                if len(have) == len(required) and gens == {my_gen}:
                    meta2 = dict(meta)
                    meta2["generation"] = my_gen
                    meta2["members"] = sorted(required)
                    try:
                        _manifest.commit(sdir, int(step), meta2,
                                         expected_processes=len(required),
                                         lease_timeout=self.lease_timeout, ranks=required)
                    except MXNetError:
                        # lost the race to another fenced committer: the check
                        # at the loop's top picks the winner's manifest up
                        time.sleep(self.poll_interval)
                    continue
                if gens - {my_gen} and len(have) == len(required):
                    self._abort_straggler(sdir, step, f"markers span generations "
                                                      f"{sorted(gens)} (ours {my_gen})")
            if time.perf_counter() >= deadline:
                missing = []
                if mine is not None:
                    missing = [r for r in (int(x) for x in mine.get("live", []))
                               if r not in markers]
                self._abort_straggler(sdir, step,
                                      f"missing ready markers from ranks {missing}"
                                      if missing else "no manifest within the deadline")
            self._check_self_stale()
            time.sleep(self.poll_interval)

    def _abort_straggler(self, sdir: str, step: int, why: str):
        """A clean abort: counted, and no manifest (the directory stays
        invisible to restore; retention sweeps it once its markers age)."""
        self.straggler_aborts += 1
        if _telem._ENABLED:
            _telem.counter("mx_snapshot_failures_total",
                           "Interval snapshots skipped after exhausting IO retries",
                           ("source",)).labels("straggler").inc()
        if _tracing._ENABLED:
            _tracing.event("mx.coord.straggler_abort", step=int(step), why=why)
        raise StragglerTimeout(f"cross-host snapshot commit aborted at step {step}: {why} "
                               f"(straggler deadline {self.straggler_timeout:.1f}s; dir "
                               f"{sdir} stays manifest-less)")

    # -- restore-side validation -----------------------------------------------------
    def validate_manifest(self, man: Dict[str, Any], step: int):
        """A manifest to restore must carry a fencing token, its generation
        may not be ahead of this root's epoch, and the ready markers still on
        disk for the step must agree with its (step, generation)."""
        fence = man.get("fence")
        if not isinstance(fence, int) or fence < 1:
            raise MXNetError(f"snapshot step {step}: manifest carries no commit fence "
                             f"token; refused (written by a pre-coordinator writer or "
                             f"tampered)")
        gen = man.get("meta", {}).get("generation")
        if gen is None:
            return
        cur = self._gen_record()["generation"]
        if cur and int(gen) > cur:
            raise MXNetError(f"snapshot step {step}: manifest generation {gen} is ahead of "
                             f"this root's epoch {cur}: mixed snapshot roots or a wiped "
                             f"coord dir; refusing to restore")
        members = man.get("meta", {}).get("members") or []
        for rank, rec in self._markers(_manifest.step_path(self.root, int(step))).items():
            if rank in members and (int(rec.get("step", -1)) != int(step)
                                    or int(rec.get("generation", -1)) != int(gen)):
                raise MXNetError(f"snapshot step {step}: ready marker of rank {rank} is "
                                 f"stamped (step {rec.get('step')}, generation "
                                 f"{rec.get('generation')}) but the manifest says (step "
                                 f"{step}, generation {gen}): inconsistent commit; refusing "
                                 f"to restore")

    # -- the hang watchdog ------------------------------------------------------------
    def watchdog(self, what: str = "drain"):
        """A ``HangWatchdog`` over a blocking section when
        ``watchdog_timeout`` is set, else a context that does nothing."""
        if self.watchdog_timeout is None:
            return _NullWatchdog()
        return HangWatchdog(self.watchdog_timeout, what=what)

    def _check_self_stale(self):
        """In a wait loop: this host's own heartbeat not landing for a whole
        watchdog deadline means the filesystem or the process is wedged."""
        if self.watchdog_timeout is None:
            return
        if self.heartbeat_staleness() > float(self.watchdog_timeout):
            HangWatchdog(0.0, what="heartbeat")._fire()

    # -- lifecycle ----------------------------------------------------------------------
    def close(self):
        self.leave()

    def __enter__(self):
        if not self._joined:
            self.join()
        return self

    def __exit__(self, *exc):
        self.close()
        return False
