"""The threaded TCP parameter server behind ``dist_async``.

Counterpart of ``mxnet_tpu/kvstore/ps.py`` (the reference's
``kvstore_dist_server.h:325`` ``DataHandleDefault`` and ps-lite's push/pull
RPC). Each key lives at a home rank (``KVStoreDist._home``); every worker's
push is applied there on arrival, in arrival order and with no barrier, and
a pull fetches the home's current value, so an asynchronous worker sees the
others' pushes without synchronizing. Every process runs one daemon server
thread for the keys whose home it is; the address rendezvous goes through
the key-value store of the job's process group (``_dist_util.store()``, a
``FileStore`` or ``TCPStore``: the counterpart of the reference's
``coordinator_kv()``, the jax.distributed client's store).

Wire format: length-prefixed pickles of ``(op, ...)`` tuples with numpy
payloads (``_pack``/``_unpack``); a tensor on the card is copied to the host
before it is packed. This is a compatibility path, not the fast path: the
fused trainers reduce gradients with collectives.

``PSServer`` keeps plain counters where the reference books telemetry:
``push_counts`` (pushes applied, by key) and ``applied`` (the client ids of
the pushes applied to a key, in order).
"""
from __future__ import annotations

import os
import pickle
import socket
import struct
import threading
import time
from typing import Callable, Dict, Optional

import numpy as np

from ..base import MXNetError

_HDR = struct.Struct("<Q")

# a duplicate's server-side wait for the in-flight original stays under the
# client's receive timeout, or the waiter's reply could never reach a live
# client and a re-push under a fresh seq would apply twice
_CLIENT_RECV_TIMEOUT = 600.0
_INFLIGHT_WAIT = _CLIENT_RECV_TIMEOUT - 10.0
RENDEZVOUS_TIMEOUT_S = 120.0


def _send_msg(sock: socket.socket, obj) -> None:
    data = pickle.dumps(obj, protocol=4)
    sock.sendall(_HDR.pack(len(data)) + data)


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    chunks = []
    got = 0
    while got < n:
        c = sock.recv(min(n - got, 1 << 20))
        if not c:
            raise ConnectionError("peer closed")
        chunks.append(c)
        got += len(c)
    return b"".join(chunks)


def _recv_msg(sock: socket.socket):
    (n,) = _HDR.unpack(_recv_exact(sock, _HDR.size))
    return pickle.loads(_recv_exact(sock, n))


def _pack(arr) -> tuple:
    """``(dtype, shape, bytes)`` of a numpy array or a tensor (copied to the
    host first)."""
    if hasattr(arr, "detach"):
        arr = arr.detach().cpu().numpy()
    a = np.ascontiguousarray(np.asarray(arr))
    return (str(a.dtype), a.shape, a.tobytes())


def _unpack(payload) -> np.ndarray:
    dtype, shape, raw = payload
    return np.frombuffer(raw, dtype=dtype).reshape(shape).copy()


class PSServer:
    """One daemon thread a process serving the keys whose home it is.

    Requests, each answered on the caller's connection:

    - ``("init", key, payload)`` -> ``("ok",)``: the first init wins;
    - ``("push", key, payload[, stype])`` -> ``("ok",)``: the updater, or
      the pushed value replaces the stored one;
    - ``("pull", key)`` -> ``("ok", payload)`` or ``("missing",)``;
    - ``("pull_rows", key, ids)`` -> ``("ok", payload)``: the rows only;
    - ``("has", key)`` -> ``("ok",)`` or ``("missing",)``.

    A request may come in the exactly-once envelope ``("req", client_id,
    seq, inner)``: the server keeps the last (seq, response) of each client
    and answers a duplicate seq of a push or init with that response instead
    of applying it again, so a retry after a lost reply cannot apply one
    gradient twice (ps-lite's resender). A duplicate that arrives while the
    original is still being applied waits for it. Locks are per key (and a
    guard for the registries): each key keeps arrival order, different keys
    proceed at once.

    ``get_updater()`` gives the updater at each push: ``updater(key, grad,
    stored)`` on CPU ``NDArray``s (the server's copy of the value), which it
    updates in place."""

    def __init__(self, get_updater: Callable[[], Optional[Callable]]):
        self._get_updater = get_updater
        self._store: Dict = {}
        self._guard = threading.Lock()
        self._key_locks: Dict = {}
        self._dedup: Dict[str, tuple] = {}     # client_id -> (last seq, response)
        self.push_counts: Dict = {}
        self.applied: Dict = {}
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind(("", 0))
        self._sock.listen(64)
        self.port = self._sock.getsockname()[1]
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._accept_loop, daemon=True,
                                        name="mxtpu-ps-server")
        self._thread.start()

    def _accept_loop(self):
        while not self._stop.is_set():
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return
            threading.Thread(target=self._serve, args=(conn,), daemon=True).start()

    def _serve(self, conn: socket.socket):
        try:
            while True:
                msg = _recv_msg(conn)
                try:
                    # _handle does no socket IO: any exception is the handler's
                    # and goes back to the client as an error reply
                    resp = self._handle(msg)
                except Exception as e:  # noqa: BLE001 - surfaced to the client
                    resp = ("error", f"{type(e).__name__}: {e}"[:500])
                _send_msg(conn, resp)
        except (ConnectionError, OSError):
            pass
        finally:
            conn.close()

    def _key_lock(self, key) -> threading.Lock:
        with self._guard:
            lock = self._key_locks.get(key)
            if lock is None:
                lock = self._key_locks[key] = threading.Lock()
            return lock

    def _handle(self, msg, client=None):
        if msg[0] == "req":
            _, cid, seq, inner = msg
            if inner[0] not in ("push", "init"):
                return self._handle(inner, cid)        # idempotent: run again
            with self._guard:
                last = self._dedup.get(cid)
                if last is not None and last[0] == seq:
                    pending = last[1]
                elif last is not None and last[0] > seq:
                    # unreachable through PSClient, whose per-home lock orders
                    # retries before any newer send; never fake a success
                    return ("error", "superseded duplicate seq")
                else:
                    pending = None
                    self._dedup[cid] = (seq, threading.Event())
            if pending is not None:
                if isinstance(pending, threading.Event):
                    pending.wait(timeout=_INFLIGHT_WAIT)
                    with self._guard:
                        last = self._dedup.get(cid)
                        if last is not None and last[0] == seq and \
                                not isinstance(last[1], threading.Event):
                            return last[1]
                    return ("error", "in-flight duplicate never completed")
                return pending
            resp = err = None
            try:
                resp = self._handle(inner, cid)
            except Exception as e:  # noqa: BLE001 - cached, then re-raised
                err = f"{type(e).__name__}: {e}"[:500]
                raise
            finally:
                # always release the waiters, with the real error for a retry;
                # replace only this request's entry
                with self._guard:
                    cur = self._dedup.get(cid)
                    if cur is not None and cur[0] == seq:
                        final = resp if resp is not None else \
                            ("error", err or "apply raised at the server")
                        self._dedup[cid] = (seq, final)
                        if isinstance(cur[1], threading.Event):
                            cur[1].set()
            return resp
        op, key = msg[0], msg[1]
        if op == "init":
            with self._key_lock(key):
                if key not in self._store:      # rank 0 is the only sender
                    self._store[key] = _unpack(msg[2])
            return ("ok",)
        if op == "push":
            grad = _unpack(msg[2])
            with self._key_lock(key):
                if key not in self._store:
                    return ("missing",)
                stored = self._store[key]
                updater = self._get_updater()
                if updater is None:
                    self._store[key] = grad.astype(stored.dtype)
                else:
                    self._store[key] = self._apply(updater, key, grad, stored)
                self.push_counts[key] = self.push_counts.get(key, 0) + 1
                self.applied.setdefault(key, []).append(client)
            return ("ok",)
        if op == "pull":
            with self._key_lock(key):
                if key not in self._store:
                    return ("missing",)
                return ("ok", _pack(self._store[key]))
        if op == "pull_rows":
            ids = np.asarray(msg[2], dtype=np.int64)
            with self._key_lock(key):
                if key not in self._store:
                    return ("missing",)
                return ("ok", _pack(self._store[key][ids]))
        if op == "has":
            with self._key_lock(key):
                return ("ok",) if key in self._store else ("missing",)
        return ("error", f"unknown op {op!r}")

    @staticmethod
    def _apply(updater, key, grad: np.ndarray, stored: np.ndarray):
        """The server-side optimizer on the stored value (in place where the
        updater writes in place); returns the new value."""
        import torch
        from ..context import cpu
        from ..ndarray import NDArray
        s_nd = NDArray(torch.from_numpy(stored), cpu())
        with torch.no_grad():
            updater(key, NDArray(torch.from_numpy(grad), cpu()), s_nd)
        return s_nd._data.detach().numpy()

    def close(self):
        self._stop.set()
        try:
            self._sock.close()
        except OSError:
            pass


class PSClient:
    """A process's client: one connection a home rank."""

    def __init__(self, addr_of: Callable[[int], str]):
        import uuid
        self._addr_of = addr_of
        self._conns: Dict[int, socket.socket] = {}
        self._locks: Dict[int, threading.Lock] = {}
        self._guard = threading.Lock()
        self._id = uuid.uuid4().hex
        self._seq = 0

    def _conn(self, home: int):
        with self._guard:
            return self._locks.setdefault(home, threading.Lock())

    def request(self, home: int, msg, retries: int = 1):
        """Send ``msg`` to ``home`` in the exactly-once envelope and return
        the reply; one resend, under the same seq, after a dropped
        connection."""
        lock = self._conn(home)
        with lock:
            with self._guard:
                self._seq += 1
                seq = self._seq
            wire = ("req", self._id, seq, msg)
            for attempt in range(retries + 1):
                sock = self._conns.get(home)
                try:
                    if sock is None:
                        host, port = self._addr_of(home).rsplit(":", 1)
                        sock = socket.create_connection((host, int(port)), timeout=120)
                        # longer than the server's in-flight wait (see above)
                        sock.settimeout(_CLIENT_RECV_TIMEOUT)
                        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                        self._conns[home] = sock
                    _send_msg(sock, wire)
                    return _recv_msg(sock)
                except (ConnectionError, OSError):
                    self._conns.pop(home, None)
                    if attempt == retries:
                        raise
        raise MXNetError("unreachable")

    def _wait_until(self, home: int, key, msg, timeout: float):
        deadline = time.monotonic() + timeout
        while True:
            resp = self.request(home, msg)
            if resp[0] == "ok":
                return resp
            if resp[0] == "error":
                raise MXNetError(f"dist_async: server error for key {key!r} at rank "
                                 f"{home}: {resp[1] if len(resp) > 1 else resp}")
            if time.monotonic() > deadline:
                raise MXNetError(f"dist_async: key {key!r} never initialized at its home "
                                 f"server (rank {home}) within {timeout}s")
            time.sleep(0.02)

    def pull_blocking(self, home: int, key, timeout: float = 120.0) -> np.ndarray:
        """A pull that waits for the key to be initialized at its home."""
        return _unpack(self._wait_until(home, key, ("pull", key), timeout)[1])

    def wait_ready(self, home: int, key, timeout: float = 120.0):
        """Wait until ``key`` is initialized at its home (a few bytes each
        probe, not the value)."""
        self._wait_until(home, key, ("has", key), timeout)

    def close(self):
        for s in self._conns.values():
            try:
                s.close()
            except OSError:
                pass
        self._conns.clear()


def coordinator_kv():
    """The key-value store every rank of the job reaches, or None: the store
    of the process group ``_dist_util.init_process_group`` set up."""
    from .. import _dist_util
    return _dist_util.store()


def _host() -> str:
    """The address peers reach this process's server at:
    ``MXNET_TPU_PS_HOST``, else the loopback when every rank of the job runs
    on this host, else the host name."""
    host = os.environ.get("MXNET_TPU_PS_HOST")
    if host:
        return host
    import torch.distributed as dist
    from .. import _dist_util
    world = dist.get_world_size() if dist.is_initialized() else 1
    if _dist_util.env_local_world_size(world) >= world:
        return "127.0.0.1"
    return socket.gethostname()


def publish_address(rank: int, port: int) -> None:
    """Post this rank's server address to the job's store."""
    st = coordinator_kv()
    if st is None:
        raise MXNetError("dist_async needs the key-value store of a process group set "
                         "up by _dist_util.init_process_group (or the reference's "
                         "environment names) for its address rendezvous")
    st.set(f"mxtpu_ps/{rank}", f"{_host()}:{port}")


def resolve_address(rank: int, timeout_ms: int = int(RENDEZVOUS_TIMEOUT_S * 1000)) -> str:
    """Rank ``rank``'s server address (waits up to ``timeout_ms``)."""
    import datetime
    st = coordinator_kv()
    if st is None:
        raise MXNetError("no process-group store for the dist_async rendezvous")
    key = f"mxtpu_ps/{rank}"
    st.wait([key], datetime.timedelta(milliseconds=timeout_ms))
    return st.get(key).decode()


__all__ = ["PSServer", "PSClient", "coordinator_kv", "publish_address", "resolve_address"]
