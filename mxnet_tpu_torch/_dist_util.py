"""Process groups over ``torch.distributed``: set-up, backend, launcher.

Counterpart of ``mxnet_tpu/_dist_util.py`` and of the environment the
reference reads to join a job (``kvstore/kvstore.py:414-433``): the rank
from ``MXNET_TPU_RANK`` (or ``DMLC_WORKER_ID``), the world size from
``MXNET_TPU_NUM_WORKERS`` (or ``DMLC_NUM_WORKER``) and the rendezvous from
``MXNET_TPU_COORDINATOR`` (or ``DMLC_PS_ROOT_URI`` with
``DMLC_PS_ROOT_PORT``): ``host:port`` becomes ``tcp://host:port``, and a
``file://`` or ``tcp://`` URL is taken as it is.

- ``choose_backend`` is the one rule for the backend: ``nccl`` when every
  rank on a host has a CUDA device of its own, ``gloo`` when ranks share a
  device or run on the CPU. ``init_process_group`` uses it unless told a
  backend, and a failure of that backend raises; it never tries the other.
- A rank's device is explicit: ``gpu(local_rank % device_count)``, or the
  CPU when the caller asks for it (``rank_context``).
- ``launch_local`` is the counterpart of ``tools/launch.py --launcher
  local``: it starts ``n`` ranks of a function named ``"module:function"``
  as processes of this interpreter with ``file://`` rendezvous, joins them
  under a timeout and raises if any rank failed or hung. Each rank imports
  only what the function's module imports.
- ``plan_buckets`` groups tensors into buckets of at most ``bucket_bytes``
  for one all-reduce each (the replicated step's buckets; the ZeRO buckets
  are ``parallel/zero.py``'s plan).
- ``exchange`` posts one round of point-to-point sends and receives
  together (``batch_isend_irecv``), each with a peer and a tag; the
  pipeline's two rings (activations forward, cotangents backward) carry
  tags of their own, so at two stages, where the next and the previous
  rank are one peer, a receive never takes the other ring's message.
  ``ring_shift`` sends tensors to the next rank of a group and receives
  the previous rank's, as one such round. Under gloo on CUDA tensors both
  stage them through pinned host memory: gloo's send/recv refuse CUDA tensors (the peer closes the
  connection), while its ``reduce_scatter_tensor``,
  ``all_gather_into_tensor`` and ``all_to_all_single`` take them and are
  called directly. The compute stays on the card. ``p2p_stats`` counts the
  sends and bytes they made, also under CUDA graph replay (``engine``).

Nothing here starts a process or opens a socket when it is imported.
"""
from __future__ import annotations

import datetime
import importlib
import json
import os
import subprocess
import sys
import time
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from . import engine
from .base import MXNetError, env
from .context import Context, cpu, gpu

ENV_RANK = ("MXNET_TPU_RANK", "DMLC_WORKER_ID")
ENV_WORLD = ("MXNET_TPU_NUM_WORKERS", "DMLC_NUM_WORKER")
ENV_COORDINATOR = ("MXNET_TPU_COORDINATOR", "DMLC_PS_ROOT_URI")
COLLECTIVE_TIMEOUT_S = 300.0
FAILURE_GRACE_S = 5.0      # launch_local: how long the other ranks of a failed one may take to exit

env.declare("MXNET_TPU_BUCKET_BYTES", 32 * 1024 * 1024, int,
            "Bytes of gradients reduced by one collective (one bucket)")


def _env_first(names: Sequence[str]) -> Optional[str]:
    for name in names:
        value = os.environ.get(name)
        if value:
            return value
    return None


def env_rank() -> int:
    return int(_env_first(ENV_RANK) or 0)


def env_world_size() -> int:
    return int(_env_first(ENV_WORLD) or 1)


def env_local_rank() -> int:
    """The rank among the ranks of this host (``LOCAL_RANK``, else the rank:
    the launcher's ranks all run on one host)."""
    return int(os.environ.get("LOCAL_RANK", env_rank()))


def env_local_world_size(world_size: int) -> int:
    """The ranks on this host (``LOCAL_WORLD_SIZE``, else the world's)."""
    return int(os.environ.get("LOCAL_WORLD_SIZE", world_size))


def env_init_method() -> Optional[str]:
    """The rendezvous URL from the reference's environment names, or None."""
    coord = _env_first(ENV_COORDINATOR)
    if not coord:
        return None
    if "://" in coord:
        return coord
    if ":" not in coord:
        coord = f"{coord}:{os.environ.get('DMLC_PS_ROOT_PORT', '9091')}"
    return f"tcp://{coord}"


def choose_backend(device_type: str, ranks_per_host: int, device_count: int) -> str:
    """``nccl`` when each rank on a host has a CUDA device of its own;
    ``gloo`` when ranks share a device (NCCL refuses two ranks on one) or run
    on the CPU."""
    if device_type == "cpu":
        return "gloo"
    if device_type != "gpu":
        raise MXNetError(f"no process-group backend for device type {device_type!r}")
    return "nccl" if 0 < ranks_per_host <= device_count else "gloo"


def rank_context(device: str = "gpu", local_rank: Optional[int] = None) -> Context:
    """This rank's device: ``gpu(local_rank % device_count)``, or ``cpu()``
    when ``device="cpu"``. Raises without a CUDA device for ``"gpu"``."""
    if device == "cpu":
        return cpu()
    if device != "gpu":
        raise MXNetError(f"device must be 'gpu' or 'cpu', got {device!r}")
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n == 0:
        raise MXNetError("a rank on the GPU needs a CUDA device and none is "
                         "available; pass device='cpu' to run the ranks on the host")
    local = env_local_rank() if local_rank is None else local_rank
    return gpu(local % n)


def init_process_group(device: str = "gpu", backend: Optional[str] = None,
                       rank: Optional[int] = None, world_size: Optional[int] = None,
                       init_method: Optional[str] = None) -> Tuple[str, Context]:
    """Join the job: the default process group from the arguments or, where
    they are None, the reference's environment names. Returns the backend
    and this rank's context. Also sets the current CUDA device to it. A
    collective that waits longer than ``COLLECTIVE_TIMEOUT_S`` raises."""
    rank = env_rank() if rank is None else rank
    world_size = env_world_size() if world_size is None else world_size
    init_method = init_method or env_init_method()
    if init_method is None:
        raise MXNetError("no rendezvous: pass init_method or set "
                         f"{ENV_COORDINATOR[0]} (or {ENV_COORDINATOR[1]})")
    if not 0 <= rank < world_size:
        raise MXNetError(f"rank {rank} outside a world of {world_size}")
    ctx = rank_context(device)
    if backend is None:
        n_dev = torch.cuda.device_count() if ctx.device_type == "gpu" else 0
        backend = choose_backend(ctx.device_type, env_local_world_size(world_size), n_dev)
    if ctx.device_type == "gpu":
        torch.cuda.set_device(ctx.torch_device)
    if dist.is_initialized():
        if dist.get_rank() != rank or dist.get_world_size() != world_size \
                or dist.get_backend() != backend:
            raise MXNetError(f"a process group is already set up as rank "
                             f"{dist.get_rank()} of {dist.get_world_size()} "
                             f"({dist.get_backend()})")
        return backend, ctx
    kwargs = {}
    if backend == "nccl":
        kwargs["device_id"] = ctx.torch_device
    dist.init_process_group(backend=backend, init_method=init_method, rank=rank,
                            world_size=world_size,
                            timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S),
                            **kwargs)
    return backend, ctx


def destroy_process_group() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()


# -- buckets -----------------------------------------------------------------

def plan_buckets(sizes: Sequence[Tuple[int, int]], bucket_bytes: int) -> List[List[int]]:
    """Group ``(key, nbytes)`` entries, in the order given, into buckets of
    at most ``bucket_bytes`` (an entry larger than that is a bucket of its
    own). Returns the keys of each bucket."""
    buckets: List[List[int]] = []
    used = bucket_bytes
    for key, nbytes in sizes:
        if used + nbytes > bucket_bytes or not buckets:
            buckets.append([])
            used = 0
        buckets[-1].append(key)
        used += nbytes
    return buckets


# -- collectives ---------------------------------------------------------------

p2p_stats = {"sends": 0, "bytes": 0}
engine.register_counter(sys.modules[__name__], "p2p_stats")

# (op, axis) -> [calls, payload bytes] of the collectives the tensor-parallel
# and pipeline paths issue (``count_comm``); ``PipelineTrainer.last_stats``
# reads the difference across a step
comm_stats: Dict[Tuple[str, str], List[int]] = {}


def count_comm(op: str, axis: str, nbytes: int, calls: int = 1) -> None:
    """Add ``calls`` collectives ``op`` over ``axis`` moving ``nbytes`` of
    payload (the tensor's bytes on this rank) to ``comm_stats``."""
    c = comm_stats.setdefault((op, axis), [0, 0])
    c[0] += calls
    c[1] += int(nbytes)


def exchange(sends: Sequence[Tuple[torch.Tensor, int, int]],
             recvs: Sequence[Tuple[torch.Tensor, int, int]], group) -> None:
    """One round of point-to-point messages, posted together: each ``(tensor,
    peer, tag)`` of ``sends`` goes to ``peer`` (a rank of ``group``), and each
    of ``recvs`` is filled in place from its peer's send of the same tag.
    Both sides of a message must be in the round on their ranks; a round
    with neither does nothing."""
    if not sends and not recvs:
        return
    staged = dist.get_backend(group) == "gloo" and any(
        t.is_cuda for t, _, _ in [*sends, *recvs])
    if staged:     # gloo's send/recv take host memory only
        out = [(torch.empty(t.shape, dtype=t.dtype, pin_memory=True).copy_(t), p, g)
               for t, p, g in sends]
        into = [(torch.empty(t.shape, dtype=t.dtype, pin_memory=True), p, g)
                for t, p, g in recvs]
    else:
        out = [(t.contiguous(), p, g) for t, p, g in sends]
        into = list(recvs)
    ops = [dist.P2POp(dist.isend, t, dist.get_global_rank(group, p), group, g)
           for t, p, g in out] + \
        [dist.P2POp(dist.irecv, t, dist.get_global_rank(group, p), group, g)
         for t, p, g in into]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    if staged:
        for (dst, _, _), (h, _, _) in zip(recvs, into):
            dst.copy_(h)
    p2p_stats["sends"] += len(sends)
    p2p_stats["bytes"] += sum(t.numel() * t.element_size() for t, _, _ in sends)


def ring_shift(tensors: Sequence[torch.Tensor], group) -> List[torch.Tensor]:
    """Send each of ``tensors`` to the next rank of ``group`` (in group
    order, cyclic) and return the ones the previous rank sent (new tensors
    of the same shapes, dtypes and device)."""
    n = dist.get_world_size(group)
    me = dist.get_rank(group)
    tensors = [t.contiguous() for t in tensors]
    outs = [torch.empty_like(t) for t in tensors]
    exchange([(t, (me + 1) % n, 0) for t in tensors],
             [(o, (me - 1) % n, 0) for o in outs], group)
    return outs


# -- the local launcher --------------------------------------------------------

_WORKER = ("import sys; from mxnet_tpu_torch._dist_util import _worker_main; "
           "sys.exit(_worker_main(sys.argv[1:]))")


def launch_local(target: str, n: int, kwargs: Optional[Dict] = None, *, workdir: str,
                 device: str = "gpu", timeout: float = 120.0,
                 pythonpath: Sequence[str] = ()) -> List:
    """Run ``target`` (``"module:function"``) in ``n`` ranks on this host and
    return each rank's result, in rank order.

    Each rank is ``python -c ...`` with ``MXNET_TPU_RANK``,
    ``MXNET_TPU_NUM_WORKERS`` and ``MXNET_TPU_COORDINATOR`` (a ``file://``
    rendezvous in ``workdir``, which also takes the ranks' arguments, logs
    and results) set, and, unless the caller's environment sets it,
    ``OMP_NUM_THREADS`` to this host's cores over ``n`` (the ranks share the
    host; more threads than cores slowed a 4-rank CPU run 3.6x). It joins
    the process group on ``device`` (``init_process_group``), calls
    ``function(**kwargs)`` (JSON arguments) and writes the return value as
    JSON. ``pythonpath`` is put in
    front of the ranks' ``PYTHONPATH`` so they can import ``module``.
    A rank that exits non-zero, or any rank still running after ``timeout``
    seconds, stops every rank and raises ``MXNetError`` with the end of each
    failed rank's output."""
    if n < 1:
        raise MXNetError(f"launch_local needs at least one rank, got {n}")
    os.makedirs(workdir, exist_ok=True)
    rendezvous = os.path.join(workdir, f"rendezvous.{os.getpid()}.{time.time_ns()}")
    args_path = os.path.join(workdir, "kwargs.json")
    with open(args_path, "w") as f:
        json.dump(kwargs or {}, f)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    paths = [*pythonpath, root] + [p for p in os.environ.get("PYTHONPATH", "").split(
        os.pathsep) if p]
    threads = os.environ.get("OMP_NUM_THREADS") or str(max(1, (os.cpu_count() or 1) // n))
    procs, logs = [], []
    try:
        for rank in range(n):
            env_r = dict(os.environ, OMP_NUM_THREADS=threads, MXNET_TPU_RANK=str(rank),
                         MXNET_TPU_NUM_WORKERS=str(n),
                         MXNET_TPU_COORDINATOR=f"file://{rendezvous}", LOCAL_RANK=str(rank),
                         PYTHONPATH=os.pathsep.join(paths))
            log = open(os.path.join(workdir, f"rank{rank}.log"), "w+")
            logs.append(log)
            cmd = [sys.executable, "-c", _WORKER, target, args_path,
                   os.path.join(workdir, f"result{rank}.json"), device]
            procs.append(subprocess.Popen(cmd, env=env_r, stdout=log,
                                          stderr=subprocess.STDOUT))
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            codes = [p.poll() for p in procs]
            if any(c not in (None, 0) for c in codes) or all(c == 0 for c in codes):
                break
            time.sleep(0.05)
        if any(p.poll() != 0 for p in procs):
            # the other ranks of a failed one fail in turn (their peer is
            # gone): give them a moment so every traceback is reported
            grace = min(deadline, time.monotonic() + FAILURE_GRACE_S)
            while time.monotonic() < grace and any(p.poll() is None for p in procs):
                time.sleep(0.05)
            hung = [r for r, p in enumerate(procs) if p.poll() is None]
            for p in procs:
                if p.poll() is None:
                    p.kill()
                p.wait()
            failed = [r for r in range(n) if r not in hung and procs[r].returncode != 0]
            tails = []
            for r in failed or hung:
                logs[r].seek(0)
                tails.append(f"--- rank {r} (exit {procs[r].returncode}) ---\n"
                             + logs[r].read()[-4000:])
            what = (f"rank(s) {failed} failed" if failed
                    else f"rank(s) {hung} still running after {timeout:.0f} s")
            raise MXNetError(f"launch_local({target}, n={n}): {what}\n" + "\n".join(tails))
        results = []
        for rank in range(n):
            with open(os.path.join(workdir, f"result{rank}.json")) as f:
                results.append(json.load(f))
        return results
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for log in logs:
            log.close()


def _worker_main(argv: Sequence[str]) -> int:
    """One rank of ``launch_local``: join, run the target, write its result."""
    target, args_path, result_path, device = argv
    module, _, name = target.partition(":")
    fn = getattr(importlib.import_module(module), name)
    with open(args_path) as f:
        kwargs = json.load(f)
    init_process_group(device=device)
    try:
        result = fn(**kwargs)
        dist.barrier()
    finally:
        destroy_process_group()
    with open(result_path, "w") as f:
        json.dump(result, f)
    return 0


__all__ = ["choose_backend", "rank_context", "init_process_group",
           "destroy_process_group", "launch_local", "plan_buckets", "exchange", "ring_shift",
           "p2p_stats", "comm_stats", "count_comm", "env_rank", "env_world_size", "env_local_rank", "env_init_method"]
