"""Seeding and generators.

Counterpart of ``mxnet_tpu/random.py:83-124``. The reference keeps one
global threefry key; here ``seed(n)`` drives one explicit
``torch.Generator`` per device, made on first use and seeded with ``n``.
Initializers, dropout, ``nd.random`` and the sampling ops draw from
``generator(ctx)``. Threefry and Philox
streams cannot be matched, so tests that compare the two packages draw
their inputs and weights with numpy.

``get_state_raw``/``set_state_raw`` (reference :118-134) carry the state of
every generator made so far, and the seed that later ones take, as one
uint8 vector (``_RAW_MAGIC``, the seed, then per generator its device and
``Generator.get_state()``): the ``rng`` leaf of an elastic snapshot. The
reference's leaf is a threefry key (uint32); neither package reads the
other's.

``seed`` and ``set_state_raw`` reseed or restore the generators in place:
a generator object lives as long as the process, so a CUDA graph that
registered it (``engine.capture``) goes on drawing from it, and a replay
after ``seed(n)`` draws what an eager step would.

Like the reference, ``seed`` also seeds Python's ``random`` and numpy's
global generator (the samplers' and ``NDArrayIter``'s shuffles draw from
it), and the host generators of the data pipeline: ``host_rng()`` is a
``numpy.random.RandomState`` of the calling thread (a ``DataLoader``
worker's, for the random transforms), made at its first use after a
``seed`` from that seed and the thread's order of arrival (reference
:64-80); before any ``seed`` it is unseeded.
"""
from __future__ import annotations

import random as _pyrandom
import struct
import threading
from typing import Dict

import numpy as _np
import torch

from .base import MXNetError
from .context import Context

_lock = threading.Lock()
_seed = 0
_generators: Dict[torch.device, torch.Generator] = {}
_host_state = {"seed": None, "epoch": 0, "next_idx": 0}
_host_tls = threading.local()


def host_rng() -> "_np.random.RandomState":
    """The calling thread's host generator (see the module docstring)."""
    st = _host_state
    if getattr(_host_tls, "epoch", None) != st["epoch"]:
        with _lock:
            idx = st["next_idx"]
            st["next_idx"] += 1
        base = st["seed"]
        _host_tls.rng = _np.random.RandomState() if base is None else \
            _np.random.RandomState((int(base) + 0x9E3779B9 * (idx + 1)) % (2 ** 32))
        _host_tls.epoch = st["epoch"]
    return _host_tls.rng


def seed(seed_state: int, ctx="all"):
    """Reseed every device's generator (``ctx`` is accepted for API parity:
    all devices are reseeded, as in the reference)."""
    global _seed
    with _lock:
        _seed = int(seed_state)
        for gen in _generators.values():
            gen.manual_seed(_seed)
        _host_state.update(seed=_seed, epoch=_host_state["epoch"] + 1, next_idx=0)
    _pyrandom.seed(int(seed_state))
    _np.random.seed(int(seed_state) % (2 ** 32))


def generator(ctx) -> torch.Generator:
    """The generator of ``ctx`` (a Context or torch.device)."""
    device = ctx.torch_device if isinstance(ctx, Context) else torch.device(ctx)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    with _lock:
        gen = _generators.get(device)
        if gen is None:
            gen = torch.Generator(device=device)
            gen.manual_seed(_seed)
            _generators[device] = gen
    return gen


_RAW_MAGIC = b"MXTG1"


def get_state_raw() -> _np.ndarray:
    """The seed and the state of every generator made so far, as one uint8
    vector (for checkpointing)."""
    with _lock:
        parts = [_RAW_MAGIC, struct.pack("<qI", _seed, len(_generators))]
        for device in sorted(_generators, key=str):
            name = str(device).encode()
            state = _generators[device].get_state().numpy().tobytes()
            parts += [struct.pack("<I", len(name)), name,
                      struct.pack("<Q", len(state)), state]
    return _np.frombuffer(b"".join(parts), dtype=_np.uint8).copy()


def set_state_raw(raw):
    """Restore the generators from ``get_state_raw()``'s vector. Generators of
    devices this process does not have (a snapshot of a GPU run restored on
    the CPU) are not made; the others continue their saved streams."""
    global _seed
    raw = _np.asarray(raw)
    buf = raw.tobytes()
    if raw.dtype != _np.uint8 or not buf.startswith(_RAW_MAGIC):
        raise MXNetError(f"rng state of another format ({raw.dtype}, {raw.shape}): "
                         f"the port's generator states start with {_RAW_MAGIC!r}; a "
                         f"threefry key from the reference package cannot seed them")
    off = len(_RAW_MAGIC)
    seed_state, n = struct.unpack_from("<qI", buf, off)
    off += struct.calcsize("<qI")
    states = {}
    for _ in range(n):
        (ln,) = struct.unpack_from("<I", buf, off)
        name = buf[off + 4:off + 4 + ln].decode()
        off += 4 + ln
        (ls,) = struct.unpack_from("<Q", buf, off)
        states[torch.device(name)] = torch.frombuffer(
            bytearray(buf[off + 8:off + 8 + ls]), dtype=torch.uint8)
        off += 8 + ls
    with _lock:
        _seed = int(seed_state)
        for device, gen in _generators.items():
            if device not in states:       # as if made anew at its first use
                gen.manual_seed(_seed)
        for device, state in states.items():
            if device.type == "cuda" and (not torch.cuda.is_available() or
                                          device.index >= torch.cuda.device_count()):
                continue
            gen = _generators.get(device)
            if gen is None:
                gen = _generators[device] = torch.Generator(device=device)
            gen.set_state(state)
