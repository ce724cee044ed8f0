"""Fault schedules: when an armed injection point fires.

Counterpart of ``mxnet_tpu/faults/schedule.py``, the same classes and spec
grammar. A schedule is a small deterministic state machine driven by the
per-point attempt counter the plane keeps (1-based, incremented on every
``faults.check(point)``), so the same spec against the same code path fires
on the same attempts in every run.

Spec grammar (one schedule)::

    every_nth:N          fire on attempts N, 2N, 3N, ...
    first_k:K            fire on attempts 1..K, then never again
    p:P[:seedS]          seeded Bernoulli(P) per attempt (own RNG stream,
                         default seed 0)

and ``parse_spec`` reads the full ``MXNET_TPU_FAULTS`` form::

    point=schedule[;point=schedule...]
    e.g.  elastic.write_shard=first_k:1;elastic.read=every_nth:3
"""
from __future__ import annotations

import random
from typing import Dict, List, Tuple

from ..base import MXNetError

__all__ = ["Schedule", "EveryNth", "FirstK", "SeededProbability",
           "parse_schedule", "parse_spec"]


class Schedule:
    """Base: ``fires(attempt)`` decides whether attempt #n (1-based) injects.
    The plane calls it under its lock, so schedules need no lock of their
    own."""

    def fires(self, attempt: int) -> bool:
        raise NotImplementedError

    def spec(self) -> str:
        raise NotImplementedError

    def __repr__(self):
        return f"<{type(self).__name__} {self.spec()}>"


class EveryNth(Schedule):
    """Fire on every Nth attempt (N=1 means always)."""

    def __init__(self, n: int):
        if int(n) < 1:
            raise MXNetError(f"every_nth needs n >= 1, got {n}")
        self.n = int(n)

    def fires(self, attempt: int) -> bool:
        return attempt % self.n == 0

    def spec(self) -> str:
        return f"every_nth:{self.n}"


class FirstK(Schedule):
    """Fire on the first K attempts only: the transient fault a bounded
    retry must absorb."""

    def __init__(self, k: int):
        if int(k) < 0:
            raise MXNetError(f"first_k needs k >= 0, got {k}")
        self.k = int(k)

    def fires(self, attempt: int) -> bool:
        return attempt <= self.k

    def spec(self) -> str:
        return f"first_k:{self.k}"


class SeededProbability(Schedule):
    """Bernoulli(p) per attempt from a private seeded stream: the same seed
    replays the same fire/no-fire sequence."""

    def __init__(self, p: float, seed: int = 0):
        p = float(p)
        if not 0.0 <= p <= 1.0:
            raise MXNetError(f"probability schedule needs 0 <= p <= 1, got {p}")
        self.p = p
        self.seed = int(seed)
        self._rng = random.Random(self.seed)

    def fires(self, attempt: int) -> bool:
        return self._rng.random() < self.p

    def spec(self) -> str:
        return f"p:{self.p}:seed{self.seed}"


def parse_schedule(text: str) -> Schedule:
    """``every_nth:3`` / ``first_k:2`` / ``p:0.1[:seed7]`` -> Schedule."""
    parts = [p.strip() for p in str(text).strip().split(":")]
    kind = parts[0]
    try:
        if kind == "every_nth" and len(parts) == 2:
            return EveryNth(int(parts[1]))
        if kind == "first_k" and len(parts) == 2:
            return FirstK(int(parts[1]))
        if kind == "p" and len(parts) in (2, 3):
            seed = 0
            if len(parts) == 3:
                s = parts[2]
                seed = int(s[len("seed"):] if s.startswith("seed") else s)
            return SeededProbability(float(parts[1]), seed)
    except (ValueError, IndexError):
        pass
    raise MXNetError(f"unparseable fault schedule {text!r}; expected every_nth:N, "
                     f"first_k:K, or p:P[:seedS]")


def parse_spec(spec: str) -> List[Tuple[str, Schedule]]:
    """Parse the ``MXNET_TPU_FAULTS`` value into (point, schedule) pairs."""
    out: List[Tuple[str, Schedule]] = []
    seen: Dict[str, str] = {}
    for part in str(spec).split(";"):
        part = part.strip()
        if not part:
            continue
        if "=" not in part:
            raise MXNetError(f"unparseable fault spec entry {part!r}; expected "
                             f"point=schedule")
        point, _, sched = part.partition("=")
        point = point.strip()
        if not point:
            raise MXNetError(f"empty fault point in spec entry {part!r}")
        if point in seen:
            raise MXNetError(f"fault point {point!r} appears twice in spec "
                             f"({seen[point]!r} then {sched.strip()!r})")
        seen[point] = sched.strip()
        out.append((point, parse_schedule(sched)))
    return out
