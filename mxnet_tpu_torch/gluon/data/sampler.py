"""Samplers (counterpart of ``mxnet_tpu/gluon/data/sampler.py``).

``RandomSampler`` shuffles with numpy's global generator, as the
reference's does, so one ``np.random.seed`` (or ``mx.random.seed``) gives
both packages the same order.
"""
from __future__ import annotations

import numpy as _np

from ...base import MXNetError


class Sampler:
    def __iter__(self):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError


class SequentialSampler(Sampler):
    def __init__(self, length, start=0):
        self._length = length
        self._start = start

    def __iter__(self):
        return iter(range(self._start, self._start + self._length))

    def __len__(self):
        return self._length


class RandomSampler(Sampler):
    def __init__(self, length):
        self._length = length

    def __iter__(self):
        idx = _np.arange(self._length)
        _np.random.shuffle(idx)
        return iter(idx.tolist())

    def __len__(self):
        return self._length


class BatchSampler(Sampler):
    """Batches of ``batch_size`` indices; the last partial batch is kept,
    discarded, or rolled over into the next epoch's first batch."""

    def __init__(self, sampler, batch_size, last_batch="keep"):
        if last_batch not in ("keep", "discard", "rollover"):
            raise MXNetError(f"last_batch must be keep, discard or rollover, got {last_batch!r}")
        self._sampler = sampler
        self._batch_size = batch_size
        self._last_batch = last_batch
        self._prev = []

    def __iter__(self):
        batch, self._prev = self._prev, []
        for i in self._sampler:
            batch.append(i)
            if len(batch) == self._batch_size:
                yield batch
                batch = []
        if batch:
            if self._last_batch == "keep":
                yield batch
            elif self._last_batch == "rollover":
                self._prev = batch

    def __len__(self):
        n = len(self._sampler)
        if self._last_batch == "keep":
            return (n + self._batch_size - 1) // self._batch_size
        if self._last_batch == "discard":
            return n // self._batch_size
        return (n + len(self._prev)) // self._batch_size


class FilterSampler(Sampler):
    """The indices whose dataset element satisfies ``fn``."""

    def __init__(self, fn, dataset):
        self._indices = [i for i in range(len(dataset)) if fn(dataset[i])]

    def __iter__(self):
        return iter(self._indices)

    def __len__(self):
        return len(self._indices)
