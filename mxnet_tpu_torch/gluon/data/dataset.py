"""Datasets (counterpart of ``mxnet_tpu/gluon/data/dataset.py``).

A ``Dataset`` maps an index to a sample: ``transform(fn)`` wraps it lazily
(``fn(*sample)`` at each access), ``transform_first(fn)`` applies ``fn`` to
the first element of each sample only (the image, not the label).
``ArrayDataset`` holds its arrays as numpy (an ``NDArray`` is read to the
host once), so a sample is a numpy row, as in the reference.
"""
from __future__ import annotations

from ...base import MXNetError
from ...ndarray import NDArray


class Dataset:
    def __getitem__(self, idx):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError

    def filter(self, fn):
        return SimpleDataset([self[i] for i in range(len(self)) if fn(self[i])])

    def shard(self, num_shards, index):
        return SimpleDataset([self[i] for i in range(index, len(self), num_shards)])

    def take(self, count):
        return SimpleDataset([self[i] for i in range(min(count, len(self)))])

    def transform(self, fn, lazy=True):
        return _LazyTransformDataset(self, fn)

    def transform_first(self, fn, lazy=True):
        def first(*items):
            if len(items) == 1:
                return fn(items[0])
            return (fn(items[0]),) + items[1:]
        return self.transform(first, lazy)


class _LazyTransformDataset(Dataset):
    def __init__(self, data, fn):
        self._data = data
        self._fn = fn

    def __len__(self):
        return len(self._data)

    def __getitem__(self, idx):
        item = self._data[idx]
        if isinstance(item, tuple):
            return self._fn(*item)
        return self._fn(item)


class SimpleDataset(Dataset):
    def __init__(self, data):
        self._data = data

    def __len__(self):
        return len(self._data)

    def __getitem__(self, idx):
        return self._data[idx]


class ArrayDataset(Dataset):
    def __init__(self, *args):
        if not args:
            raise MXNetError("ArrayDataset needs at least one array")
        self._length = len(args[0])
        self._data = []
        for a in args:
            if isinstance(a, NDArray):
                a = a.asnumpy()
            if len(a) != self._length:
                raise MXNetError(f"ArrayDataset: arrays of {self._length} and {len(a)} rows")
            self._data.append(a)

    def __len__(self):
        return self._length

    def __getitem__(self, idx):
        if len(self._data) == 1:
            return self._data[0][idx]
        return tuple(d[idx] for d in self._data)


class RecordFileDataset(Dataset):
    """Records of an indexed RecordIO file: waits for ROADMAP A9's
    ``recordio.py``."""

    def __init__(self, filename):
        raise MXNetError("gluon.data.RecordFileDataset reads RecordIO, which the port "
                         "does not have yet: ROADMAP A9 (recordio.py)")
