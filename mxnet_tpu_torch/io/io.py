"""Data iterators (counterpart of ``mxnet_tpu/io/io.py``).

``DataDesc``, ``DataBatch`` and ``DataIter``; ``NDArrayIter`` over
in-memory arrays (a list, a dict or one array; ``last_batch_handle``
``"pad"``, ``"discard"`` or ``"roll_over"``; shuffled by numpy's global
generator at each ``reset``, as the reference's); ``ResizeIter``;
``PrefetchingIter``, whose thread reads the next batches ahead of the
consumer and, given a ``ctx`` on the card, stages host batches in pinned
memory and hands them to the consumer, who copies them to the card without
blocking; ``MNISTIter`` (idx files, gzipped or not, or the reference's
synthetic set from ``seed``) and ``CSVIter``.

Waiting for ROADMAP A9, and refusing with ``MXNetError``: ``ImageRecordIter``
and ``ImageDetRecordIter`` (``recordio.py``, ``image.py``) and
``LibSVMIter`` (CSR arrays, ``ndarray/sparse.py``).
"""
from __future__ import annotations

import gzip
import os
import queue
import struct
import threading
from collections import namedtuple
from typing import Optional

import numpy as _np

from ..base import MXNetError
from ..context import Context, current_context
from ..ndarray import NDArray, array


class DataDesc(namedtuple("DataDesc", ["name", "shape", "dtype", "layout"])):
    def __new__(cls, name, shape, dtype=_np.float32, layout="NCHW"):
        return super().__new__(cls, name, tuple(shape), dtype, layout)

    @staticmethod
    def get_batch_axis(layout):
        return 0 if layout is None else layout.find("N")


class DataBatch:
    def __init__(self, data, label=None, pad=0, index=None, bucket_key=None,
                 provide_data=None, provide_label=None):
        self.data = data if isinstance(data, (list, tuple)) or data is None else [data]
        self.label = label if isinstance(label, (list, tuple)) or label is None else [label]
        self.pad = pad
        self.index = index
        self.bucket_key = bucket_key
        self.provide_data = provide_data
        self.provide_label = provide_label

    def __str__(self):
        ds = [d.shape for d in self.data] if self.data else []
        ls = [l.shape for l in self.label] if self.label else []
        return f"DataBatch: data shapes: {ds} label shapes: {ls}"


class DataIter:
    def __init__(self, batch_size=0):
        self.batch_size = batch_size

    def __iter__(self):
        return self

    def reset(self):
        pass

    def next(self) -> DataBatch:
        if self.iter_next():
            return DataBatch(self.getdata(), self.getlabel(), self.getpad(), self.getindex())
        raise StopIteration

    def __next__(self):
        return self.next()

    def iter_next(self):
        raise NotImplementedError

    def getdata(self):
        raise NotImplementedError

    def getlabel(self):
        raise NotImplementedError

    def getindex(self):
        return None

    def getpad(self):
        return 0


class NDArrayIter(DataIter):
    """Batches of in-memory arrays. The last batch of an epoch is filled
    from the epoch's start (``"pad"``, with ``getpad()`` the filled count,
    or ``"roll_over"``) or dropped (``"discard"``)."""

    def __init__(self, data, label=None, batch_size=1, shuffle=False,
                 last_batch_handle="pad", data_name="data", label_name="softmax_label",
                 ctx: Optional[Context] = None):
        super().__init__(batch_size)
        self.data = _init_data(data, allow_empty=False, default_name=data_name)
        self.label = _init_data(label, allow_empty=True, default_name=label_name)
        self.idx = _np.arange(self.data[0][1].shape[0])
        self.shuffle = shuffle
        self.last_batch_handle = last_batch_handle
        self.num_data = self.idx.shape[0]
        self.cursor = -batch_size
        self._ctx = ctx or current_context()
        if last_batch_handle == "discard":
            self.num_data = (self.num_data // batch_size) * batch_size
        self.reset()

    @property
    def provide_data(self):
        return [DataDesc(k, (self.batch_size,) + v.shape[1:], v.dtype) for k, v in self.data]

    @property
    def provide_label(self):
        return [DataDesc(k, (self.batch_size,) + v.shape[1:], v.dtype) for k, v in self.label]

    def reset(self):
        if self.shuffle:
            _np.random.shuffle(self.idx)
        self.cursor = -self.batch_size

    def iter_next(self):
        self.cursor += self.batch_size
        return self.cursor < self.num_data

    def _take(self, arrays):
        end = self.cursor + self.batch_size
        if end <= self.num_data:
            sel = self.idx[self.cursor:end]
        else:               # pad and roll_over both fill from the epoch's start
            sel = _np.concatenate([self.idx[self.cursor:], self.idx[:end - self.num_data]])
        return [array(v[sel], ctx=self._ctx, dtype=v.dtype) for _, v in arrays]

    def getdata(self):
        return self._take(self.data)

    def getlabel(self):
        return self._take(self.label)

    def getpad(self):
        end = self.cursor + self.batch_size
        if end > self.num_data and self.last_batch_handle == "pad":
            return end - self.num_data
        return 0


def _init_data(data, allow_empty, default_name):
    if data is None:
        if not allow_empty:
            raise MXNetError("data cannot be None")
        return []
    if isinstance(data, (_np.ndarray, NDArray)):
        data = [data]
    if isinstance(data, (list, tuple)):
        out = [(f"{default_name}{'_' + str(i) if i else ''}", d) for i, d in enumerate(data)]
    elif isinstance(data, dict):
        out = list(data.items())
    else:
        raise MXNetError(f"unsupported data type {type(data)}")
    return [(k, v.asnumpy() if isinstance(v, NDArray) else _np.asarray(v)) for k, v in out]


class ResizeIter(DataIter):
    """``data_iter`` resized to ``size`` batches an epoch (restarting it when
    it runs out)."""

    def __init__(self, data_iter, size, reset_internal=True):
        super().__init__(data_iter.batch_size)
        self.data_iter = data_iter
        self.size = size
        self.reset_internal = reset_internal
        self.cur = 0
        self.current_batch = None

    @property
    def provide_data(self):
        return self.data_iter.provide_data

    @property
    def provide_label(self):
        return self.data_iter.provide_label

    def reset(self):
        self.cur = 0
        if self.reset_internal:
            self.data_iter.reset()

    def iter_next(self):
        if self.cur == self.size:
            return False
        try:
            self.current_batch = self.data_iter.next()
        except StopIteration:
            self.data_iter.reset()
            self.current_batch = self.data_iter.next()
        self.cur += 1
        return True

    def next(self):
        if self.iter_next():
            return self.current_batch
        raise StopIteration

    def getdata(self):
        return self.current_batch.data

    def getlabel(self):
        return self.current_batch.label


def _bounded_put(q: "queue.Queue", item, stop: threading.Event) -> bool:
    """put() that gives up once the consumer signalled stop (a blocking put
    into a full queue whose consumer left would hold the thread forever)."""
    while not stop.is_set():
        try:
            q.put(item, timeout=0.1)
            return True
        except queue.Full:
            continue
    return False


def _stage(arrays, ctx):
    """Host arrays pinned for a copy to ``ctx`` on the card (others kept)."""
    if ctx is None or ctx.device_type != "gpu":
        return arrays
    return [a._data.pin_memory() if a._data.device.type == "cpu" else a for a in arrays]


def _land(arrays, ctx):
    """Pinned host tensors copied to ``ctx`` without blocking the host."""
    return [NDArray(a.to(ctx.torch_device, non_blocking=True), ctx) if not isinstance(a, NDArray)
            else a for a in arrays]


class PrefetchingIter(DataIter):
    """The batches of ``iters`` (joined field by field), read ahead by a
    thread, ``prefetch_depth`` at most. With ``ctx`` a card's context, host
    batches are staged in pinned memory by the thread and copied to the card
    by ``next()`` on the caller's current stream, without blocking."""

    def __init__(self, iters, rename_data=None, rename_label=None, prefetch_depth=2,
                 ctx: Optional[Context] = None):
        if not isinstance(iters, (list, tuple)):
            iters = [iters]
        super().__init__(iters[0].batch_size)
        self.iters = iters
        self._ctx = ctx
        self._prefetch_depth = max(int(prefetch_depth), 1)
        self._q: queue.Queue = queue.Queue(maxsize=self._prefetch_depth)
        self._stop = threading.Event()
        self._thread = None
        self._start()

    @property
    def provide_data(self):
        return sum([i.provide_data for i in self.iters], [])

    @property
    def provide_label(self):
        return sum([i.provide_label for i in self.iters], [])

    def _start(self):
        stop, q, ctx = self._stop, self._q, self._ctx

        def worker():
            try:
                while not stop.is_set():
                    batches = []
                    try:
                        for it in self.iters:
                            batches.append(it.next())
                    except StopIteration:
                        _bounded_put(q, None, stop)
                        return
                    data = _stage(sum([b.data for b in batches], []), ctx)
                    label = _stage(sum([(b.label or []) for b in batches], []), ctx)
                    if not _bounded_put(q, (data, label, batches[0].pad), stop):
                        return
            except Exception as e:   # raised in the consumer
                _bounded_put(q, e, stop)
        self._thread = threading.Thread(target=worker, daemon=True, name="mx-io-prefetch")
        self._thread.start()

    def reset(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        if self._thread is not None:
            self._thread.join(timeout=5)
        for it in self.iters:
            it.reset()
        self._stop = threading.Event()
        self._q = queue.Queue(maxsize=self._prefetch_depth)
        self._start()

    def next(self):
        item = self._q.get()
        if item is None:
            raise StopIteration
        if isinstance(item, Exception):
            raise item
        data, label, pad = item
        if self._ctx is not None:
            data, label = _land(data, self._ctx), _land(label, self._ctx)
        return DataBatch(data, label, pad)

    def iter_next(self):
        try:
            self._peek = self.next()
            return True
        except StopIteration:
            return False


class _Wrapped(DataIter):
    """An iterator whose batches are an inner ``NDArrayIter``'s."""

    @property
    def provide_data(self):
        return self._inner.provide_data

    @property
    def provide_label(self):
        return self._inner.provide_label

    def reset(self):
        self._inner.reset()

    def next(self):
        return self._inner.next()

    def iter_next(self):
        return self._inner.iter_next()


class MNISTIter(_Wrapped):
    """MNIST from idx files (gzipped or not); when they are absent, the
    reference's deterministic synthetic set from ``seed``: class patterns of
    4x4 blocks upsampled to 28x28 plus noise. Images scaled to [0, 1], as
    (N, 1, 28, 28) or flat (N, 784); labels float32."""

    def __init__(self, image="train-images-idx3-ubyte", label="train-labels-idx1-ubyte",
                 batch_size=128, shuffle=True, flat=False, seed=0, silent=True,
                 num_parts=1, part_index=0, ctx=None, synthetic_size=2048):
        super().__init__(batch_size)
        if os.path.exists(image) and os.path.exists(label):
            imgs = self._read_idx(image)
            labs = self._read_idx(label)
        else:
            rng = _np.random.RandomState(seed)
            labs = rng.randint(0, 10, size=(synthetic_size,)).astype("uint8")
            base4 = rng.rand(10, 4, 4).astype("float32")
            base = _np.kron(base4, _np.ones((7, 7), "float32"))
            imgs = (base[labs] * 255 * 0.5 + rng.rand(synthetic_size, 28, 28) * 127).astype("uint8")
        if num_parts > 1:
            imgs = imgs[part_index::num_parts]
            labs = labs[part_index::num_parts]
        x = imgs.astype("float32") / 255.0
        x = x.reshape(len(x), -1) if flat else x.reshape(len(x), 1, 28, 28)
        self._inner = NDArrayIter(x, labs.astype("float32"), batch_size, shuffle=shuffle, ctx=ctx)

    @staticmethod
    def _read_idx(path):
        op = gzip.open if path.endswith(".gz") else open
        with op(path, "rb") as f:
            magic = struct.unpack(">I", f.read(4))[0]
            ndim = magic & 0xFF
            dims = struct.unpack(">" + "I" * ndim, f.read(4 * ndim))
            return _np.frombuffer(f.read(), dtype=_np.uint8).reshape(dims)


class CSVIter(_Wrapped):
    """Rows of a CSV file reshaped to ``data_shape`` (and of ``label_csv`` to
    ``label_shape``); ``round_batch`` fills the last batch from the start."""

    def __init__(self, data_csv, data_shape, label_csv=None, label_shape=(1,),
                 batch_size=1, round_batch=True, ctx=None):
        super().__init__(batch_size)
        data = _np.loadtxt(data_csv, delimiter=",", dtype="float32")
        data = data.reshape((-1,) + tuple(data_shape))
        label = None
        if label_csv is not None:
            label = _np.loadtxt(label_csv, delimiter=",", dtype="float32")
            label = label.reshape((-1,) + tuple(label_shape))
        self._inner = NDArrayIter(data, label, batch_size, ctx=ctx,
                                  last_batch_handle="roll_over" if round_batch else "discard")


def _waits(name, needs):
    class Waiting(DataIter):
        def __init__(self, *args, **kwargs):
            raise MXNetError(f"io.{name} needs {needs}, which the port does not have yet: "
                             f"ROADMAP A9")
    Waiting.__name__ = Waiting.__qualname__ = name
    Waiting.__doc__ = f"Waits for ROADMAP A9 ({needs}); refuses."
    return Waiting


ImageRecordIter = _waits("ImageRecordIter", "RecordIO and image decoding (recordio.py, "
                                            "image.py)")
ImageDetRecordIter = _waits("ImageDetRecordIter", "RecordIO and image decoding (recordio.py, "
                                                  "image.py)")
LibSVMIter = _waits("LibSVMIter", "CSR arrays (ndarray/sparse.py)")
