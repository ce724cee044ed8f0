"""DataLoader (counterpart of ``mxnet_tpu/gluon/data/dataloader.py``).

Batches of a ``Dataset`` by a ``BatchSampler`` (``shuffle`` and
``last_batch`` ``"keep"``, ``"discard"`` or ``"rollover"``, or a sampler
of the caller's), stacked by ``batchify_fn`` (default: samples stacked into
NDArrays; tuples of fields stacked field by field). ``num_workers`` > 0
runs the sampling, the transforms and the stacking on that many threads, as
the reference's workers are (numpy and torch's copies release the GIL);
batches come out in the sampler's order, at most ``prefetch`` (default
``2 * num_workers``) ahead of the consumer.

Where a batch lands: on the context current in the thread that iterates
(``mx.gpu(0)`` unless a ``with mx.cpu():`` says otherwise). With
``pin_memory=True`` the workers stack the batch in pinned host memory and
the iterating thread copies it to ``gpu(pin_device_id)`` without blocking
(``non_blocking=True`` on its current stream), so the copy overlaps the
work already queued on the card.
"""
from __future__ import annotations

import queue
import threading
from typing import Optional

import numpy as _np
import torch

from ...context import cpu, current_context, gpu
from ...ndarray import NDArray, array
from .dataset import Dataset
from .sampler import BatchSampler, RandomSampler, SequentialSampler, Sampler


def default_batchify_fn(data):
    """Stack samples into a batch (NDArrays stacked, tuples field by field,
    anything else through numpy, float64 as float32)."""
    if isinstance(data[0], NDArray):
        return NDArray(torch.stack([d._data for d in data]), data[0].ctx)
    if isinstance(data[0], tuple):
        return tuple(default_batchify_fn(list(x)) for x in zip(*data))
    arr = _np.asarray(data)
    if arr.dtype == _np.float64:
        arr = arr.astype(_np.float32)
    return array(arr)


def default_mp_batchify_fn(data):
    return default_batchify_fn(data)


def _pin(batch):
    if isinstance(batch, NDArray):
        return NDArray(batch._data.pin_memory(), cpu())
    if isinstance(batch, (tuple, list)):
        return type(batch)(_pin(b) for b in batch)
    return batch


def _to_device(batch, ctx):
    if isinstance(batch, NDArray):
        return NDArray(batch._data.to(ctx.torch_device, non_blocking=True), ctx)
    if isinstance(batch, (tuple, list)):
        return type(batch)(_to_device(b, ctx) for b in batch)
    return batch


class DataLoader:
    def __init__(self, dataset: Dataset, batch_size=None, shuffle=False,
                 sampler: Optional[Sampler] = None, last_batch=None,
                 batch_sampler=None, batchify_fn=None, num_workers=0,
                 pin_memory=False, pin_device_id=0, prefetch=None,
                 thread_pool=False, timeout=120):
        self._dataset = dataset
        if batch_sampler is None:
            if batch_size is None:
                raise ValueError("batch_size required when batch_sampler is None")
            if sampler is None:
                sampler = RandomSampler(len(dataset)) if shuffle else \
                    SequentialSampler(len(dataset))
            elif shuffle:
                raise ValueError("shuffle must be False with custom sampler")
            batch_sampler = BatchSampler(sampler, batch_size, last_batch or "keep")
        self._batch_sampler = batch_sampler
        self._batchify_fn = batchify_fn or default_batchify_fn
        self._num_workers = max(0, num_workers)
        self._pin_memory = pin_memory
        self._pin_device_id = pin_device_id
        self._prefetch = max(0, prefetch if prefetch is not None else 2 * self._num_workers)
        self._timeout = timeout

    def __len__(self):
        return len(self._batch_sampler)

    def device_feed(self, device=None, mesh=None, data_spec=None, depth=None,
                    trainer=None):
        """This loader in an ``engine.async_feed.DeviceFeed`` (reference
        :66-77): the feed's producer runs the sampling and stacking on the
        host and copies each batch to ``device`` ahead of the step.
        ``trainer=`` is the reference's shortcut for ``DeviceFeed.for_trainer``
        (its ``docs/input_pipeline.md``): a ``DataParallelTrainer``'s device
        and this rank's part of the batch."""
        from ...engine.async_feed import DeviceFeed
        src = _HostBatches(self)
        if trainer is not None:
            return DeviceFeed.for_trainer(src, trainer, depth=depth)
        return DeviceFeed(src, device=device, mesh=mesh, data_spec=data_spec, depth=depth)

    def _make(self, idx, ctx):
        """One batch, stacked on ``ctx`` (pinned on the host with pin_memory)."""
        samples = [self._dataset[j] for j in idx]
        with ctx:
            batch = self._batchify_fn(samples)
        return _pin(batch) if self._pin_memory else batch

    def __iter__(self):
        if self._pin_memory:
            build, target = cpu(), gpu(self._pin_device_id)
        else:
            build, target = current_context(), None
        batches = self._inline(build) if self._num_workers == 0 else self._threaded(build)
        for batch in batches:
            yield _to_device(batch, target) if target is not None else batch

    def _inline(self, ctx):
        for idx in self._batch_sampler:
            yield self._make(idx, ctx)

    def _threaded(self, ctx):
        tasks = list(enumerate(self._batch_sampler))
        task_q: "queue.Queue" = queue.Queue()
        for t in tasks:
            task_q.put(t)
        out_q: "queue.Queue" = queue.Queue()
        ahead = threading.Semaphore(max(self._prefetch, self._num_workers))
        stop = threading.Event()

        def worker():
            while not stop.is_set():
                ahead.acquire()
                if stop.is_set():
                    return
                try:
                    i, idx = task_q.get_nowait()
                except queue.Empty:
                    ahead.release()
                    return
                try:
                    out_q.put((i, self._make(idx, ctx)))
                except Exception as e:       # raised in the consumer, in order
                    out_q.put((i, e))

        threads = [threading.Thread(target=worker, daemon=True, name=f"mx-dataloader-{k}")
                   for k in range(self._num_workers)]
        for t in threads:
            t.start()
        results = {}
        try:
            for nxt in range(len(tasks)):
                while nxt not in results:
                    i, payload = out_q.get(timeout=self._timeout)
                    results[i] = payload
                payload = results.pop(nxt)
                ahead.release()
                if isinstance(payload, Exception):
                    raise payload
                yield payload
        finally:
            stop.set()
            for _ in threads:
                ahead.release()
            for t in threads:
                t.join(timeout=self._timeout)


class _HostBatches:
    """A loader's batches stacked on the host, for a ``DeviceFeed`` to copy."""

    def __init__(self, loader: DataLoader):
        self._loader = loader
        self.batch_size = getattr(loader._batch_sampler, "_batch_size", 0)

    def __len__(self):
        return len(self._loader)

    def __iter__(self):
        ld = self._loader
        return ld._inline(cpu()) if ld._num_workers == 0 else ld._threaded(cpu())
