"""The port's ``io`` iterators against the reference's
(``mxnet_tpu/io/io.py``): ``NDArrayIter`` in each ``last_batch_handle``
mode, shuffled under one ``np.random.seed``, with list and dict inputs,
over two epochs (batches, ``pad``, ``provide_data``/``provide_label``);
``ResizeIter``; ``PrefetchingIter`` over two iterators; ``MNISTIter`` on its
synthetic set and on idx files the test writes (plain and gzipped, flat and
not, split in parts); ``CSVIter`` on CSV files the test writes; the deferred
iterators refuse.

Tolerance: exact. The same numpy arrays go into both packages' NDArrays.
On the card (``gpu``-marked), ``PrefetchingIter(ctx=gpu(0))`` stages the
host batches in pinned memory and gives the same batches on the card.
"""
import gzip
import os
import struct

import numpy as np
import pytest
import torch

import mxnet_tpu_torch as mt
from torch_threads import one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def ref():
    import mxnet_tpu as mx
    return mx


def _epochs(it, n=2):
    out = []
    for _ in range(n):
        it.reset()
        out.append([([d.asnumpy() for d in b.data],
                     [l.asnumpy() for l in (b.label or [])], b.pad) for b in it])
    return out


def _same(a, b):
    assert len(a) == len(b)
    for ea, eb in zip(a, b):
        assert len(ea) == len(eb)
        for (da, la, pa), (db, lb, pb) in zip(ea, eb):
            assert pa == pb
            for u, v in zip(da + la, db + lb):
                assert u.dtype == v.dtype
                np.testing.assert_array_equal(u, v)


def _data(n=11):
    rs = np.random.RandomState(0)
    return rs.normal(size=(n, 2, 3)).astype(np.float32), np.arange(n).astype(np.float32)


@pytest.mark.parametrize("shuffle", [False, True], ids=["ordered", "shuffled"])
@pytest.mark.parametrize("mode", ["pad", "discard", "roll_over"])
def test_ndarray_iter_matches_reference(ref, mode, shuffle):
    x, y = _data()
    runs = []
    for pkg in (mt, ref):
        np.random.seed(4)
        it = pkg.io.NDArrayIter(x, y, batch_size=4, shuffle=shuffle, last_batch_handle=mode,
                                ctx=pkg.cpu())
        runs.append((_epochs(it), it.provide_data, it.provide_label))
    _same(runs[0][0], runs[1][0])
    assert [tuple(d) for d in runs[0][1]] == [tuple(d) for d in runs[1][1]]
    assert [tuple(d) for d in runs[0][2]] == [tuple(d) for d in runs[1][2]]


def test_ndarray_iter_dict_and_list_inputs(ref):
    x, y = _data(9)
    z = x[:, 0] * 2
    runs = []
    for pkg in (mt, ref):
        a = pkg.io.NDArrayIter({"a": x, "b": z}, {"lab": y}, batch_size=3, ctx=pkg.cpu())
        b = pkg.io.NDArrayIter([x, pkg.nd.array(z, ctx=pkg.cpu())], None, batch_size=5,
                               ctx=pkg.cpu())
        runs.append((_epochs(a), _epochs(b), [d.name for d in a.provide_data],
                     [d.name for d in b.provide_data], [d.name for d in a.provide_label]))
    _same(runs[0][0], runs[1][0])
    _same(runs[0][1], runs[1][1])
    assert runs[0][2:] == runs[1][2:]


def test_resize_and_prefetching_iters_match_reference(ref):
    x, y = _data(10)
    runs = []
    for pkg in (mt, ref):
        base = pkg.io.NDArrayIter(x, y, batch_size=3, ctx=pkg.cpu())
        resized = pkg.io.ResizeIter(base, 5)
        two = pkg.io.PrefetchingIter([pkg.io.NDArrayIter(x, y, batch_size=4, ctx=pkg.cpu()),
                                      pkg.io.NDArrayIter(x * 2, None, batch_size=4,
                                                         ctx=pkg.cpu())])
        runs.append((_epochs(resized), _epochs(two), len(two.provide_data)))
    _same(runs[0][0], runs[1][0])
    _same(runs[0][1], runs[1][1])
    assert runs[0][2] == runs[1][2] == 2


def _write_idx(path, arr, gz):
    op = gzip.open if gz else open
    with op(path, "wb") as f:
        f.write(struct.pack(">I", 0x0800 | arr.ndim))
        f.write(struct.pack(">" + "I" * arr.ndim, *arr.shape))
        f.write(arr.astype(np.uint8).tobytes())


@pytest.mark.parametrize("source", ["synthetic", "idx", "idx.gz"])
def test_mnist_iter_matches_reference(ref, tmp_path, source):
    kw = dict(batch_size=16, shuffle=True, seed=3, synthetic_size=80)
    if source != "synthetic":
        rs = np.random.RandomState(1)
        gz = source.endswith(".gz")
        img = os.path.join(tmp_path, "img" + (".gz" if gz else ""))
        lab = os.path.join(tmp_path, "lab" + (".gz" if gz else ""))
        _write_idx(img, rs.randint(0, 256, (40, 28, 28)), gz)
        _write_idx(lab, rs.randint(0, 10, (40,)), gz)
        kw.update(image=img, label=lab)
    else:
        kw.update(image=os.path.join(tmp_path, "absent"), label=os.path.join(tmp_path, "absent"))
    for extra in ({}, {"flat": True, "num_parts": 2, "part_index": 1}):
        runs = []
        for pkg in (mt, ref):
            np.random.seed(6)
            it = pkg.io.MNISTIter(ctx=pkg.cpu(), **kw, **extra)
            runs.append(_epochs(it))
        _same(*runs)
        shape = runs[0][0][0][0][0].shape
        assert shape == ((16, 784) if extra else (16, 1, 28, 28))


def test_csv_iter_matches_reference(ref, tmp_path):
    rs = np.random.RandomState(2)
    data, label = rs.normal(size=(7, 6)).astype(np.float32), rs.randint(0, 3, (7, 1))
    dpath, lpath = os.path.join(tmp_path, "d.csv"), os.path.join(tmp_path, "l.csv")
    np.savetxt(dpath, data, delimiter=",")
    np.savetxt(lpath, label, delimiter=",")
    for round_batch in (True, False):
        runs = []
        for pkg in (mt, ref):
            it = pkg.io.CSVIter(dpath, (2, 3), label_csv=lpath, batch_size=3,
                                round_batch=round_batch, ctx=pkg.cpu())
            runs.append(_epochs(it))
        _same(*runs)


def test_data_desc_and_batch_match_reference(ref):
    a, b = mt.io.DataDesc("data", (2, 3)), ref.io.DataDesc("data", (2, 3))
    assert tuple(a) == tuple(b)
    assert mt.io.DataDesc.get_batch_axis("TNC") == ref.io.DataDesc.get_batch_axis("TNC") == 1
    batch = mt.io.DataBatch(mt.nd.array(np.ones((2, 3), np.float32), ctx=mt.cpu()), pad=1)
    rbatch = ref.io.DataBatch(ref.nd.array(np.ones((2, 3), np.float32)), pad=1)
    assert str(batch) == str(rbatch) and batch.pad == rbatch.pad == 1


@pytest.mark.parametrize("name", ["ImageRecordIter", "ImageDetRecordIter", "LibSVMIter"])
def test_deferred_iterators_refuse(name):
    with pytest.raises(mt.MXNetError, match="ROADMAP A9"):
        getattr(mt.io, name)(path_imgrec="x.rec", data_shape=(3, 8, 8), batch_size=2)


@pytest.mark.gpu
def test_gpu_prefetching_iter_stages_pinned_batches():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run on the card")
    x, y = _data(10)
    want = _epochs(mt.io.NDArrayIter(x, y, batch_size=4, ctx=mt.cpu()))
    it = mt.io.PrefetchingIter(mt.io.NDArrayIter(x, y, batch_size=4, ctx=mt.cpu()),
                               ctx=mt.gpu(0))
    batches = list(it)
    assert all(d.ctx == mt.gpu(0) for b in batches for d in b.data + b.label)
    _same(_epochs(it), want)
