"""The port's ``gluon.data`` against the reference's
(``mxnet_tpu/gluon/data``): datasets and their transforms, every sampler
under one ``np.random.seed``, ``DataLoader`` batches in each
``last_batch`` mode with 0 and 2 workers, the synthetic vision datasets,
MNIST read from idx files the test writes, and the vision transforms.

Tolerance: indices, batches and dataset arrays exactly (the same numpy
arrays moved into each package); the deterministic transforms 1e-6 (the
same numpy code in f32); the random transforms by their properties (the
output is a flip, a window, a scaled copy of the input, within [0, 255]),
and, drawn single-threaded after the same seed, equal to the reference's.
On the card (``gpu``-marked), ``pin_memory=True`` gives the same batches on
the card.
"""
import gzip
import os
import struct

import numpy as np
import pytest
import torch

import mxnet_tpu_torch as mt
from mxnet_tpu_torch.gluon import data as gdata
from mxnet_tpu_torch.gluon.data.vision import transforms as T
from torch_threads import one_torch_thread  # noqa: F401

TOL_TRANSFORM = 1e-6


@pytest.fixture(scope="module")
def ref():
    import mxnet_tpu as mx
    from mxnet_tpu.gluon import data as rdata
    from mxnet_tpu.gluon.data.vision import transforms as RT
    return mx, rdata, RT


def _arrays(n=10, seed=0):
    rs = np.random.RandomState(seed)
    return rs.normal(size=(n, 3)).astype(np.float32), np.arange(n, dtype=np.int32)


def _np(x):
    if isinstance(x, (tuple, list)):
        return [_np(v) for v in x]
    return x.asnumpy() if hasattr(x, "asnumpy") else np.asarray(x)


def test_datasets_and_transforms_match_reference(ref):
    _, rdata, _ = ref
    x, y = _arrays()
    for pkg in (gdata, rdata):
        assert len(pkg.ArrayDataset(x, y)) == 10
    port, want = gdata.ArrayDataset(x, y), rdata.ArrayDataset(x, y)
    views = [
        (lambda d: d, "whole"),
        (lambda d: d.transform(lambda a, b: (a * 2, b + 1)), "transform"),
        (lambda d: d.transform_first(lambda a: a - 1), "transform_first"),
        (lambda d: d.filter(lambda s: s[1] % 2 == 0), "filter"),
        (lambda d: d.shard(3, 1), "shard"),
        (lambda d: d.take(4), "take"),
    ]
    for view, _name in views:
        a, b = view(port), view(want)
        assert len(a) == len(b)
        for i in range(len(a)):
            for u, v in zip(_np(a[i]), _np(b[i])):
                np.testing.assert_array_equal(u, v)
    single = gdata.SimpleDataset(list(range(5))).transform_first(lambda v: v * 3)
    assert [single[i] for i in range(5)] == [0, 3, 6, 9, 12]
    nd_ds = gdata.ArrayDataset(mt.nd.array(x, ctx=mt.cpu()))
    np.testing.assert_array_equal(nd_ds[2], x[2])


def test_samplers_match_reference_under_one_seed(ref):
    _, rdata, _ = ref
    ds = gdata.ArrayDataset(*_arrays(11))
    for kind in ("sequential", "random", "keep", "discard", "rollover", "filter"):
        seqs = []
        for pkg, dset in ((gdata, ds), (rdata, rdata.ArrayDataset(*_arrays(11)))):
            np.random.seed(5)
            if kind == "sequential":
                s = pkg.SequentialSampler(7, start=2)
            elif kind == "random":
                s = pkg.RandomSampler(11)
            elif kind == "filter":
                s = pkg.FilterSampler(lambda item: item[1] % 3 == 0, dset)
            else:
                s = pkg.BatchSampler(pkg.RandomSampler(11), 4, kind)
            epochs = [list(s) for _ in range(3)]          # rollover carries over
            seqs.append((epochs, len(s)))
        assert seqs[0] == seqs[1], kind


@pytest.mark.parametrize("workers", [0, 2])
@pytest.mark.parametrize("last_batch", ["keep", "discard", "rollover"])
def test_dataloader_batches_match_reference(ref, last_batch, workers):
    mx, rdata, _ = ref
    x, y = _arrays(23, seed=1)
    got, want = [], []
    np.random.seed(9)
    loader = gdata.DataLoader(gdata.ArrayDataset(x, y), batch_size=5, shuffle=True,
                              last_batch=last_batch, num_workers=workers)
    with mt.cpu():
        for _ in range(2):
            got.append([_np(b) for b in loader])
    np.random.seed(9)
    rloader = rdata.DataLoader(rdata.ArrayDataset(x, y), batch_size=5, shuffle=True,
                               last_batch=last_batch, num_workers=workers)
    for _ in range(2):
        want.append([_np(b) for b in rloader])
    assert len(loader) == len(rloader)
    assert len(got[0]) == len(want[0]) and len(got[1]) == len(want[1])
    for eg, ew in zip(got, want):
        for bg, bw in zip(eg, ew):
            for u, v in zip(bg, bw):
                assert u.dtype == v.dtype
                np.testing.assert_array_equal(u, v)


def test_dataloader_places_batches_and_takes_a_batchify_fn():
    """Batches land on the iterating thread's context, also from worker
    threads; a custom ``batchify_fn`` and a custom sampler are used."""
    x, y = _arrays(8)
    seen = []

    def batchify(samples):
        seen.append(len(samples))
        return mt.nd.array(np.stack([s[0] for s in samples]))
    loader = gdata.DataLoader(gdata.ArrayDataset(x, y), batch_size=3, num_workers=2,
                              batchify_fn=batchify,
                              sampler=gdata.SequentialSampler(6, start=2))
    with mt.cpu():
        batches = list(loader)
    assert sorted(seen) == [3, 3] and all(b.ctx == mt.cpu() for b in batches)
    np.testing.assert_array_equal(batches[1].asnumpy(), x[5:8])
    with pytest.raises(ValueError):
        gdata.DataLoader(gdata.ArrayDataset(x), batch_size=2, shuffle=True,
                         sampler=gdata.SequentialSampler(8))


@pytest.mark.parametrize("name", ["MNIST", "FashionMNIST", "CIFAR10", "CIFAR100"])
@pytest.mark.parametrize("train", [True, False], ids=["train", "test"])
def test_synthetic_vision_datasets_equal_reference(ref, tmp_path, name, train):
    _, rdata, _ = ref
    a = getattr(gdata.vision, name)(root=str(tmp_path), train=train, synthetic_size=64)
    b = getattr(rdata.vision, name)(root=str(tmp_path), train=train, synthetic_size=64)
    assert len(a) == len(b) == 64
    np.testing.assert_array_equal(a._data, b._data)
    np.testing.assert_array_equal(a._label, b._label)
    x, lab = a[3]
    assert x.dtype == np.uint8 and x.shape == a._shape and lab.dtype == np.int32


def _write_idx(path, arr):
    dims = arr.shape
    with gzip.open(path, "wb") as f:
        f.write(struct.pack(">I", 0x0800 | len(dims)))
        f.write(struct.pack(">" + "I" * len(dims), *dims))
        f.write(arr.astype(np.uint8).tobytes())


def test_mnist_reads_idx_files(ref, tmp_path):
    """MNIST from gzipped idx files the test writes, with ToTensor through
    ``transform_first``, equal to the reference reading the same files."""
    _, rdata, RT = ref
    rs = np.random.RandomState(3)
    imgs = rs.randint(0, 256, (12, 28, 28)).astype(np.uint8)
    labs = rs.randint(0, 10, 12).astype(np.uint8)
    _write_idx(os.path.join(tmp_path, "train-images-idx3-ubyte.gz"), imgs)
    with gzip.open(os.path.join(tmp_path, "train-labels-idx1-ubyte.gz"), "wb") as f:
        f.write(struct.pack(">II", 0x0801, 12))
        f.write(labs.tobytes())
    a = gdata.vision.MNIST(root=str(tmp_path)).transform_first(T.ToTensor())
    b = rdata.vision.MNIST(root=str(tmp_path)).transform_first(RT.ToTensor())
    assert len(a) == len(b) == 12
    for i in (0, 7, 11):
        (xa, ya), (xb, yb) = a[i], b[i]
        assert xa.shape == (1, 28, 28) and ya == labs[i]
        np.testing.assert_allclose(xa, xb, rtol=TOL_TRANSFORM, atol=TOL_TRANSFORM)
        assert ya == yb


def _image(seed=4, h=12, w=10):
    return np.random.RandomState(seed).randint(0, 256, (h, w, 3)).astype(np.uint8)


DETERMINISTIC = [
    ("to_tensor", lambda t: t.ToTensor()),
    ("normalize", lambda t: t.Compose([t.ToTensor(), t.Normalize(mean=(0.5, 0.4, 0.3),
                                                                  std=(0.2, 0.3, 0.4))])),
    ("cast", lambda t: t.Cast("float16")),
    ("resize", lambda t: t.Resize((7, 5))),
    ("resize-int", lambda t: t.Resize(16)),
    ("center-crop", lambda t: t.CenterCrop((6, 4))),
    ("center-crop-up", lambda t: t.CenterCrop(14)),
    ("crop-resize", lambda t: t.CropResize(2, 1, 5, 6)),
    ("random-crop-full", lambda t: t.RandomCrop((10, 12))),
    ("jitter-none", lambda t: t.RandomColorJitter()),
]


@pytest.mark.parametrize("make", [d[1] for d in DETERMINISTIC], ids=[d[0] for d in DETERMINISTIC])
def test_deterministic_transforms_match_reference(ref, make):
    _, _, RT = ref
    img = _image()
    got, want = make(T)(img), make(RT)(img)
    assert np.asarray(got).shape == np.asarray(want).shape
    assert np.asarray(got).dtype == np.asarray(want).dtype
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               rtol=TOL_TRANSFORM, atol=TOL_TRANSFORM)


def test_random_transforms_by_their_properties():
    img = _image(h=16, w=16)
    mt.random.seed(1)
    for _ in range(8):
        f = np.asarray(T.RandomFlipLeftRight()(img))
        assert np.array_equal(f, img) or np.array_equal(f, img[:, ::-1])
        f = np.asarray(T.RandomFlipTopBottom()(img))
        assert np.array_equal(f, img) or np.array_equal(f, img[::-1])
        c = T.RandomCrop(8, pad=2)(img)
        padded = np.pad(img, ((2, 2), (2, 2), (0, 0)))
        assert c.shape == (8, 8, 3) and any(
            np.array_equal(c, padded[i:i + 8, j:j + 8]) for i in range(13) for j in range(13))
        assert T.RandomResizedCrop(10)(img).shape == (10, 10, 3)
        b = T.RandomBrightness(0.3)(img)
        ratio = b[img > 10] / img[img > 10].astype(np.float32)
        assert b.min() >= 0 and b.max() <= 255 and np.ptp(ratio[b[img > 10] < 255]) < 1e-4
        for t in (T.RandomContrast(0.4), T.RandomSaturation(0.4), T.RandomHue(0.2),
                  T.RandomLighting(0.1), T.RandomColorJitter(0.2, 0.2, 0.2, 0.1)):
            o = t(img)
            assert o.shape == img.shape and o.min() >= 0 and o.max() <= 255
    with pytest.raises(mt.MXNetError):
        T.CropResize(0, 0, 4, 4, size=8)


RANDOM = [
    ("flip-lr", lambda t: t.RandomFlipLeftRight()),
    ("resized-crop", lambda t: t.RandomResizedCrop(8)),
    ("crop-pad", lambda t: t.RandomCrop(6, pad=1)),
    ("jitter", lambda t: t.RandomColorJitter(0.3, 0.3, 0.3, 0.1)),
    ("lighting", lambda t: t.RandomLighting(0.2)),
]


@pytest.mark.parametrize("make", [r[1] for r in RANDOM], ids=[r[0] for r in RANDOM])
def test_random_transforms_draw_the_reference_numbers(ref, make):
    """Single-threaded after the same seed the host generators draw the same
    numbers in both packages, so the outputs agree (1e-6)."""
    mx, _, RT = ref
    img = _image(seed=8, h=14, w=14)
    runs = []
    for pkg, tmod in ((mt, T), (mx, RT)):
        pkg.random.seed(21)
        t = make(tmod)
        runs.append([np.asarray(t(img), np.float64) for _ in range(4)])
    for u, v in zip(*runs):
        np.testing.assert_allclose(u, v, rtol=TOL_TRANSFORM, atol=TOL_TRANSFORM)


def test_deferred_datasets_refuse():
    for make in (lambda: gdata.RecordFileDataset("x.rec"),
                 lambda: gdata.vision.ImageFolderDataset("."),
                 lambda: gdata.vision.ImageRecordDataset("x.rec")):
        with pytest.raises(mt.MXNetError, match="ROADMAP A9"):
            make()


@pytest.mark.gpu
def test_gpu_pinned_loader_equals_host_batches():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run on the card")
    x, y = _arrays(20)
    np.random.seed(2)
    host = gdata.DataLoader(gdata.ArrayDataset(x, y), batch_size=6, shuffle=True,
                            num_workers=2)
    with mt.cpu():
        want = [_np(b) for b in host]
    np.random.seed(2)
    pinned = gdata.DataLoader(gdata.ArrayDataset(x, y), batch_size=6, shuffle=True,
                              num_workers=2, pin_memory=True)
    got = list(pinned)
    assert all(f.ctx == mt.gpu(0) for b in got for f in b)
    for bg, bw in zip(got, want):
        for u, v in zip(_np(bg), bw):
            np.testing.assert_array_equal(u, v)
