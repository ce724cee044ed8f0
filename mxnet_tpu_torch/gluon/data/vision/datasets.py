"""Vision datasets (counterpart of ``mxnet_tpu/gluon/data/vision/datasets.py``).

Nothing is downloaded. A dataset reads its canonical files under ``root``
(MNIST's gzipped idx files, CIFAR's binary batches) when they are there,
and otherwise makes the reference's deterministic synthetic set of the
same shapes and label structure (``synthetic_size`` samples, from a fixed
numpy seed: class means plus noise, so a net can learn it), the same arrays
as the reference's for the same arguments. A sample is ``(image, label)``:
an HWC uint8 numpy array and an int32 label.
"""
from __future__ import annotations

import gzip
import os
import struct

import numpy as _np

from ....base import MXNetError
from ..dataset import Dataset


class _DownloadedDataset(Dataset):
    def __init__(self, root, train, transform):
        self._root = os.path.expanduser(root)
        self._train = train
        self._transform = transform
        self._data = None
        self._label = None
        self._get_data()

    def __len__(self):
        return len(self._label)

    def __getitem__(self, idx):
        x = self._data[idx]
        y = self._label[idx]
        if self._transform is not None:
            return self._transform(x, y)
        return x, y

    def _synthetic(self, seed):
        rng = _np.random.RandomState(seed)
        n = self._synthetic_size
        label = rng.randint(0, self._classes, n).astype(_np.int32)
        base = rng.rand(self._classes, *self._shape)
        data = ((base[label] * 0.6 + rng.rand(n, *self._shape) * 0.4) * 255).astype(_np.uint8)
        return data, label


class MNIST(_DownloadedDataset):
    """MNIST: 28x28x1 uint8 images, 10 classes."""

    _shape = (28, 28, 1)
    _classes = 10
    _files = {True: ("train-images-idx3-ubyte.gz", "train-labels-idx1-ubyte.gz"),
              False: ("t10k-images-idx3-ubyte.gz", "t10k-labels-idx1-ubyte.gz")}

    def __init__(self, root=os.path.join("~", ".mxnet", "datasets", "mnist"),
                 train=True, transform=None, synthetic_size=2048):
        self._synthetic_size = synthetic_size
        super().__init__(root, train, transform)

    def _get_data(self):
        img_f, lab_f = self._files[self._train]
        img_p = os.path.join(self._root, img_f)
        lab_p = os.path.join(self._root, lab_f)
        if os.path.exists(img_p) and os.path.exists(lab_p):
            with gzip.open(lab_p, "rb") as f:
                struct.unpack(">II", f.read(8))
                label = _np.frombuffer(f.read(), dtype=_np.uint8).astype(_np.int32)
            with gzip.open(img_p, "rb") as f:
                _, n, r, c = struct.unpack(">IIII", f.read(16))
                data = _np.frombuffer(f.read(), dtype=_np.uint8).reshape(n, r, c, 1)
        else:
            data, label = self._synthetic(42 if self._train else 43)
        self._data = data
        self._label = label


class FashionMNIST(MNIST):
    def __init__(self, root=os.path.join("~", ".mxnet", "datasets", "fashion-mnist"),
                 train=True, transform=None, synthetic_size=2048):
        super().__init__(root, train, transform, synthetic_size)


class CIFAR10(_DownloadedDataset):
    """CIFAR-10: 32x32x3 uint8 images, 10 classes."""

    _shape = (32, 32, 3)
    _classes = 10

    def __init__(self, root=os.path.join("~", ".mxnet", "datasets", "cifar10"),
                 train=True, transform=None, synthetic_size=2048):
        self._synthetic_size = synthetic_size
        super().__init__(root, train, transform)

    def _get_data(self):
        files = [os.path.join(self._root, f"data_batch_{i}.bin") for i in range(1, 6)] \
            if self._train else [os.path.join(self._root, "test_batch.bin")]
        if all(os.path.exists(f) for f in files):
            datas, labels = [], []
            for fn in files:
                raw = _np.fromfile(fn, dtype=_np.uint8).reshape(-1, 3073)
                labels.append(raw[:, 0].astype(_np.int32))
                datas.append(raw[:, 1:].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1))
            self._data = _np.concatenate(datas)
            self._label = _np.concatenate(labels)
        else:
            self._data, self._label = self._synthetic(44 if self._train else 45)


class CIFAR100(CIFAR10):
    """CIFAR-100: as CIFAR-10 with 100 classes."""

    _classes = 100

    def __init__(self, root=os.path.join("~", ".mxnet", "datasets", "cifar100"),
                 fine_label=False, train=True, transform=None, synthetic_size=2048):
        super().__init__(root, train, transform, synthetic_size)


class ImageFolderDataset(Dataset):
    """Images in ``root/<label name>/``: waits for ROADMAP A9's ``image.py``."""

    def __init__(self, root, flag=1, transform=None):
        raise MXNetError("gluon.data.vision.ImageFolderDataset decodes images, which the "
                         "port does not do yet: ROADMAP A9 (image.py)")


class ImageRecordDataset(Dataset):
    """Images and labels of a RecordIO file: waits for ROADMAP A9's
    ``recordio.py`` and ``image.py``."""

    def __init__(self, filename, flag=1, transform=None):
        raise MXNetError("gluon.data.vision.ImageRecordDataset reads RecordIO, which the "
                         "port does not have yet: ROADMAP A9 (recordio.py, image.py)")
