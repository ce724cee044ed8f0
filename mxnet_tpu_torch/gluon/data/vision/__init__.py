"""Vision datasets and transforms (counterpart of
``mxnet_tpu/gluon/data/vision``). ``ImageFolderDataset`` and
``ImageRecordDataset`` wait for ROADMAP A9's ``image.py`` and
``recordio.py`` and refuse."""
from . import transforms
from .datasets import (MNIST, FashionMNIST, CIFAR10, CIFAR100,
                       ImageFolderDataset, ImageRecordDataset)

__all__ = ["transforms", "MNIST", "FashionMNIST", "CIFAR10", "CIFAR100",
           "ImageFolderDataset", "ImageRecordDataset"]
