"""Datasets, samplers and the data loader (counterpart of
``mxnet_tpu/gluon/data``): ``Dataset`` (with ``transform`` and
``transform_first``), ``SimpleDataset``, ``ArrayDataset``, every sampler,
``DataLoader``, and ``vision`` (MNIST, Fashion-MNIST, CIFAR-10/100 and the
transforms). ``RecordFileDataset`` waits for ROADMAP A9's ``recordio.py``
and refuses."""
from .dataset import Dataset, ArrayDataset, SimpleDataset, RecordFileDataset
from .sampler import (Sampler, SequentialSampler, RandomSampler,
                      BatchSampler, FilterSampler)
from .dataloader import DataLoader
from . import vision

__all__ = ["Dataset", "ArrayDataset", "SimpleDataset", "RecordFileDataset",
           "Sampler", "SequentialSampler", "RandomSampler", "BatchSampler",
           "FilterSampler", "DataLoader", "vision"]
