"""Data iterators (counterpart of ``mxnet_tpu/io``); see ``io.io``."""
from .io import (DataDesc, DataBatch, DataIter, NDArrayIter, ResizeIter,
                 PrefetchingIter, MNISTIter, CSVIter, ImageRecordIter,
                 LibSVMIter, ImageDetRecordIter)

__all__ = ["DataDesc", "DataBatch", "DataIter", "NDArrayIter", "ResizeIter",
           "PrefetchingIter", "MNISTIter", "CSVIter", "ImageRecordIter",
           "LibSVMIter", "ImageDetRecordIter"]
