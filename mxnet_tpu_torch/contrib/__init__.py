"""Contributed modules (counterpart of ``mxnet_tpu/contrib/``): the ported
part of ``amp``, its dynamic ``LossScaler``."""
from . import amp

__all__ = ["amp"]
