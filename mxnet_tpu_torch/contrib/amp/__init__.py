"""Automatic mixed precision (counterpart of ``mxnet_tpu/contrib/amp/``):
the dynamic ``LossScaler`` that ``parallel.DataParallelTrainer`` uses for
``dtype="float16"``. ``amp.init`` and the op lists wait for a later slice."""
from .loss_scaler import LossScaler

__all__ = ["LossScaler"]
