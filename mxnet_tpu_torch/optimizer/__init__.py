"""Optimizers (counterpart of ``mxnet_tpu/optimizer/__init__.py``): the
ported subset, ``SGD`` and ``Adam``, with ``Optimizer``, ``Updater`` and the
``create``/``register`` registry."""
from .optimizer import (Optimizer, Updater, get_updater, create, register,
                        SGD, Adam)

__all__ = ["Optimizer", "Updater", "get_updater", "create", "register",
           "SGD", "Adam"]
