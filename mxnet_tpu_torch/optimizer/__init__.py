"""Optimizers (counterpart of ``mxnet_tpu/optimizer/__init__.py``): the
reference's 19 registered classes, with ``Optimizer``, ``Updater`` and the
``create``/``register`` registry."""
from .optimizer import (Optimizer, Updater, get_updater, create, register,
                        SGD, ccSGD, NAG, SGLD, Signum, DCASGD, FTML, LARS, LBSGD, LAMB,
                        Adam, AdamW, AdaGrad, RMSProp, AdaDelta, Ftrl, Adamax, Nadam, Test)

__all__ = ["Optimizer", "Updater", "get_updater", "create", "register",
           "SGD", "ccSGD", "NAG", "SGLD", "Signum", "DCASGD", "FTML", "LARS", "LBSGD",
           "LAMB", "Adam", "AdamW", "AdaGrad", "RMSProp", "AdaDelta", "Ftrl", "Adamax",
           "Nadam", "Test"]
