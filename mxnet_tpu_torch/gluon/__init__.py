"""Gluon: blocks, parameters, layers, losses and the trainer (counterpart of
``mxnet_tpu/gluon``).

Ported so far: ``Block``, ``HybridBlock``, ``Parameter``, ``ParameterDict``,
the layers BERT uses, ``loss.SoftmaxCrossEntropyLoss`` and ``Trainer`` on
one device. The other losses, data, the model zoo and the contrib layers
wait for later slices.
"""
from . import nn
from . import loss
from .block import Block, HybridBlock
from .parameter import Parameter, ParameterDict
from .trainer import Trainer

__all__ = ["nn", "loss", "Block", "HybridBlock", "Parameter", "ParameterDict",
           "Trainer"]
