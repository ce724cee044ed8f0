"""Gluon: blocks, parameters, layers, losses and the trainer (counterpart of
``mxnet_tpu/gluon``).

Ported so far: ``Block``, ``HybridBlock``, ``Parameter``, ``ParameterDict``,
the layers BERT and ResNet use, ``loss.SoftmaxCrossEntropyLoss``, the
model zoo's ResNet family and ``Trainer`` on one device. The other losses,
data, the other zoo families and the contrib layers wait for later slices.
"""
from . import nn
from . import loss
from . import model_zoo
from .block import Block, HybridBlock
from .parameter import Parameter, ParameterDict
from .trainer import Trainer

__all__ = ["nn", "loss", "model_zoo", "Block", "HybridBlock", "Parameter", "ParameterDict",
           "Trainer"]
