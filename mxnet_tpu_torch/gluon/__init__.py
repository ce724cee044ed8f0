"""Gluon: blocks, parameters, layers, losses and the trainer (counterpart of
``mxnet_tpu/gluon``).

Ported so far: ``Block``, ``HybridBlock`` (its hybridized forward and
training pair as CUDA graphs), ``Parameter``, ``ParameterDict``, the layers
BERT, ResNet and LeNet use, the thirteen losses of ``loss``, ``data``
(datasets, samplers, ``DataLoader``, the vision datasets and transforms),
the model zoo's ResNet family and ``Trainer`` on one device (with
``save_states``/``load_states``), nested ``name_scope`` prefixes and the
reference's ``.params`` files. The other zoo
families, the recurrent and contrib layers wait for later slices.
"""
from . import nn
from . import loss
from . import data
from . import model_zoo
from .block import Block, HybridBlock
from .parameter import Parameter, ParameterDict
from .trainer import Trainer

__all__ = ["nn", "loss", "data", "model_zoo", "Block", "HybridBlock", "Parameter", "ParameterDict",
           "Trainer"]
