"""Gluon layers (counterpart of ``mxnet_tpu/gluon/nn``)."""
from .basic_layers import (Sequential, HybridSequential, Dense, Dropout,
                           BatchNorm, Embedding, Flatten, Activation, LayerNorm)
from .conv_layers import (Conv2D, MaxPool2D, AvgPool2D, GlobalMaxPool2D,
                          GlobalAvgPool2D)

__all__ = ["Sequential", "HybridSequential", "Dense", "Dropout", "BatchNorm",
           "Embedding", "Flatten", "Activation", "LayerNorm", "Conv2D",
           "MaxPool2D", "AvgPool2D", "GlobalMaxPool2D", "GlobalAvgPool2D"]
