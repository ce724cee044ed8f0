"""MLP (counterpart of ``mxnet_tpu/models/mlp.py``; the reference MXNet's
``example/image-classification/symbols/mlp.py``): dense layers of
``hidden`` units with ``activation``, then the classifier."""
from ..gluon.block import HybridBlock
from ..gluon import nn


class MLP(HybridBlock):
    def __init__(self, hidden=(128, 64), classes=10, activation="relu", **kwargs):
        super().__init__(**kwargs)
        self.body = nn.HybridSequential()
        for h in hidden:
            self.body.add(nn.Dense(h, activation=activation))
        self.output = nn.Dense(classes)

    def hybrid_forward(self, F, x):
        return self.output(self.body(x))


def mlp(hidden=(128, 64), classes=10, **kwargs):
    return MLP(hidden, classes, **kwargs)
