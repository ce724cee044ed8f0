"""LeNet-5 (counterpart of ``mxnet_tpu/models/lenet.py``; the reference
MXNet's ``example/image-classification/train_mnist.py`` network): two
tanh convolutions of 20 and 50 5x5 filters, each followed by a 2x2 max
pool, then a 500-unit tanh dense layer and the classifier."""
from ..gluon.block import HybridBlock
from ..gluon import nn


class LeNet(HybridBlock):
    def __init__(self, classes=10, **kwargs):
        super().__init__(**kwargs)
        self.features = nn.HybridSequential()
        self.features.add(nn.Conv2D(20, kernel_size=5, activation="tanh"))
        self.features.add(nn.MaxPool2D(pool_size=2, strides=2))
        self.features.add(nn.Conv2D(50, kernel_size=5, activation="tanh"))
        self.features.add(nn.MaxPool2D(pool_size=2, strides=2))
        self.features.add(nn.Flatten())
        self.features.add(nn.Dense(500, activation="tanh"))
        self.output = nn.Dense(classes)

    def hybrid_forward(self, F, x):
        return self.output(self.features(x))


def lenet(classes=10, **kwargs):
    return LeNet(classes, **kwargs)
