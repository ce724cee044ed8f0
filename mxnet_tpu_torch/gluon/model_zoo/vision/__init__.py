"""Vision model zoo (counterpart of ``mxnet_tpu/gluon/model_zoo/vision``).

Ported: the ResNet family, v1 and v2, 18 to 152 layers. AlexNet, DenseNet,
Inception v3, MobileNet v1/v2, SqueezeNet and VGG wait for later slices
(ROADMAP.md); ``get_model`` names ROADMAP for them. Weights are not
downloaded: ``pretrained=True`` raises, and ``convert.load_jax_params``
loads the reference's weights as numpy arrays.
"""
from ....base import MXNetError
from .resnet import (ResNetV1, ResNetV2, BasicBlockV1, BasicBlockV2,
                     BottleneckV1, BottleneckV2, get_resnet, resnet18_v1,
                     resnet34_v1, resnet50_v1, resnet101_v1, resnet152_v1,
                     resnet18_v2, resnet34_v2, resnet50_v2, resnet101_v2,
                     resnet152_v2)

_models = {
    "resnet18_v1": resnet18_v1, "resnet34_v1": resnet34_v1,
    "resnet50_v1": resnet50_v1, "resnet101_v1": resnet101_v1,
    "resnet152_v1": resnet152_v1,
    "resnet18_v2": resnet18_v2, "resnet34_v2": resnet34_v2,
    "resnet50_v2": resnet50_v2, "resnet101_v2": resnet101_v2,
    "resnet152_v2": resnet152_v2,
}

# the reference zoo's other names (mxnet_tpu/gluon/model_zoo/vision/__init__.py)
_NOT_PORTED = (
    "alexnet", "densenet121", "densenet161", "densenet169", "densenet201",
    "inceptionv3", "mobilenet1.0", "mobilenet0.75", "mobilenet0.5",
    "mobilenet0.25", "mobilenetv2_1.0", "mobilenetv2_0.75", "mobilenetv2_0.5",
    "mobilenetv2_0.25", "squeezenet1.0", "squeezenet1.1", "vgg11", "vgg13",
    "vgg16", "vgg19", "vgg11_bn", "vgg13_bn", "vgg16_bn", "vgg19_bn")


def get_model(name, **kwargs):
    name = name.lower()
    if name in _NOT_PORTED:
        raise MXNetError(f"model {name} is not ported yet (ROADMAP.md lists the "
                         f"zoo families still to port); ported: {sorted(_models)}")
    if name not in _models:
        raise MXNetError(f"model {name} not in zoo: {sorted(_models)}")
    return _models[name](**kwargs)


__all__ = ["get_model", "ResNetV1", "ResNetV2", "BasicBlockV1", "BasicBlockV2",
           "BottleneckV1", "BottleneckV2", "get_resnet", *_models]
