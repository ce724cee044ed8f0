"""Convolution and pooling layers.

Counterpart of ``mxnet_tpu/gluon/nn/conv_layers.py``: ``_Conv`` (:16) with
``Conv2D`` (:75), ``_Pooling`` (:135), ``MaxPool2D``, ``AvgPool2D``,
``GlobalMaxPool2D`` and ``GlobalAvgPool2D``, in NCHW with OIHW weights.
A ``Conv2D`` built without ``in_channels`` takes it from its first input.
The 1-D and 3-D layers, the transposed convolutions and ``ReflectionPad2D``
wait for the slices whose models use them.
"""
from __future__ import annotations

from ..block import HybridBlock


def _tuple(v, n):
    return (v,) * n if isinstance(v, int) else tuple(v)


class _Conv(HybridBlock):
    """reference conv_layers.py:16-72 (the ``Convolution`` op only)."""

    def __init__(self, channels, kernel_size, strides, padding, dilation,
                 groups, layout, in_channels=0, activation=None, use_bias=True,
                 weight_initializer=None, bias_initializer="zeros",
                 prefix=None, params=None):
        super().__init__(prefix, params)
        self._channels = channels
        self._kwargs = {
            "kernel": kernel_size, "stride": strides, "dilate": dilation,
            "pad": padding, "num_filter": channels, "num_group": groups,
            "no_bias": not use_bias, "layout": layout}
        self._activation = activation
        wshape = (channels, in_channels // groups if in_channels else 0) + kernel_size
        self.weight = self.params.get("weight", shape=wshape,
                                      init=weight_initializer,
                                      allow_deferred_init=True)
        if use_bias:
            self.bias = self.params.get("bias", shape=(channels,),
                                        init=bias_initializer,
                                        allow_deferred_init=True)
        else:
            self.bias = None

    def infer_shape(self, x, *args):
        self.weight.shape = ((self._channels, x.shape[1] // self._kwargs["num_group"])
                             + tuple(self._kwargs["kernel"]))

    def hybrid_forward(self, F, x, weight, bias=None):
        out = F.Convolution(x, weight, bias, **self._kwargs)
        if self._activation:
            out = F.Activation(out, act_type=self._activation)
        return out


class Conv2D(_Conv):
    def __init__(self, channels, kernel_size, strides=(1, 1), padding=(0, 0),
                 dilation=(1, 1), groups=1, layout="NCHW", activation=None,
                 use_bias=True, weight_initializer=None, bias_initializer="zeros",
                 in_channels=0, prefix=None, params=None):
        super().__init__(channels, _tuple(kernel_size, 2), _tuple(strides, 2),
                         _tuple(padding, 2), _tuple(dilation, 2), groups, layout,
                         in_channels, activation, use_bias, weight_initializer,
                         bias_initializer, prefix=prefix, params=params)


class _Pooling(HybridBlock):
    """reference conv_layers.py:135-150; ``ceil_mode`` is the ``"full"``
    pooling convention (see ``ops/nn.py``)."""

    def __init__(self, pool_size, strides, padding, ceil_mode, global_pool,
                 pool_type, layout, count_include_pad=None, prefix=None, params=None):
        super().__init__(prefix, params)
        if strides is None:
            strides = pool_size
        self._kwargs = {
            "kernel": pool_size, "stride": strides, "pad": padding,
            "pool_type": pool_type, "global_pool": global_pool,
            "pooling_convention": "full" if ceil_mode else "valid"}
        if count_include_pad is not None:
            self._kwargs["count_include_pad"] = count_include_pad

    def hybrid_forward(self, F, x):
        return F.Pooling(x, **self._kwargs)


class MaxPool2D(_Pooling):
    def __init__(self, pool_size=(2, 2), strides=None, padding=0, layout="NCHW",
                 ceil_mode=False, prefix=None, params=None):
        super().__init__(_tuple(pool_size, 2), _tuple(strides or pool_size, 2),
                         _tuple(padding, 2), ceil_mode, False, "max", layout,
                         prefix=prefix, params=params)


class AvgPool2D(_Pooling):
    def __init__(self, pool_size=(2, 2), strides=None, padding=0, layout="NCHW",
                 ceil_mode=False, count_include_pad=True, prefix=None, params=None):
        super().__init__(_tuple(pool_size, 2), _tuple(strides or pool_size, 2),
                         _tuple(padding, 2), ceil_mode, False, "avg", layout,
                         count_include_pad, prefix=prefix, params=params)


class GlobalMaxPool2D(_Pooling):
    def __init__(self, layout="NCHW", prefix=None, params=None):
        super().__init__((1, 1), (1, 1), (0, 0), False, True, "max", layout,
                         prefix=prefix, params=params)


class GlobalAvgPool2D(_Pooling):
    def __init__(self, layout="NCHW", prefix=None, params=None):
        super().__init__((1, 1), (1, 1), (0, 0), False, True, "avg", layout,
                         prefix=prefix, params=params)
