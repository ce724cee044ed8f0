"""Core layers.

Counterpart of ``mxnet_tpu/gluon/nn/basic_layers.py:13-278``: ``Sequential``,
``HybridSequential``, ``Dense`` (with ``activation``, e.g. ``"gelu"``),
``Dropout`` (identity at p=0 or outside training), ``Embedding`` and
``LayerNorm``. Every layer needs its input width (``in_units``,
``in_channels``): deferred shape inference is not ported yet, and
initializing a layer without it raises ``MXNetError``. BatchNorm, the other
norms and activations wait for the slices whose models use them.
"""
from __future__ import annotations

from ..block import Block, HybridBlock


class Sequential(Block):
    def __init__(self, prefix=None, params=None):
        super().__init__(prefix, params)

    def add(self, *blocks):
        for b in blocks:
            self.register_child(b)

    def forward(self, x):
        for b in self._modules.values():
            x = b(x)
        return x

    def __getitem__(self, i):
        return list(self._modules.values())[i]

    def __len__(self):
        return len(self._modules)


class HybridSequential(HybridBlock):
    def __init__(self, prefix=None, params=None):
        super().__init__(prefix, params)

    def add(self, *blocks):
        for b in blocks:
            self.register_child(b)

    def hybrid_forward(self, F, x):
        for b in self._modules.values():
            x = b(x)
        return x

    def __getitem__(self, i):
        return list(self._modules.values())[i]

    def __len__(self):
        return len(self._modules)


class Dense(HybridBlock):
    """reference basic_layers.py:144 — weight (units, in_units)."""

    def __init__(self, units, activation=None, use_bias=True, flatten=True,
                 dtype="float32", weight_initializer=None, bias_initializer="zeros",
                 in_units=0, prefix=None, params=None):
        super().__init__(prefix, params)
        self._units = units
        self._flatten = flatten
        self._activation = activation
        self.weight = self.params.get("weight", shape=(units, in_units),
                                      dtype=dtype, init=weight_initializer)
        if use_bias:
            self.bias = self.params.get("bias", shape=(units,), dtype=dtype,
                                        init=bias_initializer)
        else:
            self.bias = None

    def hybrid_forward(self, F, x, weight, bias=None):
        out = F.FullyConnected(x, weight, bias, num_hidden=self._units,
                               no_bias=(bias is None), flatten=self._flatten)
        if self._activation:
            out = F.Activation(out, act_type=self._activation)
        return out


class Dropout(HybridBlock):
    def __init__(self, rate, axes=(), prefix=None, params=None):
        super().__init__(prefix, params)
        self._rate = rate
        self._axes = tuple(axes)

    def hybrid_forward(self, F, x):
        from ... import autograd
        return F.Dropout(x, p=self._rate, axes=self._axes,
                         training=autograd.is_training() or autograd.is_recording())


class Embedding(HybridBlock):
    """Ids must lie in [0, input_dim): see ``ops/nn.py`` on out-of-range ids.
    ``sparse_grad`` is accepted; the gradient is dense (row-sparse storage
    is not ported)."""

    def __init__(self, input_dim, output_dim, dtype="float32",
                 weight_initializer=None, sparse_grad=False, prefix=None, params=None):
        super().__init__(prefix, params)
        self._input_dim = input_dim
        self._output_dim = output_dim
        self.weight = self.params.get(
            "weight", shape=(input_dim, output_dim), dtype=dtype,
            init=weight_initializer,
            grad_stype="row_sparse" if sparse_grad else "default")

    def hybrid_forward(self, F, x, weight):
        return F.Embedding(x, weight, input_dim=self._input_dim,
                           output_dim=self._output_dim)


class LayerNorm(HybridBlock):
    """reference basic_layers.py:546."""

    def __init__(self, axis=-1, epsilon=1e-5, center=True, scale=True,
                 beta_initializer="zeros", gamma_initializer="ones",
                 in_channels=0, prefix=None, params=None):
        super().__init__(prefix, params)
        self._axis = axis
        self._epsilon = epsilon
        self.gamma = self.params.get("gamma", shape=(in_channels,),
                                     init=gamma_initializer,
                                     grad_req="write" if scale else "null")
        self.beta = self.params.get("beta", shape=(in_channels,),
                                    init=beta_initializer,
                                    grad_req="write" if center else "null")

    def hybrid_forward(self, F, x, gamma, beta):
        return F.LayerNorm(x, gamma, beta, axis=self._axis, eps=self._epsilon)
