"""Core layers.

Counterpart of ``mxnet_tpu/gluon/nn/basic_layers.py:13-278``: ``Sequential``,
``HybridSequential``, ``Dense`` (with ``activation``, e.g. ``"gelu"``),
``Dropout`` (identity at p=0 or outside training), ``BatchNorm``,
``Embedding``, ``Flatten``, ``Activation`` and ``LayerNorm``. A layer built
without its input width (``in_units``, ``in_channels``) takes it from its
first input (deferred shape inference, ``gluon/block.py``). The other norms
and activation layers wait for the slices whose models use them.

Under tensor parallelism (a weight placed on a mesh of ranks with a spec
over one axis, ``parallel.shard_params_megatron``), ``Dense`` and
``Embedding`` compute their rank's part with the boundary collectives of
``parallel/megatron.py``: a column-parallel ``Dense`` (weight ``P(tp,
None)``) applies ``copy_to_tp`` and then the local product with its bias
shard; a row-parallel one (``P(None, tp)``) the local product, then
``reduce_from_tp``, then the replicated bias, added once; a vocab-sharded
``Embedding`` (``P(tp, None)``) ``vocab_parallel_embedding`` and then
``reduce_from_tp``. The product stays ``FullyConnected`` (``F.linear``).
"""
from __future__ import annotations

import math

import torch

from ...base import MXNetError, torch_dtype
from ...ndarray import NDArray
from ..block import Block, HybridBlock, defer_aux_update


def _tp_layout(param):
    """(sharded dim, axis, mesh) of a weight placed on a mesh with a spec,
    or (None, None, None)."""
    if param._mesh is None or param.sharding is None:
        return None, None, None
    from ...parallel.tensor_parallel import spec_axes, tp_shard_dim
    sharded = spec_axes(param.sharding)
    if not sharded:
        return None, None, None
    axis = sharded[0][1][0]
    return tp_shard_dim(param.sharding, axis), axis, param._mesh


def _wrap(t, like: NDArray) -> NDArray:
    return NDArray(t, like.ctx)


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
                                      dtype=dtype, init=weight_initializer,
                                      allow_deferred_init=True)
        if use_bias:
            self.bias = self.params.get("bias", shape=(units,), dtype=dtype,
                                        init=bias_initializer,
                                        allow_deferred_init=True)
        else:
            self.bias = None

    def infer_shape(self, x, *args):
        in_units = math.prod(x.shape[1:]) if self._flatten else x.shape[-1]
        self.weight.shape = (self._units, in_units)

    def hybrid_forward(self, F, x, weight, bias=None):
        dim, axis, mesh = _tp_layout(self.weight)
        if dim is None:
            out = F.FullyConnected(x, weight, bias, num_hidden=self._units,
                                   no_bias=(bias is None), flatten=self._flatten)
        elif dim == 0:                  # column-parallel: the bias is sharded too
            from ...parallel import megatron
            x = _wrap(megatron.copy_to_tp(x._data, axis, mesh), x)
            out = F.FullyConnected(x, weight, bias, num_hidden=weight.shape[0],
                                   no_bias=(bias is None), flatten=self._flatten)
        else:                           # row-parallel: the bias after the sum
            from ...parallel import megatron
            out = F.FullyConnected(x, weight, None, num_hidden=self._units,
                                   no_bias=True, flatten=self._flatten)
            out = _wrap(megatron.reduce_from_tp(out._data, axis, mesh), out)
            if bias is not None:
                out = out + bias
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


class BatchNorm(HybridBlock):
    """reference basic_layers.py:98-156. In training (``autograd.record()``
    or ``train_mode``) it normalises by the batch's statistics and blends
    them into the running ones, m * running + (1 - m) * batch with the
    batch's biased variance; otherwise, and always under
    ``use_global_stats``, it normalises by the running stats. The running
    stats are parameters with ``grad_req="null"``: the Trainer skips them."""

    def __init__(self, axis=1, momentum=0.9, epsilon=1e-5, center=True,
                 scale=True, use_global_stats=False, beta_initializer="zeros",
                 gamma_initializer="ones", running_mean_initializer="zeros",
                 running_variance_initializer="ones", in_channels=0,
                 prefix=None, params=None):
        super().__init__(prefix, params)
        self._axis = axis
        self._momentum = momentum
        self._epsilon = epsilon
        self._scale = scale
        self._use_global_stats = use_global_stats
        self.gamma = self.params.get("gamma", shape=(in_channels,),
                                     init=gamma_initializer, allow_deferred_init=True,
                                     grad_req="write" if scale else "null")
        self.beta = self.params.get("beta", shape=(in_channels,),
                                    init=beta_initializer, allow_deferred_init=True,
                                    grad_req="write" if center else "null")
        self.running_mean = self.params.get("running_mean", shape=(in_channels,),
                                            init=running_mean_initializer,
                                            allow_deferred_init=True,
                                            grad_req="null", differentiable=False)
        self.running_var = self.params.get("running_var", shape=(in_channels,),
                                           init=running_variance_initializer,
                                           allow_deferred_init=True,
                                           grad_req="null", differentiable=False)

    def infer_shape(self, x, *args):
        c = x.shape[self._axis]
        for p in (self.gamma, self.beta, self.running_mean, self.running_var):
            p.shape = (c,)

    def cast(self, dtype):
        """The statistics stay in f32 for bf16/f16 (reference :139-144)."""
        if torch_dtype(dtype) in (torch.float16, torch.bfloat16):
            dtype = "float32"
        super().cast(dtype)

    def hybrid_forward(self, F, x, gamma, beta, running_mean, running_var):
        from ... import autograd
        training = (autograd.is_training() or autograd.is_recording()) \
            and not self._use_global_stats
        out, mean, var = F.BatchNorm(
            x, gamma, beta, running_mean, running_var, eps=self._epsilon,
            momentum=self._momentum, fix_gamma=not self._scale,
            use_global_stats=self._use_global_stats, axis=self._axis,
            training=training)
        if training:
            m = self._momentum
            with torch.no_grad():
                defer_aux_update(self.running_mean,
                                 m * running_mean._data + (1 - m) * mean._data)
                defer_aux_update(self.running_var,
                                 m * running_var._data + (1 - m) * var._data)
        return out


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
        dim, axis, mesh = _tp_layout(self.weight)
        if dim is None:
            return F.Embedding(x, weight, input_dim=self._input_dim,
                               output_dim=self._output_dim)
        if dim != 0:
            raise MXNetError(f"Embedding weight {self.weight.name}: only the vocab "
                             f"dim shards, got {self.weight.sharding}")
        from ...parallel import megatron
        part = megatron.vocab_parallel_embedding(x._data, weight._data, axis, mesh)
        return _wrap(megatron.reduce_from_tp(part, axis, mesh), x)


class Flatten(HybridBlock):
    """(N, ...) -> (N, prod(...)) (reference basic_layers.py:188)."""

    def hybrid_forward(self, F, x):
        return F.Flatten(x)


class Activation(HybridBlock):
    """reference basic_layers.py:193."""

    def __init__(self, activation, prefix=None, params=None):
        super().__init__(prefix, params)
        self._act_type = activation

    def hybrid_forward(self, F, x):
        return F.Activation(x, act_type=self._act_type)


class LayerNorm(HybridBlock):
    """reference basic_layers.py:546."""

    def __init__(self, axis=-1, epsilon=1e-5, center=True, scale=True,
                 beta_initializer="zeros", gamma_initializer="ones",
                 in_channels=0, prefix=None, params=None):
        super().__init__(prefix, params)
        self._axis = axis
        self._epsilon = epsilon
        self.gamma = self.params.get("gamma", shape=(in_channels,),
                                     init=gamma_initializer, allow_deferred_init=True,
                                     grad_req="write" if scale else "null")
        self.beta = self.params.get("beta", shape=(in_channels,),
                                    init=beta_initializer, allow_deferred_init=True,
                                    grad_req="write" if center else "null")

    def infer_shape(self, x, *args):
        c = x.shape[self._axis]
        self.gamma.shape = (c,)
        self.beta.shape = (c,)

    def hybrid_forward(self, F, x, gamma, beta):
        return F.LayerNorm(x, gamma, beta, axis=self._axis, eps=self._epsilon)
