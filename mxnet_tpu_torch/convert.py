"""Weights across the two packages, as numpy arrays.

``load_jax_params(net, arrays)`` loads a dict keyed by the reference's
structural parameter paths (``encoder.layers.0.attn.qkv.weight``,
``embed_ln.gamma``), the form
``{k: p.data().asnumpy() for k, p in jnet._collect_params_with_prefix().items()}``
gives for a ``mxnet_tpu`` block. The port's ``Block`` has the same paths, so
the dict loads as it is. Every key is checked before any value is copied:
a missing, extra or mis-shaped key raises ``MXNetError`` and loads nothing.

``seeded_params(net, seed)`` makes such a dict with numpy, the same for the
same seed on every host, so a run on the card and the CPU tests load
weights through the same function. Both work for every model of the port
whose paths follow the reference's: BERT, ResNet, the long-context recipe's
``LongContextLM`` (``word_embed``, ``pos_embed``, ``cells.<i>.attn.qkv``, ...)
and ``MoETransformerLM`` (``cells.<i>.moe.gate_w``, ``.w1``, ``.w2``).

The carrier for ranks: ``shard_arrays(arrays, specs, mesh)`` cuts one rank's
shards out of full arrays by their ``PartitionSpec``s (the parameters'
``sharding`` after ``parallel.shard_params_megatron``, or an expert's
``P("ep", None, None)`` under ``recipes.moe.MoETrainer``), and ``gather_params(net)`` /
``gather_grads(net)`` gather every placed parameter's shards (or its
gradient's) back into full numpy arrays by structural path, a collective
that every rank of the mesh calls. The tests and ``chip_smoke.py`` compare
the ranks with the reference through them.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .base import MXNetError
from .parallel.tensor_parallel import gather_tensor, shard_tensor


def load_jax_params(net, arrays: Dict[str, np.ndarray]) -> None:
    params = net._collect_params_with_prefix()
    missing = sorted(set(params) - set(arrays))
    extra = sorted(set(arrays) - set(params))
    if missing or extra:
        raise MXNetError(f"load_jax_params: missing {missing[:5]} "
                         f"({len(missing)}), extra {extra[:5]} ({len(extra)})")
    for key, p in params.items():
        shape = tuple(np.shape(arrays[key]))
        if p.shape is not None and shape != tuple(p.shape):
            raise MXNetError(f"load_jax_params: {key} has shape {shape}, "
                             f"the parameter {p.shape}")
    for key, p in params.items():
        p.set_data(np.asarray(arrays[key]))


def seeded_params(net, seed: int) -> Dict[str, np.ndarray]:
    """Random f32 weights for every structural path of ``net``, drawn in
    path order from one ``RandomState(seed)``:

    - 4-D (convolution) weights: N(0, sqrt(2 / fan_in)), fan_in = in
      channels x kernel area, so activations keep their scale through a
      deep convolutional stack;
    - norm gamma 1 + N(0, 0.1), beta N(0, 0.1);
    - BatchNorm running_mean 0.1 N, running_var 1 + 0.1 |N| (positive, so
      inference never takes the root of a negative variance);
    - every other tensor (dense weights, biases): N(0, 0.02).

    A net without convolutions or BatchNorm (BERT) gets what the same seed
    gave before the first two rules existed. A net with deferred shapes
    needs one forward first."""
    rs = np.random.RandomState(seed)
    out = {}
    for key, p in net._collect_params_with_prefix().items():
        if not p._shape_complete():
            raise MXNetError(f"seeded_params: {key} has incomplete shape {p.shape}")
        if key.endswith("gamma"):
            a = 1.0 + 0.1 * rs.standard_normal(p.shape)
        elif key.endswith("beta"):
            a = 0.1 * rs.standard_normal(p.shape)
        elif key.endswith("running_mean"):
            a = 0.1 * rs.standard_normal(p.shape)
        elif key.endswith("running_var"):
            a = 1.0 + 0.1 * np.abs(rs.standard_normal(p.shape))
        elif len(p.shape) == 4:
            fan_in = int(np.prod(p.shape[1:]))
            a = np.sqrt(2.0 / fan_in) * rs.standard_normal(p.shape)
        else:
            a = 0.02 * rs.standard_normal(p.shape)
        out[key] = a.astype(np.float32)
    return out


def shard_arrays(arrays: Dict[str, np.ndarray], specs: Dict[str, object],
                 mesh) -> Dict[str, np.ndarray]:
    """One rank's shards of full arrays: each array cut by its spec at the
    mesh's coordinates (an array without a spec is whole)."""
    return {k: np.ascontiguousarray(
        shard_tensor(torch.from_numpy(np.asarray(a)), specs.get(k), mesh).numpy())
        for k, a in arrays.items()}


def gather_params(net) -> Dict[str, np.ndarray]:
    """Every parameter of ``net`` as a full numpy array by structural path,
    its shards gathered from the ranks of the mesh it is placed on."""
    return {k: gather_tensor(p._param.detach(), p.sharding, p._mesh).cpu().numpy()
            for k, p in net._collect_params_with_prefix().items()}


def gather_grads(net) -> Dict[str, np.ndarray]:
    """The gradient buffer of every parameter that has one, full, by path."""
    return {k: gather_tensor(p._grad, p.sharding, p._mesh).cpu().numpy()
            for k, p in net._collect_params_with_prefix().items()
            if p._grad is not None}
