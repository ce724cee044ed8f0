"""Optimizer update operators.

Counterpart of ``mxnet_tpu/ops/optimizer_ops.py:23-189``: ``sgd_update``,
``sgd_mom_update`` and ``adam_update``, with the helpers ``_clip``,
``_rescaled`` and ``_rescaled_wd`` that fix the order of rescale, clip and
weight decay. Each op is a plain function of tensors returning
``(new weight, *new states)``; registered ``differentiable=False``, so
``invoke`` runs it under ``no_grad``, and with ``state_inputs``, so
``nd.sgd_mom_update(w, g, mom, lr=...)`` writes the new momentum back into
``mom`` and returns the new weight, as the reference's nd wrapper does.
The ``Optimizer`` classes (``optimizer/optimizer.py``) call these same
functions. ``adam_update`` has no bias correction: the ``Adam`` class folds
it into ``lr``.

The lazy row-sparse forms, the multi-precision ``mp_*`` ops, the fused
``multi_*`` ops and the other optimizers' rules wait for later slices.
"""
from __future__ import annotations

import torch

from .registry import register


def _clip(g, clip_gradient):
    """Clipping is on whenever ``clip_gradient >= 0`` (reference
    optimizer_op-inl.h: every kernel tests ``>= 0``; -1 means off)."""
    if clip_gradient is None or clip_gradient < 0:
        return g
    return torch.clamp(g, -clip_gradient, clip_gradient)


def _rescaled(g, rescale_grad, clip_gradient):
    """SGD family: clip(rescale_grad * grad); weight decay comes after."""
    return _clip(g * rescale_grad, clip_gradient)


def _rescaled_wd(g, weight, wd, rescale_grad, clip_gradient):
    """Adam family: wd * weight joins the gradient before clipping."""
    return _clip(g * rescale_grad + wd * weight, clip_gradient)


@register("sgd_update", differentiable=False)
def sgd_update(weight, grad, lr, wd=0.0, rescale_grad=1.0, clip_gradient=-1.0,
               lazy_update=True):
    g = _rescaled(grad, rescale_grad, clip_gradient) + wd * weight
    return weight - lr * g


@register("sgd_mom_update", differentiable=False, state_inputs=((2, 1),))
def sgd_mom_update(weight, grad, mom, lr, momentum=0.0, wd=0.0,
                   rescale_grad=1.0, clip_gradient=-1.0, lazy_update=True):
    g = _rescaled(grad, rescale_grad, clip_gradient) + wd * weight
    mom2 = momentum * mom - lr * g
    return weight + mom2, mom2


@register("adam_update", differentiable=False, state_inputs=((2, 1), (3, 2)))
def adam_update(weight, grad, mean, var, lr, beta1=0.9, beta2=0.999,
                epsilon=1e-8, wd=0.0, rescale_grad=1.0, clip_gradient=-1.0,
                lazy_update=True):
    g = _rescaled_wd(grad, weight, wd, rescale_grad, clip_gradient)
    m2 = beta1 * mean + (1 - beta1) * g
    v2 = beta2 * var + (1 - beta2) * g * g
    return weight - lr * m2 / (torch.sqrt(v2) + epsilon), m2, v2
