"""Optimizer update operators.

Counterpart of ``mxnet_tpu/ops/optimizer_ops.py`` (its 33 registered ops,
:106-545): the SGD family (``sgd_update``, ``sgd_mom_update``, their
``mp_*`` forms, ``nag_mom_update`` and its ``mp_`` form, ``signsgd_update``,
``signum_update``), the Adam family (``adam_update``, ``_adamw_update``
and its ``mp_`` form), ``ftrl_update``, ``ftml_update``, ``rmsprop_update``,
``rmspropalex_update``, ``_sparse_adagrad_update``,
``_contrib_group_adagrad_update``, the LAMB phases and their ``mp_`` forms,
``multi_sum_sq``, ``multi_lars``, the four ``multi_*sgd*`` ops, the four
``preloaded_multi_*`` ops and ``_multi_(mp_)adamw_update``; each with the
reference's signature, defaults and aliases.

The helpers ``_clip``, ``_rescaled`` and ``_rescaled_wd`` fix the order of
rescale, clip and weight decay: ``_rescaled`` clips rescale·grad and the
caller adds wd after (the SGD, Signum, AdaGrad and LAMB family);
``_rescaled_wd`` adds wd·weight before the clip (the Adam, FTML and RMSProp
family). Clipping is on whenever ``clip_gradient >= 0``, so 0 clamps the
gradient to zero.

Each op is a plain function of tensors returning ``(new weight, *new
states)``; registered ``differentiable=False``, so ``invoke`` runs it under
``no_grad``, and with ``state_inputs`` (pairs, or for the multi-tensor ops
a function of the inputs and params that gives them), so
``nd.sgd_mom_update(w, g, mom, lr=...)`` writes the new momentum back into
``mom`` and returns the new weight, as the reference's nd wrapper does.
The ``multi_*`` ops take the reference's flat layout (weight, grad, states
of weight 0, then of weight 1, ...); the ``preloaded_`` forms read ``lrs``
and ``wds`` from their last two arrays, ``_multi_(mp_)adamw_update`` the
rescale from its last. The ``Optimizer`` classes (``optimizer/optimizer.py``)
call these same functions. ``adam_update`` has no bias correction: the
``Adam`` class folds it into ``lr``.

The lazy row-sparse forms (``sgd_lazy_update``, ``sgd_mom_lazy_update``,
``adam_lazy_update``; reference :73-104) need row-sparse gradients, which
come with ``ndarray/sparse.py`` (ROADMAP A9): they raise until then.
``_sparse_adagrad_update`` given a dense gradient computes what the
reference computes on the same arrays: rows whose gradient is all zero are
left as they are.
"""
from __future__ import annotations

import torch

from ..base import MXNetError
from .registry import register


def _clip(g, clip_gradient):
    """Clipping is on whenever ``clip_gradient >= 0`` (reference
    optimizer_op-inl.h: every kernel tests ``>= 0``; -1 means off). A
    tensor ``clip_gradient`` selects on the device."""
    if clip_gradient is None:
        return g
    if isinstance(clip_gradient, torch.Tensor):
        return torch.where(clip_gradient >= 0,
                           torch.minimum(torch.maximum(g, -clip_gradient), clip_gradient), g)
    if clip_gradient < 0:
        return g
    return torch.clamp(g, -clip_gradient, clip_gradient)


def _rescaled(g, rescale_grad, clip_gradient):
    """SGD family: clip(rescale_grad * grad); weight decay comes after."""
    return _clip(g * rescale_grad, clip_gradient)


def _rescaled_wd(g, weight, wd, rescale_grad, clip_gradient):
    """Adam family: wd * weight joins the gradient before clipping."""
    return _clip(g * rescale_grad + wd * weight, clip_gradient)


def _f32(x):
    return x.float()


def _live_rows(grad):
    """The rows of a dense-backed row-sparse gradient with any nonzero."""
    if grad.dim() > 1:
        return (grad != 0).flatten(1).any(dim=1).view((-1,) + (1,) * (grad.dim() - 1))
    return grad != 0


# ---------------------------------------------------------------------------
# SGD family
# ---------------------------------------------------------------------------

def _needs_sparse(name):
    raise MXNetError(f"{name} updates only the rows of a row-sparse gradient; row-sparse "
                     f"arrays (ndarray/sparse.py) are ROADMAP A9")


def sgd_lazy_update(weight, grad, lr, wd=0.0, rescale_grad=1.0, clip_gradient=-1.0):
    _needs_sparse("sgd_lazy_update")


def sgd_mom_lazy_update(weight, grad, mom, lr, momentum=0.0, wd=0.0, rescale_grad=1.0,
                        clip_gradient=-1.0):
    _needs_sparse("sgd_mom_lazy_update")


def adam_lazy_update(weight, grad, mean, var, lr, beta1=0.9, beta2=0.999, epsilon=1e-8,
                     wd=0.0, rescale_grad=1.0, clip_gradient=-1.0):
    _needs_sparse("adam_lazy_update")


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


@register("mp_sgd_update", differentiable=False, state_inputs=((2, 1),))
def mp_sgd_update(weight, grad, weight32, lr, wd=0.0, rescale_grad=1.0,
                  clip_gradient=-1.0, lazy_update=True):
    g = _rescaled(_f32(grad), rescale_grad, clip_gradient) + wd * weight32
    w32 = weight32 - lr * g
    return w32.to(weight.dtype), w32


@register("mp_sgd_mom_update", differentiable=False, state_inputs=((2, 1), (3, 2)))
def mp_sgd_mom_update(weight, grad, mom, weight32, lr, momentum=0.0, wd=0.0,
                      rescale_grad=1.0, clip_gradient=-1.0, lazy_update=True):
    g = _rescaled(_f32(grad), rescale_grad, clip_gradient) + wd * weight32
    mom2 = momentum * mom - lr * g
    w32 = weight32 + mom2
    return w32.to(weight.dtype), mom2, w32


@register("nag_mom_update", differentiable=False, state_inputs=((2, 1),))
def nag_mom_update(weight, grad, mom, lr, momentum=0.0, wd=0.0,
                   rescale_grad=1.0, clip_gradient=-1.0):
    g = _rescaled(grad, rescale_grad, clip_gradient) + wd * weight
    mom2 = momentum * mom + g
    return weight - lr * (g + momentum * mom2), mom2


@register("mp_nag_mom_update", differentiable=False, state_inputs=((2, 1), (3, 2)))
def mp_nag_mom_update(weight, grad, mom, weight32, lr, momentum=0.0, wd=0.0,
                      rescale_grad=1.0, clip_gradient=-1.0):
    g = _rescaled(_f32(grad), rescale_grad, clip_gradient) + wd * weight32
    mom2 = momentum * mom + g
    w32 = weight32 - lr * (g + momentum * mom2)
    return w32.to(weight.dtype), mom2, w32


@register("signsgd_update", differentiable=False)
def signsgd_update(weight, grad, lr, wd=0.0, rescale_grad=1.0, clip_gradient=-1.0):
    g = _rescaled(grad, rescale_grad, clip_gradient)
    return (1 - lr * wd) * weight - lr * torch.sign(g)


@register("signum_update", differentiable=False, state_inputs=((2, 1),))
def signum_update(weight, grad, mom, lr, momentum=0.0, wd=0.0,
                  rescale_grad=1.0, clip_gradient=-1.0, wd_lh=0.0):
    g = _rescaled(grad, rescale_grad, clip_gradient)
    mom2 = momentum * mom - (1 - momentum) * (g + wd * weight)
    return (1 - lr * wd_lh) * weight + lr * torch.sign(mom2), mom2


# ---------------------------------------------------------------------------
# Adam family (adamw takes rescale_grad as a tensor input, for loss scaling)
# ---------------------------------------------------------------------------

@register("adam_update", differentiable=False, state_inputs=((2, 1), (3, 2)))
def adam_update(weight, grad, mean, var, lr, beta1=0.9, beta2=0.999,
                epsilon=1e-8, wd=0.0, rescale_grad=1.0, clip_gradient=-1.0,
                lazy_update=True):
    g = _rescaled_wd(grad, weight, wd, rescale_grad, clip_gradient)
    m2 = beta1 * mean + (1 - beta1) * g
    v2 = beta2 * var + (1 - beta2) * g * g
    return weight - lr * m2 / (torch.sqrt(v2) + epsilon), m2, v2


def _adamw_core(w32, g, mean, var, rescale_tensor, lr, eta, beta1, beta2, epsilon, wd,
                clip_gradient):
    g = _clip(_f32(g) * rescale_tensor, clip_gradient)
    m2 = beta1 * mean + (1 - beta1) * g
    v2 = beta2 * var + (1 - beta2) * g * g
    w2 = w32 - eta * (lr * m2 / (torch.sqrt(v2) + epsilon) + wd * w32)
    return w2, m2, v2


@register("_adamw_update", aliases=("adamw_update",), differentiable=False,
          state_inputs=((2, 1), (3, 2)))
def adamw_update(weight, grad, mean, var, rescale_grad, lr, eta, beta1=0.9,
                 beta2=0.999, epsilon=1e-8, wd=0.0, clip_gradient=-1.0):
    w2, m2, v2 = _adamw_core(weight, grad, mean, var, rescale_grad, lr, eta,
                             beta1, beta2, epsilon, wd, clip_gradient)
    return w2.to(weight.dtype), m2, v2


@register("_mp_adamw_update", aliases=("mp_adamw_update",), differentiable=False,
          state_inputs=((2, 1), (3, 2), (4, 3)))
def mp_adamw_update(weight, grad, mean, var, weight32, rescale_grad, lr, eta,
                    beta1=0.9, beta2=0.999, epsilon=1e-8, wd=0.0, clip_gradient=-1.0):
    w32, m2, v2 = _adamw_core(weight32, grad, mean, var, rescale_grad, lr, eta,
                              beta1, beta2, epsilon, wd, clip_gradient)
    return w32.to(weight.dtype), m2, v2, w32


# ---------------------------------------------------------------------------
# FTRL / FTML / RMSProp / AdaGrad
# ---------------------------------------------------------------------------

@register("ftrl_update", differentiable=False, state_inputs=((2, 1), (3, 2)))
def ftrl_update(weight, grad, z, n, lr, lamda1=0.01, beta=1.0, wd=0.0,
                rescale_grad=1.0, clip_gradient=-1.0):
    g = _rescaled(grad, rescale_grad, clip_gradient)
    n2 = n + g * g
    sigma = (torch.sqrt(n2) - torch.sqrt(n)) / lr
    z2 = z + g - sigma * weight
    w2 = torch.where(
        torch.abs(z2) > lamda1,
        -(z2 - torch.sign(z2) * lamda1) / ((beta + torch.sqrt(n2)) / lr + wd),
        torch.zeros((), dtype=z2.dtype, device=z2.device)).to(weight.dtype)
    return w2, z2, n2


@register("ftml_update", differentiable=False, state_inputs=((2, 1), (3, 2), (4, 3)))
def ftml_update(weight, grad, d, v, z, lr, t, beta1=0.6, beta2=0.999,
                epsilon=1e-8, wd=0.0, rescale_grad=1.0, clip_grad=-1.0):
    g = _rescaled_wd(grad, weight, wd, rescale_grad, clip_grad)
    v2 = beta2 * v + (1 - beta2) * g * g
    d2 = (1 - beta1 ** t) / lr * (torch.sqrt(v2 / (1 - beta2 ** t)) + epsilon)
    sigma = d2 - beta1 * d
    z2 = beta1 * z + (1 - beta1) * g - sigma * weight
    return -z2 / d2, d2, v2, z2


@register("rmsprop_update", differentiable=False, state_inputs=((2, 1),))
def rmsprop_update(weight, grad, n, lr, rho=0.95, epsilon=1e-8, wd=0.0,
                   rescale_grad=1.0, clip_gradient=-1.0, clip_weights=-1.0):
    g = _rescaled_wd(grad, weight, wd, rescale_grad, clip_gradient)
    n2 = rho * n + (1 - rho) * g * g
    w2 = weight - lr * g / torch.sqrt(n2 + epsilon)
    return _clip(w2, clip_weights), n2


@register("rmspropalex_update", differentiable=False,
          state_inputs=((2, 1), (3, 2), (4, 3)))
def rmspropalex_update(weight, grad, n, g, delta, lr, rho=0.95, momentum=0.9,
                       epsilon=1e-8, wd=0.0, rescale_grad=1.0, clip_gradient=-1.0,
                       clip_weights=-1.0):
    gr = _rescaled_wd(grad, weight, wd, rescale_grad, clip_gradient)
    n2 = rho * n + (1 - rho) * gr * gr
    gavg2 = rho * g + (1 - rho) * gr
    delta2 = momentum * delta - lr * gr / torch.sqrt(n2 - gavg2 * gavg2 + epsilon)
    return _clip(weight + delta2, clip_weights), n2, gavg2, delta2


@register("_sparse_adagrad_update", aliases=("sparse_adagrad_update",),
          differentiable=False, state_inputs=((2, 1),))
def sparse_adagrad_update(weight, grad, history, lr, epsilon=1e-7, wd=0.0,
                          rescale_grad=1.0, clip_gradient=-1.0):
    """Row-sparse AdaGrad on a dense gradient: rows whose gradient is all
    zero are left untouched (the lazy row-sparse semantics)."""
    g = _rescaled(grad, rescale_grad, clip_gradient) + wd * weight
    live = _live_rows(grad)
    h2 = torch.where(live, history + g * g, history)
    w2 = torch.where(live, weight - lr * g / (torch.sqrt(h2) + epsilon), weight)
    return w2, h2


@register("_contrib_group_adagrad_update", aliases=("group_adagrad_update",),
          differentiable=False, state_inputs=((2, 1),))
def group_adagrad_update(weight, grad, history, lr, epsilon=1e-5,
                         rescale_grad=1.0, clip_gradient=-1.0):
    """Per-row (group) AdaGrad: the accumulator holds one value a row, the
    mean of the squared gradients over the trailing axes."""
    g = _rescaled(grad, rescale_grad, clip_gradient)
    axes = tuple(range(1, grad.dim()))
    h2 = history + (torch.mean(g * g, dim=axes) if axes else g * g)
    scale = h2.reshape(tuple(h2.shape) + (1,) * (grad.dim() - 1)) if axes else h2
    return weight - lr * g / (torch.sqrt(scale) + epsilon), h2


# ---------------------------------------------------------------------------
# LAMB phases
# ---------------------------------------------------------------------------

def _lamb_phase1(weight, g, mean, var, beta1, beta2, epsilon, t, bias_correction, wd):
    m2 = beta1 * mean + (1 - beta1) * g
    v2 = beta2 * var + (1 - beta2) * g * g
    if bias_correction:
        mhat, vhat = m2 / (1 - beta1 ** t), v2 / (1 - beta2 ** t)
    else:
        mhat, vhat = m2, v2
    return mhat / (torch.sqrt(vhat) + epsilon) + wd * weight, m2, v2


@register("lamb_update_phase1", differentiable=False, state_inputs=((2, 1), (3, 2)))
def lamb_update_phase1(weight, grad, mean, var, beta1=0.9, beta2=0.999,
                       epsilon=1e-6, t=1, bias_correction=True, wd=0.0,
                       rescale_grad=1.0, clip_gradient=-1.0):
    g = _rescaled(grad, rescale_grad, clip_gradient)
    return _lamb_phase1(weight, g, mean, var, beta1, beta2, epsilon, t, bias_correction, wd)


def _lamb_phase2(weight32, g, r1, r2, lr, lower_bound, upper_bound):
    if lower_bound is not None and lower_bound > 0:
        r1 = torch.clamp(r1, min=lower_bound)
    if upper_bound is not None and upper_bound > 0:
        r1 = torch.clamp(r1, max=upper_bound)
    ratio = torch.where((r1 > 0) & (r2 > 0), r1 / r2, torch.ones_like(r1))
    return weight32 - lr * ratio * g


@register("lamb_update_phase2", differentiable=False)
def lamb_update_phase2(weight, g, r1, r2, lr, lower_bound=-1.0, upper_bound=-1.0):
    return _lamb_phase2(weight, g, r1, r2, lr, lower_bound, upper_bound)


@register("mp_lamb_update_phase1", differentiable=False, state_inputs=((2, 1), (3, 2)))
def mp_lamb_update_phase1(weight, grad, mean, var, weight32, beta1=0.9,
                          beta2=0.999, epsilon=1e-6, t=1, bias_correction=True,
                          wd=0.0, rescale_grad=1.0, clip_gradient=-1.0):
    g = _rescaled(_f32(grad), rescale_grad, clip_gradient)
    return _lamb_phase1(weight32, g, mean, var, beta1, beta2, epsilon, t, bias_correction,
                        wd)


@register("mp_lamb_update_phase2", differentiable=False, state_inputs=((4, 1),))
def mp_lamb_update_phase2(weight, g, r1, r2, weight32, lr, lower_bound=-1.0,
                          upper_bound=-1.0):
    w32 = _lamb_phase2(weight32, g, r1, r2, lr, lower_bound, upper_bound)
    return w32.to(weight.dtype), w32


# ---------------------------------------------------------------------------
# Multi-tensor ops
# ---------------------------------------------------------------------------

@register("multi_sum_sq", differentiable=False)
def multi_sum_sq(*arrays, num_arrays):
    """The sum of squares of each input, stacked into a (num_arrays,)
    vector (it feeds ``multi_lars``)."""
    return torch.stack([torch.sum(torch.square(_f32(a))) for a in arrays])


@register("multi_lars", differentiable=False)
def multi_lars(lrs, weights_sum_sq, grads_sum_sq, wds, eta, eps, rescale_grad=1.0):
    wn = torch.sqrt(weights_sum_sq)
    gn = torch.sqrt(grads_sum_sq) * rescale_grad
    trust = torch.where((wn > 0) & (gn > 0), eta * wn / (gn + wds * wn + eps),
                        torch.ones_like(wn))
    return lrs * trust


def _multi_sgd(arrays, stride, lrs, wds, momentum, rescale_grad, clip_gradient,
               num_weights, mp):
    new_w, new_state = [], []
    for i in range(num_weights):
        chunk = arrays[i * stride:(i + 1) * stride]
        w, g = chunk[0], chunk[1]
        master = chunk[-1] if mp else w
        mom = chunk[2] if stride - mp == 3 else None
        g = _rescaled(_f32(g) if mp else g, rescale_grad, clip_gradient) + wds[i] * master
        if mom is not None:
            mom2 = momentum * mom - lrs[i] * g
            w2 = master + mom2
            new_state.append(mom2)
        else:
            w2 = master - lrs[i] * g
        new_w.append(w2.to(w.dtype))
        if mp:
            new_state.append(w2)
    return tuple(new_w) + tuple(new_state)


def _multi_state_spec(stride, has_mom, mp):
    """``state_inputs`` of a multi SGD op: its mom and weight32 inputs,
    mapped to their outputs after the ``num_weights`` weights."""
    def spec(inputs, params):
        pairs, out = [], params["num_weights"]
        for i in range(params["num_weights"]):
            for present, at in ((has_mom, 2), (mp, stride - 1)):
                if present:
                    pairs.append((i * stride + at, out))
                    out += 1
        return pairs
    return spec


@register("multi_sgd_update", differentiable=False)
def multi_sgd_update(*arrays, lrs, wds, num_weights, rescale_grad=1.0, clip_gradient=-1.0):
    return _multi_sgd(arrays, 2, lrs, wds, 0.0, rescale_grad, clip_gradient, num_weights,
                      mp=False)


@register("multi_sgd_mom_update", differentiable=False,
          state_inputs=_multi_state_spec(3, True, False))
def multi_sgd_mom_update(*arrays, lrs, wds, num_weights, momentum=0.0, rescale_grad=1.0,
                         clip_gradient=-1.0):
    return _multi_sgd(arrays, 3, lrs, wds, momentum, rescale_grad, clip_gradient,
                      num_weights, mp=False)


@register("multi_mp_sgd_update", differentiable=False,
          state_inputs=_multi_state_spec(3, False, True))
def multi_mp_sgd_update(*arrays, lrs, wds, num_weights, rescale_grad=1.0,
                        clip_gradient=-1.0):
    return _multi_sgd(arrays, 3, lrs, wds, 0.0, rescale_grad, clip_gradient, num_weights,
                      mp=True)


@register("multi_mp_sgd_mom_update", differentiable=False,
          state_inputs=_multi_state_spec(4, True, True))
def multi_mp_sgd_mom_update(*arrays, lrs, wds, num_weights, momentum=0.0,
                            rescale_grad=1.0, clip_gradient=-1.0):
    return _multi_sgd(arrays, 4, lrs, wds, momentum, rescale_grad, clip_gradient,
                      num_weights, mp=True)


def _preloaded(arrays, stride, mp, momentum, rescale_grad, clip_gradient, num_weights):
    lrs_t, wds_t = arrays[-2], arrays[-1]
    return _multi_sgd(arrays[:-2], stride, [lrs_t[i] for i in range(num_weights)],
                      [wds_t[i] for i in range(num_weights)], momentum, rescale_grad,
                      clip_gradient, num_weights, mp=mp)


@register("preloaded_multi_sgd_update", differentiable=False)
def preloaded_multi_sgd_update(*arrays, num_weights, rescale_grad=1.0, clip_gradient=-1.0):
    return _preloaded(arrays, 2, False, 0.0, rescale_grad, clip_gradient, num_weights)


@register("preloaded_multi_sgd_mom_update", differentiable=False,
          state_inputs=_multi_state_spec(3, True, False))
def preloaded_multi_sgd_mom_update(*arrays, num_weights, momentum=0.0, rescale_grad=1.0,
                                   clip_gradient=-1.0):
    return _preloaded(arrays, 3, False, momentum, rescale_grad, clip_gradient, num_weights)


@register("preloaded_multi_mp_sgd_update", differentiable=False,
          state_inputs=_multi_state_spec(3, False, True))
def preloaded_multi_mp_sgd_update(*arrays, num_weights, rescale_grad=1.0,
                                  clip_gradient=-1.0):
    return _preloaded(arrays, 3, True, 0.0, rescale_grad, clip_gradient, num_weights)


@register("preloaded_multi_mp_sgd_mom_update", differentiable=False,
          state_inputs=_multi_state_spec(4, True, True))
def preloaded_multi_mp_sgd_mom_update(*arrays, num_weights, momentum=0.0,
                                      rescale_grad=1.0, clip_gradient=-1.0):
    return _preloaded(arrays, 4, True, momentum, rescale_grad, clip_gradient, num_weights)


def _multi_adamw_spec(stride, mp):
    def spec(inputs, params):
        pairs, out = [], params["num_weights"]
        for i in range(params["num_weights"]):
            for at in (2, 3, 4) if mp else (2, 3):
                pairs.append((i * stride + at, out))
                out += 1
        return pairs
    return spec


def _multi_adamw(arrays, stride, mp, lrs, etas, wds, beta1, beta2, epsilon, clip_gradient,
                 num_weights):
    rescale = arrays[-1]
    new_w, new_state = [], []
    for i in range(num_weights):
        w, g, m, v = arrays[i * stride:i * stride + 4]
        master = arrays[i * stride + 4] if mp else w
        w2, m2, v2 = _adamw_core(master, g, m, v, rescale, lrs[i], etas[i], beta1, beta2,
                                 epsilon, wds[i], clip_gradient)
        new_w.append(w2.to(w.dtype))
        new_state.extend([m2, v2] + ([w2] if mp else []))
    return tuple(new_w) + tuple(new_state)


@register("_multi_adamw_update", aliases=("multi_adamw_update",), differentiable=False,
          state_inputs=_multi_adamw_spec(4, False))
def multi_adamw_update(*arrays, lrs, etas, wds, num_weights, beta1=0.9, beta2=0.999,
                       epsilon=1e-8, clip_gradient=-1.0):
    return _multi_adamw(arrays, 4, False, lrs, etas, wds, beta1, beta2, epsilon,
                        clip_gradient, num_weights)


@register("_multi_mp_adamw_update", aliases=("multi_mp_adamw_update",),
          differentiable=False, state_inputs=_multi_adamw_spec(5, True))
def multi_mp_adamw_update(*arrays, lrs, etas, wds, num_weights, beta1=0.9, beta2=0.999,
                          epsilon=1e-8, clip_gradient=-1.0):
    return _multi_adamw(arrays, 5, True, lrs, etas, wds, beta1, beta2, epsilon,
                        clip_gradient, num_weights)
