"""Optimizers: the base class, ``Updater`` and the reference's 19 classes.

Counterpart of ``mxnet_tpu/optimizer/optimizer.py``: ``Optimizer``,
``Updater``, ``create``/``register`` (:27-215), the update rules ``_k_*``
(:295-485) and the registered classes (:492-907): ``SGD``, ``ccSGD``,
``NAG``, ``SGLD``, ``Signum``, ``DCASGD``, ``FTML``, ``LARS``, ``LBSGD``,
``LAMB``, ``Adam``, ``AdamW``, ``AdaGrad``, ``RMSProp``, ``AdaDelta``,
``Ftrl``, ``Adamax``, ``Nadam`` and ``Test``, under their registered
(lower-cased) names. As in the reference, ``ccSGD`` is registered as its
own subclass of ``SGD`` and the module's name is then rebound to ``SGD``.

The hyper-parameters reach the rules rounded to float32, as the
reference's jitted kernels take them. Two clip conventions, both the
reference's: the rules that go through the registered ops
(``ops/optimizer_ops.py``: SGD, NAG, Adam, RMSProp, Ftrl, Signum, FTML)
clip when ``clip_gradient >= 0``, so 0 zeroes the gradient; the rules
written here (``_k_adamw``, ``_k_adagrad``, ``_k_adadelta``, ``_k_adamax``,
``_k_nadam``, ``_k_dcasgd``, ``_k_sgld``, ``_k_lars``, ``_k_lamb``) clip
when ``clip_gradient > 0``, so 0 turns clipping off. ``Adam`` folds the bias
correction into the learning rate, ``lr * sqrt(1 - beta2**t) / (1 -
beta1**t)``, as ``_k_adam`` does; ``adam_update`` itself has none.

The rules take their scalars as floats or as 0-d tensors alike: the fused
step (``parallel/data_parallel.py``'s ``functional_optimizer``) calls the
same rules with the scalars of its ``_hyper`` row on the device.

Traps kept from the reference: ``Nadam``'s ``m_schedule`` lives on the
optimizer and every ``update`` call multiplies it, once per parameter and
not per step, and ``_k_nadam`` computes a first ``mbar`` the next line
overwrites; ``DCASGD``'s state is a copy of the previous weight (never a
view: the update writes the weight in place), and the rule keeps the old
weight as the new state; ``LAMB``'s state is float32 whatever the weight,
its bounds are ``lower_bound or 0`` and ``upper_bound or inf``, and its
norms (and ``LARS``'s) are float32 over the whole tensor; ``AdaGrad``'s
keyword is ``eps`` (stored as ``float_stable_eps``); ``Adamax``'s
denominator has a fixed 1e-8; ``LBSGD`` ignores its warm-up arguments;
``SGLD`` draws its noise from the port's generator of the weight's device
(``random.generator``), N(0, 1) scaled by sqrt(lr).

``lr_scheduler`` (reference :54-56, :91, :111-117): an ``LRScheduler``
(``mxnet_tpu_torch.lr_scheduler``) whose ``base_lr`` becomes the
optimizer's ``learning_rate``; the rate is then read through it at the
optimizer's ``num_update``, and ``set_learning_rate`` raises while it is
set. ``multi_precision=True`` (reference :129-147), for every class: a
float16 or bfloat16 weight gets a float32 master copy as the first part of
its state; the update runs on the master with the gradient cast to
float32, and the weight is the master cast back.

Memory: updates write the new weight and states into the existing tensors
in place, under ``torch.no_grad()``, so a ``Parameter``'s ``nn.Parameter``
keeps its identity and no second copy of the weights or states stays
alive. This is the counterpart of the reference's buffer donation
(``_UpdateKernel``, :229-273); with telemetry on, ``Updater`` books the
bytes each update writes in place (the weight and its states) into
``mx_donation_saved_bytes_total``, the reference's counter of donated
bytes (:255-262).

States: ``Updater.get_states``/``set_states`` serve ``kvstore`` and
``Trainer.save_states``/``load_states``; ``set_states`` also reads the
reference's bytes (``_StatesUnpickler``), and a pickled ``Optimizer``
carries no parameters (``__getstate__``, reference :71-79).

Waiting for later slices: the lazy row-sparse updates (ROADMAP A9) and
``aggregate_num``.
"""
from __future__ import annotations

import io
import pickle
import sys

from typing import Any, Dict

import numpy as np
import torch

from ..base import MXNetError
from .. import telemetry as _telem
from ..ndarray import NDArray
from ..ops import optimizer_ops as _oo

_OPT_REGISTRY: Dict[str, type] = {}


def register(cls):
    _OPT_REGISTRY[cls.__name__.lower()] = cls
    return cls


def create(name, **kwargs) -> "Optimizer":
    if isinstance(name, Optimizer):
        return name
    try:
        cls = _OPT_REGISTRY[name.lower()]
    except KeyError:
        raise MXNetError(f"unknown optimizer {name!r} (registered: "
                         f"{sorted(_OPT_REGISTRY)})") from None
    return cls(**kwargs)


def _f(x) -> float:
    """``x`` rounded to float32, as the reference's kernels receive it."""
    return float(np.float32(x))


class Optimizer:
    """Base optimizer (reference optimizer.py:45)."""

    def __init__(self, rescale_grad=1.0, param_idx2name=None, wd=0.0,
                 clip_gradient=None, learning_rate=0.01, lr_scheduler=None,
                 multi_precision=False, param_dict=None, begin_num_update=0,
                 aggregate_num=0, **kwargs):
        if kwargs:
            raise MXNetError(f"unknown optimizer arguments {sorted(kwargs)}")
        if lr_scheduler is not None and not callable(lr_scheduler):
            raise MXNetError(f"lr_scheduler must be an LRScheduler (called with "
                             f"num_update), got {type(lr_scheduler).__name__}")
        self.rescale_grad = rescale_grad
        self.lr = learning_rate
        self.lr_scheduler = lr_scheduler
        if lr_scheduler is not None:
            lr_scheduler.base_lr = learning_rate
        self.multi_precision = multi_precision
        self.wd = wd
        self.clip_gradient = clip_gradient
        self.param_idx2name = dict(param_idx2name or {})
        self.idx2name = self.param_idx2name
        self.param_dict = dict(param_dict or {})
        self.num_update = begin_num_update
        self.begin_num_update = begin_num_update
        self._index_update_count: Dict[Any, int] = {}
        self.lr_mult: Dict[str, float] = {}
        self.wd_mult: Dict[str, float] = {}

    # pickling (``Updater.get_states(dump_optimizer=True)``, reference
    # :71-79): the live Parameters (and their device tensors) are dropped;
    # unpickling starts from the class's defaults, so a state written by
    # the reference (whose attributes may differ) leaves none missing
    def __getstate__(self):
        st = dict(self.__dict__)
        st["param_dict"] = {}
        return st

    def __setstate__(self, st):
        try:
            self.__dict__.update(type(self)().__dict__)
        except TypeError:                  # a class with required arguments
            pass
        self.__dict__.update(st)

    # -- bookkeeping --------------------------------------------------------
    def _update_count(self, index):
        if not isinstance(index, (list, tuple)):
            index = [index]
        for i in index:
            self._index_update_count.setdefault(i, self.begin_num_update)
            self._index_update_count[i] += 1
            self.num_update = max(self._index_update_count[i], self.num_update)

    def _get_lr(self, index):
        lr = self.lr_scheduler(self.num_update) if self.lr_scheduler else self.lr
        if index in self.param_dict:
            lr *= self.param_dict[index].lr_mult
        elif index in self.lr_mult:
            lr *= self.lr_mult[index]
        elif index in self.idx2name:
            lr *= self.lr_mult.get(self.idx2name[index], 1.0)
        return lr

    def _get_wd(self, index):
        wd = self.wd
        if index in self.param_dict:
            wd *= self.param_dict[index].wd_mult
        elif index in self.wd_mult:
            wd *= self.wd_mult[index]
        elif index in self.idx2name:
            wd *= self.wd_mult.get(self.idx2name[index], 1.0)
        return wd

    def _clip_arg(self):
        return self.clip_gradient if self.clip_gradient is not None else -1.0

    def set_learning_rate(self, lr):
        if self.lr_scheduler is not None:
            raise MXNetError("lr_scheduler is set; use the scheduler to change lr")
        self.lr = lr

    @property
    def learning_rate(self):
        return self.lr_scheduler(self.num_update) if self.lr_scheduler else self.lr

    def set_lr_mult(self, args_lr_mult):
        self.lr_mult = dict(args_lr_mult)

    def set_wd_mult(self, args_wd_mult):
        self.wd_mult = dict(args_wd_mult)

    # -- state and update ---------------------------------------------------
    def create_state(self, index, weight):
        return None

    def _has_master(self, weight):
        return self.multi_precision and weight.dtype in (torch.float16, torch.bfloat16)

    def create_state_multi_precision(self, index, weight):
        if self._has_master(weight):
            master = NDArray(weight._data.detach().float(), weight.ctx)
            return (master, self.create_state(index, master))
        return self.create_state(index, weight)

    def update(self, index, weight, grad, state):
        raise NotImplementedError

    def update_multi_precision(self, index, weight, grad, state):
        if self._has_master(weight):
            master, base_state = state
            self.update(index, master, NDArray(grad._data.float(), grad.ctx),
                        base_state)
            _write([weight], [master._data])
        else:
            self.update(index, weight, grad, state)


class _StatesUnpickler(pickle.Unpickler):
    """Unpickles a states blob without importing the reference package or
    JAX: a class of ``mxnet_tpu.optimizer`` or ``mxnet_tpu.lr_scheduler``
    becomes the port's class of that name; any other global of
    ``mxnet_tpu`` or ``jax`` raises ``MXNetError`` naming it."""

    def find_class(self, module, name):
        root = module.split(".")[0]
        if root == "mxnet_tpu":
            if module.startswith("mxnet_tpu.optimizer") or module == "mxnet_tpu.lr_scheduler":
                from .. import lr_scheduler
                ours = sys.modules[__name__] if module.startswith("mxnet_tpu.optimizer") \
                    else lr_scheduler
                cls = getattr(ours, name, None)
                if isinstance(cls, type):
                    return cls
            raise MXNetError(f"optimizer states refer to {module}.{name}, which the "
                             f"port has no counterpart of (not imported)")
        if root in ("jax", "jaxlib"):
            raise MXNetError(f"optimizer states refer to {module}.{name} (JAX), "
                             f"which the port does not import")
        return super().find_class(module, name)


class Updater:
    """Holds the per-index states and applies an optimizer (reference
    optimizer.py:160)."""

    def __init__(self, optimizer: Optimizer):
        self.optimizer = optimizer
        self.states: Dict[Any, Any] = {}
        self._unplaced = set()

    def __call__(self, index, grad, weight):
        if not isinstance(index, (list, tuple)):
            index, grad, weight = [index], [grad], [weight]
        for i, g, w in zip(index, grad, weight):
            if i not in self.states:
                self.states[i] = self.optimizer.create_state_multi_precision(i, w)
            elif i in self._unplaced:
                self.states[i] = _to_ctx(self.states[i], w.ctx)
                self._unplaced.discard(i)
            self.optimizer.update_multi_precision(i, w, g, self.states[i])
            if _telem._ENABLED:
                _telem.counter("mx_donation_saved_bytes_total",
                               "Buffer bytes aliased in place by donated updates").inc(
                    _telem.payload_bytes([w, self.states[i]]))

    def get_states(self, dump_optimizer=False) -> bytes:
        """The states (and, with ``dump_optimizer``, the optimizer without
        its parameters) as bytes (reference optimizer.py:184): each state
        tensor as ``("nd", numpy array, dtype, device type, device id)``."""
        def conv(s):
            if isinstance(s, NDArray):
                return ("nd", s.asnumpy(), str(s.dtype).rpartition(".")[2],
                        s.ctx.device_type, s.ctx.device_id)
            if isinstance(s, (tuple, list)):
                return ("tuple", [conv(x) for x in s])
            return ("raw", s)
        blob = {"states": {k: conv(v) for k, v in self.states.items()}}
        if dump_optimizer:
            blob["optimizer"] = self.optimizer
        return pickle.dumps(blob)

    def set_states(self, states_blob: bytes):
        """Install states from ``get_states``' bytes, the port's or the
        reference's (whose entries ``("nd", array, dtype)`` name no device:
        such a state goes to the device of this index's weight, from the
        optimizer's ``param_dict`` or, failing that, at the index's next
        update). The blob is unpickled (``_StatesUnpickler``): load only
        bytes this program or the reference wrote. A dumped optimizer
        replaces this updater's."""
        from ..context import Context, cpu
        from ..ndarray import array
        blob = _StatesUnpickler(io.BytesIO(states_blob)).load()
        params = self.optimizer.param_dict
        self._unplaced = set()

        def unconv(s, k):
            if s[0] == "nd":
                if len(s) > 3:
                    ctx = Context(s[3], s[4])
                elif k in params:
                    ctx = params[k].list_ctx()[0]
                else:
                    ctx = cpu()
                    self._unplaced.add(k)
                return array(s[1], ctx=ctx, dtype=s[2])
            if s[0] == "tuple":
                return tuple(unconv(x, k) for x in s[1])
            return s[1]
        self.states = {k: unconv(v, k) for k, v in blob["states"].items()}
        if "optimizer" in blob:
            self.optimizer = blob["optimizer"]


def _to_ctx(state, ctx):
    if isinstance(state, NDArray):
        return state.as_in_context(ctx)
    if isinstance(state, tuple):
        return tuple(_to_ctx(x, ctx) for x in state)
    return state


def get_updater(optimizer: Optimizer) -> Updater:
    return Updater(optimizer)


def _write(targets, values):
    """Copy each new value into its tensor in place (no autograd)."""
    with torch.no_grad():
        for t, v in zip(targets, values):
            t._data.copy_(v)




# ---------------------------------------------------------------------------
# Update rules (reference :295-485). Scalars are float32-rounded floats or
# 0-d float32 tensors; each rule returns (new weight, *new states).
# ---------------------------------------------------------------------------

def _clip_pos(g, clip):
    """The ``_k_*`` rules' clip, on when ``clip > 0``."""
    if isinstance(clip, torch.Tensor):
        return torch.where(clip > 0, torch.clamp(g, -clip, clip), g)
    return torch.clamp(g, -clip, clip) if clip > 0 else g


def _norm(x):
    """The float32 2-norm of the whole tensor (reference ``_norm`` :456)."""
    return torch.linalg.vector_norm(x, dtype=torch.float32)


def _k_sgd(w, g, lr, wd, rescale, clip):
    return (_oo.sgd_update(w, g, lr, wd=wd, rescale_grad=rescale, clip_gradient=clip),)


def _k_sgd_mom(w, g, mom, lr, wd, rescale, clip, momentum):
    return _oo.sgd_mom_update(w, g, mom, lr, momentum=momentum, wd=wd,
                              rescale_grad=rescale, clip_gradient=clip)


def _k_nag(w, g, mom, lr, wd, rescale, clip, momentum):
    return _oo.nag_mom_update(w, g, mom, lr, momentum=momentum, wd=wd,
                              rescale_grad=rescale, clip_gradient=clip)


def _k_adamw(w, g, m, v, lr, eta, wd, rescale, clip, beta1, beta2, eps, coef1, coef2):
    g = _clip_pos(g * rescale, clip)
    m2 = beta1 * m + (1 - beta1) * g
    v2 = beta2 * v + (1 - beta2) * g * g
    mhat = m2 / coef1
    vhat = v2 / coef2
    return w - eta * (lr * mhat / (torch.sqrt(vhat) + eps) + wd * w), m2, v2


def _k_rmsprop(w, g, n, lr, wd, rescale, clip, rho, eps):
    return _oo.rmsprop_update(w, g, n, lr, rho=rho, epsilon=eps, wd=wd,
                              rescale_grad=rescale, clip_gradient=clip)


def _k_rmsprop_alex(w, g, n, gavg, delta, lr, wd, rescale, clip, rho, momentum, eps):
    return _oo.rmspropalex_update(w, g, n, gavg, delta, lr, rho=rho, momentum=momentum,
                                  epsilon=eps, wd=wd, rescale_grad=rescale,
                                  clip_gradient=clip)


def _k_adagrad(w, g, h, lr, wd, rescale, clip, eps):
    g = _clip_pos(g * rescale, clip) + wd * w
    h2 = h + g * g
    return w - lr * g / (torch.sqrt(h2) + eps), h2


def _k_adadelta(w, g, acc_g, acc_d, wd, rescale, clip, rho, eps):
    g = _clip_pos(g * rescale, clip) + wd * w
    acc_g2 = rho * acc_g + (1 - rho) * g * g
    d = torch.sqrt(acc_d + eps) / torch.sqrt(acc_g2 + eps) * g
    acc_d2 = rho * acc_d + (1 - rho) * d * d
    return w - d, acc_g2, acc_d2


def _k_ftrl(w, g, z, n, lr, wd, rescale, clip, lamda1, beta):
    return _oo.ftrl_update(w, g, z, n, lr, lamda1=lamda1, beta=beta, wd=wd,
                           rescale_grad=rescale, clip_gradient=clip)


def _k_adamax(w, g, m, u, lr, wd, rescale, clip, beta1, beta2, coef1):
    g = _clip_pos(g * rescale, clip) + wd * w
    m2 = beta1 * m + (1 - beta1) * g
    u2 = torch.maximum(beta2 * u, torch.abs(g))
    return w - (lr / coef1) * m2 / (u2 + 1e-8), m2, u2


def _k_nadam(w, g, m, v, lr, wd, rescale, clip, beta1, beta2, eps, mschedule, mnext,
             coef2):
    g = _clip_pos(g * rescale, clip) + wd * w
    ghat = g / (1 - mschedule)
    m2 = beta1 * m + (1 - beta1) * g
    v2 = beta2 * v + (1 - beta2) * g * g
    mhat = m2 / (1 - mschedule * mnext)
    vhat = v2 / coef2
    # the reference computes this mbar and overwrites it on the next line
    mbar = (1 - mnext / (1 - mschedule)) * ghat + (mnext / (1 - mschedule * mnext)) * m2
    mbar = (1.0 - mnext) * ghat + mnext * mhat
    return w - lr * mbar / (torch.sqrt(vhat) + eps), m2, v2


def _k_signum(w, g, mom, lr, wd, rescale, clip, momentum, wd_lh):
    return _oo.signum_update(w, g, mom, lr, momentum=momentum, wd=wd, rescale_grad=rescale,
                             clip_gradient=clip, wd_lh=wd_lh)


def _k_ftml(w, g, d, v, z, lr, wd, rescale, clip, beta1, beta2, eps, t):
    return _oo.ftml_update(w, g, d, v, z, lr, t, beta1=beta1, beta2=beta2, epsilon=eps,
                           wd=wd, rescale_grad=rescale, clip_grad=clip)


def _k_dcasgd(w, g, prev_w, lr, wd, rescale, clip, lamda):
    """-> (new weight, the old weight): the caller keeps a copy of ``w``."""
    g = _clip_pos(g * rescale, clip) + wd * w
    comp = lamda * g * g * (w - prev_w)
    return w - lr * (g + comp), w


def _k_sgld(w, g, noise, lr, wd, rescale, clip):
    g = _clip_pos(g * rescale, clip) + wd * w
    return (w - 0.5 * lr * g + lr ** 0.5 * noise,)


def _lars_norms(w, g, rescale, clip):
    """LARS's first pass: the clipped gradient and the float32 norms of the
    weight and of it."""
    g = _clip_pos(g * rescale, clip)
    return g, _norm(w), _norm(g)


def _lars_apply(w, g, mom, wn, gn, lr, wd, momentum, eta, eps):
    trust = torch.where((wn > 0) & (gn > 0), eta * wn / (gn + wd * wn + eps), 1.0)
    g = g + wd * w
    mom2 = momentum * mom + trust * lr * g
    return w - mom2, mom2


def _k_lars(w, g, mom, lr, wd, rescale, clip, momentum, eta, eps):
    """``trust = eta·‖w‖/(‖g‖ + wd·‖w‖ + eps)`` where both norms are > 0,
    else 1; wd joins g after the trust ratio; ``mom = momentum·mom +
    trust·lr·g``; ``w - mom``."""
    g, wn, gn = _lars_norms(w, g, rescale, clip)
    return _lars_apply(w, g, mom, wn, gn, lr, wd, momentum, eta, eps)


def _lamb_direction(w, g, m, v, wd, rescale, clip, beta1, beta2, eps, coef1, coef2):
    """LAMB's first pass: the direction r and the new moments (coef1 = coef2
    = 1 without bias correction: x/1 is x)."""
    g = _clip_pos(g * rescale, clip)
    m2 = beta1 * m + (1 - beta1) * g
    v2 = beta2 * v + (1 - beta2) * g * g
    mhat = m2 / coef1
    vhat = v2 / coef2
    return mhat / (torch.sqrt(vhat) + eps) + wd * w, m2, v2


def _lamb_apply(w, r, wn, rn, lr, lower, upper):
    trust = torch.where(rn > 0, torch.clamp(wn, lower, upper) / rn, 1.0)
    return w - lr * trust * r


def _k_lamb(w, g, m, v, lr, wd, rescale, clip, beta1, beta2, eps, coef1, coef2, lower,
            upper):
    """The trust ratio is ‖w‖ clipped to [lower, upper] over ‖r‖, or 1
    where ‖r‖ = 0, both float32 norms of the whole tensor."""
    r, m2, v2 = _lamb_direction(w, g, m, v, wd, rescale, clip, beta1, beta2, eps, coef1,
                                coef2)
    return _lamb_apply(w, r, _norm(w), _norm(r), lr, lower, upper), m2, v2


# ---------------------------------------------------------------------------
# Optimizer classes
# ---------------------------------------------------------------------------

def _zeros(weight, dtype=None):
    from ..ndarray import zeros
    return zeros(weight.shape, ctx=weight.ctx, dtype=dtype or weight.dtype)


class _RuleOptimizer(Optimizer):
    """An optimizer whose ``update`` is one ``_k_*`` rule over the weight,
    the gradient and its states (``_states``), with ``_args(index)`` the
    rule's scalars after them (counted first, so t is this update's)."""

    def _states(self, state):
        if state is None:
            return ()
        return tuple(state) if isinstance(state, (tuple, list)) else (state,)

    def _clip_f(self):
        return _f(self._clip_arg())

    def update(self, index, weight, grad, state):
        self._update_count(index)
        states = self._states(state)
        with torch.no_grad():
            new = self._rule(weight._data, grad._data, *(s._data for s in states),
                             *self._args(index))
        _write([weight, *states], new)


@register
class SGD(_RuleOptimizer):
    """SGD with optional momentum (reference optimizer.py:493)."""

    def __init__(self, momentum=0.0, lazy_update=True, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum
        self.lazy_update = lazy_update

    def create_state(self, index, weight):
        return _zeros(weight) if self.momentum != 0.0 else None

    def _rule(self, w, g, *state_and_args):
        if self.momentum == 0.0:
            return _k_sgd(w, g, *state_and_args)
        return _k_sgd_mom(w, g, *state_and_args, _f(self.momentum))

    def _args(self, index):
        return (_f(self._get_lr(index)), _f(self._get_wd(index)), _f(self.rescale_grad),
                self._clip_f())


@register
class ccSGD(SGD):
    """The deprecated name of SGD (reference :524); the module's ``ccSGD``
    is rebound to ``SGD`` at the end, as in the reference (:907)."""


@register
class NAG(_RuleOptimizer):
    """Nesterov momentum (``nag_mom_update``, reference :530)."""

    def __init__(self, momentum=0.0, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum

    def create_state(self, index, weight):
        return _zeros(weight)

    _rule = staticmethod(_k_nag)

    def _args(self, index):
        return (_f(self._get_lr(index)), _f(self._get_wd(index)), _f(self.rescale_grad),
                self._clip_f(), _f(self.momentum))


@register
class SGLD(_RuleOptimizer):
    """Stochastic gradient Langevin dynamics (reference :549): noise
    N(0, 1) from the port's generator of the weight's device."""

    def update(self, index, weight, grad, state):
        from ..random import generator
        self._update_count(index)
        with torch.no_grad():
            noise = torch.randn(weight.shape, generator=generator(weight.ctx),
                                device=weight._data.device,
                                dtype=torch.float32).to(weight.dtype)
            new = _k_sgld(weight._data, grad._data, noise, _f(self._get_lr(index)),
                          _f(self._get_wd(index)), _f(self.rescale_grad), self._clip_f())
        _write([weight], new)


@register
class Signum(_RuleOptimizer):
    """signSGD with momentum (``signum_update``, reference :564)."""

    def __init__(self, learning_rate=0.01, momentum=0.9, wd_lh=0.0, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.momentum = momentum
        self.wd_lh = wd_lh

    def create_state(self, index, weight):
        return _zeros(weight)

    _rule = staticmethod(_k_signum)

    def _args(self, index):
        return (_f(self._get_lr(index)), _f(self._get_wd(index)), _f(self.rescale_grad),
                self._clip_f(), _f(self.momentum), _f(self.wd_lh))


@register
class DCASGD(_RuleOptimizer):
    """Delay-compensated async SGD (reference :585). Its state is a copy of
    the previous weight, and the rule returns the old weight as the new
    state: the copy is taken before the weight is overwritten."""

    def __init__(self, momentum=0.0, lamda=0.04, **kwargs):
        super().__init__(**kwargs)
        self.lamda = lamda

    def create_state(self, index, weight):
        from ..ndarray import NDArray as _ND
        return _ND(weight._data.detach().clone(), weight.ctx)

    def update(self, index, weight, grad, state):
        self._update_count(index)
        with torch.no_grad():
            w2, _ = _k_dcasgd(weight._data, grad._data, state._data, _f(self._get_lr(index)),
                              _f(self._get_wd(index)), _f(self.rescale_grad), self._clip_f(),
                              _f(self.lamda))
        _write([state, weight], [weight._data, w2])     # the old weight first


@register
class FTML(_RuleOptimizer):
    """Follow the moving leader (``ftml_update``, reference :604)."""

    def __init__(self, beta1=0.6, beta2=0.999, epsilon=1e-8, **kwargs):
        super().__init__(**kwargs)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon

    def create_state(self, index, weight):
        return (_zeros(weight), _zeros(weight), _zeros(weight))

    _rule = staticmethod(_k_ftml)

    def _args(self, index):
        return (_f(self._get_lr(index)), _f(self._get_wd(index)), _f(self.rescale_grad),
                self._clip_f(), _f(self.beta1), _f(self.beta2), _f(self.epsilon),
                _f(self._index_update_count[index]))


@register
class LARS(_RuleOptimizer):
    """Layer-wise adaptive rate scaling (reference :628, ``_k_lars``)."""

    def __init__(self, momentum=0.0, eta=0.001, epsilon=1e-8, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum
        self.eta = eta
        self.epsilon = epsilon

    def create_state(self, index, weight):
        return _zeros(weight)

    _rule = staticmethod(_k_lars)

    def _args(self, index):
        return (_f(self._get_lr(index)), _f(self._get_wd(index)), _f(self.rescale_grad),
                self._clip_f(), _f(self.momentum), _f(self.eta), _f(self.epsilon))


@register
class LBSGD(SGD):
    """Large-batch SGD (reference :652): SGD's rule; the warm-up arguments
    are taken and ignored, as in the reference."""

    def __init__(self, warmup_strategy="linear", warmup_epochs=5, batch_scale=1,
                 updates_per_epoch=32, begin_epoch=0, num_epochs=60, **kwargs):
        super().__init__(**kwargs)


@register
class LAMB(_RuleOptimizer):
    """Layer-wise adaptive moments for large batches (reference :662,
    ``_k_lamb``): float32 state whatever the weight's dtype."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999, epsilon=1e-6,
                 lower_bound=None, upper_bound=None, bias_correction=True, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon
        self.lower_bound = lower_bound
        self.upper_bound = upper_bound
        self.bias_correction = bias_correction

    def create_state(self, index, weight):
        return (_zeros(weight, "float32"), _zeros(weight, "float32"))

    _rule = staticmethod(_k_lamb)

    def _bounds(self):
        return _f(self.lower_bound or 0.0), _f(self.upper_bound or np.inf)

    def _args(self, index):
        t = self._index_update_count[index]
        c1, c2 = (_f(1 - self.beta1 ** t), _f(1 - self.beta2 ** t)) \
            if self.bias_correction else (1.0, 1.0)
        return (_f(self._get_lr(index)), _f(self._get_wd(index)), _f(self.rescale_grad),
                self._clip_f(), _f(self.beta1), _f(self.beta2), _f(self.epsilon), c1, c2,
                *self._bounds())


@register
class Adam(_RuleOptimizer):
    """Adam with the bias correction folded into the learning rate
    (reference :694-719)."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, lazy_update=True, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon
        self.lazy_update = lazy_update

    def create_state(self, index, weight):
        return (_zeros(weight), _zeros(weight))

    def _rule(self, w, g, m, v, lr, wd, rescale, clip, coef1, coef2):
        lr_t = float(np.float32(lr) * np.sqrt(np.float32(coef2)) / np.float32(coef1))
        return _oo.adam_update(w, g, m, v, lr_t, beta1=_f(self.beta1), beta2=_f(self.beta2),
                               epsilon=_f(self.epsilon), wd=wd, rescale_grad=rescale,
                               clip_gradient=clip)

    def _args(self, index):
        t = self._index_update_count[index]
        return (_f(self._get_lr(index)), _f(self._get_wd(index)), _f(self.rescale_grad),
                self._clip_f(), _f(1 - self.beta1 ** t), _f(1 - self.beta2 ** t))


@register
class AdamW(Adam):
    """Adam with decoupled weight decay (reference :722):
    ``w - eta·(lr·m̂/(√v̂ + eps) + wd·w)``. A subclass of ``Adam``: every
    ``isinstance`` dispatch tests AdamW first."""

    def __init__(self, eta=1.0, **kwargs):
        super().__init__(**kwargs)
        self.eta = eta

    _rule = staticmethod(_k_adamw)

    def _args(self, index):
        t = self._index_update_count[index]
        return (_f(self._get_lr(index)), _f(self.eta), _f(self._get_wd(index)),
                _f(self.rescale_grad), self._clip_f(), _f(self.beta1), _f(self.beta2),
                _f(self.epsilon), _f(1 - self.beta1 ** t), _f(1 - self.beta2 ** t))


@register
class AdaGrad(_RuleOptimizer):
    """AdaGrad (reference :744); the keyword ``eps`` is stored as
    ``float_stable_eps``."""

    def __init__(self, eps=1e-7, **kwargs):
        super().__init__(**kwargs)
        self.float_stable_eps = eps

    def create_state(self, index, weight):
        return _zeros(weight)

    _rule = staticmethod(_k_adagrad)

    def _args(self, index):
        return (_f(self._get_lr(index)), _f(self._get_wd(index)), _f(self.rescale_grad),
                self._clip_f(), _f(self.float_stable_eps))


@register
class RMSProp(_RuleOptimizer):
    """RMSProp (reference :763): ``gamma1`` is rho; ``centered=True`` runs
    ``rmspropalex_update`` with ``gamma2`` as its momentum and a state of
    three."""

    def __init__(self, learning_rate=0.001, gamma1=0.9, gamma2=0.9, epsilon=1e-8,
                 centered=False, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.gamma1, self.gamma2, self.epsilon = gamma1, gamma2, epsilon
        self.centered = centered

    def create_state(self, index, weight):
        if self.centered:
            return (_zeros(weight), _zeros(weight), _zeros(weight))
        return _zeros(weight)

    def _rule(self, w, g, *state_and_args):
        return (_k_rmsprop_alex if self.centered else _k_rmsprop)(w, g, *state_and_args)

    def _args(self, index):
        head = (_f(self._get_lr(index)), _f(self._get_wd(index)), _f(self.rescale_grad),
                self._clip_f(), _f(self.gamma1))
        if self.centered:
            return head + (_f(self.gamma2), _f(self.epsilon))
        return head + (_f(self.epsilon),)


@register
class AdaDelta(_RuleOptimizer):
    """AdaDelta (reference :797): no learning rate."""

    def __init__(self, rho=0.9, epsilon=1e-5, **kwargs):
        super().__init__(**kwargs)
        self.rho, self.epsilon = rho, epsilon

    def create_state(self, index, weight):
        return (_zeros(weight), _zeros(weight))

    _rule = staticmethod(_k_adadelta)

    def _args(self, index):
        return (_f(self._get_wd(index)), _f(self.rescale_grad), self._clip_f(),
                _f(self.rho), _f(self.epsilon))


@register
class Ftrl(_RuleOptimizer):
    """FTRL-proximal (``ftrl_update``, reference :818)."""

    def __init__(self, lamda1=0.01, learning_rate=0.1, beta=1.0, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.lamda1, self.beta = lamda1, beta

    def create_state(self, index, weight):
        return (_zeros(weight), _zeros(weight))

    _rule = staticmethod(_k_ftrl)

    def _args(self, index):
        return (_f(self._get_lr(index)), _f(self._get_wd(index)), _f(self.rescale_grad),
                self._clip_f(), _f(self.lamda1), _f(self.beta))


@register
class Adamax(_RuleOptimizer):
    """Adamax (reference :839)."""

    def __init__(self, learning_rate=0.002, beta1=0.9, beta2=0.999, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2 = beta1, beta2

    def create_state(self, index, weight):
        return (_zeros(weight), _zeros(weight))

    _rule = staticmethod(_k_adamax)

    def _args(self, index):
        t = self._index_update_count[index]
        return (_f(self._get_lr(index)), _f(self._get_wd(index)), _f(self.rescale_grad),
                self._clip_f(), _f(self.beta1), _f(self.beta2), _f(1 - self.beta1 ** t))


@register
class Nadam(_RuleOptimizer):
    """Nesterov Adam (reference :862). ``m_schedule`` is the optimizer's
    own: every ``update`` call multiplies it by this call's momentum, so a
    net of N parameters multiplies it N times a step."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999, epsilon=1e-8,
                 schedule_decay=0.004, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon
        self.schedule_decay = schedule_decay
        self.m_schedule = 1.0

    def create_state(self, index, weight):
        return (_zeros(weight), _zeros(weight))

    _rule = staticmethod(_k_nadam)

    def _args(self, index):
        t = self._index_update_count[index]
        momentum_t = self.beta1 * (1.0 - 0.5 * 0.96 ** (t * self.schedule_decay))
        momentum_t1 = self.beta1 * (1.0 - 0.5 * 0.96 ** ((t + 1) * self.schedule_decay))
        self.m_schedule = self.m_schedule * momentum_t
        return (_f(self._get_lr(index)), _f(self._get_wd(index)), _f(self.rescale_grad),
                self._clip_f(), _f(self.beta1), _f(self.beta2), _f(self.epsilon),
                _f(self.m_schedule), _f(momentum_t1), _f(1 - self.beta2 ** t))


@register
class Test(_RuleOptimizer):
    """The reference's test optimizer (:892): w -= lr·g (no clip), with a
    state buffer that the update leaves as it is."""

    def create_state(self, index, weight):
        return _zeros(weight)

    def update(self, index, weight, grad, state):
        self._update_count(index)
        with torch.no_grad():
            new = _k_sgd(weight._data, grad._data, _f(self._get_lr(index)),
                         _f(self._get_wd(index)), _f(self.rescale_grad), _f(-1.0))
        _write([weight], new)


ccSGD = SGD
