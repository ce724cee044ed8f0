"""Optimizers: the base class, ``Updater``, ``SGD`` and ``Adam``.

Counterpart of ``mxnet_tpu/optimizer/optimizer.py:27-215`` (``Optimizer``,
``Updater``, ``create``/``register``), ``SGD`` (:493) and ``Adam``
(:695-719). Each update calls the registered op's function from
``ops/optimizer_ops.py`` with the hyper-parameters rounded to float32, as
the reference's jitted kernels take them (``_k_sgd``, ``_k_sgd_mom``,
``_k_adam``, :295-347); ``Adam`` folds the bias correction into the
learning rate, ``lr * sqrt(1 - beta2**t) / (1 - beta1**t)``, exactly as
``_k_adam`` does, and ``adam_update`` itself has none.

``lr_scheduler`` (reference :54-56, :91, :111-117): an ``LRScheduler``
(``mxnet_tpu_torch.lr_scheduler``) whose ``base_lr`` becomes the
optimizer's ``learning_rate``; the rate is then read through it at the
optimizer's ``num_update``, and ``set_learning_rate`` raises while it is
set. ``multi_precision=True`` (reference :129-147): a float16 or bfloat16
weight gets a float32 master copy as the first part of its state; the
update runs on the master with the gradient cast to float32, and the
weight is the master cast back.

Memory: updates write the new weight and states into the existing tensors
in place, under ``torch.no_grad()``, so a ``Parameter``'s ``nn.Parameter``
keeps its identity and no second copy of the weights or states stays
alive. This is the counterpart of the reference's buffer donation
(``_UpdateKernel``, :229-273).

Waiting for later slices: the lazy row-sparse updates, ``aggregate_num``
and the other optimizers; ``Updater.get_states`` / ``set_states`` come with
``Trainer.save_states``.
"""
from __future__ import annotations

import pickle

from typing import Any, Dict

import numpy as np
import torch

from ..base import MXNetError
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
        raise MXNetError(f"unknown optimizer {name!r} (ported: "
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


class Updater:
    """Holds the per-index states and applies an optimizer (reference
    optimizer.py:160)."""

    def __init__(self, optimizer: Optimizer):
        self.optimizer = optimizer
        self.states: Dict[Any, Any] = {}

    def __call__(self, index, grad, weight):
        if not isinstance(index, (list, tuple)):
            index, grad, weight = [index], [grad], [weight]
        for i, g, w in zip(index, grad, weight):
            if i not in self.states:
                self.states[i] = self.optimizer.create_state_multi_precision(i, w)
            self.optimizer.update_multi_precision(i, w, g, self.states[i])

    def get_states(self, dump_optimizer=False) -> bytes:
        """The states (and, with ``dump_optimizer``, the optimizer) as bytes
        (reference optimizer.py:184): each state tensor as a numpy array with
        its device."""
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
        """Install states from ``get_states``' bytes. They are unpickled:
        load only bytes this program wrote."""
        from ..context import Context
        from ..ndarray import array
        blob = pickle.loads(states_blob)

        def unconv(s):
            if s[0] == "nd":
                return array(s[1], ctx=Context(s[3], s[4]), dtype=s[2])
            if s[0] == "tuple":
                return tuple(unconv(x) for x in s[1])
            return s[1]
        self.states = {k: unconv(v) for k, v in blob["states"].items()}
        if "optimizer" in blob:
            self.optimizer = blob["optimizer"]


def get_updater(optimizer: Optimizer) -> Updater:
    return Updater(optimizer)


def _write(targets, values):
    """Copy each new value into its tensor in place (no autograd)."""
    with torch.no_grad():
        for t, v in zip(targets, values):
            t._data.copy_(v)


@register
class SGD(Optimizer):
    """SGD with optional momentum (reference optimizer.py:493)."""

    def __init__(self, momentum=0.0, lazy_update=True, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum
        self.lazy_update = lazy_update

    def create_state(self, index, weight):
        if self.momentum != 0.0:
            from ..ndarray import zeros
            return zeros(weight.shape, ctx=weight.ctx, dtype=weight.dtype)
        return None

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr, wd = _f(self._get_lr(index)), _f(self._get_wd(index))
        args = dict(wd=wd, rescale_grad=_f(self.rescale_grad),
                    clip_gradient=_f(self._clip_arg()))
        with torch.no_grad():
            if self.momentum == 0.0:
                new = (_oo.sgd_update(weight._data, grad._data, lr, **args),)
                _write([weight], new)
            else:
                new = _oo.sgd_mom_update(weight._data, grad._data, state._data,
                                         lr, momentum=_f(self.momentum), **args)
                _write([weight, state], new)


@register
class Adam(Optimizer):
    """Adam with the bias correction folded into the learning rate
    (reference optimizer.py:695-719)."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, lazy_update=True, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon
        self.lazy_update = lazy_update

    def create_state(self, index, weight):
        from ..ndarray import zeros
        return (zeros(weight.shape, ctx=weight.ctx, dtype=weight.dtype),
                zeros(weight.shape, ctx=weight.ctx, dtype=weight.dtype))

    def update(self, index, weight, grad, state):
        self._update_count(index)
        t = self._index_update_count[index]
        coef1 = np.float32(1 - self.beta1 ** t)
        coef2 = np.float32(1 - self.beta2 ** t)
        lr_t = float(np.float32(self._get_lr(index)) * np.sqrt(coef2) / coef1)
        m, v = state
        with torch.no_grad():
            new = _oo.adam_update(
                weight._data, grad._data, m._data, v._data, lr_t,
                beta1=_f(self.beta1), beta2=_f(self.beta2),
                epsilon=_f(self.epsilon), wd=_f(self._get_wd(index)),
                rescale_grad=_f(self.rescale_grad),
                clip_gradient=_f(self._clip_arg()))
        _write([weight, m, v], new)
