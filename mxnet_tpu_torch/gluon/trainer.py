"""gluon.Trainer on one device.

Counterpart of ``mxnet_tpu/gluon/trainer.py:23-211``: applies an optimizer
(``optimizer.create(name, **optimizer_params)`` or an ``Optimizer``) to a
list of ``Parameter``s. ``step(batch_size)`` sets ``rescale_grad = scale /
batch_size`` (:114), reduces the gradients (``allreduce_grads``) and runs the
``Updater`` on every parameter whose ``grad_req`` is not ``"null"``, in
order; the updates write into the weights in place.

One device only, for now: ``kvstore`` ``"device"``, ``"local"`` or ``None``
means no store, since one device's reduction is the identity. Any other
kvstore, or parameters on more than one device, raises ``MXNetError``; the
kvstore comes with the data-parallel slice. ``save_states``/``load_states``
wait for a later slice and raise.
"""
from __future__ import annotations

from typing import List

from ..base import MXNetError
from .. import optimizer as opt_mod
from .parameter import Parameter, ParameterDict

_ONE_DEVICE_KVSTORES = ("device", "local", None)


class Trainer:
    def __init__(self, params, optimizer, optimizer_params=None,
                 kvstore="device", compression_params=None,
                 update_on_kvstore=None):
        if isinstance(params, (dict, ParameterDict)):
            params = list(params.values())
        if not isinstance(params, (list, tuple)):
            raise MXNetError("params must be a ParameterDict/dict/list of Parameter")
        if kvstore not in _ONE_DEVICE_KVSTORES or update_on_kvstore \
                or compression_params:
            raise MXNetError(f"kvstore {kvstore!r} (update_on_kvstore="
                             f"{update_on_kvstore}, compression "
                             f"{compression_params}): only one device without "
                             f"a store is ported; the kvstore comes with the "
                             f"data-parallel slice")
        self._params: List[Parameter] = []
        for p in params:
            if not isinstance(p, Parameter):
                raise MXNetError(f"invalid parameter {p!r}")
            self._params.append(p)
        optimizer_params = dict(optimizer_params or {})
        self._scale = float(optimizer_params.get("rescale_grad", 1.0))
        param_dict = dict(enumerate(self._params))
        if isinstance(optimizer, opt_mod.Optimizer):
            if set(optimizer_params) - {"rescale_grad"}:
                raise MXNetError("optimizer_params must be None when optimizer "
                                 "is an Optimizer instance")
            self._optimizer = optimizer
            self._optimizer.param_dict = param_dict
        else:
            self._optimizer = opt_mod.create(optimizer, param_dict=param_dict,
                                             **optimizer_params)
        self._updater = opt_mod.get_updater(self._optimizer)
        self._checked = False

    @property
    def learning_rate(self):
        return self._optimizer.learning_rate

    @property
    def optimizer(self):
        return self._optimizer

    def set_learning_rate(self, lr):
        self._optimizer.set_learning_rate(lr)

    def _check_one_device(self):
        if self._checked:
            return
        devices = {p.list_ctx()[0] for p in self._params}
        if len(devices) > 1:
            raise MXNetError(f"parameters on {len(devices)} devices "
                             f"({sorted(map(str, devices))}): one device only "
                             f"until the data-parallel slice")
        self._checked = True

    def step(self, batch_size, ignore_stale_grad=False):
        """Rescale gradients by ``1 / batch_size``, reduce them and update
        (reference trainer.py:106)."""
        self._optimizer.rescale_grad = self._scale / batch_size
        self.allreduce_grads()
        self._update()

    def allreduce_grads(self):
        """The identity on one device (no store)."""
        self._check_one_device()

    def update(self, batch_size, ignore_stale_grad=False):
        self._check_one_device()
        self._optimizer.rescale_grad = self._scale / batch_size
        self._update()

    def _update(self):
        for i, p in enumerate(self._params):
            if p.grad_req != "null":
                self._updater(i, p.grad(), p.data())

    def zero_grad(self):
        for p in self._params:
            p.zero_grad()

    def save_states(self, fname):
        raise MXNetError("Trainer.save_states is not ported yet")

    def load_states(self, fname):
        raise MXNetError("Trainer.load_states is not ported yet")
