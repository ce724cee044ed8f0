"""gluon.Trainer, with or without a kvstore.

Counterpart of ``mxnet_tpu/gluon/trainer.py:23-211``: applies an optimizer
(``optimizer.create(name, **optimizer_params)`` or an ``Optimizer``) to a
list of ``Parameter``s. ``step(batch_size)`` sets ``rescale_grad = scale /
batch_size`` (:114), reduces the gradients (``allreduce_grads``) and runs the
``Updater`` on every parameter whose ``grad_req`` is not ``"null"``, in
order; the updates write into the weights in place.

The kvstore (``kvstore``: a name for ``kvstore.create``, a ``KVStore``, or
None for none) is made at the first ``step``, ``update`` or
``allreduce_grads`` (``_init_kvstore``, :66): every trainable parameter's
value is its key's initial value (rank 0's, under ``dist_sync``), and
``update_on_kvstore`` defaults to true for the ``dist*`` stores, as in the
reference. Then:

- with the update on the store, ``step`` pushes each gradient and pulls the
  weight the store's updater made (``pushpull(i, grad, out=weight)``);
- otherwise ``allreduce_grads`` reduces the gradients in place through the
  store: for ``dist*`` stores one ``pushpull`` per bucket of
  ``MXNET_TPU_BUCKET_BYTES``, the buckets in reverse declaration order (the
  order the backward finishes them); an in-process store's reduction of one
  value a key is the identity, so nothing is pushed to it (the reference
  pushes each gradient, which changes nothing the trainer reads); and the
  optimizer runs here.

``compression_params`` go to the store's ``set_gradient_compression`` when
it is made (a dist store; the in-process stores raise), as in the reference
(:71). An unknown store name raises at construction; parameters on more
than one device raise at the first step. ``save_states``/``load_states``
wait for a later slice and raise.
"""
from __future__ import annotations

from typing import List

from ..base import MXNetError, env
from .. import optimizer as opt_mod
from .. import kvstore as kvs_mod
from .. import _dist_util
from .parameter import Parameter, ParameterDict


class Trainer:
    def __init__(self, params, optimizer, optimizer_params=None,
                 kvstore="device", compression_params=None,
                 update_on_kvstore=None):
        if isinstance(params, (dict, ParameterDict)):
            params = list(params.values())
        if not isinstance(params, (list, tuple)):
            raise MXNetError("params must be a ParameterDict/dict/list of Parameter")
        self._compression_params = compression_params
        if isinstance(kvstore, str):
            kvs_mod.kvstore.check_type(kvstore)
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
        self._kvstore_arg = kvstore
        self._kvstore = None
        self._update_on_kvstore = update_on_kvstore
        self._kv_initialized = False

    @property
    def learning_rate(self):
        return self._optimizer.learning_rate

    @property
    def optimizer(self):
        return self._optimizer

    def set_learning_rate(self, lr):
        self._optimizer.set_learning_rate(lr)

    def _init_kvstore(self):
        """The store and its keys (reference :66)."""
        devices = {p.list_ctx()[0] for p in self._params}
        if len(devices) > 1:
            raise MXNetError(f"parameters on {len(devices)} devices "
                             f"({sorted(map(str, devices))}): one device per "
                             f"process, a rank a device")
        arg = self._kvstore_arg
        kv = kvs_mod.create(arg) if isinstance(arg, str) else arg
        self._kvstore = kv
        on_kv = False
        if kv is not None:
            if self._compression_params:
                kv.set_gradient_compression(self._compression_params)
            on_kv = self._update_on_kvstore
            if on_kv is None:
                on_kv = kv.type.startswith("dist")
            for i, p in enumerate(self._params):
                if p.grad_req != "null":
                    kv.init(i, p.data())
            if on_kv:
                kv.set_optimizer(self._optimizer)
        self._update_on_kvstore_flag = bool(on_kv)
        self._kv_initialized = True

    def step(self, batch_size, ignore_stale_grad=False):
        """Rescale gradients by ``1 / batch_size``, reduce them and update
        (reference trainer.py:106)."""
        if not self._kv_initialized:
            self._init_kvstore()
        self._optimizer.rescale_grad = self._scale / batch_size
        self._allreduce_grads()
        self._update()

    def allreduce_grads(self):
        """Reduce the gradients in place through the store (none: identity)."""
        if not self._kv_initialized:
            self._init_kvstore()
        self._allreduce_grads()

    def _allreduce_grads(self):
        kv = self._kvstore
        if kv is None:
            return
        live = [(i, p) for i, p in enumerate(self._params) if p.grad_req != "null"]
        if self._update_on_kvstore_flag:
            for i, p in live:
                kv.pushpull(i, p.grad(), out=p.data())
            return
        if not kv.type.startswith("dist"):
            return      # one process, one value a key: the reduction is the identity
        grad_of = {i: p.grad() for i, p in live}
        sizes = [(i, grad_of[i].size * 4) for i, _ in live]
        buckets = _dist_util.plan_buckets(sizes, int(env.get("MXNET_TPU_BUCKET_BYTES")))
        for keys in sorted(buckets, key=lambda b: -max(b)):
            grads = [grad_of[i] for i in keys]
            kv.pushpull(keys, grads, out=grads)

    def update(self, batch_size, ignore_stale_grad=False):
        if not self._kv_initialized:
            self._init_kvstore()
        if self._update_on_kvstore_flag:
            raise MXNetError("update() applies the optimizer here; this trainer "
                             "updates on the kvstore (update_on_kvstore)")
        self._optimizer.rescale_grad = self._scale / batch_size
        self._update()

    def _update(self):
        if self._update_on_kvstore_flag:
            return          # the store's updater made the weights in pushpull
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
