"""Evaluation metrics.

Counterpart of ``mxnet_tpu/metric.py``: ``EvalMetric`` and
``CompositeEvalMetric``; ``Accuracy``, ``TopKAccuracy``, ``F1``, ``MAE``,
``MSE``, ``RMSE``, ``CrossEntropy``, ``NegativeLogLikelihood``,
``Perplexity``, ``PearsonCorrelation``, ``MCC``, ``PCC``, ``Loss`` and
``CustomMetric``; ``np`` (a custom metric from a numpy function),
``register`` and ``create`` (by name, a list, a callable or a metric).

``update(labels, preds)`` takes the port's ``NDArray``s, ``torch``
tensors or numpy arrays, one or a list of each. Where both sides of a pair
are device arrays (``NDArray`` or tensor), ``Accuracy``, ``TopKAccuracy``,
``MAE``, ``MSE``, ``CrossEntropy`` and ``Loss`` reduce them on their device
and keep ``sum_metric`` as a device scalar that later batches add to
without waiting for the card; ``get()`` is the one point where the host
waits (``float``). The others read numpy on the host, as the reference's
do.
"""
from __future__ import annotations

import math

import numpy as _np
import torch

from .base import MXNetError

_METRIC_REGISTRY = {}


def register(*names):
    def deco(cls):
        for n in names or (cls.__name__.lower(),):
            _METRIC_REGISTRY[n.lower()] = cls
        return cls
    return deco


def _raw(x):
    if isinstance(x, torch.Tensor):
        return x.detach()
    data = getattr(x, "_data", None)
    return data.detach() if isinstance(data, torch.Tensor) else None


def _as_numpy(x):
    raw = _raw(x)
    if raw is not None:
        return (raw.float() if raw.dtype == torch.bfloat16 else raw).cpu().numpy()
    return _np.asarray(x)


def _raw_pair(label, pred):
    """The device tensors of ``label`` and ``pred`` when both are arrays of
    the port (or tensors): the path that does not wait for the device; None
    falls back to numpy."""
    lr, pr = _raw(label), _raw(pred)
    if lr is None or pr is None:
        return None
    return lr, pr


def _host(v):
    """The designed device->host sync point (get()/get_global() only)."""
    return float(v)


def _pairs(labels, preds):
    if not isinstance(labels, (list, tuple)):
        labels = [labels]
    if not isinstance(preds, (list, tuple)):
        preds = [preds]
    check_label_shapes(labels, preds)
    return zip(labels, preds)


def check_label_shapes(labels, preds, shape=False):
    if len(labels) != len(preds):
        raise MXNetError(f"label/pred count mismatch: {len(labels)} vs {len(preds)}")


class EvalMetric:
    def __init__(self, name, output_names=None, label_names=None, **kwargs):
        self.name = str(name)
        self.output_names = output_names
        self.label_names = label_names
        self._kwargs = kwargs
        self.reset()

    def reset(self):
        self.num_inst = 0
        self.sum_metric = 0.0
        self.global_num_inst = 0
        self.global_sum_metric = 0.0

    def reset_local(self):
        self.num_inst = 0
        self.sum_metric = 0.0

    def update(self, labels, preds):
        raise NotImplementedError

    def update_dict(self, label, pred):
        if self.output_names is not None:
            pred = [pred[n] for n in self.output_names]
        else:
            pred = list(pred.values())
        if self.label_names is not None:
            label = [label[n] for n in self.label_names]
        else:
            label = list(label.values())
        self.update(label, pred)

    def get(self):
        if self.num_inst == 0:
            return (self.name, float("nan"))
        return (self.name, _host(self.sum_metric) / self.num_inst)

    def get_global(self):
        if self.global_num_inst == 0:
            return (self.name, float("nan"))
        return (self.name, _host(self.global_sum_metric) / self.global_num_inst)

    def get_name_value(self):
        name, value = self.get()
        if not isinstance(name, list):
            name, value = [name], [value]
        return list(zip(name, value))

    def _update(self, metric, inst):
        self.sum_metric += metric
        self.num_inst += inst
        self.global_sum_metric += metric
        self.global_num_inst += inst

    def __str__(self):
        return f"EvalMetric: {dict(self.get_name_value())}"


class CompositeEvalMetric(EvalMetric):
    def __init__(self, metrics=None, name="composite", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)
        self.metrics = [create(m) if isinstance(m, str) else m for m in (metrics or [])]

    def add(self, metric):
        self.metrics.append(create(metric) if isinstance(metric, str) else metric)

    def update(self, labels, preds):
        for m in self.metrics:
            m.update(labels, preds)

    def reset(self):
        for m in getattr(self, "metrics", []):
            m.reset()

    def get(self):
        names, values = [], []
        for m in self.metrics:
            n, v = m.get()
            names.append(n)
            values.append(v)
        return (names, values)


@register("accuracy", "acc")
class Accuracy(EvalMetric):
    def __init__(self, axis=1, name="accuracy", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)
        self.axis = axis

    def update(self, labels, preds):
        for label, pred in _pairs(labels, preds):
            raw = _raw_pair(label, pred)
            if raw is not None:
                l, p = raw
                if p.ndim > l.ndim:
                    p = torch.argmax(p, dim=self.axis)
                p = p.to(torch.int32).reshape(-1)
                l = l.to(torch.int32).reshape(-1)
                self._update((p == l).sum(), int(l.shape[0]))
                continue
            p = _as_numpy(pred)
            l = _as_numpy(label).astype("int64")
            if p.ndim > l.ndim:
                p = _np.argmax(p, axis=self.axis)
            p = p.astype("int64").reshape(-1)
            l = l.reshape(-1)
            self._update(_np.float64((p == l).sum()), len(l))


@register("top_k_accuracy", "topkaccuracy")
class TopKAccuracy(EvalMetric):
    def __init__(self, top_k=1, name="top_k_accuracy", output_names=None, label_names=None):
        super().__init__(f"{name}_{top_k}", output_names, label_names)
        self.top_k = top_k

    def update(self, labels, preds):
        for label, pred in _pairs(labels, preds):
            raw = _raw_pair(label, pred)
            if raw is not None:
                l, p = raw
                l = l.to(torch.int64).reshape(-1)
                topk = torch.argsort(p, dim=-1, stable=True)[:, -self.top_k:]
                hit = (topk == l[:, None]).any(dim=1).sum()
                self._update(hit, int(l.shape[0]))
                continue
            p = _as_numpy(pred)
            l = _as_numpy(label).astype("int64").reshape(-1)
            topk = _np.argsort(p, axis=-1)[:, -self.top_k:]
            hit = (topk == l[:, None]).any(axis=1).sum()
            self._update(_np.float64(hit), len(l))


@register("f1")
class F1(EvalMetric):
    def __init__(self, name="f1", average="macro", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)
        self.average = average
        self._tp = self._fp = self._fn = 0.0

    def reset(self):
        super().reset()
        self._tp = self._fp = self._fn = 0.0

    def update(self, labels, preds):
        for label, pred in _pairs(labels, preds):
            p = _as_numpy(pred)
            l = _as_numpy(label).reshape(-1).astype("int64")
            ph = (p[:, 1] > 0.5).astype("int64") if p.ndim == 2 \
                else (p > 0.5).astype("int64").reshape(-1)
            self._tp += float(((ph == 1) & (l == 1)).sum())
            self._fp += float(((ph == 1) & (l == 0)).sum())
            self._fn += float(((ph == 0) & (l == 1)).sum())
            prec = self._tp / max(self._tp + self._fp, 1e-12)
            rec = self._tp / max(self._tp + self._fn, 1e-12)
            f1 = 2 * prec * rec / max(prec + rec, 1e-12)
            self.sum_metric = self.global_sum_metric = f1
            self.num_inst = self.global_num_inst = 1


@register("mae")
class MAE(EvalMetric):
    def __init__(self, name="mae", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)

    def update(self, labels, preds):
        for label, pred in _pairs(labels, preds):
            raw = _raw_pair(label, pred)
            if raw is not None:
                l, p = raw
                self._update(torch.abs(l.reshape(p.shape) - p).mean() * l.shape[0],
                             int(l.shape[0]))
                continue
            l, p = _as_numpy(label), _as_numpy(pred)
            self._update(_np.abs(l.reshape(p.shape) - p).mean() * l.shape[0], l.shape[0])


@register("mse")
class MSE(EvalMetric):
    def __init__(self, name="mse", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)

    def update(self, labels, preds):
        for label, pred in _pairs(labels, preds):
            raw = _raw_pair(label, pred)
            if raw is not None:
                l, p = raw
                self._update(((l.reshape(p.shape) - p) ** 2).mean() * l.shape[0],
                             int(l.shape[0]))
                continue
            l, p = _as_numpy(label), _as_numpy(pred)
            self._update(((l.reshape(p.shape) - p) ** 2).mean() * l.shape[0], l.shape[0])


@register("rmse")
class RMSE(MSE):
    def __init__(self, name="rmse", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)

    def get(self):
        if self.num_inst == 0:
            return (self.name, float("nan"))
        return (self.name, math.sqrt(_host(self.sum_metric) / self.num_inst))


@register("cross-entropy", "ce")
class CrossEntropy(EvalMetric):
    def __init__(self, eps=1e-12, name="cross-entropy", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)
        self.eps = eps

    def update(self, labels, preds):
        for label, pred in _pairs(labels, preds):
            raw = _raw_pair(label, pred)
            if raw is not None:
                l, p = raw
                l = l.to(torch.int64).reshape(-1)
                prob = p[torch.arange(l.shape[0], device=p.device), l]
                self._update(-torch.log(prob + self.eps).sum(), int(l.shape[0]))
                continue
            l = _as_numpy(label).astype("int64").reshape(-1)
            p = _as_numpy(pred)
            prob = p[_np.arange(l.shape[0]), l]
            self._update(-_np.log(prob + self.eps).sum(), l.shape[0])


@register("nll_loss")
class NegativeLogLikelihood(CrossEntropy):
    def __init__(self, eps=1e-12, name="nll-loss", output_names=None, label_names=None):
        super().__init__(eps, name, output_names, label_names)


@register("perplexity")
class Perplexity(CrossEntropy):
    def __init__(self, ignore_label=None, axis=-1, name="perplexity",
                 output_names=None, label_names=None):
        super().__init__(name=name, output_names=output_names, label_names=label_names)
        self.ignore_label = ignore_label

    def update(self, labels, preds):
        for label, pred in _pairs(labels, preds):
            l = _as_numpy(label).astype("int64").reshape(-1)
            p = _as_numpy(pred).reshape(l.shape[0], -1)
            prob = p[_np.arange(l.shape[0]), l]
            if self.ignore_label is not None:
                prob = prob[l != self.ignore_label]
            self._update(float(-_np.log(prob + self.eps).sum()), int(prob.shape[0]))

    def get(self):
        if self.num_inst == 0:
            return (self.name, float("nan"))
        return (self.name, math.exp(self.sum_metric / self.num_inst))


@register("pearsonr")
class PearsonCorrelation(EvalMetric):
    def __init__(self, name="pearsonr", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)

    def update(self, labels, preds):
        for label, pred in _pairs(labels, preds):
            l = _as_numpy(label).reshape(-1)
            p = _as_numpy(pred).reshape(-1)
            self._update(float(_np.corrcoef(l, p)[0, 1]), 1)


def _hard(p):
    """Class predictions: argmax over the last axis, or p > 0.5 for scores."""
    return _np.argmax(p, axis=-1).reshape(-1) if p.ndim > 1 \
        else (p > 0.5).astype("int64").reshape(-1)


@register("mcc")
class MCC(EvalMetric):
    def __init__(self, name="mcc", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)
        self._counts = _np.zeros(4)

    def reset(self):
        super().reset()
        self._counts = _np.zeros(4)

    def update(self, labels, preds):
        for label, pred in _pairs(labels, preds):
            l = _as_numpy(label).astype("int64").reshape(-1)
            ph = _hard(_as_numpy(pred))
            self._counts += [float(((ph == 1) & (l == 1)).sum()),
                             float(((ph == 1) & (l == 0)).sum()),
                             float(((ph == 0) & (l == 1)).sum()),
                             float(((ph == 0) & (l == 0)).sum())]
            tp, fp, fn, tn = self._counts
            denom = math.sqrt(max((tp + fp) * (tp + fn) * (tn + fp) * (tn + fn), 1e-12))
            self.sum_metric = self.global_sum_metric = (tp * tn - fp * fn) / denom
            self.num_inst = self.global_num_inst = 1


@register("pcc")
class PCC(EvalMetric):
    """Multiclass MCC from a growing KxK confusion matrix (the discrete
    Pearson correlation, R_K; for two classes it equals MCC)."""

    def __init__(self, name="pcc", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)
        self._cm = _np.zeros((2, 2))

    def reset(self):
        super().reset()
        self._cm = _np.zeros((2, 2))

    def _grow(self, k):
        if k > self._cm.shape[0]:
            cm = _np.zeros((k, k))
            cm[:self._cm.shape[0], :self._cm.shape[1]] = self._cm
            self._cm = cm

    def update(self, labels, preds):
        for label, pred in _pairs(labels, preds):
            l = _as_numpy(label).astype("int64").reshape(-1)
            ph = _hard(_as_numpy(pred))
            self._grow(max(int(l.max()), int(ph.max())) + 1)
            _np.add.at(self._cm, (l, ph), 1)
            c = self._cm
            n = c.sum()
            t = c.sum(axis=1)     # true counts per class
            q = c.sum(axis=0)     # predicted counts per class
            cov_xy = n * _np.trace(c) - (t * q).sum()
            cov_xx = n * n - (t * t).sum()
            cov_yy = n * n - (q * q).sum()
            denom = math.sqrt(cov_xx * cov_yy)
            self.sum_metric = self.global_sum_metric = cov_xy / denom if denom > 0 else 0.0
            self.num_inst = self.global_num_inst = 1


@register("loss")
class Loss(EvalMetric):
    def __init__(self, name="loss", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)

    def update(self, _, preds):
        if not isinstance(preds, (list, tuple)):
            preds = [preds]
        for pred in preds:
            raw = _raw(pred)
            if raw is not None:
                self._update(raw.sum(), int(raw.numel()))
                continue
            p = _as_numpy(pred)
            self._update(p.sum(), int(_np.prod(p.shape)))


@register("custom")
class CustomMetric(EvalMetric):
    def __init__(self, feval, name="custom", allow_extra_outputs=False,
                 output_names=None, label_names=None):
        super().__init__(f"custom({name})", output_names, label_names)
        self._feval = feval

    def update(self, labels, preds):
        for label, pred in _pairs(labels, preds):
            v = self._feval(_as_numpy(label), _as_numpy(pred))
            if isinstance(v, tuple):
                self._update(v[0], v[1])
            else:
                self._update(float(v), 1)


def np(numpy_feval, name="custom", allow_extra_outputs=False):
    """A ``CustomMetric`` of ``numpy_feval(label, pred)`` on numpy arrays."""
    return CustomMetric(numpy_feval, name, allow_extra_outputs)


def create(metric, *args, **kwargs) -> EvalMetric:
    """A metric by name (``"acc"``, ``"top_k_accuracy"``, ...), from a
    callable (a ``CustomMetric``), a list (a ``CompositeEvalMetric``) or a
    metric itself."""
    if callable(metric):
        return CustomMetric(metric, *args, **kwargs)
    if isinstance(metric, EvalMetric):
        return metric
    if isinstance(metric, list):
        return CompositeEvalMetric([create(m) for m in metric])
    try:
        return _METRIC_REGISTRY[metric.lower()](*args, **kwargs)
    except KeyError:
        raise MXNetError(f"unknown metric {metric!r}") from None
