"""The port's ``metric`` against the reference's (``mxnet_tpu/metric.py``):
every metric, built by its class and by ``create(name)``, fed the same two
batches of numpy predictions and labels as each package's NDArrays, as
numpy arrays, and (port only) as torch tensors; ``get()`` (and
``get_global()``) must equal the reference's.

Tolerance: counts exactly; values that are sums of f32 reductions (MAE,
MSE, RMSE, cross-entropy, the loss) 1e-6 relative, as the two packages may
sum in another order; the host metrics (numpy in both) exactly.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu_torch as mt
from torch_threads import one_torch_thread  # noqa: F401

TOL = 1e-6
N = 16


def _softmax(x):
    e = np.exp(x - x.max(-1, keepdims=True))
    return (e / e.sum(-1, keepdims=True)).astype(np.float32)


def _batches(kind, seed):
    """Two (label, pred) numpy batches for a metric of ``kind``."""
    rs = np.random.RandomState(seed)
    out = []
    for _ in range(2):
        if kind == "class":
            out.append((rs.randint(0, 5, N).astype(np.float32),
                        _softmax(rs.normal(size=(N, 5)).astype(np.float32))))
        elif kind == "binary":
            out.append((rs.randint(0, 2, N).astype(np.float32),
                        _softmax(rs.normal(size=(N, 2)).astype(np.float32))))
        elif kind == "pcc":
            out.append((rs.randint(0, 4, N).astype(np.float32),
                        _softmax(rs.normal(size=(N, 4)).astype(np.float32))))
        elif kind == "regression":
            out.append((rs.normal(size=(N, 3)).astype(np.float32),
                        rs.normal(size=(N, 3)).astype(np.float32)))
        elif kind == "pearson":
            lab = rs.normal(size=N).astype(np.float32)
            out.append((lab, (lab + rs.normal(size=N)).astype(np.float32)))
        else:                                      # loss values
            out.append((None, np.abs(rs.normal(size=N)).astype(np.float32)))
    return out


def _feval(label, pred):
    return float(np.abs(label.reshape(-1) - pred.argmax(-1)).mean())


# (id, class name, kwargs, create name or None, batch kind, exact)
METRICS = [
    ("accuracy", "Accuracy", {}, "acc", "class", True),
    ("top-k", "TopKAccuracy", {"top_k": 3}, "top_k_accuracy", "class", True),
    ("f1", "F1", {}, "f1", "binary", True),
    ("mae", "MAE", {}, "mae", "regression", False),
    ("mse", "MSE", {}, "mse", "regression", False),
    ("rmse", "RMSE", {}, "rmse", "regression", False),
    ("cross-entropy", "CrossEntropy", {}, "ce", "class", False),
    ("nll", "NegativeLogLikelihood", {}, "nll_loss", "class", False),
    ("perplexity", "Perplexity", {"ignore_label": 0}, "perplexity", "class", True),
    ("pearson", "PearsonCorrelation", {}, "pearsonr", "pearson", True),
    ("mcc", "MCC", {}, "mcc", "binary", True),
    ("pcc", "PCC", {}, "pcc", "pcc", True),
    ("loss", "Loss", {}, "loss", "loss", False),
]


@pytest.fixture(scope="module")
def ref():
    import mxnet_tpu as mx
    return mx


def _feed(metric, batches, wrap):
    for label, pred in batches:
        metric.update([wrap(label)] if label is not None else None, [wrap(pred)])
    return metric.get(), metric.get_global()


def _close(got, want, exact):
    (gn, gv), (wn, wv) = got, want
    assert gn == wn
    if exact:
        np.testing.assert_array_equal(gv, wv)
    else:
        np.testing.assert_allclose(gv, wv, rtol=TOL)


@pytest.mark.parametrize("by_name", [False, True], ids=["class", "create"])
@pytest.mark.parametrize("form", ["ndarray", "numpy", "tensor"])
@pytest.mark.parametrize("case", METRICS, ids=[m[0] for m in METRICS])
def test_metric_matches_reference(ref, case, form, by_name):
    _, cls, kw, name, kind, exact = case
    batches = _batches(kind, seed=len(cls))
    wraps = {"ndarray": (lambda a: mt.nd.array(a, ctx=mt.cpu()),
                         lambda a: ref.nd.array(a, ctx=ref.cpu())),
             "numpy": (lambda a: a, lambda a: a),
             "tensor": (torch.from_numpy, lambda a: ref.nd.array(a, ctx=ref.cpu()))}[form]
    make = (lambda pkg: pkg.metric.create(name, **kw)) if by_name \
        else (lambda pkg: getattr(pkg.metric, cls)(**kw))
    got = _feed(make(mt), batches, wraps[0])
    want = _feed(make(ref), batches, wraps[1])
    for g, w in zip(got, want):
        _close(g, w, exact)


def test_accuracy_takes_single_arrays_and_resets(ref):
    """``Accuracy`` and ``Loss`` also take one array each; ``reset()`` and
    ``reset_local()`` clear what the reference clears."""
    (l1, p1), (l2, p2) = _batches("class", 3)
    outs = []
    for pkg in (mt, ref):
        acc = pkg.metric.Accuracy()
        acc.update(pkg.nd.array(l1, ctx=pkg.cpu()), pkg.nd.array(p1, ctx=pkg.cpu()))
        acc.reset_local()
        acc.update(pkg.nd.array(l2, ctx=pkg.cpu()), pkg.nd.array(p2, ctx=pkg.cpu()))
        loss = pkg.metric.Loss()
        loss.update(None, pkg.nd.array(p2, ctx=pkg.cpu()))
        outs.append((acc.get(), acc.get_global(), loss.get(), str(acc)))
        acc.reset()
        outs[-1] += (acc.get()[0], np.isnan(acc.get()[1]))
    assert outs[0][0] == outs[1][0] and outs[0][1] == outs[1][1]
    np.testing.assert_allclose(outs[0][2][1], outs[1][2][1], rtol=TOL)
    assert outs[0][3:] == outs[1][3:]


def test_composite_custom_and_np_match_reference(ref):
    """A composite of names and metrics, ``CustomMetric``, ``np(...)``,
    ``create`` of a callable and of a list; unknown names raise."""
    batches = _batches("class", 5)
    outs = []
    for pkg in (mt, ref):
        comp = pkg.metric.CompositeEvalMetric(["acc", pkg.metric.TopKAccuracy(top_k=2)])
        comp.add("ce")
        custom = pkg.metric.CustomMetric(_feval, name="argmax-gap")
        npm = pkg.metric.np(_feval)
        from_fn = pkg.metric.create(_feval)
        from_list = pkg.metric.create(["acc", "nll_loss"])
        res = []
        for m in (comp, custom, npm, from_fn, from_list):
            for label, pred in batches:
                m.update([pkg.nd.array(label, ctx=pkg.cpu())], [pkg.nd.array(pred, ctx=pkg.cpu())])
            res.append(m.get())
        res.append(comp.get_name_value())
        outs.append(res)
    for g, w in zip(*outs):
        if isinstance(g, list):
            g, w = dict(g), dict(w)
            assert g.keys() == w.keys()
            np.testing.assert_allclose([g[k] for k in g], [w[k] for k in g], rtol=TOL)
            continue
        assert g[0] == w[0]
        np.testing.assert_allclose(g[1], w[1], rtol=TOL)
    with pytest.raises(mt.MXNetError):
        mt.metric.create("no-such-metric")


def test_device_metrics_do_not_sync_until_get():
    """The device path keeps ``sum_metric`` a tensor until ``get()``."""
    label, pred = _batches("class", 7)[0]
    acc = mt.metric.Accuracy()
    acc.update(torch.from_numpy(label), torch.from_numpy(pred))
    assert isinstance(acc.sum_metric, torch.Tensor)
    assert isinstance(acc.get()[1], float)
