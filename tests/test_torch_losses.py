"""The thirteen Gluon losses of the port against the reference's
(``mxnet_tpu/gluon/loss.py``): the same numpy inputs through each package's
loss block under ``autograd.record()``, the loss values and the gradients of
the differentiable inputs after ``backward()`` compared, each case plain and
with a ``weight`` and a ``sample_weight``.

Tolerance 1e-5, relative and absolute, in f32: the same formulas on the CPU;
CTC's forward algorithm is ``F.ctc_loss`` in the port and a log-space scan in
the reference, which agree to that.
"""
import numpy as np
import pytest

import mxnet_tpu_torch as mt
from torch_threads import one_torch_thread  # noqa: F401

TOL = 1e-5
B, C = 4, 5


def _rs(seed):
    return np.random.RandomState(seed)


def _f(rs, *shape):
    return rs.normal(0, 1, shape).astype(np.float32)


def _signs(rs, *shape):
    return np.where(rs.rand(*shape) > 0.5, 1.0, -1.0).astype(np.float32)


def _cases():
    """(id, loss name, kwargs, inputs, differentiable input indices,
    sample_weight shape)."""
    rs = _rs(0)
    pred, label = _f(rs, B, C), _f(rs, B, C)
    bits = (rs.rand(B, C) > 0.5).astype(np.float32)
    probs = rs.uniform(0.05, 0.95, (B, C)).astype(np.float32)
    cls = rs.randint(0, C, B).astype(np.float32)
    dist = rs.dirichlet(np.ones(C), B).astype(np.float32)
    counts = rs.poisson(2.0, (B, C)).astype(np.float32)
    ctc_pred = _f(rs, B, 6, C)
    ctc_label = np.array([[0, 1, -1], [2, 2, 3], [1, -1, -1], [3, 0, 2]], np.float32)
    pos_weight = rs.uniform(0.5, 2.0, C).astype(np.float32)
    a, p, n = _f(rs, B, C), _f(rs, B, C), _f(rs, B, C)
    return [
        ("l2", "L2Loss", {}, [pred, label], [0], (B, 1)),
        ("l1", "L1Loss", {}, [pred, label], [0], (B, 1)),
        ("sigmoid-bce-logits", "SigmoidBinaryCrossEntropyLoss", {}, [pred, bits], [0],
         (B, 1)),
        ("sigmoid-bce-probs", "SigmoidBCELoss", {"from_sigmoid": True}, [probs, bits], [0],
         (B, 1)),
        ("softmax-ce-sparse", "SoftmaxCrossEntropyLoss", {}, [pred, cls], [0], (B, 1)),
        ("softmax-ce-dense", "SoftmaxCELoss", {"sparse_label": False}, [pred, dist], [0],
         (B, 1)),
        ("kldiv-logits", "KLDivLoss", {"from_logits": False}, [pred, dist], [0], (B, 1)),
        ("kldiv-logprobs", "KLDivLoss", {}, [np.log(dist), dist], [0], (B, 1)),
        ("ctc", "CTCLoss", {}, [ctc_pred, ctc_label], [0], (B,)),
        ("huber", "HuberLoss", {"rho": 0.5}, [pred, label], [0], (B, 1)),
        ("hinge", "HingeLoss", {}, [pred, _signs(rs, B, C)], [0], (B, 1)),
        ("squared-hinge", "SquaredHingeLoss", {"margin": 0.5}, [pred, _signs(rs, B, C)],
         [0], (B, 1)),
        ("logistic-signed", "LogisticLoss", {}, [pred, _signs(rs, B, C)], [0], (B, 1)),
        ("logistic-binary", "LogisticLoss", {"label_format": "binary"}, [pred, bits], [0],
         (B, 1)),
        ("triplet", "TripletLoss", {"margin": 0.5}, [a, p, n], [0, 1, 2], (B,)),
        ("poisson-logits", "PoissonNLLLoss", {}, [pred, counts], [0], (B, 1)),
        ("poisson-full", "PoissonNLLLoss", {"from_logits": False, "compute_full": True},
         [np.exp(pred), counts], [0], (B, 1)),
        ("cosine", "CosineEmbeddingLoss", {"margin": 0.1},
         [a, p, _signs(rs, B)], [0, 1], (B,)),
    ]


CASES = _cases()
IDS = [c[0] for c in CASES]


def _run(pkg, ctx, name, kw, arrays, diff, sw):
    loss = getattr(pkg.gluon.loss, name)(**kw)
    nds = [pkg.nd.array(a, ctx=ctx) for a in arrays]
    for i in diff:
        nds[i].attach_grad()
    args = list(nds)
    if sw is not None:              # CTC's lengths come before its sample_weight
        args += [None, None] * (name == "CTCLoss") + [pkg.nd.array(sw, ctx=ctx)]
    with pkg.autograd.record():
        out = loss(*args)
    out.backward()
    return out.asnumpy(), [nds[i].grad.asnumpy() for i in diff]


@pytest.fixture(scope="module")
def ref():
    import mxnet_tpu as mx
    return mx


@pytest.mark.parametrize("weighted", [False, True], ids=["plain", "weighted"])
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_loss_matches_reference(ref, case, weighted):
    _, name, kw, arrays, diff, sw_shape = case
    kw, sw = dict(kw), None
    if weighted:
        kw["weight"] = 0.7
        sw = _rs(1).uniform(0.5, 1.5, sw_shape).astype(np.float32)
    got, got_g = _run(mt, mt.cpu(), name, kw, arrays, diff, sw)
    want, want_g = _run(ref, ref.cpu(), name, kw, arrays, diff, sw)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    for g, w in zip(got_g, want_g):
        np.testing.assert_allclose(g, w, rtol=TOL, atol=TOL)


def test_sigmoid_bce_pos_weight_matches_reference(ref):
    """``pos_weight`` (after ``sample_weight``) in both forms of the input."""
    rs = _rs(2)
    pred, bits = _f(rs, B, C), (rs.rand(B, C) > 0.5).astype(np.float32)
    pw = rs.uniform(0.5, 2.0, C).astype(np.float32)
    sw = np.ones((B, 1), np.float32)
    for from_sigmoid, x in ((False, pred), (True, 1 / (1 + np.exp(-pred)))):
        x = x.astype(np.float32)
        outs = []
        for pkg, ctx in ((mt, mt.cpu()), (ref, ref.cpu())):
            loss = pkg.gluon.loss.SigmoidBCELoss(from_sigmoid=from_sigmoid)
            p = pkg.nd.array(x, ctx=ctx)
            p.attach_grad()
            with pkg.autograd.record():
                L = loss(p, pkg.nd.array(bits, ctx=ctx), pkg.nd.array(sw, ctx=ctx),
                         pkg.nd.array(pw, ctx=ctx))
            L.backward()
            outs.append((L.asnumpy(), p.grad.asnumpy()))
        for g, w in zip(*outs):
            np.testing.assert_allclose(g, w, rtol=TOL, atol=TOL)


def test_hybridized_losses_equal_plain_on_the_cpu():
    """Hybridized, a loss block runs its eager forward on the CPU: values and
    input gradients bitwise the unhybridized block's (tolerance 0)."""
    for _, name, kw, arrays, diff, _ in CASES:
        outs = []
        for hybrid in (False, True):
            loss = getattr(mt.gluon.loss, name)(**kw)
            if hybrid:
                loss.hybridize()
            nds = [mt.nd.array(a, ctx=mt.cpu()) for a in arrays]
            for i in diff:
                nds[i].attach_grad()
            with mt.autograd.record():
                out = loss(*nds)
            out.backward()
            outs.append([out.asnumpy()] + [nds[i].grad.asnumpy() for i in diff])
        for g, w in zip(*outs):
            np.testing.assert_array_equal(g, w)


def test_ctc_infeasible_alignment_is_infinite_where_the_reference_floors(ref):
    """A label that cannot fit its sequence (3 labels, 2 frames): the port's
    ``F.ctc_loss`` gives +inf, the reference's log-space scan its floor for
    log 0 (1e30). A difference kept (ROADMAP §C); feasible rows agree at
    TOL."""
    rs = _rs(3)
    pred = _f(rs, 2, 2, C)
    label = np.array([[0, 1, 2], [1, -1, -1]], np.float32)
    got, want = (pkg.gluon.loss.CTCLoss()(pkg.nd.array(pred, ctx=pkg.cpu()),
                                          pkg.nd.array(label, ctx=pkg.cpu())).asnumpy()
                 for pkg in (mt, ref))
    assert np.isinf(got[0]) and want[0] >= 1e29
    np.testing.assert_allclose(got[1], want[1], rtol=TOL, atol=TOL)
