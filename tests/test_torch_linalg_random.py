"""``nd.linalg`` and ``nd.random`` of the port against the reference package.

- linalg: every ``nd.linalg`` function on batched, well-conditioned inputs
  (symmetric positive definite ones shifted by a multiple of the identity,
  triangular ones with a dominant diagonal) within 1e-4 of each tensor's
  max of the reference's, and its gradients (of a random projection of the
  output) within 1e-4 as well; ``syevd``, whose eigenvectors' signs are the
  solver's, by its eigenvalues, its reconstruction ``U^T diag(L) U`` and
  ``|U|``.
- random: the two packages' generators differ, so each sampler is held by
  its distribution, not by values: the sample mean and variance within 5
  standard errors of the distribution's, and a Kolmogorov-Smirnov test
  against its CDF (p above 1e-3) for the continuous ones; the NDArray
  parameter forms (``_sample_*``) by their shape and per-row moments; and
  ``mx.random.seed`` makes every draw repeat, bitwise.
"""
import math

import numpy as np
import pytest
import torch

import mxnet_tpu_torch as mt
from torch_threads import one_torch_thread  # noqa: F401

TOL_LINALG = 1e-4
N_DRAWS = 20000


@pytest.fixture(scope="module")
def ref():
    import mxnet_tpu as mx
    return mx


def _rs(seed):
    return np.random.RandomState(seed)


def _spd(rs, *batch, n=4):
    m = rs.randn(*batch, n, n).astype(np.float32)
    return (m @ np.swapaxes(m, -1, -2) + n * np.eye(n, dtype=np.float32)).astype(np.float32)


def _lower(rs, *batch, n=4):
    return (np.tril(rs.randn(*batch, n, n)) + 3 * np.eye(n)).astype(np.float32)


def _inputs(name):
    rs = _rs(sum(name.encode()))
    return {
        "gemm": ([rs.randn(2, 3, 4), rs.randn(2, 4, 5), rs.randn(2, 3, 5)],
                 {"alpha": 0.5, "beta": 2.0}),
        "gemm2": ([rs.randn(2, 4, 3), rs.randn(2, 4, 5)], {"transpose_a": True}),
        "potrf": ([_spd(rs, 2)], {}),
        "potri": ([np.linalg.cholesky(_spd(rs, 2))], {}),
        "trsm": ([_lower(rs, 2), rs.randn(2, 4, 3)], {"alpha": 1.5}),
        "trsm-rightside": ([_lower(rs, 2), rs.randn(2, 3, 4)], {"rightside": True,
                                                               "transpose": True}),
        "trmm": ([rs.randn(2, 4, 4), rs.randn(2, 4, 3)], {"lower": False}),
        "sumlogdiag": ([_spd(rs, 3)], {}),
        "syrk": ([rs.randn(2, 3, 4)], {"transpose": True, "alpha": 0.5}),
        "extractdiag": ([rs.randn(2, 4, 4)], {"offset": 1}),
        "makediag": ([rs.randn(2, 3)], {"offset": -1}),
        "extracttrian": ([rs.randn(2, 4, 4)], {"lower": False}),
        "maketrian": ([rs.randn(2, 6)], {}),
        "gelqf": ([rs.randn(2, 3, 5)], {}),
        "inverse": ([_spd(rs, 2)], {}),
        "det": ([_spd(rs, 3) * 0.5], {}),
        "slogdet": ([rs.randn(2, 4, 4) + 3 * np.eye(4)], {}),
    }[name]


LINALG = ["gemm", "gemm2", "potrf", "potri", "trsm", "trsm-rightside", "trmm",
          "sumlogdiag", "syrk", "extractdiag", "makediag", "extracttrian", "maketrian",
          "gelqf", "inverse", "det", "slogdet"]


def _run(pkg, name, arrays, kw, proj_seed):
    """The outputs of ``nd.linalg.<name>`` and the gradients of a fixed
    random projection of them with respect to every input."""
    short = name.split("-")[0]
    # extracttrian/maketrian: ops of both packages that neither's nd.linalg names
    fn = getattr(pkg.nd.linalg, short, None) or getattr(pkg.nd, "linalg_" + short)
    xs = [pkg.nd.array(a.astype(np.float32), ctx=pkg.cpu()) for a in arrays]
    for x in xs:
        x.attach_grad()
    with pkg.autograd.record():
        out = fn(*xs, **kw)
        outs = list(out) if isinstance(out, (list, tuple)) else [out]
        rs = _rs(proj_seed)
        total = None
        for o in outs:
            if name == "slogdet" and o is outs[0]:
                continue                        # the sign is piecewise constant
            w = pkg.nd.array(rs.randn(*o.shape).astype(np.float32), ctx=pkg.cpu())
            term = (o * w).sum()
            total = term if total is None else total + term
    total.backward()
    return [np.asarray(o.asnumpy()) for o in outs], [np.asarray(x.grad.asnumpy()) for x in xs]


def _rel(got, want):
    scale = max(np.abs(want).max(), 1e-30)
    return np.abs(got - want).max() / scale


@pytest.mark.parametrize("name", LINALG)
def test_linalg_matches_reference_with_gradients(ref, name):
    arrays, kw = _inputs(name)
    got = _run(mt, name, arrays, kw, 9)
    want = _run(ref, name, arrays, kw, 9)
    for g, w in zip(got[0], want[0]):
        assert g.shape == w.shape
        assert _rel(g, w) <= TOL_LINALG, (name, "output", _rel(g, w))
    for g, w in zip(got[1], want[1]):
        assert _rel(g, w) <= TOL_LINALG, (name, "gradient", _rel(g, w))


def test_syevd_reconstructs_and_matches_reference(ref):
    a = _spd(_rs(3), 2)
    u, lam = mt.nd.linalg.syevd(mt.nd.array(a, ctx=mt.cpu()))
    ru, rlam = ref.nd.linalg.syevd(ref.nd.array(a, ctx=ref.cpu()))
    u, lam, ru, rlam = u.asnumpy(), lam.asnumpy(), np.asarray(ru.asnumpy()), \
        np.asarray(rlam.asnumpy())
    assert _rel(lam, rlam) <= TOL_LINALG
    assert _rel(np.abs(u), np.abs(ru)) <= TOL_LINALG
    back = np.swapaxes(u, -1, -2) @ (lam[..., None] * u)
    assert _rel(back, a) <= TOL_LINALG
    x = mt.nd.array(a, ctx=mt.cpu())
    x.attach_grad()
    with mt.autograd.record():
        s = mt.nd.linalg.syevd(x)[1].sum()        # the trace: gradient I
    s.backward()
    assert _rel(x.grad.asnumpy(), np.broadcast_to(np.eye(4), a.shape)) <= TOL_LINALG


# -- random -------------------------------------------------------------------------------

def _ks(samples, cdf):
    """The Kolmogorov-Smirnov statistic and its asymptotic p-value."""
    x = np.sort(samples.astype(np.float64).ravel())
    n = x.size
    c = cdf(x)
    d = max(np.max(np.arange(1, n + 1) / n - c), np.max(c - np.arange(n) / n))
    t = d * math.sqrt(n)
    p = 2 * sum((-1) ** (k - 1) * math.exp(-2 * k * k * t * t) for k in range(1, 101))
    return d, min(max(p, 0.0), 1.0)


def _moments_ok(x, mean, var):
    x = x.astype(np.float64).ravel()
    se_mean = math.sqrt(var / x.size)
    assert abs(x.mean() - mean) <= 5 * se_mean + 1e-12, (x.mean(), mean)
    # the variance's standard error, from the fourth moment of the sample
    m4 = np.mean((x - x.mean()) ** 4)
    se_var = math.sqrt(max(m4 - x.var() ** 2, 1e-30) / x.size)
    assert abs(x.var() - var) <= 5 * se_var + 1e-12, (x.var(), var)


def _gamma_cdf(a, scale):
    from scipy import special
    return lambda x: special.gammainc(a, np.maximum(x, 0) / scale)


def _normal_cdf(m, s):
    from scipy import special
    return lambda x: 0.5 * (1 + special.erf((x - m) / (s * math.sqrt(2))))


CONTINUOUS = {
    "uniform": (lambda: mt.nd.random.uniform(-1.0, 3.0, shape=(N_DRAWS,), ctx=mt.cpu()),
                1.0, 16.0 / 12, lambda x: np.clip((x + 1) / 4, 0, 1)),
    "normal": (lambda: mt.nd.random.normal(1.5, 2.0, shape=(N_DRAWS,), ctx=mt.cpu()),
               1.5, 4.0, None),
    "randn": (lambda: mt.nd.random.randn(100, N_DRAWS // 100, loc=-1.0, ctx=mt.cpu()),
              -1.0, 1.0, None),
    "exponential": (lambda: mt.nd.random.exponential(0.5, shape=(N_DRAWS,), ctx=mt.cpu()),
                    0.5, 0.25, lambda x: 1 - np.exp(-np.maximum(x, 0) / 0.5)),
    "gamma": (lambda: mt.nd.random.gamma(2.5, 1.5, shape=(N_DRAWS,), ctx=mt.cpu()),
              3.75, 2.5 * 1.5 ** 2, None),
}


@pytest.mark.parametrize("name", list(CONTINUOUS))
def test_continuous_samplers_by_moments_and_ks(name):
    draw, mean, var, cdf = CONTINUOUS[name]
    mt.random.seed(123)
    x = draw().asnumpy()
    _moments_ok(x, mean, var)
    if cdf is None:
        cdf = {"normal": _normal_cdf(1.5, 2.0), "randn": _normal_cdf(-1.0, 1.0),
               "gamma": _gamma_cdf(2.5, 1.5)}[name]
    assert _ks(x, cdf)[1] > 1e-3
    mt.random.seed(123)
    np.testing.assert_array_equal(draw().asnumpy(), x)


DISCRETE = {
    "poisson": (lambda: mt.nd.random.poisson(3.5, shape=(N_DRAWS,), ctx=mt.cpu()), 3.5, 3.5),
    "randint": (lambda: mt.nd.random.randint(-3, 5, shape=(N_DRAWS,), ctx=mt.cpu()),
                0.5, (8 ** 2 - 1) / 12),
    "bernoulli": (lambda: mt.nd.random.bernoulli(0.3, shape=(N_DRAWS,), ctx=mt.cpu()),
                  0.3, 0.21),
    "negative_binomial": (lambda: mt.nd.random.negative_binomial(
        3, 0.4, shape=(N_DRAWS,), ctx=mt.cpu()), 3 * 0.6 / 0.4, 3 * 0.6 / 0.16),
    "generalized_negative_binomial": (lambda: mt.nd.random.generalized_negative_binomial(
        2.0, 0.5, shape=(N_DRAWS,), ctx=mt.cpu()), 2.0, 2.0 + 0.5 * 4.0),
}


@pytest.mark.parametrize("name", list(DISCRETE))
def test_discrete_samplers_by_moments(name):
    draw, mean, var = DISCRETE[name]
    mt.random.seed(7)
    x = draw().asnumpy()
    assert np.all(x == np.round(x))
    _moments_ok(x, mean, var)
    mt.random.seed(7)
    np.testing.assert_array_equal(draw().asnumpy(), x)


def test_randint_range_and_dtype(ref):
    x = mt.nd.random.randint(2, 6, shape=(1000,), ctx=mt.cpu())
    r = ref.nd.random.randint(2, 6, shape=(1000,), ctx=ref.cpu())
    assert x.dtype == torch.int32 and str(np.asarray(r.asnumpy()).dtype) == "int32"
    assert set(np.unique(x.asnumpy())) == {2, 3, 4, 5}


def test_multinomial_frequencies_and_log_probs(ref):
    p = np.array([[0.1, 0.2, 0.7], [0.5, 0.25, 0.25]], np.float32)
    data = mt.nd.array(p, ctx=mt.cpu())
    mt.random.seed(3)
    idx, logp = mt.nd.random.multinomial(data, shape=N_DRAWS // 2, get_prob=True)
    assert idx.shape == (2, N_DRAWS // 2) and idx.dtype == torch.int32
    for row in range(2):
        freq = np.bincount(idx.asnumpy()[row], minlength=3) / (N_DRAWS // 2)
        se = np.sqrt(p[row] * (1 - p[row]) / (N_DRAWS // 2))
        assert np.all(np.abs(freq - p[row]) <= 5 * se)
        np.testing.assert_allclose(logp.asnumpy()[row], np.log(p[row])[idx.asnumpy()[row]],
                                   rtol=1e-5)
    one = mt.nd.random.multinomial(mt.nd.array(p[0], ctx=mt.cpu()))
    rone = ref.nd.random.multinomial(ref.nd.array(p[0], ctx=ref.cpu()))
    assert one.shape == tuple(rone.shape) == ()
    assert mt.nd.random.multinomial(data).shape == (2,)


def test_shuffle_permutes_rows():
    x = mt.nd.array(np.arange(40, dtype=np.float32).reshape(20, 2), ctx=mt.cpu())
    mt.random.seed(1)
    y = mt.nd.random.shuffle(x).asnumpy()
    assert sorted(y[:, 0].tolist()) == list(range(0, 40, 2))
    np.testing.assert_array_equal(y[:, 1], y[:, 0] + 1)
    mt.random.seed(1)
    np.testing.assert_array_equal(mt.nd.random.shuffle(x).asnumpy(), y)


SAMPLE_OPS = {
    "uniform": (lambda a, b: mt.nd.random.uniform(a, b, shape=4000),
                lambda lo, hi: ((lo + hi) / 2, (hi - lo) ** 2 / 12)),
    "normal": (lambda a, b: mt.nd.random.normal(a, b, shape=4000),
               lambda m, s: (m, s ** 2)),
    "gamma": (lambda a, b: mt.nd.random.gamma(a, b, shape=4000),
              lambda a, b: (a * b, a * b * b)),
    "exponential": (lambda a, b: mt.nd.random.exponential(a, shape=4000),
                    lambda a, b: (a, a * a)),
    "poisson": (lambda a, b: mt.nd.random.poisson(a, shape=4000),
                lambda a, b: (a, a)),
    "negative_binomial": (lambda a, b: mt.nd.random.negative_binomial(a, b * 0.3, shape=4000),
                          lambda k, p: (k * (1 - 0.3 * p) / (0.3 * p),
                                        k * (1 - 0.3 * p) / (0.3 * p) ** 2)),
    "generalized_negative_binomial": (
        lambda a, b: mt.nd.random.generalized_negative_binomial(a, b, shape=4000),
        lambda m, al: (m, m + al * m * m)),
}


@pytest.mark.parametrize("name", list(SAMPLE_OPS))
def test_ndarray_parameters_route_to_the_multisample_ops(ref, name):
    draw, moments = SAMPLE_OPS[name]
    a = np.array([[1.0, 2.5], [4.0, 0.5]], np.float32)
    b = np.array([[2.0, 3.0], [1.5, 1.0]], np.float32)
    before = mt.ops.get_op("_sample_" + name).calls
    mt.random.seed(11)
    out = draw(mt.nd.array(a, ctx=mt.cpu()), mt.nd.array(b, ctx=mt.cpu()))
    assert mt.ops.get_op("_sample_" + name).calls == before + 1
    assert out.shape == (2, 2, 4000)
    x = out.asnumpy()
    for i in range(2):
        for j in range(2):
            m, v = moments(float(a[i, j]), float(b[i, j]))
            _moments_ok(x[i, j], m, v)
    mt.random.seed(11)
    again = draw(mt.nd.array(a, ctx=mt.cpu()), mt.nd.array(b, ctx=mt.cpu()))
    np.testing.assert_array_equal(again.asnumpy(), x)


def test_sample_shapes_match_reference(ref):
    a = np.array([1.0, 2.0, 3.0], np.float32)
    for shape, want in ((None, (3,)), (5, (3, 5)), ((2, 4), (3, 2, 4))):
        got = mt.nd.random.normal(mt.nd.array(a, ctx=mt.cpu()), mt.nd.array(a, ctx=mt.cpu()),
                                  shape=shape)
        r = ref.nd.random.normal(ref.nd.array(a, ctx=ref.cpu()), ref.nd.array(a, ctx=ref.cpu()),
                                 shape=shape)
        assert got.shape == tuple(r.shape) == want


def test_registered_random_ops_and_out():
    mt.random.seed(5)
    u = mt.nd._random_uniform(low=2.0, high=3.0, shape=(500,), ctx=mt.cpu()).asnumpy()
    assert u.min() >= 2.0 and u.max() < 3.0
    like = mt.nd.zeros((3, 4), ctx=mt.cpu(), dtype="float16")
    z = mt.nd._random_normal_like(like)
    assert z.shape == (3, 4) and z.dtype == torch.float16
    assert mt.nd._random_uniform_like(like).dtype == torch.float16
    n = mt.nd._random_normal(loc=1.0, scale=0.0, shape=(2,), ctx=mt.cpu()).asnumpy()
    np.testing.assert_array_equal(n, [1.0, 1.0])
    idx = mt.nd._sample_multinomial(mt.nd.array([[0.0, 1.0, 0.0]], ctx=mt.cpu()), shape=3)
    np.testing.assert_array_equal(idx.asnumpy(), [[1, 1, 1]])
    out = mt.nd.zeros((1000,), ctx=mt.cpu())
    ptr = out._data.data_ptr()
    assert mt.nd.random.uniform(0.0, 1.0, shape=(1000,), ctx=mt.cpu(), out=out) is out
    assert out._data.data_ptr() == ptr and 0.0 < out.asnumpy().mean() < 1.0


def test_seed_repeats_across_samplers():
    def draws():
        return [mt.nd.random.uniform(shape=(5,), ctx=mt.cpu()).asnumpy(),
                mt.nd.random.poisson(2.0, shape=(5,), ctx=mt.cpu()).asnumpy(),
                mt.nd.random.gamma(1.5, shape=(5,), ctx=mt.cpu()).asnumpy()]
    mt.random.seed(99)
    a = draws()
    mt.random.seed(99)
    b = draws()
    mt.random.seed(100)
    c = draws()
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    assert not np.array_equal(a[0], c[0])
