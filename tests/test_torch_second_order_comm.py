"""Second order through the port's communication Functions, against the
reference on two CPU devices.

Each case is a gradient penalty: a loss through one collective, its gradient
with respect to the rank's input taken with ``create_graph=True``, the
penalty, and the penalty's gradient with respect to the
rank's weight. The port runs it on 2 gloo ranks (``_dist_util.launch_local``,
one spawn for the module); the reference under ``shard_map`` on 2 CPU
devices, where JAX differentiates the custom_vjp backward rules of
``parallel.megatron``'s boundary collectives and of ``parallel.moe``'s
``wire_all_to_all``, and ``lax.all_to_all`` (Ulysses' exchange) natively.

The penalty is ``sum((g * w) ** 2)`` on each rank, a rank's part of the
global penalty, which is their sum (in the reference: the per-rank values
summed outside ``shard_map``). Each case's loss is nonlinear in the
collective's output, so the cotangent that reaches the first backward
depends on the weights, and the penalty varies over the ranks even where
``g`` is replicated (``copy_to_tp``), so the second derivative must run each
backward's collective again as JAX differentiates it: ``psum``'s transpose
is ``psum``, ``psum_scatter``'s ``all_gather`` and the reverse, an
all-to-all's the opposite all-to-all; ``reduce_from_tp``'s identity
backward stays the identity.

``pipeline_apply``'s GPipe Function refuses a second derivative with the
reference's words (``autograd._NO_SECOND_ORDER``): its reversed ticks'
point-to-point exchanges are not autograd ops, so nothing could record the
second derivative through them.

Tolerance: float32, only the order of summation differs: 1e-5 of the
largest value.
"""
import pathlib

import numpy as np
import pytest
import torch

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import _dist_util
from torch_threads import one_torch_thread  # noqa: F401

MODULE = "test_torch_second_order_comm"
TESTS_DIR = str(pathlib.Path(__file__).resolve().parent)
TOL = 1e-5
N = 2

# case -> (x rows a rank, c rows a rank, whether x is replicated); every
# array has 6 columns, a rank's w has its x's shape
CASES = {
    "copy_to_tp": (4, 4, True),
    "reduce_from_tp": (4, 4, False),
    "gather_from_sp": (4, 8, False),
    "scatter_to_sp": (4, 2, False),
    "wire_all_to_all": (4, 4, False),
    "ulysses_all_to_all": (4, 4, False),
}


def _arrays(case):
    """Global x, w, c (float32, seeded): rank r's rows are block r."""
    rx, rc, x_rep = CASES[case]
    rs = np.random.RandomState(sum(map(ord, case)))
    x = rs.randn(rx if x_rep else N * rx, 6).astype(np.float32)
    w = rs.randn(N * rx, 6).astype(np.float32)
    c = rs.randn(N * rc if case != "reduce_from_tp" else rc, 6).astype(np.float32)
    return x, w, c


def rank_penalties():
    """This rank's gradient of its penalty with respect to its weight block,
    for every case (see the module docstring)."""
    from mxnet_tpu_torch.ops.attention import _AllToAll
    from mxnet_tpu_torch.parallel import make_mesh, megatron, moe
    mesh = make_mesh({"tp": N}, devices=[mt.cpu()])
    r = mesh.axis_index("tp")
    group = mesh.group("tp")
    ops = {
        "copy_to_tp": lambda a: megatron.copy_to_tp(a, "tp", mesh),
        "reduce_from_tp": lambda a: megatron.reduce_from_tp(a, "tp", mesh),
        "gather_from_sp": lambda a: megatron.gather_from_sp(a, "tp", 0, mesh),
        "scatter_to_sp": lambda a: megatron.scatter_to_sp(a, "tp", 0, mesh),
        "wire_all_to_all": lambda a: moe.wire_all_to_all(
            a.reshape(N, -1, 6), "tp", None, mesh).reshape(a.shape),
        "ulysses_all_to_all": lambda a: _AllToAll.apply(a, group, N, 0, 1),
    }
    out = {}
    for case, op in ops.items():
        rx, rc, x_rep = CASES[case]
        x, w, c = (torch.from_numpy(a) for a in _arrays(case))
        xr = (x if x_rep else x[r * rx:(r + 1) * rx]).clone().requires_grad_()
        wr = w[r * rx:(r + 1) * rx].clone().requires_grad_()
        cr = c if case == "reduce_from_tp" else c[r * rc:(r + 1) * rc]
        if case == "copy_to_tp":
            f = op(xr) * wr
        else:
            f = op(xr * wr)
        if case == "ulysses_all_to_all":
            f = f.reshape(rc, -1)
        loss = torch.sum(torch.tanh(f) * cr)
        (g,) = torch.autograd.grad(loss, xr, create_graph=True)
        (gw,) = torch.autograd.grad(torch.sum((g * wr) ** 2), wr)
        out[case] = gw.numpy().tolist()
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return _dist_util.launch_local(f"{MODULE}:rank_penalties", N, device="cpu",
                                   timeout=120, pythonpath=[TESTS_DIR],
                                   workdir=str(tmp_path_factory.mktemp("so")))


def _reference(case):
    """The penalty's gradient with respect to the global w, by the reference
    under shard_map on 2 CPU devices."""
    import jax
    import jax.numpy as jnp
    from jax import lax
    from mxnet_tpu.parallel import megatron as M
    from mxnet_tpu.parallel import moe
    from mxnet_tpu.parallel.mesh import make_mesh, P
    from mxnet_tpu.parallel.zero import shard_map_compat
    rx, rc, x_rep = CASES[case]
    mesh = make_mesh({"tp": N}, devices=jax.devices("cpu")[:N])
    ops = {
        "copy_to_tp": lambda a: M.copy_to_tp(a, "tp"),
        "reduce_from_tp": lambda a: M.reduce_from_tp(a, "tp"),
        "gather_from_sp": lambda a: M.gather_from_sp(a, "tp", 0),
        "scatter_to_sp": lambda a: M.scatter_to_sp(a, "tp", 0),
        "wire_all_to_all": lambda a: moe.wire_all_to_all(
            a.reshape(N, -1, 6), "tp", None).reshape(a.shape),
        "ulysses_all_to_all": lambda a: lax.all_to_all(a, "tp", 0, 1, tiled=True),
    }
    op = ops[case]
    x, w, c = (jnp.asarray(a) for a in _arrays(case))

    def body(x, w, c):
        def loss(x):
            f = op(x) * w if case == "copy_to_tp" else op(x * w)
            if case == "ulysses_all_to_all":
                f = f.reshape(rc, -1)
            return jnp.sum(jnp.tanh(f) * c)
        g = jax.grad(loss)(x)
        return jnp.sum((g * w) ** 2).reshape(1)

    c_spec = P() if case == "reduce_from_tp" else P("tp")
    fn = shard_map_compat(body, mesh, (P() if x_rep else P("tp"), P("tp"), c_spec),
                          P("tp"))

    def objective(w):
        return jnp.sum(fn(x, w, c))
    return np.asarray(jax.grad(objective)(w))


@pytest.mark.parametrize("case", list(CASES))
def test_penalty_gradient_matches_reference(ranks, case):
    rx = CASES[case][0]
    got = np.concatenate([np.asarray(ranks[r][case], np.float32) for r in range(N)])
    expect = _reference(case)
    assert got.shape == expect.shape
    err = np.abs(got - expect).max()
    assert err <= TOL * max(float(np.abs(expect).max()), 1.0), (case, err)
    assert got[:rx].any() and got[rx:].any()


def test_gpipe_refuses_a_second_derivative():
    from mxnet_tpu_torch import autograd
    from mxnet_tpu_torch.base import MXNetError
    from mxnet_tpu_torch.parallel import pipeline_apply
    rs = np.random.RandomState(0)
    w = torch.from_numpy(rs.randn(6, 6).astype(np.float32)).requires_grad_()
    x = torch.from_numpy(rs.randn(2, 3, 6).astype(np.float32)).requires_grad_()
    out = pipeline_apply(lambda p, h, t: torch.tanh(h @ p[0]), [w], x, remat=False)
    (g,) = torch.autograd.grad(out.sum(), x, create_graph=False)
    assert g.shape == x.shape                   # first order is unchanged
    out = pipeline_apply(lambda p, h, t: torch.tanh(h @ p[0]), [w], x, remat=False)
    with pytest.raises(MXNetError) as e:
        torch.autograd.grad(out.sum(), x, create_graph=True)
    assert str(e.value) == autograd._NO_SECOND_ORDER
