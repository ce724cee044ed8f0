"""The port's mixture-of-experts layers against the reference's, on the CPU.

- ``topk_gating`` on random, all-tied and overflowing logits, k = 1 and 2:
  the dispatch tensor equal to the reference's, and the combine tensor the
  dispatch times the port's own router probabilities exactly and the
  reference's to 2 ulps (torch's and XLA's exp differ in the last bit);
  ties go to the lower expert index.
- ``load_balance_loss``, ``dropped_tokens``, ``moe_capacity``,
  ``all_to_all_wire_bytes`` and ``load_balancing_loss`` over a grid.
- ``moe_ffn`` (top-1 and top-2, with overflow): output and the gradients of
  x, gate_w, w1 and w2 against ``jax.grad`` of the reference's, in f64 to
  1e-10 and in f32 to 1e-5 of each tensor's max (top-1's gate_w gradient,
  f32 rounding in both packages, against the f64 one at 1e-4); the port's indexed dispatch/combine against its
  one-hot einsum form (``_einsum_ffn``): bitwise at top-1, and at top-2,
  where BLAS may fuse the two products of a token's sum into one rounding,
  within 2 ulps of the output's max.
- ``wire_all_to_all`` with the native, bf16 and int8 wires and
  ``expert_parallel_moe`` (the dryrun's shape, and E = 8 top-2) on 4 spawned
  gloo ranks against the reference's under ``shard_map`` on 4 CPU devices:
  the exchanged values bitwise (the same rounding to bf16 and the same int8
  quantisation), the exchange's gradient its inverse exchange; the layer's
  output and gradients 2e-5 of each tensor's max (at top-1 gate_w's
  gradient is the f32 rounding of d(g/g) = 0 in both packages, and is held
  below 1e-5 of x's).
"""
import sys

import numpy as np
import pytest
import torch

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import _dist_util
from mxnet_tpu_torch.parallel import make_mesh
from mxnet_tpu_torch.parallel import moe as pm
from torch_threads import one_torch_thread  # noqa: F401

MODULE = "test_torch_moe"
TESTS_DIR = str(__import__("pathlib").Path(__file__).resolve().parent)
EP = 4
TOL_FFN = 1e-5          # moe_ffn against jax, of each tensor's max
TOL_EP = 2e-5           # the reference's own (tests/test_recipes.py)
ULP2 = 2 * 2.0 ** -23   # the softmax's last bits, relative
# (name, E, D, H, tokens, top_k, capacity_factor): the dryrun's call
# (__graft_entry__.py:188-203 at 4 devices) and a top-2 case with overflow
EP_CASES = [("dryrun", 4, 16, 32, 32, 1, 4.0), ("e8top2", 8, 16, 32, 64, 2, 1.0)]
WIRES = [None, "bfloat16", "int8"]
WIRE_SHAPE = (EP * EP, 6, 8)          # each rank's (EP, 6, 8) block of rows


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()), 1e-30)


def _logits(kind, k):
    rs = np.random.RandomState(3 + k)
    if kind == "tied":
        return np.zeros((6, 4), np.float32), 6
    if kind == "overflow":
        lg = rs.normal(0, 1, (24, 4)).astype(np.float32)
        lg[:, 1] += 4.0                  # most tokens want expert 1
        return lg, pm.moe_capacity(24, k, 1.0, 4)
    return rs.normal(0, 2, (64, 8)).astype(np.float32), pm.moe_capacity(64, k, 1.5, 8)


@pytest.mark.parametrize("kind", ["random", "tied", "overflow"])
@pytest.mark.parametrize("k", [1, 2])
def test_topk_gating_matches_reference(kind, k):
    import jax.numpy as jnp
    from mxnet_tpu.parallel import moe as R
    lg, cap = _logits(kind, k)
    rd, rc = (np.asarray(a) for a in R.topk_gating(jnp.asarray(lg), k, cap))
    d, c = pm.topk_gating(torch.from_numpy(lg), k, cap)
    d, c = d.numpy(), c.numpy()
    np.testing.assert_array_equal(d, rd)
    probs = torch.softmax(torch.from_numpy(lg), -1).numpy()
    np.testing.assert_array_equal(c, d * probs[:, :, None])
    assert np.abs(c - rc).max() <= ULP2 * max(float(np.abs(rc).max()), 1e-30)
    again = pm.topk_gating(torch.from_numpy(lg), k, cap)
    assert np.array_equal(again[0].numpy(), d) and np.array_equal(again[1].numpy(), c)
    if kind == "tied":         # every token on the lowest k experts
        assert (d.sum(2)[:, :k] == 1).all() and (d.sum(2)[:, k:] == 0).all()
    if kind == "overflow":
        assert 0 < int(pm.dropped_tokens(torch.from_numpy(d), lg.shape[0], k)) \
            == int(R.dropped_tokens(jnp.asarray(rd), lg.shape[0], k))


def test_overflow_claims_slots_in_token_order():
    d, c = pm.topk_gating(torch.tensor([[9.0, 0.0]] * 5), 1, 3)
    for n in range(3):
        assert d[n, 0, n] == 1.0 and d[n].sum() == 1.0
    for n in (3, 4):
        assert d[n].sum() == 0.0 and c[n].sum() == 0.0
    assert int(pm.dropped_tokens(d, 5, 1)) == 2


def test_losses_counts_and_wire_bytes_match_reference():
    import jax
    import jax.numpy as jnp
    from mxnet_tpu.parallel import moe as R
    rs = np.random.RandomState(4)
    for N, E, k, cf in [(16, 4, 1, 1.0), (32, 8, 2, 0.5), (48, 4, 2, 2.0), (10, 2, 1, 0.3)]:
        lg = (rs.normal(0, 1, (N, E)) + np.linspace(0, 2, E)).astype(np.float32)
        cap = pm.moe_capacity(N, k, cf, E)
        assert cap == R.moe_capacity(N, k, cf, E)
        rd, _ = R.topk_gating(jnp.asarray(lg), k, cap)
        d, _ = pm.topk_gating(torch.from_numpy(lg), k, cap)
        probs = jax.nn.softmax(jnp.asarray(lg), -1)
        want = float(R.load_balance_loss(probs, rd))
        got = float(pm.load_balance_loss(torch.softmax(torch.from_numpy(lg), -1), d))
        assert abs(got - want) <= 1e-6 * abs(want)
        assert int(pm.dropped_tokens(d, N, k)) == int(R.dropped_tokens(rd, N, k))
        want = float(R.load_balancing_loss(jnp.asarray(lg), k))
        assert abs(float(pm.load_balancing_loss(torch.from_numpy(lg), k)) - want) \
            <= 1e-6 * want
    for n_tok, d_model, E, k, cf in [(64, 16, 8, 2, 1.5), (8192, 768, 8, 1, 1.25),
                                     (1024, 768, 8, 1, 1.25), (7, 3, 4, 1, 0.1)]:
        for ep in (1, 2, 4):
            for comm in WIRES:
                kw = dict(n_experts=E, top_k=k, capacity_factor=cf, ep=ep, comm_dtype=comm)
                assert pm.all_to_all_wire_bytes(n_tok, d_model, **kw) == \
                    R.all_to_all_wire_bytes(n_tok, d_model, **kw)
    uniform = torch.full((16, 4), 0.25)
    d, _ = pm.topk_gating(torch.eye(4).repeat(4, 1) * 5.0, 1, 16)
    assert abs(float(pm.load_balance_loss(uniform, d)) - 1.0) < 1e-6


def _ffn_data(E, D, H, N, seed):
    rs = np.random.RandomState(seed)
    return {"x": rs.normal(0, 1, (N, D)).astype(np.float32),
            "gate_w": rs.normal(0, 0.5, (D, E)).astype(np.float32),
            "w1": rs.normal(0, 0.3, (E, D, H)).astype(np.float32),
            "w2": rs.normal(0, 0.3, (E, H, D)).astype(np.float32),
            "c": rs.normal(0, 1, (N, D)).astype(np.float32)}


def _ffn_grads(R, jax, jnp, data, k, cf, dtype):
    """(y, dropped, grads) of sum(y * c) + aux_loss in the reference (jax.grad)
    and in the port (autograd), inputs in ``dtype``."""
    names = ("x", "gate_w", "w1", "w2")
    c = data["c"].astype(dtype)

    def ref_loss(x, gw, w1, w2):
        y, aux = R.moe_ffn(x, gw, w1, w2, top_k=k, capacity_factor=cf,
                           activation=jax.nn.gelu, return_aux=True)
        return jnp.sum(y * c) + aux["aux_loss"], (y, aux["dropped"])

    (_, (ry, rdrop)), rg = jax.value_and_grad(ref_loss, argnums=(0, 1, 2, 3), has_aux=True)(
        *(jnp.asarray(data[n].astype(dtype)) for n in names))
    ts = [torch.from_numpy(data[n].astype(dtype)).requires_grad_() for n in names]
    y, aux = pm.moe_ffn(*ts, top_k=k, capacity_factor=cf,
                        activation=lambda h: torch.nn.functional.gelu(h, approximate="tanh"),
                        return_aux=True)
    grads = torch.autograd.grad((y * torch.from_numpy(c)).sum() + aux["aux_loss"], ts)
    return ((np.asarray(ry), int(rdrop), [np.asarray(g) for g in rg]),
            (y.detach().numpy(), int(aux["dropped"]), [g.numpy() for g in grads]))


@pytest.mark.parametrize("k,cf", [(1, 1.25), (2, 0.75)], ids=["top1", "top2-overflow"])
def test_moe_ffn_and_gradients_match_reference(k, cf):
    """y and the gradients of sum(y * c) + aux_loss against jax.grad: in f64
    to 1e-10, and in f32 to TOL_FFN. At top-1 the normalized combine weight
    is g/g = 1, whose gradient is 0 but in f32 the rounding of 1/g - g/g^2;
    it dominates gate_w's small gradient in both packages (5e-5 of its max
    from the f64 value), so there the f32 gradient is held against the f64
    one at 1e-4."""
    import jax
    import jax.numpy as jnp
    from mxnet_tpu.parallel import moe as R
    data = _ffn_data(4, 16, 32, 48, seed=10 + k)
    with jax.enable_x64(True):
        (ry64, rd64, rg64), (y64, d64, g64) = _ffn_grads(R, jax, jnp, data, k, cf, np.float64)
    (ry, rdrop, rg), (y, drop, grads) = _ffn_grads(R, jax, jnp, data, k, cf, np.float32)
    assert drop == rdrop == d64 == rd64 and (k == 1 or rdrop > 0)
    assert _rel(y64, ry64) <= 1e-10 and _rel(y, ry) <= TOL_FFN
    for n, g, want, g_64, want64 in zip(("x", "gate_w", "w1", "w2"), grads, rg, g64, rg64):
        assert _rel(g_64, want64) <= 1e-10, n
        if k == 1 and n == "gate_w":
            assert _rel(g, want64) <= 1e-4
        else:
            assert _rel(g, want) <= TOL_FFN, n


@pytest.mark.parametrize("k,cf", [(1, 1.0), (2, 0.75)], ids=["top1", "top2-overflow"])
def test_indexed_dispatch_equals_einsum_form(k, cf):
    data = _ffn_data(8, 16, 32, 64, seed=20 + k)
    args = [torch.from_numpy(data[n]) for n in ("x", "gate_w", "w1", "w2")]
    got = pm.moe_ffn(*args, top_k=k, capacity_factor=cf).numpy()
    want = pm._einsum_ffn(*args, top_k=k, capacity_factor=cf).numpy()
    if k == 1:
        np.testing.assert_array_equal(got, want)
    else:
        assert _rel(got, want) <= ULP2


def rank_moe(workdir):
    """One of 4 ranks of an ep=4 mesh: each wire's exchange, its round trip
    and its gradient on this rank's block, then each EP_CASES layer on this
    rank's token shard (outputs and gradients, gate_w's summed over ep)."""
    mesh = make_mesh({"ep": EP}, devices=[mt.cpu()])
    r = mesh.axis_index("ep")
    data = dict(np.load(f"{workdir}/moe.npz"))
    out = {"wire": {}, "layer": {}}
    rows = WIRE_SHAPE[0] // EP
    for comm in WIRES:
        x = torch.from_numpy(data["wire_x"][r * rows:(r + 1) * rows]).requires_grad_()
        c = torch.from_numpy(data["wire_c"][r * rows:(r + 1) * rows])
        once = pm.wire_all_to_all(x, "ep", comm, mesh)
        back = pm.wire_all_to_all(once, "ep", comm, mesh)
        (g,) = torch.autograd.grad((once * c).sum(), x)
        mirror = pm.wire_all_to_all(c, "ep", comm, mesh)
        out["wire"][str(comm)] = {"once": once.detach().numpy().tolist(),
                                  "back": back.detach().numpy().tolist(),
                                  "grad_is_mirror": bool(torch.equal(g, mirror))}
    for name, E, D, H, N, k, cf in EP_CASES:
        el, nl = E // EP, N // EP
        ts = [torch.from_numpy(data[f"{name}_{n}"][sl]).requires_grad_() for n, sl in
              (("x", slice(r * nl, (r + 1) * nl)), ("gate_w", slice(None)),
               ("w1", slice(r * el, (r + 1) * el)), ("w2", slice(r * el, (r + 1) * el)))]
        y = pm.expert_parallel_moe(*ts, axis_name="ep", top_k=k, capacity_factor=cf,
                                   mesh=mesh)
        c = torch.from_numpy(data[f"{name}_c"][r * nl:(r + 1) * nl])
        grads = list(torch.autograd.grad((y * c).sum(), ts))
        torch.distributed.all_reduce(grads[1], group=mesh.group("ep"))
        out["layer"][name] = {"y": y.detach().numpy().tolist(),
                              "grads": [g.numpy().tolist() for g in grads]}
    out["modules"] = sorted(m for m in sys.modules
                            if m.split(".")[0] in ("jax", "jaxlib", "mxnet_tpu"))
    return out


@pytest.fixture(scope="module")
def ep_runs(tmp_path_factory):
    """The reference's exchanges and layers under shard_map on 4 CPU
    devices, and the port's 4 ranks (one spawn)."""
    import jax
    import jax.numpy as jnp
    from mxnet_tpu.parallel import moe as R
    from mxnet_tpu.parallel.mesh import make_mesh as ref_mesh, P as RP
    from mxnet_tpu.parallel.zero import shard_map_compat
    rs = np.random.RandomState(30)
    data = {"wire_x": rs.normal(0, 1, WIRE_SHAPE).astype(np.float32),
            "wire_c": rs.normal(0, 1, WIRE_SHAPE).astype(np.float32)}
    for name, E, D, H, N, k, cf in EP_CASES:
        data.update({f"{name}_{n}": v for n, v in _ffn_data(E, D, H, N, seed=31).items()})
    mesh = ref_mesh({"ep": EP}, devices=jax.devices("cpu")[:EP])
    ref = {"wire": {}, "layer": {}}
    for comm in WIRES:
        once = shard_map_compat(lambda t, comm=comm: R.wire_all_to_all(t, "ep", comm), mesh,
                                in_specs=(RP("ep"),), out_specs=RP("ep"))
        ref["wire"][str(comm)] = np.asarray(jax.jit(once)(jnp.asarray(data["wire_x"])))
    for name, E, D, H, N, k, cf in EP_CASES:
        def body(x, gw, w1, w2, k=k, cf=cf):
            return R.expert_parallel_moe(x, gw, w1, w2, axis_name="ep", top_k=k,
                                         capacity_factor=cf)
        fn = shard_map_compat(body, mesh, in_specs=(RP("ep", None), RP(None, None),
                                                    RP("ep", None, None), RP("ep", None, None)),
                              out_specs=RP("ep", None))
        args = [jnp.asarray(data[f"{name}_{n}"]) for n in ("x", "gate_w", "w1", "w2")]
        y, vjp = jax.vjp(jax.jit(fn), *args)
        ref["layer"][name] = {"y": np.asarray(y),
                              "grads": [np.asarray(g) for g in
                                        vjp(jnp.asarray(data[f"{name}_c"]))]}
    root = tmp_path_factory.mktemp("moe")
    np.savez(root / "moe.npz", **data)
    ranks = _dist_util.launch_local(f"{MODULE}:rank_moe", EP, {"workdir": str(root)},
                                    device="cpu", timeout=180, pythonpath=[TESTS_DIR],
                                    workdir=str(root / "launch"))
    return {"data": data, "ref": ref, "ranks": ranks}


@pytest.mark.parametrize("comm", WIRES, ids=[str(c) for c in WIRES])
def test_wire_all_to_all_matches_reference(ep_runs, comm):
    """The exchanged blocks bitwise the reference's (the same bf16 rounding
    and int8 scale and rounding), the gradient the mirror exchange, and two
    exchanges the identity (up to the wire's rounding)."""
    want = ep_runs["ref"]["wire"][str(comm)]
    x = ep_runs["data"]["wire_x"]
    rows = WIRE_SHAPE[0] // EP
    for r, rank in enumerate(ep_runs["ranks"]):
        got = rank["wire"][str(comm)]
        np.testing.assert_array_equal(np.asarray(got["once"], np.float32),
                                      want[r * rows:(r + 1) * rows])
        assert got["grad_is_mirror"]
        tol = 0.0 if comm is None else (0.08 if comm == "int8" else 0.04)
        np.testing.assert_allclose(np.asarray(got["back"], np.float32),
                                   x[r * rows:(r + 1) * rows], atol=tol)


@pytest.mark.parametrize("case", EP_CASES, ids=[c[0] for c in EP_CASES])
def test_expert_parallel_moe_matches_reference(ep_runs, case):
    """Each rank's output rows and its gradients (x's rows, the summed
    gate_w, its experts' w1/w2) against the reference's, and the output
    against the single-shard moe_ffn on the rank's tokens (the reference's
    claim, tests/test_recipes.py:192)."""
    name, E, D, H, N, k, cf = case
    want = ep_runs["ref"]["layer"][name]
    data = ep_runs["data"]
    el, nl = E // EP, N // EP
    for r, rank in enumerate(ep_runs["ranks"]):
        got = rank["layer"][name]
        y = np.asarray(got["y"], np.float32)
        assert _rel(y, want["y"][r * nl:(r + 1) * nl]) <= TOL_EP
        local = pm.moe_ffn(torch.from_numpy(data[f"{name}_x"][r * nl:(r + 1) * nl]),
                           *(torch.from_numpy(data[f"{name}_{n}"]) for n in
                             ("gate_w", "w1", "w2")), top_k=k, capacity_factor=cf).numpy()
        np.testing.assert_allclose(y, local, rtol=TOL_EP, atol=TOL_EP)
        sl = [slice(r * nl, (r + 1) * nl), slice(None), slice(r * el, (r + 1) * el),
              slice(r * el, (r + 1) * el)]
        grads = [np.asarray(g, np.float32) for g in got["grads"]]
        for n, g, w, s in zip(("x", "gate_w", "w1", "w2"), grads, want["grads"], sl):
            if k == 1 and n == "gate_w":
                # d(g/g) = 0: both packages give f32 rounding, far below x's gradient
                assert np.abs(g).max() <= 1e-5 * np.abs(grads[0]).max()
                continue
            assert _rel(g, w[s]) <= TOL_EP, (name, n, r)
    assert all(rank["modules"] == [] for rank in ep_runs["ranks"])


def test_wire_refusals_and_contexts():
    with pytest.raises(mt.MXNetError, match="mesh of torch.distributed ranks"):
        pm.wire_all_to_all(torch.zeros(1, 2), "ep")
    with pytest.raises(mt.MXNetError, match="unsupported comm_dtype"):
        pm._wire_exchange(torch.zeros(1, 2), None, 1, "float8")
    assert pm.current_expert_axis() is None
    with pm.expert_axis("ep", "int8"):
        assert (pm.current_expert_axis().axis_name, pm.current_expert_axis().comm_dtype) \
            == ("ep", "int8")
    assert pm.current_expert_axis() is None
    with pm.collect_metrics() as mc:
        assert float(mc.aux_loss()) == 0.0 and int(mc.dropped_total()) == 0
        pm.report_metrics({"aux_loss": torch.tensor(1.5), "dropped": torch.tensor(2)})
        pm.report_metrics({"aux_loss": torch.tensor(0.5), "dropped": torch.tensor(1)})
    assert float(mc.aux_loss()) == 2.0 and int(mc.dropped_total()) == 3
    pm.report_metrics({"aux_loss": torch.tensor(9.0), "dropped": torch.tensor(9)})
    assert len(mc.aux_losses) == 2             # no collector open: dropped


# -- on the card -----------------------------------------------------------------------

@pytest.mark.gpu
def test_gating_and_ffn_on_the_card_match_the_cpu():
    """All-tied logits break toward the lower index on the card too (argmax
    for k = 1, a stable sort for k = 2); moe_ffn on the card against the
    CPU, f32 with TF32 off, 1e-5 of max."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    for k in (1, 2):
        tied = torch.zeros(4096, 8)
        d_cpu, _ = pm.topk_gating(tied, k, 4096)
        d_gpu, _ = pm.topk_gating(tied.cuda(), k, 4096)
        assert torch.equal(d_gpu.cpu(), d_cpu)
        assert (d_cpu.sum(2)[:, :k] == 1).all()
    data = _ffn_data(8, 64, 128, 2048, seed=40)
    args = [torch.from_numpy(data[n]) for n in ("x", "gate_w", "w1", "w2")]
    cpu = pm.moe_ffn(*args, top_k=1, capacity_factor=1.25)
    gpu = pm.moe_ffn(*(a.cuda() for a in args), top_k=1, capacity_factor=1.25)
    assert _rel(gpu.cpu().numpy(), cpu.numpy()) <= TOL_FFN
