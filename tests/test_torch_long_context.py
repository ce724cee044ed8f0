"""The port's long-context recipe against the reference's, on the CPU.

- ``ring_attention`` (causal and not, over sp 2 and 4) and
  ``ulysses_attention`` (sp 2): outputs and the gradients of q, k and v
  against the reference's under ``shard_map`` on conftest's virtual CPU
  devices. The port runs as 4 ranks of ``torch.distributed`` over gloo
  (``_dist_util.launch_local``), each holding its contiguous sequence chunk;
  on the CPU each hop runs the kernels' plain versions through the same hop
  structure as on the card.
- ``LongContextLM`` (2 layers, units 32, 2 heads of 16, vocab 64, T = 256):
  its flash path against the reference's and against its own dense oracle.
- ``LongContextTrainer`` at dp2 x sp2 (B = 4, T = 64, Adam lr 1e-3, 3
  steps): losses and weights against the reference's trainer on the same
  layout, the reduced gradients after step 1 against the reference's
  gradient of the same loss, and the port's dp1 x sp4 against its dp4 x sp1
  (the reference's ``tests/test_recipes.py:396`` claim: sequence sharding is
  a layout, not a model change).
- ``TokenWindows``; ``make_feed`` gives a ``DeviceFeed`` of its batches
  (``tests/test_torch_async_feed.py`` holds it against the reference); the
  registry lists both recipes; the ranks load neither jax nor the reference.

Tolerances (float32; only the order of summation differs, plus the ring's
merge of per-hop (O, LSE) against the reference's running (num, den, max)):
attention outputs 1e-5 and gradients 1e-4 of each tensor's max; logits
1e-5 of their max against the reference and against the dense oracle;
trajectories as ``tests/test_torch_dist_data_parallel.py``: loss 1e-5
relative, weights 2e-5 absolute, gradients 1e-4 of each tensor's max.
"""
import sys

import numpy as np
import pytest
import torch

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import _dist_util
from mxnet_tpu_torch.convert import gather_params, load_jax_params, seeded_params
from mxnet_tpu_torch.ops.attention import ring_attention, ulysses_attention
from mxnet_tpu_torch.parallel import make_mesh
from mxnet_tpu_torch.recipes import get_recipe, list_recipes
from mxnet_tpu_torch.recipes import long_context as lc
from torch_threads import one_torch_thread  # noqa: F401

CFG = dict(num_layers=2, units=32, hidden_size=64, num_heads=2)
VOCAB = 64
B, T = 4, 64
MAXLEN = 256            # every model's max_length (position table rows)
STEPS = 3
LR = 1e-3
TOL_ATT = 1e-5
TOL_ATT_GRAD = 1e-4
TOL_LOGITS = 1e-5
TOL_LOSS = 1e-5
TOL_W = 2e-5
TOL_GRAD = 1e-4
MODULE = "test_torch_long_context"
TESTS_DIR = str(__import__("pathlib").Path(__file__).resolve().parent)
# (name, mesh axes, the attention's axis size): ring over sp of dp2 x sp2 and of sp4
ATT_CASES = [("ring", 2, False), ("ring", 2, True), ("ring", 4, False), ("ring", 4, True),
             ("ulysses", 2, False), ("ulysses", 2, True)]
AB, AH, AT, AD = 2, 4, 64, 16


def _att_data(seed=2):
    rs = np.random.RandomState(seed)
    return {k: rs.standard_normal((AB, AH, AT, AD)).astype(np.float32)
            for k in ("q", "k", "v", "do")}


def _rel(got, want):
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()), 1e-30)


def _trainer_run(net, mesh, x, y, steps, grads_after_first=False):
    tr = lc.make_trainer(net, mesh, learning_rate=LR)
    losses, grads = [], None
    for i in range(steps):
        losses.append(float(tr.step(x, y)))
        if i == 0 and grads_after_first:
            grads = {k: g.numpy() for k, g in tr.gathered_grads().items()}
    return losses, grads, tr


def rank_long_context(workdir):
    """One of 4 ranks: the attention cases, the dp2 x sp2 trajectory, and the
    dp1 x sp4 and dp4 x sp1 trajectories."""
    ctx = mt.cpu()
    att = dict(np.load(f"{workdir}/att.npz"))
    out = {"att": {}}
    meshes = {2: make_mesh({"dp": 2, "sp": 2}, devices=[ctx]),
              4: make_mesh({"sp": 4}, devices=[ctx])}
    for name, n, causal in ATT_CASES:
        mesh = meshes[n]
        s = mesh.axis_index("sp")
        q, k, v, do = (torch.from_numpy(att[key].reshape(AB, AH, n, AT // n, AD)[:, :, s])
                       .requires_grad_(key != "do") for key in ("q", "k", "v", "do"))
        if name == "ring":
            o = ring_attention(q, k, v, "sp", causal=causal, mesh=mesh)
        else:
            o = ulysses_attention(q, k, v, "sp", causal=causal, mesh=mesh)
        dq, dk, dv = torch.autograd.grad(o, (q, k, v), do)
        out["att"][f"{name}{n}{causal}"] = {
            "sp": s, "o": o.detach().numpy().tolist(), "dq": dq.numpy().tolist(),
            "dk": dk.numpy().tolist(), "dv": dv.numpy().tolist()}

    weights = dict(np.load(f"{workdir}/weights.npz"))
    data = np.load(f"{workdir}/data.npz")
    x = mt.nd.array(data["x"], ctx=ctx, dtype="int32")
    y = mt.nd.array(data["y"], ctx=ctx, dtype="int32")

    def model():
        net = lc.make_model(VOCAB, seq_len=MAXLEN, ctx=ctx, **CFG)
        load_jax_params(net, weights)
        return net

    net = model()
    losses, grads, tr = _trainer_run(net, meshes[2], x, y, STEPS, grads_after_first=True)
    params = gather_params(net)
    if meshes[2].rank == 0:
        np.savez(f"{workdir}/grads.npz", **grads)
        np.savez(f"{workdir}/params.npz", **params)
    out["dp2sp2"] = {"losses": losses, "coords": dict(meshes[2].coords),
                     "local": list(tr._local(tr._raw(x)).shape),
                     "ring_bytes": tr._ring_step_bytes((B, T))[0]}
    for axes in ({"dp": 1, "sp": 4}, {"dp": 4, "sp": 1}):
        net = model()
        losses, _, _ = _trainer_run(net, make_mesh(axes, devices=[ctx]), x, y, STEPS)
        params = gather_params(net)
        key = f"dp{axes['dp']}sp{axes['sp']}"
        if meshes[2].rank == 0:
            np.savez(f"{workdir}/{key}_params.npz", **params)
        out[key] = {"losses": losses}
    out["p2p"] = dict(_dist_util.p2p_stats)
    out["modules"] = sorted(m for m in sys.modules
                            if m.split(".")[0] in ("jax", "jaxlib", "mxnet_tpu"))
    return out


@pytest.fixture(scope="module")
def weights():
    net = lc.LongContextLM(VOCAB, max_length=MAXLEN, **CFG)
    net.initialize(ctx=mt.cpu())
    return seeded_params(net, seed=6)


def _ref_model(weights):
    import mxnet_tpu as mx
    from mxnet_tpu.recipes import long_context as rlc
    net = rlc.make_model(VOCAB, seq_len=MAXLEN, ctx=mx.cpu(), **CFG)
    for key, p in net._collect_params_with_prefix().items():
        p.set_data(mx.nd.array(weights[key], ctx=mx.cpu()))
    return net


@pytest.fixture(scope="module")
def runs(tmp_path_factory, weights):
    """The reference's attention cases under shard_map, its dp2 x sp2
    trajectory and full-batch gradient; the port's 4 ranks (one spawn)."""
    import jax
    import jax.numpy as jnp
    import mxnet_tpu as mx
    from mxnet_tpu.ops.attention import ring_attention as ref_ring, \
        ulysses_attention as ref_ulysses
    from mxnet_tpu.parallel.mesh import make_mesh as ref_mesh, P as RP
    from mxnet_tpu.parallel.zero import shard_map_compat
    from mxnet_tpu.recipes import long_context as rlc

    att = _att_data()
    ref_att = {}
    for name, n, causal in ATT_CASES:
        mesh = ref_mesh({"sp": n}, devices=jax.devices("cpu")[:n])
        fn = ref_ring if name == "ring" else ref_ulysses
        spec = RP(None, None, "sp", None)
        body = shard_map_compat(lambda q, k, v, fn=fn, causal=causal: fn(q, k, v, "sp",
                                                                         causal=causal),
                                mesh, in_specs=(spec,) * 3, out_specs=spec)
        q, k, v, do = (jnp.asarray(att[key]) for key in ("q", "k", "v", "do"))
        o, vjp = jax.vjp(jax.jit(body), q, k, v)
        ref_att[f"{name}{n}{causal}"] = dict(zip(("o", "dq", "dk", "dv"),
                                                 (np.asarray(a) for a in (o, *vjp(do)))))

    rs = np.random.RandomState(8)
    x = rs.randint(0, VOCAB, size=(B, T)).astype(np.int32)
    y = rs.randint(0, VOCAB, size=(B, T)).astype(np.int32)
    xr, yr = mx.nd.array(x, dtype="int32"), mx.nd.array(y, dtype="int32")
    # the reference's gradient of the batch's mean token cross entropy, by
    # jax.grad through the functional forward its trainers differentiate
    # (its eager tape does not reach through RingSelfAttention's raw arrays)
    from mxnet_tpu.parallel.data_parallel import _make_apply_fn
    net = _ref_model(weights)
    paths = list(net._collect_params_with_prefix())
    plist = [net._collect_params_with_prefix()[k] for k in paths]
    apply_fn = _make_apply_fn(net, plist, train=True)
    key = jnp.zeros((2,), jnp.uint32)
    g = jax.grad(lambda ps: rlc.token_cross_entropy(apply_fn(key, ps, jnp.asarray(x))[0],
                                                    jnp.asarray(y)))(
        [p.data()._data for p in plist])
    ref_grads = {k: np.asarray(a) for k, a in zip(paths, g)}
    net = _ref_model(weights)
    tr = rlc.make_trainer(net, ref_mesh({"dp": 2, "sp": 2}, devices=jax.devices("cpu")[:4]),
                          learning_rate=LR)
    ref_losses = [float(tr.step(xr, yr)) for _ in range(STEPS)]
    tr.sync()
    ref_params = {k: p.data().asnumpy() for k, p in net._collect_params_with_prefix().items()}

    root = tmp_path_factory.mktemp("lc")
    np.savez(root / "att.npz", **att)
    np.savez(root / "weights.npz", **weights)
    np.savez(root / "data.npz", x=x, y=y)
    ranks = _dist_util.launch_local(f"{MODULE}:rank_long_context", 4, {"workdir": str(root)},
                                    device="cpu", timeout=180, pythonpath=[TESTS_DIR],
                                    workdir=str(root / "launch"))
    files = {k: dict(np.load(root / f"{k}.npz"))
             for k in ("grads", "params", "dp1sp4_params", "dp4sp1_params")}
    return {"att": att, "ref_att": ref_att, "ref_losses": np.array(ref_losses),
            "ref_params": ref_params, "ref_grads": ref_grads, "ranks": ranks, **files}


@pytest.mark.parametrize("name,n,causal", ATT_CASES,
                         ids=[f"{a}-sp{n}-{'causal' if c else 'full'}" for a, n, c in ATT_CASES])
def test_sequence_parallel_attention_matches_reference(runs, name, n, causal):
    """Each rank's chunk of the output and of dq, dk, dv against the
    reference's under shard_map."""
    want = runs["ref_att"][f"{name}{n}{causal}"]
    for rank in runs["ranks"]:
        got = rank["att"][f"{name}{n}{causal}"]
        s = got["sp"]
        for key in ("o", "dq", "dk", "dv"):
            ref = want[key].reshape(AB, AH, n, AT // n, AD)[:, :, s]
            tol = TOL_ATT if key == "o" else TOL_ATT_GRAD
            assert _rel(np.asarray(got[key], np.float32), ref) <= tol, (key, s)


def test_long_context_lm_matches_reference_and_dense_oracle(weights):
    """The flash path (on the CPU the kernels' plain versions, in the
    reference its blockwise fallback) against the reference's logits, and
    against the port's own dense O(T^2) oracle with the same weights."""
    import mxnet_tpu as mx
    x = np.random.RandomState(14).randint(0, VOCAB, size=(2, MAXLEN)).astype(np.int32)
    want = _ref_model(weights)(mx.nd.array(x, dtype="int32")).asnumpy()
    nets = {}
    for dense in (False, True):
        nets[dense] = lc.make_model(VOCAB, seq_len=MAXLEN, dense_attention=dense,
                                    ctx=mt.cpu(), **CFG)
        load_jax_params(nets[dense], weights)
    got = nets[False](mt.nd.array(x, ctx=mt.cpu(), dtype="int32")).asnumpy()
    dense = nets[True](mt.nd.array(x, ctx=mt.cpu(), dtype="int32")).asnumpy()
    assert _rel(got, want) <= TOL_LOGITS
    assert _rel(got, dense) <= TOL_LOGITS


def test_trainer_dp2_sp2_matches_reference(runs):
    """Losses, the reduced gradients after step 1 and the weights after step
    3; each rank holds (B/2, T/2) tokens."""
    r = runs
    for rank in r["ranks"]:
        np.testing.assert_allclose(rank["dp2sp2"]["losses"], r["ref_losses"], rtol=TOL_LOSS)
        assert rank["dp2sp2"]["local"] == [B // 2, T // 2]
    assert r["ref_losses"][-1] < r["ref_losses"][0]
    assert set(r["grads"]) == set(r["ref_grads"])
    for key, g in r["ref_grads"].items():
        assert np.abs(r["grads"][key] - g).max() <= TOL_GRAD * max(float(np.abs(g).max()),
                                                                  1e-30), key
    for key, w in r["ref_params"].items():
        assert np.abs(r["params"][key] - w).max() <= TOL_W, key


def test_trainer_sp4_matches_sp1(runs):
    """dp1 x sp4 (ring over 4 chunks, global positions) against dp4 x sp1."""
    for rank in runs["ranks"]:
        np.testing.assert_allclose(rank["dp1sp4"]["losses"], rank["dp4sp1"]["losses"],
                                   rtol=TOL_LOSS)
    for key, w in runs["dp4sp1_params"].items():
        assert np.abs(runs["dp1sp4_params"][key] - w).max() <= TOL_W, key


def test_ranks_send_the_ring_and_load_no_reference(runs):
    """The ring sent K/V chunks point to point; no rank loaded jax or the
    reference; the reference's wire-byte estimate is the port's formula."""
    for rank in runs["ranks"]:
        assert rank["p2p"]["sends"] > 0 and rank["p2p"]["bytes"] > 0
        assert rank["modules"] == []
        # 2 cells, sp 2: 3 x 2 x (2 x (B/2 x T/2) tokens x 32 units x 4 B) x 1 hop
        assert rank["dp2sp2"]["ring_bytes"] == 3 * 2 * (2 * (B // 2) * (T // 2) * 32 * 4)


def test_token_windows_and_refusals(monkeypatch):
    toks = np.arange(0, 1000, dtype=np.int32)
    src = lc.TokenWindows(toks, batch_size=3, seq_len=8)
    assert len(src) == (1000 - 1) // 24
    batches = list(src)
    assert len(batches) == len(src)
    x0, y0 = batches[0]
    assert x0.shape == (3, 8) and y0.shape == (3, 8)
    np.testing.assert_array_equal(y0.ravel(), x0.ravel() + 1)
    with pytest.raises(mt.MXNetError, match="too short"):
        lc.TokenWindows(np.arange(5), batch_size=4, seq_len=8)
    net = lc.make_model(VOCAB, seq_len=8, ctx=mt.cpu(), **CFG)
    tr = lc.make_trainer(net, make_mesh({"dp": 1, "sp": 1}, devices=[mt.cpu()]))
    feed = lc.make_feed(src, tr)
    fx, fy = next(feed)
    feed.close()
    np.testing.assert_array_equal(fx.numpy(), x0)
    np.testing.assert_array_equal(fy.numpy(), y0)
    assert get_recipe("moe").name == "moe"
    assert list_recipes() == ["moe", "long_context"]
    assert get_recipe("long_context").build_trainer is lc.make_trainer
    assert lc.default_seq_len() == 32768
    monkeypatch.setenv("MXNET_TPU_LONG_CONTEXT_SEQ", "4096")
    assert lc.LongContextLM(32, num_layers=1, units=16, hidden_size=32,
                            num_heads=1)._max_length == 4096


def test_trainer_refuses_sharded_parameters():
    net = lc.make_model(VOCAB, seq_len=T, ctx=mt.cpu(), **CFG)
    net.cells[0].attn.qkv.weight.sharding = mt.parallel.P("tp", None)
    with pytest.raises(mt.MXNetError, match="replicated parameters"):
        lc.make_trainer(net, make_mesh({"dp": 1, "sp": 1, "tp": 1}, devices=[mt.cpu()]))


# -- on the card -----------------------------------------------------------------------

def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run on the card")
    return mt.gpu(0)


def _lm_step_on_the_card(cfg):
    """One forward and backward of a ``LongContextLM`` of ``cfg`` on the card
    against the CPU (plain versions): K1, K2 and K3 each launch once a layer
    with the causal mask; logits 1e-4 and gradients 1e-3 of their max (f32,
    TF32 off: cuBLAS and the 3xTF32 kernels against the CPU)."""
    gpu = _cuda()
    torch.backends.cuda.matmul.allow_tf32 = False
    from mxnet_tpu_torch.ops.cuda import flash_attention as fa
    x = np.random.RandomState(3).randint(0, VOCAB, size=(2, MAXLEN)).astype(np.int32)
    out = {}
    for ctx in (mt.cpu(), gpu):
        net = lc.make_model(VOCAB, seq_len=MAXLEN, ctx=ctx, **cfg)
        if ctx == mt.cpu():
            weights = seeded_params(net, seed=1)
        load_jax_params(net, weights)
        counters = (fa.flash_attention_fwd, fa.flash_attention_bwd_dq,
                    fa.flash_attention_bwd_dkv)
        before = [dict(c.launches_by_mask) for c in counters]
        params = [p._param for p in net.collect_params().values()]
        with torch.enable_grad(), mt.autograd.record():
            logits = net(mt.nd.array(x, ctx=ctx, dtype="int32"))._data
            grads = torch.autograd.grad(logits.float().square().mean(), params)
        out[ctx.device_type] = (logits.detach().cpu().numpy(),
                                [g.cpu().numpy() for g in grads])
        if ctx == gpu:
            for c, b in zip(counters, before):
                assert c.launches_by_mask.get("causal", 0) - b.get("causal", 0) \
                    == cfg["num_layers"]
                assert c.launches_by_mask.get("full", 0) == b.get("full", 0)
    assert _rel(out["gpu"][0], out["cpu"][0]) <= 1e-4
    for g, c in zip(out["gpu"][1], out["cpu"][1]):
        assert _rel(g, c) <= 1e-3


@pytest.mark.gpu
def test_lm_step_on_the_card_reaches_the_causal_kernels():
    """Head dim 32 (units 64, 2 heads): see ``_lm_step_on_the_card``."""
    _lm_step_on_the_card(dict(num_layers=2, units=64, hidden_size=128, num_heads=2))


@pytest.mark.gpu
def test_head_dim_16_matches_the_plain_versions_on_the_card():
    """The recipe's CPU test shape (units 32, 2 heads: head dim 16, which
    K1-K3 have instantiated since the D = 16 port) runs the kernels on the
    card and agrees with the plain versions on the CPU, as at head dim 32."""
    _lm_step_on_the_card(CFG)
