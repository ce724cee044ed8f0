"""The port's MoE recipe against the reference's, on the CPU.

The model is the recipe's tiny preset (``moe_transformer_tiny``: 2 layers,
units 64, hidden 128, 2 heads) with vocab 64, 4 experts, top-1, capacity
factor 2, weights from ``convert.seeded_params`` loaded into both packages;
batches (B, T) = (8, 8) of tokens from a numpy seed; Adam lr 1e-2 (1e-3 on
the ranks), aux weight 1e-2.

- ``MoETransformerLM``: logits against the reference's, and the gradient of
  the token cross entropy plus the weighted aux loss against ``jax.grad``
  through the reference's ``_make_apply_fn`` (its eager tape does not see
  through the MoE cell); the registry, the parameter paths and tags,
  ``pipeline_split``'s shared blocks, and the refusals
  (``tests/test_recipes.py:337-350``).
- ``MoETrainer`` on ``{dp: 1, ep: 1}`` (a mesh of one device): 10 losses
  against the reference's trainer; with E = 1 against the dense oracle
  through ``DataParallelTrainer(zero_update=True)`` (aux weight 0).
- 4 gloo ranks (one spawn): ``{dp: 2, ep: 2}`` against the reference's
  trainer on the same layout of 4 CPU devices, and against ``{dp: 4, ep:
  1}`` (the same 4 token shards, so the same gating); each step's routing
  compared first; a snapshot after step 2 on dp2 x ep2 resumed on dp1 x ep4
  through ``resume_or_init``: ``"resharded"``, step 3 against the
  uninterrupted run's.
- A MoE snapshot written by the reference's trainer resumed in the port, and
  the reverse.

Tolerances (f32): losses 1e-5 relative, weights 2e-5 absolute after 3 steps
(``tests/test_torch_dist_data_parallel.py``'s), logits 1e-5 of their max,
gradients 1e-5 of each tensor's max; gate_w's, where top-1's normalized
combine weight g/g contributes only f32 rounding to a small aux gradient,
1e-3. The 10-step trajectories: 1e-5 relative. The resume: 1e-5 relative
(``__graft_entry__.py:237``).
"""
import sys

import numpy as np
import pytest
import torch

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import _dist_util, elastic
from mxnet_tpu_torch.convert import gather_params, load_jax_params, seeded_params
from mxnet_tpu_torch.elastic import state as es
from mxnet_tpu_torch.parallel import DataParallelTrainer, Mesh, P, make_mesh
from mxnet_tpu_torch.parallel import moe as pm
from mxnet_tpu_torch.recipes import get_recipe, list_recipes
from mxnet_tpu_torch.recipes import moe as rm
from torch_threads import one_torch_thread  # noqa: F401

VOCAB, E, TOPK, CF = 64, 4, 1, 2.0
B, T = 8, 8
LR, LR_RANKS = 1e-2, 1e-3
STEPS, STEPS_RANKS = 10, 3
TOL_LOSS = 1e-5
TOL_W = 2e-5
TOL_LOGITS = 1e-5
TOL_GRAD = 1e-5
TOL_GATE_GRAD = 1e-3
TOL_RESUME = 1e-5
MODULE = "test_torch_moe_recipe"
TESTS_DIR = str(__import__("pathlib").Path(__file__).resolve().parent)


def _rel(got, want):
    return float(np.abs(np.asarray(got) - want).max()) / max(float(np.abs(want).max()), 1e-30)


def _batch(seed):
    rs = np.random.RandomState(seed)
    return (rs.randint(0, VOCAB, size=(B, T)).astype(np.int32),
            rs.randint(0, VOCAB, size=(B, T)).astype(np.int32))


def _model(weights, ctx=None, num_experts=E, dense=False):
    net = rm.make_model(VOCAB, num_experts=num_experts, top_k=TOPK, capacity_factor=CF,
                        dense_ffn=dense, ctx=ctx or mt.cpu())
    load_jax_params(net, weights)
    return net


@pytest.fixture(scope="module")
def weights():
    return seeded_params(rm.make_model(VOCAB, num_experts=E, top_k=TOPK, capacity_factor=CF,
                                       ctx=mt.cpu()), seed=3)


def _ref_model(weights, num_experts=E, dense=False):
    import mxnet_tpu as mx
    from mxnet_tpu.recipes import moe as rrm
    net = rrm.make_model(VOCAB, num_experts=num_experts, top_k=TOPK, capacity_factor=CF,
                         dense_ffn=dense, ctx=mx.cpu())
    for key, p in net._collect_params_with_prefix().items():
        p.set_data(mx.nd.array(weights[key], ctx=mx.cpu()))
    return net


def _ref_mesh(axes):
    import jax
    from mxnet_tpu.parallel.mesh import make_mesh as ref_mesh
    n = int(np.prod(list(axes.values())))
    return ref_mesh(axes, devices=jax.devices("cpu")[:n])


def _xy(x, y, ctx=None):
    ctx = ctx or mt.cpu()
    return mt.nd.array(x, ctx=ctx, dtype="int32"), mt.nd.array(y, ctx=ctx, dtype="int32")


def _one_device():
    return make_mesh({"dp": 1, "ep": 1}, devices=[mt.cpu()])


# -- the model ------------------------------------------------------------------------

def test_registry_paths_and_refusals(weights):
    assert list_recipes() == ["moe", "long_context"]
    r = get_recipe("moe")
    assert (r.name, r.build_model, r.build_trainer) == ("moe", rm.make_model, rm.make_trainer)
    assert r.build_oracle.keywords == {"dense_ffn": True}
    with pytest.raises(KeyError):
        get_recipe("nope")
    with pytest.raises(TypeError):
        rm.make_model(VOCAB, units=768, ctx=mt.cpu())
    net = _model(weights)
    assert list(net._collect_params_with_prefix()) == list(_ref_model(weights)
                                                           ._collect_params_with_prefix())
    tagged = sorted(k for k, p in net._collect_params_with_prefix().items()
                    if getattr(p, "_is_moe_expert", False))
    assert tagged == [f"cells.{i}.moe.{w}" for i in range(2) for w in ("w1", "w2")]
    # pipeline_split (refused until the pipeline took this model): wrappers
    # over the model's own blocks, the same Parameters and the same logits
    embed, cells, head = net.pipeline_split()
    shared = {id(p) for p in net.collect_params().values()}
    split = [p for b in (embed, head, *cells) for p in b.collect_params().values()]
    assert len(split) == len(shared) and all(id(p) in shared for p in split)
    tokens = mt.nd.array(np.arange(B * T).reshape(B, T) % VOCAB, ctx=mt.cpu(), dtype="int32")
    h = embed(tokens)
    for c in cells:
        h = c(h)
    torch.testing.assert_close(head(h)._data, net(tokens)._data, rtol=0, atol=0)
    dense = mt.gluon.nn.Dense(4, in_units=3)
    dense.initialize(ctx=mt.cpu())
    with pytest.raises(mt.MXNetError, match="_is_moe_expert"):
        rm.MoETrainer(dense, rm.token_cross_entropy, mesh=_one_device())
    with pytest.raises(mt.MXNetError, match="divisible"):
        rm.MoETrainer(_model(weights), rm.token_cross_entropy,
                      mesh=Mesh([mt.cpu()], ("dp", "ep"), (1, 8)))
    net = _model(weights)
    net.cells[0].attn.qkv.weight.sharding = P("tp", None)
    with pytest.raises(mt.MXNetError, match="shards only expert parameters"):
        rm.make_trainer(net, make_mesh({"dp": 1, "ep": 1, "tp": 1}, devices=[mt.cpu()]))
    with pytest.raises(mt.MXNetError, match="no 'ep' axis"):
        rm.make_trainer(_model(weights), make_mesh({"dp": 1}, devices=[mt.cpu()]))


def test_lm_forward_and_gradient_match_reference(weights):
    """Logits, and the gradient of the token cross entropy plus 1e-2 times
    the aux loss, by autograd against the reference's jax.grad through
    ``_make_apply_fn``."""
    import jax
    import jax.numpy as jnp
    import mxnet_tpu as mx
    from mxnet_tpu.parallel import moe as R
    from mxnet_tpu.parallel.data_parallel import _make_apply_fn
    from mxnet_tpu.recipes import moe as rrm
    x, y = _batch(5)
    rnet = _ref_model(weights)
    want_logits = rnet(mx.nd.array(x, dtype="int32")).asnumpy()
    paths = list(rnet._collect_params_with_prefix())
    plist = [rnet._collect_params_with_prefix()[k] for k in paths]
    apply_fn = _make_apply_fn(rnet, plist, train=True)

    def ref_loss(ps):
        with R.collect_metrics() as mc:
            out = apply_fn(jnp.zeros((2,), jnp.uint32), ps, jnp.asarray(x))[0]
        return rrm.token_cross_entropy(out, jnp.asarray(y)) + 1e-2 * mc.aux_loss()

    ref_grads = dict(zip(paths, jax.grad(ref_loss)([p.data()._data for p in plist])))
    net = _model(weights)
    params = net._collect_params_with_prefix()
    with torch.enable_grad(), mt.autograd.record(), pm.collect_metrics() as mc:
        logits = net(mt.nd.array(x, ctx=mt.cpu(), dtype="int32"))._data
        loss = rm.token_cross_entropy(logits, torch.from_numpy(y)) + 1e-2 * mc.aux_loss()
        grads = torch.autograd.grad(loss, [p._param for p in params.values()])
    assert len(mc.aux_losses) == 2 and [a.shape for a in mc.assignments] == [(B * T, 1)] * 2
    assert _rel(logits.detach().numpy(), want_logits) <= TOL_LOGITS
    for (key, _), g in zip(params.items(), grads):
        tol = TOL_GATE_GRAD if key.endswith("gate_w") else TOL_GRAD
        assert _rel(g.numpy(), np.asarray(ref_grads[key])) <= tol, key


def test_trainer_one_device_matches_reference_10_steps(weights):
    """MoETrainer on {dp: 1, ep: 1} (one device: moe_ffn, one K5-style update
    over every parameter) against the reference's: 10 losses, the weights,
    and the dropped count (the drain books it)."""
    import mxnet_tpu as mx
    from mxnet_tpu.recipes import moe as rrm
    x, y = _batch(7)
    rtr = rrm.make_trainer(_ref_model(weights), _ref_mesh({"dp": 1, "ep": 1}),
                           learning_rate=LR)
    want = [float(rtr.step(mx.nd.array(x, dtype="int32"), mx.nd.array(y, dtype="int32")))
            for _ in range(STEPS)]
    net = _model(weights)
    tr = rm.make_trainer(net, _one_device(), learning_rate=LR)
    got = [float(tr.step(*_xy(x, y))) for _ in range(STEPS)]
    np.testing.assert_allclose(got, want, rtol=TOL_LOSS)
    assert got[-1] < got[0]
    assert len(tr._groups) == 1 and not tr._zero_buckets
    assert tr._program.label == "moe.step[MoETransformerLM]"
    assert tr._program.key_base[-1] == ("moe", "ep", 1, 1e-2, None)
    tr.drain()
    assert tr.dropped_tokens == tr.global_dropped_tokens() >= 0


def test_e1_matches_dense_oracle_10_steps(weights):
    """E = 1, top-1: the normalized combine weight is exactly 1, so the MoE
    trainer (aux weight 0) follows the dense oracle's DataParallelTrainer."""
    w1 = seeded_params(rm.make_model(VOCAB, num_experts=1, top_k=1, ctx=mt.cpu()), seed=4)
    x, y = _batch(8)
    moe = rm.MoETrainer(_model(w1, num_experts=1), rm.token_cross_entropy, "adam",
                        {"learning_rate": LR}, mesh=_one_device(), aux_loss_weight=0.0)
    dense = DataParallelTrainer(_model(w1, num_experts=1, dense=True), rm.token_cross_entropy,
                                "adam", {"learning_rate": LR},
                                mesh=make_mesh({"dp": 1}, devices=[mt.cpu()]),
                                zero_update=True)
    la = [float(moe.step(*_xy(x, y))) for _ in range(STEPS)]
    lb = [float(dense.step(*_xy(x, y))) for _ in range(STEPS)]
    np.testing.assert_allclose(la, lb, rtol=TOL_LOSS)
    assert la[-1] < la[0]


# -- ranks ----------------------------------------------------------------------------------

def _rank_run(axes, weights, x, y, steps, snapshot=None):
    """MoETrainer on ``axes``: losses, each step's routing, the gathered
    weights; with ``snapshot`` a directory, a snapshot after step 2."""
    mesh = make_mesh(axes, devices=[mt.cpu()])
    net = _model(weights)
    tr = rm.make_trainer(net, mesh, learning_rate=LR_RANKS)
    out = {"losses": [], "routes": [], "local": list(tr._local(tr._raw(x)).shape)}
    for i in range(steps):
        out["losses"].append(float(tr.step(*_xy(x, y))))
        out["routes"].append([a.reshape(-1).tolist() for a in tr.last_assignments])
        if snapshot and i == 1:
            elastic.save_trainer(elastic.SnapshotManager(snapshot), tr, wait=True)
    out["dropped"] = tr.global_dropped_tokens()
    out["a2a"] = list(tr._a2a_step_bytes(x.shape))
    out["experts_local"] = list(net.cells[0].moe.w1._param.shape)
    out["buckets"] = [list(a) for a in tr._bucket_axes]
    return out, gather_params(net)


def rank_moe_recipe(workdir):
    """One of 4 ranks: dp2 x ep2 (snapshot after step 2), dp4 x ep1, and
    dp1 x ep4 resumed from the snapshot."""
    weights = dict(np.load(f"{workdir}/weights.npz"))
    data = np.load(f"{workdir}/data.npz")
    x, y = data["x"], data["y"]
    out = {}
    for axes, snap in (({"dp": 2, "ep": 2}, f"{workdir}/snap"), ({"dp": 4, "ep": 1}, None)):
        key = f"dp{axes['dp']}ep{axes['ep']}"
        out[key], params = _rank_run(axes, weights, x, y, STEPS_RANKS, snap)
        if torch.distributed.get_rank() == 0:
            np.savez(f"{workdir}/{key}.npz", **params)
    mesh = make_mesh({"dp": 1, "ep": 4}, devices=[mt.cpu()])

    def rebuild():
        mt.random.seed(99)
        return rm.make_trainer(rm.make_model(VOCAB, num_experts=E, top_k=TOPK,
                                             capacity_factor=CF, ctx=mt.cpu()),
                               mesh, learning_rate=LR_RANKS)
    _, tr, start, outcome = elastic.resume_or_init(f"{workdir}/snap", rebuild)
    out["resume"] = {"start": start, "outcome": outcome,
                     "loss": float(tr.step(*_xy(x, y))),
                     "experts_local": list(tr.net.cells[0].moe.w1._param.shape)}
    out["modules"] = sorted(m for m in sys.modules
                            if m.split(".")[0] in ("jax", "jaxlib", "mxnet_tpu"))
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, weights):
    """The reference's dp2 x ep2 trainer on 4 CPU devices; the port's 4 ranks."""
    import mxnet_tpu as mx
    from mxnet_tpu.recipes import moe as rrm
    x, y = _batch(9)
    net = _ref_model(weights)
    tr = rrm.make_trainer(net, _ref_mesh({"dp": 2, "ep": 2}), learning_rate=LR_RANKS)
    ref_losses = [float(tr.step(mx.nd.array(x, dtype="int32"), mx.nd.array(y, dtype="int32")))
                  for _ in range(STEPS_RANKS)]
    tr.sync()
    ref_params = {k: p.data().asnumpy() for k, p in net._collect_params_with_prefix().items()}
    root = tmp_path_factory.mktemp("moe_recipe")
    np.savez(root / "weights.npz", **weights)
    np.savez(root / "data.npz", x=x, y=y)
    out = _dist_util.launch_local(f"{MODULE}:rank_moe_recipe", 4, {"workdir": str(root)},
                                  device="cpu", timeout=240, pythonpath=[TESTS_DIR],
                                  workdir=str(root / "launch"))
    params = {k: dict(np.load(root / f"{k}.npz")) for k in ("dp2ep2", "dp4ep1")}
    return {"ranks": out, "ref_losses": ref_losses, "ref_params": ref_params,
            "params": params, "x": x}


def test_dp2_ep2_matches_reference(ranks):
    for rank in ranks["ranks"]:
        np.testing.assert_allclose(rank["dp2ep2"]["losses"], ranks["ref_losses"],
                                   rtol=TOL_LOSS)
        assert rank["dp2ep2"]["local"] == [B // 4, T]
        assert rank["dp2ep2"]["experts_local"] == [E // 2, 64, 128]
    for key, w in ranks["ref_params"].items():
        assert np.abs(ranks["params"]["dp2ep2"][key] - w).max() <= TOL_W, key


def test_ep_is_a_layout(ranks):
    """dp2 x ep2 against dp4 x ep1: each rank gates the same token shard, so
    the routing of every step is the same (compared first), then the losses
    and the weights."""
    for rank in ranks["ranks"]:
        a, b = rank["dp2ep2"], rank["dp4ep1"]
        flips = sum(int(np.sum(np.asarray(ra) != np.asarray(rb)))
                    for sa, sb in zip(a["routes"], b["routes"]) for ra, rb in zip(sa, sb))
        assert flips == 0
        np.testing.assert_allclose(a["losses"], b["losses"], rtol=TOL_LOSS)
        assert a["dropped"] == b["dropped"]
    for key, w in ranks["params"]["dp4ep1"].items():
        assert np.abs(ranks["params"]["dp2ep2"][key] - w).max() <= TOL_W, key


def test_ep_reshard_resume(ranks):
    for rank in ranks["ranks"]:
        res = rank["resume"]
        assert (res["start"], res["outcome"]) == (2, "resharded")
        assert res["experts_local"] == [1, 64, 128]
        want = rank["dp2ep2"]["losses"][2]
        assert abs(res["loss"] - want) <= TOL_RESUME * abs(want)


def test_ranks_accounting_and_isolation(ranks):
    """The expert buckets are summed over dp only, the others over both
    axes; the all-to-all bytes are the reference's formula; no rank loaded
    jax or the reference."""
    from mxnet_tpu.parallel import moe as R
    for rank in ranks["ranks"]:
        run = rank["dp2ep2"]
        assert {tuple(a) for a in run["buckets"]} == {("dp",)}
        per = R.all_to_all_wire_bytes(B * T // 4, 64, n_experts=E, top_k=TOPK,
                                      capacity_factor=CF, ep=2)
        assert run["a2a"] == [2 * 4 * per, 2 * 4]
        assert rank["dp4ep1"]["a2a"] == [0, 8]
        assert rank["modules"] == []


# -- snapshots across the packages ------------------------------------------------------

def test_reference_moe_snapshot_resumes_in_the_port(tmp_path, weights):
    import mxnet_tpu as mx
    from mxnet_tpu import elastic as ref_elastic
    from mxnet_tpu.recipes import moe as rrm
    x, y = _batch(11)
    rtr = rrm.make_trainer(_ref_model(weights), _ref_mesh({"dp": 1, "ep": 1}),
                           learning_rate=LR)
    xr, yr = mx.nd.array(x, dtype="int32"), mx.nd.array(y, dtype="int32")
    for _ in range(3):
        rtr.step(xr, yr)
    ref_elastic.save_trainer(ref_elastic.SnapshotManager(str(tmp_path)), rtr, wait=True)
    want = [float(rtr.step(xr, yr)) for _ in range(3)]
    mt.random.seed(5)
    tr = rm.make_trainer(rm.make_model(VOCAB, num_experts=E, top_k=TOPK, capacity_factor=CF,
                                       ctx=mt.cpu()), _one_device(), learning_rate=LR)
    with elastic.SnapshotReader(str(tmp_path), 3) as rd:
        assert {f"opt.x{i}.{k}" for i, p in enumerate(tr._plist)
                if getattr(p, "_is_moe_expert", False) for k in (0, 1)} <= rd.names
        es.install(tr, rd.manifest["meta"], rd, rd.names - {"rng"})
    got = [float(tr.step(*_xy(x, y))) for _ in range(3)]
    np.testing.assert_allclose(got, want, rtol=TOL_LOSS)


def test_port_moe_snapshot_resumes_in_the_reference(tmp_path, weights):
    import mxnet_tpu as mx
    from mxnet_tpu import elastic as ref_elastic
    from mxnet_tpu.recipes import moe as rrm
    x, y = _batch(12)
    tr = rm.make_trainer(_model(weights), _one_device(), learning_rate=LR)
    for _ in range(3):
        tr.step(*_xy(x, y))
    elastic.save_trainer(elastic.SnapshotManager(str(tmp_path)), tr, wait=True)
    want = [float(tr.step(*_xy(x, y))) for _ in range(3)]
    mx.random.seed(5)
    rtr = rrm.make_trainer(rrm.make_model(VOCAB, num_experts=E, top_k=TOPK,
                                          capacity_factor=CF, ctx=mx.cpu()),
                           _ref_mesh({"dp": 1, "ep": 1}), learning_rate=LR)
    man = ref_elastic.manifest.load(str(tmp_path), 3)
    with ref_elastic.SnapshotReader(str(tmp_path), 3) as rd:
        ref_elastic.install(rtr, man["meta"], rd, set(rd.names) - {"rng"})
    got = [float(rtr.step(mx.nd.array(x, dtype="int32"), mx.nd.array(y, dtype="int32")))
           for _ in range(3)]
    np.testing.assert_allclose(got, want, rtol=TOL_LOSS)
