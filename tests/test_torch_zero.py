"""The port's sharded weight update (``parallel/zero.py``) against the reference's.

- The planner and its helpers equal the reference's: ``plan_buckets`` field
  by field (with and without ``boundaries``), ``flatten_bucket`` /
  ``unflatten_bucket`` / ``shard_slice`` / ``wd_vector``, the wire-byte
  estimators and ``canonical_comm_dtype``.
- ``reduce_scatter_bucket`` in the three wire dtypes and ``all_gather_bucket``
  on 2 and 4 ranks of ``torch.distributed`` over gloo (spawned by
  ``_dist_util.launch_local``) against the reference's under ``shard_map`` on
  conftest's virtual CPU devices, the same flat buckets on each rank.
- ``DataParallelTrainer(zero_update=True)`` on ``bert_tiny(vocab_size=512)``
  at dp2 (B = 4, T = 128, Adam lr 1e-3, 3 steps): its losses and weights
  against the reference's ``zero_update=True`` step, its reduced gradients
  after step 1 against the reference's gradient of the same loss, and
  against the port's own ``zero_update=False`` step; with bf16 and int8 on
  the wire against the port's replicated step; each rank's segments, its
  state bytes (about half the replicated step's) and ``state_dict``. And an
  MLP's SGD-momentum step (K4's rule) with two weight decays, sharded
  against replicated, on the 2 and 4 collective ranks.

Tolerances. Native wire, float32, where only the order of summation
differs: loss 1e-5 relative, weights 2e-5 absolute, gradients 1e-4 of each
tensor's max (as ``tests/test_torch_dist_data_parallel.py``); the native
sharded step against the port's replicated one, where the arithmetic is the
same (a sum of two ranks' gradients either way, the same elementwise Adam):
1e-7. Reduce-scatter against the reference: native and bf16 1e-6 of the
sum's max (the reduction order over 4 ranks may differ; bf16 chunks are
rounded identically), int8 the same plus one quantum (scale) where a value
lies on a rounding tie of the two programs' f32 division. Compressed
trajectories against the replicated step: the reduced gradients after
step 1 within the wire's quantum (``wire_ratio``: bf16 n 2^-8 of the
tensor's max, int8 n / 127 of the chunk's max, for n = 2 ranks; measured
0.41 / 0.40 of it; a half-batch or wrong-chunk fault reads 236 / 84);
losses within the reference's own bounds (``tests/test_zero_dp.py``), 2e-2
(bf16) and 5e-2 (int8) relative; the mean weight distance after 3 steps at
5e-3 (bf16) and 0.25 (int8) lr x steps, set from the readings 7e-4 and
0.12 (the faults above read 0.41 and 0.90). The largest distance is no
test: Adam moves an element whose gradient is mostly wire noise by about lr
a step either way.
"""
import sys

import numpy as np
import pytest
import torch

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import _dist_util
from mxnet_tpu_torch.convert import gather_params, load_jax_params, seeded_params
from mxnet_tpu_torch.models import bert_tiny
from mxnet_tpu_torch.parallel import DataParallelTrainer, make_mesh
from mxnet_tpu_torch.parallel import zero as zero_mod
from torch_threads import one_torch_thread  # noqa: F401

VOCAB = 512
B, T = 4, 128
STEPS = 3
LR = 1e-3
TOL_LOSS = 1e-5
TOL_W = 2e-5
TOL_GRAD = 1e-4
TOL_SAME = 1e-7
TOL_RS = 1e-6
TOL_COMPRESSED = {"bfloat16": 2e-2, "int8": 5e-2}
TOL_COMPRESSED_W = {"bfloat16": 5e-3, "int8": 0.25}
MODULE = "test_torch_zero"
TESTS_DIR = str(__import__("pathlib").Path(__file__).resolve().parent)
COMMS = [None, "bfloat16", "int8"]


def _loaded():
    return sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "mxnet_tpu"))


# -- the planner ------------------------------------------------------------------

PLAN_CASES = {
    "mixed": ([(0, (4, 3), "float32"), (1, (5,), "float32"), (2, (2, 2), "bfloat16"),
               (3, (100,), "float32"), (4, (), "float32"), (5, (7, 7), "bfloat16")],
              8, 64 * 4, None),
    "oversize": ([(0, (1000,), "float32"), (1, (2,), "float32")], 4, 128, None),
    "boundaries": ([(i, (3 + i, 2), "float32") for i in range(8)], 3, 1 << 20, [2, 5]),
    "one_rank": ([(i, (17,), "float32") for i in range(5)], 1, 40 * 4, [1]),
}


@pytest.mark.parametrize("case", list(PLAN_CASES))
def test_plan_buckets_equals_reference(case):
    import jax.numpy as jnp
    from mxnet_tpu.parallel import zero as ref
    entries, ndp, cap, bounds = PLAN_CASES[case]
    got = zero_mod.plan_buckets(entries, ndp, cap, boundaries=bounds)
    want = ref.plan_buckets([(i, s, jnp.dtype(d)) for i, s, d in entries], ndp, cap,
                            boundaries=bounds)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for field in ("dtype", "indices", "offsets", "sizes", "shapes", "padded_size",
                      "ndp", "used_size", "pad", "shard_size", "nbytes"):
            assert getattr(g, field) == getattr(w, field), (case, field)
    for comm in COMMS:
        for n in (1, 2, ndp):
            assert zero_mod.reduce_scatter_wire_bytes(got, n, comm) == \
                ref.reduce_scatter_wire_bytes(want, n, comm)
            assert zero_mod.all_gather_wire_bytes(got, n) == ref.all_gather_wire_bytes(want, n)


def test_flatten_unflatten_shard_wd_equal_reference():
    import jax.numpy as jnp
    from mxnet_tpu.parallel import zero as ref
    entries, ndp, cap, _ = PLAN_CASES["mixed"]
    f32 = [(i, s, d) for i, s, d in entries if d == "float32"]
    plan = zero_mod.plan_buckets(f32, ndp, cap)
    ref_plan = ref.plan_buckets([(i, s, jnp.float32) for i, s, _ in f32], ndp, cap)
    rs = np.random.RandomState(0)
    arrays = {i: rs.standard_normal(s).astype(np.float32) for i, s, _ in f32}
    wds = {i: 0.1 * i for i, _, _ in f32}
    for b, rb in zip(plan, ref_plan):
        flat = zero_mod.flatten_bucket(b, {i: torch.from_numpy(a) for i, a in arrays.items()})
        ref_flat = np.asarray(ref.flatten_bucket(rb, {i: jnp.asarray(a)
                                                      for i, a in arrays.items()}))
        np.testing.assert_array_equal(flat.numpy(), ref_flat)
        for (i, v), (j, rv) in zip(zero_mod.unflatten_bucket(b, flat),
                                   ref.unflatten_bucket(rb, jnp.asarray(ref_flat))):
            assert i == j
            np.testing.assert_array_equal(v.numpy(), np.asarray(rv))
            np.testing.assert_array_equal(v.numpy(), arrays[i])
        for pos in range(ndp):
            np.testing.assert_array_equal(zero_mod.shard_slice(b, flat, pos).numpy(),
                                          np.asarray(ref.shard_slice(rb, ref_flat, pos)))
        np.testing.assert_array_equal(zero_mod.wd_vector(b, wds), ref.wd_vector(rb, wds))
        assert not zero_mod.wd_vector(b, wds)[b.used_size:].any()     # the pad decays nothing


def test_canonical_comm_dtype_and_state_bytes():
    c = zero_mod.canonical_comm_dtype
    assert c(None) is None and c("") is None and c("float32") is None
    assert c("bf16") == "bfloat16" and c(torch.bfloat16) == "bfloat16" and c("int8") == "int8"
    with pytest.raises(mt.MXNetError, match="unsupported comm dtype"):
        c("int4")
    tree = [(torch.zeros(3, 4), torch.zeros(5, dtype=torch.bfloat16)), (), {"a": torch.zeros(2)}]
    assert zero_mod.per_replica_state_bytes(tree) == 48 + 10 + 8


# -- the collectives on ranks -------------------------------------------------------

def _buckets(n, seed=7):
    """Each rank's flat bucket of 24 n elements (a shard of 24 a rank), the
    first shard all zeros on every rank (the int8 path's scale of 1)."""
    rs = np.random.RandomState(seed)
    flats = rs.standard_normal((n, 24 * n)).astype(np.float32) * 3.0
    flats[:, :24] = 0.0                # chunk 0 is all zeros on every rank
    return flats


def rank_collectives(workdir, n):
    """One rank: its shard of the sum of every rank's bucket in each wire dtype,
    and the all-gather of its native shard."""
    mesh = make_mesh({"dp": n}, devices=[mt.cpu()])
    flat = torch.from_numpy(np.load(f"{workdir}/flats.npy")[mesh.rank])
    out = {}
    for comm in COMMS:
        out[str(comm)] = zero_mod.reduce_scatter_bucket(flat, "dp", n, comm, mesh).tolist()
    out["gather"] = zero_mod.all_gather_bucket(torch.tensor(out["None"]), "dp", mesh).tolist()
    out["sgd"] = _sgd_steps(mesh)
    out["modules"] = _loaded()
    return out


def _sgd_steps(mesh):
    """An MLP's 3 SGD-momentum steps, sharded and replicated, with weight
    decay on the weights and none on the biases (two launch groups), in
    buckets of 64 elements (shards cut inside parameters)."""
    from mxnet_tpu_torch.gluon import loss as gloss, nn
    rs = np.random.RandomState(3)
    x = mt.nd.array(rs.standard_normal((8, 12)).astype(np.float32), ctx=mt.cpu())
    y = mt.nd.array(rs.randint(0, 5, size=8).astype(np.int32), ctx=mt.cpu(), dtype="int32")
    out = {}
    for zero in (False, True):
        net = nn.HybridSequential()
        net.add(nn.Dense(16, in_units=12, activation="relu"), nn.Dense(5, in_units=16))
        net.initialize(ctx=mt.cpu())
        load_jax_params(net, seeded_params(net, seed=2))
        opt = mt.optimizer.create("sgd", learning_rate=0.1, momentum=0.9, wd=1e-3)
        names = list(net.collect_params())
        opt.set_wd_mult({i: 0.0 for i, n in enumerate(names) if n.endswith("bias")})
        tr = DataParallelTrainer(net, gloss.SoftmaxCrossEntropyLoss(), opt, mesh=mesh,
                                 zero_update=zero, bucket_bytes=64 * 4)
        losses = [float(tr.step(x, y)) for _ in range(STEPS)]
        out[str(zero)] = {"losses": losses,
                          "params": {k: v.tolist() for k, v in gather_params(net).items()},
                          "wds": sorted(set(tr._groups) | set(tr._segments))}
    return out


@pytest.fixture(scope="module", params=[2, 4], ids=["dp2", "dp4"])
def collectives(request, tmp_path_factory):
    import jax
    import jax.numpy as jnp
    from mxnet_tpu.parallel import zero as ref
    from mxnet_tpu.parallel.mesh import make_mesh as ref_mesh, P as RP
    n = request.param
    flats = _buckets(n)
    root = tmp_path_factory.mktemp(f"rs{n}")
    np.save(root / "flats.npy", flats)
    ranks = _dist_util.launch_local(f"{MODULE}:rank_collectives", n,
                                    {"workdir": str(root), "n": n}, device="cpu",
                                    timeout=120, pythonpath=[TESTS_DIR],
                                    workdir=str(root / "launch"))
    mesh = ref_mesh({"dp": n}, devices=jax.devices("cpu")[:n])
    want = {}
    for comm in COMMS:
        fn = ref.shard_map_compat(
            lambda f, comm=comm: ref.reduce_scatter_bucket(f[0], "dp", n, comm),
            mesh, in_specs=(RP("dp"),), out_specs=RP("dp"))
        want[str(comm)] = np.asarray(jax.jit(fn)(jnp.asarray(flats)))
    return n, flats, ranks, want


@pytest.mark.parametrize("comm", [str(c) for c in COMMS])
def test_reduce_scatter_bucket_matches_reference(collectives, comm):
    n, flats, ranks, want = collectives
    got = np.concatenate([np.asarray(r[comm], np.float32) for r in ranks])
    scale = float(np.abs(flats.sum(0)).max())
    tol = TOL_RS * scale
    if comm == "int8":      # one quantum where the two programs round a tie apart
        tol += float(np.abs(flats).max()) / 127.0
    assert np.abs(got - want[comm]).max() <= tol
    # and the sum itself, within the wire's rounding
    exact = flats.sum(0)
    bound = {"None": TOL_RS, "bfloat16": n * 2 ** -8, "int8": n / 127.0}[comm]
    assert np.abs(got - exact).max() <= bound * float(np.abs(flats).max()) + TOL_RS * scale
    assert not got[:24].any()          # an all-zero chunk stays zero (int8: scale 1)


def test_sharded_sgd_equals_replicated_with_two_wd_groups(collectives):
    """K4's rule over a shard cut at parameter boundaries, one launch for
    each weight decay: the sharded SGD-momentum step equals the replicated
    one (TOL_SAME) on every rank."""
    _, _, ranks, _ = collectives
    for r in ranks:
        rep, sharded = r["sgd"]["False"], r["sgd"]["True"]
        np.testing.assert_allclose(sharded["losses"], rep["losses"], rtol=TOL_SAME)
        for key, w in rep["params"].items():
            assert np.abs(np.asarray(sharded["params"][key]) - np.asarray(w)).max() \
                <= TOL_SAME, key
        assert sharded["wds"] == rep["wds"] == [0.0, 1e-3]
        assert rep["losses"][-1] < rep["losses"][0]


def test_all_gather_bucket_restores_the_rank_order(collectives):
    n, flats, ranks, _ = collectives
    full = np.concatenate([np.asarray(r["None"], np.float32) for r in ranks])
    for r in ranks:
        np.testing.assert_array_equal(np.asarray(r["gather"], np.float32), full)
        assert r["modules"] == []


# -- the sharded step ---------------------------------------------------------------------

def token_ce(logits, labels):
    logits = logits.float()
    return torch.nn.functional.cross_entropy(
        logits.reshape(-1, logits.shape[-1]), labels.reshape(-1).long(), reduction="none")


CONFIGS = {"zero": (True, None), "zero_bfloat16": (True, "bfloat16"),
           "zero_int8": (True, "int8"), "replicated": (False, None)}


def wire_chunks(tr):
    """Per parameter path, the wire chunk of each element: chunk j of bucket b
    (the slice of the flat bucket that rank j reduces) numbered across
    buckets. The int8 wire takes one scale per chunk and rank."""
    paths = {id(p): k for k, p in tr.net._collect_params_with_prefix().items()}
    out, base = {}, 0
    for b in tr._zero_plan:
        for i, o, n, shape in zip(b.indices, b.offsets, b.sizes, b.shapes):
            ids = base + (o + np.arange(n)) // b.shard_size
            out[paths[id(tr._plist[i])]] = ids.reshape(shape)
        base += b.ndp
    return out


def rank_zero_steps(workdir, steps, lr, bucket_bytes):
    """One rank at dp2: each configuration's ``steps`` steps from the same
    weights; rank 0 writes the reduced gradients after step 1 and the weights
    after the last step of each."""
    weights = dict(np.load(f"{workdir}/weights.npz"))
    data = np.load(f"{workdir}/data.npz")
    ctx = mt.cpu()
    mesh = make_mesh({"dp": 2}, devices=[ctx])
    x = mt.nd.array(data["x"], ctx=ctx, dtype="int32")
    y = mt.nd.array(data["y"], ctx=ctx, dtype="int32")
    out = {}
    for name, (zero, comm) in CONFIGS.items():
        net = bert_tiny(vocab_size=VOCAB)
        net.initialize(ctx=ctx)
        load_jax_params(net, weights)
        tr = DataParallelTrainer(net, token_ce, "adam", {"learning_rate": lr}, mesh=mesh,
                                 zero_update=zero, comm_dtype=comm, bucket_bytes=bucket_bytes)
        losses = []
        for i in range(steps):
            losses.append(float(tr.step(x, y)))
            if i == 0:
                grads = {k: g.numpy() for k, g in tr.gathered_grads().items()}
        params = gather_params(net)
        state = tr.state_dict()
        if mesh.rank == 0:
            if zero:
                np.savez(f"{workdir}/{name}_chunks.npz", **wire_chunks(tr))
            np.savez(f"{workdir}/{name}_grads.npz", **grads)
            np.savez(f"{workdir}/{name}_params.npz", **params)
            np.savez(f"{workdir}/{name}_state.npz",
                     **{f"{k}.{j}": s.numpy() for k, st in state["opt_state"].items()
                        for j, s in enumerate(st)})
        plan = [(b.padded_size, b.shard_size, len(b.indices)) for b in tr._zero_plan]
        segs = [[(i, lo, hi, off) for i, lo, hi, off in zb["segments"]]
                for zb in tr._zero_buckets]
        out[name] = {"losses": losses, "state_bytes": tr._opt_state_replica_bytes(),
                     "plan": plan, "segments": segs,
                     "sizes": [p._param.numel() for p in tr._plist],
                     "groups": {str(k): len(v) for k, v in tr._segments.items()}}
    out["modules"] = _loaded()
    out["rank"] = mesh.rank
    return out


@pytest.fixture(scope="module")
def zero_runs(tmp_path_factory):
    import jax
    import jax.numpy as jnp
    import mxnet_tpu as mx
    from mxnet_tpu.models import bert_tiny as ref_bert_tiny
    from mxnet_tpu.parallel import DataParallelTrainer as RefDPT, make_mesh as ref_mesh

    port = bert_tiny(vocab_size=VOCAB)
    port.initialize(ctx=mt.cpu())
    weights = seeded_params(port, seed=4)
    rs = np.random.RandomState(9)
    x = rs.randint(0, VOCAB, size=(B, T)).astype(np.int32)
    y = rs.randint(0, VOCAB, size=(B, T)).astype(np.int32)
    bucket_bytes = 1 << 20            # several buckets, some cut across parameters

    def loss_fn(logits, labels):
        logits = logits.astype(jnp.float32)
        logz = jax.nn.logsumexp(logits, axis=-1)
        gold = jnp.take_along_axis(logits, labels[..., None].astype(jnp.int32),
                                   axis=-1)[..., 0]
        return jnp.mean(logz - gold)

    def ref_net():
        net = ref_bert_tiny(vocab_size=VOCAB)
        net.initialize(ctx=mx.cpu())
        for key, p in net._collect_params_with_prefix().items():
            p.set_data(mx.nd.array(weights[key], ctx=mx.cpu()))
        return net

    net = ref_net()
    with mx.autograd.record():
        loss = mx.gluon.loss.SoftmaxCrossEntropyLoss()(
            net(mx.nd.array(x, dtype="int32")), mx.nd.array(y, dtype="int32")).mean()
    loss.backward()
    ref_grads = {k: p.grad().asnumpy() for k, p in net._collect_params_with_prefix().items()}
    net = ref_net()
    tr = RefDPT(net, loss_fn, optimizer="adam", optimizer_params={"learning_rate": LR},
                mesh=ref_mesh({"dp": 2}, devices=jax.devices("cpu")[:2]),
                zero_update=True, bucket_bytes=bucket_bytes)
    xr, yr = mx.nd.array(x, dtype="int32"), mx.nd.array(y, dtype="int32")
    ref_losses = [float(tr.step(xr, yr)) for _ in range(STEPS)]
    tr.sync()
    ref_params = {k: p.data().asnumpy() for k, p in net._collect_params_with_prefix().items()}
    ref_plan = [(b.padded_size, b.shard_size, len(b.indices)) for b in tr._zero_plan]

    root = tmp_path_factory.mktemp("zero")
    np.savez(root / "weights.npz", **weights)
    np.savez(root / "data.npz", x=x, y=y)
    ranks = _dist_util.launch_local(
        f"{MODULE}:rank_zero_steps", 2,
        {"workdir": str(root), "steps": STEPS, "lr": LR, "bucket_bytes": bucket_bytes},
        device="cpu", timeout=180, pythonpath=[TESTS_DIR], workdir=str(root / "launch"))
    files = {name: {kind: dict(np.load(root / f"{name}_{kind}.npz"))
                    for kind in ("grads", "params", "state", "chunks")
                    if (root / f"{name}_{kind}.npz").exists()} for name in CONFIGS}
    return {"ref_losses": np.array(ref_losses), "ref_params": ref_params,
            "ref_grads": ref_grads, "ref_plan": ref_plan, "ranks": ranks, "files": files}


def test_zero_step_matches_reference(zero_runs):
    """Losses and weights against the reference's sharded step; the reduced
    gradients after step 1 against the reference's gradient of the loss."""
    r = zero_runs
    for rank in r["ranks"]:
        np.testing.assert_allclose(rank["zero"]["losses"], r["ref_losses"], rtol=TOL_LOSS)
        assert rank["zero"]["plan"] == [list(b) for b in r["ref_plan"]]
    assert r["ref_losses"][-1] < r["ref_losses"][0]
    got = r["files"]["zero"]
    for key, w in r["ref_params"].items():
        assert np.abs(got["params"][key] - w).max() <= TOL_W, key
    for key, g in r["ref_grads"].items():
        scale = max(float(np.abs(g).max()), 1e-30)
        assert np.abs(got["grads"][key] - g).max() <= TOL_GRAD * scale, key


def test_zero_step_equals_replicated_step(zero_runs):
    """The native sharded step against the port's replicated one: losses,
    gradients, weights and the gathered Adam state."""
    f, ranks = zero_runs["files"], zero_runs["ranks"]
    for rank in ranks:
        np.testing.assert_allclose(rank["zero"]["losses"], rank["replicated"]["losses"],
                                   rtol=TOL_SAME)
    for kind in ("grads", "params", "state"):
        assert set(f["zero"][kind]) == set(f["replicated"][kind]), kind
        for key, a in f["replicated"][kind].items():
            assert np.abs(f["zero"][kind][key] - a).max() <= TOL_SAME, (kind, key)


def wire_ratio(comm, n, rep, got, chunks):
    """The largest of |got - rep| over the wire's quantum, element by element:
    bf16 n 2^-8 of the tensor's max (each rank's value rounded once to an
    8-bit significand), int8 n / 127 of its chunk's max (one scale, max /
    127, per chunk and rank; the rounding is half a scale)."""
    if comm == "int8":
        ids = np.concatenate([chunks[k].ravel() for k in rep])
        cmax = np.zeros(int(ids.max()) + 1)
        np.maximum.at(cmax, ids, np.concatenate([np.abs(rep[k]).ravel() for k in rep]))
    worst = 0.0
    for key, r in rep.items():
        quantum = (n / 127.0 * cmax[chunks[key]] if comm == "int8"
                   else n * 2.0 ** -8 * np.abs(r).max())
        worst = max(worst, float((np.abs(got[key] - r) / np.maximum(quantum, 1e-30)).max()))
    return worst


@pytest.mark.parametrize("comm", ["bfloat16", "int8"])
def test_compressed_wire_tracks_replicated(zero_runs, comm):
    """The reduced gradients after step 1 within the wire's quantum of the
    replicated step's (``wire_ratio`` <= 1); losses within the reference's
    bounds; the mean weight distance after 3 steps within TOL_COMPRESSED_W
    lr x steps."""
    f, ranks = zero_runs["files"], zero_runs["ranks"]
    rep, got = f["replicated"], f[f"zero_{comm}"]
    assert set(got["grads"]) == set(rep["grads"]) == set(got["chunks"])
    ratio = wire_ratio(comm, 2, rep["grads"], got["grads"], got["chunks"])
    dw = np.concatenate([np.abs(got["params"][k] - w).ravel()
                         for k, w in rep["params"].items()]).mean() / (LR * STEPS)
    assert ratio <= 1.0, ratio
    for rank in ranks:
        np.testing.assert_allclose(rank[f"zero_{comm}"]["losses"],
                                   rank["replicated"]["losses"], rtol=TOL_COMPRESSED[comm])
        assert rank[f"zero_{comm}"]["losses"][-1] < rank[f"zero_{comm}"]["losses"][0]
    assert dw <= TOL_COMPRESSED_W[comm], dw


def test_each_rank_updates_its_shard_only(zero_runs):
    """The two ranks' segments tile every bucket's used part exactly once,
    never the pad; one launch group (wd 0); each rank's optimizer state is
    about half the replicated step's."""
    ranks = sorted(zero_runs["ranks"], key=lambda r: r["rank"])
    z = [r["zero"] for r in ranks]
    sizes = z[0]["sizes"]
    for b, (padded, shard, _) in enumerate(z[0]["plan"]):
        covered = []
        for pos, rz in enumerate(z):
            for i, lo, hi, off in rz["segments"][b]:
                assert 0 <= lo < hi <= sizes[i] and 0 <= off and off + hi - lo <= shard
                covered.append((i, lo, hi))
        per_param = {}
        for i, lo, hi in covered:
            per_param.setdefault(i, []).append((lo, hi))
        for i, spans in per_param.items():
            spans.sort()
            assert spans[0][0] == 0 and spans[-1][1] == sizes[i]
            assert all(a[1] == b_[0] for a, b_ in zip(spans, spans[1:]))
    assert all(rz["groups"].keys() == {"0.0"} for rz in z)
    rep = ranks[0]["replicated"]["state_bytes"]
    for rz in z:
        assert 0.45 * rep <= rz["state_bytes"] <= 0.55 * rep
    assert all(r["modules"] == [] for r in ranks)
