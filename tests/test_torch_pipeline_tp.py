"""Tensor parallelism and ZeRO inside the port's pipeline stages, against the
reference, on the CPU.

The configuration is the reference's own (``tests/test_partitioned_tp.py``):
vocab 64, batch (8, 8), BERT with 4 layers, units 32, hidden 64, 2 heads (4
for the tp 4 reshard), SGD lr 0.5 (wd 0), the mean token cross entropy
(``recipes.long_context.token_cross_entropy``), M = 2; the weights come from
``convert.seeded_params`` into both packages, the batch from a numpy seed.

- One 4-rank gloo spawn against the reference's ``PipelineTrainer`` on CPU
  devices, 10 losses and the weights after ``sync()`` (two-rank meshes get a
  ``rep`` axis that carries no data, ``test_torch_pipeline.py``'s way):
  ``{pp: 2, tp: 2}`` partitioned (the reference's :111); ``{pp: 2, tp: 2}``
  weight-sharded under ``shard_params_megatron`` (``test_pipeline_1f1b.py``
  :247); ``{pp: 2, tp: 2}`` partitioned with sequence parallelism (:180);
  ``{pp: 1, tp: 2, dp: 2}`` partitioned with ZeRO (:141) in the native, bf16
  and int8 wires; ``{pp: 2, dp: 2}`` with ZeRO and Adam lr 1e-2
  (``test_pipeline_1f1b.py:228``); the counted collectives against the reference's
  estimates (:191, :212); at pp 1 a tp 2 snapshot of each package resumed
  on tp 4 in the port and in the reference (:254). On the ranks also:
  sequence parallelism against none with dropout 0.1, and no jax or
  reference module loaded.
- In one process: the plans of ``plan_cell`` (BERT, long context's
  ``_LCCell``, the MoE cell), ``plan_embed`` and ``plan_head`` and the view
  helpers against the reference's; ``vocab_parallel_cross_entropy`` at tp 1
  against the plain mean; the dropout masks of a sequence shard; the
  rejections of ``test_partitioned_tp.py:302-382`` and
  ``test_pipeline_1f1b.py:336``.
- On the card (gpu): ``cell_forward`` at BERT-base width with K1-K3 against
  the plain attention path.

Tolerances. f32 runs: losses 1e-5 relative, weights 2e-5 absolute
(``test_torch_pipeline.py``'s; only the order of summation differs;
readings on the CPU: losses 2.2e-7, weights 8.5e-7, 6.6e-6 for the Adam
run). The bf16 and int8 wires: the reference's own bar
(``test_partitioned_tp.py``: losses 5e-4 relative, weights 1e-3). Both
packages round the same chunks the same way, but a gradient that differs
in its last f32 bits (the order of summation) may round to the other bf16
neighbour, 2^-8 of itself, and lr 0.5 carries that into the weights:
readings bf16 3.8e-4 / 6.9e-4, int8 8.6e-8 / 1.2e-7 (its quantum, a
chunk's max / 127, is coarse enough that no element changed side). Under
ZeRO with int8 each tp rank's chunk scales differ, so the copies of a
replicated leaf drift apart across tp ranks; ``sync()`` keeps tp rank 0's,
as the reference's ``sync`` reads one copy. Sequence parallelism against
none with dropout: the first loss bitwise (the same dropout masks, the same
per-token arithmetic in the forward); after that the sums of a replicated
leaf's gradient split over the token shards round differently, so the 10
losses are held at 1e-5 relative and the weights at 2e-5. The resumed
runs: rtol 5e-4 (the reference's :254); across the packages and dp degrees
the ZeRO resumes at 1e-5.
"""
import os
import sys
import threading

import numpy as np
import pytest
import torch

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import _dist_util, elastic
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.convert import load_jax_params, seeded_params
from mxnet_tpu_torch.models import BertModel
from mxnet_tpu_torch.parallel import (PipelineTrainer, apply_rules, make_mesh, megatron,
                                      shard_params_megatron, shard_rules)
from mxnet_tpu_torch.recipes.long_context import token_cross_entropy
from torch_threads import one_torch_thread  # noqa: F401

V, B, T, M = 64, 8, 8, 2
CFG = dict(vocab_size=V, num_layers=4, units=32, hidden_size=64, num_heads=2,
           max_length=T, dropout=0.0)
CFG4 = dict(CFG, num_heads=4)
SGD = {"learning_rate": 0.5, "wd": 0.0}
STEPS = 10
SNAP_AT = 5                 # the ZeRO runs' snapshot step
TOL_LOSS, TOL_W = 1e-5, 2e-5
TOL_WIRE = {"bfloat16": (5e-4, 1e-3), "int8": (5e-4, 1e-3)}
TOL_RESUME = 5e-4
PART = dict(tp_axis="tp", tp_mode="partitioned")
# name -> (port mesh, reference mesh, trainer keywords, shard_params_megatron)
RUNS = {
    "part_tp2": ({"pp": 2, "tp": 2}, {"pp": 2, "tp": 2}, PART, False),
    "sharded_tp2": ({"pp": 2, "tp": 2}, {"pp": 2, "tp": 2}, dict(tp_axis="tp"), True),
    "part_sp": ({"pp": 2, "tp": 2}, {"pp": 2, "tp": 2}, dict(PART, sequence_parallel=True),
                False),
    "zero": ({"pp": 1, "tp": 2, "dp": 2}, {"pp": 1, "tp": 2, "dp": 2},
             dict(PART, dp_axis="dp", zero_update=True), False),
    "zero_bfloat16": ({"pp": 1, "tp": 2, "dp": 2}, {"pp": 1, "tp": 2, "dp": 2},
                      dict(PART, dp_axis="dp", zero_update=True, comm_dtype="bfloat16"), False),
    "zero_int8": ({"pp": 1, "tp": 2, "dp": 2}, {"pp": 1, "tp": 2, "dp": 2},
                  dict(PART, dp_axis="dp", zero_update=True, comm_dtype="int8"), False),
    # ZeRO over the stage buckets without tp, Adam (test_pipeline_1f1b.py:228)
    "zero_pp2_dp2": ({"pp": 2, "dp": 2}, {"pp": 2, "dp": 2},
                     dict(dp_axis="dp", zero_update=True, optimizer="adam",
                          optimizer_params={"learning_rate": 1e-2}), False),
}
MODULE = "test_torch_pipeline_tp"
TESTS_DIR = os.path.dirname(os.path.abspath(__file__))


def _batch():
    rs = np.random.RandomState(0)
    return (rs.randint(0, V, (B, T)).astype(np.int32),
            rs.randint(0, V, (B, T)).astype(np.int32))


def _net(weights, cfg=CFG, dropout=0.0):
    net = BertModel(**dict(cfg, dropout=dropout))
    net.initialize(ctx=mt.cpu())
    load_jax_params(net, weights)
    return net


def _xy():
    x, y = _batch()
    return (mt.nd.array(x, ctx=mt.cpu(), dtype="int32"),
            mt.nd.array(y, ctx=mt.cpu(), dtype="int32"))


def _params(net):
    return {k: p._param.detach().numpy().copy()
            for k, p in net._collect_params_with_prefix().items()}


def _trainer(net, axes, optimizer="sgd", optimizer_params=SGD, **kw):
    return PipelineTrainer(net, token_cross_entropy, optimizer, optimizer_params,
                           mesh=make_mesh(axes, devices=[mt.cpu()]), num_microbatch=M, **kw)


def _on_four(axes):
    """A mesh of 2 ranks runs on 4 with a leading ``rep`` axis."""
    n = int(np.prod(list(axes.values())))
    return axes if n == 4 else {"rep": 4 // n, **axes}


# -- the ranks -----------------------------------------------------------------------

def rank_pipeline_tp(workdir):
    """One of 4 ranks: each of RUNS, the dropout pair, the tp 4 resumes."""
    weights = dict(np.load(f"{workdir}/weights.npz"))
    weights4 = dict(np.load(f"{workdir}/weights4.npz"))
    x, y = _xy()
    rank = torch.distributed.get_rank()
    out = {"rank": rank}
    for name, (axes, _, kw, megatron_specs) in RUNS.items():
        net = _net(weights)
        if megatron_specs:
            shard_params_megatron(net, axis="tp")
        tr = _trainer(net, _on_four(axes), **kw)
        losses = []
        for i in range(STEPS):
            losses.append(float(tr.step(x, y)))
            if name == "zero" and i + 1 == SNAP_AT:
                elastic.save_trainer(elastic.SnapshotManager(f"{workdir}/port_zero"), tr,
                                     wait=True)
        comm = tr.last_stats["comm"]
        held = sum(lf.w.numel() for lf in tr._all_leaves())
        tr.sync()
        np.savez(f"{workdir}/{name}_w{rank}.npz", **_params(net))
        out[name] = {"losses": losses, "comm": comm, "stage": tr.stage, "held": held,
                     "estimate": tr.comm_estimate((B, T)), "groups": len(tr._groups)}
    # ZeRO snapshots: the reference's resumed here; the port's on dp 1
    _, axes, kw, _ = RUNS["zero"]
    for src, axes in (("ref_zero", axes), ("port_zero", {"rep": 2, **dict(axes, dp=1)})):
        mt.random.seed(5)
        fresh = BertModel(**CFG)
        fresh.initialize(ctx=mt.cpu())
        tr = _trainer(fresh, axes, **kw)
        with elastic.SnapshotReader(f"{workdir}/{src}", SNAP_AT) as rd:
            elastic.state.install(tr, rd.manifest["meta"], rd, rd.names - {"rng"})
        out[f"{src}_resumed"] = [float(tr.step(x, y)) for _ in range(STEPS - SNAP_AT)]
    # sequence parallelism against none, dropout 0.1, the same masks
    for name, sp in (("drop", False), ("drop_sp", True)):
        net = _net(weights, dropout=0.1)
        mt.random.seed(7)           # the same dropout seed for both trainers
        tr = _trainer(net, {"pp": 2, "tp": 2}, sequence_parallel=sp, **PART)
        out[name] = [float(tr.step(x, y)) for _ in range(STEPS)]
        tr.sync()
        np.savez(f"{workdir}/{name}_w{rank}.npz", **_params(net))
    # a tp 2 run of the port, saved at step 2, resumed on tp 4 here; the
    # reference's tp 2 snapshot resumed on tp 4
    tr = _trainer(_net(weights4, CFG4), _on_four({"pp": 1, "tp": 2}), **PART)
    for _ in range(2):
        tr.step(x, y)
    elastic.save_trainer(elastic.SnapshotManager(f"{workdir}/port"), tr, wait=True)
    out["tp2_next"] = [float(tr.step(x, y)) for _ in range(2)]
    for src in ("port", "ref"):
        mt.random.seed(5)
        fresh = BertModel(**CFG4)
        fresh.initialize(ctx=mt.cpu())
        tr4 = _trainer(fresh, {"pp": 1, "tp": 4}, **PART)
        with elastic.SnapshotReader(f"{workdir}/{src}", 2) as rd:
            elastic.state.install(tr4, rd.manifest["meta"], rd, rd.names - {"rng"})
        out[f"tp4_from_{src}"] = [float(tr4.step(x, y)) for _ in range(2)]
    out["modules"] = sorted(m for m in sys.modules
                            if m.split(".")[0] in ("jax", "jaxlib", "mxnet_tpu"))
    return out


# -- the reference ------------------------------------------------------------------------

def _ref_net(weights, cfg=CFG):
    import mxnet_tpu as mx
    from mxnet_tpu.models.bert import BertModel as RefBert
    net = RefBert(**cfg)
    net.initialize(ctx=mx.cpu())
    for key, p in net._collect_params_with_prefix().items():
        p.set_data(mx.nd.array(weights[key], ctx=mx.cpu()))
    return net


def _ref_trainer(net, axes, optimizer="sgd", optimizer_params=SGD, **kw):
    import jax
    from mxnet_tpu.parallel import PipelineTrainer as RefPipeline
    from mxnet_tpu.parallel import make_mesh as ref_mesh
    from mxnet_tpu.recipes.moe import token_cross_entropy as ref_loss
    n = int(np.prod(list(axes.values())))
    return RefPipeline(net, ref_loss, optimizer=optimizer,
                       optimizer_params=dict(optimizer_params),
                       mesh=ref_mesh(axes, devices=jax.devices("cpu")[:n]), num_microbatch=M,
                       schedule="1f1b", **kw)


def _ref_xy():
    import mxnet_tpu as mx
    x, y = _batch()
    return mx.nd.array(x, dtype="int32"), mx.nd.array(y, dtype="int32")


def _ref_runs(weights, names, root=None):
    """The reference trajectories of ``names``: losses, weights and the
    collectives its telemetry books for the last step; with ``root`` a
    snapshot after step SNAP_AT under ``root/ref_{name}``."""
    from mxnet_tpu import elastic as ref_elastic
    from mxnet_tpu import telemetry as telem
    from mxnet_tpu.parallel import shard_params_megatron as ref_megatron
    x, y = _ref_xy()
    out = {}
    telem.enable()
    try:
        for name in names:
            _, axes, kw, megatron_specs = RUNS[name]
            net = _ref_net(weights)
            if megatron_specs:
                ref_megatron(net, axis="tp")
            tr = _ref_trainer(net, axes, **kw)
            losses = []
            for i in range(STEPS):
                if i == STEPS - 1:
                    telem.reset()
                losses.append(float(tr.step(x, y)))
                if root is not None and i + 1 == SNAP_AT:
                    ref_elastic.save_trainer(ref_elastic.SnapshotManager(
                        str(root / f"ref_{name}")), tr, wait=True)
            calls = telem.get_metric("mx_comm_calls_total")
            nbytes = telem.get_metric("mx_comm_bytes_total")
            comm = {op: (calls.get(op, "mesh"), nbytes.get(op, "mesh"))
                    for op in ("tp_act_psum", "tp_act_all_gather", "tp_act_psum_scatter",
                               "tp_weight_all_gather", "reduce_scatter", "all_gather")}
            tr.sync()
            out[name] = (losses, {k: np.asarray(p.data().asnumpy())
                                  for k, p in net._collect_params_with_prefix().items()}, comm)
    finally:
        telem.disable()
    return out


def _ref_snapshot(weights4, root):
    """tp 2 at pp 1: the reference's snapshot after 2 steps (for the port's
    ranks) and its next 2 losses."""
    from mxnet_tpu import elastic as ref_elastic
    x, y = _ref_xy()
    tr = _ref_trainer(_ref_net(weights4, CFG4), {"pp": 1, "tp": 2}, **PART)
    for _ in range(2):
        tr.step(x, y)
    ref_elastic.save_trainer(ref_elastic.SnapshotManager(str(root / "ref")), tr, wait=True)
    return {"tp2_next": [float(tr.step(x, y)) for _ in range(2)]}


def _ref_from_port(root):
    """The port's tp 2 snapshot resumed by the reference on tp 4."""
    import mxnet_tpu as mx
    from mxnet_tpu import elastic as ref_elastic
    from mxnet_tpu.models.bert import BertModel as RefBert
    x, y = _ref_xy()
    mx.random.seed(6)
    net = RefBert(**CFG4)
    net.initialize(ctx=mx.cpu())
    net(x)
    tr = _ref_trainer(net, {"pp": 1, "tp": 4}, **PART)
    man = ref_elastic.manifest.load(str(root / "port"), 2)
    with ref_elastic.SnapshotReader(str(root / "port"), 2) as rd:
        ref_elastic.install(tr, man["meta"], rd, set(rd.names) - {"rng"})
    return [float(tr.step(x, y)) for _ in range(2)], man["meta"]


def _ref_zero_from_port(weights, root):
    """The port's ZeRO snapshot (step SNAP_AT) resumed by the reference."""
    from mxnet_tpu import elastic as ref_elastic
    x, y = _ref_xy()
    _, axes, kw, _ = RUNS["zero"]
    tr = _ref_trainer(_ref_net(weights), axes, **kw)
    man = ref_elastic.manifest.load(str(root / "port_zero"), SNAP_AT)
    with ref_elastic.SnapshotReader(str(root / "port_zero"), SNAP_AT) as rd:
        ref_elastic.install(tr, man["meta"], rd, set(rd.names) - {"rng"})
    return [float(tr.step(x, y)) for _ in range(STEPS - SNAP_AT)]


@pytest.fixture(scope="module")
def weights():
    return seeded_params(BertModel(**CFG), seed=3)


@pytest.fixture(scope="module")
def weights4():
    return seeded_params(BertModel(**CFG4), seed=4)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, weights, weights4):
    """The spawn runs in a thread while this process runs the reference;
    the ranks read the reference's tp 2 snapshot, written first."""
    root = tmp_path_factory.mktemp("pipeline_tp")
    np.savez(root / "weights.npz", **weights)
    np.savez(root / "weights4.npz", **weights4)
    ref = _ref_snapshot(weights4, root)
    ref.update(_ref_runs(weights, ["zero"], root))
    result = {}

    def spawn():
        try:
            result["ranks"] = _dist_util.launch_local(
                f"{MODULE}:rank_pipeline_tp", 4, {"workdir": str(root)}, device="cpu",
                timeout=300, pythonpath=[TESTS_DIR], workdir=str(root / "launch"))
        except Exception as e:          # re-raised in the test process below
            result["error"] = e
    thread = threading.Thread(target=spawn)
    thread.start()
    try:
        ref.update(_ref_runs(weights, [n for n in RUNS if n != "zero"]))
    finally:
        thread.join()
    if "error" in result:
        raise result["error"]
    ref["tp4_from_port"], ref["port_meta"] = _ref_from_port(root)
    ref["zero_from_port"] = _ref_zero_from_port(weights, root)
    files = {p.name[:-4]: dict(np.load(p)) for p in root.glob("*_w*.npz")}
    return {"ref": ref, "ranks": result["ranks"], "files": files}



def _close(got, want, tol, what):
    for key, w in want.items():
        err = np.abs(got[key] - w).max()
        assert err <= tol, (what, key, err)


@pytest.mark.parametrize("name", list(RUNS))
def test_ranks_match_reference(ranks, name):
    """Each composition's 10 losses and weights after ``sync()`` on every
    rank against the reference's trainer of the same mesh."""
    ref_losses, ref_w, _ = ranks["ref"][name]
    wire = name.partition("_")[2]
    tol_loss, tol_w = TOL_WIRE.get(wire, (TOL_LOSS, TOL_W))
    for rank in ranks["ranks"]:
        losses = rank[name]["losses"]
        np.testing.assert_allclose(losses, ref_losses, rtol=tol_loss)
        assert losses[-1] < losses[0]
        _close(ranks["files"][f"{name}_w{rank['rank']}"], ref_w, tol_w, (name, rank["rank"]))


def test_counted_collectives_against_reference(ranks):
    """The reference books M (4L + 2) activation all-reduces a step (L = 4
    layers over the stages), M (2L + 1) 2 all-gather/reduce-scatter pairs
    under sp, (tp - 1)/tp of one microbatch's activation each; the port counts
    the collectives it issued: summed over the two stages of a tp rank they
    are the reference's calls, their payload the reference's bytes times
    tp/(tp - 1). Partitioned tp gathers no weight; weight-sharded tp does.
    ZeRO: one reduce-scatter and one all-gather per bucket."""
    ref = ranks["ref"]
    by = {r["rank"]: r for r in ranks["ranks"]}

    def summed(name, op):
        tot = [0, 0]
        for r in by.values():
            if r[name]["stage"] is not None and r["rank"] % 2 == 0:     # tp rank 0
                c = r[name]["comm"].get(f"{op}@tp", {"calls": 0, "bytes": 0})
                tot[0] += c["calls"]
                tot[1] += c["bytes"]
        return tot
    calls, nbytes = summed("part_tp2", "act_all_reduce")
    assert (calls, nbytes // 2) == tuple(ref["part_tp2"][2]["tp_act_psum"])
    assert ref["part_tp2"][2]["tp_weight_all_gather"] == (0, 0)
    for r in by.values():
        assert tuple(r["part_tp2"]["estimate"]["tp_act_psum"]) == \
            tuple(ref["part_tp2"][2]["tp_act_psum"])
        assert not any(k.startswith(("tp_weight", "grad_all_reduce@tp+")) for k in r["part_tp2"]["comm"]
                       if "weight" in k)
    # an all-gather's payload is this rank's shard: (tp - 1) of it cross the wire
    for op, ref_op, wire in (("act_all_gather", "tp_act_all_gather", 1.0),
                             ("act_reduce_scatter", "tp_act_psum_scatter", 0.5)):
        calls, nbytes = summed("part_sp", op)
        assert (calls, nbytes * wire) == tuple(ref["part_sp"][2][ref_op]), op
    assert summed("part_sp", "act_all_reduce")[0] == 0
    calls, _ = summed("sharded_tp2", "tp_weight_all_gather")
    assert calls > 0 and ref["sharded_tp2"][2]["tp_weight_all_gather"][1] > 0
    assert tuple(by[0]["sharded_tp2"]["estimate"]["tp_weight_all_gather"]) == \
        tuple(ref["sharded_tp2"][2]["tp_weight_all_gather"])
    assert summed("sharded_tp2", "act_all_reduce") == [0, 0]
    for r in by.values():
        est = r["zero"]["estimate"]
        assert tuple(est["reduce_scatter"]) == tuple(ref["zero"][2]["reduce_scatter"])
        assert tuple(est["all_gather"]) == tuple(ref["zero"][2]["all_gather"])
        assert r["zero"]["comm"]["zero_reduce_scatter@dp"]["calls"] == ref["zero"][2]["reduce_scatter"][0]
        assert r["zero"]["comm"]["zero_all_gather@dp"]["calls"] == ref["zero"][2]["all_gather"][0]
        assert tuple(r["zero_int8"]["estimate"]["reduce_scatter"]) == \
            tuple(ref["zero_int8"][2]["reduce_scatter"])


def test_partitioned_leaves_halve(ranks):
    """A tp 2 rank holds half of each partitioned leaf: the sharded leaves'
    elements halve against the whole model's."""
    full = sum(np.prod(v.shape) for v in ranks["ref"]["part_tp2"][1].values())
    for r in ranks["ranks"]:
        assert r["part_tp2"]["held"] < 0.6 * full


def test_sequence_parallel_with_dropout(ranks):
    """sp and non-sp draw the same dropout masks: the first loss is the same
    bits; the trajectories agree to the f32 tolerances."""
    for rank in ranks["ranks"]:
        assert rank["drop"][0] == rank["drop_sp"][0]
        np.testing.assert_allclose(rank["drop_sp"], rank["drop"], rtol=TOL_LOSS)
        _close(ranks["files"][f"drop_sp_w{rank['rank']}"],
               ranks["files"][f"drop_w{rank['rank']}"], TOL_W, ("drop", rank["rank"]))
    # dropout on: the trajectory differs from the dropout-free one
    assert ranks["ranks"][0]["drop"][0] != ranks["ranks"][0]["part_tp2"]["losses"][0]


def test_tp2_snapshots_resume_on_tp4(ranks):
    """A tp 2 snapshot of either package resumes on tp 4 in the other (and the
    port's in the port) and continues the tp 2 trajectory."""
    ref = ranks["ref"]
    meta = ref["port_meta"]
    assert (meta["kind"], meta["tp_mode"], meta["tp_degree"]) == ("pp", "partitioned", 2)
    np.testing.assert_allclose(ref["tp4_from_port"], ranks["ranks"][0]["tp2_next"],
                               rtol=TOL_RESUME)
    for rank in ranks["ranks"]:
        np.testing.assert_allclose(rank["tp4_from_ref"], ref["tp2_next"], rtol=TOL_RESUME)
        np.testing.assert_allclose(rank["tp4_from_port"], rank["tp2_next"], rtol=TOL_RESUME)
        np.testing.assert_allclose(rank["tp2_next"], ref["tp2_next"], rtol=TOL_LOSS)


def test_zero_snapshots_across_packages_and_dp(ranks):
    """A ZeRO snapshot (partitioned tp 2, dp 2) of either package resumes in
    the other; the port's also on dp 1 (the lanes re-packed onto the new
    plan), each continuing the saved trajectory."""
    ref_losses = ranks["ref"]["zero"][0]
    for rank in ranks["ranks"]:
        port = rank["zero"]["losses"]
        np.testing.assert_allclose(rank["ref_zero_resumed"], ref_losses[SNAP_AT:], rtol=TOL_LOSS)
        np.testing.assert_allclose(rank["port_zero_resumed"], port[SNAP_AT:], rtol=TOL_LOSS)
        np.testing.assert_allclose(ranks["ref"]["zero_from_port"], port[SNAP_AT:],
                                   rtol=TOL_LOSS)


def test_ranks_load_neither_jax_nor_the_reference(ranks):
    assert all(rank["modules"] == [] for rank in ranks["ranks"])


# -- one process ---------------------------------------------------------------------

def _asdict(plan):
    import dataclasses
    return dataclasses.asdict(plan)


@pytest.mark.parametrize("kind", ["bert", "bert_head_major", "lc", "lc_dense", "moe"])
def test_plans_match_reference(kind):
    """plan_cell's roles and layouts equal the reference's on the same cell;
    plan_embed and plan_head on BERT's split."""
    from mxnet_tpu.parallel import megatron as ref_mg
    from mxnet_tpu_torch.models import bert as pb
    from mxnet_tpu_torch.models import moe_transformer as pm
    from mxnet_tpu_torch.recipes import long_context as plc
    from mxnet_tpu.models import bert as rb
    from mxnet_tpu.models import moe_transformer as rm
    from mxnet_tpu.recipes import long_context as rlc
    make = {
        "bert": lambda m: m.TransformerEncoderCell(32, 64, 4, 0.1),
        "bert_head_major": lambda m: m.TransformerEncoderCell(32, 64, 4, 0.1,
                                                              head_major_qkv=True),
        "lc": lambda m: m._LCCell(32, 64, 4),
        "lc_dense": lambda m: m._LCCell(32, 64, 4, dense_attention=True),
        "moe": lambda m: m.MoETransformerCell(32, 64, 4, 4),
    }[kind]
    mods = {"lc": (plc, rlc), "lc_dense": (plc, rlc), "moe": (pm, rm)}.get(kind, (pb, rb))
    port, ref = make(mods[0]), make(mods[1])
    for n_tp in (1, 2, 4):
        got = megatron.plan_cell(port, list(port.collect_params().values()), n_tp)
        want = ref_mg.plan_cell(ref, list(ref.collect_params().values()), n_tp)
        assert _asdict(got) == _asdict(want), (kind, n_tp)
    if kind == "bert":
        from mxnet_tpu_torch.models import BertModel as PB
        net, rnet = PB(**CFG), rb.BertModel(**CFG)
        (pe, _, ph), (re_, _, rh) = net.pipeline_split(), rnet.pipeline_split()
        for n_tp in (1, 2):
            for fn, a, b in ((megatron.plan_embed, pe, re_), (megatron.plan_head, ph, rh)):
                ref_fn = getattr(ref_mg, fn.__name__)
                assert _asdict(fn(a, list(a.collect_params().values()), n_tp)) == \
                    _asdict(ref_fn(b, list(b.collect_params().values()), n_tp))
        for layout in (None, (0, 1), (0, 3), (1, 1), (1, 3)):
            for shape in ((96, 32), (12, 96, 8)):
                if layout is not None and shape[layout[0]] % layout[1]:
                    continue
                assert megatron.view_shape(shape, layout) == ref_mg.view_shape(shape, layout)
            assert megatron.view_shard_dim(layout) == ref_mg.view_shard_dim(layout)


def test_plan_rejections():
    """The reference's refusals of a cell it cannot partition."""
    from mxnet_tpu_torch.models import bert as pb
    from mxnet_tpu_torch.models import moe_transformer as pm
    cell = pb.TransformerEncoderCell(32, 64, 2, fused_qkv=False)
    with pytest.raises(MXNetError, match="fused qkv"):
        megatron.plan_cell(cell, list(cell.collect_params().values()), 2)
    cell = pb.TransformerEncoderCell(32, 64, 2)
    with pytest.raises(MXNetError, match="heads"):
        megatron.plan_cell(cell, list(cell.collect_params().values()), 4)
    with pytest.raises(MXNetError, match="stage's parameter list"):
        megatron.plan_cell(cell, list(cell.collect_params().values())[1:], 1)
    cell = pm.MoETransformerCell(32, 64, 2, 4, dense_ffn=True)
    with pytest.raises(MXNetError, match="dense_ffn"):
        megatron.plan_cell(cell, list(cell.collect_params().values()), 2)
    cell = pm.MoETransformerCell(32, 64, 2, 3)
    with pytest.raises(MXNetError, match="MoE experts"):
        megatron.plan_cell(cell, list(cell.collect_params().values()), 2)


def test_vocab_parallel_cross_entropy_tp1():
    """At one rank the fused loss is the plain mean token cross entropy."""
    rs = np.random.RandomState(1)
    h = torch.tensor(rs.randn(2, 5, 16), dtype=torch.float32, requires_grad=True)
    w = torch.tensor(rs.randn(V, 16), dtype=torch.float32)
    b = torch.tensor(rs.randn(V), dtype=torch.float32)
    labels = torch.tensor(rs.randint(0, V, (2, 5)))
    got = megatron.vocab_parallel_cross_entropy(h, w, b, labels)
    want = token_cross_entropy(torch.nn.functional.linear(h, w, b), labels)
    torch.testing.assert_close(got, want.mean(), rtol=1e-6, atol=1e-6)
    g1, = torch.autograd.grad(got, h)
    g2, = torch.autograd.grad(want.mean(), h)
    torch.testing.assert_close(g1, g2, rtol=1e-5, atol=1e-7)


class _Coord:
    """A mesh's coordinate on the tp axis, for the dropout masks."""

    def __init__(self, r):
        self.r = r

    def axis_index(self, axis):
        return self.r


def test_dropout_masks_of_a_sequence_shard():
    """A token shard draws its slice of the full mask: the same elements
    bitwise, and a new key gives another mask."""
    x = torch.randn(2, 8, 4)
    key = (11, 3, 0, 0, 2, 1)
    full = megatron._dropout(x, key, 0.5, megatron.PartitionConfig("tp", 2), tuple(x.shape))
    for r in range(2):
        cfg = megatron.PartitionConfig("tp", 2, sp=True, mesh=_Coord(r))
        part = megatron._dropout(x[:, 4 * r:4 * r + 4], key, 0.5, cfg, tuple(x.shape))
        assert torch.equal(part, full[:, 4 * r:4 * r + 4])
    other = megatron._dropout(x, key[:-1] + (2,), 0.5, megatron.PartitionConfig("tp", 2),
                              tuple(x.shape))
    assert not torch.equal(other, full) and (full == 0).any()


def test_shard_rules_and_apply_rules():
    """The reference's :302-345: an unknown role, an axis the mesh lacks, the
    specs attached."""
    from mxnet_tpu_torch.parallel import Mesh, P
    with pytest.raises(MXNetError, match="unknown logical axis"):
        shard_rules({"head": "tp"})
    rules = shard_rules({"mlp": None, "seq": "sp"})
    assert rules["mlp"] is None and rules["seq"] == "sp" and rules["kv"] == "tp"
    net = BertModel(**CFG)
    with pytest.raises(MXNetError, match="does not exist"):
        apply_rules(net, mesh=Mesh([mt.cpu()], ("pp", "dp"), (2, 2)))
    silent = {"vocab": None, "heads": None, "kv": None, "joined_kv": None, "mlp": None,
              "seq": None, "batch": "dp"}
    assert apply_rules(net, rules=silent, mesh=Mesh([mt.cpu()], ("pp", "dp"), (2, 2))) == 0
    assert apply_rules(net, mesh=Mesh([mt.cpu()], ("dp", "tp", "sp"), (1, 2, 2))) > 0
    params = dict(net._collect_params_with_prefix())
    spec = {k.rpartition(".")[0].rpartition(".")[2] + "." + k.rpartition(".")[2]: p.sharding
            for k, p in params.items()}
    assert spec["qkv.weight"] == P("tp", None) and spec["proj.weight"] == P(None, "tp")
    assert params["word_embed.weight"].sharding == P("tp", None)


def test_config_rejections(weights):
    """The reference's refusals (``test_partitioned_tp.py:348-382``,
    ``test_pipeline_1f1b.py:336``) on a mesh of one process."""
    from mxnet_tpu_torch.parallel import Mesh
    net = _net(weights)
    mesh = Mesh([mt.cpu()], ("pp", "tp"), (2, 2))
    loss = token_cross_entropy
    with pytest.raises(MXNetError, match="tp_mode"):
        PipelineTrainer(net, loss, mesh=mesh, tp_axis="tp", tp_mode="interleaved")
    with pytest.raises(MXNetError, match="1F1B"):
        PipelineTrainer(net, loss, mesh=mesh, tp_axis="tp", tp_mode="partitioned",
                        schedule="gpipe")
    with pytest.raises(MXNetError, match="sequence_parallel"):
        PipelineTrainer(net, loss, mesh=mesh, tp_axis="tp", sequence_parallel=True)
    with pytest.raises(MXNetError, match="cross-entropy"):
        PipelineTrainer(net, lambda a, b: a.mean(), mesh=mesh, tp_axis="tp",
                        tp_mode="partitioned")
    with pytest.raises(MXNetError, match="heads"):
        PipelineTrainer(net, loss, mesh=Mesh([mt.cpu()], ("pp", "tp"), (2, 4)), tp_axis="tp",
                        tp_mode="partitioned")
    with pytest.raises(MXNetError, match="requires a tp_axis"):
        PipelineTrainer(net, loss, mesh=mesh, tp_mode="partitioned")
    with pytest.raises(MXNetError, match="dp_axis"):
        PipelineTrainer(net, loss, mesh=Mesh([mt.cpu()], ("pp",), (2,)), zero_update=True)
    with pytest.raises(MXNetError, match="tp_axis"):
        PipelineTrainer(net, loss, mesh=Mesh([mt.cpu()], ("pp", "dp", "tp"), (2, 1, 2)),
                        dp_axis="dp", tp_axis="tp", zero_update=True)
    # the reference's refusals of LAMB/LARS under ZeRO (:657-659) and tp (:473-476)
    with pytest.raises(MXNetError, match="zero_update does not support LAMB: its per-tensor"):
        PipelineTrainer(net, loss, optimizer="lamb", mesh=Mesh([mt.cpu()], ("pp", "dp"), (2, 2)),
                        dp_axis="dp", zero_update=True)
    with pytest.raises(MXNetError, match="tensor parallelism does not support LARS"):
        PipelineTrainer(net, loss, optimizer="lars", mesh=mesh, tp_axis="tp",
                        tp_mode="partitioned")
    with pytest.raises(MXNetError, match="unsupported comm dtype"):
        PipelineTrainer(net, loss, mesh=Mesh([mt.cpu()], ("pp", "dp"), (2, 2)), dp_axis="dp",
                        zero_update=True, comm_dtype="int4")
    with pytest.raises(MXNetError, match="requires schedule='1f1b'"):
        PipelineTrainer(net, loss, mesh=Mesh([mt.cpu()], ("pp",), (2,)), schedule="gpipe",
                        virtual_stages=2)


def test_sequence_parallel_rejects_indivisible_seq():
    """seq_len 9 does not split over tp 2 (``test_partitioned_tp.py:369``)."""
    from mxnet_tpu_torch.parallel import Mesh
    cfg = dict(CFG, max_length=9)
    net = BertModel(**cfg)
    net.initialize(ctx=mt.cpu())
    tr = PipelineTrainer(net, token_cross_entropy, "sgd", SGD,
                         mesh=Mesh([mt.cpu()], ("pp", "tp"), (1, 2)), tp_axis="tp",
                         tp_mode="partitioned", sequence_parallel=True, num_microbatch=2)
    x = mt.nd.array(np.zeros((B, 9)), ctx=mt.cpu(), dtype="int32")
    with pytest.raises(MXNetError, match="seq_len"):
        tr.step(x, x)


# -- on the card ---------------------------------------------------------------------

@pytest.mark.gpu
def test_cell_forward_kernels_against_plain_attention():
    """``cell_forward`` at BERT-base width (units 768, 12 heads, hidden 3072)
    on the card at T = 1024 runs K1-K3 once each on its (B H, T, T, 64)
    attention; the plain path (MXNET_FLASH_ATTENTION_MIN_SEQ above T) gives
    the same output and leaf gradients, f32 with TF32 off, within 1e-4 of
    max (K1-K3 against their plain versions hold 1e-5, the rest is the
    summation order of the softmax)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from mxnet_tpu_torch.base import env
    from mxnet_tpu_torch.models import bert as pb
    from mxnet_tpu_torch.ops.cuda import flash_attention as fa
    torch.backends.cuda.matmul.allow_tf32 = False
    mt.random.seed(0)
    cell = pb.TransformerEncoderCell(768, 3072, 12)
    cell.initialize(ctx=mt.gpu(0))
    plist = list(cell.collect_params().values())
    plan = megatron.plan_cell(cell, plist, 1)
    cfg = megatron.PartitionConfig("tp", 1)
    h = torch.randn(2, 1024, 768, device="cuda", generator=torch.Generator("cuda").manual_seed(1))
    outs = []
    for min_seq in (1024, 4096):
        leaves = [p._param.detach().clone().view(megatron.view_shape(tuple(p.shape), lay))
                  .requires_grad_() for p, lay in zip(plist, plan.layouts)]
        before = (fa.flash_attention_fwd.launches, fa.flash_attention_bwd_dq.launches,
                  fa.flash_attention_bwd_dkv.launches)
        old = os.environ.get("MXNET_FLASH_ATTENTION_MIN_SEQ")
        os.environ["MXNET_FLASH_ATTENTION_MIN_SEQ"] = str(min_seq)
        try:
            assert env.get("MXNET_FLASH_ATTENTION_MIN_SEQ") == min_seq
            y = megatron.cell_forward(plan, cfg, leaves, h, (0,))
            grads = torch.autograd.grad(y.square().mean(), leaves)
        finally:
            if old is None:
                del os.environ["MXNET_FLASH_ATTENTION_MIN_SEQ"]
            else:
                os.environ["MXNET_FLASH_ATTENTION_MIN_SEQ"] = old
        torch.cuda.synchronize()
        after = (fa.flash_attention_fwd.launches, fa.flash_attention_bwd_dq.launches,
                 fa.flash_attention_bwd_dkv.launches)
        assert [a - b for a, b in zip(after, before)] == ([1, 1, 1] if min_seq == 1024
                                                         else [0, 0, 0])
        outs.append((y.detach(), [g.detach() for g in grads]))
    (y1, g1), (y2, g2) = outs
    assert (y1 - y2).abs().max() <= 1e-4 * y2.abs().max()
    for a, b in zip(g1, g2):
        assert (a - b).abs().max() <= 1e-4 * b.abs().max() + 1e-12
