"""The port's 1F1B pipeline against the reference's, on the CPU.

The model is the reference's own pipeline tests' BERT
(``tests/test_pipeline_1f1b.py``: vocab 64, 4 layers, units 32, hidden 64,
2 heads, max_length 8, no dropout) with weights from
``convert.seeded_params`` loaded into both packages, batches (8, 8) of
tokens from a numpy seed, and the mean token cross entropy.

- 4 gloo ranks (one spawn) against the reference's ``PipelineTrainer`` on
  CPU devices: ``{pp: 2}`` at M = 4 with Adam lr 1e-2 (the port's ranks on a
  mesh ``{rep: 2, pp: 2}`` whose ``rep`` axis carries no data: two
  replicas of the 2-stage pipeline), 10 losses and the weights after
  ``sync()``; ``{pp: 2, dp: 2}`` at M = 2 with SGD lr 0.5, the same;
  ``dtype="bfloat16"`` at M = 4, Adam lr 1e-2, 5 steps. On the ranks also
  the most microbatches each stage held in flight at M = 4 and M = 8
  (min(M, 2(pp - 1 - s) + 1)), the point-to-point sends, the embed and head
  bitwise equal across the pp ranks after 3 steps, and no jax or reference
  module loaded.
- In one process: ``{pp: 1}`` at M = 4 against the port's
  ``DataParallelTrainer``; a frozen embedding (the reference's :265); the
  rejections; GPipe and the interleaved stages at pp 1 against the same
  fused step, and ``pipeline_apply``, ``gpipe_schedule`` and
  ``schedule_1f1b(n_chunks=2)`` on one stage (their parity with the
  reference on more stages is ``test_torch_pipeline_schedules.py``'s, the
  tp and ZeRO compositions ``test_torch_pipeline_tp.py``'s);
  ``pipeline_split``'s shared Parameters.

Tolerances (f32; the reference's own 1F1B tests allow losses 2e-3 / 5e-4
relative and weights 5e-3 / 1e-3 relative for Adam / SGD over 10 steps):
losses 1e-5 relative, weights 2e-5 absolute (``test_torch_data_parallel.py``'s;
only the order of summation differs). bfloat16 (the frameworks round at
other places): the losses 1e-3 relative, and each weight's change from its
start against the reference's change, ||dw - dw_ref|| / ||dw_ref||, 0.3 for
each tensor and 0.15 over the whole model. The loss falls by about 28% in
the 5 steps and the largest weight moves 5e-2, so an update that is lost,
of the wrong sign or of the wrong size fails. Readings on the CPU: losses
2.1e-4 relative, 0.136 for the worst tensor (``ffn1.bias`` of layer 0),
0.076 over the model.
"""
import os
import sys

import numpy as np
import pytest
import torch

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import _dist_util
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.convert import load_jax_params, seeded_params
from mxnet_tpu_torch.models import BertModel
from mxnet_tpu_torch.parallel import (DataParallelTrainer, Mesh, PipelineTrainer,
                                      make_mesh, pipeline)
from torch_threads import one_torch_thread  # noqa: F401

V, B, T = 64, 8, 8
CFG = dict(vocab_size=V, num_layers=4, units=32, hidden_size=64, num_heads=2,
           max_length=T, dropout=0.0)
STEPS, STEPS_BF16 = 10, 5
TOL_LOSS = 1e-5
TOL_W = 2e-5
TOL_BF16_LOSS = 1e-3
TOL_BF16_DW = 0.3           # each tensor's change against the reference's
TOL_BF16_DW_ALL = 0.15      # the whole model's
# (name, port mesh, reference mesh, dp_axis, M, optimizer, params, steps, dtype)
RUNS = [("adam_pp2", {"rep": 2, "pp": 2}, {"pp": 2}, None, 4, "adam",
         {"learning_rate": 1e-2}, STEPS, None),
        ("sgd_pp2_dp2", {"pp": 2, "dp": 2}, {"pp": 2, "dp": 2}, "dp", 2, "sgd",
         {"learning_rate": 0.5, "wd": 0.0}, STEPS, None),
        ("bf16_pp2", {"rep": 2, "pp": 2}, {"pp": 2}, None, 4, "adam",
         {"learning_rate": 1e-2}, STEPS_BF16, "bfloat16")]
# the reference's two cyclic rings send one activation each a tick, both ways
# at every tick: 2(M + 2(pp - 1)) hops a step
REF_HOPS_PP2_M4 = 2 * (4 + 2 * (2 - 1))
MODULE = "test_torch_pipeline"
TESTS_DIR = os.path.dirname(os.path.abspath(__file__))


def token_ce(logits, labels):
    """Per-token cross entropy (the trainers take its mean)."""
    logits = logits.float()
    return torch.logsumexp(logits, -1) - logits.gather(-1, labels.long()[..., None])[..., 0]


def _batch(seed=0, batch=B):
    rs = np.random.RandomState(seed)
    return (rs.randint(0, V, (batch, T)).astype(np.int32),
            rs.randint(0, V, (batch, T)).astype(np.int32))


@pytest.fixture(scope="module")
def weights():
    return seeded_params(BertModel(**CFG), seed=3)


def _net(weights, ctx=None):
    net = BertModel(**CFG)
    net.initialize(ctx=ctx or mt.cpu())
    load_jax_params(net, weights)
    return net


def _xy(x, y):
    return (mt.nd.array(x, ctx=mt.cpu(), dtype="int32"),
            mt.nd.array(y, ctx=mt.cpu(), dtype="int32"))


def _params(net):
    return {k: p._param.detach().numpy().copy()
            for k, p in net._collect_params_with_prefix().items()}


# -- the ranks -----------------------------------------------------------------------

def rank_pipeline(workdir):
    """One of 4 ranks: each of RUNS, then one step at M = 8."""
    weights = dict(np.load(f"{workdir}/weights.npz"))
    x, y = _batch()
    rank = torch.distributed.get_rank()
    out = {"rank": rank}
    for name, axes, _, dp_axis, M, opt, params, steps, dtype in RUNS:
        net = _net(weights)
        tr = PipelineTrainer(net, token_ce, opt, params, mesh=make_mesh(axes, devices=[mt.cpu()]),
                             dp_axis=dp_axis, num_microbatch=M, dtype=dtype)
        sends0 = dict(_dist_util.p2p_stats)
        run = {"losses": [], "stage": tr.stage, "in_flight": [],
               "layers": list(tr._own), "groups": len(tr._groups)}
        for i in range(steps):
            run["losses"].append(float(tr.step(*_xy(x, y))))
            run["in_flight"].append(tr.last_stats["max_in_flight"])
            if i == 2:
                eh = {f"e{j}": p._param.detach().numpy() for j, p in enumerate(tr._embed_plist)}
                eh.update({f"h{j}": p._param.detach().numpy()
                           for j, p in enumerate(tr._head_plist)})
                np.savez(f"{workdir}/{name}_eh{rank}.npz", **eh)
        run["stats"] = dict(tr.last_stats)
        run["p2p_sends"] = _dist_util.p2p_stats["sends"] - sends0["sends"]
        run["p2p_bytes"] = _dist_util.p2p_stats["bytes"] - sends0["bytes"]
        tr.sync()
        np.savez(f"{workdir}/{name}_w{rank}.npz", **_params(net))
        out[name] = run
    x8, y8 = _batch(batch=B)
    tr = PipelineTrainer(_net(weights), token_ce, "adam", {"learning_rate": 1e-2},
                         mesh=make_mesh({"rep": 2, "pp": 2}, devices=[mt.cpu()]),
                         num_microbatch=8)
    tr.step(*_xy(x8, y8))
    out["in_flight_m8"] = tr.last_stats["max_in_flight"]
    out["modules"] = sorted(m for m in sys.modules
                            if m.split(".")[0] in ("jax", "jaxlib", "mxnet_tpu"))
    return out


def _ref_run(weights, axes, dp_axis, M, opt, params, steps, dtype):
    import jax
    import jax.numpy as jnp
    import mxnet_tpu as mx
    from mxnet_tpu.models.bert import BertModel as RefBert
    from mxnet_tpu.parallel import PipelineTrainer as RefPipeline
    from mxnet_tpu.parallel import make_mesh as ref_mesh

    def loss(logits, labels):
        logits = logits.astype(jnp.float32)
        gold = jnp.take_along_axis(logits, labels[..., None].astype(jnp.int32), axis=-1)[..., 0]
        return jnp.mean(jax.nn.logsumexp(logits, axis=-1) - gold)
    net = RefBert(**CFG)
    net.initialize(ctx=mx.cpu())
    for key, p in net._collect_params_with_prefix().items():
        p.set_data(mx.nd.array(weights[key], ctx=mx.cpu()))
    n = int(np.prod(list(axes.values())))
    tr = RefPipeline(net, loss, optimizer=opt, optimizer_params=params,
                     mesh=ref_mesh(axes, devices=jax.devices("cpu")[:n]), dp_axis=dp_axis,
                     num_microbatch=M, schedule="1f1b", dtype=dtype)
    x, y = _batch()
    xr, yr = mx.nd.array(x, dtype="int32"), mx.nd.array(y, dtype="int32")
    losses = [float(tr.step(xr, yr)) for _ in range(steps)]
    tr.sync()
    return losses, {k: np.asarray(p.data().asnumpy())
                    for k, p in net._collect_params_with_prefix().items()}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, weights):
    ref = {name: _ref_run(weights, ref_axes, dp_axis, M, opt, params, steps, dtype)
           for name, _, ref_axes, dp_axis, M, opt, params, steps, dtype in RUNS}
    root = tmp_path_factory.mktemp("pipeline")
    np.savez(root / "weights.npz", **weights)
    out = _dist_util.launch_local(f"{MODULE}:rank_pipeline", 4, {"workdir": str(root)},
                                  device="cpu", timeout=240, pythonpath=[TESTS_DIR],
                                  workdir=str(root / "launch"))
    files = {p.name[:-4]: dict(np.load(p)) for p in root.glob("*.npz") if p.name != "weights.npz"}
    return {"ref": ref, "ranks": out, "files": files}


@pytest.mark.parametrize("name", [r[0] for r in RUNS])
def test_ranks_match_reference(ranks, weights, name):
    bf16 = name.startswith("bf16")
    ref_losses, ref_w = ranks["ref"][name]
    for rank in ranks["ranks"]:
        losses = rank[name]["losses"]
        np.testing.assert_allclose(losses, ref_losses,
                                   rtol=TOL_BF16_LOSS if bf16 else TOL_LOSS)
        assert losses[-1] < losses[0]
        got = ranks["files"][f"{name}_w{rank['rank']}"]
        off = norm = 0.0
        for key, w in ref_w.items():
            assert got[key].dtype == np.float32
            if not bf16:
                assert np.abs(got[key] - w).max() <= TOL_W, (rank["rank"], key)
                continue
            step_ref, step = w - weights[key], got[key] - weights[key]
            if not step_ref.any():          # a leaf no token reaches (seg_embed)
                assert not step.any(), (rank["rank"], key)
                continue
            rel = np.linalg.norm(step - step_ref) / np.linalg.norm(step_ref)
            assert rel <= TOL_BF16_DW, (rank["rank"], key, rel)
            off += np.sum((step - step_ref) ** 2)
            norm += np.sum(step_ref ** 2)
        if bf16:
            assert np.sqrt(off / norm) <= TOL_BF16_DW_ALL, (rank["rank"], np.sqrt(off / norm))


def test_ranks_schedule_and_wires(ranks):
    """Stage s of pp = 2 holds at most min(M, 2(pp - 1 - s) + 1) microbatches
    in flight, at M = 4 and at M = 8; each stage sends M activations (stage
    0) or M cotangents (stage 1) a step, where the reference's cyclic rings
    make 2(M + 2(pp - 1)) hops; one update launch a weight decay."""
    for rank in ranks["ranks"]:
        run = rank["adam_pp2"]
        s = run["stage"]
        assert run["layers"] == [2 * s, 2 * s + 1]
        assert set(run["in_flight"]) == {min(4, 2 * (1 - s) + 1)}
        assert rank["in_flight_m8"] == min(8, 2 * (1 - s) + 1)
        assert run["stats"]["ticks"] == 4 + 2
        act = B // 4 * T * 32 * 4
        assert run["stats"]["sends"] == 4 and run["stats"]["bytes"] == 4 * act
        assert run["p2p_sends"] == 4 * STEPS and run["p2p_bytes"] == 4 * STEPS * act
        assert run["stats"]["sends"] < REF_HOPS_PP2_M4 == 12
        assert run["groups"] == 1
        dp = rank["sgd_pp2_dp2"]
        assert dp["stats"]["bytes"] == 2 * (B // 2 // 2) * T * 32 * 4
        bf = rank["bf16_pp2"]
        assert bf["stats"]["bytes"] == 4 * B // 4 * T * 32 * 2      # bf16 on the wire


def test_embed_and_head_bitwise_equal_across_stages(ranks):
    files = ranks["files"]
    for name in ("adam_pp2", "sgd_pp2_dp2"):
        arrays = [files[f"{name}_eh{r}"] for r in range(4)]
        for a in arrays[1:]:
            for key, v in arrays[0].items():
                assert np.array_equal(a[key], v), (name, key)


def test_ranks_load_neither_jax_nor_the_reference(ranks):
    assert all(rank["modules"] == [] for rank in ranks["ranks"])


# -- one process ------------------------------------------------------------------

def _one(net, M=4, **kw):
    return PipelineTrainer(net, token_ce, "adam", {"learning_rate": 1e-2},
                           mesh=make_mesh({"pp": 1}, devices=[mt.cpu()]), num_microbatch=M, **kw)


def test_pp1_matches_data_parallel(weights):
    """One stage at M = 4 equals the full-batch fused step up to the order
    of summation; one launch of the update a step, the schedule's ticks."""
    x, y = _batch(1)
    n1, n2 = _net(weights), _net(weights)
    dpt = DataParallelTrainer(n1, token_ce, "adam", {"learning_rate": 1e-2},
                              mesh=make_mesh({"dp": 1}, devices=[mt.cpu()]))
    tr = _one(n2)
    want = [float(dpt.step(*_xy(x, y))) for _ in range(STEPS)]
    got = [float(tr.step(*_xy(x, y))) for _ in range(STEPS)]
    np.testing.assert_allclose(got, want, rtol=TOL_LOSS)
    assert tr.last_stats == {"ticks": 4, "max_in_flight": 1, "sends": 0, "bytes": 0,
                             "comm": {}}
    assert tr.num_update == STEPS and tr._program.label == "pp.step[BertModel]"
    assert tr._program.key_base[0] == "pp_step"
    a, b = _params(n1), _params(n2)
    for key, w in a.items():
        assert np.abs(b[key] - w).max() <= TOL_W, key


def test_frozen_embedding_skips_update(weights):
    """Frozen embed parameters ride the schedule untouched while the rest
    trains to the values of the fused step with the same frozen mask."""
    x, y = _batch(2)

    def frozen():
        net = _net(weights)
        embed, _, _ = net.pipeline_split()
        for p in embed.collect_params().values():
            p.grad_req = "null"
        return net
    n1, n2 = frozen(), frozen()
    before = _params(n2)
    dpt = DataParallelTrainer(n1, token_ce, "sgd", {"learning_rate": 0.5, "wd": 0.0},
                              mesh=make_mesh({"dp": 1}, devices=[mt.cpu()]))
    tr = PipelineTrainer(n2, token_ce, "sgd", {"learning_rate": 0.5, "wd": 0.0},
                         mesh=make_mesh({"pp": 1}, devices=[mt.cpu()]), num_microbatch=4)
    assert not any(tr._tr_e) and all(not st for st in tr._opt_e)
    want = [float(dpt.step(*_xy(x, y))) for _ in range(3)]
    got = [float(tr.step(*_xy(x, y))) for _ in range(3)]
    np.testing.assert_allclose(got, want, rtol=TOL_LOSS)
    after, oracle = _params(n2), _params(n1)
    embed_keys = {k for k in after if k.startswith(("word_embed", "pos_embed", "seg_embed",
                                                    "embed_ln"))}
    assert embed_keys
    for key in after:
        if key in embed_keys:
            assert np.array_equal(after[key], before[key]), key
        assert np.abs(after[key] - oracle[key]).max() <= TOL_W, key


def test_pipeline_split_shares_parameters(weights):
    net = _net(weights)
    before = list(net.collect_params().items())
    embed, cells, head = net.pipeline_split()
    assert list(net.collect_params().items()) == before
    shared = {id(p) for _, p in before}
    for block in (embed, head, *cells):
        assert all(id(p) in shared for p in block.collect_params().values())
    assert [c for c in cells] == [net.encoder.layers[i] for i in range(4)]
    assert embed.word_embed is net.word_embed and head.ln is net.encoder.ln
    x, _ = _batch(3)
    h = embed(_xy(x, x)[0])
    for c in cells:
        h = c(h)
    torch.testing.assert_close(head(h)._data, net(_xy(x, x)[0])._data, rtol=0, atol=0)
    assert net.pipeline_split()[0] is not embed      # fresh wrappers, none kept


class _Stateful(mt.gluon.HybridBlock):
    """A net whose cells hold a BatchNorm, or differ in width."""

    def __init__(self, cell_units=(8, 8), norm=False):
        super().__init__()
        self.embed = mt.gluon.nn.Dense(8, in_units=4)
        self.cells = mt.gluon.nn.HybridSequential()
        for u in cell_units:
            self.cells.add(mt.gluon.nn.BatchNorm(in_channels=8) if norm
                           else mt.gluon.nn.Dense(8, in_units=u))
        self.head = mt.gluon.nn.Dense(4, in_units=8)

    def pipeline_split(self):
        return self.embed, [self.cells[i] for i in range(len(self.cells))], self.head


def test_rejections(weights, monkeypatch):
    """The reference's refusals, with its messages."""
    x, y = _batch(4)
    net = _net(weights)
    with pytest.raises(MXNetError, match="divide"):
        PipelineTrainer(net, token_ce, mesh=Mesh([mt.cpu()], ("pp",), (3,)))
    tr = PipelineTrainer(net, token_ce, mesh=make_mesh({"pp": 1}, devices=[mt.cpu()]),
                         num_microbatch=3)
    with pytest.raises(MXNetError, match="must divide by num_microbatch"):
        tr.step(*_xy(x, y))
    dense = mt.gluon.nn.Dense(4, in_units=4)
    dense.initialize(ctx=mt.cpu())
    with pytest.raises(MXNetError, match="pipeline_split"):
        PipelineTrainer(dense, token_ce, mesh=make_mesh({"pp": 1}, devices=[mt.cpu()]))
    fresh = BertModel(**CFG)
    with pytest.raises(MXNetError, match="uninitialized"):
        PipelineTrainer(fresh, token_ce, mesh=make_mesh({"pp": 1}, devices=[mt.cpu()]))
    for bad, match in ((_Stateful(norm=True), "aux state"),
                       (_Stateful(cell_units=(8, 4)), "structurally identical")):
        bad.initialize(ctx=mt.cpu())
        with pytest.raises(MXNetError, match=match):
            PipelineTrainer(bad, token_ce, mesh=make_mesh({"pp": 1}, devices=[mt.cpu()]))
    half = _net(weights)
    half.encoder.layers[1].ffn.ffn1.weight.grad_req = "null"
    with pytest.raises(MXNetError, match="frozen in some layers"):
        PipelineTrainer(half, token_ce, mesh=make_mesh({"pp": 1}, devices=[mt.cpu()]))
    with pytest.raises(MXNetError, match="float32/bfloat16"):
        PipelineTrainer(net, token_ce, mesh=make_mesh({"pp": 1}, devices=[mt.cpu()]),
                        dtype="float16")
    with pytest.raises(MXNetError, match="unknown pipeline schedule"):
        PipelineTrainer(net, token_ce, mesh=make_mesh({"pp": 1}, devices=[mt.cpu()]),
                        schedule="pipedream")


@pytest.mark.parametrize("kw", [dict(schedule="gpipe"), dict(virtual_stages=2),
                                dict(schedule="env")])
def test_other_compositions_raise_a2b(weights, monkeypatch, kw):
    """The compositions that were refused until the GPipe and interleaved
    schedules came (``schedule="gpipe"``, also through
    ``MXNET_TPU_PP_SCHEDULE``, and ``virtual_stages=2``) now train: at pp 1
    their 3 losses and the weights equal the full-batch fused step's (the
    reference's parity on more stages is ``test_torch_pipeline_schedules.py``'s)."""
    if kw == dict(schedule="env"):
        monkeypatch.setenv("MXNET_TPU_PP_SCHEDULE", "gpipe")
        kw = {}
    x, y = _batch(6)
    n1, n2 = _net(weights), _net(weights)
    dpt = DataParallelTrainer(n1, token_ce, "adam", {"learning_rate": 1e-2},
                              mesh=make_mesh({"dp": 1}, devices=[mt.cpu()]))
    tr = _one(n2, **kw)
    assert tr.schedule == kw.get("schedule", "gpipe" if not kw else "1f1b")
    want = [float(dpt.step(*_xy(x, y))) for _ in range(3)]
    got = [float(tr.step(*_xy(x, y))) for _ in range(3)]
    np.testing.assert_allclose(got, want, rtol=TOL_LOSS)
    a, b = _params(n1), _params(n2)
    for key, w in a.items():
        assert np.abs(b[key] - w).max() <= TOL_W, key


def test_functional_gpipe_and_chunks_raise_a2b():
    """The functional forms that were refused until the GPipe and
    interleaved schedules came now run on one stage: ``pipeline_apply`` and
    ``gpipe_schedule`` give the stage's output and gradients,
    ``schedule_1f1b(n_chunks=2)`` the loss and gradients of one chunk."""
    rs = np.random.RandomState(8)
    w = torch.tensor(rs.normal(0, 0.5, (6, 6)).astype(np.float32), requires_grad=True)
    xs = torch.tensor(rs.normal(0, 1, (4, 3, 6)).astype(np.float32), requires_grad=True)
    out = pipeline.pipeline_apply(lambda p, h, t: torch.tanh(h @ p[0]), [w], xs)
    out.sum().backward()
    w2, x2 = w.detach().clone().requires_grad_(), xs.detach().clone().requires_grad_()
    want = torch.tanh(x2 @ w2)
    want.sum().backward()
    torch.testing.assert_close(out, want.detach(), rtol=0, atol=1e-6)
    torch.testing.assert_close(w.grad, w2.grad, rtol=0, atol=1e-5)
    torch.testing.assert_close(xs.grad, x2.grad, rtol=0, atol=1e-6)
    shim = pipeline.gpipe_schedule(lambda h: torch.tanh(h @ w.detach()), 4, "pp")
    torch.testing.assert_close(shim(xs.detach()), want.detach(), rtol=0, atol=1e-6)
    ys = torch.tensor(rs.normal(0, 1, (4, 3, 6)).astype(np.float32))
    got = {}
    for chunks in (1, 2):
        grad = torch.zeros_like(w)
        loss, stats = pipeline.schedule_1f1b(
            lambda x, m: x, lambda h, m, c: torch.tanh(h @ w) if c == 0 or chunks == 1 else h,
            lambda h, y, m: ((h - y) ** 2).mean(), [w], [grad], xs.detach(), ys,
            n_chunks=chunks, loss_scale=0.25)
        got[chunks] = (float(loss), grad, stats)
    assert got[2][2]["ticks"] == 4 + 2 and got[2][2]["max_in_flight"] == 3
    assert got[1][0] == pytest.approx(got[2][0], rel=1e-6)
    torch.testing.assert_close(got[1][1], got[2][1], rtol=0, atol=1e-6)
    assert pipeline.pipeline_spec(4) == {"num_stages": 4, "axis": "pp"}


def test_schedule_across_stages_needs_act_meta():
    """A stage of a pipeline learns what it receives only from ``act_meta``
    (the trainer's ``_activation``, in predict mode)."""
    mesh = Mesh([mt.cpu()], ("pp",), (2,))
    with pytest.raises(MXNetError, match="act_meta"):
        pipeline.schedule_1f1b(None, None, None, [], [], [0], [0], mesh=mesh)


def test_bfloat16_step_under_no_grad(weights):
    """The compute-dtype casts are made under ``enable_grad``: a step called
    under ``torch.no_grad()`` gives the gradients, and so the weights, of a
    step called outside it."""
    x, y = _batch(5)
    nets = [_net(weights), _net(weights)]
    trs = [_one(n, dtype="bfloat16") for n in nets]
    trs[0].step(*_xy(x, y))
    with torch.no_grad():
        trs[1].step(*_xy(x, y))
    a, b = _params(nets[0]), _params(nets[1])
    assert any(not np.array_equal(a[k], weights[k]) for k in a)
    for key in a:
        assert np.array_equal(a[key], b[key]), key
