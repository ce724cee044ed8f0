"""The port's GPipe and interleaved 1F1B schedules against the reference's,
on the CPU.

The model, weights and batch are ``test_torch_pipeline.py``'s (the
reference's pipeline tests' BERT: vocab 64, 4 layers, units 32, hidden 64, 2
heads, max_length 8, no dropout; ``convert.seeded_params`` into both
packages, batches (8, 8) from a numpy seed), the loss the mean token cross
entropy (``recipes.long_context.token_cross_entropy``).

- One 4-rank gloo spawn, in a thread while this process runs the
  reference's ``PipelineTrainer`` on CPU devices (two-rank meshes get a
  ``rep`` axis that carries no data): ``schedule="gpipe"`` at ``{pp: 2}``
  (Adam lr 1e-2, M = 4; with ``remat`` and without, and through
  ``MXNET_TPU_PP_SCHEDULE``), at ``{pp: 4}``, at ``{pp: 2, dp: 2}`` (SGD lr
  0.5, M = 2), weight-sharded ``{pp: 2, tp: 2}`` under
  ``shard_params_megatron`` and ZeRO over ``{pp: 2, dp: 2}`` (Adam); the
  interleaved ``virtual_stages=2`` at ``{pp: 2}`` (``_stack_order`` [0, 2, 1,
  3], the reference's ``test_pipeline_1f1b.py:140-154``); each 10 losses and
  the weights after ``sync()``. Also on the ranks: each schedule's ticks,
  in-flight microbatches and sends; ``comm_estimate``'s hops against the
  reference's ``ppermute`` telemetry; ``pipeline_apply`` at pp 2 and 4 and
  ``gpipe_schedule`` at pp 2 against a sequential chain (the reference's
  ``test_pipeline_parallel.py:62-86``, its output also against the
  reference's ``pipeline_apply`` under ``shard_map``); no jax or reference
  module loaded.
- In one process: ``virtual_stages=3`` at pp 1 on 6 layers against the
  reference; ``pipeline_apply`` on one stage; GPipe with dropout with
  ``remat`` against GPipe without it (the recompute draws the first run's
  masks); the refusals.

Tolerances (f32; only the order of summation differs): losses 1e-5
relative, weights 2e-5 absolute, ``test_torch_pipeline.py``'s; readings on
the CPU below 1e-6 and 2e-6. ``pipeline_apply``: output and gradients 1e-5
absolute against the chain (float32 tanh of O(1) values).
"""
import os
import sys
import threading

import numpy as np
import pytest
import torch

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import _dist_util
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.convert import load_jax_params, seeded_params
from mxnet_tpu_torch.models import BertModel
from mxnet_tpu_torch.parallel import (Mesh, PipelineTrainer, gpipe_schedule, make_mesh,
                                      pipeline_apply, shard_params_megatron)
from mxnet_tpu_torch.recipes.long_context import token_cross_entropy
from torch_threads import one_torch_thread  # noqa: F401

V, B, T = 64, 8, 8
CFG = dict(vocab_size=V, num_layers=4, units=32, hidden_size=64, num_heads=2,
           max_length=T, dropout=0.0)
CFG6 = dict(CFG, num_layers=6)
STEPS = 10
TOL_LOSS, TOL_W = 1e-5, 2e-5
TOL_APPLY = 1e-5
ADAM = ("adam", {"learning_rate": 1e-2})
SGD = ("sgd", {"learning_rate": 0.5, "wd": 0.0})
GPIPE = dict(schedule="gpipe")
# name -> (port mesh, reference mesh, M, optimizer, trainer keywords,
#          shard_params_megatron, the reference run it is held against)
RUNS = {
    "gpipe_pp2": ({"rep": 2, "pp": 2}, {"pp": 2}, 4, ADAM, GPIPE, False, None),
    "gpipe_pp2_noremat": ({"rep": 2, "pp": 2}, None, 4, ADAM, dict(GPIPE, remat=False), False,
                          "gpipe_pp2"),
    "gpipe_env": ({"rep": 2, "pp": 2}, None, 4, ADAM, {}, False, "gpipe_pp2"),
    "gpipe_pp4": ({"pp": 4}, {"pp": 4}, 4, ADAM, GPIPE, False, None),
    "gpipe_pp2_dp2": ({"pp": 2, "dp": 2}, {"pp": 2, "dp": 2}, 2, SGD,
                      dict(GPIPE, dp_axis="dp"), False, None),
    "gpipe_sharded_tp2": ({"pp": 2, "tp": 2}, {"pp": 2, "tp": 2}, 2, SGD,
                          dict(GPIPE, tp_axis="tp"), True, None),
    "gpipe_zero": ({"pp": 2, "dp": 2}, {"pp": 2, "dp": 2}, 2, ADAM,
                   dict(GPIPE, dp_axis="dp", zero_update=True), False, None),
    "v2_pp2": ({"rep": 2, "pp": 2}, {"pp": 2}, 4, ADAM, dict(virtual_stages=2), False, None),
}
APPLY_D, APPLY_M = 8, 4
MODULE = "test_torch_pipeline_schedules"
TESTS_DIR = os.path.dirname(os.path.abspath(__file__))


def _batch(seed=0):
    rs = np.random.RandomState(seed)
    return (rs.randint(0, V, (B, T)).astype(np.int32),
            rs.randint(0, V, (B, T)).astype(np.int32))


def _net(weights, cfg=CFG):
    net = BertModel(**cfg)
    net.initialize(ctx=mt.cpu())
    load_jax_params(net, weights)
    return net


def _xy(seed=0):
    x, y = _batch(seed)
    return (mt.nd.array(x, ctx=mt.cpu(), dtype="int32"),
            mt.nd.array(y, ctx=mt.cpu(), dtype="int32"))


def _params(net):
    return {k: p._param.detach().numpy().copy()
            for k, p in net._collect_params_with_prefix().items()}


def _trainer(net, axes, M, opt, **kw):
    return PipelineTrainer(net, token_cross_entropy, opt[0], dict(opt[1]),
                           mesh=make_mesh(axes, devices=[mt.cpu()]), num_microbatch=M, **kw)


def _apply_data(n):
    rs = np.random.RandomState(1)
    w = rs.normal(0, 0.5, (n, APPLY_D, APPLY_D)).astype(np.float32)
    x = rs.normal(0, 1, (APPLY_M, 2, APPLY_D)).astype(np.float32)
    cot = rs.normal(0, 1, (APPLY_M, 2, APPLY_D)).astype(np.float32)
    return w, x, cot


def _stage(p, h):
    return torch.tanh(h @ p)


def _chain(w, x, cot):
    """The sequential chain of ``n`` stages: output, each stage's weight
    gradient and the input's, of sum(out * cot)."""
    ws = [torch.tensor(wi, requires_grad=True) for wi in w]
    xs = torch.tensor(x, requires_grad=True)
    h = xs
    for wi in ws:
        h = _stage(wi, h)
    (h * torch.tensor(cot)).sum().backward()
    return (h.detach().numpy(), np.stack([wi.grad.numpy() for wi in ws]), xs.grad.numpy())


# -- the ranks -----------------------------------------------------------------------

def _apply_on_rank(axes, remat):
    """``pipeline_apply`` of tanh(h @ W_s) on this rank's stage: the output
    (last stage), the stage's weight gradient and the input's (stage 0) of
    sum(out * cot)."""
    mesh = make_mesh(axes, devices=[mt.cpu()])
    n, s = mesh.axis_size("pp"), mesh.axis_index("pp")
    w, x, cot = _apply_data(n)
    ws = torch.tensor(w[s], requires_grad=True)
    xs = torch.tensor(x, requires_grad=True)
    out = pipeline_apply(lambda p, h, t: _stage(p[0], h), [ws], xs, mesh=mesh, remat=remat)
    (out * torch.tensor(cot)).sum().backward()
    return {"stage": s, "out": out.detach().tolist(), "dw": ws.grad.tolist(),
            "dx": None if xs.grad is None else xs.grad.tolist()}


def rank_pipeline_schedules(workdir):
    """One of 4 ranks: each of RUNS, then ``pipeline_apply`` and
    ``gpipe_schedule``."""
    weights = dict(np.load(f"{workdir}/weights.npz"))
    x, y = _xy()
    rank = torch.distributed.get_rank()
    out = {"rank": rank}
    for name, (axes, _, M, opt, kw, megatron_specs, _) in RUNS.items():
        net = _net(weights)
        if megatron_specs:
            shard_params_megatron(net, axis="tp")
        if name == "gpipe_env":
            os.environ["MXNET_TPU_PP_SCHEDULE"] = "gpipe"
        try:
            tr = _trainer(net, axes, M, opt, **kw)
        finally:
            os.environ.pop("MXNET_TPU_PP_SCHEDULE", None)
        losses = [float(tr.step(x, y)) for _ in range(STEPS)]
        run = {"losses": losses, "stage": tr.stage, "schedule": tr.schedule,
               "remat": tr.remat, "stats": {k: v for k, v in tr.last_stats.items()
                                            if k != "comm"},
               "stack_order": list(tr._stack_order), "own": list(tr._own),
               "estimate": tr.comm_estimate((B, T)).get("ppermute")}
        tr.sync()
        np.savez(f"{workdir}/{name}_w{rank}.npz", **_params(net))
        out[name] = run
    out["apply"] = {f"pp{n}_{remat}": _apply_on_rank(axes, remat)
                    for n, axes in ((2, {"rep": 2, "pp": 2}), (4, {"pp": 4}))
                    for remat in (True, False)}
    mesh = make_mesh({"rep": 2, "pp": 2}, devices=[mt.cpu()])
    w, xa, _ = _apply_data(2)
    s = mesh.axis_index("pp")
    ws = torch.tensor(w[s])
    got = gpipe_schedule(lambda h: _stage(ws, h), APPLY_M, "pp", mesh=mesh)(torch.tensor(xa))
    out["gpipe_schedule"] = {"stage": s, "out": got.tolist()}
    out["modules"] = sorted(m for m in sys.modules
                            if m.split(".")[0] in ("jax", "jaxlib", "mxnet_tpu"))
    return out


# -- the reference ----------------------------------------------------------------------

def _ref_runs(weights, names):
    """The reference's losses, weights after ``sync()`` and the ``ppermute``
    telemetry of its last step, for each of ``names``."""
    import jax
    import mxnet_tpu as mx
    from mxnet_tpu import telemetry as telem
    from mxnet_tpu.models.bert import BertModel as RefBert
    from mxnet_tpu.parallel import PipelineTrainer as RefPipeline
    from mxnet_tpu.parallel import make_mesh as ref_mesh
    from mxnet_tpu.parallel import shard_params_megatron as ref_megatron
    from mxnet_tpu.recipes.moe import token_cross_entropy as ref_loss
    x, y = (mx.nd.array(a, dtype="int32") for a in _batch())
    out = {}
    telem.enable()
    try:
        for name in names:
            _, axes, M, opt, kw, megatron_specs, _ = RUNS[name]
            net = RefBert(**CFG)
            net.initialize(ctx=mx.cpu())
            for key, p in net._collect_params_with_prefix().items():
                p.set_data(mx.nd.array(weights[key], ctx=mx.cpu()))
            if megatron_specs:
                ref_megatron(net, axis="tp")
            n = int(np.prod(list(axes.values())))
            kw = dict(kw)
            kw.setdefault("schedule", "1f1b")
            tr = RefPipeline(net, ref_loss, optimizer=opt[0], optimizer_params=dict(opt[1]),
                             mesh=ref_mesh(axes, devices=jax.devices("cpu")[:n]),
                             num_microbatch=M, **kw)
            losses = []
            for i in range(STEPS):
                if i == STEPS - 1:
                    telem.reset()
                losses.append(float(tr.step(x, y)))
            calls = telem.get_metric("mx_comm_calls_total").get("ppermute", "mesh")
            nbytes = telem.get_metric("mx_comm_bytes_total").get("ppermute", "mesh")
            tr.sync()
            out[name] = (losses, {k: np.asarray(p.data().asnumpy())
                                  for k, p in net._collect_params_with_prefix().items()},
                         (calls, nbytes))
    finally:
        telem.disable()
    return out


def _ref_pipeline_apply(n):
    """The reference's ``pipeline_apply`` over ``n`` CPU devices (its
    ``test_pipeline_parallel.py:62-86``): the last stage's output."""
    import jax
    import jax.numpy as jnp
    from mxnet_tpu.parallel import make_mesh as ref_mesh
    from mxnet_tpu.parallel import pipeline_apply as ref_apply
    from mxnet_tpu.parallel.mesh import P
    from mxnet_tpu.parallel.zero import shard_map_compat
    w, x, _ = _apply_data(n)
    mesh = ref_mesh({"pp": n}, devices=jax.devices("cpu")[:n])
    out = jax.jit(shard_map_compat(
        lambda wi, xs: ref_apply(lambda p, h, t: jnp.tanh(h @ p[0]), wi, xs,
                                 axis_name="pp")[None],
        mesh=mesh, in_specs=(P("pp"), P(None)), out_specs=P("pp")))(jnp.asarray(w),
                                                                  jnp.asarray(x))
    return np.asarray(out[-1])


@pytest.fixture(scope="module")
def weights():
    return seeded_params(BertModel(**CFG), seed=3)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, weights):
    root = tmp_path_factory.mktemp("pipeline_schedules")
    np.savez(root / "weights.npz", **weights)
    result = {}

    def spawn():
        try:
            result["ranks"] = _dist_util.launch_local(
                f"{MODULE}:rank_pipeline_schedules", 4, {"workdir": str(root)},
                device="cpu", timeout=300, pythonpath=[TESTS_DIR],
                workdir=str(root / "launch"))
        except Exception as e:          # re-raised in the test process below
            result["error"] = e
    thread = threading.Thread(target=spawn)
    thread.start()
    try:
        ref = _ref_runs(weights, [n for n, r in RUNS.items() if r[6] is None])
        ref["apply_pp4"] = _ref_pipeline_apply(4)
    finally:
        thread.join()
    if "error" in result:
        raise result["error"]
    files = {p.name[:-4]: dict(np.load(p)) for p in root.glob("*_w*.npz")}
    return {"ref": ref, "ranks": result["ranks"], "files": files}


@pytest.mark.parametrize("name", list(RUNS))
def test_ranks_match_reference(ranks, name):
    """Each schedule's 10 losses and the weights after ``sync()`` on every
    rank against the reference's trainer of the same mesh (GPipe without
    remat and through the environment against the reference's GPipe)."""
    ref_losses, ref_w, _ = ranks["ref"][RUNS[name][6] or name]
    for rank in ranks["ranks"]:
        run = rank[name]
        assert run["schedule"] == ("1f1b" if name.startswith("v") else "gpipe")
        assert run["remat"] == (name != "gpipe_pp2_noremat")
        np.testing.assert_allclose(run["losses"], ref_losses, rtol=TOL_LOSS)
        assert run["losses"][-1] < run["losses"][0]
        got = ranks["files"][f"{name}_w{rank['rank']}"]
        for key, w in ref_w.items():
            assert np.abs(got[key] - w).max() <= TOL_W, (name, rank["rank"], key)


def test_schedule_ticks_in_flight_and_sends(ranks):
    """GPipe: M + pp - 1 ticks each way, all M microbatches held (the
    reference's O(M) residuals), M activations sent forward by every stage
    but the last and M cotangents back by every stage but the first. The
    interleaved pp 2 x v 2: stage s owns layers [s, s + 2] (stack order [0,
    2, 1, 3]), M + 2(pp v - 1) ticks, at most min(M, 2(pp v - 1 - l) + 1)
    microbatches in a chunk of logical stage l, 3 hops of a microbatch each
    way split 2 : 1 between the stages."""
    act = B // 4 * T * 32 * 4
    for rank in ranks["ranks"]:
        for name, n in (("gpipe_pp2", 2), ("gpipe_pp4", 4)):
            run = rank[name]
            s = run["stage"]
            sends = 4 * ((s < n - 1) + (s > 0))
            assert run["stats"] == {"ticks": 4 + n - 1, "max_in_flight": 4, "sends": sends,
                                    "bytes": sends * act}, (name, run["stats"])
        v2 = rank["v2_pp2"]
        s = v2["stage"]
        assert v2["stack_order"] == [0, 2, 1, 3] and v2["own"] == [s, s + 2]
        assert v2["stats"] == {"ticks": 4 + 2 * 3, "max_in_flight": min(4, 2 * (3 - s) + 1),
                               "sends": 3 * 4, "bytes": 3 * 4 * act}
        assert rank["gpipe_pp2_dp2"]["stats"]["bytes"] == 2 * (B // 2 // 2) * T * 32 * 4


@pytest.mark.parametrize("name", ["gpipe_pp2", "gpipe_pp4", "gpipe_pp2_dp2", "v2_pp2"])
def test_hop_estimate_matches_reference_telemetry(ranks, name):
    """``comm_estimate``'s ``ppermute`` is the reference's booking: 2 (M +
    pp v - 1) hops under GPipe, 2 (M + 2(pp v - 1)) under 1F1B, each of a
    v-stack of a microbatch's activation."""
    want = tuple(ranks["ref"][name][2])
    for rank in ranks["ranks"]:
        assert tuple(rank[name]["estimate"]) == want


@pytest.mark.parametrize("n", [2, 4])
def test_pipeline_apply_matches_sequential(ranks, n):
    """``pipeline_apply`` with and without remat: the last stage's output,
    each stage's weight gradient and stage 0's input gradient equal the
    sequential chain's; the output equals the reference's ``pipeline_apply``
    (pp 4), and the other stages return zeros."""
    w, x, cot = _apply_data(n)
    out, dw, dx = _chain(w, x, cot)
    if n == 4:
        np.testing.assert_allclose(out, ranks["ref"]["apply_pp4"], atol=TOL_APPLY)
    for rank in ranks["ranks"]:
        for remat in (True, False):
            got = rank["apply"][f"pp{n}_{remat}"]
            s = got["stage"]
            if s == n - 1:
                np.testing.assert_allclose(got["out"], out, atol=TOL_APPLY)
            else:
                assert not np.asarray(got["out"]).any()
            np.testing.assert_allclose(got["dw"], dw[s], atol=TOL_APPLY)
            if s == 0:
                np.testing.assert_allclose(got["dx"], dx, atol=TOL_APPLY)


def test_gpipe_schedule_shim(ranks):
    w, x, _ = _apply_data(2)
    h = torch.tensor(x)
    for wi in w:
        h = _stage(torch.tensor(wi), h)
    for rank in ranks["ranks"]:
        got = rank["gpipe_schedule"]
        if got["stage"] == 1:
            np.testing.assert_allclose(got["out"], h.numpy(), atol=TOL_APPLY)


def test_ranks_load_neither_jax_nor_the_reference(ranks):
    assert all(rank["modules"] == [] for rank in ranks["ranks"])


# -- one process ------------------------------------------------------------------

def test_virtual_stages_3_matches_reference():
    """6 layers in 3 chunks of 2 at pp 1: the chunks hand their outputs on
    within the process (no send), chunk 0 holds min(M, 2 v - 1) = 4
    microbatches; 10 losses and the weights against the reference's
    ``virtual_stages=3``."""
    weights6 = seeded_params(BertModel(**CFG6), seed=6)
    net = _net(weights6, CFG6)
    tr = _trainer(net, {"pp": 1}, 4, ADAM, virtual_stages=3)
    x, y = _xy(1)
    losses = [float(tr.step(x, y)) for _ in range(STEPS)]
    assert tr.last_stats == {"ticks": 4 + 2 * 2, "max_in_flight": 4, "sends": 0, "bytes": 0,
                             "comm": {}}
    assert tr._stack_order == list(range(6))
    import jax
    import mxnet_tpu as mx
    from mxnet_tpu.models.bert import BertModel as RefBert
    from mxnet_tpu.parallel import PipelineTrainer as RefPipeline
    from mxnet_tpu.parallel import make_mesh as ref_mesh
    from mxnet_tpu.recipes.moe import token_cross_entropy as ref_loss
    ref = RefBert(**CFG6)
    ref.initialize(ctx=mx.cpu())
    for key, p in ref._collect_params_with_prefix().items():
        p.set_data(mx.nd.array(weights6[key], ctx=mx.cpu()))
    rtr = RefPipeline(ref, ref_loss, optimizer=ADAM[0], optimizer_params=dict(ADAM[1]),
                      mesh=ref_mesh({"pp": 1}, devices=jax.devices("cpu")[:1]),
                      num_microbatch=4, schedule="1f1b", virtual_stages=3)
    rx, ry = (mx.nd.array(a, dtype="int32") for a in _batch(1))
    want = [float(rtr.step(rx, ry)) for _ in range(STEPS)]
    np.testing.assert_allclose(losses, want, rtol=TOL_LOSS)
    rtr.sync()
    got = _params(net)
    for key, p in ref._collect_params_with_prefix().items():
        assert np.abs(got[key] - p.data().asnumpy()).max() <= TOL_W, key


def test_pipeline_apply_one_stage():
    """Without a mesh, one stage: the output and the gradients of the
    chain of that stage."""
    w, x, cot = _apply_data(1)
    out, dw, dx = _chain(w, x, cot)
    ws = torch.tensor(w[0], requires_grad=True)
    xs = torch.tensor(x, requires_grad=True)
    got = pipeline_apply(lambda p, h, t: _stage(p[0], h), [ws], xs)
    (got * torch.tensor(cot)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), out, atol=TOL_APPLY)
    np.testing.assert_allclose(ws.grad.numpy(), dw[0], atol=TOL_APPLY)
    np.testing.assert_allclose(xs.grad.numpy(), dx, atol=TOL_APPLY)


def test_gpipe_remat_recompute_draws_the_same_dropout(weights):
    """With dropout 0.1 at pp 1 and the same seed, GPipe with remat (whose
    backward runs each stage forward again) draws the masks of GPipe
    without it: 5 losses and the weights agree at the f32 tolerances; a run
    of another seed differs. (1F1B draws the embed's masks in another
    order: each microbatch's embed just before its cells.)"""
    x, y = _xy(2)
    runs = {}
    for name, kw, seed in (("noremat", dict(GPIPE, remat=False), 5), ("remat", GPIPE, 5),
                           ("other", GPIPE, 6)):
        net = BertModel(**dict(CFG, dropout=0.1))
        net.initialize(ctx=mt.cpu())
        load_jax_params(net, weights)
        mt.random.seed(seed)
        tr = _trainer(net, {"pp": 1}, 4, ADAM, **kw)
        runs[name] = ([float(tr.step(x, y)) for _ in range(5)], _params(net))
    base, wb = runs["noremat"]
    losses, w = runs["remat"]
    np.testing.assert_allclose(losses, base, rtol=TOL_LOSS)
    for key in wb:
        assert np.abs(w[key] - wb[key]).max() <= TOL_W, key
    assert abs(runs["other"][0][0] - base[0]) > 1e-4


def test_refusals(weights):
    """The reference's (``test_pipeline_1f1b.py:336-357``): ``virtual_stages``
    without 1F1B, layers that do not divide into pp x v chunks, and
    ``virtual_stages`` below 1."""
    net = _net(weights)
    with pytest.raises(MXNetError, match="requires schedule='1f1b'"):
        PipelineTrainer(net, token_cross_entropy, mesh=Mesh([mt.cpu()], ("pp",), (2,)),
                        schedule="gpipe", virtual_stages=2)
    with pytest.raises(MXNetError, match="do not divide into 2 pipeline stages x 4"):
        PipelineTrainer(net, token_cross_entropy, mesh=Mesh([mt.cpu()], ("pp",), (2,)),
                        virtual_stages=4)
    with pytest.raises(MXNetError, match="virtual_stages must be >= 1"):
        PipelineTrainer(net, token_cross_entropy, mesh=make_mesh({"pp": 1}, devices=[mt.cpu()]),
                        virtual_stages=0)
