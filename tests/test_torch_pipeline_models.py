"""``LongContextLM`` and ``MoETransformerLM`` in the port's pipeline against
the reference's, on the CPU.

The models are narrow copies of the recipes' (vocab 64, 4 layers, units 32,
hidden 64, 2 heads, max_length 16; the MoE with 4 experts, top-1, capacity
factor 2, ``test_torch_moe_recipe.py``'s gating), weights from ``convert.seeded_params`` loaded into both
packages, batches (8, 16) of tokens from a numpy seed, the mean token cross
entropy (``recipes.long_context.token_cross_entropy``), Adam lr 1e-2, M = 2.

- One 4-rank gloo spawn, in a thread while this process runs the
  reference's ``PipelineTrainer`` on CPU devices: each model's
  ``pipeline_split`` under 1F1B at ``{pp: 2}`` (a ``rep`` axis carrying no
  data makes it 4 ranks) and under ``tp_mode="partitioned"`` at ``{pp: 2,
  tp: 2}`` (the partitioned cell's causal branch, and ``_tp_moe`` with the
  experts split over tp), 10 losses and the weights after ``sync()``; no
  jax or reference module loaded.
- In one process: ``LongContextLM`` at pp 1 against ``LongContextTrainer``'s
  step on the same weights and batch (the microbatch means average to the
  batch mean); the split's shared blocks.

Tolerances (f32; only the order of summation differs): losses 1e-5
relative over the 10 steps; weights 2e-5 absolute, after the 10 steps for
``LongContextLM`` (``test_torch_pipeline.py``'s) and after 3 for the MoE
(``test_torch_moe_recipe.py``'s). Under top-1 the normalized combine weight
is g/g = 1: the task loss gives the gate no gradient but f32 rounding,
different in the two packages, which Adam scales up to steps of up to lr,
and those gates move the whole model apart slowly (read after 10 steps:
gate_w 3.1e-5, word_embed 2.0e-5 at pp 2 and 4.2e-5 at tp 2; after 3 steps
all below 1e-5). With top-2 the gate learns, but at step 6 one (token,
expert) assignment of layer 2 flips between the packages at a near tie, in
the one-stage run as in the pipeline, and the losses part by 2e-5 to 7e-4
after it. The MoE's capacity is a microbatch's in both packages, so the
pipeline's losses are not ``MoETrainer``'s full-batch ones; they are held
against the reference's pipeline.
"""
import os
import sys
import threading

import numpy as np
import pytest
import torch

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import _dist_util
from mxnet_tpu_torch.convert import load_jax_params, seeded_params
from mxnet_tpu_torch.models.moe_transformer import MoETransformerLM
from mxnet_tpu_torch.parallel import PipelineTrainer, make_mesh
from mxnet_tpu_torch.recipes.long_context import (LongContextLM, LongContextTrainer,
                                                   token_cross_entropy)
from torch_threads import one_torch_thread  # noqa: F401

V, B, T, M = 64, 8, 16, 2
LC_CFG = dict(num_layers=4, units=32, hidden_size=64, num_heads=2, max_length=T)
MOE_CFG = dict(LC_CFG, num_experts=4, top_k=1, capacity_factor=2.0)
STEPS = 10
W_STEP = {"lc": STEPS, "moe": 3}      # the step after which the weights are held
TOL_LOSS, TOL_W = 1e-5, 2e-5
ADAM = {"learning_rate": 1e-2}
PART = dict(tp_axis="tp", tp_mode="partitioned")
MODELS = {"lc": (LongContextLM, LC_CFG), "moe": (MoETransformerLM, MOE_CFG)}
# name -> (model, port mesh, reference mesh, trainer keywords)
RUNS = {f"{model}_{kind}": (model, *layout)
        for model in MODELS
        for kind, layout in (("pp2", ({"rep": 2, "pp": 2}, {"pp": 2}, {})),
                             ("tp2", ({"pp": 2, "tp": 2}, {"pp": 2, "tp": 2}, PART)))}
MODULE = "test_torch_pipeline_models"
TESTS_DIR = os.path.dirname(os.path.abspath(__file__))


def _batch(seed=0):
    rs = np.random.RandomState(seed)
    return (rs.randint(0, V, (B, T)).astype(np.int32),
            rs.randint(0, V, (B, T)).astype(np.int32))


def _xy(seed=0):
    return tuple(mt.nd.array(a, ctx=mt.cpu(), dtype="int32") for a in _batch(seed))


def _net(model, weights):
    cls, cfg = MODELS[model]
    net = cls(V, **cfg)
    net.initialize(ctx=mt.cpu())
    load_jax_params(net, weights)
    return net


def _params(net):
    return {k: p._param.detach().numpy().copy()
            for k, p in net._collect_params_with_prefix().items()}


# -- the ranks -----------------------------------------------------------------------

def rank_pipeline_models(workdir):
    """One of 4 ranks: each of RUNS."""
    x, y = _xy()
    rank = torch.distributed.get_rank()
    out = {"rank": rank}
    for name, (model, axes, _, kw) in RUNS.items():
        net = _net(model, dict(np.load(f"{workdir}/{model}.npz")))
        tr = PipelineTrainer(net, token_cross_entropy, "adam", dict(ADAM),
                             mesh=make_mesh(axes, devices=[mt.cpu()]), num_microbatch=M, **kw)
        losses = []
        for i in range(STEPS):
            losses.append(float(tr.step(x, y)))
            if i + 1 == W_STEP[model]:
                tr.sync()
                np.savez(f"{workdir}/{name}_w{rank}.npz", **_params(net))
        out[name] = {"losses": losses, "stage": tr.stage}
    out["modules"] = sorted(m for m in sys.modules
                            if m.split(".")[0] in ("jax", "jaxlib", "mxnet_tpu"))
    return out


# -- the reference ----------------------------------------------------------------------

def _ref_net(model, weights):
    import mxnet_tpu as mx
    from mxnet_tpu.models.moe_transformer import MoETransformerLM as RefMoE
    from mxnet_tpu.recipes.long_context import LongContextLM as RefLC
    cls, cfg = {"lc": (RefLC, LC_CFG), "moe": (RefMoE, MOE_CFG)}[model]
    net = cls(V, **cfg)
    net.initialize(ctx=mx.cpu())
    for key, p in net._collect_params_with_prefix().items():
        p.set_data(mx.nd.array(weights[key], ctx=mx.cpu()))
    return net


def _ref_runs(weights):
    import jax
    import mxnet_tpu as mx
    from mxnet_tpu.parallel import PipelineTrainer as RefPipeline
    from mxnet_tpu.parallel import make_mesh as ref_mesh
    from mxnet_tpu.recipes.moe import token_cross_entropy as ref_loss
    x, y = (mx.nd.array(a, dtype="int32") for a in _batch())
    out = {}
    for name, (model, _, axes, kw) in RUNS.items():
        net = _ref_net(model, weights[model])
        n = int(np.prod(list(axes.values())))
        tr = RefPipeline(net, ref_loss, optimizer="adam", optimizer_params=dict(ADAM),
                         mesh=ref_mesh(axes, devices=jax.devices("cpu")[:n]),
                         num_microbatch=M, schedule="1f1b", **kw)
        losses, w = [], None
        for i in range(STEPS):
            losses.append(float(tr.step(x, y)))
            if i + 1 == W_STEP[model]:
                tr.sync()
                w = {k: np.asarray(p.data().asnumpy())
                     for k, p in net._collect_params_with_prefix().items()}
        out[name] = (losses, w)
    return out


@pytest.fixture(scope="module")
def weights():
    return {model: seeded_params(cls(V, **cfg), seed=21 + i)
            for i, (model, (cls, cfg)) in enumerate(MODELS.items())}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, weights):
    root = tmp_path_factory.mktemp("pipeline_models")
    for model, w in weights.items():
        np.savez(root / f"{model}.npz", **w)
    result = {}

    def spawn():
        try:
            result["ranks"] = _dist_util.launch_local(
                f"{MODULE}:rank_pipeline_models", 4, {"workdir": str(root)}, device="cpu",
                timeout=300, pythonpath=[TESTS_DIR], workdir=str(root / "launch"))
        except Exception as e:          # re-raised in the test process below
            result["error"] = e
    thread = threading.Thread(target=spawn)
    thread.start()
    try:
        ref = _ref_runs(weights)
    finally:
        thread.join()
    if "error" in result:
        raise result["error"]
    files = {p.name[:-4]: dict(np.load(p)) for p in root.glob("*_w*.npz")}
    return {"ref": ref, "ranks": result["ranks"], "files": files}


@pytest.mark.parametrize("name", list(RUNS))
def test_ranks_match_reference(ranks, name):
    """Each model's split under 1F1B and partitioned tp: 10 losses and the
    weights after ``sync()`` (at ``W_STEP``) on every rank against the
    reference's pipeline of the same mesh."""
    ref_losses, ref_w = ranks["ref"][name]
    for rank in ranks["ranks"]:
        losses = rank[name]["losses"]
        np.testing.assert_allclose(losses, ref_losses, rtol=TOL_LOSS)
        assert losses[-1] < losses[0]
        got = ranks["files"][f"{name}_w{rank['rank']}"]
        assert set(got) == set(ref_w)
        for key, w in ref_w.items():
            assert np.abs(got[key] - w).max() <= TOL_W, (name, rank["rank"], key)


def test_ranks_load_neither_jax_nor_the_reference(ranks):
    assert all(rank["modules"] == [] for rank in ranks["ranks"])


# -- one process ------------------------------------------------------------------

def test_lc_pp1_matches_long_context_trainer(weights):
    """At pp 1 in M = 4 microbatches the pipeline's 3 losses and weights
    equal ``LongContextTrainer``'s full-batch step on ``{dp: 1, sp: 1}``: the
    mean of the microbatch means is the batch mean."""
    x, y = _xy(1)
    n1, n2 = _net("lc", weights["lc"]), _net("lc", weights["lc"])
    lct = LongContextTrainer(n1, token_cross_entropy, "adam", dict(ADAM),
                             mesh=make_mesh({"dp": 1, "sp": 1}, devices=[mt.cpu()]))
    tr = PipelineTrainer(n2, token_cross_entropy, "adam", dict(ADAM),
                         mesh=make_mesh({"pp": 1}, devices=[mt.cpu()]), num_microbatch=4)
    want = [float(lct.step(x, y)) for _ in range(3)]
    got = [float(tr.step(x, y)) for _ in range(3)]
    np.testing.assert_allclose(got, want, rtol=TOL_LOSS)
    a, b = _params(n1), _params(n2)
    for key, w in a.items():
        assert np.abs(b[key] - w).max() <= TOL_W, key


@pytest.mark.parametrize("model", list(MODELS))
def test_pipeline_split_shares_parameters(weights, model):
    """The wrappers re-register the model's own blocks: the same Parameters,
    and embed -> cells -> head is the model's forward."""
    net = _net(model, weights[model])
    embed, cells, head = net.pipeline_split()
    shared = {id(p) for p in net.collect_params().values()}
    split = [p for b in (embed, head, *cells) for p in b.collect_params().values()]
    assert len(split) == len(shared) and all(id(p) in shared for p in split)
    assert cells == [net.cells[i] for i in range(LC_CFG["num_layers"])]
    assert embed.word_embed is net.word_embed and head.decoder is net.decoder
    x, _ = _xy(2)
    h = embed(x)
    for c in cells:
        h = c(h)
    torch.testing.assert_close(head(h)._data, net(x)._data, rtol=0, atol=0)
