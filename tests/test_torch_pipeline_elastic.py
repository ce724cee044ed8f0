"""Pipeline snapshots (the ``pp`` kind of ``elastic/state.py``) against the
reference's, on the CPU.

The model, weights and batch are ``test_torch_pipeline.py``'s (the
reference's pipeline tests' BERT, 4 layers, batch (8, 8)), at M = 4.

- 2 gloo ranks (one spawn), ``{pp: 2}``: the reference's
  ``test_kill_resume_pp_parity`` (``tests/test_elastic.py:149-163``: SGD lr
  0.5, a snapshot after step 5, ``resume_or_init`` -> ``(5, "resumed")``,
  steps 6-10 equal to the uninterrupted run's at rtol 1e-6); a snapshot the
  reference's ``PipelineTrainer`` wrote on 2 CPU devices after 3 Adam steps,
  installed by the port's ranks, and 3 more steps against the reference's;
  the port's snapshot after 3 Adam steps, written by both ranks (each its
  stage's rows of every stage leaf, rank 0 the embed and head), installed
  into the reference's trainer in this process, and 3 more steps against the
  port's; the same snapshot resumed on ``{pp: 1, dp: 2}`` through
  ``resume_or_init``: ``(3, "resharded")``, step 4 against the pp2 run's.
  The schedules (the reference's ``test_pp_cross_config_resharded``,
  ``tests/test_elastic.py:187-200``): an interleaved ``virtual_stages=2``
  snapshot after 5 SGD steps (stack order [0, 2, 1, 3]) resumed at v 1
  through ``resume_or_init``: ``(5, "resharded")``, steps 6-10 against the
  uninterrupted v 1 run's; the reference's v 2 snapshot after 3 Adam steps
  installed by the port's v 1 ranks, and the port's v 2 snapshot installed
  into the reference's v 1 trainer, 3 more steps each against the other
  package's v 2 run; a GPipe snapshot after 3 Adam steps resumed under 1F1B
  (``(3, "resharded")``: another step program), 3 more steps against the
  GPipe run's.
- In one process: ``state_dict()`` and ``load_state_dict`` at pp 1, the
  leaf names and shapes and meta keys against the reference's ``capture``.
  The ZeRO and tensor-parallel layouts of the kind are
  ``test_torch_pipeline_tp.py``'s.

Tolerances: the resume of a run in one package, rtol 1e-6 (the reference's
own); across the packages, and across schedules (v 2 to v 1, GPipe to
1F1B: the order of the gradient sums differs), losses 1e-5 relative
(``test_torch_pipeline.py``'s); v 2 to v 1 through SGD lr 0.5, rtol 2e-5,
atol 1e-6, the reference's own (``tests/test_elastic.py:200``).
"""
import os
import sys

import numpy as np
import pytest
import torch

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import elastic
from mxnet_tpu_torch import _dist_util
from mxnet_tpu_torch.elastic import state as es
from mxnet_tpu_torch.parallel import PipelineTrainer, make_mesh
from torch_threads import one_torch_thread  # noqa: F401

TESTS_DIR = os.path.dirname(os.path.abspath(__file__))
if TESTS_DIR not in sys.path:
    sys.path.insert(0, TESTS_DIR)
from test_torch_pipeline import CFG, _batch, _net, _xy, token_ce  # noqa: E402

M = 4
ADAM = ("adam", {"learning_rate": 1e-2})
SGD = ("sgd", {"learning_rate": 0.5, "wd": 0.0})
TOL_RESUME = 1e-6
TOL_LOSS = 1e-5
TOL_RESHARD = (2e-5, 1e-6)      # rtol, atol
MODULE = "test_torch_pipeline_elastic"


def _trainer(weights, axes, opt=ADAM, seed=None, **kw):
    """The port's trainer on ``axes``: the weights, or with ``weights`` None
    its own initial weights (a rebuilt trainer before a resume)."""
    if weights is None:
        from mxnet_tpu_torch.models import BertModel
        mt.random.seed(seed)
        net = BertModel(**CFG)
        net.initialize(ctx=mt.cpu())
    else:
        net = _net(weights)
    return PipelineTrainer(net, token_ce, opt[0], opt[1],
                           mesh=make_mesh(axes, devices=[mt.cpu()]), num_microbatch=M, **kw)


def rank_pipeline_elastic(workdir):
    """One of 2 ranks: the kill-resume parity, the reference's snapshot, the
    port's snapshot and its pp2 -> pp1 x dp2 resume."""
    weights = dict(np.load(f"{workdir}/weights.npz"))
    x, y = _xy(*_batch())
    out = {"rank": torch.distributed.get_rank()}
    # the reference's kill-and-resume parity, pp = 2
    ref = _trainer(weights, {"pp": 2}, SGD)
    ref_losses = [float(ref.step(x, y)) for _ in range(10)]
    tr = _trainer(weights, {"pp": 2}, SGD)
    for _ in range(5):
        tr.step(x, y)
    elastic.save_trainer(elastic.SnapshotManager(f"{workdir}/kill"), tr, wait=True)
    _, tr2, start, outcome = elastic.resume_or_init(
        f"{workdir}/kill", lambda: _trainer(None, {"pp": 2}, SGD, seed=9))
    out["kill"] = {"start": start, "outcome": outcome, "want": ref_losses[5:],
                   "got": [float(tr2.step(x, y)) for _ in range(5)]}
    # the reference's snapshot, installed here
    tr = _trainer(None, {"pp": 2}, seed=7)
    with elastic.SnapshotReader(f"{workdir}/ref", 3) as rd:
        es.install(tr, rd.manifest["meta"], rd, rd.names - {"rng"})
    out["from_ref"] = [float(tr.step(x, y)) for _ in range(3)]
    # the port's snapshot for the reference, and for {pp: 1, dp: 2}
    tr = _trainer(weights, {"pp": 2})
    for _ in range(3):
        tr.step(x, y)
    elastic.save_trainer(elastic.SnapshotManager(f"{workdir}/port"), tr, wait=True)
    out["port"] = [float(tr.step(x, y)) for _ in range(3)]
    _, tr3, start, outcome = elastic.resume_or_init(
        f"{workdir}/port", lambda: _trainer(None, {"pp": 1, "dp": 2}, seed=8, dp_axis="dp"))
    out["reshard"] = {"start": start, "outcome": outcome, "loss": float(tr3.step(x, y)),
                      "layers": list(tr3._own)}
    # an interleaved v 2 snapshot resumed at v 1 (steps 6-10 of ``ref``)
    tr = _trainer(weights, {"pp": 2}, SGD, virtual_stages=2)
    for _ in range(5):
        tr.step(x, y)
    elastic.save_trainer(elastic.SnapshotManager(f"{workdir}/v2"), tr, wait=True)
    _, tr2, start, outcome = elastic.resume_or_init(
        f"{workdir}/v2", lambda: _trainer(None, {"pp": 2}, SGD, seed=10))
    out["v2_to_v1"] = {"start": start, "outcome": outcome, "order": list(tr._stack_order),
                       "own": list(tr._own), "want": ref_losses[5:],
                       "got": [float(tr2.step(x, y)) for _ in range(5)]}
    # the reference's v 2 snapshot at v 1; the port's v 2 snapshot for it
    tr = _trainer(None, {"pp": 2}, seed=12)
    with elastic.SnapshotReader(f"{workdir}/ref_v2", 3) as rd:
        es.install(tr, rd.manifest["meta"], rd, rd.names - {"rng"})
    out["from_ref_v2"] = [float(tr.step(x, y)) for _ in range(3)]
    tr = _trainer(weights, {"pp": 2}, virtual_stages=2)
    for _ in range(3):
        tr.step(x, y)
    elastic.save_trainer(elastic.SnapshotManager(f"{workdir}/port_v2"), tr, wait=True)
    out["port_v2"] = [float(tr.step(x, y)) for _ in range(3)]
    # a GPipe snapshot resumed under 1F1B
    tr = _trainer(weights, {"pp": 2}, schedule="gpipe")
    for _ in range(3):
        tr.step(x, y)
    elastic.save_trainer(elastic.SnapshotManager(f"{workdir}/gpipe"), tr, wait=True)
    want = [float(tr.step(x, y)) for _ in range(3)]
    _, tr2, start, outcome = elastic.resume_or_init(
        f"{workdir}/gpipe", lambda: _trainer(None, {"pp": 2}, seed=13))
    out["gpipe_to_1f1b"] = {"start": start, "outcome": outcome, "schedule": tr2.schedule,
                            "want": want, "got": [float(tr2.step(x, y)) for _ in range(3)]}
    return out


@pytest.fixture(scope="module")
def weights():
    from mxnet_tpu_torch.convert import seeded_params
    from mxnet_tpu_torch.models import BertModel
    return seeded_params(BertModel(**CFG), seed=3)


def _ref_trainer(weights, seed=None, virtual_stages=1):
    """The reference's PipelineTrainer on 2 CPU devices, Adam lr 1e-2."""
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
    if seed is not None:
        mx.random.seed(seed)
    net = RefBert(**CFG)
    net.initialize(ctx=mx.cpu())
    if weights is not None:
        for key, p in net._collect_params_with_prefix().items():
            p.set_data(mx.nd.array(weights[key], ctx=mx.cpu()))
    return RefPipeline(net, loss, optimizer=ADAM[0], optimizer_params=ADAM[1],
                       mesh=ref_mesh({"pp": 2}, devices=jax.devices("cpu")[:2]),
                       num_microbatch=M, schedule="1f1b", virtual_stages=virtual_stages)


def _ref_xy():
    import mxnet_tpu as mx
    x, y = _batch()
    return mx.nd.array(x, dtype="int32"), mx.nd.array(y, dtype="int32")


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, weights):
    from mxnet_tpu import elastic as ref_elastic
    root = tmp_path_factory.mktemp("pipeline_elastic")
    np.savez(root / "weights.npz", **weights)
    rtr = _ref_trainer(weights)
    x, y = _ref_xy()
    for _ in range(3):
        rtr.step(x, y)
    ref_elastic.save_trainer(ref_elastic.SnapshotManager(str(root / "ref")), rtr, wait=True)
    ref_next = [float(rtr.step(x, y)) for _ in range(3)]
    rtr = _ref_trainer(weights, virtual_stages=2)
    for _ in range(3):
        rtr.step(x, y)
    ref_elastic.save_trainer(ref_elastic.SnapshotManager(str(root / "ref_v2")), rtr, wait=True)
    ref_next_v2 = [float(rtr.step(x, y)) for _ in range(3)]
    out = _dist_util.launch_local(f"{MODULE}:rank_pipeline_elastic", 2, {"workdir": str(root)},
                                  device="cpu", timeout=240, pythonpath=[TESTS_DIR],
                                  workdir=str(root / "launch"))
    # the port's snapshot, into the reference
    rtr2 = _ref_trainer(None, seed=11)
    man = ref_elastic.manifest.load(str(root / "port"), 3)
    with ref_elastic.SnapshotReader(str(root / "port"), 3) as rd:
        ref_elastic.install(rtr2, man["meta"], rd, set(rd.names) - {"rng"})
    from_port = [float(rtr2.step(x, y)) for _ in range(3)]
    chunks = {name: sorted(c["index"][0] for c in cs) for name, cs in man["chunks"].items()}
    # the port's v 2 snapshot, into the reference's v 1 trainer
    rtr3 = _ref_trainer(None, seed=14)
    man_v2 = ref_elastic.manifest.load(str(root / "port_v2"), 3)
    with ref_elastic.SnapshotReader(str(root / "port_v2"), 3) as rd:
        ref_elastic.install(rtr3, man_v2["meta"], rd, set(rd.names) - {"rng"})
    from_port_v2 = [float(rtr3.step(x, y)) for _ in range(3)]
    return {"ranks": out, "ref_next": ref_next, "from_port": from_port, "chunks": chunks,
            "meta": man["meta"], "ref_next_v2": ref_next_v2, "from_port_v2": from_port_v2,
            "meta_v2": man_v2["meta"]}


def test_kill_resume_pp_parity(ranks):
    for rank in ranks["ranks"]:
        k = rank["kill"]
        assert (k["start"], k["outcome"]) == (5, "resumed")
        np.testing.assert_allclose(k["got"], k["want"], rtol=TOL_RESUME, atol=1e-7)


def test_reference_snapshot_resumes_on_port_ranks(ranks):
    for rank in ranks["ranks"]:
        np.testing.assert_allclose(rank["from_ref"], ranks["ref_next"], rtol=TOL_LOSS)


def test_port_snapshot_resumes_in_the_reference(ranks):
    """Each stage's rows of a stage leaf come from its own rank, the whole
    replicated leaves from rank 0; the reference installs the result."""
    assert ranks["chunks"]["param.s.0"] == [[0, 2], [2, 4]]
    assert ranks["chunks"]["opt.s.0.1"] == [[0, 2], [2, 4]]
    assert ranks["chunks"]["param.e.0"] == [[0, CFG["vocab_size"]]]
    meta = ranks["meta"]
    assert (meta["kind"], meta["n_stages"], meta["n_layers"], meta["stack_order"],
            meta["zero"], meta["dp_degree"]) == ("pp", 2, 4, [0, 1, 2, 3], False, 1)
    for rank in ranks["ranks"]:
        np.testing.assert_allclose(ranks["from_port"], rank["port"], rtol=TOL_LOSS)


def test_pp2_snapshot_reshards_onto_pp1_dp2(ranks):
    for rank in ranks["ranks"]:
        r = rank["reshard"]
        assert (r["start"], r["outcome"]) == (3, "resharded")
        assert r["layers"] == [0, 1, 2, 3]
        assert abs(r["loss"] - rank["port"][0]) <= TOL_LOSS * abs(rank["port"][0])


def test_interleaved_snapshot_resumes_at_v1(ranks):
    """The reference's ``test_pp_cross_config_resharded``: the stage rows are
    saved in the v 2 stack order and permuted back at v 1."""
    for rank in ranks["ranks"]:
        r = rank["v2_to_v1"]
        assert r["order"] == [0, 2, 1, 3]
        assert (r["start"], r["outcome"]) == (5, "resharded")
        np.testing.assert_allclose(r["got"], r["want"], rtol=TOL_RESHARD[0],
                                   atol=TOL_RESHARD[1])


def test_interleaved_snapshots_across_the_packages(ranks):
    """A v 2 snapshot of either package resumes at v 1 in the other."""
    meta = ranks["meta_v2"]
    assert (meta["virtual_stages"], meta["stack_order"]) == (2, [0, 2, 1, 3])
    for rank in ranks["ranks"]:
        np.testing.assert_allclose(rank["from_ref_v2"], ranks["ref_next_v2"], rtol=TOL_LOSS)
        np.testing.assert_allclose(ranks["from_port_v2"], rank["port_v2"], rtol=TOL_LOSS)


def test_gpipe_snapshot_resumes_under_1f1b(ranks):
    for rank in ranks["ranks"]:
        r = rank["gpipe_to_1f1b"]
        assert (r["start"], r["outcome"], r["schedule"]) == (3, "resharded", "1f1b")
        np.testing.assert_allclose(r["got"], r["want"], rtol=TOL_LOSS)


# -- one process -------------------------------------------------------------------------

def test_state_dict_round_trip(weights):
    x, y = _xy(*_batch())
    tr = _trainer(weights, {"pp": 1})
    for _ in range(3):
        tr.step(x, y)
    snap = tr.state_dict()
    want = [float(tr.step(x, y)) for _ in range(2)]
    tr2 = _trainer(None, {"pp": 1}, seed=4)
    tr2.load_state_dict(snap)
    assert tr2.num_update == 3
    assert [float(tr2.step(x, y)) for _ in range(2)] == want


def test_capture_matches_reference_schema(weights):
    """Leaf names, global shapes and meta keys are the reference's."""
    from mxnet_tpu.elastic import state as ref_state
    ref = ref_state.capture(_ref_trainer(weights))
    port = es.capture(_trainer(weights, {"pp": 1}))
    shapes = {k: tuple(np.shape(v)) for k, v in ref["leaves"].items() if k != "rng"}
    assert {k: tuple(v.shape) for k, v in port["leaves"].items() if k != "rng"} == shapes
    assert set(ref["meta"]) <= set(port["meta"])
    for key in ("kind", "n_e", "n_s", "n_h", "n_layers", "virtual_stages", "stack_order",
                "zero", "tp_mode", "tp_degree", "sequence_parallel", "optimizer"):
        assert port["meta"][key] == ref["meta"][key], key

