"""The fused step's optimizer rules against the reference's, on the CPU.

``parallel.functional_optimizer`` dispatches in the reference's order
(``mxnet_tpu/parallel/data_parallel.py:77-182``): AdamW, LAMB, Adam, LARS,
NAG, RMSProp (not centered), AdaGrad, SGD; it refuses the rest with the
reference's words. Held here:

- the dispatch and the refusals; each rule's scalars read only from its
  ``_hyper`` row (the optimizer changed after the row was written changes
  nothing; another row gives the class path's result at that row's t and
  lr);
- each rule against the class path (``Updater``, a parameter at a time) on
  the same tensors over 3 steps: 1e-6 of each tensor's max (the same
  formulas, lr and the bias corrections rounded apart);
- the six new rules' trajectories on the narrow BERT of
  ``tests/test_torch_data_parallel.py`` against the reference's
  ``DataParallelTrainer`` on a one-device mesh, 10 steps at that file's
  Adam tolerances: loss 1e-5 relative, weights 2e-5 absolute, the first
  state 1e-4 and the second 1e-3 of each tensor's max; LAMB under a
  ``FactorScheduler``;
- LAMB in float16 from the default scale 2^16: the first step overflows,
  every weight and state keeps its value bitwise, and the losses, the
  weights and the scale follow the reference's;
- the pipeline at pp 1 with LAMB and with LARS against the reference's
  ``PipelineTrainer`` (10 steps, the tolerances of
  ``tests/test_torch_pipeline.py``): LAMB's and LARS's norms there are
  over the stage's stacked layers of each cell parameter, as the
  reference's stacked leaf;
- the overlapped step (a world-1 gloo group) with LAMB equal to the plain
  step; LAMB, AdamW and LARS snapshots (states of two and one tensors)
  resuming bitwise through ``elastic`` and ``checkpoint``; the recipes'
  refusals of LAMB and LARS.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import _dist_util, elastic
from mxnet_tpu_torch import optimizer as opt_mod
from mxnet_tpu_torch.checkpoint import CheckpointManager, restore_trainer, save_trainer
from mxnet_tpu_torch.convert import load_jax_params, seeded_params
from mxnet_tpu_torch.models import BertModel
from mxnet_tpu_torch.ops.cuda import fused_optimizer as fo
from mxnet_tpu_torch.parallel import DataParallelTrainer, PipelineTrainer, make_mesh
from mxnet_tpu_torch.parallel.data_parallel import functional_optimizer
from torch_threads import one_torch_thread  # noqa: F401

CFG = dict(vocab_size=1024, num_layers=2, units=128, hidden_size=512, num_heads=2,
           max_length=256)
B, T = 2, 64
STEPS = 10
TOL_LOSS = 1e-5
TOL_W = 2e-5
# (id, optimizer, params): the six new rules on BERT
RULES = [
    ("adamw", "adamw", {"learning_rate": 1e-3, "wd": 0.01}),
    ("lamb", "lamb", {"learning_rate": 1e-3, "wd": 0.01}),
    ("lars", "lars", {"learning_rate": 0.1, "momentum": 0.9, "eta": 0.001, "wd": 5e-5}),
    ("nag", "nag", {"learning_rate": 0.05, "momentum": 0.9, "wd": 1e-4}),
    ("rmsprop", "rmsprop", {"learning_rate": 1e-3, "wd": 1e-4}),
    ("adagrad", "adagrad", {"learning_rate": 1e-3, "wd": 1e-4}),
]
# every optimizer the fused step takes, with the fields of its row
DISPATCH = [("adamw", {"eta": 0.5}, "eta"), ("lamb", {}, "lower_bound"),
            ("adam", {}, "c1"), ("lars", {"momentum": 0.9}, "eta"),
            ("nag", {"momentum": 0.9}, "momentum"), ("rmsprop", {}, "rho"),
            ("adagrad", {}, "epsilon"), ("sgd", {"momentum": 0.9}, "momentum"),
            ("lbsgd", {"momentum": 0.9}, "momentum"), ("ccsgd", {}, "momentum")]
REFUSED = [("rmsprop", {"centered": True}, "RMSProp"), ("signum", {}, "Signum"),
           ("ftml", {}, "FTML"), ("ftrl", {}, "Ftrl"), ("adadelta", {}, "AdaDelta"),
           ("adamax", {}, "Adamax"), ("nadam", {}, "Nadam"), ("sgld", {}, "SGLD"),
           ("dcasgd", {}, "DCASGD"), ("test", {}, "Test")]


@pytest.fixture(scope="module")
def ref():
    import mxnet_tpu as mx
    from mxnet_tpu.parallel import DataParallelTrainer as RefDPT, make_mesh as ref_mesh
    return mx, RefDPT, ref_mesh


def _rel(a, b):
    return float(np.abs(a - b).max()) / max(float(np.abs(b).max()), 1e-30)


# -- dispatch and the row --------------------------------------------------------

@pytest.mark.parametrize("name,kw,field", DISPATCH, ids=[d[0] for d in DISPATCH])
def test_dispatch_takes_the_reference_rules(name, kw, field):
    init, update, hyper = functional_optimizer(opt_mod.create(name, **kw))
    assert field in hyper.fields
    assert len(hyper(1, 0.1, 0.0)) == len(hyper.fields)
    if name in ("adam", "sgd", "lbsgd", "ccsgd"):
        assert hyper.fields == fo.HYPER_FIELDS     # K4/K5's, as their library checks
    state = init(torch.zeros(3))
    assert all(s.dtype == torch.float32 for s in state)


@pytest.mark.parametrize("name,kw,cls", REFUSED, ids=[r[2] for r in REFUSED])
def test_refuses_the_rest_with_the_reference_words(name, kw, cls):
    with pytest.raises(mt.MXNetError, match=f"no functional adapter for optimizer {cls}; "
                                            f"use gluon.Trainer or add one"):
        functional_optimizer(opt_mod.create(name, **kw))


NEW = ["adamw", "lamb", "lars", "nag", "rmsprop", "adagrad"]
CLASS_KW = {"adamw": {"eta": 0.5, "wd": 0.1}, "lamb": {"wd": 0.01, "upper_bound": 2.0},
            "lars": {"momentum": 0.9, "eta": 0.01, "wd": 0.01},
            "nag": {"momentum": 0.9, "wd": 0.01}, "rmsprop": {"wd": 0.01},
            "adagrad": {"wd": 0.01}, "adam": {"wd": 0.01}, "sgd": {"momentum": 0.9}}


def _tensors(seed, steps=3):
    rs = np.random.RandomState(seed)
    shapes = [(6, 5), (7,), (3, 2, 2)]
    ws = [torch.from_numpy(rs.normal(0, 1, s).astype(np.float32)) for s in shapes]
    gs = [[torch.from_numpy(rs.normal(0, 1, s).astype(np.float32)) for s in shapes]
          for _ in range(steps)]
    return ws, gs


def _fused_run(opt, ws, gs, lrs, clip=None):
    init, update, hyper = functional_optimizer(opt)
    ws = [w.clone() for w in ws]
    states = [init(w) for w in ws]
    for t, (step, lr) in enumerate(zip(gs, lrs), 1):
        h = torch.tensor(hyper(t, lr, opt._get_wd(0)), dtype=torch.float32)
        update(ws, step, states, h)
    return ws, states


def _class_run(opt, ws, gs, lrs):
    upd = opt_mod.get_updater(opt)
    ws = [mt.nd.array(w.numpy(), ctx=mt.cpu()) for w in ws]
    for step, lr in zip(gs, lrs):
        opt.set_learning_rate(lr)
        for i, (w, g) in enumerate(zip(ws, step)):
            upd(i, mt.nd.array(g.numpy(), ctx=mt.cpu()), w)
    states = [upd.states[i] for i in range(len(ws))]
    return [w._data for w in ws], [tuple(x._data for x in (s if isinstance(s, tuple) else
                                                            (s,) if s is not None else ()))
                                   for s in states]


@pytest.mark.parametrize("name", NEW + ["adam", "sgd"])
@pytest.mark.parametrize("clip", [None, 0.0, 0.5])
def test_fused_rule_matches_the_class_path(name, clip):
    ws, gs = _tensors(1)
    lrs = [0.05, 0.02, 0.01]
    kw = dict(CLASS_KW[name], clip_gradient=clip)
    fw, fs = _fused_run(opt_mod.create(name, **kw), ws, gs, lrs)
    cw, cs = _class_run(opt_mod.create(name, **kw), ws, gs, lrs)
    for a, b in zip(fw, cw):
        assert _rel(a.numpy(), b.numpy()) <= 1e-6
    for sa, sb in zip(fs, cs):
        for a, b in zip(sa, sb):
            assert _rel(a.numpy(), b.numpy()) <= 1e-6


@pytest.mark.parametrize("name", NEW)
def test_rules_read_lr_and_t_only_from_the_row(name):
    """The row is the step's input: the optimizer's lr, betas, eta and wd
    changed after the row was made change nothing; a row made for t = 3 and
    another lr gives that step's result."""
    opt = opt_mod.create(name, **CLASS_KW[name])
    init, update, hyper = functional_optimizer(opt)
    ws, gs = _tensors(2, steps=1)
    row = torch.tensor(hyper(3, 0.02, opt._get_wd(0)), dtype=torch.float32)
    results = []
    for mutate in (False, True):
        w2 = [w.clone() for w in ws]
        st = [init(w) for w in w2]
        if mutate:
            for attr in ("lr", "beta1", "beta2", "eta", "momentum", "gamma1", "epsilon",
                         "float_stable_eps", "wd", "rescale_grad"):
                if hasattr(opt, attr):
                    setattr(opt, attr, getattr(opt, attr) * 0.5 + 0.01)
            opt.num_update = 99
        update(w2, gs[0], st, row)
        results.append(w2)
    for a, b in zip(*results):
        assert torch.equal(a, b)
    other = opt_mod.create(name, **CLASS_KW[name])
    other.set_learning_rate(0.02)
    w3 = [mt.nd.array(w.numpy(), ctx=mt.cpu()) for w in ws]
    for i, (w, g) in enumerate(zip(w3, gs[0])):
        other._index_update_count[i] = 2                 # this update is t = 3
        other.update(i, w, mt.nd.array(g.numpy(), ctx=mt.cpu()), other.create_state(i, w))
    for a, b in zip(results[0], w3):
        assert _rel(a.numpy(), b.asnumpy()) <= 1e-6


def test_lamb_and_lars_norms_follow_stacks():
    """``stacks``: one norm over the stack's tensors together (the
    pipeline's layers of a cell parameter, the reference's stacked leaf),
    equal to the rule on the tensors concatenated."""
    for name in ("lamb", "lars"):
        opt = opt_mod.create(name, **CLASS_KW[name])
        init, update, hyper = functional_optimizer(opt)
        rs = np.random.RandomState(5)
        ws = [torch.from_numpy(rs.normal(0, 1, (4, 3)).astype(np.float32)) for _ in range(2)]
        gs = [torch.from_numpy(rs.normal(0, 1, (4, 3)).astype(np.float32)) for _ in range(2)]
        row = torch.tensor(hyper(1, 0.1, 0.01), dtype=torch.float32)
        a = [w.clone() for w in ws]
        update(a, gs, [init(w) for w in a], row, stacks=[[0, 1]])
        cat = [torch.cat(ws)]
        update(cat, [torch.cat(gs)], [init(cat[0])], row)
        assert _rel(torch.cat(a).numpy(), cat[0].numpy()) <= 1e-6


# -- the fused step on BERT against the reference's ---------------------------------

def _batch(seed):
    rs = np.random.RandomState(seed)
    return (rs.randint(0, CFG["vocab_size"], size=(B, T)).astype(np.int32),
            rs.randint(0, CFG["vocab_size"], size=(B, T)).astype(np.int32))


def _bert_pair(ref, seed=0):
    mx = ref[0]
    from mxnet_tpu.models.bert import BertModel as RefBert
    weights = seeded_params(BertModel(**CFG), seed=seed)
    port = BertModel(**CFG)
    port.initialize(ctx=mt.cpu())
    load_jax_params(port, weights)
    refnet = RefBert(**CFG)
    refnet.initialize(ctx=mx.cpu())
    for key, p in refnet._collect_params_with_prefix().items():
        p.set_data(mx.nd.array(weights[key], ctx=mx.cpu()))
    return port, refnet


def _weights(net):
    return {k: p.data().asnumpy() for k, p in net._collect_params_with_prefix().items()}


def _ref_leaves(st):
    if isinstance(st, (tuple, list)):
        return [x for s in st for x in _ref_leaves(s)]
    return [np.asarray(st)]


def _sched(pkg, name):
    return {"lr_scheduler": pkg.lr_scheduler.FactorScheduler(step=3, factor=0.5)} \
        if name == "lamb" else {}


@pytest.mark.parametrize("name,params", [r[1:] for r in RULES], ids=[r[0] for r in RULES])
def test_bert_trajectory_matches_reference(ref, name, params):
    mx, RefDPT, ref_mesh = ref
    port, refnet = _bert_pair(ref)
    x, y = _batch(1)
    pt = DataParallelTrainer(port, mt.gluon.loss.SoftmaxCrossEntropyLoss(), name,
                             dict(params, **_sched(mt, name)),
                             mesh=make_mesh({"dp": 1}, devices=[mt.cpu()]))
    rt = RefDPT(refnet, mx.gluon.loss.SoftmaxCrossEntropyLoss(), name,
                dict(params, **_sched(mx, name)), mesh=ref_mesh({"dp": 1}))
    xp, yp = mt.nd.array(x, ctx=mt.cpu()), mt.nd.array(y, ctx=mt.cpu(), dtype="int32")
    got = np.array([float(pt.step(xp, yp)) for _ in range(STEPS)])
    want = np.array([float(rt.step(mx.nd.array(x), mx.nd.array(y, dtype="int32")))
                     for _ in range(STEPS)])
    rt.sync()
    np.testing.assert_allclose(got, want, rtol=TOL_LOSS)
    assert got[-1] < got[0]
    pw, rw = _weights(port), _weights(refnet)
    for key, w in rw.items():
        assert np.abs(pw[key] - w).max() <= TOL_W, key
    for st, rst, p in zip(pt._opt_state, rt._opt_state, pt._plist):
        for k, (a, b) in enumerate(zip(st, _ref_leaves(rst))):
            assert _rel(a.numpy(), b) <= (1e-4, 1e-3)[k], (p.name, k)
    if name == "lamb":
        assert pt._hyper.shape == (1, len(pt._hyper_fn.fields))
        np.testing.assert_array_equal(
            pt._hyper[0].numpy(), np.float32(pt._hyper_fn(STEPS, np.float32(
                pt.optimizer.learning_rate), 0.01)))


def _mlp(pkg):
    net = pkg.gluon.nn.HybridSequential()
    net.add(pkg.gluon.nn.Dense(64, activation="relu", in_units=32))
    net.add(pkg.gluon.nn.Dense(10, in_units=64))
    return net


def test_lamb_float16_skips_the_overflowing_step(ref):
    """The MLP of ``tests/test_torch_f16_step.py`` in float16 under LAMB from
    the default scale 2^16: the first step overflows and changes no weight
    or state (bitwise); then losses (1e-5), weights (1e-6 absolute) and the
    scale follow the reference's."""
    mx, RefDPT, ref_mesh = ref
    rs = np.random.RandomState(0)
    x = rs.standard_normal((16, 32)).astype(np.float32)
    y = rs.randint(0, 10, 16).astype(np.int32)
    pnet = _mlp(mt)
    pnet.initialize(ctx=mt.cpu())
    weights = seeded_params(pnet, seed=2)
    load_jax_params(pnet, weights)
    rnet = _mlp(mx)
    rnet.initialize(ctx=mx.cpu())
    for k, p in rnet._collect_params_with_prefix().items():
        p.set_data(mx.nd.array(weights[k], ctx=mx.cpu()))
    params = {"learning_rate": 1e-4, "wd": 0.01}
    pt = DataParallelTrainer(pnet, mt.gluon.loss.SoftmaxCrossEntropyLoss(), "lamb", params,
                             mesh=make_mesh({"dp": 1}, devices=[mt.cpu()]), dtype="float16")
    rt = RefDPT(rnet, mx.gluon.loss.SoftmaxCrossEntropyLoss(), "lamb", params,
                mesh=ref_mesh({"dp": 1}), dtype="float16")
    skipped = 0
    for s in range(4):
        before = {k: p.data().asnumpy().copy() for k, p in
                  pnet._collect_params_with_prefix().items()}
        states = [tuple(t.clone() for t in st) for st in pt._opt_state]
        scale = pt._scaler.loss_scale
        got = float(pt.step(mt.nd.array(x, ctx=mt.cpu()), mt.nd.array(y, ctx=mt.cpu(),
                                                                       dtype="int32")))
        want = float(rt.step(mx.nd.array(x), mx.nd.array(y, dtype="int32")))
        rt.sync()
        np.testing.assert_allclose(got, want, rtol=1e-5)
        assert pt._scaler.loss_scale == rt._scaler.loss_scale
        after = _weights(pnet)
        for k, w in _weights(rnet).items():
            assert np.abs(after[k] - w).max() <= 1e-6, (s, k)
        if pt._scaler.loss_scale < scale:
            skipped += 1
            for k, w in before.items():
                np.testing.assert_array_equal(after[k], w)
            for a, b in zip(pt._opt_state, states):
                assert all(torch.equal(u, v) for u, v in zip(a, b))
    assert skipped >= 1 and pt._scaler.loss_scale < 2.0 ** 16


# -- the pipeline's LAMB/LARS lanes ------------------------------------------------

PP_CFG = dict(vocab_size=64, num_layers=4, units=32, hidden_size=64, num_heads=2,
              max_length=8, dropout=0.0)


@pytest.mark.parametrize("name,params", [
    ("lamb", {"learning_rate": 1e-2, "wd": 0.01}),
    ("lars", {"learning_rate": 0.5, "momentum": 0.9, "eta": 0.01, "wd": 1e-4})])
def test_pipeline_pp1_matches_reference(name, params):
    import test_torch_pipeline as tp
    weights = seeded_params(BertModel(**PP_CFG), seed=3)
    assert tp.CFG == PP_CFG
    net = tp._net(weights)
    tr = PipelineTrainer(net, tp.token_ce, name, params,
                         mesh=make_mesh({"pp": 1}, devices=[mt.cpu()]), num_microbatch=4)
    x, y = tp._batch()
    got = [float(tr.step(*tp._xy(x, y))) for _ in range(STEPS)]
    want, ref_w = tp._ref_run(weights, {"pp": 1}, None, 4, name, params, STEPS, None)
    np.testing.assert_allclose(got, want, rtol=TOL_LOSS)
    assert got[-1] < got[0]
    pw = tp._params(net)
    for key, w in ref_w.items():
        assert np.abs(pw[key] - w).max() <= TOL_W, key


# -- the overlapped step, snapshots --------------------------------------------------

@pytest.fixture
def world1(tmp_path):
    _dist_util.init_process_group(device="cpu", backend="gloo", rank=0, world_size=1,
                                  init_method=f"file://{tmp_path}/rdv")
    yield
    _dist_util.destroy_process_group()


def _bert(optimizer, params, seed=None, weights=None, **kw):
    if seed is not None:
        mt.random.seed(seed)
    net = BertModel(**CFG)
    net.initialize(ctx=mt.cpu())
    if weights is not None:
        load_jax_params(net, weights)
    return net, DataParallelTrainer(net, mt.gluon.loss.SoftmaxCrossEntropyLoss(), optimizer,
                                    params, mesh=kw.pop("mesh", None)
                                    or make_mesh({"dp": 1}, devices=[mt.cpu()]), **kw)


def test_overlap_lamb_equals_the_plain_step(world1):
    """At world 1 over gloo the overlapped step's buckets are unflattened and
    updated a parameter at a time: LAMB's losses and weights equal the
    plain step's."""
    weights = seeded_params(BertModel(**CFG), seed=0)
    x, y = _batch(1)
    out = []
    for overlap in (False, True):
        net, tr = _bert("lamb", {"learning_rate": 1e-3, "wd": 0.01}, weights=weights,
                        mesh=make_mesh({"dp": 1}, devices=[mt.cpu()]), overlap_grads=overlap,
                        overlap_segments=2)
        xs, ys = mt.nd.array(x, ctx=mt.cpu()), mt.nd.array(y, ctx=mt.cpu(), dtype="int32")
        out.append(([float(tr.step(xs, ys)) for _ in range(3)], _weights(net)))
    np.testing.assert_allclose(out[1][0], out[0][0], rtol=1e-6)
    for k, w in out[0][1].items():
        assert np.abs(out[1][1][k] - w).max() <= 1e-6, k


@pytest.mark.parametrize("name,arity", [("lamb", 2), ("adamw", 2), ("lars", 1)])
def test_snapshot_resumes_bitwise(tmp_path, name, arity):
    weights = seeded_params(BertModel(**CFG), seed=0)
    params = {"learning_rate": 1e-3, "wd": 0.01}
    x, y = _batch(2)
    xs, ys = mt.nd.array(x, ctx=mt.cpu()), mt.nd.array(y, ctx=mt.cpu(), dtype="int32")
    _, whole = _bert(name, params, weights=weights)
    want = [float(whole.step(xs, ys)) for _ in range(5)]
    _, tr = _bert(name, params, weights=weights)
    for _ in range(3):
        tr.step(xs, ys)
    mgr = elastic.SnapshotManager(str(tmp_path / "snap"))
    elastic.save_trainer(mgr, tr, wait=True)
    ck = CheckpointManager(str(tmp_path / "ck"))
    save_trainer(ck, tr, wait=True)
    _, r1, start, outcome = elastic.resume_or_init(
        str(tmp_path / "snap"), lambda: _bert(name, params, seed=7)[1])
    assert (start, outcome) == (3, "resumed")
    _, r2 = _bert(name, params, seed=9)
    restore_trainer(ck, r2)
    for resumed in (r1, r2):
        for a, b in zip(resumed._opt_state, tr._opt_state):
            assert len(a) == len(b) == arity and all(torch.equal(u, v) for u, v in zip(a, b))
        assert [float(resumed.step(xs, ys)) for _ in range(2)] == want[3:]


def test_recipes_refuse_lamb_and_lars():
    """Both recipes take ``zero_update``: MoETrainer refuses LAMB/LARS in its
    reference's words (``mxnet_tpu/recipes/moe.py:149-153``);
    LongContextTrainer with the fused step's ZeRO refusal, which the
    reference's recipe leaves out (ROADMAP §C, a difference kept)."""
    from mxnet_tpu_torch.recipes import long_context as lc, moe as rm
    net = rm.make_model(64, num_experts=2, ctx=mt.cpu())
    with pytest.raises(mt.MXNetError, match="LAMB per-tensor trust ratios do not decompose"):
        rm.MoETrainer(net, rm.token_cross_entropy, "lamb",
                      mesh=make_mesh({"dp": 1, "ep": 1}, devices=[mt.cpu()]))
    net = lc.make_model(64, seq_len=64, num_layers=1, units=32, hidden_size=64, num_heads=2,
                        ctx=mt.cpu())
    with pytest.raises(mt.MXNetError, match="zero_update does not support LARS"):
        lc.LongContextTrainer(net, lc.token_cross_entropy, "lars",
                              mesh=make_mesh({"dp": 1, "sp": 1}, devices=[mt.cpu()]))
