"""The port's fused training step against the reference's, on the CPU.

``mxnet_tpu_torch.parallel.DataParallelTrainer`` against
``mxnet_tpu.parallel.DataParallelTrainer`` on a one-device CPU mesh, the
same seeded weights (``convert.seeded_params``, into the port by
``load_jax_params``, into the reference by ``set_data``) and the same
batches from numpy:

- the narrow BERT of ``tests/test_torch_train.py`` (2 layers, units 128)
  with Adam for 10 steps in float32: the loss trajectory, every weight and
  the Adam m and v after the last step; then in bfloat16;
- SGD with momentum and wd under a ``FactorScheduler`` that halves lr every
  3 updates: the case where the Pallas kernel's momentum rule and
  ``sgd_mom_update``'s part (the reference step applies the latter); and
  plain SGD, which keeps no state;
- a narrow ``ResNetV1`` (bench.py's SGD recipe) with the BatchNorm running
  statistics, in float32 and bfloat16;
- float16 with the dynamic ``LossScaler``: BERT's loss times the initial
  scale 2^16 overflows float16, so the first steps are skipped and the
  scale halves until it fits, in both packages alike;
- the refusals (a mesh of ranks without a process group, ``zero_update``
  beyond pure data parallelism, a comm dtype not ported, a compression type
  other than 2-bit, ``overlap_grads`` on a net with no block chain and
  ``overlap_segments`` leaving one segment that owns parameters, a
  ``data_spec`` axis the mesh lacks, an optimizer not ported, deferred
  shapes); on a mesh of one device, Megatron specs, ``P("dp", "sp")`` and
  ``bucket_bytes`` leave the step as it is, and the step's operands keeping their storage, so the
  fused update's pointer table is built once.

Tolerances, measured here first: float32 (only the order of summation
differs) loss 1e-5 relative (measured 1.6e-7), weights 2e-5 absolute after
10 Adam steps at lr 1e-3 (1.4e-6), Adam m 1e-4 and v 1e-3 of each tensor's
max; SGD weights 1e-5 of each tensor's max. bfloat16 (the frameworks round
at other places: the reference's CPU compiler computes bf16 convolutions in
f32 and keeps some intermediates unrounded): BERT loss 3e-2 relative
(measured 0 over 10 steps) and weights 2e-2 absolute (7.1e-3); ResNet one
step, loss 3e-2 relative and the running statistics 3e-2 of their max
(1.2e-2), against a step of 0.1 x (batch stat - running stat).
"""
import numpy as np
import pytest
import torch

import mxnet_tpu_torch as mt
from mxnet_tpu_torch.convert import load_jax_params, seeded_params
from mxnet_tpu_torch.gluon.model_zoo import vision
from mxnet_tpu_torch.models import BertModel
from mxnet_tpu_torch.ops.cuda import fused_optimizer as fo
from mxnet_tpu_torch.parallel import DataParallelTrainer, P, make_mesh
from torch_threads import one_torch_thread  # noqa: F401

CFG = dict(vocab_size=1024, num_layers=2, units=128, hidden_size=512,
           num_heads=2, max_length=256)
B, T = 2, 64
TOL_LOSS = 1e-5
TOL_W = 2e-5
TOL_BF16_LOSS = 3e-2
TOL_BF16_W = 2e-2
CHANNELS = [16, 32, 64, 128, 256]


@pytest.fixture(scope="module")
def ref():
    import mxnet_tpu as mx
    from mxnet_tpu.parallel import DataParallelTrainer as RefDPT, make_mesh as ref_mesh
    return mx, RefDPT, ref_mesh


def _cpu_mesh(axes=None):
    return make_mesh(axes or {"dp": 1}, devices=[mt.cpu()])


def _batch(seed):
    rs = np.random.RandomState(seed)
    return (rs.randint(0, CFG["vocab_size"], size=(B, T)).astype(np.int32),
            rs.randint(0, CFG["vocab_size"], size=(B, T)).astype(np.int32))


def _bert_pair(ref, seed):
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


def _run(ref, port, refnet, x, y, steps, optimizer, params, dtype=None,
         ref_params=None):
    """``steps`` steps of each package's trainer -> (port losses, ref
    losses, port trainer, ref trainer)."""
    mx, RefDPT, ref_mesh = ref
    pt = DataParallelTrainer(port, mt.gluon.loss.SoftmaxCrossEntropyLoss(), optimizer,
                             params, mesh=_cpu_mesh(), dtype=dtype)
    rt = RefDPT(refnet, mx.gluon.loss.SoftmaxCrossEntropyLoss(), optimizer,
                ref_params if ref_params is not None else params,
                mesh=ref_mesh({"dp": 1}), dtype=dtype)
    xp, yp = mt.nd.array(x, ctx=mt.cpu()), mt.nd.array(y, ctx=mt.cpu(), dtype="int32")
    xr, yr = mx.nd.array(x), mx.nd.array(y, dtype="int32")
    p_loss = np.array([float(pt.step(xp, yp)) for _ in range(steps)])
    r_loss = np.array([float(rt.step(xr, yr)) for _ in range(steps)])
    pt.sync()
    rt.sync()
    return p_loss, r_loss, pt, rt


def _weights(net):
    return {k: p.data().asnumpy() for k, p in net._collect_params_with_prefix().items()}


def _rel(a, b):
    return float(np.abs(a - b).max()) / max(float(np.abs(b).max()), 1e-30)


def test_adam_f32_matches_reference(ref):
    port, refnet = _bert_pair(ref, seed=0)
    x, y = _batch(1)
    p_loss, r_loss, pt, rt = _run(ref, port, refnet, x, y, 10, "adam",
                                  {"learning_rate": 1e-3})
    np.testing.assert_allclose(p_loss, r_loss, rtol=TOL_LOSS)
    assert p_loss[-1] < p_loss[0]
    pw, rw = _weights(port), _weights(refnet)
    assert set(pw) == set(rw)
    for key, w in rw.items():
        assert np.abs(pw[key] - w).max() <= TOL_W, key
    assert pt.num_update == rt.num_update == 10
    for (m, v), (rm, rv), p in zip(pt._opt_state, rt._opt_state, pt._plist):
        assert _rel(m.numpy(), np.asarray(rm)) <= 1e-4, p.name
        assert _rel(v.numpy(), np.asarray(rv)) <= 1e-3, p.name


def test_bf16_matches_reference(ref):
    port, refnet = _bert_pair(ref, seed=0)
    x, y = _batch(1)
    seen = []
    hook = port.encoder.layers[0].register_forward_hook(
        lambda blk, args, out: seen.append(out._data.dtype))
    p_loss, r_loss, pt, _ = _run(ref, port, refnet, x, y, 10, "adam",
                                 {"learning_rate": 1e-3}, dtype="bfloat16")
    hook.detach()
    assert seen and set(seen) == {torch.bfloat16}   # the layers ran in bf16
    np.testing.assert_allclose(p_loss, r_loss, rtol=TOL_BF16_LOSS)
    assert p_loss[-1] < p_loss[0]
    pw, rw = _weights(port), _weights(refnet)
    for key, w in rw.items():
        assert pw[key].dtype == np.float32                  # f32 masters
        assert np.abs(pw[key] - w).max() <= TOL_BF16_W, key
    grads = [p.grad()._data for p in port.encoder.collect_params().values()
             if p.grad_req != "null"]
    assert all(g.dtype == torch.float32 for g in grads)    # through the cast
    assert all(float(g.abs().max()) > 0 for g in grads)


@pytest.mark.parametrize("momentum", [0.9, 0.0], ids=["momentum", "plain"])
def test_sgd_under_factor_scheduler_matches_reference(ref, momentum):
    mx = ref[0]
    port, refnet = _bert_pair(ref, seed=2)
    x, y = _batch(3)
    hyper = {"learning_rate": 0.5, "momentum": momentum, "wd": 1e-3}
    p_loss, r_loss, pt, rt = _run(
        ref, port, refnet, x, y, 8, "sgd",
        dict(hyper, lr_scheduler=mt.lr_scheduler.FactorScheduler(3, 0.5)),
        ref_params=dict(hyper, lr_scheduler=mx.lr_scheduler.FactorScheduler(3, 0.5)))
    assert pt.optimizer.learning_rate == rt.optimizer.learning_rate == 0.125  # halved twice
    np.testing.assert_allclose(p_loss, r_loss, rtol=TOL_LOSS)
    pw, rw = _weights(port), _weights(refnet)
    for key, w in rw.items():
        assert _rel(pw[key], w) <= 1e-5, key
    states = [s for s in pt._opt_state if s]
    assert len(states) == (len(pt._groups[1e-3]) if momentum else 0)


def _resnet_pair(ref, seed):
    mx = ref[0]
    from mxnet_tpu.gluon.model_zoo.vision import resnet as ref_resnet
    port = vision.ResNetV1(vision.BottleneckV1, [1, 1, 1, 1], CHANNELS, classes=10)
    port.initialize(ctx=mt.cpu())
    port(mt.nd.zeros((1, 3, 64, 64), ctx=mt.cpu()))
    weights = seeded_params(port, seed)
    refnet = ref_resnet.ResNetV1(ref_resnet.BottleneckV1, [1, 1, 1, 1], CHANNELS,
                                 classes=10)
    for key, p in refnet._collect_params_with_prefix().items():
        p.set_data(mx.nd.array(weights[key], ctx=mx.cpu()))
    refnet.hybridize()
    load_jax_params(port, {k: p.data().asnumpy()
                           for k, p in refnet._collect_params_with_prefix().items()})
    return port, refnet, weights


@pytest.mark.parametrize("dtype", [None, "bfloat16"])
def test_resnet_batchnorm_matches_reference(ref, dtype):
    port, refnet, w0 = _resnet_pair(ref, seed=21)
    rs = np.random.RandomState(22)
    x = rs.uniform(-1, 1, (2, 3, 64, 64)).astype(np.float32)
    y = rs.randint(0, 10, size=(2,)).astype(np.int32)
    steps = 3 if dtype is None else 1
    p_loss, r_loss, _, _ = _run(ref, port, refnet, x, y, steps, "sgd",
                                {"learning_rate": 0.05, "momentum": 0.9, "wd": 1e-4},
                                dtype=dtype)
    np.testing.assert_allclose(p_loss, r_loss, rtol=TOL_LOSS if dtype is None
                               else TOL_BF16_LOSS)
    pw, rw = _weights(port), _weights(refnet)
    running = [k for k in rw if "running" in k]
    assert len(running) == 2 * 17
    for key in running:
        assert pw[key].dtype == np.float32
        assert np.abs(pw[key] - w0[key]).max() > 0, key          # they moved
        assert _rel(pw[key], rw[key]) <= (1e-5 if dtype is None else 3e-2), key
    if dtype is None:
        for key, w in rw.items():
            assert _rel(pw[key], w) <= 1e-5, key


def test_f16_loss_scaler_skips_overflowing_steps(ref):
    port, refnet = _bert_pair(ref, seed=0)
    x, y = _batch(1)
    w0 = _weights(port)
    mx, RefDPT, ref_mesh = ref
    pt = DataParallelTrainer(port, mt.gluon.loss.SoftmaxCrossEntropyLoss(), "adam",
                             {"learning_rate": 1e-3}, mesh=_cpu_mesh(), dtype="float16")
    rt = RefDPT(refnet, mx.gluon.loss.SoftmaxCrossEntropyLoss(), "adam",
                {"learning_rate": 1e-3}, mesh=ref_mesh({"dp": 1}), dtype="float16")
    xp, yp = mt.nd.array(x, ctx=mt.cpu()), mt.nd.array(y, ctx=mt.cpu(), dtype="int32")
    p_scales, r_scales, p_loss, r_loss = [], [], [], []
    for step in range(5):
        p_loss.append(float(pt.step(xp, yp)))
        r_loss.append(float(rt.step(mx.nd.array(x), mx.nd.array(y, dtype="int32"))))
        p_scales.append(pt._scaler.loss_scale)
        r_scales.append(rt._scaler.loss_scale)
        if step == 0:      # the overflowing first step changed nothing
            for key, w in _weights(port).items():
                np.testing.assert_array_equal(w, w0[key], err_msg=key)
    assert p_scales == r_scales
    assert p_scales[0] == 2.0 ** 15                  # halved on the overflow
    assert p_scales[-1] == p_scales[-2]              # fits: no more halving
    np.testing.assert_allclose(p_loss, r_loss, rtol=TOL_BF16_LOSS)
    pw, rw = _weights(port), _weights(refnet)
    for key, w in rw.items():
        assert np.abs(pw[key] - w).max() <= TOL_BF16_W, key


def test_loss_scaler_matches_reference(ref):
    """``LossScaler``'s policy (halve on overflow, double after
    ``scale_window`` clean steps), ``has_overflow`` and ``state_dict``."""
    from mxnet_tpu.contrib.amp.loss_scaler import LossScaler as RefScaler
    port, refs = mt.contrib.amp.LossScaler(scale_window=3), RefScaler(scale_window=3)
    finite = [True, False, True, True, True, True, False, False, True]
    for f in finite:
        assert port.update_from_step(torch.tensor(f)) == refs.update_from_step(f) == f
        assert port.loss_scale == refs.loss_scale
    assert port.state_dict() == refs.state_dict()
    grads = [np.ones(3, np.float32), np.array([1.0, np.inf], np.float32)]
    assert port.has_overflow([torch.from_numpy(g) for g in grads]) \
        == refs.has_overflow([ref[0].nd.array(g) for g in grads]) is True
    assert port.has_overflow([mt.nd.array(grads[0], ctx=mt.cpu())]) is False
    fresh = mt.contrib.amp.LossScaler()
    fresh.load_state_dict(port.state_dict())
    assert fresh.state_dict() == port.state_dict()


def _dense_net():
    net = mt.gluon.nn.Dense(3, in_units=4)
    net.initialize(ctx=mt.cpu())
    return net


@pytest.mark.parametrize("case,match", [
    ("mesh", "torch.distributed"), ("zero_update", "pure data parallelism"),
    # the ids of these three predate the port of overlap.py and compression
    pytest.param("compression", "unsupported gradient compression",
                 id="compression-ROADMAP A2"),
    pytest.param("overlap_grads", "no linear block chain", id="overlap_grads-ROADMAP A2"),
    ("comm_dtype", "unsupported comm dtype"),
    pytest.param("overlap_segments", "nothing to overlap", id="overlap_segments-ROADMAP A2"),
    ("data_spec", "no 'sp' axis"),
    # the id predates the port of the other optimizers: the reference's own
    # refusal of an optimizer with no fused rule is what remains
    pytest.param("optimizer", "no functional adapter for optimizer FTML; use gluon.Trainer",
                 id="optimizer-ROADMAP A5"),
    ("rmsprop_centered", "no functional adapter for optimizer RMSProp"),
    ("zero_lamb", "zero_update does not support LAMB: its per-tensor trust-ratio"),
    ("zero_lars", "zero_update does not support LARS"),
    ("deferred", "deferred"), ("dtype", "float32/bfloat16/float16"),
    ("device", "mesh's device")])
def test_refuses_what_is_not_ported(case, match):
    """What the step refuses: a mesh of ranks with no process group, a
    compression type other than 2-bit, ``overlap_grads`` on a net with no
    block chain and an ``overlap_segments`` plan with one owning segment (as
    the reference does), ``zero_update`` beyond pure data parallelism (the
    sequence split too) and a comm dtype ``parallel/zero.py`` lacks, a data
    axis the mesh lacks, an optimizer with no fused rule (FTML, centered
    RMSProp: the reference's words), LAMB and LARS under ``zero_update``
    (their per-tensor norms; the reference's words), deferred shapes, a
    dtype, a device."""
    loss = mt.gluon.loss.SoftmaxCrossEntropyLoss()
    kw = {"mesh": _cpu_mesh()}
    net = _dense_net()
    if case == "mesh":
        with pytest.raises(mt.MXNetError, match=match):
            make_mesh({"dp": 2}, devices=[mt.cpu(), mt.cpu()])
        return
    if case == "overlap_grads":
        kw[case] = True
    elif case == "zero_update":
        kw.update(zero_update=True, mesh=_cpu_mesh({"dp": 1, "sp": 1}),
                  data_spec=P("dp", "sp"))
    elif case == "compression":
        kw[case] = {"type": "1bit"}
    elif case == "overlap_segments":
        net = mt.gluon.nn.HybridSequential()      # a chain of one block
        net.add(_dense_net())
        kw.update(overlap_grads=True, overlap_segments=4)
    elif case == "comm_dtype":
        kw.update(zero_update=True, comm_dtype="int4")
    elif case == "data_spec":
        kw[case] = P("dp", "sp")
    elif case == "dtype":
        kw[case] = "int8"
    elif case == "deferred":
        net = mt.gluon.nn.Dense(3)
        net.initialize(ctx=mt.cpu())
    elif case == "device":
        kw["mesh"] = make_mesh({"dp": 1}, devices=[mt.gpu(0)])
    elif case.startswith("zero_"):
        kw["zero_update"] = True
    optimizer = {"optimizer": mt.optimizer.create("ftml"),
                 "rmsprop_centered": mt.optimizer.create("rmsprop", centered=True),
                 "zero_lamb": "lamb", "zero_lars": "lars"}.get(case, "sgd")
    with pytest.raises(mt.MXNetError, match=match):
        DataParallelTrainer(net, loss, optimizer, mesh=kw.pop("mesh"), **kw)


def test_one_device_mesh_takes_specs_and_bucket_bytes():
    """On a mesh of one device whose dp, tp and sp axes have size 1, the
    dryrun's options (Megatron specs, ``data_spec=P("dp", "sp")``,
    ``bucket_bytes``) give the one-device step, loss for loss."""
    from mxnet_tpu_torch.parallel import shard_params_megatron
    weights = seeded_params(BertModel(**CFG), seed=4)
    x, y = _batch(2)
    losses = []
    for dryrun in (False, True):
        net = BertModel(**CFG, head_major_qkv=True)
        net.initialize(ctx=mt.cpu())
        load_jax_params(net, weights)
        kw = {"mesh": _cpu_mesh()}
        if dryrun:
            assert shard_params_megatron(net) > 0
            kw = {"mesh": make_mesh({"dp": 1, "tp": 1, "sp": 1}, devices=[mt.cpu()]),
                  "data_spec": P("dp", "sp"), "bucket_bytes": 4096}
        tr = DataParallelTrainer(net, mt.gluon.loss.SoftmaxCrossEntropyLoss(), "adam",
                                 {"learning_rate": 1e-3}, **kw)
        xp = mt.nd.array(x, ctx=mt.cpu())
        yp = mt.nd.array(y, ctx=mt.cpu(), dtype="int32")
        losses.append([float(tr.step(xp, yp)) for _ in range(2)])
        assert all(p._mesh is None for p in tr._plist)
    assert losses[0] == losses[1]


def test_step_operands_keep_their_storage():
    """Every step updates the same tensors in place, so the fused update's
    pointer table (keyed on data pointers) is built once and then found; a
    new tensor misses it."""
    net = _dense_net()
    tr = DataParallelTrainer(net, mt.gluon.loss.SoftmaxCrossEntropyLoss(), "adam",
                             {"learning_rate": 0.1}, mesh=_cpu_mesh())
    x = mt.nd.array(np.random.RandomState(0).rand(5, 4).astype(np.float32), ctx=mt.cpu())
    y = mt.nd.array(np.arange(5) % 3, ctx=mt.cpu(), dtype="int32")

    def operands():
        ps = [p for p in tr._plist if p.grad_req != "null"]
        return [[p._param for p in ps], [p._grad for p in ps],
                [s[0] for s in tr._opt_state], [s[1] for s in tr._opt_state]]

    def table(ops):
        w, g, m, v = ops
        return fo._table("fused_adam_update", torch.device("cpu"),
                         [w, g, m, v, w, m, v], ["w", "g", "m", "v", "ow", "om", "ov"])
    first = [[t.data_ptr() for t in lst] for lst in operands()]
    built = fo.table_stats["built"]
    losses = []
    for _ in range(3):
        losses.append(float(tr.step(x, y)))
        assert [[t.data_ptr() for t in lst] for lst in operands()] == first
        table(operands())
    assert fo.table_stats["built"] == built + 1
    assert losses[-1] < losses[0]
    ops = operands()
    ops[0][0] = ops[0][0].clone()                  # a parameter made anew
    table(ops)
    assert fo.table_stats["built"] == built + 2


def test_run_steps_and_pending_loss():
    """``run_steps`` is ``n`` steps; ``step`` returns a loss that syncs only
    when read."""
    x = mt.nd.array(np.random.RandomState(1).rand(6, 4).astype(np.float32), ctx=mt.cpu())
    y = mt.nd.array(np.arange(6) % 3, ctx=mt.cpu(), dtype="int32")
    losses = []
    for run in ("step", "run_steps"):
        net = _dense_net()
        net.weight.set_data(np.full((3, 4), 0.1, np.float32))
        tr = DataParallelTrainer(net, mt.gluon.loss.SoftmaxCrossEntropyLoss(), "sgd",
                                 {"learning_rate": 0.1, "momentum": 0.9},
                                 mesh=_cpu_mesh())
        if run == "step":
            pending = [tr.step(x, y) for _ in range(4)]
            assert "PendingScalar" in repr(pending[0])
            losses.append(np.array([float(p) for p in pending]))
        else:
            losses.append(tr.run_steps(x, y, 4).asnumpy())
        assert tr.num_update == 4
    np.testing.assert_array_equal(losses[0], losses[1])


@pytest.mark.gpu
@pytest.mark.parametrize("optimizer,params,rule", [
    ("adam", {"learning_rate": 0.01, "wd": 1e-3}, "fused_adam_update"),
    ("sgd", {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-3}, "fused_sgd_mom_update"),
    ("sgd", {"learning_rate": 0.1}, "fused_sgd_update")])
def test_gpu_step_is_one_cached_update_launch(optimizer, params, rule):
    """On the card: one launch of the rule's kernel a step, its pointer table
    built at the first step only, and the same weights as on the CPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run on the card")
    rs = np.random.RandomState(5)
    x = rs.rand(16, 12).astype(np.float32)
    y = (np.arange(16) % 5).astype(np.int32)
    w0 = {"0.weight": rs.randn(32, 12).astype(np.float32), "0.bias": np.zeros(32, np.float32),
          "1.weight": rs.randn(5, 32).astype(np.float32), "1.bias": np.zeros(5, np.float32)}
    finals = []
    for ctx in (mt.gpu(0), mt.cpu()):
        net = mt.gluon.nn.HybridSequential()
        net.add(mt.gluon.nn.Dense(32, in_units=12, activation="relu"),
                mt.gluon.nn.Dense(5, in_units=32))
        net.initialize(ctx=ctx)
        load_jax_params(net, w0)
        tr = DataParallelTrainer(net, mt.gluon.loss.SoftmaxCrossEntropyLoss(), optimizer,
                                 dict(params), mesh=make_mesh({"dp": 1}, devices=[ctx]))
        xs, ys = mt.nd.array(x, ctx=ctx), mt.nd.array(y, ctx=ctx, dtype="int32")
        counter = getattr(fo, rule)
        launches, built = counter.launches, fo.table_stats["built"]
        for _ in range(3):
            tr.step(xs, ys)
        tr.sync()
        if ctx.device_type == "gpu":
            assert counter.launches - launches == 3
            assert fo.table_stats["built"] - built == 1
        finals.append(_weights(net))
    for key, w in finals[1].items():
        assert _rel(finals[0][key], w) <= 1e-5, key
