"""The float16 fused step with its overflow flag and loss scale on the device.

``DataParallelTrainer(dtype="float16")`` keeps the loss scale and the count
of finite steps in device memory (``LossScaler.bind``), sets its overflow
flag with a device op, gates K4/K5 by it (their ``skip``) and runs the
scaler's policy with tensor ops, so the step is captured on the card like
the others. Here, on the CPU, the same device ops run eagerly against the
reference's float16 step (``mxnet_tpu/parallel/data_parallel.py:830-876``,
its run_steps :1373-1480) on a one-device CPU mesh:

- an MLP (32 -> 64 relu -> 10) in float16 compute over float32 weights,
  Gluon's softmax cross entropy (float16 loss: its gradient times the
  default scale 2^16 overflows), ``scale_window`` 3 in both packages so that
  the scale halves, doubles after three finite steps and overflows again:
  6 ``step`` calls and 3 ``run_steps(2)`` calls, for SGD with momentum (K4's
  ``sgd_mom_update``) and Adam (K5), each against the reference: the
  losses, the weights, the loss scale and the count after every call;
- an overflowing step leaves every weight and optimizer state bitwise as it
  was; no ``.item()`` runs on the step path;
- the plain K4/K5 hyper forms with ``skip`` set leave weights and state
  bitwise unchanged, and with ``skip`` 0 give the ungated result;
- the device policy against the host's over a sequence of flags, with the
  gate of ``run_steps`` off and on;
- an elastic snapshot taken mid-run restores the scale and the count onto
  the device, and the resumed run continues the uninterrupted one bitwise;
- the 2-bit compressed body keeps every residual on an overflow, and the
  ZeRO body (a world-1 gloo group: its buckets exist on a mesh of ranks)
  keeps its weight and state shards.

Tolerances, measured first: the losses agree bitwise here (the float16 loss
rounds alike); 1e-5 relative is the bar. Weights differ where a float16
gradient rounds to the other neighbour in the other package (about 1e-4
absolute in a gradient), so the learning rates are small enough (SGD 1e-4,
Adam 1e-5) that 6 updates stay within the bar of 1e-6 absolute. Adam's
epsilon is 1e-2: a gradient element that rounds to 0 in one package and to
1e-4 in the other moved Adam's update at epsilon 1e-8 by nearly lr (1.1e-5
measured in ``run_steps``), which says nothing of the step.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import _dist_util
from mxnet_tpu_torch.contrib.amp import LossScaler
from mxnet_tpu_torch.convert import load_jax_params, seeded_params
from mxnet_tpu_torch.ops.cuda import fused_optimizer as fo
from mxnet_tpu_torch.parallel import DataParallelTrainer, make_mesh
from torch_threads import one_torch_thread  # noqa: F401

IN, HID, OUT, B = 32, 64, 10, 16
WINDOW = 3
STEPS = 6
TOL_LOSS = 1e-5
TOL_W = 1e-6
OPTS = {"sgd": {"learning_rate": 1e-4, "momentum": 0.9},
        "adam": {"learning_rate": 1e-5, "epsilon": 1e-2}}


def _net(pkg):
    net = pkg.gluon.nn.HybridSequential()
    net.add(pkg.gluon.nn.Dense(HID, activation="relu", in_units=IN))
    net.add(pkg.gluon.nn.Dense(OUT, in_units=HID))
    return net


def _data(seed=0):
    rs = np.random.RandomState(seed)
    return (rs.standard_normal((B, IN)).astype(np.float32),
            rs.randint(0, OUT, B).astype(np.int32))


def _weights():
    net = _net(mt)
    net.initialize(ctx=mt.cpu())
    return seeded_params(net, seed=2)


def _port(opt, weights, **kw):
    net = _net(mt)
    net.initialize(ctx=mt.cpu())
    load_jax_params(net, weights)
    tr = DataParallelTrainer(net, mt.gluon.loss.SoftmaxCrossEntropyLoss(), opt, OPTS[opt],
                             mesh=kw.pop("mesh", None) or make_mesh({"dp": 1},
                                                                    devices=[mt.cpu()]),
                             dtype="float16", **kw)
    tr._scaler._scale_window = WINDOW
    return net, tr


def _xy(x, y):
    return mt.nd.array(x, ctx=mt.cpu()), mt.nd.array(y, ctx=mt.cpu(), dtype="int32")


def _host(net):
    return {k: p.data().asnumpy().copy() for k, p in net._collect_params_with_prefix().items()}


def _states(tr):
    return [tuple(s.clone() for s in st) for st in tr._opt_state]


@pytest.fixture(scope="module")
def ref():
    import mxnet_tpu as mx
    from mxnet_tpu.parallel import DataParallelTrainer as RefDPT, make_mesh as ref_mesh

    def make(opt, weights):
        net = _net(mx)
        net.initialize(ctx=mx.cpu())
        for k, p in net._collect_params_with_prefix().items():
            p.set_data(mx.nd.array(weights[k], ctx=mx.cpu()))
        tr = RefDPT(net, mx.gluon.loss.SoftmaxCrossEntropyLoss(), opt, OPTS[opt],
                    mesh=ref_mesh({"dp": 1}), dtype="float16")
        tr._scaler._scale_window = WINDOW
        return net, tr
    return mx, make


def _ref_host(net):
    return {k: p.data().asnumpy() for k, p in net._collect_params_with_prefix().items()}


@pytest.mark.parametrize("opt", list(OPTS))
def test_step_matches_reference(ref, opt):
    """6 ``step`` calls: every call's loss, weights, scale and count against
    the reference's; the overflowing steps change nothing."""
    mx, make = ref
    w = _weights()
    x, y = _data()
    net, tr = _port(opt, w)
    rnet, rt = make(opt, w)
    scales, skipped = [], 0
    for s in range(STEPS):
        before, st = _host(net), _states(tr)
        got = float(tr.step(*_xy(x, y)))
        want = float(rt.step(mx.nd.array(x), mx.nd.array(y, dtype="int32")))
        rt.sync()
        np.testing.assert_allclose(got, want, rtol=TOL_LOSS)
        assert (tr._scaler.loss_scale, tr._scaler._unskipped) == \
            (rt._scaler.loss_scale, rt._scaler._unskipped), s
        pw, rw = _host(net), _ref_host(rnet)
        for k, v in rw.items():
            assert np.abs(pw[k] - v).max() <= TOL_W, (s, k)
        if scales and tr._scaler.loss_scale < scales[-1] or not scales \
                and tr._scaler.loss_scale < 2.0 ** 16:          # this step overflowed
            skipped += 1
            for k, v in before.items():
                np.testing.assert_array_equal(pw[k], v, err_msg=f"{s} {k}")
            for a, b in zip(_states(tr), st):
                for u, v in zip(a, b):
                    assert torch.equal(u, v), s
        scales.append(tr._scaler.loss_scale)
    assert skipped == 2 and scales[0] == 2.0 ** 15 and max(scales) == 2.0 ** 16, scales


@pytest.mark.parametrize("opt", list(OPTS))
def test_run_steps_matches_reference(ref, opt):
    """3 ``run_steps(2)`` calls: the scale is fixed within a call and the
    policy runs once at its end on all its flags, as in the reference."""
    mx, make = ref
    w = _weights()
    x, y = _data()
    net, tr = _port(opt, w)
    rnet, rt = make(opt, w)
    seen = []
    for c in range(3):
        got = tr.run_steps(*_xy(x, y), 2).asnumpy()
        want = np.asarray(rt.run_steps(mx.nd.array(x), mx.nd.array(y, dtype="int32"), 2))
        rt.sync()
        np.testing.assert_allclose(got, want, rtol=TOL_LOSS)
        assert (tr._scaler.loss_scale, tr._scaler._unskipped) == \
            (rt._scaler.loss_scale, rt._scaler._unskipped), c
        seen.append(tr._scaler.loss_scale)
        pw, rw = _host(net), _ref_host(rnet)
        for k, v in rw.items():
            assert np.abs(pw[k] - v).max() <= TOL_W, (c, k)
    assert seen[0] == 2.0 ** 15, seen           # both steps of the first call overflowed


def test_no_host_read_on_the_step_path(monkeypatch):
    """``step`` reads neither the flag nor the scale on the host: with
    ``Tensor.item`` and ``Tensor.__bool__`` raising, overflowing and finite
    steps run."""
    w = _weights()
    net, tr = _port("adam", w)
    x, y = _xy(*_data())

    def refuse(*a, **k):
        raise AssertionError("a host read on the step path")
    losses = []
    with monkeypatch.context() as m:
        m.setattr(torch.Tensor, "item", refuse)
        m.setattr(torch.Tensor, "__bool__", refuse)
        for _ in range(3):
            losses.append(tr.step(x, y))
    assert [float(v) for v in losses] and tr._scaler.loss_scale == 2.0 ** 15
    assert tr._eager_reason() == "cpu"


def test_eager_reason_is_never_float16(monkeypatch):
    """On a card the float16 step is captured: no eager reason names it."""
    net, tr = _port("sgd", _weights())

    class Gpu:
        device_type = "gpu"
    monkeypatch.setattr(tr, "device", Gpu())
    assert tr._eager_reason() is None


RULES = {
    "sgd_update": (fo.fused_sgd_update_hyper, 0, dict(lr=0.1, wd=1e-3)),
    "sgd_mom_update": (fo.fused_sgd_mom_update_hyper, 1, dict(lr=0.1, momentum=0.9, wd=1e-3)),
    "adam_update": (fo.fused_adam_update_hyper, 2, dict(lr=1e-3, beta1=0.9, beta2=0.999,
                                                        epsilon=1e-8, wd=1e-3)),
}


@pytest.mark.parametrize("rule", list(RULES))
def test_plain_forms_skip_on_the_flag(rule):
    """The plain K4/K5 hyper forms: ``skip`` set writes nothing (bitwise),
    ``skip`` 0 gives the ungated update."""
    fn, n_state, kw = RULES[rule]
    rs = np.random.RandomState(3)
    shapes = [(7, 5), (33,), (2, 3, 4)]

    def tensors():
        return [torch.from_numpy(rs.standard_normal(s).astype(np.float32)) for s in shapes]
    w, g = tensors(), tensors()
    states = [[t.abs() for t in tensors()] for _ in range(n_state)]
    hyper = torch.tensor(fo.hyper_values(**kw))
    for flag in (1.0, 0.0, float("nan")):
        ws = [t.clone() for t in w]
        ss = [[t.clone() for t in st] for st in states]
        fn(ws, g, *ss, hyper, out=(ws, *ss), skip=torch.tensor([flag]))
        ungated = [t.clone() for t in w], [[t.clone() for t in st] for st in states]
        fn(ungated[0], g, *ungated[1], hyper, out=(ungated[0], *ungated[1]))
        if flag == 0.0:
            for a, b in zip(ws + sum(ss, []), ungated[0] + sum(ungated[1], [])):
                assert torch.equal(a, b), rule
        else:
            for a, b in zip(ws + sum(ss, []), w + sum(states, [])):
                assert torch.equal(a, b), (rule, flag)


def test_device_policy_matches_host_policy():
    """``update_on_device`` against ``update_scale`` over a sequence of
    flags; a gate of 0 leaves scale and count as they were."""
    host, dev = LossScaler(scale_window=3), LossScaler(scale_window=3)
    dev.bind("cpu")
    flags = [1, 0, 0, 0, 0, 1, 1, 0, 0, 0, 0, 0, 0, 1] + [1] * 20 + [0]
    seen = []
    for f in flags:
        host.update_scale(bool(f))
        dev.update_on_device(torch.tensor([float(f)]), torch.tensor([1.0]))
        assert (dev.loss_scale, dev._unskipped) == (host.loss_scale, host._unskipped)
        dev.update_on_device(torch.tensor([1.0]), torch.tensor([0.0]))
        assert (dev.loss_scale, dev._unskipped) == (host.loss_scale, host._unskipped)
        seen.append(host.loss_scale)
    assert min(seen) == 1.0 and max(seen) == 2.0 ** 16      # the floor and the doublings
    fresh = LossScaler()
    fresh.bind("cpu")
    fresh.load_state_dict(dev.state_dict())
    assert fresh.state_dict() == dev.state_dict() == host.state_dict()
    assert fresh._dev[0].dtype == torch.float64 and fresh._dev[1].dtype == torch.int64


def test_snapshot_mid_run_restores_scale_and_count(tmp_path):
    """A snapshot after 3 steps (the scale halved once, the count at 2)
    resumes onto the device, and the next 3 steps equal the uninterrupted
    run's bitwise: losses, weights, scale and count."""
    from mxnet_tpu_torch import elastic
    w = _weights()
    x, y = _xy(*_data())
    net, tr = _port("adam", w)
    base = [float(tr.step(x, y)) for _ in range(STEPS)]
    base_w, base_sc = _host(net), tr._scaler.state_dict()
    net, tr = _port("adam", w)
    for _ in range(3):
        tr.step(x, y)
    mid = tr._scaler.state_dict()
    elastic.save_trainer(elastic.SnapshotManager(str(tmp_path)), tr, wait=True)
    holder = {}

    def make():
        holder["net"], t2 = _port("adam", _weights())
        return t2
    _, tr2, start, outcome = elastic.resume_or_init(str(tmp_path), make)
    assert (start, outcome) == (3, "resumed")
    assert tr2._scaler.state_dict() == mid and tr2._scaler._dev is not None
    assert float(tr2._scaler._dev[0]) == mid["loss_scale"]
    got = [float(tr2.step(x, y)) for _ in range(3)]
    assert got == base[3:]
    assert tr2._scaler.state_dict() == base_sc
    for k, v in _host(holder["net"]).items():
        np.testing.assert_array_equal(v, base_w[k], err_msg=k)


def test_compressed_body_keeps_residuals_on_overflow():
    """2-bit compression under float16: the overflowing first step leaves
    every residual (zeros) and weight bitwise; a finite step moves them."""
    net, tr = _port("sgd", _weights(), compression={"type": "2bit", "threshold": 2.0 ** -10})
    x, y = _xy(*_data())
    before = _host(net)
    tr.step(x, y)
    assert tr._scaler.loss_scale == 2.0 ** 15
    assert all(torch.count_nonzero(r) == 0 for r in tr._comp_resid if r is not None)
    for k, v in _host(net).items():
        np.testing.assert_array_equal(v, before[k], err_msg=k)
    tr.step(x, y)
    assert tr._scaler.loss_scale == 2.0 ** 15 and tr._scaler._unskipped == 1
    assert any(torch.count_nonzero(r) > 0 for r in tr._comp_resid if r is not None)
    assert any(not np.array_equal(v, before[k]) for k, v in _host(net).items())


@pytest.fixture
def world1(tmp_path):
    _dist_util.init_process_group(device="cpu", backend="gloo", rank=0, world_size=1,
                                  init_method=f"file://{tmp_path / 'rdzv'}")
    yield
    _dist_util.destroy_process_group()


def test_zero_body_keeps_shards_on_overflow(world1):
    """ZeRO under float16 on a mesh of ranks: the overflowing step leaves
    the weight and state shards of every bucket bitwise; then a finite step
    moves them, and the trajectory equals the replicated step's."""
    x, y = _xy(*_data())
    mesh = make_mesh({"dp": 1}, devices=[mt.cpu()])
    net, tr = _port("adam", _weights(), mesh=mesh, zero_update=True)
    assert tr._zero_buckets
    shards = [(zb["wshard"].clone(), tuple(s.clone() for s in zb["state"]))
              for zb in tr._zero_buckets]
    before = _host(net)
    losses = [float(tr.step(x, y))]
    for zb, (ws, st) in zip(tr._zero_buckets, shards):
        assert torch.equal(zb["wshard"], ws)
        for a, b in zip(zb["state"], st):
            assert torch.equal(a, b)
    for k, v in _host(net).items():
        np.testing.assert_array_equal(v, before[k], err_msg=k)
    losses += [float(tr.step(x, y)) for _ in range(2)]
    assert any(not torch.equal(a, b) for zb, (_, st) in zip(tr._zero_buckets, shards)
               for a, b in zip(zb["state"], st))
    plain_net, plain = _port("adam", _weights(), mesh=mesh, zero_update=False)
    assert [float(plain.step(x, y)) for _ in range(3)] == losses
    for k, v in _host(plain_net).items():
        np.testing.assert_array_equal(v, _host(net)[k], err_msg=k)


# -- on the card ----------------------------------------------------------------------

def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run on the card")
    return mt.gpu(0)


@pytest.mark.gpu
@pytest.mark.parametrize("rule", list(RULES))
def test_gpu_kernel_gate(rule):
    """K4/K5's gate on the card: the flag 1 writes nothing (bitwise), the
    flag 0 is bitwise the ungated launch; one launch counted each call."""
    ctx = _cuda()
    fn, n_state, kw = RULES[rule]
    gen = torch.Generator(device="cuda").manual_seed(5)
    shapes = [(1000, 77), (16385,), (3, 5)]

    def tensors():
        return [torch.randn(s, generator=gen, device="cuda") for s in shapes]
    w, g = tensors(), tensors()
    states = [[t.abs() for t in tensors()] for _ in range(n_state)]
    hyper = torch.tensor(fo.hyper_values(**kw), device="cuda")
    counter = {"sgd_update": fo.fused_sgd_update, "sgd_mom_update": fo.fused_sgd_mom_update,
               "adam_update": fo.fused_adam_update}[rule]
    got = {}
    for flag in (None, 0.0, 1.0):
        ws = [t.clone() for t in w]
        ss = [[t.clone() for t in st] for st in states]
        before = counter.launches
        skip = None if flag is None else torch.full((1,), flag, device="cuda")
        fn(ws, g, *ss, hyper, out=(ws, *ss), skip=skip)
        torch.cuda.synchronize()
        assert counter.launches == before + 1
        got[flag] = ws + sum(ss, [])
    assert all(torch.equal(a, b) for a, b in zip(got[0.0], got[None]))
    assert all(torch.equal(a, b) for a, b in zip(got[1.0], w + sum(states, [])))
    assert ctx is not None


@pytest.mark.gpu
@pytest.mark.parametrize("opt", list(OPTS))
def test_gpu_captured_f16_equals_eager(opt):
    """The float16 step captured on the card (no eager reason) against the
    same trainer eager: 6 steps from the default scale with scale_window 3
    (two overflows), losses, weights, optimizer state, scale and count
    bitwise after every step; one capture, K4/K5 once a step."""
    from mxnet_tpu_torch import engine
    ctx = _cuda()
    w = _weights()
    x, y = _data()
    xg, yg = mt.nd.array(x, ctx=ctx), mt.nd.array(y, ctx=ctx, dtype="int32")
    counter = fo.fused_adam_update if opt == "adam" else fo.fused_sgd_mom_update
    runs = {}
    for captured in (True, False):
        net = _net(mt)
        net.initialize(ctx=ctx)
        load_jax_params(net, w)
        tr = DataParallelTrainer(net, mt.gluon.loss.SoftmaxCrossEntropyLoss(), opt, OPTS[opt],
                                 mesh=make_mesh({"dp": 1}, devices=[ctx]), dtype="float16")
        tr._scaler._scale_window = WINDOW
        assert tr.captured and tr._eager_reason() is None
        if not captured:
            tr._graph_reason = "eager yardstick"
        engine.reset_stats()
        counter.launches = 0
        trail = []
        for _ in range(STEPS):
            loss = float(tr.step(xg, yg))
            trail.append((loss, tr._scaler.loss_scale, tr._scaler._unskipped,
                          [p.data().asnumpy() for p in net.collect_params().values()],
                          [s.cpu().numpy() for st in tr._opt_state for s in st]))
        runs[captured] = (trail, engine.cache_stats()["captures"], counter.launches)
    cap, eag = runs[True], runs[False]
    assert (cap[1], eag[1]) == (1, 0) and cap[2] == eag[2] == STEPS
    for a, b in zip(cap[0], eag[0]):
        assert a[:3] == b[:3]
        for u, v in zip(a[3] + a[4], b[3] + b[4]):
            np.testing.assert_array_equal(u, v)
    assert sum(a[1] < b[1] for a, b in zip(cap[0][1:], cap[0])) + (cap[0][0][1] < 2.0 ** 16) == 2
