"""ResNet through the Gluon model zoo in the port against the reference.

Op by op (``Convolution``, ``Pooling``, ``BatchNorm``: forward and the
gradient of every input for one random cotangent on every output, against
``mxnet_tpu.ops.registry.get_op``), layer by layer with deferred shape
inference, and whole narrow ResNets (channels [16, 32, 64, 128, 256], one
block a stage, batch 2), v1 and v2 with bottleneck and basic blocks: logits
in inference and in training mode and the running stats after a
training-mode forward, and three SGD-momentum steps (lr 0.05, momentum 0.9,
wd 1e-4, as ``bench.py``) of loss, weights and running stats, with the
reference's weights carried into the port by ``load_jax_params``. The
reference nets are hybridized (one XLA program each, the package's own
fast path), which keeps this file within about half a minute.

Images are 64x64, not 32x32: at 32x32 the last stage is 1x1, so its
BatchNorms in training mode take the variance of two values per channel,
which amplifies the rounding of their inputs (3e-5 relative in the
training-mode logits of the bottleneck v1 net, measured); at 64x64 it is
2x2 and everything agrees within the tolerance.

Tolerance: 1e-5 relative in f32 (each array against its own largest
|value|; inputs, weights and cotangents of order 1), where the two
frameworks compute the same formulas on the CPU and differ only in the
order of summation. Shapes, dtypes and the inferred parameter shapes are
equal.

Also ``convert.seeded_params``: BERT-base's dict for seed 0 is what the rule
before the convolution/BatchNorm rules gave, and no ``running_var`` is <= 0.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu_torch as mt
from mxnet_tpu_torch.convert import load_jax_params, seeded_params
from mxnet_tpu_torch.gluon import model_zoo
from mxnet_tpu_torch.gluon.model_zoo import vision
from mxnet_tpu_torch.gluon.parameter import DeferredInitializationError
from mxnet_tpu_torch.ops.registry import get_op
from torch_threads import one_torch_thread  # noqa: F401

TOL = 1e-5
IMAGE = 64

_rs = np.random.RandomState(0)


def _f(*shape):
    return _rs.standard_normal(shape).astype(np.float32)


def _close(got, expect, tol=TOL, what=""):
    got, expect = np.asarray(got), np.asarray(expect)
    assert got.shape == expect.shape, (what, got.shape, expect.shape)
    finite = np.isfinite(expect)
    np.testing.assert_array_equal(np.isfinite(got), finite, err_msg=what)
    np.testing.assert_array_equal(got[~finite], expect[~finite], err_msg=what)
    scale = max(float(np.abs(expect[finite]).max(initial=0.0)), 1e-30)
    err = float(np.abs(got[finite] - expect[finite]).max(initial=0.0))
    assert err <= tol * scale, f"{what}: max|d| {err:.3e} > {tol:.0e} x {scale:.3e}"


# ---------------------------------------------------------------------------
# seeded_params
# ---------------------------------------------------------------------------

def _old_rule(net, seed):
    """The rule every PR before this one used: N(0, 0.02), gamma 1 + N(0, 0.1),
    beta N(0, 0.1)."""
    rs = np.random.RandomState(seed)
    out = {}
    for key, p in net._collect_params_with_prefix().items():
        if key.endswith("gamma"):
            a = 1.0 + 0.1 * rs.standard_normal(p.shape)
        elif key.endswith("beta"):
            a = 0.1 * rs.standard_normal(p.shape)
        else:
            a = 0.02 * rs.standard_normal(p.shape)
        out[key] = a.astype(np.float32)
    return out


def test_seeded_params_keeps_bert_base():
    """The new rules touch only 4-D weights and running stats. BERT-base has
    neither, and on a BERT small enough to draw twice quickly (same layer
    types, 2 layers) the whole dict is equal; so BERT-base's is too."""
    from mxnet_tpu_torch.models import BertModel, bert_base
    shapes = {k: p.shape for k, p in bert_base(max_length=512)
              ._collect_params_with_prefix().items()}
    assert len(shapes) == 157
    assert not [k for k, s in shapes.items() if len(s) == 4 or "running" in k]
    net = BertModel(vocab_size=1000, num_layers=2, units=128, hidden_size=512,
                    num_heads=2, max_length=64)
    new, old = seeded_params(net, seed=0), _old_rule(net, seed=0)
    assert list(new) == list(old)
    for key in old:
        np.testing.assert_array_equal(new[key], old[key], err_msg=key)


def test_seeded_params_resnet50_scales():
    net = vision.resnet50_v1()
    net.initialize(ctx=mt.cpu())
    net(mt.nd.zeros((1, 3, 32, 32), ctx=mt.cpu()))      # shapes only
    params = seeded_params(net, seed=0)
    assert len(params) == 299
    running_var = [v for k, v in params.items() if k.endswith("running_var")]
    assert len(running_var) == 53 and min(v.min() for v in running_var) >= 1.0
    stem = params["features.0.weight"]                    # (64, 3, 7, 7)
    assert abs(stem.std() / np.sqrt(2.0 / 147) - 1) < 0.05
    assert abs(params["output.weight"].std() / 0.02 - 1) < 0.05


# ---------------------------------------------------------------------------
# ops
# ---------------------------------------------------------------------------

OP_CASES = [
    ("conv2d-stride-pad-bias", "Convolution", [_f(2, 4, 9, 9), _f(6, 4, 3, 3), _f(6)],
     {"kernel": (3, 3), "num_filter": 6, "stride": (2, 2), "pad": (1, 1)}),
    ("conv2d-dilate-groups", "Convolution", [_f(2, 4, 9, 8), _f(6, 2, 3, 3)],
     {"kernel": (3, 3), "num_filter": 6, "dilate": (2, 1), "num_group": 2,
      "no_bias": True}),
    ("conv2d-1x1", "Convolution", [_f(2, 8, 5, 5), _f(4, 8, 1, 1), _f(4)],
     {"kernel": (1, 1), "num_filter": 4, "stride": (2, 2)}),
    ("conv1d", "Convolution", [_f(2, 3, 11), _f(5, 3, 3), _f(5)],
     {"kernel": (3,), "num_filter": 5, "pad": (1,)}),
    ("conv3d", "Convolution", [_f(1, 2, 5, 5, 5), _f(3, 2, 3, 3, 3)],
     {"kernel": (3, 3, 3), "num_filter": 3, "stride": (2, 2, 2), "no_bias": True}),
    ("pool-max", "Pooling", [_f(2, 3, 9, 9)],
     {"kernel": (3, 3), "stride": (2, 2), "pad": (1, 1), "pool_type": "max"}),
    ("pool-avg-exclude-pad", "Pooling", [_f(2, 3, 8, 8)],
     {"kernel": (3, 3), "stride": (2, 2), "pad": (1, 1), "pool_type": "avg",
      "count_include_pad": False}),
    ("pool-sum", "Pooling", [_f(2, 3, 8, 8)],
     {"kernel": (2, 2), "stride": (2, 2), "pool_type": "sum"}),
    # "full" where torch's ceil_mode would drop the last window (3 vs 2)
    ("pool-max-full-beyond-ceil", "Pooling", [_f(2, 3, 5, 5)],
     {"kernel": (3, 3), "stride": (3, 3), "pad": (1, 1), "pool_type": "max",
      "pooling_convention": "full"}),
    ("pool-avg-full-beyond-ceil", "Pooling", [_f(2, 3, 5, 5)],
     {"kernel": (3, 3), "stride": (3, 3), "pad": (1, 1), "pool_type": "avg",
      "pooling_convention": "full"}),
    ("pool-avg-full-exclude-pad", "Pooling", [_f(2, 3, 6, 7)],
     {"kernel": (3, 3), "stride": (2, 2), "pad": (1, 1), "pool_type": "avg",
      "pooling_convention": "full", "count_include_pad": False}),
    ("pool-max-1d-wide-pad", "Pooling", [_f(2, 3, 10)],
     {"kernel": (2,), "stride": (2,), "pad": (2,), "pool_type": "max"}),
    ("pool-global-avg", "Pooling", [_f(2, 3, 5, 4)],
     {"kernel": (1, 1), "global_pool": True, "pool_type": "avg"}),
    ("pool-global-max", "Pooling", [_f(2, 3, 5, 4)],
     {"kernel": (1, 1), "global_pool": True, "pool_type": "max"}),
    ("pool-global-sum", "Pooling", [_f(2, 3, 5, 4)],
     {"global_pool": True, "pool_type": "sum"}),
    ("bn-train", "BatchNorm", [_f(4, 3, 5, 5) * 2 + 1, _f(3), _f(3), _f(3),
                               np.abs(_f(3)) + 0.5],
     {"eps": 1e-5, "fix_gamma": False, "training": True}),
    ("bn-eval", "BatchNorm", [_f(4, 3, 5, 5), _f(3), _f(3), _f(3), np.abs(_f(3)) + 0.5],
     {"eps": 1e-5, "fix_gamma": False, "training": False}),
    ("bn-eval-constant-stats", "BatchNorm", [_f(4, 3, 5, 5), _f(3), _f(3), _f(3),
                                             np.abs(_f(3)) + 0.5],
     {"eps": 1e-5, "fix_gamma": False, "training": False, "_constant": (3, 4)}),
    ("bn-fix-gamma", "BatchNorm", [_f(4, 3, 5, 5), _f(3), _f(3), _f(3), np.abs(_f(3)) + 0.5],
     {"training": True}),
    ("bn-axis-last-global-stats", "BatchNorm", [_f(4, 5, 3), _f(3), _f(3), _f(3),
                                                np.abs(_f(3)) + 0.5],
     {"axis": -1, "fix_gamma": False, "use_global_stats": True, "training": True}),
]


@pytest.fixture(scope="module")
def ref_vjp():
    import jax
    import jax.numpy as jnp
    from mxnet_tpu.ops.registry import get_op as ref_get_op

    def run(name, arrays, params, cots):
        fn = ref_get_op(name).fn
        outs, vjp = jax.vjp(lambda *a: fn(*a, **params), *map(jnp.asarray, arrays))
        single = not isinstance(outs, tuple)
        grads = vjp(jnp.asarray(cots[0]) if single else tuple(map(jnp.asarray, cots)))
        outs = [outs] if single else list(outs)
        return [np.asarray(o) for o in outs], [np.asarray(g) for g in grads]
    return run


def _port_vjp(name, arrays, params, cots, constant=()):
    """Outputs and input gradients; inputs listed in ``constant`` need no
    gradient (the port's op may take another kernel for them)."""
    ts = [torch.from_numpy(a).requires_grad_(i not in constant)
          for i, a in enumerate(arrays)]
    outs = get_op(name)(*ts, **params)
    outs = list(outs) if isinstance(outs, tuple) else [outs]
    wrt = [t for t in ts if t.requires_grad]
    live = [(o, torch.from_numpy(c)) for o, c in zip(outs, cots) if o.requires_grad]
    got = iter(torch.autograd.grad([o for o, _ in live], wrt, [c for _, c in live],
                                   allow_unused=True))
    grads = [next(got) if t.requires_grad else None for t in ts]
    return ([o.detach().numpy() for o in outs],
            [np.zeros_like(a) if g is None else g.numpy() for a, g in zip(arrays, grads)])


@pytest.mark.parametrize("name,arrays,params", [c[1:] for c in OP_CASES],
                         ids=[c[0] for c in OP_CASES])
def test_op_forward_and_gradients_match_reference(ref_vjp, name, arrays, params):
    params = dict(params)
    constant = params.pop("_constant", ())
    outs = get_op(name)(*(torch.from_numpy(a) for a in arrays), **params)
    outs = list(outs) if isinstance(outs, tuple) else [outs]
    rs = np.random.RandomState(len(name))
    cots = [rs.standard_normal(o.shape).astype(np.float32) for o in outs]
    r_outs, r_grads = ref_vjp(name, arrays, params, cots)
    p_outs, p_grads = _port_vjp(name, arrays, params, cots, constant)
    assert len(p_outs) == len(r_outs)
    for i, (g, e) in enumerate(zip(p_outs, r_outs)):
        assert g.dtype == e.dtype
        _close(g, e, what=f"output {i}")
    for i, (g, e) in enumerate(zip(p_grads, r_grads)):
        if i not in constant:
            _close(g, e, what=f"gradient of input {i}")


def test_conv_float16_computes_in_float32(ref_vjp):
    x, w = _f(1, 2, 6, 6), _f(3, 2, 3, 3)
    params = {"kernel": (3, 3), "num_filter": 3, "no_bias": True}
    got = get_op("Convolution")(torch.from_numpy(x).half(), torch.from_numpy(w).half(),
                                **params)
    (expect,), _ = ref_vjp("Convolution", [x.astype(np.float16), w.astype(np.float16)],
                           params, [np.zeros((1, 3, 4, 4), np.float16)])
    assert got.dtype == torch.float16 and expect.dtype == np.float16
    np.testing.assert_array_equal(got.numpy(), expect)


# ---------------------------------------------------------------------------
# layers, with deferred shape inference
# ---------------------------------------------------------------------------

LAYERS = [
    ("conv2d", lambda nn: nn.Conv2D(6, 3, strides=2, padding=1), (2, 4, 9, 9)),
    ("conv2d-groups-relu", lambda nn: nn.Conv2D(6, 1, groups=2, activation="relu"),
     (2, 4, 5, 5)),
    ("batchnorm", lambda nn: nn.BatchNorm(), (4, 3, 5, 5)),
    ("batchnorm-no-scale", lambda nn: nn.BatchNorm(scale=False, center=False, momentum=0.5),
     (4, 3, 5, 5)),
    ("dense-flatten", lambda nn: nn.Dense(5), (2, 3, 4, 4)),
    ("maxpool", lambda nn: nn.MaxPool2D(3, 2, 1), (2, 3, 9, 9)),
    ("avgpool-ceil", lambda nn: nn.AvgPool2D(2, ceil_mode=True, count_include_pad=False),
     (2, 3, 7, 7)),
    ("global-avg", lambda nn: nn.GlobalAvgPool2D(), (2, 3, 5, 5)),
    ("global-max", lambda nn: nn.GlobalMaxPool2D(), (2, 3, 5, 5)),
    ("flatten", lambda nn: nn.Flatten(), (2, 3, 4, 5)),
    ("activation", lambda nn: nn.Activation("relu"), (2, 3, 4)),
]


@pytest.fixture(scope="module")
def ref_mx():
    import mxnet_tpu as mx
    return mx


def _both(ref_mx, make, shape, seed):
    """The layer in both packages, shapes inferred from one forward each,
    the port's weights copied into the reference."""
    x = np.random.RandomState(seed).standard_normal(shape).astype(np.float32)
    port, ref = make(mt.gluon.nn), make(ref_mx.gluon.nn)
    port.initialize(ctx=mt.cpu())
    ref.initialize(ctx=ref_mx.cpu())
    port(mt.nd.array(x, ctx=mt.cpu()))
    ref(ref_mx.nd.array(x, ctx=ref_mx.cpu()))
    pp, rp = port._collect_params_with_prefix(), ref._collect_params_with_prefix()
    assert {k: p.shape for k, p in pp.items()} == {k: p.shape for k, p in rp.items()}
    if pp:
        weights = seeded_params(port, seed)
        load_jax_params(port, weights)
        for key, p in rp.items():
            p.set_data(ref_mx.nd.array(weights[key], ctx=ref_mx.cpu()))
    return port, ref, x


@pytest.mark.parametrize("make,shape", [c[1:] for c in LAYERS], ids=[c[0] for c in LAYERS])
def test_layer_matches_reference(ref_mx, make, shape):
    port, ref, x = _both(ref_mx, make, shape, seed=len(shape))
    xp, xr = mt.nd.array(x, ctx=mt.cpu()), ref_mx.nd.array(x, ctx=ref_mx.cpu())
    _close(port(xp).asnumpy(), ref(xr).asnumpy(), what="inference")
    with mt.autograd.record():
        got = port(xp).asnumpy()
    with ref_mx.autograd.record():
        expect = ref(xr).asnumpy()
    _close(got, expect, what="training mode")
    rp = ref._collect_params_with_prefix()
    for key, p in port._collect_params_with_prefix().items():
        _close(p.data().asnumpy(), rp[key].data().asnumpy(), what=key)


def test_deferred_parameter_waits_for_the_first_forward():
    conv = mt.gluon.nn.Conv2D(8, 3)
    conv.initialize(ctx=mt.cpu())
    assert conv.weight.shape == (8, 0, 3, 3)
    with pytest.raises(DeferredInitializationError, match="in_channels"):
        conv.weight.data()
    out = conv(mt.nd.zeros((1, 5, 6, 6), ctx=mt.cpu()))
    assert conv.weight.shape == (8, 5, 3, 3) and out.shape == (1, 8, 4, 4)
    assert conv.weight.data().ctx == mt.cpu()
    bare = mt.gluon.Parameter("w", shape=(4, 0))
    with pytest.raises(mt.MXNetError, match="allow_deferred_init"):
        bare.initialize(ctx=mt.cpu())


def test_running_stats_are_skipped_by_the_trainer():
    bn = mt.gluon.nn.BatchNorm(in_channels=3)
    bn.initialize(ctx=mt.cpu())
    trainer = mt.gluon.Trainer(bn.collect_params(), "sgd", {"learning_rate": 1.0})
    x = mt.nd.array(_f(4, 3, 2, 2) + 3.0, ctx=mt.cpu())
    with mt.autograd.record():
        loss = bn(x).sum()
    loss.backward()
    mean = bn.running_mean.data().asnumpy()
    np.testing.assert_allclose(mean, 0.1 * x.asnumpy().mean(axis=(0, 2, 3)), rtol=1e-6)
    trainer.step(1)
    np.testing.assert_array_equal(bn.running_mean.data().asnumpy(), mean)
    with pytest.raises(mt.MXNetError, match="grad_req='null'"):
        bn.running_var.grad()


def test_model_zoo_names():
    assert isinstance(model_zoo.get_model("resnet50_v1"), vision.ResNetV1)
    assert isinstance(model_zoo.get_model("ResNet18_v2"), vision.ResNetV2)
    with pytest.raises(mt.MXNetError, match="ROADMAP"):
        model_zoo.get_model("vgg16")
    with pytest.raises(mt.MXNetError, match="not in zoo"):
        model_zoo.get_model("resnet51_v1")
    with pytest.raises(mt.MXNetError, match="pretrained"):
        vision.resnet18_v1(pretrained=True)


# ---------------------------------------------------------------------------
# whole narrow nets
# ---------------------------------------------------------------------------

CHANNELS = [16, 32, 64, 128, 256]
NETS = [("v1-bottleneck", "ResNetV1", "BottleneckV1"),
        ("v1-basic", "ResNetV1", "BasicBlockV1"),
        ("v2-bottleneck", "ResNetV2", "BottleneckV2"),
        ("v2-basic", "ResNetV2", "BasicBlockV2")]


def _nets(ref_mx, net_cls, block_cls, seed):
    """The port's net (shapes from one forward) and the reference's
    (hybridized), holding the same seeded weights: the reference's are set
    directly, in the port's shapes, and carried into the port by
    ``load_jax_params``."""
    from mxnet_tpu.gluon.model_zoo.vision import resnet as ref_resnet
    port = getattr(vision, net_cls)(getattr(vision, block_cls), [1, 1, 1, 1], CHANNELS,
                                    classes=10)
    port.initialize(ctx=mt.cpu())
    port(mt.nd.zeros((1, 3, IMAGE, IMAGE), ctx=mt.cpu()))
    weights = seeded_params(port, seed)
    ref = getattr(ref_resnet, net_cls)(getattr(ref_resnet, block_cls), [1, 1, 1, 1],
                                       CHANNELS, classes=10)
    for key, p in ref._collect_params_with_prefix().items():
        p.set_data(ref_mx.nd.array(weights[key], ctx=ref_mx.cpu()))
    ref.hybridize()
    load_jax_params(port, {k: p.data().asnumpy()
                           for k, p in ref._collect_params_with_prefix().items()})
    return port, ref


def _images(seed):
    rs = np.random.RandomState(seed)
    return (rs.uniform(-1, 1, (2, 3, IMAGE, IMAGE)).astype(np.float32),
            rs.randint(0, 10, size=(2,)).astype(np.int32))


@pytest.mark.parametrize("net_cls,block_cls", [n[1:] for n in NETS],
                         ids=[n[0] for n in NETS])
def test_narrow_resnet_logits_match_reference(ref_mx, net_cls, block_cls):
    port, ref = _nets(ref_mx, net_cls, block_cls, seed=11)
    x, _ = _images(12)
    xp, xr = mt.nd.array(x, ctx=mt.cpu()), ref_mx.nd.array(x, ctx=ref_mx.cpu())
    got, expect = port(xp).asnumpy(), ref(xr).asnumpy()
    assert expect.std() > 0.1                 # the logits are not trivially small
    _close(got, expect, what="inference logits")
    with mt.autograd.record():
        got = port(xp).asnumpy()
    with ref_mx.autograd.record():
        expect = ref(xr).asnumpy()
    _close(got, expect, what="training-mode logits")
    rp = ref._collect_params_with_prefix()
    for key, p in port._collect_params_with_prefix().items():
        if "running" in key:
            _close(p.data().asnumpy(), rp[key].data().asnumpy(), what=key)


@pytest.mark.parametrize("net_cls,block_cls", [n[1:] for n in NETS[::3]],
                         ids=[n[0] for n in NETS[::3]])
def test_narrow_resnet_sgd_steps_match_reference(ref_mx, net_cls, block_cls):
    port, ref = _nets(ref_mx, net_cls, block_cls, seed=21)
    x, y = _images(22)
    hyper = {"learning_rate": 0.05, "momentum": 0.9, "wd": 1e-4}
    runs = []
    for mx, net in ((mt, port), (ref_mx, ref)):
        loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
        trainer = mx.gluon.Trainer(net.collect_params(), "sgd", hyper)
        xs, ys = mx.nd.array(x, ctx=mx.cpu()), mx.nd.array(y, ctx=mx.cpu(), dtype="int32")
        losses = []
        for _ in range(3):
            with mx.autograd.record():
                loss = loss_fn(net(xs), ys)
            loss.backward()
            trainer.step(2)
            losses.append(loss.asnumpy())
        runs.append((np.array(losses), {k: p.data().asnumpy() for k, p in
                                        net._collect_params_with_prefix().items()}))
    (p_loss, p_w), (r_loss, r_w) = runs
    assert np.isfinite(p_loss).all()
    np.testing.assert_allclose(p_loss, r_loss, rtol=TOL)
    assert p_loss[-1].mean() < p_loss[0].mean()     # one batch: the loss falls
    assert set(p_w) == set(r_w)
    for key, w in r_w.items():
        _close(p_w[key], w, what=key)
