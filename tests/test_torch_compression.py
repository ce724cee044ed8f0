"""2-bit gradient compression with error feedback against the reference's, on the CPU.

- ``KVStoreDist._compress`` over 5 pushes of one key, bitwise the
  reference's ``KVStoreDist._compress`` (both single-process dist stores: the
  port's on a world-1 gloo group), values, residuals and all; the in-process
  stores refuse compression as the reference's do, and ``{"type": "none"}``
  turns it off;
- ``DataParallelTrainer(compression=...)`` on a one-device mesh: 10 SGD
  steps and the weights against the reference's compressed step, and the
  refusals (another type, ZeRO, overlap);
- on 2 gloo ranks spawned by ``_dist_util.launch_local`` (one spawn for the
  module): the compressed dp 2 trajectory against the reference's on a
  2-device CPU mesh ``make_mesh({"dp": 2})``, and ``dist_sync`` with
  compression under ``gluon.Trainer``.

Tolerances: the quantized values are multiples of the threshold, so the
``_compress`` sequence is compared bitwise; the trainers' losses and weights
at rtol 1e-5 / atol 1e-6 (the gradients before quantization differ by float
rounding only; a flip of one quantization bucket would show as a multiple of
threshold x lr, far above it).
"""
import os

import numpy as np
import pytest
import torch

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import _dist_util
from mxnet_tpu_torch.parallel import DataParallelTrainer, make_mesh
from torch_threads import one_torch_thread  # noqa: F401

MODULE = "test_torch_compression"
TESTS_DIR = os.path.dirname(os.path.abspath(__file__))
RTOL, ATOL = 1e-5, 1e-6
COMP = {"type": "2bit", "threshold": 0.05}
STEPS = 10
B = 16


@pytest.fixture(scope="module")
def ref():
    import mxnet_tpu as mx
    from mxnet_tpu.parallel import DataParallelTrainer as RefDPT, make_mesh as ref_mesh
    return mx, RefDPT, ref_mesh


@pytest.fixture
def world1(tmp_path):
    _dist_util.init_process_group(device="cpu", backend="gloo", rank=0, world_size=1,
                                  init_method=f"file://{tmp_path / 'rdzv'}")
    yield
    _dist_util.destroy_process_group()


def _pushes():
    rs = np.random.RandomState(5)
    return [rs.uniform(-0.8, 0.8, (7, 3)).astype(np.float32) for _ in range(5)]


def test_compress_sequence_bitwise_reference(ref, world1):
    mx = ref[0]
    rkv = mx.kv.create("dist_sync")
    pkv = mt.kv.create("dist_sync")
    for kv in (rkv, pkv):
        kv.set_gradient_compression({"type": "2bit", "threshold": 0.5})
    for g in _pushes():
        q_ref = np.asarray(rkv._compress("k", mx.nd.array(g))._data)
        q_port = pkv._compress("k", torch.from_numpy(g)).numpy()
        np.testing.assert_array_equal(q_port, q_ref)
        np.testing.assert_array_equal(pkv._comp_residual["k"].numpy(),
                                      np.asarray(rkv._comp_residual["k"]))
    assert set(np.unique(q_port)) <= {-0.5, 0.0, 0.5}
    # through push and pull: the stored value is the quantized push
    pkv.init("w", mt.nd.zeros((7, 3), ctx=mt.cpu()))
    rkv.init("w", mx.nd.zeros((7, 3)))
    for g in _pushes():
        pkv.push("w", mt.nd.array(g, ctx=mt.cpu()))
        rkv.push("w", mx.nd.array(g))
    po, ro = mt.nd.zeros((7, 3), ctx=mt.cpu()), mx.nd.zeros((7, 3))
    pkv.pull("w", out=po)
    rkv.pull("w", out=ro)
    np.testing.assert_array_equal(po.asnumpy(), ro.asnumpy())
    pkv.set_gradient_compression({"type": "none"})
    assert not pkv._compression


@pytest.mark.parametrize("kv_type", ["local", "device", "nccl"])
def test_in_process_stores_refuse(ref, kv_type):
    mx = ref[0]
    for pkg in (mt, mx):
        kv = pkg.kv.create(kv_type)
        with pytest.raises(pkg.MXNetError, match="only supported on dist"):
            kv.set_gradient_compression(COMP)


def test_unknown_type_refused(world1):
    with pytest.raises(mt.MXNetError, match="unsupported gradient compression"):
        mt.kv.create("dist_sync").set_gradient_compression({"type": "1bit"})


def _weights():
    rs = np.random.RandomState(11)
    return {"0.weight": (rs.randn(16, 8) * 0.3).astype(np.float32),
            "0.bias": (rs.randn(16) * 0.1).astype(np.float32),
            "1.weight": (rs.randn(4, 16) * 0.3).astype(np.float32),
            "1.bias": (rs.randn(4) * 0.1).astype(np.float32)}


def _batch():
    rs = np.random.RandomState(12)
    return (rs.randn(B, 8).astype(np.float32), rs.randint(0, 4, size=(B,)).astype(np.int32))


def _mlp(pkg, weights):
    net = pkg.gluon.nn.HybridSequential()
    net.add(pkg.gluon.nn.Dense(16, activation="relu", in_units=8),
            pkg.gluon.nn.Dense(4, in_units=16))
    net.initialize(ctx=pkg.cpu())
    for k, p in net._collect_params_with_prefix().items():
        p.set_data(pkg.nd.array(weights[k], ctx=pkg.cpu()))
    return net


def _params(net):
    return {k: p.data().asnumpy() for k, p in net._collect_params_with_prefix().items()}


def _port_run(mesh, x, y, steps=STEPS):
    net = _mlp(mt, _weights())
    tr = DataParallelTrainer(net, mt.gluon.loss.SoftmaxCrossEntropyLoss(), "sgd",
                             {"learning_rate": 0.1, "momentum": 0.9}, mesh=mesh,
                             compression=COMP)
    losses = [float(tr.step(mt.nd.array(x, ctx=mt.cpu()),
                            mt.nd.array(y, ctx=mt.cpu(), dtype="int32")))
              for _ in range(steps)]
    tr.sync()
    return losses, _params(net), tr


def _ref_run(ref, n, x, y, steps=STEPS):
    import jax
    import jax.numpy as jnp
    mx, RefDPT, ref_mesh = ref

    def loss_fn(logits, labels):
        logz = jax.nn.logsumexp(logits, axis=-1)
        gold = jnp.take_along_axis(logits, labels[:, None].astype(jnp.int32), axis=-1)[:, 0]
        return jnp.mean(logz - gold)

    net = _mlp(mx, _weights())
    tr = RefDPT(net, loss_fn, "sgd", {"learning_rate": 0.1, "momentum": 0.9},
                mesh=ref_mesh({"dp": n}, devices=jax.devices("cpu")[:n]), compression=COMP)
    losses = [float(tr.step(mx.nd.array(x), mx.nd.array(y, dtype="int32")))
              for _ in range(steps)]
    tr.sync()
    return losses, _params(net), tr


def test_compressed_step_matches_reference_one_device(ref):
    x, y = _batch()
    p_loss, p_w, tr = _port_run(make_mesh({"dp": 1}, devices=[mt.cpu()]), x, y)
    r_loss, r_w, rt = _ref_run(ref, 1, x, y)
    np.testing.assert_allclose(p_loss, r_loss, rtol=RTOL, atol=ATOL)
    for k, w in r_w.items():
        np.testing.assert_allclose(p_w[k], w, rtol=RTOL, atol=ATOL, err_msg=k)
    for r, rr in zip([r for r in tr._comp_resid if r is not None], rt._comp_resid):
        np.testing.assert_allclose(r.numpy(), np.asarray(rr)[0], rtol=RTOL, atol=ATOL)
    assert p_loss[-1] < p_loss[0]


@pytest.mark.parametrize("kw,match", [
    ({"compression": {"type": "1bit"}}, "unsupported gradient compression"),
    ({"compression": COMP, "zero_update": True}, "zero_update is incompatible"),
    ({"compression": COMP, "overlap_grads": True}, "overlap_grads is incompatible")])
def test_trainer_refusals(kw, match):
    with pytest.raises(mt.MXNetError, match=match):
        DataParallelTrainer(_mlp(mt, _weights()), mt.gluon.loss.SoftmaxCrossEntropyLoss(),
                            "sgd", mesh=make_mesh({"dp": 1}, devices=[mt.cpu()]), **kw)


# -- two ranks -------------------------------------------------------------------------

def rank_compressed():
    """One of 2 ranks: the compressed DPT on its half of the batch, then
    ``dist_sync`` with compression under ``gluon.Trainer``."""
    import sys
    x, y = _batch()
    losses, weights, tr = _port_run(make_mesh({"dp": 2}, devices=[mt.cpu()]), x, y)
    kv = mt.kv.create("dist_sync")
    r = kv.rank
    kv.set_gradient_compression({"type": "2bit", "threshold": 0.5})
    kv.init("w", mt.nd.zeros((4,), ctx=mt.cpu()))
    got = []
    for step in range(3):
        kv.push("w", mt.nd.array(np.full(4, 0.3 * (r + 1) * (step + 1), np.float32),
                                 ctx=mt.cpu()))
        out = mt.nd.zeros((4,), ctx=mt.cpu())
        kv.pull("w", out=out)
        got.append(out.asnumpy().tolist())
    net = _mlp(mt, _weights())
    trainer = mt.gluon.Trainer(net.collect_params(), "sgd", {"learning_rate": 0.1},
                               kvstore="dist_sync", compression_params=COMP)
    half = slice(r * B // 2, (r + 1) * B // 2)
    loss_fn = mt.gluon.loss.SoftmaxCrossEntropyLoss()
    for _ in range(3):
        with mt.autograd.record():
            loss = loss_fn(net(mt.nd.array(x[half], ctx=mt.cpu())),
                           mt.nd.array(y[half], ctx=mt.cpu()))
        loss.backward()
        trainer.step(B)
    return {"rank": r, "losses": losses,
            "weights": {k: v.tolist() for k, v in weights.items()}, "kv": got,
            "trainer": {k: v.tolist() for k, v in _params(net).items()},
            "modules": sorted(m for m in sys.modules
                              if m.split(".")[0] in ("jax", "jaxlib", "mxnet_tpu"))}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return _dist_util.launch_local(f"{MODULE}:rank_compressed", 2, device="cpu",
                                   timeout=180, pythonpath=[TESTS_DIR],
                                   workdir=str(tmp_path_factory.mktemp("comp")))


def test_compressed_dp2_matches_reference_two_devices(ref, ranks):
    x, y = _batch()
    r_loss, r_w, _ = _ref_run(ref, 2, x, y)
    for w in ranks:
        assert not w["modules"]
        np.testing.assert_allclose(w["losses"], r_loss, rtol=RTOL, atol=ATOL)
        for k, v in r_w.items():
            np.testing.assert_allclose(np.array(w["weights"][k]), v, rtol=RTOL, atol=ATOL,
                                       err_msg=k)


def test_dist_sync_with_compression(ref, ranks):
    """Each rank's push quantized with its own residual, then summed: the
    same arithmetic as two reference dist stores' ``_compress`` added."""
    mx = ref[0]
    stores = [mx.kv.create("dist_sync") for _ in range(2)]
    for kv in stores:
        kv.set_gradient_compression({"type": "2bit", "threshold": 0.5})
    want = []
    for step in range(3):
        q = [np.asarray(kv._compress("w", mx.nd.array(
            np.full(4, 0.3 * (r + 1) * (step + 1), np.float32)))._data)
            for r, kv in enumerate(stores)]
        want.append((q[0] + q[1]).tolist())
    for w in ranks:
        assert w["kv"] == want
    # the two ranks' Trainers stay in lock step
    for k in ranks[0]["trainer"]:
        assert ranks[0]["trainer"][k] == ranks[1]["trainer"][k]
