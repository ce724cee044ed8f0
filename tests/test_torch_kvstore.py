"""The port's kvstore against the reference's, on the CPU.

- The cases of ``tests/test_kvstore.py`` the port supports, each run in both
  packages in this process and compared: init/push/pull by store type, the
  sum of a pushed list, an updater on the store, pushpull (one key, and a
  list of keys reduced by buckets), several and string keys, the optimizer
  states' round trip; and every store refusing gradient compression.
- ``dist_sync`` over two ranks of ``torch.distributed`` (gloo on the CPU,
  spawned by ``_dist_util.launch_local``, one spawn for the module, a 120 s
  join timeout; the ranks import only the port and this module): push/pull
  and pushpull sum the workers' values, init keeps rank 0's value, and
  ``gluon.Trainer(kvstore="dist_sync")`` on each worker's half of a batch
  ends where the reference's ``Trainer`` ends on the whole batch, with the
  update on the store (the default for ``dist*``) and with the bucketed
  gradient reduction (``update_on_kvstore=False``).
- The ``MXNetError`` of each store type that waits for a later slice.

Tolerances: the sums are exact; 3 Adam steps of a two-layer MLP 1e-5
(float32, only the order of summation differs).
"""
import pathlib

import numpy as np
import pytest
import torch

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import _dist_util
from torch_threads import one_torch_thread  # noqa: F401

MODULE = "test_torch_kvstore"
TESTS_DIR = str(pathlib.Path(__file__).resolve().parent)
TOL = 1e-5
B = 8


@pytest.fixture(scope="module")
def mx():
    import mxnet_tpu as mx
    return mx


def _both(mx):
    return ((mt, mt.cpu()), (mx, mx.cpu()))


def _ones(pkg, ctx, shape):
    return pkg.nd.array(np.ones(shape, np.float32), ctx=ctx)


@pytest.mark.parametrize("kv_type", ["local", "device", "tpu", "nccl"])
def test_init_push_pull(mx, kv_type):
    for pkg, ctx in _both(mx):
        kv = pkg.kv.create(kv_type if pkg is mt or kv_type != "nccl" else "tpu")
        kv.init(3, _ones(pkg, ctx, (2, 3)))
        out = pkg.nd.zeros((2, 3), ctx=ctx)
        kv.pull(3, out=out)
        np.testing.assert_allclose(out.asnumpy(), np.ones((2, 3)))
        kv.push(3, _ones(pkg, ctx, (2, 3)) * 4)
        kv.pull(3, out=out)
        np.testing.assert_allclose(out.asnumpy(), 4 * np.ones((2, 3)))


def test_push_aggregates_list(mx):
    outs = []
    for pkg, ctx in _both(mx):
        kv = pkg.kv.create("local")
        kv.init("w", pkg.nd.zeros((4,), ctx=ctx))
        kv.push("w", [_ones(pkg, ctx, (4,)) * c for c in (1, 2, 3)])
        out = pkg.nd.zeros((4,), ctx=ctx)
        kv.pull("w", out=out)
        outs.append(out.asnumpy())
    np.testing.assert_array_equal(outs[0], outs[1])
    np.testing.assert_array_equal(outs[0], 6 * np.ones(4))


def test_updater_on_store(mx):
    outs = []
    for pkg, ctx in _both(mx):
        kv = pkg.kv.create("local")
        kv.init("w", _ones(pkg, ctx, (3,)))
        if pkg is mt:
            def sgd_like(key, grad, weight):
                weight._data.copy_((weight - 0.1 * grad)._data)
        else:
            def sgd_like(key, grad, weight):
                weight._set_data((weight - 0.1 * grad)._data)
        kv.set_updater(sgd_like)
        kv.push("w", _ones(pkg, ctx, (3,)))
        out = pkg.nd.zeros((3,), ctx=ctx)
        kv.pull("w", out=out)
        outs.append(out.asnumpy())
    np.testing.assert_allclose(outs[0], outs[1], rtol=1e-6)
    np.testing.assert_allclose(outs[0], 0.9 * np.ones(3), rtol=1e-6)


def test_pushpull_persists(mx):
    for pkg, ctx in _both(mx):
        kv = pkg.kv.create("tpu")
        kv.init(0, pkg.nd.zeros((5,), ctx=ctx))
        out = pkg.nd.zeros((5,), ctx=ctx)
        kv.pushpull(0, _ones(pkg, ctx, (5,)) * 2, out=out)
        np.testing.assert_array_equal(out.asnumpy(), 2 * np.ones(5))
        after = pkg.nd.zeros((5,), ctx=ctx)
        kv.pull(0, out=after)
        np.testing.assert_array_equal(after.asnumpy(), 2 * np.ones(5))


def test_pushpull_key_list_by_buckets(mx, monkeypatch):
    """A list of keys with no updater goes through float32 buckets; with a
    bucket smaller than one value every key is a bucket of its own."""
    rs = np.random.RandomState(0)
    vals = [rs.randn(*s).astype(np.float32) for s in ((3, 4), (5,), (2, 2, 2))]
    monkeypatch.setenv("MXNET_TPU_BUCKET_BYTES", "40")
    outs = []
    for pkg, ctx in _both(mx):
        kv = pkg.kv.create("device")
        kv.init([0, 1, 2], [pkg.nd.zeros(v.shape, ctx=ctx) for v in vals])
        out = [pkg.nd.zeros(v.shape, ctx=ctx) for v in vals]
        kv.pushpull([0, 1, 2], [[pkg.nd.array(v, ctx=ctx)] * 2 for v in vals], out=out)
        stored = [pkg.nd.zeros(v.shape, ctx=ctx) for v in vals]
        kv.pull([0, 1, 2], out=stored)
        outs.append([o.asnumpy() for o in out + stored])
    for a, b, v in zip(outs[0], outs[1], vals + vals):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, 2 * v)


def test_multiple_keys_and_str_keys(mx):
    for pkg, ctx in _both(mx):
        kv = pkg.kv.create("local")
        keys = ["a", "b", "c"]
        for i, k in enumerate(keys):
            kv.init(k, _ones(pkg, ctx, (2,)) * i)
        for i, k in enumerate(keys):
            o = pkg.nd.zeros((2,), ctx=ctx)
            kv.pull(k, out=o)
            np.testing.assert_array_equal(o.asnumpy(), i * np.ones(2))


def test_optimizer_states_roundtrip(mx, tmp_path):
    """The states saved after one momentum update, loaded into a second
    store, give the same next update; in both packages alike."""
    results = []
    for pkg, ctx in _both(mx):
        kv = pkg.kv.create("local")
        kv.init("w", _ones(pkg, ctx, (3,)))
        kv.set_optimizer(pkg.optimizer.create("sgd", learning_rate=0.1, momentum=0.9))
        kv.push("w", _ones(pkg, ctx, (3,)))
        fname = str(tmp_path / f"{pkg.__name__}.states")
        kv.save_optimizer_states(fname)
        cur = pkg.nd.zeros((3,), ctx=ctx)
        kv.pull("w", out=cur)
        kv2 = pkg.kv.create("local")
        kv2.init("w", cur)
        kv2.set_optimizer(pkg.optimizer.create("sgd", learning_rate=0.1, momentum=0.9))
        kv2.load_optimizer_states(fname)
        o1, o2 = pkg.nd.zeros((3,), ctx=ctx), pkg.nd.zeros((3,), ctx=ctx)
        for k, o in ((kv, o1), (kv2, o2)):
            k.push("w", _ones(pkg, ctx, (3,)))
            k.pull("w", out=o)
        np.testing.assert_allclose(o1.asnumpy(), o2.asnumpy(), rtol=1e-6)
        results.append(o1.asnumpy())
    np.testing.assert_allclose(results[0], results[1], rtol=1e-6)


@pytest.mark.parametrize("kv_type", ["local", "device", "nccl"])
def test_gradient_compression_refused(kv_type):
    kv = mt.kv.create(kv_type)
    with pytest.raises(mt.MXNetError, match="compression"):
        kv.set_gradient_compression({"type": "2bit", "threshold": 0.5})


@pytest.mark.parametrize("name,match", [
    ("dist_async", "kvstore/ps.py"), ("dist_async_device", "kvstore/ps.py"),
    ("dist_device_async", "kvstore/ps.py"), ("nonsense", "unknown kvstore")])
def test_deferred_and_unknown_types_raise(name, match):
    with pytest.raises(mt.MXNetError, match=match):
        mt.kv.create(name)
    net = mt.gluon.nn.Dense(2, in_units=3)
    net.initialize(ctx=mt.cpu())
    with pytest.raises(mt.MXNetError, match=match):
        mt.gluon.Trainer(net.collect_params(), "sgd", kvstore=name)


def test_trainer_refuses_compression_and_devices():
    net = mt.gluon.nn.Dense(2, in_units=3)
    net.initialize(ctx=mt.cpu())
    with pytest.raises(mt.MXNetError, match="ROADMAP A2"):
        mt.gluon.Trainer(net.collect_params(), "sgd",
                         compression_params={"type": "2bit"})
    kv = mt.kv.create("local")
    kv.init("k", _ones(mt, mt.cpu(), (2,)))
    elsewhere = mt.nd.NDArray(torch.ones(2, device="meta"), mt.cpu())   # another device
    with pytest.raises(mt.MXNetError, match="several devices"):
        kv.push("k", [_ones(mt, mt.cpu(), (2,)), elsewhere])


# -- two workers --------------------------------------------------------------

def _mlp(pkg, ctx, weights):
    net = pkg.gluon.nn.HybridSequential()
    net.add(pkg.gluon.nn.Dense(16, in_units=8, activation="relu"),
            pkg.gluon.nn.Dense(4, in_units=16))
    net.initialize(ctx=ctx)
    for key, p in net._collect_params_with_prefix().items():
        p.set_data(pkg.nd.array(weights[key], ctx=ctx))
    return net


def _train(pkg, ctx, net, x, y, kvstore, update_on_kvstore=None, steps=3):
    trainer = pkg.gluon.Trainer(net.collect_params(), "adam", {"learning_rate": 0.01},
                                kvstore=kvstore, update_on_kvstore=update_on_kvstore)
    loss_fn = pkg.gluon.loss.SoftmaxCrossEntropyLoss()
    for _ in range(steps):
        with pkg.autograd.record():
            loss = loss_fn(net(pkg.nd.array(x, ctx=ctx)), pkg.nd.array(y, ctx=ctx))
        loss.backward()
        trainer.step(B)
    return {k: p.data().asnumpy().tolist() for k, p in net._collect_params_with_prefix().items()}


def _data():
    rs = np.random.RandomState(2)
    weights = {"0.weight": rs.randn(16, 8) * 0.3, "0.bias": rs.randn(16) * 0.1,
               "1.weight": rs.randn(4, 16) * 0.3, "1.bias": rs.randn(4) * 0.1}
    weights = {k: v.astype(np.float32) for k, v in weights.items()}
    x = rs.randn(B, 8).astype(np.float32)
    y = rs.randint(0, 4, size=(B,)).astype(np.float32)
    return weights, x, y


def rank_dist_sync():
    """One worker: the dist_sync sums, then the Trainer on its half batch."""
    import sys
    kv = mt.kv.create("dist_sync")
    ctx = mt.cpu()
    r = kv.rank
    kv.init("w", _ones(mt, ctx, (3,)) * (r + 7))      # rank 0's value wins
    init = mt.nd.zeros((3,), ctx=ctx)
    kv.pull("w", out=init)
    kv.push("w", _ones(mt, ctx, (3,)) * (r + 1))       # 1 + 2
    pushed = mt.nd.zeros((3,), ctx=ctx)
    kv.pull("w", out=pushed)
    pp = mt.nd.zeros((3,), ctx=ctx)
    kv.pushpull("w", [_ones(mt, ctx, (3,)) * (r + 1)] * 2, out=pp)  # 2 + 4
    kv.barrier()
    weights, x, y = _data()
    half = slice(r * B // 2, (r + 1) * B // 2)
    on_kv = _train(mt, ctx, _mlp(mt, ctx, weights), x[half], y[half], kv)
    local = _train(mt, ctx, _mlp(mt, ctx, weights), x[half], y[half], "dist_sync",
                   update_on_kvstore=False)
    return {"rank": r, "workers": kv.num_workers, "type": kv.type,
            "init": init.asnumpy().tolist(), "pushed": pushed.asnumpy().tolist(),
            "pushpull": pp.asnumpy().tolist(), "on_kv": on_kv, "local": local,
            "modules": sorted(m for m in sys.modules
                              if m.split(".")[0] in ("jax", "jaxlib", "mxnet_tpu"))}


@pytest.fixture(scope="module")
def workers(tmp_path_factory):
    return _dist_util.launch_local(f"{MODULE}:rank_dist_sync", 2, device="cpu",
                                   timeout=120, pythonpath=[TESTS_DIR],
                                   workdir=str(tmp_path_factory.mktemp("kv")))


def test_dist_sync_sums_over_workers(workers):
    for w in workers:
        assert w["workers"] == 2 and w["type"] == "dist_sync" and not w["modules"]
        assert w["init"] == [7.0] * 3
        assert w["pushed"] == [3.0] * 3
        assert w["pushpull"] == [6.0] * 3


@pytest.mark.parametrize("mode", ["on_kv", "local"])
def test_dist_sync_trainer_matches_reference_on_whole_batch(mx, workers, mode):
    weights, x, y = _data()
    ref = _train(mx, mx.cpu(), _mlp(mx, mx.cpu(), weights), x, y, "device")
    for w in workers:
        for key, value in ref.items():
            np.testing.assert_allclose(np.array(w[mode][key]), value, rtol=TOL, atol=TOL,
                                       err_msg=key)
