"""LeNet and MLP (``models.lenet``, ``models.mlp``) against the reference's
(``mxnet_tpu/models/lenet.py``, ``mlp.py``), and the ``train_mnist`` loop of
``examples/train_mnist.py`` at a small size in both packages.

Weights come from ``convert.seeded_params`` as numpy and load into both
nets by structural path; inputs are numpy from a seed (and the synthetic
MNIST of ``gluon.data.vision.MNIST``, equal in both packages).

Tolerances: the forward 1e-5 of the output's max; every gradient 1e-4 of
its tensor's max (f32 convolutions and products summed in another order);
the 10-step loss trajectory of ``gluon.Trainer`` (SGD, momentum 0.9) 1e-5
relative at each step; the accuracy ``metric`` over the run equal. The port
runs each net hybridized (the CPU runs the eager forward); the reference
hybridized as well.
"""
import numpy as np
import pytest

import mxnet_tpu_torch as mt
import mxnet_tpu_torch.models  # noqa: F401  (mt.models)
from mxnet_tpu_torch.convert import load_jax_params, seeded_params
from mxnet_tpu_torch.gluon.data.vision import transforms as T
from torch_threads import one_torch_thread  # noqa: F401

TOL_OUT = 1e-5
TOL_GRAD = 1e-4
TOL_LOSS = 1e-5


@pytest.fixture(scope="module")
def ref():
    import mxnet_tpu as mx
    import mxnet_tpu.models  # noqa: F401
    return mx


def _inputs(kind, n=4, seed=0):
    rs = np.random.RandomState(seed)
    shape = (n, 1, 28, 28) if kind == "lenet" else (n, 20)
    return rs.uniform(0, 1, shape).astype(np.float32), rs.randint(0, 10, n).astype(np.float32)


def _pair(ref, kind, x):
    """The port's and the reference's net with the same seeded weights."""
    make = {"lenet": lambda m: m.lenet(), "mlp": lambda m: m.mlp(hidden=(32, 16))}[kind]
    port = make(mt.models)
    port.initialize(ctx=mt.cpu())
    port(mt.nd.array(x, ctx=mt.cpu()))            # deferred shapes
    weights = seeded_params(port, seed=1)
    load_jax_params(port, weights)
    refnet = make(ref.models)
    refnet.initialize(ctx=ref.cpu())
    refnet(ref.nd.array(x))
    params = refnet._collect_params_with_prefix()
    assert sorted(params) == sorted(weights)
    for k, p in params.items():
        p.set_data(ref.nd.array(weights[k]))
    port.hybridize()
    refnet.hybridize()
    return port, refnet


def _max_rel(got, want):
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize("kind", ["lenet", "mlp"])
def test_forward_and_gradients_match_reference(ref, kind):
    x, y = _inputs(kind)
    port, refnet = _pair(ref, kind, x)
    outs, grads = [], []
    for pkg, net, ctx in ((mt, port, mt.cpu()), (ref, refnet, ref.cpu())):
        loss = pkg.gluon.loss.SoftmaxCrossEntropyLoss()
        xx = pkg.nd.array(x, ctx=ctx)
        xx.attach_grad()
        with pkg.autograd.record():
            out = net(xx)
            L = loss(out, pkg.nd.array(y, ctx=ctx))
        L.backward()
        outs.append(out.asnumpy())
        grads.append({k: p.grad().asnumpy() for k, p in net._collect_params_with_prefix().items()}
                     | {"input": xx.grad.asnumpy()})
    assert _max_rel(*outs) <= TOL_OUT
    for k in grads[1]:
        assert _max_rel(grads[0][k], grads[1][k]) <= TOL_GRAD, k


def test_exports_match_reference(ref):
    for name in ("LeNet", "lenet", "MLP", "mlp"):
        assert hasattr(mt.models, name) and hasattr(ref.models, name)
    assert mt.models.lenet(classes=7).output._units == 7


def _train(pkg, net, steps=10):
    """The train_mnist loop on the synthetic MNIST: ArrayDataset + DataLoader
    batches of 16 (shuffled), SGD momentum 0.9, lr 0.05, Accuracy."""
    ds = pkg.gluon.data.vision.MNIST(root="/nonexistent-mnist-root", train=True,
                                     synthetic_size=160)
    tf = (T if pkg is mt else pkg.gluon.data.vision.transforms).ToTensor()
    images = np.stack([tf(ds[i][0]) for i in range(len(ds))])
    labels = np.array([ds[i][1] for i in range(len(ds))], np.float32)
    loader = pkg.gluon.data.DataLoader(pkg.gluon.data.ArrayDataset(images, labels),
                                       batch_size=16, shuffle=True, last_batch="discard")
    loss_fn = pkg.gluon.loss.SoftmaxCrossEntropyLoss()
    loss_fn.hybridize()
    trainer = pkg.gluon.Trainer(net.collect_params(), "sgd",
                                {"learning_rate": 0.05, "momentum": 0.9})
    acc = pkg.metric.Accuracy()
    losses = []
    np.random.seed(12)
    for x, y in loader:
        if len(losses) == steps:
            break
        with pkg.autograd.record():
            out = net(x)
            L = loss_fn(out, y)
        L.backward()
        trainer.step(x.shape[0])
        acc.update(y, out)
        losses.append(float(L.mean().asscalar()))
    return losses, acc.get()


def test_train_mnist_trajectory_matches_reference(ref):
    x, _ = _inputs("lenet")
    port, refnet = _pair(ref, "lenet", x)
    with mt.cpu():
        got, got_acc = _train(mt, port)
    want, want_acc = _train(ref, refnet)
    assert len(got) == len(want) == 10
    np.testing.assert_allclose(got, want, rtol=TOL_LOSS)
    assert got_acc == want_acc
    assert got[-1] < got[0]
