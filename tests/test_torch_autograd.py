"""The port's autograd against the reference's, on the same numpy inputs.

Mirrors the cases of ``tests/test_autograd.py:10-100`` (scopes, backward
with and without head gradients, ``grad``, ``mark_variables``, ``detach``,
``grad_req`` write/add) and adds the MXNet buffer semantics that torch's
``.grad`` does not have: ``"write"`` overwrites the buffer at each backward,
``"add"`` accumulates, and a variable the heads do not reach keeps its buffer
unchanged. Each case runs the same function of ``(package, arrays)`` in
both packages and compares the buffers.

Tolerance 1e-6, f32 on the CPU: the same elementwise formulas, reductions
over at most 12 elements.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu_torch as mt
from mxnet_tpu_torch.base import MXNetError
from torch_threads import one_torch_thread  # noqa: F401

TOL = 1e-6


@pytest.fixture(scope="module")
def ref():
    import mxnet_tpu as mx
    return mx


def _pkgs(ref):
    return ((mt, mt.cpu()), (ref, ref.cpu()))


def _both(ref, fn, *arrays):
    """``fn(pkg, *nd_arrays)`` in each package -> list of numpy results."""
    outs = []
    for pkg, ctx in _pkgs(ref):
        res = fn(pkg, *(pkg.nd.array(a, ctx=ctx) for a in arrays))
        outs.append([r.asnumpy() if hasattr(r, "asnumpy") else np.asarray(r)
                     for r in res])
    return outs


def _assert_same(outs):
    got, expect = outs
    assert len(got) == len(expect)
    for g, e in zip(got, expect):
        np.testing.assert_allclose(g, e, rtol=TOL, atol=TOL)


_rs = np.random.RandomState(0)
X = _rs.rand(3, 4).astype(np.float32)
W = _rs.rand(4).astype(np.float32)
V = np.array([1.0, 2.0, 3.0], np.float32)


def test_basic_grad(ref):
    def fn(pkg, x):
        x.attach_grad()
        with pkg.autograd.record():
            y = (x * x).sum()
        y.backward()
        return [x.grad]
    _assert_same(_both(ref, fn, V))


def test_chain_and_broadcast(ref):
    def fn(pkg, x, w):
        x.attach_grad()
        w.attach_grad()
        with pkg.autograd.record():
            y = (x * w).sum()
        y.backward()
        return [x.grad, w.grad]
    _assert_same(_both(ref, fn, X, W))


def test_recording_scopes_and_flags():
    ag = mt.autograd
    assert not ag.is_recording() and not ag.is_training()
    with ag.record():
        assert ag.is_recording() and ag.is_training()
        with ag.pause():
            assert not ag.is_recording() and not ag.is_training()
        with ag.pause(train_mode=True):
            assert ag.is_training()
        with ag.predict_mode():
            assert not ag.is_training()
    with ag.record(train_mode=False):
        assert ag.is_recording() and not ag.is_training()
    with ag.train_mode():
        assert ag.is_training() and not ag.is_recording()
    assert not ag.is_recording()
    assert ag.set_recording(True) is False
    assert ag.set_training(True) is False
    assert ag.is_recording() and ag.is_training()
    assert ag.set_recording(False) is True and ag.set_training(False) is True


def test_ops_outside_record_and_under_pause_are_not_recorded():
    x = mt.nd.array(V, ctx=mt.cpu())
    x.attach_grad()
    y = x * 2                          # not recorded
    with pytest.raises(MXNetError, match="recorded graph"):
        y.backward()
    with mt.autograd.record():
        with mt.autograd.pause():
            z = x * 3
    assert not z._data.requires_grad


def test_head_gradient(ref):
    def fn(pkg, x, hg):
        x.attach_grad()
        with pkg.autograd.record():
            y = x * 3
        y.backward(hg)
        return [x.grad]
    _assert_same(_both(ref, fn, V, np.array([10.0, 100.0, 1000.0], np.float32)))


def test_multiple_heads_with_and_without_head_grads(ref):
    def fn(pkg, x, w):
        x.attach_grad()
        w.attach_grad()
        with pkg.autograd.record():
            a = (x * w).sum()
            b = x * x
        pkg.autograd.backward([a, b], [None, pkg.nd.array(np.full((3, 4), 0.5, np.float32),
                                                          ctx=x.ctx)])
        return [x.grad, w.grad]
    _assert_same(_both(ref, fn, X, W))


def test_grad_write_overwrites_and_add_accumulates(ref):
    def fn(pkg, x, y):
        x.attach_grad()                    # write
        y.attach_grad(grad_req="add")
        out = []
        for scale in (1.0, 3.0):
            with pkg.autograd.record():
                z = (x * x * scale).sum() + (y * x).sum()
            z.backward()
            out += [x.grad.asnumpy(), y.grad.asnumpy()]
        return out
    _assert_same(_both(ref, fn, V, V + 1))


def test_unreached_variable_keeps_its_buffer(ref):
    def fn(pkg, x, w):
        x.attach_grad()
        w.attach_grad()
        with pkg.autograd.record():
            y = (x * w).sum()
        y.backward()
        first = w.grad.asnumpy()
        with pkg.autograd.record():
            z = (x * x).sum()              # w is not on this graph
        z.backward()
        return [x.grad, w.grad, first]
    got, expect = _both(ref, fn, X, W)
    _assert_same((got, expect))
    np.testing.assert_array_equal(got[1], got[2])


def test_detach_blocks_grad(ref):
    def fn(pkg, x):
        x.attach_grad()
        with pkg.autograd.record():
            y = x * x
            z = y.detach()
            w = z * x
        w.backward()
        return [x.grad]
    _assert_same(_both(ref, fn, np.array([2.0, -1.5], np.float32)))


def test_autograd_grad_api(ref):
    def fn(pkg, x, w):
        x.attach_grad()
        w.attach_grad()
        with pkg.autograd.record():
            y = (x * x * x * w).sum()
        gx, gw = pkg.autograd.grad([y], [x, w])
        return [gx, gw, x.grad]            # grad() writes no buffer
    _assert_same(_both(ref, fn, X, W))


def test_grad_of_unreached_variable_raises():
    x, w = (mt.nd.array(a, ctx=mt.cpu()) for a in (V, V))
    x.attach_grad()
    w.attach_grad()
    with mt.autograd.record():
        y = (x * x).sum()
    with pytest.raises(MXNetError, match="does not receive gradient"):
        mt.autograd.grad(y, [w])
    with pytest.raises(MXNetError, match="does not receive gradient"):
        mt.autograd.grad(y, [w], create_graph=True)


def test_mark_variables(ref):
    def fn(pkg, x, g):
        pkg.autograd.mark_variables([x], [g])
        with pkg.autograd.record():
            y = (x * 5).sum()
        y.backward()
        return [x.grad, g]                 # the given buffer is the one written
    _assert_same(_both(ref, fn, np.ones(2, np.float32), np.zeros(2, np.float32)))


def test_mark_variables_add_req(ref):
    def fn(pkg, x, g):
        pkg.autograd.mark_variables([x], [g], grad_reqs="add")
        for _ in range(3):
            with pkg.autograd.record():
                y = (x * x).sum()
            y.backward()
        return [x.grad]
    _assert_same(_both(ref, fn, V, np.full(3, 0.5, np.float32)))


def test_retain_graph(ref):
    def fn(pkg, x):
        x.attach_grad(grad_req="add")
        with pkg.autograd.record():
            y = (x * x).sum()
        y.backward(retain_graph=True)
        y.backward()
        return [x.grad]
    _assert_same(_both(ref, fn, V))


def test_parameter_grad_buffers(ref):
    """Gluon parameters: buffer at initialize, write, zero_grad, grad_req."""
    def fn(pkg, x, w):
        net = pkg.gluon.nn.Dense(2, in_units=3, use_bias=True)
        net.initialize(ctx=x.ctx)
        net.weight.set_data(w)
        before = net.weight.grad().asnumpy()
        with pkg.autograd.record():
            y = net(x).sum()
        y.backward()
        got = [before, net.weight.grad().asnumpy(), net.bias.grad().asnumpy()]
        net.collect_params().zero_grad()
        got.append(net.weight.grad().asnumpy())
        net.bias.grad_req = "add"
        for _ in range(2):
            with pkg.autograd.record():
                y = net(x).sum()
            y.backward()
        got += [net.bias.grad().asnumpy(), net.weight.grad().asnumpy()]
        return got
    _assert_same(_both(ref, fn, X[:, :3], X[:2, :3]))


def test_invoke_runs_non_differentiable_ops_without_grad():
    w, g, m = (mt.nd.array(a, ctx=mt.cpu()) for a in (V, V, V))
    w.attach_grad()
    with mt.autograd.record():
        out = mt.nd.sgd_update(w, g, lr=0.1)
        y = w * 2
    assert not out._data.requires_grad
    assert y._data.requires_grad
    assert isinstance(y._data.grad_fn, torch.autograd.graph.Node)
