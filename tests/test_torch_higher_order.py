"""Higher-order gradients and ``autograd.Function`` in the port, against
the reference package.

- Second order through ``_contrib_flash_attention`` (K1-K3's plain versions
  on the CPU; the reference's own CPU path): a gradient penalty
  ``grad(sum(o^2), q, create_graph=True)`` then ``sum(g^2).backward()``,
  plain and causal, every gradient within 1e-4 of its max of the
  reference's. The first-order path keeps its counts and its five saved
  tensors; the double backward counts once.
- The reference's ``tests/test_function_higher_order.py`` and
  ``tests/test_autograd.py:152-240`` cases, each run on both packages
  against its closed form (the reference's tolerances: 1e-5 or 1e-6
  relative), and the port's result within 1e-5 of the reference's.
- A third order through the flash kernels raises the reference's
  ``MXNetError``; so does a hybridized block's training pair under
  ``create_graph`` (on the card).
"""
import numpy as np
import pytest
import torch

import mxnet_tpu_torch as mt
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops.cuda import flash_attention as fa
from torch_threads import one_torch_thread  # noqa: F401

TOL_FLASH = 1e-4
TOL_PARITY = 1e-5


def _pkg(which):
    if which == "port":
        return mt, mt.cpu()
    import mxnet_tpu as mx
    return mx, mx.cpu()


def _flash_penalty(which, arrays, causal):
    mx, ctx = _pkg(which)
    q, k, v = (mx.nd.array(a, ctx=ctx) for a in arrays)
    for a in (q, k, v):
        a.attach_grad()
    with mx.autograd.record():
        o = mx.nd._contrib_flash_attention(q, k, v, causal=causal)
        g = mx.autograd.grad((o * o).sum(), q, create_graph=True)
        z = (g * g).sum()
    z.backward()
    return [o.asnumpy(), g.asnumpy()] + [a.grad.asnumpy() for a in (q, k, v)]


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_flash_attention_second_order_matches_reference(causal):
    rs = np.random.RandomState(3)
    arrays = [rs.randn(1, 2, 64, 16).astype(np.float32) for _ in range(3)]
    calls = (fa.FlashAttentionFunction.backward_calls,
             fa.FlashAttentionFunction.double_backward_calls)
    got = _flash_penalty("port", arrays, causal)
    # the grad under create_graph, and the chain through dO = 2 O in the
    # second backward; one double backward
    assert fa.FlashAttentionFunction.backward_calls - calls[0] == 2
    assert fa.FlashAttentionFunction.double_backward_calls - calls[1] == 1
    want = _flash_penalty("reference", arrays, causal)
    for name, g, w in zip(("o", "g", "dq", "dk", "dv"), got, want):
        err = np.abs(g - w).max() / np.abs(w).max()
        assert err <= TOL_FLASH, (name, err)


def test_flash_attention_first_order_path_unchanged():
    rs = np.random.RandomState(4)
    q, k, v = (torch.from_numpy(rs.randn(1, 2, 32, 16).astype(np.float32)).requires_grad_()
               for _ in range(3))
    o = fa.flash_attention(q, k, v)
    assert len(o.grad_fn.next_functions[0][0].saved_tensors) == 5
    calls = (fa.FlashAttentionFunction.backward_calls,
             fa.FlashAttentionFunction.double_backward_calls)
    o.sum().backward()
    assert fa.FlashAttentionFunction.backward_calls == calls[0] + 1
    assert fa.FlashAttentionFunction.double_backward_calls == calls[1]
    assert q.grad is not None and q.grad.grad_fn is None


def test_flash_attention_third_order_raises():
    x = mt.nd.array(np.random.RandomState(5).randn(1, 1, 16, 16).astype(np.float32),
                    ctx=mt.cpu())
    x.attach_grad()
    with mt.autograd.record():
        o = mt.nd._contrib_flash_attention(x, x, x)
        g = mt.autograd.grad((o * o).sum(), x, create_graph=True)
        with pytest.raises(MXNetError, match="no re-differentiable form"):
            mt.autograd.grad((g * g).sum(), x, create_graph=True)


# -- the reference's cases (test_function_higher_order.py) ------------------------------

def _sigmoid_cls(mx):
    class _Sigmoid(mx.autograd.Function):
        def forward(self, x):
            y = 1.0 / (1.0 + mx.nd.exp(-x))
            self.save_for_backward(y)
            return y

        def backward(self, dy):
            y, = self.saved_tensors
            return dy * y * (1.0 - y)
    return _Sigmoid


def case_second_order_through_function(mx, ctx):
    x = mx.nd.array([0.5, -1.0, 2.0, 0.0], ctx=ctx)
    x.attach_grad()
    with mx.autograd.record():
        z = _sigmoid_cls(mx)()(x).sum()
    g = mx.autograd.grad([z], [x], create_graph=True, retain_graph=True)[0]
    with mx.autograd.record():
        gs = g.sum()
    g2 = mx.autograd.grad([gs], [x])[0]
    s = 1.0 / (1.0 + np.exp(-x.asnumpy()))
    np.testing.assert_allclose(g.asnumpy(), s * (1 - s), rtol=1e-5)
    np.testing.assert_allclose(g2.asnumpy(), s * (1 - s) * (1 - 2 * s), rtol=1e-5)
    return [g.asnumpy(), g2.asnumpy()]


def case_second_order_multi_input_function(mx, ctx):
    class Mul2(mx.autograd.Function):
        def forward(self, a, b):
            self.save_for_backward(a, b)
            return a * b * b

        def backward(self, dy):
            a, b = self.saved_tensors
            return dy * b * b, dy * 2.0 * a * b

    a = mx.nd.array([2.0, 3.0], ctx=ctx)
    b = mx.nd.array([4.0, -1.0], ctx=ctx)
    a.attach_grad()
    b.attach_grad()
    with mx.autograd.record():
        z = Mul2()(a, b).sum()
    ga = mx.autograd.grad([z], [a], create_graph=True, retain_graph=True)[0]
    np.testing.assert_allclose(ga.asnumpy(), b.asnumpy() ** 2, rtol=1e-6)
    with mx.autograd.record():
        h = ga.sum()
    gb = mx.autograd.grad([h], [b])[0]
    np.testing.assert_allclose(gb.asnumpy(), 2.0 * b.asnumpy(), rtol=1e-6)
    return [ga.asnumpy(), gb.asnumpy()]


def case_function_composed_with_registered_ops(mx, ctx):
    x = mx.nd.array([0.3, -0.7, 1.2], ctx=ctx)
    x.attach_grad()
    with mx.autograd.record():
        z = _sigmoid_cls(mx)()(x * x).sum()
    g = mx.autograd.grad([z], [x], create_graph=True, retain_graph=True)[0]
    xs = x.asnumpy()
    s = 1.0 / (1.0 + np.exp(-xs ** 2))
    np.testing.assert_allclose(g.asnumpy(), 2 * xs * s * (1 - s), rtol=1e-5)
    with mx.autograd.record():
        gs = g.sum()
    g2 = mx.autograd.grad([gs], [x])[0]
    sp = s * (1 - s)
    np.testing.assert_allclose(g2.asnumpy(), 2 * sp + 4 * xs ** 2 * sp * (1 - 2 * s),
                               rtol=1e-5)
    return [g.asnumpy(), g2.asnumpy()]


def case_first_order_function_plain_backward(mx, ctx):
    x = mx.nd.array([1.0, -2.0], ctx=ctx)
    x.attach_grad()
    with mx.autograd.record():
        y = _sigmoid_cls(mx)()(x)
    y.backward()
    s = 1.0 / (1.0 + np.exp(-x.asnumpy()))
    np.testing.assert_allclose(x.grad.asnumpy(), s * (1 - s), rtol=1e-5)
    return [x.grad.asnumpy()]


def case_unrecordable_backward_has_no_second_order(mx, ctx):
    class NumpyBwd(mx.autograd.Function):
        def forward(self, x):
            self.save_for_backward(x)
            return x * x

        def backward(self, dy):
            x, = self.saved_tensors
            return mx.nd.array(2.0 * dy.asnumpy() * x.asnumpy(), ctx=ctx)

    x = mx.nd.array([3.0], ctx=ctx)
    x.attach_grad()
    with mx.autograd.record():
        z = NumpyBwd()(x).sum()
    g = mx.autograd.grad([z], [x], create_graph=True, retain_graph=True)[0]
    np.testing.assert_allclose(g.asnumpy(), [6.0], rtol=1e-6)
    with pytest.raises(mx.MXNetError):
        mx.autograd.grad([g], [x])
    return [g.asnumpy()]


# -- the reference's cases (test_autograd.py:152-240) ------------------------------------

def case_grad_create_graph_second_derivative(mx, ctx):
    x = mx.nd.array(np.asarray([1.0, 2.0, 3.0], "float32"), ctx=ctx)
    x.attach_grad()
    with mx.autograd.record():
        y = x * x * x
        gx = mx.autograd.grad(y, x, create_graph=True)
        z = (gx * gx).sum()
    z.backward()
    np.testing.assert_allclose(x.grad.asnumpy(), 36 * np.asarray([1.0, 8.0, 27.0]), rtol=1e-4)
    return [gx.asnumpy(), x.grad.asnumpy()]


def case_grad_create_graph_through_exp(mx, ctx):
    """The reference's ``np``/``exp`` case; the port has no ``np`` module
    (ROADMAP A9), so both packages take ``nd.exp``, the op ``np.exp`` is
    in the reference."""
    x = mx.nd.array([0.5, 1.0], ctx=ctx)
    x.attach_grad()
    with mx.autograd.record():
        y = mx.nd.exp(x)
        g = mx.autograd.grad(y, x, create_graph=True)
    g.backward()
    np.testing.assert_allclose(x.grad.asnumpy(), np.exp([0.5, 1.0]), rtol=1e-5)
    return [g.asnumpy(), x.grad.asnumpy()]


def case_grad_create_graph_through_custom_function(mx, ctx):
    class Square(mx.autograd.Function):
        def forward(self, x):
            self.save_for_backward(x)
            return x * x

        def backward(self, dy):
            (x,) = self.saved_tensors
            return dy * 2.0 * x

    x = mx.nd.array(np.asarray([2.0], "float32"), ctx=ctx)
    x.attach_grad()
    with mx.autograd.record():
        y = Square()(x)
    g = mx.autograd.grad([y], [x], create_graph=True, retain_graph=True)[0]
    np.testing.assert_allclose(g.asnumpy(), [4.0])
    with mx.autograd.record():
        gs = g.sum()
    g2 = mx.autograd.grad([gs], [x])[0]
    np.testing.assert_allclose(g2.asnumpy(), [2.0])
    return [g.asnumpy(), g2.asnumpy()]


def case_create_graph_immune_to_inplace_mutation(mx, ctx):
    x = mx.nd.array(np.asarray([1.0, 2.0, 3.0], "float32"), ctx=ctx)
    x.attach_grad()
    with mx.autograd.record():
        y = x * x * x
        x += 100.0
        gx = mx.autograd.grad(y, x, create_graph=True)
    np.testing.assert_allclose(gx.asnumpy(), 3 * np.asarray([1.0, 4.0, 9.0]), rtol=1e-5)
    return [gx.asnumpy(), x.asnumpy()]


def case_grad_single_head_grads_ndarray(mx, ctx):
    x = mx.nd.array(np.asarray([1.0, 2.0], "float32"), ctx=ctx)
    x.attach_grad()
    with mx.autograd.record():
        y = x * x
    g = mx.autograd.grad(y, x, head_grads=mx.nd.array(np.asarray([1.0, 1.0], "float32"),
                                                      ctx=ctx))
    np.testing.assert_allclose(g.asnumpy(), [2.0, 4.0], rtol=1e-6)
    return [g.asnumpy()]


def case_create_graph_through_slicing(mx, ctx):
    x = mx.nd.array(np.asarray([1.0, 2.0, 3.0, 4.0], "float32"), ctx=ctx)
    x.attach_grad()
    with mx.autograd.record():
        y = (x[1:3] ** 2).sum()
        g = mx.autograd.grad(y, x, create_graph=True)
        z = (g * g).sum()
    z.backward()
    np.testing.assert_allclose(x.grad.asnumpy(), [0.0, 16.0, 24.0, 0.0], rtol=1e-5)
    return [g.asnumpy(), x.grad.asnumpy()]


CASES = {name[len("case_"):]: fn for name, fn in sorted(globals().items())
         if name.startswith("case_")}


@pytest.mark.parametrize("case", sorted(CASES))
def test_reference_case_in_both_packages(case):
    got = CASES[case](*_pkg("port"))
    want = CASES[case](*_pkg("reference"))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=TOL_PARITY, atol=TOL_PARITY)


def test_function_not_recording_is_a_plain_call():
    Sig = _sigmoid_cls(mt)
    x = mt.nd.array([0.0, 1.0], ctx=mt.cpu())
    y = Sig()(x)
    assert y._data.grad_fn is None
    np.testing.assert_allclose(y.asnumpy(), 1 / (1 + np.exp(-x.asnumpy())), rtol=1e-6)


@pytest.mark.gpu
def test_hybridized_pair_refuses_create_graph_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run on the card")
    ctx = mt.gpu(0)
    net = mt.gluon.nn.Dense(4, in_units=3)
    net.initialize(ctx=ctx)
    net.hybridize()
    x = mt.nd.array(np.ones((2, 3), np.float32), ctx=ctx)
    x.attach_grad()
    for _ in range(2):                  # an eager call with a backward warms the pair
        with mt.autograd.record():
            y = net(x)
        y.backward()
    with mt.autograd.record():
        y = net(x)
        head = (y * y).sum()
    assert net._cached_graphs and next(iter(net._cached_graphs.values())).eager is None
    with pytest.raises(MXNetError, match="hybridized-block forwards"):
        mt.autograd.grad(head, x, create_graph=True)
