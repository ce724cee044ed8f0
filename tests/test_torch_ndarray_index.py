"""NDArray indexing, writes and the op-backed methods of the port, against
numpy and the reference package.

- ``x[key]`` over the reference's index matrix (``tests/test_ndarray_depth.py``:
  ints, slices with negative steps, ``None``, ``...``, tuples, NDArray
  indices) and ``x[key] = value`` (scalars, arrays, broadcast values)
  equal numpy's and the reference's, bitwise; an int out of range raises
  ``IndexError``, so iteration ends; a slice is a copy, not a view.
- ``version``, ``T``, ``item``, ``copy``, ``copyto``, ``float``/``int``,
  ``/=``, ``**``, ``%``, ``abs()`` and the op-backed methods (``take``,
  ``slice_axis``, ``one_hot``, ``clip``, ``topk``, ``sort``, ``argsort``,
  ``tile``, ``repeat``, ``flip``, ``split``, ``broadcast_to``, the
  reductions...) match the reference at 1e-6 (f32 on the CPU).
- The creation functions and ``nd.maximum``/``minimum``/``zeros_like``/
  ``ones_like`` match the reference.
- The in-place trap, both halves: a write into a variable after a recorded
  op leaves the recorded graph its old value (first order, second order
  and ``x[key] = v``), as the reference's functional ``_set_data`` does;
  and the write goes into the tensor's own storage, which the fused step
  reads: a ``DataParallelTrainer`` step after ``+=`` on a parameter equals
  a step from weights set to the same values (eager on the CPU; captured
  against eager, bitwise, on the card).
"""
import numpy as np
import pytest
import torch

import mxnet_tpu_torch as mt
from mxnet_tpu_torch.base import MXNetError
from torch_threads import one_torch_thread  # noqa: F401

TOL = 1e-6

INDEXES = [
    0, 2, -1, -3,
    slice(None), slice(1, 3), slice(None, None, 2), slice(3, None, -1),
    slice(-2, None), slice(None, -1), slice(None, None, -2),
    (1, 2), (slice(1, 3), slice(2, 4)), (slice(None), 1),
    (0, slice(None, None, 2)), (-1, -1),
    (slice(None, None, -1), slice(None)), (slice(None, None, -1), slice(4, 0, -2)),
    (None, slice(1, 3)), (slice(1, 3), None),
    (Ellipsis, 1), (1, Ellipsis), (Ellipsis, slice(None, None, -1)),
]

SETITEMS = [
    (0, 7.0),
    (slice(1, 3), -1.0),
    ((slice(None), 2), 9.0),
    ((2, 3), 4.5),
    (slice(None, None, 2), 0.25),
    (slice(None, None, -2), 3.0),
    ((1, slice(None)), np.arange(5, dtype=np.float32)),
    (slice(None), 2.0),
]


@pytest.fixture(scope="module")
def ref():
    import mxnet_tpu as mx
    return mx


def _src():
    return np.arange(20, dtype=np.float32).reshape(4, 5)


@pytest.mark.parametrize("idx", INDEXES, ids=[str(i) for i in INDEXES])
def test_getitem_matches_numpy_and_reference(ref, idx):
    src = _src()
    got = mt.nd.array(src, ctx=mt.cpu())[idx]
    want = ref.nd.array(src, ctx=ref.cpu())[idx]
    assert got.shape == src[idx].shape == tuple(want.shape)
    np.testing.assert_array_equal(got.asnumpy(), src[idx])
    np.testing.assert_array_equal(got.asnumpy(), want.asnumpy())


@pytest.mark.parametrize("dtype", ["int32", "float32"])
def test_getitem_with_an_ndarray_index(ref, dtype):
    src = _src()
    sel = np.array([0, 2, 3])
    got = mt.nd.array(src, ctx=mt.cpu())[mt.nd.array(sel, ctx=mt.cpu(), dtype=dtype)]
    want = ref.nd.array(src, ctx=ref.cpu())[ref.nd.array(sel, ctx=ref.cpu(), dtype="int32")]
    np.testing.assert_array_equal(got.asnumpy(), want.asnumpy())
    np.testing.assert_array_equal(got.asnumpy(), src[sel])
    two = mt.nd.array(src, ctx=mt.cpu())[mt.nd.array([1, 3], ctx=mt.cpu(), dtype="int32"), 2]
    np.testing.assert_array_equal(two.asnumpy(), src[[1, 3], 2])


@pytest.mark.parametrize("idx,val", SETITEMS, ids=[str(i) for i, _ in SETITEMS])
def test_setitem_matches_numpy_and_reference(ref, idx, val):
    src = _src()
    want_np = src.copy()
    want_np[idx] = val
    arr = mt.nd.array(src, ctx=mt.cpu())
    v0 = arr.version
    arr[idx] = val if not isinstance(val, np.ndarray) else mt.nd.array(val, ctx=mt.cpu())
    r = ref.nd.array(src, ctx=ref.cpu())
    r[idx] = val if not isinstance(val, np.ndarray) else ref.nd.array(val, ctx=ref.cpu())
    np.testing.assert_array_equal(arr.asnumpy(), want_np)
    np.testing.assert_array_equal(arr.asnumpy(), r.asnumpy())
    assert arr.version > v0


def test_setitem_broadcast_and_dtype():
    arr = mt.nd.array(_src(), ctx=mt.cpu())
    arr[1:3] = mt.nd.array(np.arange(5, dtype=np.float32), ctx=mt.cpu())
    arr[3] = np.float64(1.5)
    ints = mt.nd.array(np.zeros((2, 3), np.int32), ctx=mt.cpu())
    ints[:, 1] = mt.nd.array(np.array([2.7, -1.2], np.float32), ctx=mt.cpu())
    want = _src()
    want[1:3] = np.arange(5)
    want[3] = 1.5
    np.testing.assert_array_equal(arr.asnumpy(), want)
    np.testing.assert_array_equal(ints.asnumpy(), [[0, 2, 0], [0, -1, 0]])
    assert ints.dtype == torch.int32


def test_iteration_ends_and_index_errors():
    src = np.arange(6, dtype=np.float32).reshape(3, 2)
    arr = mt.nd.array(src, ctx=mt.cpu())
    rows = [r.asnumpy() for r in arr]
    np.testing.assert_array_equal(np.stack(rows), src)
    for bad in (3, -4):
        with pytest.raises(IndexError):
            arr[bad]


def test_slices_are_copies_and_writes_are_in_place():
    arr = mt.nd.array(_src(), ctx=mt.cpu())
    row, view = arr[1], arr[1:3]
    ptr = arr._data.data_ptr()
    arr[1] = 0.0
    arr += 1.0
    assert arr._data.data_ptr() == ptr
    np.testing.assert_array_equal(row.asnumpy(), _src()[1])
    np.testing.assert_array_equal(view.asnumpy(), _src()[1:3])
    c = arr.copy()
    arr[0] = -5.0
    assert c.asnumpy()[0, 0] == 1.0 and c._data.data_ptr() != arr._data.data_ptr()


METHODS = {
    "T": lambda x: x.T,
    "itruediv": lambda x: _itruediv(x),
    "pow": lambda x: abs(x) ** 1.5, "rpow": lambda x: 2.0 ** x,
    "pow-arr": lambda x: abs(x) ** (x * 0 + 2),
    "mod": lambda x: x % 1.5, "rmod": lambda x: 7.0 % (abs(x) + 1),
    "mod-arr": lambda x: x % (abs(x) + 0.5), "abs": lambda x: abs(x),
    "take": lambda x: x.take(_idx(x, [2, 0, 9]), axis=1),
    "slice_axis": lambda x: x.slice_axis(axis=2, begin=1, end=-1),
    "slice": lambda x: x.slice((0, 1), (2, 3)),
    "one_hot": lambda x: (abs(x) * 2).astype("int32").reshape(-1).one_hot(5),
    "clip": lambda x: x.clip(-0.5, 0.5),
    "topk": lambda x: x.topk(axis=-1, k=2),
    "topk-both": lambda x: x.topk(axis=1, k=2, ret_typ="both")[0],
    "sort": lambda x: x.sort(axis=1, is_ascend=False),
    "argsort": lambda x: x.argsort(),
    "tile": lambda x: x.tile((1, 2, 1)),
    "repeat": lambda x: x.repeat(2, axis=0),
    "flip": lambda x: x.flip(axis=2),
    "split": lambda x: x.split(num_outputs=2, axis=2)[1],
    "broadcast_to": lambda x: x[:, :1].broadcast_to((2, 3, 4)),
    "squeeze": lambda x: x[:, :1].squeeze(axis=1),
    "prod": lambda x: (x * 0.5 + 1).prod(axis=1), "max": lambda x: x.max(axis=(0, 2)),
    "min": lambda x: x.min(), "argmax": lambda x: x.argmax(axis=1),
    "argmin": lambda x: x.argmin(axis=2, keepdims=True),
    "norm": lambda x: x.norm(axis=1), "mean": lambda x: x.mean(axis=0),
    "dot": lambda x: x.reshape((6, 4)).dot(x.reshape((6, 4)), transpose_b=True),
    "zeros_like": lambda x: x.zeros_like(), "ones_like": lambda x: x.ones_like(),
    "sign": lambda x: x.sign(), "sqrt": lambda x: abs(x).sqrt(), "round": lambda x: x.round(),
    "floor": lambda x: x.floor(), "ceil": lambda x: x.ceil(), "sigmoid": lambda x: x.sigmoid(),
    "tanh": lambda x: x.tanh(), "swapaxes": lambda x: x.swapaxes(0, 2),
    "flatten": lambda x: x.flatten(), "reshape_like": lambda x: x.reshape_like(x.T),
}


def _itruediv(x):
    y = x.copy()
    y /= 4.0
    return y


def _idx(x, values):
    return type(x)(x._data.new_tensor(values)) if isinstance(x, mt.nd.NDArray) \
        else __import__("mxnet_tpu").nd.array(values, ctx=x.ctx)


@pytest.mark.parametrize("name", list(METHODS), ids=list(METHODS))
def test_methods_match_reference(ref, name):
    x = np.random.RandomState(2).randn(2, 3, 4).astype(np.float32)
    got = METHODS[name](mt.nd.array(x, ctx=mt.cpu()))
    want = METHODS[name](ref.nd.array(x, ctx=ref.cpu()))
    g, w = got.asnumpy(), np.asarray(want.asnumpy())
    assert g.shape == w.shape and g.dtype == w.dtype, (g.dtype, w.dtype)
    np.testing.assert_allclose(g, w, rtol=TOL, atol=TOL)


def test_scalar_protocols(ref):
    x = mt.nd.array(np.array([1.5], np.float32), ctx=mt.cpu())
    assert float(x) == 1.5 and int(x) == 1 and x.item() == 1.5
    assert x.tolist() == [1.5]
    np.testing.assert_array_equal(np.asarray(x), [1.5])
    with pytest.raises(MXNetError):
        bool(mt.nd.zeros((2, 2), ctx=mt.cpu()))


def test_copyto_casts_and_counts(ref):
    x = mt.nd.array(np.arange(6, dtype=np.float32).reshape(2, 3), ctx=mt.cpu())
    dst = mt.nd.zeros((2, 3), ctx=mt.cpu(), dtype="float16")
    v = dst.version
    assert x.copyto(dst) is dst and dst.version > v
    assert dst.dtype == torch.float16
    np.testing.assert_array_equal(dst.asnumpy(), x.asnumpy())
    other = x.copyto(mt.cpu())
    assert other is not x and other._data.data_ptr() != x._data.data_ptr()
    with pytest.raises(MXNetError):
        x.copyto(mt.nd.zeros((3, 2), ctx=mt.cpu()))


def test_creation_functions_match_reference(ref):
    cpu, rcpu = mt.cpu(), ref.cpu()
    pairs = [
        (mt.nd.ones((2, 3), ctx=cpu), ref.nd.ones((2, 3), ctx=rcpu)),
        (mt.nd.full((2,), 3.5, ctx=cpu), ref.nd.full((2,), 3.5, ctx=rcpu)),
        (mt.nd.full(3, 2, ctx=cpu, dtype="int32"), ref.nd.full(3, 2, ctx=rcpu, dtype="int32")),
        (mt.nd.empty((2, 2), ctx=cpu), ref.nd.empty((2, 2), ctx=rcpu)),
        (mt.nd.eye(3, ctx=cpu), ref.nd.eye(3, ctx=rcpu)),
        (mt.nd.eye(3, 4, k=1, ctx=cpu), ref.nd.eye(3, 4, k=1, ctx=rcpu)),
        (mt.nd.eye(4, 3, k=-2, ctx=cpu), ref.nd.eye(4, 3, k=-2, ctx=rcpu)),
        (mt.nd.linspace(0, 1, 5, ctx=cpu), ref.nd.linspace(0, 1, 5, ctx=rcpu)),
        (mt.nd.linspace(-1, 2, 4, endpoint=False, ctx=cpu),
         ref.nd.linspace(-1, 2, 4, endpoint=False, ctx=rcpu)),
        (mt.nd.from_numpy(np.arange(4, dtype=np.float32), ctx=cpu),
         ref.nd.from_numpy(np.arange(4, dtype=np.float32), ctx=rcpu)),
    ]
    a, b = np.arange(6, dtype=np.float32).reshape(2, 3), -np.arange(6, dtype=np.float32).reshape(2, 3)
    pa, pb = mt.nd.array(a, ctx=cpu), mt.nd.array(b, ctx=cpu)
    ra, rb = ref.nd.array(a, ctx=rcpu), ref.nd.array(b, ctx=rcpu)
    pairs += [(mt.nd.concat(pa, pb, dim=0), ref.nd.concat(ra, rb, dim=0)),
              (mt.nd.stack(pa, pb, axis=2), ref.nd.stack(ra, rb, axis=2)),
              (mt.nd.maximum(pa, pb), ref.nd.maximum(ra, rb)),
              (mt.nd.minimum(pa, 2.5), ref.nd.minimum(ra, 2.5)),
              (mt.nd.maximum(1.0, pb), ref.nd.maximum(1.0, rb)),
              (mt.nd.zeros_like(pa), ref.nd.zeros_like(ra)),
              (mt.nd.ones_like(pb), ref.nd.ones_like(rb))]
    for got, want in pairs:
        g, w = got.asnumpy(), np.asarray(want.asnumpy())
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)
    assert mt.nd.maximum(2, 3) == 3


# -- the in-place trap ----------------------------------------------------------------------

def test_write_after_record_keeps_the_recorded_values():
    """First order: y = x^3 recorded, then x += 100 and x[0] = -1; the
    gradient is 3 x^2 at the recorded x (the reference's functional
    payloads), while x holds the new values in its own storage."""
    x = mt.nd.array(np.array([1.0, 2.0, 3.0], np.float32), ctx=mt.cpu())
    x.attach_grad()
    ptr = x._data.data_ptr()
    with mt.autograd.record():
        y = x * x * x
        x += 100.0
        x[0] = -1.0
    y.backward()
    np.testing.assert_allclose(x.grad.asnumpy(), [3.0, 12.0, 27.0], rtol=1e-6)
    np.testing.assert_array_equal(x.asnumpy(), [-1.0, 102.0, 103.0])
    assert x._data.data_ptr() == ptr


def test_write_after_record_second_order_reaches_the_variable():
    x = mt.nd.array(np.array([1.0, 2.0], np.float32), ctx=mt.cpu())
    x.attach_grad()
    with mt.autograd.record():
        y = (x * x * x).sum()
        x *= 10.0
        g = mt.autograd.grad(y, x, create_graph=True)       # 3 x^2 at x = (1, 2)
        z = (g * g).sum()                                   # d/dx = 36 x^3
    z.backward()
    np.testing.assert_allclose(g.asnumpy(), [3.0, 12.0], rtol=1e-6)
    np.testing.assert_allclose(x.grad.asnumpy(), [36.0, 288.0], rtol=1e-6)


def test_write_into_a_constant_after_record():
    c = mt.nd.array(np.array([2.0, 3.0], np.float32), ctx=mt.cpu())
    x = mt.nd.array(np.array([1.0, 1.0], np.float32), ctx=mt.cpu())
    x.attach_grad()
    with mt.autograd.record():
        y = (x * c).sum()
    c[:] = 0.0
    y.backward()
    np.testing.assert_array_equal(x.grad.asnumpy(), [2.0, 3.0])


def test_write_into_a_recorded_result_swaps_it():
    x = mt.nd.array(np.array([1.0, 2.0], np.float32), ctx=mt.cpu())
    x.attach_grad()
    with mt.autograd.record():
        h = x * 3.0
        z = (h * h).sum()
        h += 1.0                       # the recorded h stays 3x
        w = (h * x).sum()              # the new h = 3x + 1: dw/dx = 6x + 1
    z.backward(retain_graph=True)
    np.testing.assert_allclose(x.grad.asnumpy(), [18.0, 36.0], rtol=1e-6)
    w.backward()
    np.testing.assert_allclose(x.grad.asnumpy(), [7.0, 13.0], rtol=1e-6)


def _dp_mlp(ctx, seed):
    from mxnet_tpu_torch.convert import load_jax_params, seeded_params
    net = mt.gluon.nn.HybridSequential()
    net.add(mt.gluon.nn.Dense(16, in_units=8, activation="relu"),
            mt.gluon.nn.Dense(4, in_units=16))
    net.initialize(ctx=ctx)
    load_jax_params(net, seeded_params(net, seed))
    return net


def _dp_run(ctx, bump, captured=True):
    """Two fused steps, ``+= 0.5`` on the first weight in place (``bump``)
    or the same values through ``set_data`` from a fresh net, two more
    steps: the losses and the weights."""
    from mxnet_tpu_torch.parallel import DataParallelTrainer, make_mesh
    net = _dp_mlp(ctx, 3)
    tr = DataParallelTrainer(net, mt.gluon.loss.SoftmaxCrossEntropyLoss(), "adam",
                             {"learning_rate": 1e-2}, mesh=make_mesh({"dp": 1}, devices=[ctx]))
    if not captured:
        tr._graph_reason = "eager yardstick"
    rs = np.random.RandomState(4)
    x = mt.nd.array(rs.randn(8, 8).astype(np.float32), ctx=ctx)
    y = mt.nd.array(np.arange(8) % 4, ctx=ctx, dtype="int32")
    losses = [float(tr.step(x, y)) for _ in range(3)]
    p = net._collect_params_with_prefix()["0.weight"]
    ptr = p._param.data_ptr()
    if bump:
        w = p.data()
        w += 0.5
    else:
        p.set_data(p.data().asnumpy() + 0.5)
    assert p._param.data_ptr() == ptr
    losses += [float(tr.step(x, y)) for _ in range(3)]
    return losses, {k: q.data().asnumpy() for k, q in net._collect_params_with_prefix().items()}


def test_inplace_on_a_parameter_reaches_the_fused_step():
    got, want = _dp_run(mt.cpu(), True), _dp_run(mt.cpu(), False)
    assert got[0] == want[0]
    for k in want[1]:
        np.testing.assert_array_equal(got[1][k], want[1][k])


@pytest.mark.gpu
def test_inplace_on_a_parameter_captured_step_equals_eager_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run on the card")
    ctx = mt.gpu(0)
    captured, eager = _dp_run(ctx, True, captured=True), _dp_run(ctx, True, captured=False)
    assert captured[0] == eager[0]
    for k in eager[1]:
        np.testing.assert_array_equal(captured[1][k], eager[1][k])
