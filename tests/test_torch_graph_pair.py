"""The training graph pair of a hybridized block (the reference's
``fwd_res``/``bwd``, ``mxnet_tpu/gluon/block.py:499-713``).

On the CPU (no graph is captured here): the signature under
``autograd.record()`` carries which inputs need a gradient and the
``MXNET_TPU_REMAT_BWD`` switch, every CPU call's entry says ``"cpu"``, a
training-mode forward outside ``record()`` has no eager reason of its own,
and the hybridized gradients equal the unhybridized ones bitwise (the CPU
runs the eager forward). The tape's side of a replay (``_PairCall``) runs on
stand-in graphs: the gradients land by ``grad_req``, an input with
``attach_grad`` gets its own, and a parameter the backward does not reach
joins no tape.

On the card (``gpu``-marked: ``pytest -m gpu --noconftest``), a small net
with BatchNorm and Dropout trained by ``gluon.Trainer`` (SGD, momentum
0.9) hybridized against the same net unhybridized, after the same seed,
bitwise: losses, every gradient, the input's gradient, the running
statistics, the weights and the generator's state, over 4 steps (eager,
capture, replays); two calls of one block in one ``record()`` scope and a
``TripletLoss`` over three calls (slots in flight); ``grad_req="add"`` over
two steps and ``backward(retain_graph=True)`` twice; ``cast()`` making the
pair stale; ``MXNET_TPU_REMAT_BWD=1``; a training-mode forward outside
``record()`` captured alone; a trainer's compute copies and a fifth call in
flight running the eager forward under their reasons.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import autograd, engine
from mxnet_tpu_torch.convert import load_jax_params, seeded_params
from mxnet_tpu_torch.gluon import block as block_mod
from mxnet_tpu_torch.gluon import nn
from torch_threads import one_torch_thread  # noqa: F401


def _net(ctx, seed=0, dropout=0.1, bn=True):
    net = nn.HybridSequential()
    net.add(nn.Dense(64, in_units=32, activation="relu"))
    if bn:
        net.add(nn.BatchNorm(in_channels=64))
    if dropout:
        net.add(nn.Dropout(dropout))
    net.add(nn.Dense(10, in_units=64))
    net.initialize(ctx=ctx)
    load_jax_params(net, seeded_params(net, seed))
    return net


def _batch(ctx, n=8, seed=1):
    rs = np.random.RandomState(seed)
    return (mt.nd.array(rs.normal(size=(n, 32)).astype(np.float32), ctx=ctx),
            mt.nd.array((np.arange(n) % 10).astype(np.int32), ctx=ctx, dtype="int32"))


# -- on the CPU ------------------------------------------------------------------------

def test_record_signature_names_the_inputs_that_need_a_gradient(monkeypatch):
    """Under record(): the inputs' (shape, dtype), the train flag, which
    inputs need a gradient, and the remat switch; outside it the flags are
    None and False."""
    ctx = mt.cpu()
    net = _net(ctx, dropout=0.0)
    loss = mt.gluon.loss.SoftmaxCrossEntropyLoss()
    net.hybridize()
    loss.hybridize()
    x, y = _batch(ctx)
    with autograd.record():
        out = net(x)
        loss(out, y)
    xg, _ = _batch(ctx, seed=2)
    xg.attach_grad()
    monkeypatch.setenv("MXNET_TPU_REMAT_BWD", "1")
    with autograd.record():
        net(xg)
    monkeypatch.delenv("MXNET_TPU_REMAT_BWD")
    net(x)
    with autograd.train_mode():
        net(x)
    sigs = sorted(net._cached_graphs, key=repr)
    assert [(s[1], s[2], s[3]) for s in sigs] == [
        (False, None, False), (True, (False,), False), (True, (True,), True),
        (True, None, False)]
    assert all(s[0] == (((8, 32), "torch.float32"),) for s in sigs)
    (lsig,) = loss._cached_graphs
    assert lsig[2] == (True, False)          # the prediction needs one, the label not
    entries = list(net._cached_graphs.values()) + list(loss._cached_graphs.values())
    assert {e.eager for e in entries} == {"cpu"}
    assert all(e.pair is None and e.graph is None for e in entries)
    assert not net[0]._cached_graphs          # children fold into the parent's call


def test_cpu_hybridized_gradients_equal_unhybridized():
    """On the CPU the hybridized block runs its eager forward: 3 SGD steps of
    the hybridized net and loss equal the plain ones bitwise, input gradient
    and running statistics included (tolerance 0)."""
    ctx = mt.cpu()
    runs = []
    for hybrid in (False, True):
        mt.random.seed(7)
        net = _net(ctx)
        loss = mt.gluon.loss.SoftmaxCrossEntropyLoss()
        if hybrid:
            net.hybridize()
            loss.hybridize()
        tr = mt.gluon.Trainer(net.collect_params(), "sgd",
                              {"learning_rate": 0.1, "momentum": 0.9})
        x, y = _batch(ctx)
        x.attach_grad()
        rec = []
        for _ in range(3):
            with autograd.record():
                L = loss(net(x), y)
            L.backward()
            tr.step(8)
            rec.append([L.asnumpy(), x.grad.asnumpy()]
                       + [p.data().asnumpy() for p in net.collect_params().values()])
        runs.append(rec)
    for a, b in zip(*runs):
        for u, v in zip(a, b):
            np.testing.assert_array_equal(u, v)


class _StandIn:
    """A stand-in for a captured graph: ``replay()`` returns ``outputs``
    after calling ``fn`` (which writes them)."""

    def __init__(self, fn, outputs):
        self.fn, self.outputs, self.replays = fn, outputs, 0

    def replay(self):
        self.replays += 1
        self.fn()
        return self.outputs


def _stand_in_slot(w, b, unused):
    """y = x @ w.T + b as a slot of stand-in graphs: the input needs a
    gradient; ``unused`` is a parameter the backward does not reach."""
    slot = block_mod._Slot(0)
    slot.remat = False
    slot.token = torch.empty(0)
    x_buf = torch.zeros(3, 4, requires_grad=True)
    y_out = torch.zeros(3, 2)
    slot.inputs, slot.wrt_inputs, slot.used_inputs = [x_buf], [0], {0}
    slot.out_diff = [True]
    slot.gouts = [torch.zeros(3, 2)]
    gx, gw, gb = torch.zeros(3, 4), torch.zeros(2, 4), torch.zeros(2)

    def fwd():
        with torch.no_grad():
            y_out.copy_(x_buf @ w.T + b)

    def bwd():
        g = slot.gouts[0]
        with torch.no_grad():
            gx.copy_(g @ w)
            gw.copy_(g.T @ x_buf)
            gb.copy_(g.sum(0))
    slot.fwd = _StandIn(fwd, [y_out])
    slot.bwd = _StandIn(bwd, [gx, gw, gb, None])
    slot.used, slot.leaves = [0, 1], [w, b]
    return slot


def test_pair_call_lands_gradients_by_grad_req():
    """``_PairCall`` on stand-in graphs: the output equals the plain
    forward's, ``backward`` replays the backward graph once, the weight (grad_req
    "add") adds, the bias ("write") overwrites, the input's buffer gets its
    gradient, and the unreached parameter keeps its buffer (tolerance 0:
    the same f32 products)."""
    rs = np.random.RandomState(0)
    w = mt.nd.array(rs.normal(size=(2, 4)).astype(np.float32), ctx=mt.cpu())
    b = mt.nd.array(rs.normal(size=(2,)).astype(np.float32), ctx=mt.cpu())
    unused = mt.nd.array(np.ones(5, np.float32), ctx=mt.cpu())
    autograd.mark_variables([w, b, unused], grad_reqs=["add", "write", "write"])
    w.grad._data.fill_(1.0)
    b.grad._data.fill_(5.0)
    unused.grad._data.fill_(3.0)
    x = mt.nd.array(rs.normal(size=(3, 4)).astype(np.float32), ctx=mt.cpu())
    x.attach_grad()
    slot = _stand_in_slot(w._data, b._data, unused._data)
    with autograd.record():
        (y,) = block_mod._PairCall.apply(slot, x._data, *slot.leaves)
        y = mt.nd.NDArray(y)
        head = (y * y).sum()
    head.backward()
    want = x._data @ w._data.T + b._data
    g = 2 * want
    assert torch.equal(y._data, want)
    assert slot.fwd.replays == 1 and slot.bwd.replays == 1
    assert torch.equal(x.grad._data, g @ w._data)
    assert torch.equal(w.grad._data, 1.0 + g.T @ x._data)
    assert torch.equal(b.grad._data, g.sum(0))
    assert torch.equal(unused.grad._data, torch.full((5,), 3.0))


def test_slot_is_busy_until_its_backward_releases_it():
    """A slot stays busy while the node of its last replay may still run a
    backward: after ``retain_graph=True`` yes, after a plain backward or once
    the outputs are gone no."""
    w = mt.nd.array(np.ones((2, 4), np.float32), ctx=mt.cpu())
    b = mt.nd.array(np.zeros(2, np.float32), ctx=mt.cpu())
    autograd.mark_variables([w, b])
    slot = _stand_in_slot(w._data, b._data, None)
    x = torch.ones(3, 4)
    assert not slot.busy()
    with autograd.record():
        (y,) = block_mod._PairCall.apply(slot, x, *slot.leaves)
    assert slot.busy()
    autograd.backward([mt.nd.NDArray(y)], retain_graph=True)
    assert slot.busy()
    autograd.backward([mt.nd.NDArray(y)])
    assert not slot.busy()
    with autograd.record():
        (y,) = block_mod._PairCall.apply(slot, x, *slot.leaves)
    assert slot.busy()
    del y
    assert not slot.busy()


# -- on the card -----------------------------------------------------------------------

def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return mt.gpu(0)


def _state(net, x):
    return {"w": {k: p._param.detach().clone()
                  for k, p in net._collect_params_with_prefix().items()},
            "g": {k: p._grad.clone() for k, p in net._collect_params_with_prefix().items()
                  if p._grad is not None},
            "x": x.grad._data.clone() if x.grad is not None else None,
            "gen": mt.random.generator(x.ctx).get_state().clone()}


def _loop(ctx, hybrid, steps=4, remat=False, monkeypatch=None, **kw):
    mt.random.seed(11)
    net = _net(ctx, **kw)
    loss = mt.gluon.loss.SoftmaxCrossEntropyLoss()
    if hybrid:
        net.hybridize()
        loss.hybridize()
    tr = mt.gluon.Trainer(net.collect_params(), "sgd", {"learning_rate": 0.1, "momentum": 0.9})
    x, y = _batch(ctx)
    x.attach_grad()
    out = []
    for _ in range(steps):
        with autograd.record():
            L = loss(net(x), y)
        L.backward()
        tr.step(8)
        out.append(dict(_state(net, x), loss=L._data.clone()))
    torch.cuda.synchronize()
    return net, out


def _assert_equal_runs(a, b):
    for sa, sb in zip(a, b):
        assert torch.equal(sa["loss"], sb["loss"])
        assert torch.equal(sa["x"], sb["x"])
        assert torch.equal(sa["gen"], sb["gen"])
        for part in ("w", "g"):
            for k in sa[part]:
                assert torch.equal(sa[part][k], sb[part][k]), (part, k)


@pytest.mark.gpu
def test_gpu_pair_equals_eager():
    """4 steps: eager (warm), capture + replay, two replays; every loss,
    gradient, input gradient, weight, running statistic and the generator's
    state bitwise the unhybridized run's; the entries carry no eager reason
    and the engine counts one slot's captures and the replays."""
    ctx = _cuda()
    _, eager = _loop(ctx, hybrid=False)
    engine.reset_stats()
    net, graph = _loop(ctx, hybrid=True)
    _assert_equal_runs(graph, eager)
    ((sig, entry),) = net._cached_graphs.items()
    assert sig[2] == (True,) and entry.eager is None and len(entry.pair.slots) == 1
    st = engine.cache_stats()
    # net and loss: one slot each (2 graphs), 3 forward and 3 backward replays each
    assert st["captures"] == 4 and st["replays"] == 12, st


@pytest.mark.gpu
def test_gpu_two_calls_in_flight():
    """Gradient accumulation over two micro-batches in one record() scope:
    the second call takes a second slot, and the gradients equal eager's."""
    ctx = _cuda()
    runs = []
    for hybrid in (False, True):
        mt.random.seed(3)
        net = _net(ctx, dropout=0.0)
        if hybrid:
            net.hybridize()
        loss = mt.gluon.loss.SoftmaxCrossEntropyLoss()
        x1, y1 = _batch(ctx, seed=4)
        x2, y2 = _batch(ctx, seed=5)
        grads = []
        for _ in range(3):
            with autograd.record():
                L = loss(net(x1), y1) + loss(net(x2), y2)
            L.backward()
            grads.append({k: p._grad.clone() for k, p in
                          net._collect_params_with_prefix().items() if p._grad is not None})
        runs.append(grads)
        if hybrid:
            (entry,) = net._cached_graphs.values()
            assert len(entry.pair.slots) == 2
    for a, b in zip(*runs):
        for k in a:
            assert torch.equal(a[k], b[k]), k


@pytest.mark.gpu
def test_gpu_triplet_over_three_calls():
    """TripletLoss over three calls of one net in one scope: three slots,
    gradients bitwise eager's over 3 steps."""
    ctx = _cuda()
    runs = []
    for hybrid in (False, True):
        net = _net(ctx, dropout=0.0, bn=False)
        loss = mt.gluon.loss.TripletLoss()
        if hybrid:
            net.hybridize()
            loss.hybridize()
        a, p, n = (_batch(ctx, seed=s)[0] for s in (6, 7, 8))
        grads = []
        for _ in range(3):
            with autograd.record():
                L = loss(net(a), net(p), net(n))
            L.backward()
            grads.append([q._grad.clone() for q in net.collect_params().values()])
        runs.append(grads)
        if hybrid:
            (entry,) = net._cached_graphs.values()
            assert len(entry.pair.slots) == 3
    for a, b in zip(*runs):
        for u, v in zip(a, b):
            assert torch.equal(u, v)


@pytest.mark.gpu
def test_gpu_grad_add_and_retain_graph():
    """grad_req "add" over two steps without zero_grad, and a backward with
    retain_graph=True run twice: the buffers equal eager's bitwise."""
    ctx = _cuda()
    runs = []
    for hybrid in (False, True):
        net = _net(ctx, dropout=0.0, bn=False)
        for q in net.collect_params().values():
            q.grad_req = "add"
        if hybrid:
            net.hybridize()
        x, _ = _batch(ctx)
        for _ in range(3):
            with autograd.record():
                L = (net(x) * net(x)).sum()
            L.backward(retain_graph=True)
            L.backward()
        runs.append([q._grad.clone() for q in net.collect_params().values()])
    for u, v in zip(*runs):
        assert torch.equal(u, v)


@pytest.mark.gpu
def test_gpu_cast_makes_the_pair_stale():
    """cast() drops the pair; the next calls warm up and capture again in
    the new dtype."""
    ctx = _cuda()
    net = _net(ctx, dropout=0.0, bn=False)
    net.hybridize()
    x, _ = _batch(ctx)
    for _ in range(3):
        with autograd.record():
            L = net(x).sum()
        L.backward()
    assert len(net._cached_graphs) == 1
    net.cast("bfloat16")
    assert len(net._cached_graphs) == 0
    engine.reset_stats()
    xb = mt.nd.array(x._data.to(torch.bfloat16))
    for _ in range(3):
        with autograd.record():
            L = net(xb).sum()
        L.backward()
    (entry,) = net._cached_graphs.values()
    assert L.dtype == torch.bfloat16 and entry.eager is None
    assert engine.cache_stats()["captures"] == 2


@pytest.mark.gpu
def test_gpu_remat_equals_eager(monkeypatch):
    """MXNET_TPU_REMAT_BWD=1: the forward graph keeps no activations and the
    backward runs the forward again, Dropout drawing the same masks and
    BatchNorm writing its statistics once: bitwise eager's over 4 steps."""
    ctx = _cuda()
    _, eager = _loop(ctx, hybrid=False)
    monkeypatch.setenv("MXNET_TPU_REMAT_BWD", "1")
    net, graph = _loop(ctx, hybrid=True)
    _assert_equal_runs(graph, eager)
    ((sig, entry),) = net._cached_graphs.items()
    assert sig[3] is True and entry.eager is None


@pytest.mark.gpu
def test_gpu_train_mode_forward_graph():
    """A training-mode forward outside record(): captured alone; outputs,
    running statistics and generator state bitwise eager's over 4 calls."""
    ctx = _cuda()
    runs = []
    for hybrid in (False, True):
        mt.random.seed(5)
        net = _net(ctx)
        if hybrid:
            net.hybridize()
        x, _ = _batch(ctx)
        outs = []
        with autograd.train_mode():
            for _ in range(4):
                outs.append(net(x)._data.clone())
        runs.append((outs, _state(net, x)))
        if hybrid:
            (entry,) = net._cached_graphs.values()
            assert entry.graph is not None and entry.eager is None
    (oa, sa), (ob, sb) = runs
    assert all(torch.equal(u, v) for u, v in zip(oa, ob))
    assert torch.equal(sa["gen"], sb["gen"])
    for k in sa["w"]:
        assert torch.equal(sa["w"][k], sb["w"][k]), k


@pytest.mark.gpu
def test_gpu_compute_copies_and_slots_beyond_the_limit_run_eagerly():
    """A trainer's compute copy standing in for a parameter ("compute"), and a
    fifth call in flight beyond the four slots ("in_flight"), run the eager
    forward; the gradients still equal the unhybridized net's."""
    ctx = _cuda()
    runs = []
    for hybrid in (False, True):
        net = _net(ctx, dropout=0.0, bn=False)
        if hybrid:
            net.hybridize()
        x, _ = _batch(ctx)
        for _ in range(2):
            with autograd.record():
                L = sum((net(x) * (k + 1)).sum() for k in range(block_mod._MAX_IN_FLIGHT + 1))
            L.backward()
        grads = [q._grad.clone() for q in net.collect_params().values()]
        reasons = {e.eager for e in net._cached_graphs.values()}
        params = list(net.collect_params().values())
        for q in params:
            q._compute = q._param.to(torch.float32)
        with autograd.record():
            out = net(x)
        for q in params:
            q._compute = None
        runs.append((grads, out._data, reasons, {e.eager for e in net._cached_graphs.values()}))
    (ga, oa, _, _), (gb, ob, rb, cb) = runs
    assert all(torch.equal(u, v) for u, v in zip(ga, gb)) and torch.equal(oa, ob)
    assert rb == {"in_flight"} and cb == {"compute"}
