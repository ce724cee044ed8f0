"""Trainer and optimizer states of the port: saved, resumed, and read from
the reference package's bytes.

- A port ``gluon.Trainer`` saved after step 3 (``net.save_parameters``,
  ``trainer.save_states``) and resumed by a fresh net and trainer (both
  files loaded) gives steps 4-6 bitwise equal to the uninterrupted run:
  losses, weights and optimizer states, for Adam, SGD with momentum and
  LAMB, with and without ``update_on_kvstore``, on a 2-layer BERT (units
  64, T 128) and on LeNet.
- The reference's ``Updater.get_states()`` bytes (with and without the
  dumped optimizer) resume in the port's ``Updater``: the next 3 updates,
  fed the same gradients, are within 1e-6 of each tensor's max of the
  reference's. The reference's ``Trainer.save_states`` file loads into a
  port ``Trainer``.
- The repairs: a pickled ``Optimizer`` carries no parameters (reference
  optimizer.py:71-79), ``Updater.set_states`` reads the reference's
  3-field entries (their device is the weight's), and a blob that names a
  reference class with no counterpart, or JAX, raises ``MXNetError``.
"""
import pickle

import numpy as np
import pytest
import torch

import mxnet_tpu_torch as mt
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.models import BertModel, lenet
from torch_threads import one_torch_thread  # noqa: F401

TOL_UPDATE = 1e-6
CFG = dict(vocab_size=256, num_layers=2, units=64, hidden_size=128, num_heads=2,
           max_length=128)
OPTIMIZERS = {"adam": {"learning_rate": 1e-3},
              "sgd": {"learning_rate": 0.05, "momentum": 0.9},
              "lamb": {"learning_rate": 1e-3, "wd": 0.01}}


def _bert(seed):
    from mxnet_tpu_torch.convert import load_jax_params, seeded_params
    net = BertModel(**CFG)
    net.initialize(ctx=mt.cpu())
    load_jax_params(net, seeded_params(net, seed=seed))
    rs = np.random.RandomState(11)
    batches = [(mt.nd.array(rs.randint(0, CFG["vocab_size"], (2, 128)), ctx=mt.cpu(),
                            dtype="int32"),
                mt.nd.array(rs.randint(0, CFG["vocab_size"], (2, 128)), ctx=mt.cpu(),
                            dtype="int32")) for _ in range(6)]
    return net, batches


def _lenet(seed):
    from mxnet_tpu_torch.convert import load_jax_params, seeded_params
    net = lenet()
    net.initialize(ctx=mt.cpu())
    rs = np.random.RandomState(12)
    x0 = mt.nd.array(rs.rand(4, 1, 28, 28).astype(np.float32), ctx=mt.cpu())
    net(x0)
    load_jax_params(net, seeded_params(net, seed=seed))
    batches = [(mt.nd.array(rs.rand(4, 1, 28, 28).astype(np.float32), ctx=mt.cpu()),
                mt.nd.array(rs.randint(0, 10, (4,)), ctx=mt.cpu(), dtype="int32"))
               for _ in range(6)]
    return net, batches


MODELS = {"bert": _bert, "lenet": _lenet}


def _trainer(net, name, on_kv):
    kw = {"kvstore": "device", "update_on_kvstore": True} if on_kv else {"kvstore": None}
    return mt.gluon.Trainer(net.collect_params(), name, dict(OPTIMIZERS[name]), **kw)


def _step(net, loss_fn, trainer, x, y):
    with mt.autograd.record():
        loss = loss_fn(net(x), y)
    loss.backward()
    trainer.step(x.shape[0])
    return loss.asnumpy()


def _weights(net):
    return {k: p.data().asnumpy() for k, p in net._collect_params_with_prefix().items()}


def _updater(trainer):
    return trainer._kvstore._opt_updater if trainer._update_on_kvstore_flag \
        else trainer._updater


def _states(trainer):
    updater = _updater(trainer)
    out = {}
    for k, s in updater.states.items():
        for j, t in enumerate(s if isinstance(s, tuple) else (s,)):
            if t is not None:
                out[(k, j)] = t.asnumpy()
    return out


CASES = [("bert", name, on_kv) for name in OPTIMIZERS for on_kv in (False, True)] + \
    [("lenet", "sgd", False), ("lenet", "adam", True)]


@pytest.mark.parametrize("model,name,on_kv", CASES,
                         ids=[f"{m}-{n}-{'kvstore' if k else 'local'}" for m, n, k in CASES])
def test_resume_after_step_3_is_bitwise(tmp_path, model, name, on_kv):
    loss_fn = mt.gluon.loss.SoftmaxCrossEntropyLoss()
    net, batches = MODELS[model](3)
    trainer = _trainer(net, name, on_kv)
    full = [_step(net, loss_fn, trainer, x, y) for x, y in batches]

    net, _ = MODELS[model](3)
    trainer = _trainer(net, name, on_kv)
    for x, y in batches[:3]:
        _step(net, loss_fn, trainer, x, y)
    net.save_parameters(str(tmp_path / "net.params"))
    trainer.save_states(str(tmp_path / "trainer.states"))

    fresh, _ = MODELS[model](9)                    # other weights until the load
    fresh.load_parameters(str(tmp_path / "net.params"))
    resumed = _trainer(fresh, name, on_kv)
    resumed.load_states(str(tmp_path / "trainer.states"))
    tail = [_step(fresh, loss_fn, resumed, x, y) for x, y in batches[3:]]

    for got, want in zip(tail, full[3:]):
        np.testing.assert_array_equal(got, want)
    # the uninterrupted run again, for its weights and states after step 6
    ref_net, _ = MODELS[model](3)
    ref_tr = _trainer(ref_net, name, on_kv)
    for x, y in batches:
        _step(ref_net, loss_fn, ref_tr, x, y)
    w_got, w_full = _weights(fresh), _weights(ref_net)
    assert sorted(w_got) == sorted(w_full)
    for k in w_full:
        np.testing.assert_array_equal(w_got[k], w_full[k], err_msg=k)
    s_got, s_want = _states(resumed), _states(ref_tr)
    assert sorted(s_got) == sorted(s_want) and s_want
    for k in s_want:
        np.testing.assert_array_equal(s_got[k], s_want[k], err_msg=str(k))
    # the optimizer that updates (the store's under update_on_kvstore, which,
    # as in the reference, the trainer's own does not become)
    assert _updater(resumed).optimizer.num_update == _updater(ref_tr).optimizer.num_update == 6


def _ref_updater_run(name, kw, weights, grads):
    """The reference: 3 updates, the updater's bytes (plain and with the
    optimizer), then 3 more; the weights after each of the last 3."""
    import mxnet_tpu as mx
    opt = mx.optimizer.create(name, **kw)
    upd = mx.optimizer.get_updater(opt)
    ws = [mx.nd.array(w, ctx=mx.cpu()) for w in weights]
    for step in range(3):
        for i, w in enumerate(ws):
            upd(i, mx.nd.array(grads[step][i], ctx=mx.cpu()), w)
    blobs = (upd.get_states(), upd.get_states(dump_optimizer=True))
    start = [w.asnumpy() for w in ws]
    after = []
    for step in range(3, 6):
        for i, w in enumerate(ws):
            upd(i, mx.nd.array(grads[step][i], ctx=mx.cpu()), w)
        after.append([w.asnumpy() for w in ws])
    return blobs, start, after


@pytest.mark.parametrize("dumped", [False, True], ids=["states", "with_optimizer"])
@pytest.mark.parametrize("name", ["adam", "sgd", "lamb"])
def test_reference_updater_bytes_resume_in_the_port(name, dumped):
    rs = np.random.RandomState(5)
    shapes = [(4, 3), (5,)]
    weights = [rs.randn(*s).astype(np.float32) for s in shapes]
    grads = [[rs.randn(*s).astype(np.float32) for s in shapes] for _ in range(6)]
    kw = dict(OPTIMIZERS[name])
    blobs, start, after = _ref_updater_run(name, kw, weights, grads)
    # without the optimizer the port's starts at the reference's count
    opt = mt.optimizer.create(name, begin_num_update=3, **kw)
    upd = mt.optimizer.get_updater(opt)
    upd.set_states(blobs[dumped])
    if dumped:
        assert type(upd.optimizer) is type(opt) and upd.optimizer is not opt
        assert upd.optimizer.param_dict == {}
    ws = [mt.nd.array(w, ctx=mt.cpu()) for w in start]
    for step in range(3, 6):
        for i, w in enumerate(ws):
            upd(i, mt.nd.array(grads[step][i], ctx=mt.cpu()), w)
        for got, want in zip(ws, after[step - 3]):
            err = np.abs(got.asnumpy() - want).max() / np.abs(want).max()
            assert err <= TOL_UPDATE, (name, step, err)


def test_reference_trainer_file_loads_into_a_port_trainer(tmp_path):
    import mxnet_tpu as mx
    path = str(tmp_path / "ref.states")
    rnet = mx.gluon.nn.Dense(3, in_units=4)
    rnet.initialize(ctx=mx.cpu())
    sched = mx.lr_scheduler.FactorScheduler(step=2, factor=0.5)
    rtr = mx.gluon.Trainer(rnet.collect_params(), "adam",
                           {"learning_rate": 0.01, "lr_scheduler": sched})
    x = mx.nd.array(np.ones((2, 4), np.float32), ctx=mx.cpu())
    for _ in range(3):
        with mx.autograd.record():
            loss = rnet(x).sum()
        loss.backward()
        rtr.step(2)
    rtr.save_states(path)
    net = mt.gluon.nn.Dense(3, in_units=4)
    net.initialize(ctx=mt.cpu())
    tr = mt.gluon.Trainer(net.collect_params(), "adam", {"learning_rate": 0.5})
    tr.load_states(path)
    assert isinstance(tr.optimizer, mt.optimizer.Adam)
    assert isinstance(tr.optimizer.lr_scheduler, mt.lr_scheduler.FactorScheduler)
    assert tr.optimizer.num_update == 3 and tr.learning_rate == rtr.learning_rate
    want = rtr._updaters[0].states
    for k, (m, v) in tr._updater.states.items():
        np.testing.assert_array_equal(m.asnumpy(), want[k][0].asnumpy())
        np.testing.assert_array_equal(v.asnumpy(), want[k][1].asnumpy())
        assert m.ctx == mt.cpu()


def test_pickled_optimizer_drops_its_parameters():
    net = mt.gluon.nn.Dense(3, in_units=4)
    net.initialize(ctx=mt.cpu())
    tr = mt.gluon.Trainer(net.collect_params(), "adam", {"learning_rate": 0.01})
    assert tr.optimizer.param_dict
    back = pickle.loads(pickle.dumps(tr.optimizer))
    assert back.param_dict == {} and tr.optimizer.param_dict
    assert back.lr == 0.01 and type(back) is type(tr.optimizer)
    blob = tr._updater.get_states(dump_optimizer=True)
    assert b"Parameter" not in blob


def test_set_states_reads_three_field_entries_onto_the_weight_device():
    net = mt.gluon.nn.Dense(3, in_units=4)
    net.initialize(ctx=mt.cpu())
    tr = mt.gluon.Trainer(net.collect_params(), "sgd",
                          {"learning_rate": 0.1, "momentum": 0.9})
    mom = np.arange(12, dtype=np.float32).reshape(3, 4)
    blob = pickle.dumps({"states": {0: ("nd", mom, "float32"), 1: ("raw", None)}})
    tr._updater.set_states(blob)
    got = tr._updater.states[0]
    assert got.ctx == mt.cpu() and got.dtype == torch.float32
    np.testing.assert_array_equal(got.asnumpy(), mom)
    # an index the optimizer has no parameter of: placed at its next update
    upd = mt.optimizer.get_updater(mt.optimizer.create("sgd", momentum=0.9))
    upd.set_states(pickle.dumps({"states": {7: ("nd", mom, "bfloat16")}}))
    assert upd.states[7].dtype == torch.bfloat16
    w = mt.nd.array(np.zeros((3, 4), np.float32), ctx=mt.cpu())
    upd(7, mt.nd.array(np.ones((3, 4), np.float32), ctx=mt.cpu()), w.astype("bfloat16"))


@pytest.mark.parametrize("module,name", [("mxnet_tpu.ndarray.ndarray", "NDArray"),
                                         ("jax._src.array", "ArrayImpl"),
                                         ("mxnet_tpu.optimizer.optimizer", "NoSuchClass")])
def test_set_states_refuses_foreign_globals(module, name):
    # {"states": {0: <module.name>}} in pickle protocol 0
    blob = f"(dp0\nVstates\np1\n(dp2\nI0\nc{module}\n{name}\np3\nss.".encode()
    upd = mt.optimizer.get_updater(mt.optimizer.create("sgd"))
    with pytest.raises(MXNetError, match=f"{module}.{name}"):
        upd.set_states(blob)
