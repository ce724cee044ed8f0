"""The ``dist_async`` parameter server (``kvstore/ps.py``) and its store.

- The reference's ``tests/test_ps_protocol.py`` cases on the port's
  ``PSServer``/``PSClient`` over localhost TCP (less its SymbolBlock case,
  which is not about the server): a retried push under the same envelope seq
  is replayed, not applied again; a fresh seq applies and pulls run again; a
  duplicate init is idempotent; a retry racing a slow original applies once;
  an updater that raises releases its waiters with an error; two clients'
  concurrent pushes each apply once. The wire format is the reference's:
  a payload packed by either package's ``_pack`` unpacks in the other.
- ``kvstore.create("dist_async")`` on 2 gloo ranks spawned by
  ``_dist_util.launch_local`` (one spawn for the module): the address
  rendezvous through the process group's store (``_dist_util.store()``),
  rank 0's value seeding every key's home, the server-side SGD applied at the
  home on every push exactly once (``push_counts`` = steps x ranks), the
  final weights equal to a replay of the applied pushes in the home's order,
  ``gluon.Trainer(kvstore="dist_async")``, and ``set_optimizer``'s barrier.
- With one worker ``dist_async`` is the in-process store.

Values are compared bitwise: the same float32 arithmetic in one order.
"""
import os
import threading
import time

import numpy as np
import pytest
import torch

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import _dist_util
from mxnet_tpu_torch.kvstore.ps import PSClient, PSServer, _pack, _unpack
from torch_threads import one_torch_thread  # noqa: F401

MODULE = "test_torch_ps"
TESTS_DIR = os.path.dirname(os.path.abspath(__file__))
STEPS = 3


def _server_with_sgd(lr=0.5):
    state = {"updater_calls": 0}

    def updater(key, grad, stored):
        state["updater_calls"] += 1
        stored -= lr * grad

    return PSServer(lambda: updater), state


def _client_for(srv):
    return PSClient(lambda rank: f"127.0.0.1:{srv.port}")


def test_push_applied_once_per_seq():
    srv, state = _server_with_sgd()
    try:
        cli = _client_for(srv)
        assert cli.request(0, ("init", "w", _pack(np.ones(4, np.float32))))[0] == "ok"
        assert cli.request(0, ("push", "w", _pack(np.full(4, 2.0, np.float32))))[0] == "ok"
        push_seq = cli._seq
        np.testing.assert_allclose(_unpack(cli.request(0, ("pull", "w"))[1]), 0.0)
        assert state["updater_calls"] == 1
        dup = ("req", cli._id, push_seq, ("push", "w", _pack(np.full(4, 2.0, np.float32))))
        assert srv._handle(dup)[0] == "ok"
        assert state["updater_calls"] == 1, "duplicate push was re-applied"
        np.testing.assert_allclose(_unpack(cli.request(0, ("pull", "w"))[1]), 0.0)
        assert srv.push_counts == {"w": 1}
    finally:
        srv.close()


def test_fresh_seq_applies_again_and_pulls_reexecute():
    srv, state = _server_with_sgd()
    try:
        cli = _client_for(srv)
        cli.request(0, ("init", "w", _pack(np.ones(4, np.float32))))
        cli.request(0, ("push", "w", _pack(np.full(4, 2.0, np.float32))))
        cli.request(0, ("push", "w", _pack(np.full(4, 2.0, np.float32))))
        assert state["updater_calls"] == 2
        np.testing.assert_allclose(_unpack(cli.request(0, ("pull", "w"))[1]), -1.0)
    finally:
        srv.close()


def test_duplicate_init_is_idempotent_anyway():
    srv, _ = _server_with_sgd()
    try:
        cli = _client_for(srv)
        cli.request(0, ("init", "w", _pack(np.zeros(2, np.float32))))
        dup = ("req", cli._id, cli._seq, ("init", "w", _pack(np.ones(2, np.float32))))
        assert srv._handle(dup)[0] == "ok"
        np.testing.assert_allclose(_unpack(cli.request(0, ("pull", "w"))[1]), 0.0)
    finally:
        srv.close()


def test_retry_racing_slow_original_applies_once():
    gate = threading.Event()
    calls = {"n": 0}

    def slow_updater(key, grad, stored):
        calls["n"] += 1
        gate.wait(5)
        stored -= grad

    srv = PSServer(lambda: slow_updater)
    try:
        cli = _client_for(srv)
        cli.request(0, ("init", "w", _pack(np.ones(2, np.float32))))
        env = ("req", cli._id, cli._seq + 1, ("push", "w", _pack(np.ones(2, np.float32))))
        results = []

        def original():
            results.append(srv._handle(env))

        t1 = threading.Thread(target=original)
        t1.start()
        time.sleep(0.1)
        t2 = threading.Thread(target=original)
        t2.start()
        time.sleep(0.1)
        gate.set()
        t1.join(10)
        t2.join(10)
        assert [r[0] for r in results] == ["ok", "ok"]
        assert calls["n"] == 1, "retry re-ran the updater"
        np.testing.assert_allclose(_unpack(srv._handle(("pull", "w"))[1]), 0.0)
    finally:
        srv.close()


def test_updater_exception_releases_waiters_with_error():
    def bad_updater(key, grad, stored):
        raise RuntimeError("boom")

    srv = PSServer(lambda: bad_updater)
    try:
        cli = _client_for(srv)
        cli.request(0, ("init", "w", _pack(np.ones(2, np.float32))))
        env = ("req", cli._id, cli._seq + 1, ("push", "w", _pack(np.ones(2, np.float32))))
        with pytest.raises(RuntimeError):
            srv._handle(env)
        assert srv._handle(env)[0] == "error"
    finally:
        srv.close()


def test_concurrent_clients_unique_seq_streams():
    srv, state = _server_with_sgd(lr=1.0)
    try:
        clients = [_client_for(srv) for _ in range(2)]
        clients[0].request(0, ("init", "w", _pack(np.zeros(1, np.float32))))

        def work(cli):
            for _ in range(10):
                cli.request(0, ("push", "w", _pack(np.full(1, -1.0, np.float32))))

        ts = [threading.Thread(target=work, args=(c,)) for c in clients]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
        assert state["updater_calls"] == 20 and srv.push_counts["w"] == 20
        assert sorted(set(srv.applied["w"])) == sorted(c._id for c in clients)
        np.testing.assert_allclose(_unpack(clients[0].request(0, ("pull", "w"))[1]), 20.0)
    finally:
        srv.close()


def test_wire_format_is_the_reference():
    from mxnet_tpu.kvstore import ps as ref_ps
    a = np.arange(12, dtype=np.float32).reshape(3, 4)
    np.testing.assert_array_equal(ref_ps._unpack(_pack(torch.from_numpy(a))), a)
    np.testing.assert_array_equal(_unpack(ref_ps._pack(a)), a)
    assert _pack(a) == ref_ps._pack(a)


def test_one_worker_is_the_in_process_store(tmp_path):
    _dist_util.init_process_group(device="cpu", backend="gloo", rank=0, world_size=1,
                                  init_method=f"file://{tmp_path / 'rdzv'}")
    try:
        assert _dist_util.store() is not None
        kv = mt.kv.create("dist_async")
        assert kv.type == "dist_async" and kv._ps_server is None
        kv.init("w", mt.nd.array(np.ones(3, np.float32), ctx=mt.cpu()))
        kv.push("w", mt.nd.array(np.full(3, 4.0, np.float32), ctx=mt.cpu()))
        out = mt.nd.zeros((3,), ctx=mt.cpu())
        kv.pull("w", out=out)
        assert out.asnumpy().tolist() == [4.0] * 3
    finally:
        _dist_util.destroy_process_group()
    assert _dist_util.store() is None


# -- two workers ---------------------------------------------------------------------------

def _grad(rank, step, key, shape):
    rs = np.random.RandomState(100 * rank + 10 * step + key)
    return rs.uniform(-1, 1, shape).astype(np.float32)


SHAPES = [(4, 3), (5,), (2, 2, 2)]


def rank_async():
    """One of 2 workers: keys at their homes, pushes applied exactly once
    under the server-side SGD, then a Trainer on dist_async."""
    import sys
    kv = mt.kv.create("dist_async")
    r = kv.rank
    kv.set_optimizer(mt.optimizer.create("sgd", learning_rate=0.1))
    for k, shape in enumerate(SHAPES):
        kv.init(k, mt.nd.array(np.full(shape, r + 1.0, np.float32), ctx=mt.cpu()))
    for step in range(STEPS):
        for k, shape in enumerate(SHAPES):
            kv.push(k, mt.nd.array(_grad(r, step, k, shape), ctx=mt.cpu()))
    kv._dist.barrier()      # every push applied: each was acknowledged
    final = {}
    for k, shape in enumerate(SHAPES):
        out = mt.nd.zeros(shape, ctx=mt.cpu())
        kv.pull(k, out=out)
        final[str(k)] = out.asnumpy().tolist()
    mine = {str(k): {"count": kv._ps_server.push_counts.get(k, 0),
                     "order": [kv._ps_client._id == c for c in kv._ps_server.applied.get(k, [])]}
            for k in range(len(SHAPES)) if kv._home(k) == r}
    kv._dist.barrier()
    # gluon.Trainer on the parameter server: update on the store
    net = mt.gluon.nn.Dense(2, in_units=3)
    net.initialize(ctx=mt.cpu())
    trainer = mt.gluon.Trainer(net.collect_params(), "sgd", {"learning_rate": 0.1},
                               kvstore="dist_async")
    x = mt.nd.array(np.random.RandomState(r).randn(4, 3).astype(np.float32), ctx=mt.cpu())
    for _ in range(2):
        with mt.autograd.record():
            out = net(x)
            loss = (out * out).sum()
        loss.backward()
        trainer.step(4)
    trainer._kvstore._dist.barrier()
    ok = trainer._kvstore.type == "dist_async" and trainer._update_on_kvstore_flag
    result = {"rank": r, "store_type": _dist_util.store().__class__.__name__,
              "final": final, "mine": mine, "trainer_ok": ok,
              "modules": sorted(m for m in sys.modules
                                if m.split(".")[0] in ("jax", "jaxlib", "mxnet_tpu"))}
    kv._dist.barrier()
    return result


@pytest.fixture(scope="module")
def workers(tmp_path_factory):
    return _dist_util.launch_local(f"{MODULE}:rank_async", 2, device="cpu", timeout=180,
                                   pythonpath=[TESTS_DIR],
                                   workdir=str(tmp_path_factory.mktemp("ps")))


def test_rendezvous_through_the_group_store(workers):
    for w in workers:
        assert w["store_type"] == "FileStore" and not w["modules"]
        assert w["trainer_ok"]


def test_every_push_applied_once_at_its_home(workers):
    homes = {}
    for w in workers:
        for k, rec in w["mine"].items():
            homes[k] = w["rank"]
            assert rec["count"] == STEPS * 2, (k, rec)
            assert len(rec["order"]) == STEPS * 2
    assert sorted(homes) == [str(k) for k in range(len(SHAPES))]


def test_weights_equal_a_replay_of_the_applied_pushes(workers):
    """Replay each key's pushes in the order its home applied them (each
    rank's own pushes in step order) through SGD from rank 0's initial value."""
    by_rank = {w["rank"]: w for w in workers}
    for k, shape in enumerate(SHAPES):
        home = next(w for w in workers if str(k) in w["mine"])
        order = home["mine"][str(k)]["order"]      # True: the home's own push
        w = np.full(shape, 1.0, np.float32)         # rank 0's value seeds the home
        step = {0: 0, 1: 0}
        opt = mt.optimizer.create("sgd", learning_rate=0.1)
        upd = mt.optimizer.get_updater(opt)
        wt = mt.nd.array(w, ctx=mt.cpu())
        for own in order:
            r = home["rank"] if own else 1 - home["rank"]
            g = mt.nd.array(_grad(r, step[r], k, shape), ctx=mt.cpu())
            step[r] += 1
            upd(k, g, wt)
        for w_ in by_rank.values():
            np.testing.assert_array_equal(np.array(w_["final"][str(k)], np.float32),
                                          wt.asnumpy())
