"""``mxnet_tpu_torch.checkpoint`` against the reference's ``tests/test_checkpoint.py``.

The reference's cases, less its orbax-message one (the port adds no
package): a save/restore round trip of a nested tree, the retention policy,
a ``DataParallelTrainer`` saved after 3 steps and restored into a rebuilt
trainer that continues the same losses (here also against the reference's
trainer), the elastic boot of ``resume_or_init``, the sidecar-driven restore
with no target (and its fallback, with a ``DeprecationWarning``, when the
sidecar is gone), and the restore onto another placement (``like=``: another
dtype and device). A checkpoint is written in the elastic snapshot format,
so ``elastic.SnapshotReader`` reads it too.

Tolerances: the round trips bitwise; the resumed losses against the
uninterrupted trainer at rtol 1e-5 (the reference's), against the
reference's trainer at 1e-5.
"""
import os

import numpy as np
import pytest
import torch

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import nd, gluon
from mxnet_tpu_torch.checkpoint import (CheckpointManager, resume_or_init, restore_trainer,
                                        save_trainer, trainer_state)
from mxnet_tpu_torch.elastic import SnapshotReader
from mxnet_tpu_torch.parallel import DataParallelTrainer, make_mesh
from torch_threads import one_torch_thread  # noqa: F401


def _loss(p, y):
    return torch.mean((p.float() - y) ** 2, dim=-1)


def _make_trainer():
    mt.random.seed(3)
    net = gluon.nn.Dense(4, in_units=8)
    net.initialize(ctx=mt.cpu())
    return DataParallelTrainer(net, _loss, optimizer="adam",
                               optimizer_params={"learning_rate": 1e-2},
                               mesh=make_mesh({"dp": 1}, devices=[mt.cpu()]))


def _data():
    rs = np.random.RandomState(0)
    x = rs.uniform(-1, 1, (8, 8)).astype(np.float32)
    y = rs.uniform(-1, 1, (8, 4)).astype(np.float32)
    return nd.array(x, ctx=mt.cpu()), nd.array(y, ctx=mt.cpu())


def test_manager_save_restore_roundtrip(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "ck"))
    state = {"w": torch.arange(6.0).reshape(2, 3), "step": np.int64(5),
             "nested": {"m": torch.ones(4)}, "pair": (np.arange(3), torch.zeros(2, 2))}
    assert mgr.save(5, state, wait=True)
    assert mgr.latest_step() == 5
    got = mgr.restore()
    np.testing.assert_array_equal(np.asarray(got["w"]), np.arange(6.0).reshape(2, 3))
    np.testing.assert_array_equal(np.asarray(got["nested"]["m"]), np.ones(4))
    assert int(np.asarray(got["step"])) == 5
    np.testing.assert_array_equal(np.asarray(got["pair"][0]), np.arange(3))
    with SnapshotReader(str(tmp_path / "ck"), 5) as rd:
        np.testing.assert_array_equal(rd("nested/m"), np.ones(4))


def test_retention_policy(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "ck"), max_to_keep=2)
    for s in (1, 2, 3, 4):
        mgr.save(s, {"x": torch.ones(2) * s}, wait=True)
    steps = mgr.all_steps()
    assert steps[-1] == 4 and len(steps) <= 2
    assert not os.path.exists(tmp_path / "ck" / "mx-leaves-1.json")
    skip = CheckpointManager(str(tmp_path / "every3"), save_interval_steps=3)
    assert [skip.save(s, {"x": torch.ones(1)}) for s in (1, 2, 3)] == [False, False, True]
    assert skip.save(4, {"x": torch.ones(1)}, force=True)
    assert skip.all_steps() == [3, 4]


def test_trainer_checkpoint_resume(tmp_path):
    x, y = _data()
    tr = _make_trainer()
    first = [float(tr.step(x, y)) for _ in range(3)]
    mgr = CheckpointManager(str(tmp_path / "ck"))
    save_trainer(mgr, tr, wait=True)
    expect = [float(tr.step(x, y)) for _ in range(2)]
    tr2 = _make_trainer()
    restore_trainer(mgr, tr2)
    assert tr2._t == 3 and tr2.optimizer.num_update == 3
    got = [float(tr2.step(x, y)) for _ in range(2)]
    np.testing.assert_allclose(got, expect, rtol=1e-5)
    assert set(trainer_state(tr2)) >= {"params", "opt_state", "step", "rng", "sched"}
    # the same trajectory as the reference's trainer
    import jax
    import jax.numpy as jnp
    import mxnet_tpu as mx
    from mxnet_tpu.parallel import DataParallelTrainer as RefDPT, make_mesh as ref_mesh
    net = mx.gluon.nn.Dense(4, in_units=8)
    net.initialize(ctx=mx.cpu())
    for k, p in net._collect_params_with_prefix().items():
        p.set_data(mx.nd.array(_make_trainer().net._collect_params_with_prefix()[k]
                               .data().asnumpy()))
    rt = RefDPT(net, lambda p, yy: jnp.mean((p.astype(jnp.float32) - yy) ** 2), "adam",
                {"learning_rate": 1e-2}, mesh=ref_mesh({"dp": 1},
                                                        devices=jax.devices("cpu")[:1]))
    rx, ry = mx.nd.array(x.asnumpy()), mx.nd.array(y.asnumpy())
    ref_losses = [float(rt.step(rx, ry)) for _ in range(5)]
    np.testing.assert_allclose(first + expect, ref_losses, rtol=1e-5)


def test_resume_or_init_elastic_boot(tmp_path):
    calls = {"n": 0}

    def init_fn():
        calls["n"] += 1
        return {"w": torch.zeros(2, 2), "step": np.int64(0)}

    d = str(tmp_path / "ck")
    mgr, state, start = resume_or_init(d, init_fn)
    assert start == 0 and calls["n"] == 1
    mgr.save(7, {"w": torch.ones(2, 2), "step": np.int64(7)}, wait=True)
    mgr.close()
    mgr2, state2, start2 = resume_or_init(d, init_fn)
    assert start2 == 8
    np.testing.assert_array_equal(np.asarray(state2["w"]), np.ones((2, 2)))
    assert isinstance(state2["w"], torch.Tensor) and int(np.asarray(state2["step"])) == 7
    mgr2.close()


def test_no_target_restore_is_sidecar_driven(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "ck"))
    state = {"w": torch.arange(4.0).reshape(2, 2),
             "nested": {"m": torch.ones(3), "k": np.int64(9)}}
    mgr.save(3, state, wait=True)
    side = tmp_path / "ck" / "mx-leaves-3.json"
    assert side.exists()
    got = mgr.restore()
    np.testing.assert_array_equal(np.asarray(got["w"]), np.arange(4.0).reshape(2, 2))
    assert int(np.asarray(got["nested"]["k"])) == 9
    os.remove(side)
    with pytest.warns(DeprecationWarning, match="sidecar"):
        got2 = mgr.restore()
    np.testing.assert_array_equal(np.asarray(got2["nested"]["m"]), np.ones(3))


def test_reshard_on_restore(tmp_path):
    """Saved as float32, restored like a target of another dtype (and the
    target's device): the placement comes from ``like``."""
    mgr = CheckpointManager(str(tmp_path / "ck"))
    w = torch.arange(16.0).reshape(4, 4)
    mgr.save(1, {"w": w}, wait=True)
    target = torch.zeros(4, 4, dtype=torch.float64)
    got = mgr.restore(1, like={"w": target})
    assert got["w"].dtype == torch.float64 and got["w"].device == target.device
    np.testing.assert_array_equal(got["w"].numpy(), w.numpy())


def test_restore_without_checkpoint_raises(tmp_path):
    with pytest.raises(mt.MXNetError, match="no checkpoint"):
        CheckpointManager(str(tmp_path / "empty")).restore()
