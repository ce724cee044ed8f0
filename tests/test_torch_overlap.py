"""The backward-overlapped gradient reduction against the reference's, on the CPU.

``mxnet_tpu_torch.parallel.overlap`` and ``DataParallelTrainer(overlap_grads=
True)`` against ``mxnet_tpu.parallel.overlap`` and the reference's trainer on
a one-device mesh ``make_mesh({"dp": 1})``, the same seeded weights and
numpy batches:

- ``chain_blocks`` / ``plan_segments`` give the same segment names, used and
  owned slots and ``boundaries`` for BERT (``pipeline_split()``), a
  ``HybridSequential`` and a model-zoo ResNet (``features`` + ``output``);
- ``allreduce_wire_bytes`` gives the same numbers over the same bucket plan;
- the overlapped trajectory over 10 steps (SGD and Adam) matches the
  reference's overlapped step, on a one-device mesh and on a world-1 gloo
  process group where the segment-aligned buckets (ZeRO's and the
  replicated step's) are reduced during the backward; and the port's
  overlapped step matches its plain step;
- the refusals and the environment's fallback behave as the reference's.

Tolerances: the reference's own for the trajectories (rtol 1e-4, atol 1e-5;
``tests/test_overlap_dp.py:128-134``); the plans and wire bytes exactly.
"""
import warnings

import numpy as np
import pytest
import torch

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import _dist_util
from mxnet_tpu_torch.convert import load_jax_params, seeded_params
from mxnet_tpu_torch.models import BertModel
from mxnet_tpu_torch.parallel import DataParallelTrainer, make_mesh
from mxnet_tpu_torch.parallel import overlap as ov
from mxnet_tpu_torch.parallel import zero as zero_mod
from torch_threads import one_torch_thread  # noqa: F401

CFG = dict(vocab_size=512, num_layers=2, units=64, hidden_size=128, num_heads=2,
           max_length=64)
RTOL, ATOL = 1e-4, 1e-5


@pytest.fixture(scope="module")
def ref():
    import mxnet_tpu as mx
    from mxnet_tpu.parallel import DataParallelTrainer as RefDPT, make_mesh as ref_mesh
    from mxnet_tpu.parallel import overlap as ref_ov
    return mx, RefDPT, ref_mesh, ref_ov


@pytest.fixture
def world1(tmp_path):
    """A world-1 gloo process group on the CPU: the mesh is one of ranks."""
    _dist_util.init_process_group(device="cpu", backend="gloo", rank=0, world_size=1,
                                  init_method=f"file://{tmp_path / 'rdzv'}")
    yield
    _dist_util.destroy_process_group()


def _mlp(pkg, seed, width=32, depth=3):
    net = pkg.gluon.nn.HybridSequential()
    units = 16
    for _ in range(depth):
        net.add(pkg.gluon.nn.Dense(width, activation="relu", in_units=units))
        units = width
    net.add(pkg.gluon.nn.Dense(4, in_units=units))
    net.initialize(ctx=pkg.cpu())
    rs = np.random.RandomState(seed)
    for key, p in sorted(net._collect_params_with_prefix().items()):
        p.set_data(pkg.nd.array((0.3 * rs.standard_normal(p.shape)).astype(np.float32),
                                ctx=pkg.cpu()))
    return net


def _mlp_batch(seed=0, n=16):
    rs = np.random.RandomState(seed)
    return (rs.uniform(-1, 1, (n, 16)).astype(np.float32),
            rs.randint(0, 4, (n,)).astype(np.int32))


def _bert_pair(mx, seed):
    from mxnet_tpu.models.bert import BertModel as RefBert
    weights = seeded_params(BertModel(**CFG), seed=seed)
    port = BertModel(**CFG)
    port.initialize(ctx=mt.cpu())
    load_jax_params(port, weights)
    refnet = RefBert(**CFG)
    refnet.initialize(ctx=mx.cpu())
    for key, p in refnet._collect_params_with_prefix().items():
        p.set_data(mx.nd.array(weights[key], ctx=mx.cpu()))
    return port, refnet


def _zoo_pair(mx):
    """A narrow model-zoo ResNet in both packages, its shapes made by one
    forward on a small image."""
    from mxnet_tpu.gluon.model_zoo.vision.resnet import (ResNetV1 as RefResNet,
                                                          BasicBlockV1 as RefBlock)
    from mxnet_tpu_torch.gluon.model_zoo.vision.resnet import ResNetV1, BasicBlockV1
    port = ResNetV1(BasicBlockV1, [1, 1, 1, 1], [8, 8, 16, 16, 32], classes=4)
    port.initialize(ctx=mt.cpu())
    port(mt.nd.zeros((1, 3, 16, 16), ctx=mt.cpu()))
    refnet = RefResNet(RefBlock, [1, 1, 1, 1], [8, 8, 16, 16, 32], classes=4)
    refnet.initialize(ctx=mx.cpu())
    refnet.hybridize()
    refnet(mx.nd.zeros((1, 3, 16, 16)))
    return port, refnet


def _plan_tuple(plan):
    return ([(s.index, s.names, s.uses, s.owned) for s in plan.segments], plan.boundaries)


@pytest.mark.parametrize("kind", ["bert", "sequential", "zoo"])
def test_chain_and_plan_match_reference(ref, kind):
    mx, _, _, ref_ov = ref
    if kind == "bert":
        port, refnet = _bert_pair(mx, 0)
    elif kind == "sequential":
        port, refnet = _mlp(mt, 0), _mlp(mx, 0)
    else:
        port, refnet = _zoo_pair(mx)
    pnames = [n for n, _ in ov.chain_blocks(port)]
    assert pnames == [n for n, _ in ref_ov.chain_blocks(refnet)]
    pl = [p for p in port.collect_params().values() if p._param is not None]
    rl = [p for p in refnet.collect_params().values() if p._data is not None]
    assert [p._param.numel() for p in pl] == [int(p._data.size) for p in rl]
    for k in (2, 3, 4, 99):
        assert _plan_tuple(ov.plan_segments(port, pl, k)) == \
            _plan_tuple(ref_ov.plan_segments(refnet, rl, k)), (kind, k)


def test_allreduce_wire_bytes_match_reference(ref):
    import jax.numpy as jnp
    from mxnet_tpu.parallel import zero as ref_zero
    _, _, _, ref_ov = ref
    shapes = [(300, 7), (64,), (1000,), (33, 33), (5,)]
    for ndp in (1, 2, 4, 8):
        pb = zero_mod.plan_buckets([(i, s, torch.float32) for i, s in enumerate(shapes)],
                                   ndp, 4096, boundaries=(2, 4))
        rb = ref_zero.plan_buckets([(i, s, jnp.float32) for i, s in enumerate(shapes)],
                                   ndp, 4096, boundaries=(2, 4))
        for comm in (None, "bfloat16", "int8"):
            assert ov.allreduce_wire_bytes(pb, ndp, comm) == \
                ref_ov.allreduce_wire_bytes(rb, ndp, comm), (ndp, comm)


def _steps(tr, x, y, n):
    return [float(tr.step(x, y)) for _ in range(n)]


def _ref_mlp_trainer(ref, optimizer, zero, overlap, lr=0.01):
    mx, RefDPT, ref_mesh, _ = ref
    import jax
    import jax.numpy as jnp

    def loss_fn(logits, labels):
        logits = logits.astype(jnp.float32)
        logz = jax.nn.logsumexp(logits, axis=-1)
        gold = jnp.take_along_axis(logits, labels[:, None].astype(jnp.int32), axis=-1)[:, 0]
        return jnp.mean(logz - gold)

    net = _mlp(mx, 0)
    return net, RefDPT(net, loss_fn, optimizer, {"learning_rate": lr},
                       mesh=ref_mesh({"dp": 1}), zero_update=zero, overlap_grads=overlap,
                       bucket_bytes=1024)


def _port_mlp_trainer(optimizer, zero, overlap, lr=0.01, **kw):
    net = _mlp(mt, 0)
    return net, DataParallelTrainer(net, mt.gluon.loss.SoftmaxCrossEntropyLoss(), optimizer,
                                    {"learning_rate": lr}, mesh=make_mesh({"dp": 1},
                                                                          devices=[mt.cpu()]),
                                    zero_update=zero, overlap_grads=overlap,
                                    bucket_bytes=1024, **kw)


def _weights(net):
    return [p.data().asnumpy() for p in net.collect_params().values()]


def _check_overlap_trajectory(ref, optimizer, zero):
    mx = ref[0]
    x, y = _mlp_batch()
    rnet, rt = _ref_mlp_trainer(ref, optimizer, zero, True)
    r_loss = _steps(rt, mx.nd.array(x), mx.nd.array(y, dtype="int32"), 10)
    rt.sync()
    pnet, pt = _port_mlp_trainer(optimizer, zero, True)
    assert pt._overlap and len(pt._overlap_plan) >= 2
    assert pt._overlap_plan.fingerprint == rt._overlap_plan.fingerprint
    xp, yp = mt.nd.array(x, ctx=mt.cpu()), mt.nd.array(y, ctx=mt.cpu(), dtype="int32")
    p_loss = _steps(pt, xp, yp, 10)
    np.testing.assert_allclose(p_loss, r_loss, rtol=RTOL, atol=ATOL)
    assert p_loss[-1] < p_loss[0]
    for i, (a, b) in enumerate(zip(_weights(pnet), _weights(rnet))):
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL, err_msg=f"param {i}")
    # the port's overlapped step against its own plain step
    qnet, qt = _port_mlp_trainer(optimizer, zero, False)
    np.testing.assert_allclose(_steps(qt, xp, yp, 10), p_loss, rtol=RTOL, atol=ATOL)
    for a, b in zip(_weights(qnet), _weights(pnet)):
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)
    return pt


@pytest.mark.parametrize("optimizer", ["sgd", "adam"])
@pytest.mark.parametrize("zero", [False, True])
def test_overlap_trajectory_matches_reference(ref, optimizer, zero):
    _check_overlap_trajectory(ref, optimizer, zero)


@pytest.mark.parametrize("optimizer", ["sgd", "adam"])
@pytest.mark.parametrize("zero", [False, True])
def test_overlap_buckets_on_a_rank_mesh(ref, world1, optimizer, zero):
    """On a world-1 gloo group the buckets are segment-aligned flat tensors
    (ZeRO's or the replicated step's) reduced as each segment finishes."""
    pt = _check_overlap_trajectory(ref, optimizer, zero)
    buckets = pt._zero_plan if zero else pt._overlap_buckets
    assert buckets and sorted(b for bs in pt._seg_buckets.values() for b in bs) == \
        list(range(len(buckets)))
    for s, bs in pt._seg_buckets.items():
        for b in bs:
            assert {pt._overlap_plan.segment_of_slot[i] for i in buckets[b].indices} == {s}


def test_overlap_bert_matches_reference(ref):
    """BERT's ``pipeline_split()`` chain: the overlapped Adam step against the
    reference's for 10 steps, and the weights after them."""
    mx, RefDPT, ref_mesh, _ = ref
    port, refnet = _bert_pair(mx, 1)
    rs = np.random.RandomState(3)
    x = rs.randint(0, CFG["vocab_size"], size=(2, 64)).astype(np.int32)
    y = rs.randint(0, CFG["vocab_size"], size=(2, 64)).astype(np.int32)
    pt = DataParallelTrainer(port, mt.gluon.loss.SoftmaxCrossEntropyLoss(), "adam",
                             {"learning_rate": 1e-3},
                             mesh=make_mesh({"dp": 1}, devices=[mt.cpu()]),
                             overlap_grads=True, overlap_segments=3)
    rt = RefDPT(refnet, mx.gluon.loss.SoftmaxCrossEntropyLoss(), "adam",
                {"learning_rate": 1e-3}, mesh=ref_mesh({"dp": 1}), overlap_grads=True,
                overlap_segments=3)
    assert pt._overlap_plan.fingerprint == rt._overlap_plan.fingerprint
    p_loss = _steps(pt, mt.nd.array(x, ctx=mt.cpu()),
                    mt.nd.array(y, ctx=mt.cpu(), dtype="int32"), 10)
    r_loss = _steps(rt, mx.nd.array(x), mx.nd.array(y, dtype="int32"), 10)
    rt.sync()
    np.testing.assert_allclose(p_loss, r_loss, rtol=RTOL, atol=ATOL)
    pw = {k: p.data().asnumpy() for k, p in port._collect_params_with_prefix().items()}
    for k, p in refnet._collect_params_with_prefix().items():
        np.testing.assert_allclose(pw[k], p.data().asnumpy(), rtol=RTOL, atol=ATOL,
                                   err_msg=k)


class _NoChain(mt.gluon.HybridBlock):
    def __init__(self):
        super().__init__()
        self.a = mt.gluon.nn.Dense(4, in_units=16)
        self.b = mt.gluon.nn.Dense(4, in_units=16)

    def hybrid_forward(self, F, x):
        return self.a(x) + self.b(x)


def _cpu_mesh():
    return make_mesh({"dp": 1}, devices=[mt.cpu()])


def test_refusals_and_env_fallback(ref, monkeypatch):
    """As the reference: an explicit ``overlap_grads=True`` on a net with no
    chain raises; overlap with compression raises; the environment's default
    falls back to the plain step with a warning; one owning segment is
    nothing to overlap."""
    loss = mt.gluon.loss.SoftmaxCrossEntropyLoss()
    net = _NoChain()
    net.initialize(ctx=mt.cpu())
    with pytest.raises(mt.MXNetError, match="no linear block chain"):
        DataParallelTrainer(net, loss, "sgd", mesh=_cpu_mesh(), overlap_grads=True)
    with pytest.raises(mt.MXNetError, match="incompatible with 2-bit"):
        DataParallelTrainer(_mlp(mt, 0), loss, "sgd", mesh=_cpu_mesh(), overlap_grads=True,
                            compression={"type": "2bit"})
    one = mt.gluon.nn.HybridSequential()
    one.add(mt.gluon.nn.Dense(4, in_units=16))
    one.initialize(ctx=mt.cpu())
    with pytest.raises(mt.MXNetError, match="nothing to overlap"):
        DataParallelTrainer(one, loss, "sgd", mesh=_cpu_mesh(), overlap_grads=True)
    monkeypatch.setenv("MXNET_TPU_OVERLAP_GRADS", "1")
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        tr = DataParallelTrainer(net, loss, "sgd", mesh=_cpu_mesh())
    assert not tr._overlap and tr._overlap_plan is None
    assert any("falling back" in str(w.message) for w in seen)
    tr2 = DataParallelTrainer(_mlp(mt, 0), loss, "sgd", mesh=_cpu_mesh())
    assert tr2._overlap and len(tr2._overlap_plan) >= 2
    monkeypatch.setenv("MXNET_TPU_OVERLAP_SEGMENTS", "2")
    assert len(DataParallelTrainer(_mlp(mt, 0), loss, "sgd",
                                   mesh=_cpu_mesh())._overlap_plan) == 2


def test_fingerprint_separates_overlap_and_segments():
    loss = mt.gluon.loss.SoftmaxCrossEntropyLoss()
    fps = {DataParallelTrainer(_mlp(mt, 0), loss, "sgd", mesh=_cpu_mesh(),
                               overlap_grads=o, overlap_segments=k)._program.fingerprint
           for o, k in ((False, 2), (True, 2), (True, 3))}
    assert len(fps) == 3


def test_accumulate_segment_grads_in_place():
    acc = torch.zeros(5)
    out = ov.accumulate_segment_grads(acc, torch.arange(5, dtype=torch.bfloat16))
    assert out is acc and acc.tolist() == [0.0, 1.0, 2.0, 3.0, 4.0]
