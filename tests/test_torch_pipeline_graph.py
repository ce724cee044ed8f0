"""``PipelineTrainer``'s step as a CUDA graph: its eager reasons, its counts
under replay, and (on the card) captured against eager.

The reference compiles the whole pipeline step into one jit
(``mxnet_tpu/parallel/pipeline.py:296``, ``:1092-1116``); the port captures
``step`` through ``engine.capture`` with ``DataParallelTrainer``'s lifecycle
(warm-up, capture, replays). Here:

- ``_eager_reason``: ``"cpu"`` on the CPU; on a card (the device stood in
  for) None for 1F1B, GPipe with and without remat, interleaved stages and
  partitioned tp at tp 1 without dropout; ``"remat_dropout"`` for GPipe
  with remat over a Dropout above 0; ``"keyed_dropout"`` for partitioned tp
  with dropout; ``"gloo"`` on a world-1 gloo group;
- a replay simulated on the CPU (a stand-in capture runs the body once
  with the engine's counter bookkeeping, its graph's replay runs nothing):
  ``last_stats`` is the captured step's on every replay, a collective the
  step counts in ``comm_stats`` is taken back after the capture and added
  at each replay, and ``p2p_stats``' sends likewise; the warm-up, capture
  and replay lifecycle (one capture, a replay a step after it);
- ``gpu``-marked (``pytest -m gpu --noconftest`` on the card): captured
  against eager (``_graph_reason`` set to a string), bitwise over 4 steps
  on a 2-layer BERT at T 64 with K1-K3 on the path
  (``MXNET_FLASH_ATTENTION_MIN_SEQ`` 16): losses, weights, Adam's state,
  and K1-K3 and K5 launches per step, replays counted: 1F1B (with dropout
  0.1 from the registered generator), GPipe with remat, interleaved v 2.
"""
import contextlib

import numpy as np
import pytest
import torch

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import _dist_util, engine
from mxnet_tpu_torch.convert import load_jax_params, seeded_params
from mxnet_tpu_torch.models import BertModel
from mxnet_tpu_torch.parallel import PipelineTrainer, make_mesh
from torch_threads import one_torch_thread  # noqa: F401

CFG = dict(vocab_size=64, num_layers=2, units=32, hidden_size=64, num_heads=2,
           max_length=64)
B, T, M = 4, 16, 2


@pytest.fixture(scope="module")
def weights():
    net = BertModel(**CFG)
    net.initialize(ctx=mt.cpu())
    return seeded_params(net, seed=7)


def _net(weights, ctx, dropout=0.0):
    net = BertModel(**dict(CFG, dropout=dropout))
    net.initialize(ctx=ctx)
    load_jax_params(net, weights)
    return net


def _trainer(net, ctx, axes=None, **kw):
    return PipelineTrainer(net, mt.gluon.loss.SoftmaxCrossEntropyLoss(), "adam",
                           {"learning_rate": 1e-3},
                           mesh=make_mesh(axes or {"pp": 1}, devices=[ctx]),
                           num_microbatch=M, **kw)


def _xy(ctx, t=T, seed=0):
    rs = np.random.RandomState(seed)
    return (mt.nd.array(rs.randint(0, CFG["vocab_size"], (B, t)).astype(np.int32), ctx=ctx,
                        dtype="int32"),
            mt.nd.array(rs.randint(0, CFG["vocab_size"], (B, t)).astype(np.int32), ctx=ctx,
                        dtype="int32"))


class _Card:
    device_type = "gpu"


CASES = {
    "1f1b": (0.0, {}, None),
    "1f1b_dropout": (0.1, {}, None),
    "gpipe_remat": (0.0, dict(schedule="gpipe"), None),
    "gpipe_remat_dropout": (0.1, dict(schedule="gpipe"), "remat_dropout"),
    "gpipe_noremat_dropout": (0.1, dict(schedule="gpipe", remat=False), None),
    "interleaved_v2": (0.0, dict(virtual_stages=2), None),
    "partitioned_tp1": (0.0, dict(tp_axis="tp", tp_mode="partitioned"), None),
    "partitioned_tp1_dropout": (0.1, dict(tp_axis="tp", tp_mode="partitioned"),
                                "keyed_dropout"),
    "partitioned_tp1_zero": (0.0, dict(tp_axis="tp", dp_axis="dp", tp_mode="partitioned",
                                   zero_update=True), None),
}


@pytest.mark.parametrize("case", list(CASES))
def test_eager_reason(weights, case, monkeypatch):
    """``"cpu"`` on the CPU; on a card the named reason of the case, or
    None: the step is captured."""
    dropout, kw, want = CASES[case]
    axes = {"pp": 1, "tp": 1, "dp": 1} if "tp_axis" in kw else None
    tr = _trainer(_net(weights, mt.cpu(), dropout), mt.cpu(), axes, **kw)
    assert tr._eager_reason() == "cpu" and not tr.captured
    monkeypatch.setattr(tr, "device", _Card())
    assert tr._eager_reason() == want


def test_eager_reason_gloo(weights, tmp_path, monkeypatch):
    """A mesh of ranks whose group is gloo runs eagerly ("gloo")."""
    _dist_util.init_process_group(device="cpu", backend="gloo", rank=0, world_size=1,
                                  init_method=f"file://{tmp_path / 'rdzv'}")
    try:
        tr = _trainer(_net(weights, mt.cpu()), mt.cpu())
        assert tr.mesh.distributed
        monkeypatch.setattr(tr, "device", _Card())
        assert tr._eager_reason() == "gloo"
    finally:
        _dist_util.destroy_process_group()


class _NoGraph:
    """A stand-in CUDA graph whose replay runs nothing."""

    def replay(self):
        pass


def _stand_in_capture(fn, key, device, owner, ptrs=None, pool=None):
    """``engine.capture``'s bookkeeping on the CPU: ``fn`` runs once (the
    capture), what it counted is taken back and becomes the entry's deltas,
    which each replay adds."""
    before = engine._snapshot()
    try:
        with engine.compile_timer():
            outputs = fn()
    finally:
        deltas = engine._deltas(before, engine._snapshot())
        engine._restore(before)
    return engine.insert(key, engine.GraphEntry(_NoGraph(), outputs, deltas, [], 0.0, 0,
                                                owner, ptrs))


def test_simulated_replay_counts(weights, monkeypatch):
    """Warm-up, capture, replays: ``last_stats`` is the captured step's on
    every replay; a collective counted in the step (a stand-in ``count_comm``
    of 100 bytes) and a point-to-point send reach ``comm_stats`` and
    ``p2p_stats`` once a step in every mode, the capture's taken back."""
    tr = _trainer(_net(weights, mt.cpu()), mt.cpu())
    monkeypatch.setattr(engine, "capture", _stand_in_capture)
    monkeypatch.setattr(engine, "side_stream", lambda device: contextlib.nullcontext())
    tr._graph_reason = None
    real = tr._forward_backward

    def counted(xs, ys):
        _dist_util.count_comm("probe_all_reduce", "dp", 100)
        _dist_util.p2p_stats["sends"] += 1
        return real(xs, ys)
    monkeypatch.setattr(tr, "_forward_backward", counted)
    x, y = _xy(mt.cpu())
    engine.reset_stats()
    key = ("probe_all_reduce", "dp")
    c0 = list(_dist_util.comm_stats.get(key, [0, 0]))
    s0 = _dist_util.p2p_stats["sends"]
    stats = []
    for i in range(5):
        tr.step(x, y)
        stats.append(tr.last_stats)
        got = _dist_util.comm_stats[key]
        assert (got[0] - c0[0], got[1] - c0[1]) == (i + 1, 100 * (i + 1)), i
        assert _dist_util.p2p_stats["sends"] - s0 == i + 1, i
    st = engine.cache_stats()
    assert (st["captures"], st["replays"]) == (1, 4), st
    assert stats[1]["comm"] == {"probe_all_reduce@dp": {"calls": 1, "bytes": 100}}
    assert all(s == stats[1] for s in stats[1:]) and stats[0] == stats[1]
    assert stats[2] is not stats[1]          # each replay reports a copy
    assert stats[1]["ticks"] == M and stats[1]["max_in_flight"] == 1


# -- on the card ----------------------------------------------------------------------

def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run on the card")
    return mt.gpu(0)


GPU_CASES = {"1f1b_dropout": (0.1, {}, (1, 1)),
             "gpipe_remat": (0.0, dict(schedule="gpipe"), (2, 1)),
             "interleaved_v2": (0.0, dict(virtual_stages=2), (1, 1))}


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(GPU_CASES))
def test_gpu_captured_equals_eager(weights, case, monkeypatch):
    """4 steps captured (warm-up, capture + replay, replays) against the
    same trainer run eagerly, from the same seed: bitwise losses, weights
    and Adam state; K1 (twice a layer and microbatch under remat), K2/K3
    once and K5 once a step in both modes."""
    from mxnet_tpu_torch.ops.cuda import flash_attention as fa
    from mxnet_tpu_torch.ops.cuda import fused_optimizer as fo
    monkeypatch.setenv("MXNET_FLASH_ATTENTION_MIN_SEQ", "16")
    ctx = _cuda()
    dropout, kw, (k1, k23) = GPU_CASES[case]
    x, y = _xy(ctx, t=64)
    runs = {}
    for mode in ("captured", "eager"):
        mt.random.seed(3)
        net = _net(weights, ctx, dropout)
        tr = _trainer(net, ctx, **kw)
        assert tr.captured
        if mode == "eager":
            tr._graph_reason = "eager yardstick"
        engine.reset_stats()
        counts = (fa.flash_attention_fwd, fa.flash_attention_bwd_dq, fo.fused_adam_update)
        for f in counts:
            f.launches = 0
        losses = [float(tr.step(x, y)) for _ in range(4)]
        tr.sync()
        runs[mode] = (losses, {k: p.data().asnumpy() for k, p in
                               net._collect_params_with_prefix().items()},
                      [torch.cat([s.reshape(-1) for s in st]).cpu()
                       for _, _, ss in tr._groups.values() for st in ss],
                      [f.launches for f in counts], engine.cache_stats()["captures"])
    cap, eag = runs["captured"], runs["eager"]
    assert cap[0] == eag[0]
    for k, w in eag[1].items():
        np.testing.assert_array_equal(cap[1][k], w, err_msg=k)
    for a, b in zip(cap[2], eag[2]):
        assert torch.equal(a, b)
    layers = CFG["num_layers"]
    assert cap[3] == eag[3] == [4 * layers * M * k1, 4 * layers * M * k23, 4], (cap[3], eag[3])
    assert (cap[4], eag[4]) == (1, 0)
