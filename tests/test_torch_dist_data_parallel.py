"""The port's distributed training step against the reference's, on the CPU.

``dryrun_multichip``'s step (``__graft_entry__.py:93-128``): a
``bert_tiny(vocab_size=512, head_major_qkv=True)`` with Megatron specs
(``shard_params_megatron``) trained with Adam through
``DataParallelTrainer(data_spec=P("dp", "sp"))``, B = 4, T = 128. The port
runs in ranks of ``torch.distributed`` over gloo, spawned by
``_dist_util.launch_local`` (one spawn per layout, ``file://`` rendezvous, a
120 s join timeout); each rank imports only the port and this module (which
imports the reference only inside its fixtures) and exchanges numpy files
with the test under ``tmp_path``. The reference runs in the test process on
conftest's virtual CPU devices, on the same layout of devices.

- dp1 x tp2 x sp2 (world 4) and dp2 (world 2): the 3 losses against the
  reference's to ``TOL_LOSS``; the gathered gradients after the first step
  against the reference's gradient of the same global-mean loss (its
  autograd on the whole batch) to ``TOL_GRAD`` of each tensor's max; the
  gathered weights after 3 steps to ``TOL_W``.
- dp1 x tp2 (world 2) under LAMB and under LARS: the same three checks, and
  each weight's change over the 3 steps against the reference's change to
  ``TOL_DW`` of its max. The reference's trust-ratio norms are the whole
  tensor's; norms over a rank's own shard change a sharded weight by
  another ratio, which only the change shows.
- The traps, each a case here that fails on a mutated copy of the port
  (CHANGES.md names the mutations): the row-parallel bias added once,
  positions offset under sp, the global loss mean, and the gradient
  reduction over the data axes only.

Tolerances (float32, only the order of summation differs): loss 1e-5
relative and weights 2e-5 absolute, as ``tests/test_torch_data_parallel.py``;
gradients 1e-4 of each tensor's max; a weight's change 2e-3 of its max (the
largest under LAMB 6.2e-4, from elements whose gradient is near LAMB's eps;
with each rank's norms over its shard alone 4.0e-2 and more under LAMB,
1.5e-1 under LARS).
"""
import numpy as np
import pytest
import torch

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import _dist_util
from mxnet_tpu_torch.convert import gather_grads, gather_params, load_jax_params, \
    seeded_params
from mxnet_tpu_torch.models import bert_tiny
from mxnet_tpu_torch.parallel import DataParallelTrainer, P, make_mesh, \
    shard_params_megatron
from torch_threads import one_torch_thread  # noqa: F401

VOCAB = 512
B, T = 4, 128
STEPS = 3
LR = 1e-3
TOL_LOSS = 1e-5
TOL_W = 2e-5
TOL_GRAD = 1e-4
TOL_DW = 2e-3
MODULE = "test_torch_dist_data_parallel"
TESTS_DIR = str(__import__("pathlib").Path(__file__).resolve().parent)


def token_ce(logits, labels):
    """Mean token cross-entropy in f32 (the dryrun's ``loss_fn``), per token."""
    logits = logits.float()
    return torch.nn.functional.cross_entropy(
        logits.reshape(-1, logits.shape[-1]), labels.reshape(-1).long(),
        reduction="none")


def _data(seed=5):
    rs = np.random.RandomState(seed)
    return (rs.randint(0, VOCAB, size=(B, T)).astype(np.int32),
            rs.randint(0, VOCAB, size=(B, T)).astype(np.int32))


def rank_bert_steps(workdir, axes, steps, optimizer, opt_params):
    """One rank: the dryrun's step ``steps`` times on ``axes`` under
    ``optimizer`` (a name) with ``opt_params``; rank 0
    writes the gathered gradients after the first step and the gathered
    weights after the last. Returns the losses and the modules loaded."""
    import sys
    weights = dict(np.load(f"{workdir}/weights.npz"))
    data = np.load(f"{workdir}/data.npz")
    ctx = mt.cpu()
    mesh = make_mesh(axes, devices=[ctx])
    net = bert_tiny(vocab_size=VOCAB, head_major_qkv=True)
    net.initialize(ctx=ctx)
    load_jax_params(net, weights)
    if axes.get("tp", 1) > 1:
        shard_params_megatron(net, axis="tp")
    spec = P("dp", "sp") if "sp" in axes else P("dp")
    tr = DataParallelTrainer(net, token_ce, optimizer, opt_params, mesh=mesh,
                             data_spec=spec)
    x = mt.nd.array(data["x"], ctx=ctx, dtype="int32")
    y = mt.nd.array(data["y"], ctx=ctx, dtype="int32")
    losses = []
    for i in range(steps):
        losses.append(float(tr.step(x, y)))
        if i == 0:
            grads = gather_grads(net)
            if mesh.rank == 0:
                np.savez(f"{workdir}/grads.npz", **grads)
    params = gather_params(net)
    if mesh.rank == 0:
        np.savez(f"{workdir}/params.npz", **params)
    state = tr.state_dict()
    state_ok = state["num_update"] == steps and all(
        np.array_equal(state["params"][k].numpy(), v) for k, v in params.items()) and all(
        all(t.shape == params[k].shape for t in st) for k, st in state["opt_state"].items())
    shapes = {k: list(p._param.shape) for k, p in net._collect_params_with_prefix().items()}
    local = [list(tr._local(tr._raw(a)).shape) for a in (x, y)]
    return {"losses": losses, "coords": dict(mesh.coords), "shapes": shapes, "local": local,
            "state_dict_full": bool(state_ok),
            "modules": sorted(m for m in sys.modules
                              if m.split(".")[0] in ("jax", "jaxlib", "mxnet_tpu"))}


LAYOUTS = {"tp_sp": {"dp": 1, "tp": 2, "sp": 2}, "dp": {"dp": 2},
           "tp_lamb": {"dp": 1, "tp": 2}, "tp_lars": {"dp": 1, "tp": 2}}
# the optimizer of each layout, Adam where none is named; LARS's step is
# lr * eta * |w| a tensor, so its lr is larger than Adam's
OPTIMIZERS = {"tp_lamb": ("lamb", {"learning_rate": LR}),
              "tp_lars": ("lars", {"learning_rate": 1.0, "momentum": 0.9})}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The weights and data; the reference's losses and weights after 3
    steps on each layout and its gradient of the same loss at the initial
    weights; the port's ranks on each layout (one spawn each)."""
    import jax
    import jax.numpy as jnp
    import mxnet_tpu as mx
    from mxnet_tpu.models import bert_tiny as ref_bert_tiny
    from mxnet_tpu.parallel import DataParallelTrainer as RefDPT, make_mesh as ref_mesh, \
        shard_params_megatron as ref_shard, P as RP

    port = bert_tiny(vocab_size=VOCAB, head_major_qkv=True)
    port.initialize(ctx=mt.cpu())
    weights = seeded_params(port, seed=3)
    x, y = _data()

    def loss_fn(logits, labels):
        logits = logits.astype(jnp.float32)
        logz = jax.nn.logsumexp(logits, axis=-1)
        gold = jnp.take_along_axis(logits, labels[..., None].astype(jnp.int32),
                                   axis=-1)[..., 0]
        return jnp.mean(logz - gold)

    def ref_net():
        net = ref_bert_tiny(vocab_size=VOCAB, head_major_qkv=True)
        net.initialize(ctx=mx.cpu())
        for key, p in net._collect_params_with_prefix().items():
            p.set_data(mx.nd.array(weights[key], ctx=mx.cpu()))
        return net

    net = ref_net()
    with mx.autograd.record():
        loss = mx.gluon.loss.SoftmaxCrossEntropyLoss()(
            net(mx.nd.array(x, dtype="int32")), mx.nd.array(y, dtype="int32")).mean()
    loss.backward()
    out = {"init": weights,
           "grads": {k: p.grad().asnumpy()
                     for k, p in net._collect_params_with_prefix().items()}}
    devs = jax.devices("cpu")
    for name, axes in LAYOUTS.items():
        net = ref_net()
        if axes.get("tp", 1) > 1:
            ref_shard(net, axis="tp")
        n = int(np.prod(list(axes.values())))
        opt, opt_params = OPTIMIZERS.get(name, ("adam", {"learning_rate": LR}))
        tr = RefDPT(net, loss_fn, optimizer=opt, optimizer_params=opt_params,
                    mesh=ref_mesh(axes, devices=devs[:n]), batch_axis_name="dp",
                    data_spec=RP("dp", "sp") if "sp" in axes else RP("dp"))
        xr, yr = mx.nd.array(x, dtype="int32"), mx.nd.array(y, dtype="int32")
        losses = [float(tr.step(xr, yr)) for _ in range(STEPS)]
        tr.sync()
        root = tmp_path_factory.mktemp(name)
        np.savez(root / "weights.npz", **weights)
        np.savez(root / "data.npz", x=x, y=y)
        ranks = _dist_util.launch_local(
            f"{MODULE}:rank_bert_steps", n,
            {"workdir": str(root), "axes": axes, "steps": STEPS, "optimizer": opt,
             "opt_params": opt_params},
            device="cpu", timeout=120, pythonpath=[TESTS_DIR], workdir=str(root / "launch"))
        out[name] = {"ref_losses": np.array(losses),
                     "ref_params": {k: p.data().asnumpy()
                                    for k, p in net._collect_params_with_prefix().items()},
                     "ranks": ranks, "grads": dict(np.load(root / "grads.npz")),
                     "params": dict(np.load(root / "params.npz"))}
    return out


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_losses_match_reference(runs, layout):
    """Every rank returns the global mean: a rank that returned its own
    mean, or whose positions did not start at its first token, fails."""
    r = runs[layout]
    for rank in r["ranks"]:
        np.testing.assert_allclose(rank["losses"], r["ref_losses"], rtol=TOL_LOSS)
    assert r["ref_losses"][-1] < r["ref_losses"][0]


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_first_step_gradients_match_reference(runs, layout):
    """The reduced gradients after step 1, gathered: a sum over tp (the
    replicated parameters' gradients doubled), a row-parallel bias added by
    every tp rank, or each rank's loss mean taken as the global one, fails."""
    got, ref = runs[layout]["grads"], runs["grads"]
    assert set(got) == set(ref)
    for key, g in ref.items():
        scale = max(float(np.abs(g).max()), 1e-30)
        assert np.abs(got[key] - g).max() <= TOL_GRAD * scale, key


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_weights_match_reference(runs, layout):
    r = runs[layout]
    assert set(r["params"]) == set(r["ref_params"])
    for key, w in r["ref_params"].items():
        assert np.abs(r["params"][key] - w).max() <= TOL_W, key


@pytest.mark.parametrize("layout", list(OPTIMIZERS))
def test_trust_ratio_norms_span_the_shards(runs, layout):
    """Each weight's change over the steps against the reference's: a
    sharded weight whose LAMB/LARS norms were its rank's shard's alone
    takes another trust ratio on each tp rank."""
    r, init = runs[layout], runs["init"]
    for key, w in r["ref_params"].items():
        ref = w - init[key]
        scale = max(float(np.abs(ref).max()), 1e-30)
        assert np.abs(r["params"][key] - init[key] - ref).max() <= TOL_DW * scale, key


def test_ranks_take_their_part_of_the_batch(runs):
    """``data_spec`` splits the global (B, T) batch: rows over dp, columns
    over sp. (A rank that took the whole batch would still match the losses
    and gradients: its share weighting would undo the sum.)"""
    for layout, part in (("tp_sp", [B, T // 2]), ("dp", [B // 2, T])):
        for rank in runs[layout]["ranks"]:
            assert rank["local"] == [part, part]


def test_state_dict_gathers_the_shards(runs):
    """``DataParallelTrainer.state_dict`` gives every parameter and Adam
    state at its full shape, the parameters equal to ``gather_params``'."""
    for layout in LAYOUTS:
        assert all(r["state_dict_full"] for r in runs[layout]["ranks"])


def test_ranks_hold_their_shards(runs):
    """Under tp=2 each rank holds half of every sharded tensor (the
    row-parallel weights copied into storage of their own) and the whole of
    the others; the coordinates are the row-major order of (dp, tp, sp)."""
    ranks = runs["tp_sp"]["ranks"]
    assert [r["coords"] for r in ranks] == [
        {"dp": 0, "tp": t, "sp": s} for t in (0, 1) for s in (0, 1)]
    shapes = ranks[0]["shapes"]
    C = 128
    assert shapes["encoder.layers.0.attn.qkv.weight"] == [3 * C // 2, C]
    assert shapes["encoder.layers.0.attn.qkv.bias"] == [3 * C // 2]
    assert shapes["encoder.layers.0.attn.proj.weight"] == [C, C // 2]
    assert shapes["encoder.layers.0.attn.proj.bias"] == [C]
    assert shapes["encoder.layers.0.ffn.ffn1.weight"] == [4 * C // 2, C]
    assert shapes["encoder.layers.0.ffn.ffn2.weight"] == [C, 4 * C // 2]
    assert shapes["word_embed.weight"] == [VOCAB // 2, C]
    assert shapes["mlm_decoder.weight"] == [VOCAB, C]
    assert shapes["pos_embed.weight"] == [512, C]


# -- the launcher and the backend rule ------------------------------------------

def rank_fails_or_hangs(how):
    """Rank 1 raises or sleeps; rank 0 returns (and then waits for rank 1 at
    the launcher's closing barrier)."""
    import time
    import torch.distributed as dist
    if dist.get_rank() == 1:
        if how == "raise":
            raise RuntimeError("rank 1 fails on purpose")
        time.sleep(600)
    return dist.get_rank()


@pytest.mark.parametrize("how,match", [("raise", r"rank\(s\) \[.*1\] failed"),
                                       ("hang", r"rank\(s\) \[.*1\] still running after 8 s")])
def test_launcher_raises_when_a_rank_fails_or_hangs(tmp_path, how, match):
    # "raise" ends as soon as rank 1 exits, so its long timeout costs nothing when
    # it works and covers rank 1's start (importing torch, joining the group) on a
    # loaded host; "hang" waits out its 8 s
    with pytest.raises(mt.MXNetError, match=match) as err:
        _dist_util.launch_local(f"{MODULE}:rank_fails_or_hangs", 2, {"how": how},
                                device="cpu", timeout=120 if how == "raise" else 8,
                                pythonpath=[TESTS_DIR], workdir=str(tmp_path))
    if how == "raise":
        assert "rank 1 fails on purpose" in str(err.value)


def test_backend_rule_and_environment(monkeypatch):
    assert _dist_util.choose_backend("cpu", 8, 0) == "gloo"
    assert _dist_util.choose_backend("gpu", 1, 1) == "nccl"
    assert _dist_util.choose_backend("gpu", 4, 4) == "nccl"
    assert _dist_util.choose_backend("gpu", 8, 1) == "gloo"      # ranks share a card
    for name in ("MXNET_TPU_RANK", "MXNET_TPU_NUM_WORKERS", "MXNET_TPU_COORDINATOR",
                 "DMLC_WORKER_ID", "DMLC_NUM_WORKER", "DMLC_PS_ROOT_URI",
                 "DMLC_PS_ROOT_PORT", "LOCAL_RANK"):
        monkeypatch.delenv(name, raising=False)
    assert (_dist_util.env_rank(), _dist_util.env_world_size(),
            _dist_util.env_init_method()) == (0, 1, None)
    monkeypatch.setenv("DMLC_WORKER_ID", "3")
    monkeypatch.setenv("DMLC_NUM_WORKER", "4")
    monkeypatch.setenv("DMLC_PS_ROOT_URI", "10.0.0.2")
    monkeypatch.setenv("DMLC_PS_ROOT_PORT", "9000")
    assert (_dist_util.env_rank(), _dist_util.env_world_size(),
            _dist_util.env_init_method()) == (3, 4, "tcp://10.0.0.2:9000")
    monkeypatch.setenv("MXNET_TPU_RANK", "1")                    # the port's names first
    monkeypatch.setenv("MXNET_TPU_COORDINATOR", "file:///tmp/rdv")
    assert (_dist_util.env_rank(), _dist_util.env_init_method()) == (1, "file:///tmp/rdv")
    with pytest.raises(mt.MXNetError, match="outside a world"):
        _dist_util.init_process_group(device="cpu", rank=5, world_size=4,
                                      init_method="file:///unused")
