"""A masked ``SelfAttention`` under a sequence shard, against sp 1 and the reference.

The reference keeps a global view and adds the mask on the plain path
(``mxnet_tpu/models/bert.py:110-123``); its step shards the sequence through
``data_spec=P('dp', 'sp')`` (``mxnet_tpu/parallel/data_parallel.py:323-325``).
The port's ``SelfAttention`` under a shard of sp ranks computes its T/sp
query rows against the keys and values gathered over sp, the mask cut to
those rows. Two masks: a causal (T, T) mask (rank 1's rows need rank 0's
keys) and a key-padding (1, T) mask (no query axis: it broadcasts).

- Alone: ``SelfAttention(32, 2)`` on the same seeded input, its output and
  the gradients of sum(out * dy) with respect to the input and every weight,
  at sp 2 (2 gloo ranks on the CPU, their shards gathered and their weight
  gradients summed) against sp 1 (one process) and against the reference.
- Trained: a small net (embedding, the masked attention with a residual, a
  decoder) through ``DataParallelTrainer(data_spec=P("dp", "sp"))`` with
  Adam for 3 steps at dp 1 x sp 2 (the same 2 ranks) against the same
  trainer in one process and against the reference's trainer on a
  {dp: 1, sp: 2} mesh of CPU devices: the losses, the reduced gradients
  after step 1 (the reference's by ``jax.grad`` through the functional
  forward its step differentiates, ``_make_apply_fn``) and the weights
  after step 3.

Tolerance (float32; only the order of summation differs): 1e-5 of each
tensor's max for outputs and gradients, losses 1e-5 relative, weights 1e-5
of each tensor's max.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import _dist_util
from mxnet_tpu_torch.convert import gather_grads, gather_params, load_jax_params, \
    seeded_params
from mxnet_tpu_torch.models.bert import SelfAttention
from mxnet_tpu_torch.parallel import DataParallelTrainer, P, make_mesh
from torch_threads import one_torch_thread  # noqa: F401

VOCAB, U, H = 64, 32, 2
B, T, SP = 2, 16, 2
STEPS, LR = 3, 1e-2
TOL = 1e-5
MODULE = "test_torch_bert_sp_mask"
TESTS_DIR = str(__import__("pathlib").Path(__file__).resolve().parent)


def _masks():
    causal = np.tril(np.ones((T, T), np.float32))
    keypad = np.ones((1, T), np.float32)
    keypad[0, T - 5:] = 0.0                  # the last 5 keys are padding
    return {"causal": causal, "keypad": keypad}


def _data():
    rs = np.random.RandomState(11)
    return {"x": rs.standard_normal((B, T, U)).astype(np.float32),
            "dy": rs.standard_normal((B, T, U)).astype(np.float32),
            "tok": rs.randint(0, VOCAB, size=(B, T)).astype(np.int32),
            "lab": rs.randint(0, VOCAB, size=(B, T)).astype(np.int32)}


def token_ce(logits, labels):
    """Mean token cross entropy in f32, per token."""
    logits = logits.float()
    return torch.nn.functional.cross_entropy(
        logits.reshape(-1, logits.shape[-1]), labels.reshape(-1).long(), reduction="none")


def masked_lm_class(HybridBlock, nn, Attention, array):
    """The trained net of either package: embedding, ``x + attn(x, mask)``,
    decoder. ``array(mask, like)`` makes the mask an array of the package."""
    class MaskedLM(HybridBlock):
        def __init__(self, mask, **kw):
            super().__init__(**kw)
            self._mask = mask
            self.embed = nn.Embedding(VOCAB, U)
            self.attn = Attention(U, H)
            self.decoder = nn.Dense(VOCAB, flatten=False, in_units=U)

        def hybrid_forward(self, F, tokens):
            h = self.embed(tokens)
            h = h + self.attn(h, array(self._mask, h))
            return self.decoder(h)
    return MaskedLM


def _port_array(mask, like):
    return mt.nd.array(mask, ctx=like.ctx)


PortLM = masked_lm_class(mt.gluon.HybridBlock, mt.gluon.nn, SelfAttention, _port_array)


def _attention_alone(attn, x, dy, mask, mesh=None):
    """out and the gradients of sum(out * dy) (input, then weights by path)
    of ``attn`` on ``x``; under ``mesh`` this rank's rows of x, dy."""
    from mxnet_tpu_torch.parallel.mesh import activate
    import contextlib
    scope = activate(mesh, "sp") if mesh is not None else contextlib.nullcontext()
    xa = mt.nd.array(x, ctx=mt.cpu())
    xa.attach_grad()
    with scope, mt.autograd.record():
        out = attn(xa, mt.nd.array(mask, ctx=mt.cpu()))
        head = (out * mt.nd.array(dy, ctx=mt.cpu())).sum()
    head.backward()
    grads = {k: p.grad().asnumpy() for k, p in attn._collect_params_with_prefix().items()}
    return out.asnumpy(), xa.grad.asnumpy(), grads


def _train(net, mesh, spec, tok, lab):
    tr = DataParallelTrainer(net, token_ce, "adam", {"learning_rate": LR}, mesh=mesh,
                             data_spec=spec)
    x = mt.nd.array(tok, ctx=mt.cpu(), dtype="int32")
    y = mt.nd.array(lab, ctx=mt.cpu(), dtype="int32")
    losses, grads = [], None
    for i in range(STEPS):
        losses.append(float(tr.step(x, y)))
        if i == 0:        # copies: on the CPU the arrays would alias the buffers
            grads = {k: v.copy() for k, v in gather_grads(net).items()}
    return losses, grads, gather_params(net)


def rank_sp_mask(workdir):
    """One of the SP ranks: for each mask, the attention alone on this
    rank's rows (outputs and input gradients gathered over sp, weight
    gradients summed), then the trained net. Rank 0 writes the arrays."""
    import torch.distributed as dist
    d = np.load(f"{workdir}/data.npz")
    aw = dict(np.load(f"{workdir}/attn.npz"))
    nw = dict(np.load(f"{workdir}/net.npz"))
    mesh = make_mesh({"dp": 1, "sp": SP}, devices=[mt.cpu()])
    r, tl = mesh.axis_index("sp"), T // SP
    rows = slice(r * tl, (r + 1) * tl)
    group = mesh.group("sp")
    res = {}
    for name, mask in _masks().items():
        attn = SelfAttention(U, H)
        attn.initialize(ctx=mt.cpu())
        load_jax_params(attn, aw)
        out, dx, grads = _attention_alone(attn, d["x"][:, rows], d["dy"][:, rows], mask, mesh)
        full = []
        for part in (out, dx):
            got = [torch.empty_like(torch.from_numpy(part)) for _ in range(SP)]
            dist.all_gather(got, torch.from_numpy(part), group=group)
            full.append(torch.cat(got, dim=1).numpy())
        for k, g in grads.items():
            t = torch.from_numpy(g)
            dist.all_reduce(t, group=group)
            grads[k] = t.numpy()
        net = PortLM(mask)
        net.initialize(ctx=mt.cpu())
        load_jax_params(net, nw)
        losses, tgrads, params = _train(net, mesh, P("dp", "sp"), d["tok"], d["lab"])
        res[name] = losses
        if mesh.rank == 0:
            np.savez(f"{workdir}/{name}.npz", out=full[0], dx=full[1],
                     **{f"g.{k}": v for k, v in grads.items()},
                     **{f"tg.{k}": v for k, v in tgrads.items()},
                     **{f"w.{k}": v for k, v in params.items()})
    return res


def _close(got, want, tol=TOL):
    scale = max(float(np.abs(want).max()), 1e-30)
    return float(np.abs(got - want).max()) <= tol * scale


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Weights, data; the reference's attention alone and trained run for
    each mask; the port at sp 1 in this process; the 2 ranks at sp 2."""
    import jax
    import jax.numpy as jnp
    import mxnet_tpu as mx
    from mxnet_tpu.parallel.data_parallel import _make_apply_fn
    from mxnet_tpu.models.bert import SelfAttention as RefAttention
    from mxnet_tpu.parallel import DataParallelTrainer as RefDPT, make_mesh as ref_mesh, \
        P as RP

    root = tmp_path_factory.mktemp("sp_mask")
    data = _data()
    probe = SelfAttention(U, H)
    probe.initialize(ctx=mt.cpu())
    aw = seeded_params(probe, seed=4)
    nprobe = PortLM(_masks()["causal"])
    nprobe.initialize(ctx=mt.cpu())
    nw = seeded_params(nprobe, seed=5)
    np.savez(root / "data.npz", **data)
    np.savez(root / "attn.npz", **aw)
    np.savez(root / "net.npz", **nw)
    ranks = _dist_util.launch_local(f"{MODULE}:rank_sp_mask", SP, {"workdir": str(root)},
                                    device="cpu", timeout=180, pythonpath=[TESTS_DIR],
                                    workdir=str(root / "launch"))

    def ref_array(mask, like):
        return mx.nd.array(mask)
    RefLM = masked_lm_class(mx.gluon.HybridBlock, mx.gluon.nn, RefAttention, ref_array)

    def ref_load(block, weights):
        block.initialize(ctx=mx.cpu())
        for k, p in block._collect_params_with_prefix().items():
            p.set_data(mx.nd.array(weights[k], ctx=mx.cpu()))
        return block

    def loss_fn(logits, labels):
        logits = logits.astype(jnp.float32)
        logz = jax.nn.logsumexp(logits, axis=-1)
        gold = jnp.take_along_axis(logits, labels[..., None].astype(jnp.int32),
                                   axis=-1)[..., 0]
        return jnp.mean(logz - gold)

    out = {}
    for name, mask in _masks().items():
        ref = ref_load(RefAttention(U, H), aw)
        xr = mx.nd.array(data["x"])
        xr.attach_grad()
        with mx.autograd.record():
            o = ref(xr, mx.nd.array(mask))
            head = (o * mx.nd.array(data["dy"])).sum()
        head.backward()
        refa = {"out": o.asnumpy(), "dx": xr.grad.asnumpy(),
                "grads": {k: p.grad().asnumpy()
                          for k, p in ref._collect_params_with_prefix().items()}}
        attn = SelfAttention(U, H)
        attn.initialize(ctx=mt.cpu())
        load_jax_params(attn, aw)
        p_out, p_dx, p_grads = _attention_alone(attn, data["x"], data["dy"], mask)
        net = PortLM(mask)
        net.initialize(ctx=mt.cpu())
        load_jax_params(net, nw)
        p_losses, p_tgrads, p_params = _train(net, make_mesh({"dp": 1}, devices=[mt.cpu()]),
                                              P("dp"), data["tok"], data["lab"])
        # the reference trainer's gradient: jax.grad through the functional
        # forward its step differentiates
        rnet = ref_load(RefLM(mask), nw)
        paths = list(rnet._collect_params_with_prefix())
        plist = [rnet._collect_params_with_prefix()[k] for k in paths]
        apply_fn = _make_apply_fn(rnet, plist, train=True)
        g = jax.grad(lambda ps: loss_fn(apply_fn(jnp.zeros((2,), jnp.uint32), ps,
                                                 jnp.asarray(data["tok"]))[0],
                                        jnp.asarray(data["lab"])))(
            [p.data()._data for p in plist])
        r_tgrads = {k: np.asarray(a) for k, a in zip(paths, g)}
        rnet = ref_load(RefLM(mask), nw)
        rt = RefDPT(rnet, loss_fn, optimizer="adam", optimizer_params={"learning_rate": LR},
                    mesh=ref_mesh({"dp": 1, "sp": SP}, devices=jax.devices("cpu")[:SP]),
                    batch_axis_name="dp", data_spec=RP("dp", "sp"))
        r_losses = [float(rt.step(mx.nd.array(data["tok"], dtype="int32"),
                                  mx.nd.array(data["lab"], dtype="int32")))
                    for _ in range(STEPS)]
        rt.sync()
        sp2 = dict(np.load(root / f"{name}.npz"))
        out[name] = {
            "ref": refa, "ref_losses": r_losses, "ref_tgrads": r_tgrads,
            "ref_params": {k: p.data().asnumpy()
                           for k, p in rnet._collect_params_with_prefix().items()},
            "sp1": {"out": p_out, "dx": p_dx, "grads": p_grads, "losses": p_losses,
                    "tgrads": p_tgrads, "params": p_params},
            "sp2": {"out": sp2["out"], "dx": sp2["dx"],
                    "grads": {k[2:]: v for k, v in sp2.items() if k.startswith("g.")},
                    "losses": ranks[0][name], "all_losses": [rk[name] for rk in ranks],
                    "tgrads": {k[3:]: v for k, v in sp2.items() if k.startswith("tg.")},
                    "params": {k[2:]: v for k, v in sp2.items() if k.startswith("w.")}}}
    return out


MASKS = list(_masks())


@pytest.mark.parametrize("mask", MASKS)
@pytest.mark.parametrize("against", ["sp1", "ref"])
def test_attention_alone(runs, mask, against):
    """The output and the input's and weights' gradients of the masked
    attention at sp 2 against sp 1 and against the reference."""
    r = runs[mask]
    want = r["sp1"] if against == "sp1" else r["ref"]
    got = r["sp2"]
    assert _close(got["out"], want["out"]), "out"
    assert _close(got["dx"], want["dx"]), "dx"
    assert set(got["grads"]) == set(want["grads"])
    for k, g in want["grads"].items():
        assert _close(got["grads"][k], g), k


@pytest.mark.parametrize("mask", MASKS)
def test_sp1_attention_matches_reference(runs, mask):
    r = runs[mask]
    assert _close(r["sp1"]["out"], r["ref"]["out"])
    assert _close(r["sp1"]["dx"], r["ref"]["dx"])
    for k, g in r["ref"]["grads"].items():
        assert _close(r["sp1"]["grads"][k], g), k


@pytest.mark.parametrize("mask", MASKS)
@pytest.mark.parametrize("against", ["sp1", "ref"])
def test_trained_net(runs, mask, against):
    """``DataParallelTrainer(data_spec=P("dp", "sp"))`` at sp 2: every rank's
    losses, the gradients after step 1 and the weights after step 3."""
    r = runs[mask]
    got = r["sp2"]
    if against == "sp1":
        want_l, want_g, want_w = r["sp1"]["losses"], r["sp1"]["tgrads"], r["sp1"]["params"]
    else:
        want_l, want_g, want_w = r["ref_losses"], r["ref_tgrads"], r["ref_params"]
    for losses in got["all_losses"]:
        np.testing.assert_allclose(losses, want_l, rtol=TOL)
    assert want_l[-1] < want_l[0]
    for k, g in want_g.items():
        assert _close(got["tgrads"][k], g), k
    for k, w in want_w.items():
        assert _close(got["params"][k], w), k


def test_mask_rows_must_cover_the_sequence():
    """A mask whose query axis is neither 1 nor the whole sequence raises."""
    from mxnet_tpu_torch.base import MXNetError
    from mxnet_tpu_torch.models.bert import _query_rows

    class _Mesh:
        def axis_size(self, axis):
            return 2

        def axis_index(self, axis):
            return 1
    m = mt.nd.array(np.ones((5, T), np.float32), ctx=mt.cpu())
    with pytest.raises(MXNetError, match="query axis"):
        _query_rows(mt.nd, m, _Mesh(), "sp", T // 2)
    full = mt.nd.array(np.arange(T * T, dtype=np.float32).reshape(T, T), ctx=mt.cpu())
    got = _query_rows(mt.nd, full, _Mesh(), "sp", T // 2).asnumpy()
    np.testing.assert_array_equal(got, full.asnumpy()[T // 2:])
