"""The port's optimizer ops, optimizers, Trainer and fused updates against
the reference package's, on the same numpy inputs.

- The registered ``sgd_update``, ``sgd_mom_update`` and ``adam_update``
  against ``mxnet_tpu.ops.registry.get_op(name)``, with rescale, clip and
  wd, and through ``nd`` (which writes the new states back into their
  arrays in both packages).
- ``SGD`` (momentum) and ``Adam`` through ``Updater`` for 5 steps, and
  ``Trainer.step(batch_size)`` on a small Dense net, against the reference
  classes.
- The plain ``fused_sgd_apply``/``fused_adam_apply`` (what the port runs for
  CPU tensors) against the reference's, at t = 1, 2 and 5 with lr changed
  between calls. On the CPU the reference functions take their jnp fallback,
  which is the same math as its Pallas kernels (``_sgd_kernel``,
  ``_adam_kernel``).
- ``multi_precision=True`` SGD (momentum) and Adam on float16 and bfloat16
  weights through ``Updater`` for 5 steps against the reference's
  ``update_multi_precision``: the low-precision weights and the float32
  masters (1e-5 of each array's max after 5 steps; the low-precision weight
  is the master rounded once, so they agree to its rounding: 1e-2), and an
  ``lr_scheduler`` read at each update.
- The fused step's rules over ragged lists (``fused_sgd_mom_update``,
  ``fused_sgd_update``, ``fused_adam_update``: plain versions on the CPU)
  against the reference's registered ``sgd_mom_update``, ``sgd_update`` and
  ``adam_update`` tensor by tensor, with rescale, clip and wd, over 5 calls
  with lr changed between them (1e-6 for one call, 1e-5 after 5; Adam 2e-5,
  see ``TOL_ADAM_RULE``).
- The traps that keep the semantics apart: the fused SGD's momentum rule is
  not ``sgd_mom_update``'s once lr changes, and the fused Adam's bias
  correction is not ``adam_update`` with a bias-corrected lr (eps lands
  elsewhere).

Tolerances, f32 on the CPU: 1e-6 relative and absolute for one update (the
same formulas; the port takes hyper-parameters rounded to f32 as the
reference does, so only rounding inside exp/sqrt/division may differ), and
1e-5 after 5 updates of values of size ~1. The CUDA kernels run only on the
card: the ``gpu`` tests skip here.
"""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import mxnet_tpu_torch as mt
from mxnet_tpu_torch.ops.cuda import fused_optimizer as fo
from mxnet_tpu_torch.ops.registry import get_op
from torch_threads import one_torch_thread  # noqa: F401

TOL = 1e-6
TOL_STEPS = 1e-5
SHAPES = [(7, 5), (128,), (3, 4, 5), (1,)]


def _arrays(seed, shapes=SHAPES, scale=1.0):
    rs = np.random.RandomState(seed)
    return [(scale * rs.normal(size=s)).astype(np.float32) for s in shapes]


@pytest.fixture(scope="module")
def ref():
    import jax.numpy as jnp
    import mxnet_tpu as mx
    from mxnet_tpu.ops.pallas import fused_optimizer as ref_fo
    from mxnet_tpu.ops import optimizer_ops as ref_oo
    from mxnet_tpu.ops.registry import get_op as ref_get_op
    return SimpleNamespace(jnp=jnp, mx=mx, fo=ref_fo, get_op=ref_get_op, oo=ref_oo)


OP_CASES = [
    ("sgd_update", 2, {"lr": 0.1, "wd": 0.01, "rescale_grad": 0.5,
                       "clip_gradient": 0.3}),
    ("sgd_update", 2, {"lr": 0.05}),
    ("sgd_mom_update", 3, {"lr": 0.1, "momentum": 0.9, "wd": 0.01,
                           "rescale_grad": 2.0, "clip_gradient": 1.0}),
    ("adam_update", 4, {"lr": 0.01, "beta1": 0.8, "wd": 0.1, "rescale_grad": 0.5,
                        "clip_gradient": 0.2}),
    ("adam_update", 4, {"lr": 0.001, "epsilon": 1e-3}),
]


@pytest.mark.parametrize("name,n_in,params", OP_CASES,
                         ids=[f"{c[0]}-{i}" for i, c in enumerate(OP_CASES)])
def test_update_ops_match_reference(ref, name, n_in, params):
    arrays = _arrays(len(name) + n_in, [(4, 6)] * n_in)
    if name == "adam_update":
        arrays[3] = arrays[3] ** 2          # var >= 0
    expect = ref.get_op(name)(*(ref.jnp.asarray(a) for a in arrays), **params)
    got = get_op(name)(*(torch.from_numpy(a) for a in arrays), **params)
    expect = expect if isinstance(expect, tuple) else (expect,)
    got = got if isinstance(got, tuple) else (got,)
    assert len(got) == len(expect)
    for g, e in zip(got, expect):
        np.testing.assert_allclose(g.numpy(), np.asarray(e), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("name", ["sgd_mom_update", "adam_update"])
def test_nd_update_writes_states_back(ref, name):
    n_in = 3 if name == "sgd_mom_update" else 4
    arrays = _arrays(9, [(5,)] * n_in)
    arrays[-1] = np.abs(arrays[-1])
    params = {"lr": 0.1, "momentum": 0.5} if n_in == 3 else {"lr": 0.1}
    ref_in = [ref.mx.nd.array(a, ctx=ref.mx.cpu()) for a in arrays]
    port_in = [mt.nd.array(a, ctx=mt.cpu()) for a in arrays]
    expect = getattr(ref.mx.nd, name)(*ref_in, **params)
    got = getattr(mt.nd, name)(*port_in, **params)
    np.testing.assert_allclose(got.asnumpy(), expect.asnumpy(), rtol=TOL, atol=TOL)
    for p, r in zip(port_in[2:], ref_in[2:]):        # states, written back
        np.testing.assert_allclose(p.asnumpy(), r.asnumpy(), rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(port_in[0].asnumpy(), arrays[0])  # weight kept


OPTIMIZERS = [("sgd", {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-3,
                       "rescale_grad": 0.5}),
              ("sgd", {"learning_rate": 0.05, "clip_gradient": 0.5}),
              ("adam", {"learning_rate": 0.01, "wd": 1e-2, "clip_gradient": 1.0}),
              ("adam", {"learning_rate": 0.001, "beta1": 0.8, "beta2": 0.99,
                        "epsilon": 1e-6})]


@pytest.mark.parametrize("name,kw", OPTIMIZERS,
                         ids=[f"{n}-{i}" for i, (n, _) in enumerate(OPTIMIZERS)])
def test_updater_matches_reference_over_5_steps(ref, name, kw):
    mx = ref.mx
    weights = _arrays(1)
    grads = [_arrays(10 + s) for s in range(5)]
    ref_upd = mx.optimizer.get_updater(mx.optimizer.create(name, **kw))
    port_upd = mt.optimizer.get_updater(mt.optimizer.create(name, **kw))
    ref_w = [mx.nd.array(w, ctx=mx.cpu()) for w in weights]
    port_w = [mt.nd.array(w, ctx=mt.cpu()) for w in weights]
    for step in range(5):
        for i in range(len(SHAPES)):
            ref_upd(i, mx.nd.array(grads[step][i], ctx=mx.cpu()), ref_w[i])
            port_upd(i, mt.nd.array(grads[step][i], ctx=mt.cpu()), port_w[i])
    for p, r in zip(port_w, ref_w):
        np.testing.assert_allclose(p.asnumpy(), r.asnumpy(), rtol=TOL_STEPS,
                                   atol=TOL_STEPS)
    assert port_upd.optimizer.num_update == ref_upd.optimizer.num_update == 5
    def states(upd):
        st = upd.states[0]
        return [] if st is None else list(st) if isinstance(st, tuple) else [st]
    assert len(states(port_upd)) == len(states(ref_upd))
    for s, rs in zip(states(port_upd), states(ref_upd)):
        np.testing.assert_allclose(s.asnumpy(), rs.asnumpy(), rtol=TOL_STEPS,
                                   atol=TOL_STEPS)


@pytest.mark.parametrize("optimizer,params", [
    ("adam", {"learning_rate": 0.01}),
    ("sgd", {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4})])
def test_trainer_step_matches_reference(ref, optimizer, params):
    mx = ref.mx
    x = _arrays(3, [(6, 5)])[0]
    target = _arrays(4, [(6, 3)])[0]
    nets = []
    for pkg, ctx in ((mt, mt.cpu()), (mx, mx.cpu())):
        net = pkg.gluon.nn.Dense(3, in_units=5)
        net.initialize(ctx=ctx)
        nets.append((pkg, ctx, net))
    w = _arrays(5, [(3, 5), (3,)])
    for pkg, ctx, net in nets:
        net.weight.set_data(pkg.nd.array(w[0], ctx=ctx))
        net.bias.set_data(pkg.nd.array(w[1], ctx=ctx))
    lr_after = []
    for pkg, ctx, net in nets:
        trainer = pkg.gluon.Trainer(net.collect_params(), optimizer, dict(params))
        for step in range(3):
            with pkg.autograd.record():
                diff = net(pkg.nd.array(x, ctx=ctx)) - pkg.nd.array(target, ctx=ctx)
                loss = (diff * diff).sum()
            loss.backward()
            trainer.step(6)
            if step == 1:
                trainer.set_learning_rate(trainer.learning_rate / 2)
        lr_after.append(trainer.learning_rate)
    (_, _, port), (_, _, refn) = nets
    assert lr_after[0] == lr_after[1]
    for a, b in ((port.weight, refn.weight), (port.bias, refn.bias)):
        np.testing.assert_allclose(a.data().asnumpy(), b.data().asnumpy(),
                                   rtol=TOL_STEPS, atol=TOL_STEPS)
        np.testing.assert_allclose(a.grad().asnumpy(), b.grad().asnumpy(),
                                   rtol=TOL_STEPS, atol=TOL_STEPS)


def test_trainer_skips_null_params_and_zero_grad():
    net = mt.gluon.nn.Dense(2, in_units=3)
    net.initialize(ctx=mt.cpu())
    net.bias.grad_req = "null"
    bias = net.bias.data().asnumpy()
    trainer = mt.gluon.Trainer(net.collect_params(), "sgd", {"learning_rate": 1.0})
    with mt.autograd.record():
        loss = net(mt.nd.array(np.ones((1, 3), np.float32), ctx=mt.cpu())).sum()
    loss.backward()
    trainer.step(1)
    np.testing.assert_array_equal(net.bias.data().asnumpy(), bias)
    np.testing.assert_array_equal(net.weight.grad().asnumpy(), np.ones((2, 3)))
    trainer.zero_grad()
    np.testing.assert_array_equal(net.weight.grad().asnumpy(), np.zeros((2, 3)))
    with pytest.raises(mt.MXNetError, match="null"):
        net.bias.grad()


def _fused_inputs(seed, with_v):
    ws, gs = _arrays(seed), _arrays(seed + 1)
    ms = _arrays(seed + 2, scale=0.1)
    vs = [np.abs(a) for a in _arrays(seed + 3, scale=0.01)] if with_v else None
    return ws, gs, ms, vs


def test_fused_sgd_plain_matches_reference(ref):
    jnp = ref.jnp
    ws, gs, ms, _ = _fused_inputs(20, False)
    rw, rm = [jnp.asarray(a) for a in ws], [jnp.asarray(a) for a in ms]
    pw, pm = [torch.from_numpy(a) for a in ws], [torch.from_numpy(a) for a in ms]
    before = fo.fused_sgd_apply.launches
    for step, lr in enumerate((0.1, 0.1, 0.03, 0.2, 0.05)):
        g = [a * (step + 1) for a in gs]
        rw, rm = ref.fo.fused_sgd_apply(rw, [jnp.asarray(a) for a in g], rm, lr=lr,
                                        momentum=0.9, wd=0.01)
        pw, pm = fo.fused_sgd_apply(pw, [torch.from_numpy(a) for a in g], pm,
                                    lr=lr, momentum=0.9, wd=0.01)
        for p, r in zip(pw + pm, rw + rm):
            np.testing.assert_allclose(p.numpy(), np.asarray(r), rtol=TOL_STEPS,
                                       atol=TOL_STEPS)
    assert fo.fused_sgd_apply.launches == before       # CPU: plain version


def test_fused_adam_plain_matches_reference(ref):
    jnp = ref.jnp
    ws, gs, ms, vs = _fused_inputs(30, True)
    r = [[jnp.asarray(a) for a in lst] for lst in (ws, ms, vs)]
    p = [[torch.from_numpy(a) for a in lst] for lst in (ws, ms, vs)]
    before = fo.fused_adam_apply.launches
    for t, lr in ((1, 1e-3), (2, 1e-3), (5, 3e-4)):
        g = [a * t for a in gs]
        rw, rm, rv = ref.fo.fused_adam_apply(r[0], [jnp.asarray(a) for a in g],
                                             r[1], r[2], lr=lr, wd=0.01, t=t)
        pw, pm, pv = fo.fused_adam_apply(p[0], [torch.from_numpy(a) for a in g],
                                         p[1], p[2], lr=lr, wd=0.01, t=t)
        r, p = [rw, rm, rv], [pw, pm, pv]
        for got, expect in zip(pw + pm + pv, rw + rm + rv):
            np.testing.assert_allclose(got.numpy(), np.asarray(expect),
                                       rtol=TOL, atol=TOL)
    assert fo.fused_adam_apply.launches == before


def test_fused_out_writes_in_place():
    ws, gs, ms, vs = _fused_inputs(40, True)
    w, g, m, v = ([torch.from_numpy(a.copy()) for a in lst] for lst in (ws, gs, ms, vs))
    expect = fo.fused_adam_apply(w, g, m, v, lr=0.01, t=3)
    ids = [id(t) for t in w + m + v]
    got = fo.fused_adam_apply(w, g, m, v, lr=0.01, t=3, out=(w, m, v))
    assert [id(t) for lst in got for t in lst] == ids
    for a, b in zip(w + m + v, expect[0] + expect[1] + expect[2]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_fused_rules_are_not_the_update_ops():
    """The traps of ROADMAP B5/B6, kept visible."""
    ws, gs, ms, vs = _fused_inputs(50, True)
    w0, g = torch.from_numpy(ws[0]), torch.from_numpy(gs[0])
    # K4 against sgd_mom_update: equal while lr is constant (the op keeps
    # -lr * m as its momentum), apart once lr changes
    kw, km = [w0], [torch.zeros_like(w0)]
    ow, om = w0, torch.zeros_like(w0)
    for step, lr in enumerate((0.1, 0.1, 0.01)):
        kw, km = fo.fused_sgd_apply(kw, [g], km, lr=lr, momentum=0.9)
        ow, om = get_op("sgd_mom_update")(ow, g, om, lr=lr, momentum=0.9)
        gap = (kw[0] - ow).abs().max().item()
        assert gap < 1e-6 if step < 2 else gap > 1e-2
    # K5 against adam_update with the bias correction folded into lr: eps
    # lands at eps * sqrt(c2) in the one and at eps in the other, which shows
    # where sqrt(v) is of the order of eps
    tiny = g * 1e-8
    z = torch.zeros_like(w0)
    kw5, _, _ = fo.fused_adam_apply([w0], [tiny], [z], [z], lr=1e-3, t=1)
    lr_t = 1e-3 * np.sqrt(1 - 0.999) / (1 - 0.9)
    ow5, _, _ = get_op("adam_update")(w0, tiny, z, z, lr=lr_t)
    assert (kw5[0] - ow5).abs().max().item() > 1e-4


@pytest.mark.parametrize("bad", ["length", "mixed-dtype", "shape", "contiguous"])
def test_fused_argument_checks(bad):
    ws = [torch.zeros(4, 3), torch.zeros(5)]
    gs, ms = [torch.zeros(4, 3), torch.zeros(5)], [torch.zeros(4, 3), torch.zeros(5)]
    if bad == "length":
        gs = gs[:1]
    elif bad == "mixed-dtype":
        ws[1] = ws[1].double()
    elif bad == "shape":
        gs[1] = torch.zeros(6)
    else:
        ws[0] = torch.zeros(3, 4).t()
    with pytest.raises(mt.MXNetError):
        fo._check("fused_sgd_apply", [ws, gs, ms], ["weights", "grads", "moms"],
                  torch.device("cpu"))


@pytest.mark.gpu
@pytest.mark.parametrize("wdtype,sdtype", [(torch.float32, torch.float32),
                                           (torch.bfloat16, torch.float32),
                                           (torch.float16, torch.float16)])
def test_fused_kernels_match_plain(wdtype, sdtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run on the card")
    shapes = [(1000, 77), (3,), (16384,), (16385,), (64, 64), (0,), (5, 1)]
    ws, gs, ms, vs = (_arrays(s, shapes, 0.1) for s in (1, 2, 3, 4))
    w, g = ([torch.from_numpy(a).to("cuda", wdtype) for a in lst] for lst in (ws, gs))
    m, v = ([torch.from_numpy(a).to("cuda", sdtype) for a in lst] for lst in (ms, vs))
    v = [t.abs() for t in v]
    w.append(torch.randn(1001, device="cuda", dtype=wdtype)[1:])   # misaligned
    g.append(torch.randn(1000, device="cuda", dtype=wdtype))
    m.append(torch.zeros(1000, device="cuda", dtype=sdtype))
    v.append(torch.zeros(1000, device="cuda", dtype=sdtype))
    tol = 1e-6 if wdtype == torch.float32 else 1e-2
    before = (fo.fused_sgd_apply.launches, fo.fused_adam_apply.launches)
    for t, lr in ((1, 1e-2), (2, 3e-3)):
        got = fo.fused_adam_apply(w, g, m, v, lr=lr, wd=0.01, t=t)
        expect = fo.fused_adam_apply_plain(w, g, m, v, lr=lr, wd=0.01, t=t)
        for a, b in zip(sum(got, []), sum(expect, [])):
            assert a.dtype == b.dtype
            assert (a.float() - b.float()).abs().max().item() <= tol * max(
                b.float().abs().max().item(), 1.0) if b.numel() else True
        got = fo.fused_sgd_apply(w, g, m, lr=lr, momentum=0.9, wd=0.01)
        expect = fo.fused_sgd_apply_plain(w, g, m, lr=lr, momentum=0.9, wd=0.01)
        for a, b in zip(sum(got, []), sum(expect, [])):
            assert (a.float() - b.float()).abs().max().item() <= tol * max(
                b.float().abs().max().item(), 1.0) if b.numel() else True
    torch.cuda.synchronize()
    assert (fo.fused_sgd_apply.launches, fo.fused_adam_apply.launches) == \
        (before[0] + 2, before[1] + 2)


MP_CASES = [("sgd", {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-3}),
            ("sgd", {"learning_rate": 0.05}),
            ("adam", {"learning_rate": 0.01, "wd": 1e-2, "clip_gradient": 1.0})]


@pytest.mark.parametrize("dtype", ["float16", "bfloat16"])
@pytest.mark.parametrize("name,kw", MP_CASES,
                         ids=[f"{n}-{i}" for i, (n, _) in enumerate(MP_CASES)])
def test_multi_precision_matches_reference(ref, name, kw, dtype):
    mx = ref.mx
    weights = _arrays(61)
    grads = [_arrays(62 + s) for s in range(5)]
    sched = {"lr_scheduler": (mx.lr_scheduler.FactorScheduler(2, 0.5),
                              mt.lr_scheduler.FactorScheduler(2, 0.5))}
    ref_upd = mx.optimizer.get_updater(mx.optimizer.create(
        name, multi_precision=True, lr_scheduler=sched["lr_scheduler"][0], **kw))
    port_upd = mt.optimizer.get_updater(mt.optimizer.create(
        name, multi_precision=True, lr_scheduler=sched["lr_scheduler"][1], **kw))
    ref_w = [mx.nd.array(w, ctx=mx.cpu(), dtype=dtype) for w in weights]
    port_w = [mt.nd.array(w, ctx=mt.cpu(), dtype=dtype) for w in weights]
    for step in range(5):
        for i in range(len(SHAPES)):
            ref_upd(i, mx.nd.array(grads[step][i], ctx=mx.cpu(), dtype=dtype), ref_w[i])
            port_upd(i, mt.nd.array(grads[step][i], ctx=mt.cpu(), dtype=dtype), port_w[i])
    assert port_upd.optimizer.learning_rate == ref_upd.optimizer.learning_rate
    for i, (p, r) in enumerate(zip(port_w, ref_w)):
        assert str(p.dtype).endswith(dtype)
        np.testing.assert_allclose(p.asnumpy().astype(np.float32),
                                   r.asnumpy().astype(np.float32), rtol=1e-2, atol=1e-2)
        master, base = port_upd.states[i]
        ref_master, ref_base = ref_upd.states[i]
        assert master.dtype == torch.float32
        np.testing.assert_allclose(master.asnumpy(), ref_master.asnumpy(),
                                   rtol=TOL_STEPS, atol=TOL_STEPS)
        # the weight is the master rounded once
        np.testing.assert_array_equal(p.asnumpy().astype(np.float32),
                                      master._data.to(p.dtype).float().numpy())
        base = [] if base is None else list(base) if isinstance(base, tuple) else [base]
        ref_base = [] if ref_base is None else \
            list(ref_base) if isinstance(ref_base, tuple) else [ref_base]
        assert len(base) == len(ref_base)
        for a, b in zip(base, ref_base):
            np.testing.assert_allclose(a.asnumpy(), b.asnumpy(), rtol=TOL_STEPS,
                                       atol=TOL_STEPS)


RULE_CASES = [
    ("sgd_mom_update", {"momentum": 0.9, "wd": 0.01, "rescale_grad": 0.5,
                        "clip_gradient": 0.3}),
    ("sgd_mom_update", {"momentum": 0.5}),
    ("sgd_update", {"wd": 0.01, "rescale_grad": 2.0, "clip_gradient": 1.0}),
    ("sgd_update", {}),
    ("adam_update", {"beta1": 0.8, "wd": 0.1, "rescale_grad": 0.5, "clip_gradient": 0.2}),
    ("adam_update", {"epsilon": 1e-3}),
]
# The reference's compiled CPU division and sqrt are not correctly rounded:
# against IEEE f32 (numpy and the port agree to 6e-8) its Adam update of
# weights of size ~1 by steps of up to 0.3 (lr 0.2, first calls) is off by up
# to 5.7e-6, measured; 2e-5 of the weight is 7e-5 of such a step.
TOL_ADAM_RULE = 2e-5
_FUSED_OF = {"sgd_mom_update": "fused_sgd_mom_update", "sgd_update": "fused_sgd_update",
             "adam_update": "fused_adam_update"}


@pytest.mark.parametrize("name,kw", RULE_CASES,
                         ids=[f"{c[0]}-{i}" for i, c in enumerate(RULE_CASES)])
def test_fused_step_rules_match_the_update_ops(ref, name, kw):
    """The rules the fused training step launches, over a ragged list, against
    the reference's registered op applied tensor by tensor."""
    jnp = ref.jnp
    ws, gs, ms, vs = _fused_inputs(70, True)
    n_states = {"sgd_mom_update": 1, "sgd_update": 0, "adam_update": 2}[name]
    port = [[torch.from_numpy(a) for a in lst] for lst in (ws, ms, vs)[:1 + n_states]]
    expect = [[jnp.asarray(a) for a in lst] for lst in (ws, ms, vs)[:1 + n_states]]
    fused = getattr(fo, _FUSED_OF[name])
    launches = fused.launches
    for step, lr in enumerate((0.1, 0.1, 0.03, 0.2, 0.05)):
        g = [a * (step + 1) for a in gs]
        port = fused(port[0], [torch.from_numpy(a) for a in g], *port[1:], lr=lr, **kw)
        # f32 scalars, as the reference's step passes them (_k_adam & co.):
        # 1 - beta is then an f32 subtraction, as in the kernel
        f32 = {k: jnp.float32(v) for k, v in dict(kw, lr=lr).items()}
        outs = [getattr(ref.oo, name)(w, jnp.asarray(gi), *st, **f32)
                for w, gi, *st in zip(*expect[:1], g, *expect[1:])]
        outs = [o if isinstance(o, tuple) else (o,) for o in outs]
        expect = [[o[k] for o in outs] for k in range(1 + n_states)]
        tol = TOL_ADAM_RULE if name == "adam_update" else TOL if step == 0 else TOL_STEPS
        assert len(port) == len(expect)
        for got_list, exp_list in zip(port, expect):
            for got, e in zip(got_list, exp_list):
                np.testing.assert_allclose(got.numpy(), np.asarray(e), rtol=tol, atol=tol)
    assert fused.launches == launches                   # CPU: plain version


@pytest.mark.gpu
@pytest.mark.parametrize("wdtype,sdtype", [(torch.float32, torch.float32),
                                           (torch.bfloat16, torch.float32),
                                           (torch.float16, torch.float16)])
def test_fused_step_rules_kernels_match_plain(wdtype, sdtype):
    """The three rules of the fused step on the card against their plain
    versions, ragged list with an empty and a misaligned tensor, in place."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run on the card")
    shapes = [(1000, 77), (3,), (16384,), (16385,), (64, 64), (0,), (5, 1)]
    ws, gs, ms, vs = (_arrays(s, shapes, 0.1) for s in (5, 6, 7, 8))
    w, g = ([torch.from_numpy(a).to("cuda", wdtype) for a in lst] for lst in (ws, gs))
    m, v = ([torch.from_numpy(a).to("cuda", sdtype) for a in lst] for lst in (ms, vs))
    v = [t.abs() for t in v]
    w.append(torch.randn(1001, device="cuda", dtype=wdtype)[1:])   # misaligned
    g.append(torch.randn(1000, device="cuda", dtype=wdtype))
    m.append(torch.zeros(1000, device="cuda", dtype=sdtype))
    v.append(torch.zeros(1000, device="cuda", dtype=sdtype))
    tol = 1e-6 if wdtype == torch.float32 else 1e-2
    kw = {"wd": 0.01, "rescale_grad": 0.5, "clip_gradient": 0.04}
    calls = [("fused_sgd_mom_update", (m,), {"momentum": 0.9}),
             ("fused_sgd_update", (), {}),
             ("fused_adam_update", (m, v), {"beta1": 0.8})]
    before = {name: getattr(fo, name).launches for name, _, _ in calls}
    for name, states, extra in calls:
        fused, plain = getattr(fo, name), getattr(fo, name + "_plain")
        for lr in (1e-2, 3e-3):
            expect = plain(w, g, *states, lr=lr, **kw, **extra)
            wc, sc = [t.clone() for t in w], [[t.clone() for t in s] for s in states]
            got = fused(wc, g, *sc, lr=lr, **kw, **extra, out=(wc, *sc))
            assert got[0][0] is wc[0]                           # in place
            for a, b in zip(sum(got, []), sum(expect, [])):
                assert a.dtype == b.dtype
                if b.numel():
                    assert (a.float() - b.float()).abs().max().item() <= tol * max(
                        b.float().abs().max().item(), 1.0), name
    torch.cuda.synchronize()
    assert {name: getattr(fo, name).launches - before[name] for name, _, _ in calls} \
        == {name: 2 for name, _, _ in calls}
