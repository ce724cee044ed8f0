"""The port's 19 optimizer classes against the reference's, on the CPU.

Each class (``mxnet_tpu_torch.optimizer``) and its reference counterpart
(``mxnet_tpu.optimizer``) run through their ``Updater`` on the same three
numpy weights (3 x 4, 5 and 2 x 3) and the same numpy gradients for 5
steps, under a ``FactorScheduler`` that halves lr every 2 updates, with wd
0.01, ``rescale_grad`` 0.5 and ``clip_gradient`` 1.0 (gradients N(0, 2²),
so the clip binds): every weight and state after each step within 1e-5 of
the reference's (relative and absolute; float32, the same formulas, the
hyper-parameters rounded to float32 in both). SGLD draws its noise from
each package's own generator, so its rule is held against the reference's
``_k_sgld`` on the same injected noise, and the class by its moments.

The traps of the reference's rules, each a named test: the two clip
conventions at ``clip_gradient=0`` (the ops' ``>= 0`` zeroes the gradient,
the ``_k_*`` rules' ``> 0`` turns clipping off), Nadam's per-call
``m_schedule``, DCASGD's copied snapshot, SGLD's moments, AdamW tested
before Adam, LAMB's bounds and ``bias_correction``, LARS's trust ratio,
``multi_precision`` with a bfloat16 weight (LAMB, NAG), and
``gluon.Trainer`` taking every registered name.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import optimizer as opt_mod
from mxnet_tpu_torch.optimizer import optimizer as O
from mxnet_tpu_torch.parallel.data_parallel import functional_optimizer
from torch_threads import one_torch_thread  # noqa: F401

TOL = 1e-5
STEPS = 5
SHAPES = [(3, 4), (5,), (2, 3)]
COMMON = dict(learning_rate=0.05, wd=0.01, rescale_grad=0.5, clip_gradient=1.0)

# (id, registered name, the class's own arguments)
CLASSES = [
    ("sgd", "sgd", {"momentum": 0.9}), ("sgd-plain", "sgd", {}),
    ("ccsgd", "ccsgd", {"momentum": 0.9}), ("nag", "nag", {"momentum": 0.9}),
    ("signum", "signum", {"momentum": 0.9, "wd_lh": 0.01}),
    ("dcasgd", "dcasgd", {"lamda": 0.5}), ("ftml", "ftml", {}),
    ("lars", "lars", {"momentum": 0.9, "eta": 0.01}),
    ("lbsgd", "lbsgd", {"momentum": 0.9, "warmup_epochs": 2, "batch_scale": 4}),
    ("lamb", "lamb", {}), ("lamb-bounds", "lamb", {"lower_bound": 0.5, "upper_bound": 1.5}),
    ("lamb-nobias", "lamb", {"bias_correction": False}), ("adam", "adam", {}),
    ("adamw", "adamw", {"eta": 0.5}), ("adagrad", "adagrad", {"eps": 1e-6}),
    ("rmsprop", "rmsprop", {}), ("rmsprop-centered", "rmsprop", {"centered": True}),
    ("adadelta", "adadelta", {"rho": 0.95}), ("ftrl", "ftrl", {"lamda1": 0.01}),
    ("adamax", "adamax", {}), ("nadam", "nadam", {}), ("test", "test", {}),
]
# the rules that clip through the registered ops (on at >= 0), and the
# ``_k_*`` rules (on at > 0)
OPS_CLIP = ["sgd", "nag", "adam", "rmsprop", "ftrl", "signum", "ftml"]
K_CLIP = ["adamw", "adagrad", "adadelta", "adamax", "nadam", "dcasgd", "lars", "lamb"]


@pytest.fixture(scope="module")
def ref():
    import mxnet_tpu as mx
    from mxnet_tpu import lr_scheduler as ref_lrs
    from mxnet_tpu.optimizer import optimizer as ref_O
    return mx, ref_lrs, ref_O


def _data(seed, steps=STEPS, shapes=SHAPES):
    rs = np.random.RandomState(seed)
    ws = [rs.normal(0, 1, s).astype(np.float32) for s in shapes]
    gs = [[rs.normal(0, 2, s).astype(np.float32) for s in shapes] for _ in range(steps)]
    return ws, gs


def _leaves(state):
    if state is None:
        return []
    if isinstance(state, (tuple, list)):
        return [x for s in state for x in _leaves(s)]
    return [state.asnumpy().astype(np.float32)]


def _runs(ref, name, kw, seed=0, steps=STEPS, sched=True, dtype=None):
    """Both packages' updaters over ``steps`` steps -> per step, per package,
    (weights, state leaves) as float32 numpy."""
    mx, ref_lrs, _ = ref
    ws, gs = _data(seed, steps)
    out = []
    for pkg, lrs, nd, ctx in ((mt, mt.lr_scheduler, mt.nd, {"ctx": mt.cpu()}),
                              (mx, ref_lrs, mx.nd, {})):
        kwargs = dict(kw)
        if sched:
            kwargs["lr_scheduler"] = lrs.FactorScheduler(step=2, factor=0.5)
        opt = pkg.optimizer.create(name, **kwargs)
        upd = pkg.optimizer.get_updater(opt)
        weights = [nd.array(w, dtype=dtype, **ctx) for w in ws]
        trace = []
        for step in gs:
            for i, (w, g) in enumerate(zip(weights, step)):
                upd(i, nd.array(g, dtype=dtype, **ctx), w)
            trace.append(([w.asnumpy().astype(np.float32) for w in weights],
                          [x for i in range(len(weights)) for x in _leaves(upd.states[i])]))
        out.append((trace, opt, upd, weights))
    return out


def _close(got, want, tol=TOL, what=""):
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g, w, rtol=tol, atol=tol, err_msg=f"{what}[{i}]")


def test_create_builds_every_registered_name(ref):
    names = sorted(ref[0].optimizer.optimizer._OPT_REGISTRY)
    assert len(names) == 19
    assert sorted(O._OPT_REGISTRY) == names
    for n in names:
        assert type(opt_mod.create(n)).__name__.lower() == n
    assert O.ccSGD is O.SGD and issubclass(O._OPT_REGISTRY["ccsgd"], O.SGD)


@pytest.mark.parametrize("name,kw", [c[1:] for c in CLASSES], ids=[c[0] for c in CLASSES])
def test_class_matches_reference_over_five_steps(ref, name, kw):
    (port, popt, _, _), (want, ropt, _, _) = _runs(ref, name, dict(COMMON, **kw))
    assert popt.num_update == ropt.num_update == STEPS
    for k, ((pw, ps), (rw, rs)) in enumerate(zip(port, want)):
        assert len(ps) == len(rs)
        _close(pw, rw, what=f"step {k + 1} weights")
        _close(ps, rs, what=f"step {k + 1} states")


@pytest.mark.parametrize("name", OPS_CLIP + K_CLIP)
def test_clip_gradient_zero_conventions(ref, name):
    """``clip_gradient=0``: the ops' rules see a zero gradient (wd 0 here,
    since the Adam family clips wd·w with it), the ``_k_*`` rules do not
    clip at all; both as the reference."""
    kw = {"learning_rate": 0.05, "momentum": 0.9} if name in ("sgd", "nag", "lars") \
        else {"learning_rate": 0.05}
    (at0, _, _, _), (ref0, _, _, _) = _runs(ref, name, dict(kw, clip_gradient=0.0),
                                            steps=2, sched=False)
    for (pw, ps), (rw, rs) in zip(at0, ref0):
        _close(pw, rw)
        _close(ps, rs)
    ws, gs = _data(0, 2)
    opt = opt_mod.create(name, **kw)
    upd = opt_mod.get_updater(opt)
    weights = [mt.nd.array(w, ctx=mt.cpu()) for w in ws]
    for step in gs:
        for i, (w, g) in enumerate(zip(weights, step)):
            g = np.zeros_like(g) if name in OPS_CLIP else g
            upd(i, mt.nd.array(g, ctx=mt.cpu()), w)
    _close(at0[-1][0], [w.asnumpy() for w in weights])


def test_nadam_multiplies_m_schedule_once_a_call(ref):
    """Two parameters and three steps: ``m_schedule`` is the product of six
    momenta (one an ``update`` call), as in the reference."""
    (port, popt, _, _), (want, ropt, _, _) = _runs(ref, "nadam", dict(COMMON), steps=3)
    expect = 1.0
    for t in range(1, 4):
        for _ in SHAPES:
            expect *= 0.9 * (1.0 - 0.5 * 0.96 ** (t * 0.004))
    assert popt.m_schedule == pytest.approx(expect, rel=1e-12)
    assert popt.m_schedule == pytest.approx(ropt.m_schedule, rel=1e-12)
    _close(port[-1][0], want[-1][0])


def test_dcasgd_state_is_a_copy_of_the_previous_weight():
    opt = opt_mod.create("dcasgd", learning_rate=0.1, lamda=0.5)
    w = mt.nd.array(np.ones((3, 4), np.float32), ctx=mt.cpu())
    state = opt.create_state(0, w)
    assert state._data.data_ptr() != w._data.data_ptr()
    g = mt.nd.array(np.full((3, 4), 2.0, np.float32), ctx=mt.cpu())
    opt.update(0, w, g, state)               # prev == w: no compensation
    w1 = w.asnumpy()
    np.testing.assert_array_equal(state.asnumpy(), np.ones((3, 4), np.float32))
    opt.update(0, w, g, state)               # prev == the step-1 weight
    np.testing.assert_array_equal(state.asnumpy(), w1)
    no_comp = w1 - 0.1 * 2.0
    comp = 0.5 * 4.0 * (w1 - 1.0)
    np.testing.assert_allclose(w.asnumpy(), w1 - 0.1 * (2.0 + comp), rtol=1e-6)
    assert np.abs(w.asnumpy() - no_comp).min() > 1e-3


def test_sgld_rule_matches_reference_on_injected_noise(ref):
    import jax.numpy as jnp
    ref_O = ref[2]
    rs = np.random.RandomState(3)
    w, g, noise = (rs.normal(0, 1, (4, 5)).astype(np.float32) for _ in range(3))
    for clip in (-1.0, 0.0, 0.5):
        (got,) = O._k_sgld(torch.from_numpy(w), torch.from_numpy(g), torch.from_numpy(noise),
                           0.01, 0.1, 0.5, clip)
        want = ref_O._k_sgld(jnp.asarray(w), jnp.asarray(g), jnp.asarray(noise),
                             jnp.float32(0.01), jnp.float32(0.1), jnp.float32(0.5),
                             jnp.float32(clip))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


def test_sgld_moments():
    """g = 0, wd 0 on 2^20 elements: the step is sqrt(lr)·N(0, 1): its mean
    within 4σ of 0 (σ = sqrt(lr / n)) and its variance within 2% of lr."""
    n, lr = 2 ** 20, 0.04
    mt.random.seed(5)
    opt = opt_mod.create("sgld", learning_rate=lr)
    w = mt.nd.array(np.zeros(n, np.float32), ctx=mt.cpu())
    opt.update(0, w, mt.nd.array(np.zeros(n, np.float32), ctx=mt.cpu()), None)
    step = w.asnumpy().astype(np.float64)
    assert abs(step.mean()) <= 4 * np.sqrt(lr / n)
    assert abs(step.var() / lr - 1) <= 0.02


def test_adamw_is_dispatched_before_adam():
    """AdamW subclasses Adam: the fused step's rule is AdamW's (decoupled wd,
    its own scalars), not K5's."""
    assert isinstance(opt_mod.create("adamw"), O.Adam)
    _, _, hyper = functional_optimizer(opt_mod.create("adamw", eta=0.5))
    assert "eta" in hyper.fields
    _, _, adam_hyper = functional_optimizer(opt_mod.create("adam"))
    assert "eta" not in adam_hyper.fields
    w = torch.ones(4)
    g = torch.full((4,), 0.5)
    a = opt_mod.create("adamw", learning_rate=0.1, wd=0.5)
    b = opt_mod.create("adam", learning_rate=0.1, wd=0.5)
    out = []
    for opt in (a, b):
        ww = mt.nd.array(w.numpy(), ctx=mt.cpu())
        opt.update(0, ww, mt.nd.array(g.numpy(), ctx=mt.cpu()), opt.create_state(0, ww))
        out.append(ww.asnumpy())
    # decoupled: w - (lr·1 + wd·w) after step 1's m̂/√v̂ = 1; Adam folds wd into g
    np.testing.assert_allclose(out[0], 1 - (0.1 + 0.5), rtol=1e-5)
    assert np.abs(out[0] - out[1]).min() > 0.1


def _lamb_numpy(w, g, lr, wd, beta1, beta2, eps, t, lower, upper, bias):
    m = (1 - beta1) * g
    v = (1 - beta2) * g * g
    mh, vh = (m / (1 - beta1 ** t), v / (1 - beta2 ** t)) if bias else (m, v)
    r = mh / (np.sqrt(vh) + eps) + wd * w
    wn = np.clip(np.linalg.norm(w), lower, upper)
    rn = np.linalg.norm(r)
    trust = wn / rn if rn > 0 else 1.0
    return w - lr * trust * r


@pytest.mark.parametrize("lower,upper,bias", [(None, None, True), (2.0, None, True),
                                              (None, 0.5, True), (None, None, False)])
def test_lamb_bounds_and_bias_correction(ref, lower, upper, bias):
    """One step from zero moments against numpy in float64 (1e-5) and the
    reference (1e-6): the bounds clip ‖w‖ (``or 0`` / ``or inf``), and
    ``bias_correction=False`` leaves m and v uncorrected."""
    rs = np.random.RandomState(11)
    w, g = rs.normal(0, 1, (6, 7)).astype(np.float32), rs.normal(0, 1, (6, 7)).astype(np.float32)
    kw = dict(learning_rate=0.1, wd=0.01, lower_bound=lower, upper_bound=upper,
              bias_correction=bias)
    got = []
    for pkg, ctx in ((mt, {"ctx": mt.cpu()}), (ref[0], {})):
        opt = pkg.optimizer.create("lamb", **kw)
        ww = pkg.nd.array(w, **ctx)
        opt.update(0, ww, pkg.nd.array(g, **ctx), opt.create_state(0, ww))
        got.append(ww.asnumpy())
    np.testing.assert_allclose(got[0], got[1], rtol=1e-6, atol=1e-6)
    want = _lamb_numpy(w.astype(np.float64), g.astype(np.float64), 0.1, 0.01, 0.9, 0.999,
                       1e-6, 1, lower or 0.0, upper or np.inf, bias)
    np.testing.assert_allclose(got[0], want, rtol=1e-5, atol=1e-5)


def test_lamb_trust_is_one_where_the_direction_is_zero():
    opt = opt_mod.create("lamb", learning_rate=0.1)
    w = mt.nd.array(np.ones((3,), np.float32), ctx=mt.cpu())
    opt.update(0, w, mt.nd.zeros((3,), ctx=mt.cpu()), opt.create_state(0, w))
    np.testing.assert_array_equal(w.asnumpy(), np.ones(3, np.float32))


@pytest.mark.parametrize("zero_w", [False, True])
def test_lars_trust_ratio(ref, zero_w):
    """trust = eta·‖w‖/(‖g‖ + wd·‖w‖ + eps), or 1 where a norm is 0; wd joins
    g after it; mom = momentum·mom + trust·lr·g; w - mom (numpy float64,
    1e-6; the reference 1e-6)."""
    rs = np.random.RandomState(12)
    w = np.zeros((4, 5), np.float32) if zero_w else rs.normal(0, 1, (4, 5)).astype(np.float32)
    g = rs.normal(0, 1, (4, 5)).astype(np.float32)
    mom0 = rs.normal(0, 0.1, (4, 5)).astype(np.float32)
    lr, wd, m, eta, eps = 0.1, 0.01, 0.9, 0.02, 1e-8
    got = []
    for pkg, ctx in ((mt, {"ctx": mt.cpu()}), (ref[0], {})):
        opt = pkg.optimizer.create("lars", learning_rate=lr, wd=wd, momentum=m, eta=eta)
        ww, st = pkg.nd.array(w, **ctx), pkg.nd.array(mom0, **ctx)
        opt.update(0, ww, pkg.nd.array(g, **ctx), st)
        got.append((ww.asnumpy(), st.asnumpy()))
    wn, gn = np.linalg.norm(w.astype(np.float64)), np.linalg.norm(g.astype(np.float64))
    trust = eta * wn / (gn + wd * wn + eps) if wn > 0 and gn > 0 else 1.0
    mom = m * mom0 + trust * lr * (g + wd * w)
    np.testing.assert_allclose(got[0][1], mom, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got[0][0], w - mom, rtol=1e-6, atol=1e-6)
    for a, b in zip(got[0], got[1]):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("name,kw", [("lamb", {}), ("nag", {"momentum": 0.9})])
def test_multi_precision_with_a_bf16_weight(ref, name, kw):
    """``multi_precision=True`` on a bfloat16 weight: a float32 master in the
    state; the master within 1e-5 of the reference's over 5 steps, the
    weight the master rounded."""
    (port, _, pupd, pws), (want, _, rupd, _) = _runs(
        ref, name, dict(COMMON, multi_precision=True, **kw), dtype="bfloat16")
    for (pw, ps), (rw, rs) in zip(port, want):
        _close(ps, rs)
        _close(pw, rw, tol=2.0 ** -7)
    for i, w in enumerate(pws):
        master = pupd.states[i][0]
        assert master.dtype == torch.float32 or str(master.dtype).endswith("float32")
        assert torch.equal(w._data, master._data.to(torch.bfloat16))


@pytest.mark.parametrize("name", sorted(O._OPT_REGISTRY))
def test_gluon_trainer_takes_every_name(ref, name):
    """One ``gluon.Trainer`` step of a Dense in both packages (SGLD: the
    weights move; the others: within 1e-5 of the reference's)."""
    mx = ref[0]
    rs = np.random.RandomState(4)
    w, b = rs.normal(0, 1, (3, 4)).astype(np.float32), rs.normal(0, 1, 3).astype(np.float32)
    x = rs.normal(0, 1, (2, 4)).astype(np.float32)
    out = []
    for pkg, ctx in ((mt, mt.cpu()), (mx, mx.cpu())):
        net = pkg.gluon.nn.Dense(3, in_units=4)
        net.initialize(ctx=ctx)
        net.weight.set_data(pkg.nd.array(w, ctx=ctx))
        net.bias.set_data(pkg.nd.array(b, ctx=ctx))
        trainer = pkg.gluon.Trainer(net.collect_params(), name, {"learning_rate": 0.1})
        with pkg.autograd.record():
            out_ = net(pkg.nd.array(x, ctx=ctx))
            loss = (out_ * out_).sum()
        loss.backward()
        trainer.step(2)
        out.append(net.weight.data().asnumpy())
    if name == "sgld":
        assert np.abs(out[0] - w).max() > 0
    else:
        np.testing.assert_allclose(out[0], out[1], rtol=TOL, atol=TOL)
