"""The port's optimizer update ops against the reference's, on the CPU.

``tests/test_torch_ops.py`` holds every op's float32 case
(``OPTIMIZER_CASES``). Here, from the same numpy inputs:

- the registry: the port registers every update op the reference does
  (its 33 in ``mxnet_tpu/ops/optimizer_ops.py``), under the same aliases;
- ``clip_gradient=0`` clamps the gradient to zero in every op that clips
  (clipping is on at ``>= 0``), as in the reference;
- the ``mp_*`` forms with a bfloat16 weight and gradient and a float32
  master: the float32 outputs within 1e-5 of the reference's (relative and
  absolute), the bfloat16 weight the port's own master rounded, and within
  one bfloat16 rounding (2^-8 of its max) of the reference's;
- ``nd.<op>(...)`` writes each op's new states back into its state arrays
  and returns the rest, as the reference's nd wrapper does (1e-5);
- the lazy row-sparse forms raise, naming ROADMAP A9.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu_torch as mt
from mxnet_tpu_torch.ops import optimizer_ops as oo
from mxnet_tpu_torch.ops.registry import all_ops, get_op
from test_torch_ops import OPTIMIZER_CASES
from torch_threads import one_torch_thread  # noqa: F401

TOL = 1e-5
_rs = np.random.RandomState(7)


def _f(*shape):
    return _rs.normal(0, 1, shape).astype(np.float32)


@pytest.fixture(scope="module")
def ref():
    import jax.numpy as jnp
    import mxnet_tpu as mx
    from mxnet_tpu.ops import optimizer_ops as ref_oo  # noqa: F401  (registers the ops)
    from mxnet_tpu.ops.registry import all_ops as ref_all_ops, get_op as ref_get_op
    return mx, jnp, ref_all_ops, ref_get_op


def _ref_names(ref):
    return {op.name for op in ref[2]().values()
            if op.fn.__module__ == "mxnet_tpu.ops.optimizer_ops"}


def test_registry_holds_every_reference_update_op(ref):
    names = _ref_names(ref)
    assert len(names) == 33
    port = {op.name for op in all_ops().values() if op.fn.__module__ == oo.__name__}
    assert port == names
    for alias, op in ref[2]().items():
        if op.name in names:
            assert get_op(alias).name == op.name, alias


# (op, inputs, params): every op that clips, at clip_gradient = 0
_W, _G = _f(3, 4), _f(3, 4)
_W2, _G2 = _f(5), _f(5)
CLIP0 = [
    ("sgd_update", [_W, _G], {"lr": 0.1, "wd": 0.01}),
    ("sgd_mom_update", [_W, _G, _f(3, 4)], {"lr": 0.1, "momentum": 0.9}),
    ("mp_sgd_update", [_W, _G, _W.copy()], {"lr": 0.1, "wd": 0.01}),
    ("mp_sgd_mom_update", [_W, _G, _f(3, 4), _W.copy()], {"lr": 0.1, "momentum": 0.9}),
    ("nag_mom_update", [_W, _G, _f(3, 4)], {"lr": 0.1, "momentum": 0.9, "wd": 0.01}),
    ("mp_nag_mom_update", [_W, _G, _f(3, 4), _W.copy()], {"lr": 0.1, "momentum": 0.9}),
    ("signsgd_update", [_W, _G], {"lr": 0.1, "wd": 0.01}),
    ("signum_update", [_W, _G, _f(3, 4)], {"lr": 0.1, "momentum": 0.9, "wd": 0.01}),
    ("adam_update", [_W, _G, _f(3, 4), _f(3, 4) ** 2], {"lr": 0.01, "wd": 0.1}),
    ("_adamw_update", [_W, _G, _f(3, 4), _f(3, 4) ** 2, np.array(1.0, np.float32)],
     {"lr": 0.01, "eta": 1.0, "wd": 0.1}),
    ("ftrl_update", [_W, _G, _f(3, 4), _f(3, 4) ** 2], {"lr": 0.1}),
    ("ftml_update", [_W, _G, _f(3, 4) ** 2 + 0.1, _f(3, 4) ** 2, _f(3, 4)],
     {"lr": 0.1, "t": 2, "wd": 0.01}),
    ("rmsprop_update", [_W, _G, _f(3, 4) ** 2], {"lr": 0.01, "wd": 0.1}),
    ("rmspropalex_update", [_W, _G, _f(3, 4) ** 2 + 1.0, _f(3, 4) * 0.1, _f(3, 4)],
     {"lr": 0.01, "wd": 0.1}),
    ("_sparse_adagrad_update", [_W, _G, _f(3, 4) ** 2 + 0.1], {"lr": 0.1, "wd": 0.01}),
    ("_contrib_group_adagrad_update", [_W, _G, _f(3) ** 2 + 0.1], {"lr": 0.1}),
    ("lamb_update_phase1", [_W, _G, _f(3, 4), _f(3, 4) ** 2], {"t": 2, "wd": 0.01}),
    ("mp_lamb_update_phase1", [_W, _G, _f(3, 4), _f(3, 4) ** 2, _W.copy()], {"t": 2}),
    ("multi_sgd_update", [_W, _G, _W2, _G2],
     {"lrs": (0.1, 0.2), "wds": (0.01, 0.0), "num_weights": 2}),
    ("multi_mp_sgd_mom_update", [_W, _G, _f(3, 4), _W.copy(), _W2, _G2, _f(5), _W2.copy()],
     {"lrs": (0.1, 0.2), "wds": (0.01, 0.0), "num_weights": 2, "momentum": 0.9}),
    ("preloaded_multi_sgd_mom_update",
     [_W, _G, _f(3, 4), _W2, _G2, _f(5), np.float32([0.1, 0.2]), np.float32([0.0, 0.01])],
     {"num_weights": 2, "momentum": 0.9}),
    ("_multi_adamw_update", [_W, _G, _f(3, 4), _f(3, 4) ** 2, _W2, _G2, _f(5),
                             _f(5) ** 2, np.array(1.0, np.float32)],
     {"lrs": (0.01, 0.02), "etas": (1.0, 1.0), "wds": (0.1, 0.0), "num_weights": 2}),
]


WD_IN_CLIP = {"adam_update", "ftml_update", "rmsprop_update", "rmspropalex_update"}


def _port(name, arrays, params):
    out = get_op(name)(*(torch.from_numpy(np.asarray(a)) for a in arrays), **params)
    return [o.float().numpy() for o in (out if isinstance(out, tuple) else (out,))]


def _ref(ref, name, arrays, params):
    jnp = ref[1]
    out = ref[3](name)(*(jnp.asarray(a) for a in arrays), **params)
    return [np.asarray(o, np.float32) for o in (out if isinstance(out, tuple) else (out,))]


def _clip_key(name):
    return "clip_grad" if name == "ftml_update" else "clip_gradient"


@pytest.mark.parametrize("name,arrays,params", CLIP0, ids=[c[0] for c in CLIP0])
def test_clip_gradient_zero_clamps_to_zero(ref, name, arrays, params):
    """At clip 0 each op sees a zero gradient: the port equals the
    reference, and equals the port given the gradient zeroed (and, where wd
    joins the gradient before the clip, no wd)."""
    kw = dict(params, **{_clip_key(name): 0.0})
    got = _port(name, arrays, kw)
    for g, e in zip(got, _ref(ref, name, arrays, kw)):
        np.testing.assert_allclose(g, e, rtol=TOL, atol=TOL)
    if name == "_sparse_adagrad_update":
        return          # its live rows are read from the gradient before the clip
    zeroed = [np.zeros_like(a) if a is _G or a is _G2 else a for a in arrays]
    # the Adam, FTML and RMSProp family clips rescale*g + wd*w: both go
    plain = dict(params, wd=0.0) if name in WD_IN_CLIP else params
    for g, e in zip(got, _port(name, zeroed, plain)):
        np.testing.assert_allclose(g, e, rtol=TOL, atol=TOL)


def _bf16(a):
    return torch.from_numpy(a).to(torch.bfloat16)


# the mp_ forms with bfloat16 weights and gradients: (op, layout, weights, params)
def _mp_inputs(layout, n=1):
    """Inputs of an mp op by layout letters, ``n`` times: w (a bf16 weight),
    g (a bf16 grad), s (a float32 state), v (a positive float32 state), m
    (the float32 master of the last w)."""
    out = []
    for _ in range(n):
        for c in layout:
            if c == "w":
                wt = _bf16(_f(3, 4))
                out.append(wt)
            elif c == "g":
                out.append(_bf16(_f(3, 4)))
            elif c == "s":
                out.append(torch.from_numpy(_f(3, 4)))
            elif c == "v":
                out.append(torch.from_numpy(_f(3, 4) ** 2))
            else:
                out.append(wt.float())
    return out


MP = [
    ("mp_sgd_update", "wgm", 1, {"lr": 0.1, "wd": 0.01, "clip_gradient": 0.5}),
    ("mp_sgd_mom_update", "wgsm", 1, {"lr": 0.1, "momentum": 0.9, "wd": 0.01}),
    ("mp_nag_mom_update", "wgsm", 1, {"lr": 0.1, "momentum": 0.9, "rescale_grad": 0.5}),
    ("_mp_adamw_update", "wgsvm", 1, {"lr": 0.01, "eta": 1.0, "wd": 0.1}),
    ("mp_lamb_update_phase1", "wgsvm", 1, {"t": 3, "wd": 0.01}),
    ("multi_mp_sgd_update", "wgm", 2, {"lrs": (0.1, 0.2), "wds": (0.01, 0.0),
                                      "num_weights": 2}),
    ("multi_mp_sgd_mom_update", "wgsm", 2, {"lrs": (0.1, 0.2), "wds": (0.01, 0.0),
                                           "num_weights": 2, "momentum": 0.9}),
    ("preloaded_multi_mp_sgd_update", "wgm", 2, {"num_weights": 2}),
    ("preloaded_multi_mp_sgd_mom_update", "wgsm", 2, {"num_weights": 2, "momentum": 0.9}),
    ("_multi_mp_adamw_update", "wgsvm", 2, {"lrs": (0.01, 0.02), "etas": (1.0, 0.5),
                                           "wds": (0.1, 0.0), "num_weights": 2}),
    ("mp_lamb_update_phase2", "wsvvm", 1, {"lr": 0.1}),
]


@pytest.mark.parametrize("name,layout,n,params", MP, ids=[c[0] for c in MP])
def test_mp_forms_take_a_bf16_weight(ref, name, layout, n, params):
    inputs = _mp_inputs(layout, n)
    if name.startswith("preloaded"):
        inputs += [torch.tensor([0.1, 0.2]), torch.tensor([0.01, 0.0])]
    if "adamw" in name:
        inputs.append(torch.tensor(1.0))
    if name == "mp_lamb_update_phase2":       # g, r1, r2 as the op takes them
        inputs[2], inputs[3] = torch.tensor(1.5), torch.tensor(2.0)
    got = get_op(name)(*inputs, **params)
    jnp = ref[1]
    expect = ref[3](name)(*(jnp.asarray(t.float().numpy()).astype(
        jnp.bfloat16 if t.dtype == torch.bfloat16 else jnp.float32) for t in inputs),
        **params)
    got = got if isinstance(got, tuple) else (got,)
    expect = expect if isinstance(expect, tuple) else (expect,)
    assert len(got) == len(expect)
    n_w = params.get("num_weights", 1)
    k = (len(got) - n_w) // n_w             # states a weight, its new master the last
    for i, (g, e) in enumerate(zip(got, expect)):
        e = np.asarray(e, np.float32)
        if g.dtype == torch.bfloat16:
            assert i < n_w
            assert torch.equal(g, got[n_w + i * k + k - 1].to(torch.bfloat16))
            assert np.abs(g.float().numpy() - e).max() <= 2.0 ** -8 * np.abs(e).max()
        else:
            np.testing.assert_allclose(g.numpy(), e, rtol=TOL, atol=TOL)


def _stateful_cases():
    return [c for c in OPTIMIZER_CASES if get_op(c[1]).state_inputs]


@pytest.mark.parametrize("name,arrays,params", [c[1:] for c in _stateful_cases()],
                         ids=[c[0] for c in _stateful_cases()])
def test_nd_writes_states_back(ref, name, arrays, params):
    """``nd.<op>`` in both packages: the returned arrays and the state
    arrays after the call."""
    mx = ref[0]
    port_in = [mt.nd.array(a, ctx=mt.cpu()) for a in arrays]
    ref_in = [mx.nd.array(a) for a in arrays]
    got = getattr(mt.nd, name)(*port_in, **params)
    expect = getattr(mx.nd, name)(*ref_in, **params)
    got = got if isinstance(got, list) else [got]
    expect = expect if isinstance(expect, list) else [expect]
    assert len(got) == len(expect)
    for g, e in zip(got + port_in, expect + ref_in):
        np.testing.assert_allclose(g.asnumpy(), e.asnumpy(), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("fn", ["sgd_lazy_update", "sgd_mom_lazy_update", "adam_lazy_update"])
def test_lazy_forms_raise_naming_a9(fn):
    w = torch.zeros(3)
    args = {"sgd_lazy_update": (w, w, 0.1), "sgd_mom_lazy_update": (w, w, w, 0.1),
            "adam_lazy_update": (w, w, w, w, 0.1)}[fn]
    with pytest.raises(mt.MXNetError, match="ROADMAP A9"):
        getattr(oo, fn)(*args)


def test_sparse_adagrad_leaves_zero_rows():
    """A dense gradient with an all-zero row: that row's weight and history
    keep their values (the reference's arithmetic on the same arrays)."""
    w, h = torch.ones(3, 4), torch.full((3, 4), 0.5)
    g = torch.ones(3, 4)
    g[1] = 0
    w2, h2 = oo.sparse_adagrad_update(w, g, h, 0.1, wd=0.1)
    assert torch.equal(w2[1], w[1]) and torch.equal(h2[1], h[1])
    assert not torch.equal(w2[0], w[0])
