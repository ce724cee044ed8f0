"""Parity sweep: every op the port registers against the reference op of
the same name (``mxnet_tpu.ops.registry.get_op(name)``), same numpy inputs.

Tolerance 1e-5 (relative and absolute) in f32: the two frameworks compute
the same formulas in f32 on the CPU, and differ at most in the order of a
reduction (softmax, LayerNorm, the matrix products) or in the last bits of
erf and exp; integer and layout results must be equal. The reference is
imported by the ``ref_op`` fixture, not at the top, so the module also
imports on a card host without jax.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu_torch as mt
from mxnet_tpu_torch.ops.registry import get_op, list_ops
from torch_threads import one_torch_thread  # noqa: F401

TOL = 1e-5

_rs = np.random.RandomState(0)


def _f(*shape):
    return _rs.normal(0, 1, shape).astype(np.float32)


_X4 = _f(2, 3, 4, 5)


def _sq(*shape):
    return _f(*shape) ** 2 + 0.1


def _w32(w):
    return [w, w.copy()]


_W, _G = _f(3, 4), _f(3, 4)
_SGD_KW = {"lr": 0.1, "wd": 0.01, "rescale_grad": 0.5, "clip_gradient": 0.3}
_MULTI_KW = {"lrs": (0.1, 0.05), "wds": (0.01, 0.0), "num_weights": 2,
             "rescale_grad": 0.5, "clip_gradient": 0.3}
# the optimizer update ops (ops/optimizer_ops.py), float32; their clip at 0,
# the bf16 mp_ forms and the nd write-back are in test_torch_optimizer_ops.py
OPTIMIZER_CASES = [
    ("mp_sgd_update", "mp_sgd_update", [_W, _G, _W.copy()], _SGD_KW),
    ("mp_sgd_mom_update", "mp_sgd_mom_update", [_W, _G, _f(3, 4), _W.copy()],
     dict(_SGD_KW, momentum=0.9)),
    ("nag_mom_update", "nag_mom_update", [_W, _G, _f(3, 4)], dict(_SGD_KW, momentum=0.9)),
    ("mp_nag_mom_update", "mp_nag_mom_update", [_W, _G, _f(3, 4), _W.copy()],
     dict(_SGD_KW, momentum=0.9)),
    ("signsgd_update", "signsgd_update", [_W, _G], _SGD_KW),
    ("signum_update", "signum_update", [_W, _G, _f(3, 4)],
     dict(_SGD_KW, momentum=0.9, wd_lh=0.02)),
    ("adamw_update", "_adamw_update", [_W, _G, _f(3, 4), _sq(3, 4), np.array(0.5, np.float32)],
     {"lr": 0.01, "eta": 0.5, "wd": 0.1, "clip_gradient": 0.2}),
    ("mp_adamw_update", "_mp_adamw_update",
     [_W, _G, _f(3, 4), _sq(3, 4), _W.copy(), np.array(2.0, np.float32)],
     {"lr": 0.01, "eta": 1.0, "wd": 0.1}),
    ("ftrl_update", "ftrl_update", [_W, _G, _f(3, 4), _sq(3, 4)],
     {"lr": 0.1, "lamda1": 0.05, "beta": 1.0, "wd": 0.01, "rescale_grad": 0.5}),
    ("ftml_update", "ftml_update", [_W, _G, _sq(3, 4), _sq(3, 4), _f(3, 4)],
     {"lr": 0.1, "t": 3, "wd": 0.01, "clip_grad": 0.4}),
    ("rmsprop_update", "rmsprop_update", [_W, _G, _sq(3, 4)],
     {"lr": 0.01, "rho": 0.9, "wd": 0.01, "clip_gradient": 0.3, "clip_weights": 1.0}),
    ("rmspropalex_update", "rmspropalex_update",
     [_W, _G, _sq(3, 4) + 1.0, _f(3, 4) * 0.1, _f(3, 4)],
     {"lr": 0.01, "rho": 0.9, "momentum": 0.8, "wd": 0.01}),
    ("sparse_adagrad_update", "_sparse_adagrad_update",
     [_W, _G * np.array([[1], [0], [1]], np.float32), _sq(3, 4)],
     {"lr": 0.1, "wd": 0.01, "rescale_grad": 0.5}),
    ("group_adagrad_update", "_contrib_group_adagrad_update", [_W, _G, _sq(3)],
     {"lr": 0.1, "clip_gradient": 0.5}),
    ("lamb_update_phase1", "lamb_update_phase1", [_W, _G, _f(3, 4), _sq(3, 4)],
     {"t": 3, "wd": 0.01, "rescale_grad": 0.5, "clip_gradient": 0.3}),
    ("lamb_update_phase1-nobias", "lamb_update_phase1", [_W, _G, _f(3, 4), _sq(3, 4)],
     {"t": 3, "bias_correction": False}),
    ("lamb_update_phase2", "lamb_update_phase2",
     [_W, _G, np.array(1.5, np.float32), np.array(2.0, np.float32)],
     {"lr": 0.1, "lower_bound": 2.0, "upper_bound": 10.0}),
    ("mp_lamb_update_phase1", "mp_lamb_update_phase1",
     [_W, _G, _f(3, 4), _sq(3, 4), _W.copy()], {"t": 2, "wd": 0.01}),
    ("mp_lamb_update_phase2", "mp_lamb_update_phase2",
     [_W, _G, np.array(1.5, np.float32), np.array(0.0, np.float32), _W.copy()], {"lr": 0.1}),
    ("multi_sum_sq", "multi_sum_sq", [_W, _f(5)], {"num_arrays": 2}),
    ("multi_lars", "multi_lars",
     [np.float32([0.1, 0.2, 0.3]), np.float32([4.0, 0.0, 9.0]), np.float32([1.0, 1.0, 0.0]),
      np.float32([0.01, 0.0, 0.1])], {"eta": 0.001, "eps": 1e-8, "rescale_grad": 0.5}),
    ("multi_sgd_update", "multi_sgd_update", [_W, _G, _f(5), _f(5)], _MULTI_KW),
    ("multi_sgd_mom_update", "multi_sgd_mom_update",
     [_W, _G, _f(3, 4), _f(5), _f(5), _f(5)], dict(_MULTI_KW, momentum=0.9)),
    ("multi_mp_sgd_update", "multi_mp_sgd_update",
     [_W, _G, _W.copy(), _G, _W, _G.copy()], _MULTI_KW),
    ("multi_mp_sgd_mom_update", "multi_mp_sgd_mom_update",
     [_W, _G, _f(3, 4), _W.copy(), _G, _W, _f(3, 4), _G.copy()],
     dict(_MULTI_KW, momentum=0.9)),
    ("preloaded_multi_sgd_update", "preloaded_multi_sgd_update",
     [_W, _G, _f(5), _f(5), np.float32([0.1, 0.05]), np.float32([0.01, 0.0])],
     {"num_weights": 2, "clip_gradient": 0.3}),
    ("preloaded_multi_sgd_mom_update", "preloaded_multi_sgd_mom_update",
     [_W, _G, _f(3, 4), _f(5), _f(5), _f(5), np.float32([0.1, 0.05]),
      np.float32([0.01, 0.0])], {"num_weights": 2, "momentum": 0.9}),
    ("preloaded_multi_mp_sgd_update", "preloaded_multi_mp_sgd_update",
     [_W, _G, _W.copy(), _G, _W, _G.copy(), np.float32([0.1, 0.05]),
      np.float32([0.01, 0.0])], {"num_weights": 2, "rescale_grad": 0.5}),
    ("preloaded_multi_mp_sgd_mom_update", "preloaded_multi_mp_sgd_mom_update",
     [_W, _G, _f(3, 4), _W.copy(), _G, _W, _f(3, 4), _G.copy(), np.float32([0.1, 0.05]),
      np.float32([0.01, 0.0])], {"num_weights": 2, "momentum": 0.9}),
    ("multi_adamw_update", "_multi_adamw_update",
     [_W, _G, _f(3, 4), _sq(3, 4), _f(5), _f(5), _f(5), _sq(5), np.array(0.5, np.float32)],
     {"lrs": (0.01, 0.02), "etas": (1.0, 0.5), "wds": (0.1, 0.0), "num_weights": 2,
      "clip_gradient": 0.3}),
    ("multi_mp_adamw_update", "_multi_mp_adamw_update",
     [_W, _G, _f(3, 4), _sq(3, 4), _W.copy(), _G, _W, _f(3, 4), _sq(3, 4), _G.copy(),
      np.array(1.0, np.float32)],
     {"lrs": (0.01, 0.02), "etas": (1.0, 0.5), "wds": (0.1, 0.0), "num_weights": 2}),
]

# (id, op name, inputs, params)
CASES = [
    ("add", "broadcast_add", [_f(3, 4), _f(4)], {}),
    ("sub", "broadcast_sub", [_f(3, 1), _f(1, 4)], {}),
    ("mul", "broadcast_mul", [_f(2, 3, 4), _f(3, 1)], {}),
    ("div", "broadcast_div", [_f(3, 4), _f(3, 4) + 3.0], {}),
    ("add-int", "broadcast_add", [np.arange(6, dtype=np.int32).reshape(2, 3),
                                  np.ones(3, np.int32)], {}),
    ("plus", "_plus_scalar", [_f(3, 4)], {"scalar": 1.5}),
    ("minus", "_minus_scalar", [_f(3, 4)], {"scalar": 0.25}),
    ("rminus", "_rminus_scalar", [_f(3, 4)], {"scalar": 2.0}),
    ("mulsc", "_mul_scalar", [_f(3, 4)], {"scalar": -1e9}),
    ("divsc", "_div_scalar", [_f(3, 4)], {"scalar": 8.0}),
    ("rdiv", "_rdiv_scalar", [_f(3, 4) + 5.0], {"scalar": 3.0}),
    ("divsc-int", "_div_scalar", [np.arange(-6, 6, dtype=np.int32)],
     {"scalar": 4.0}),
    ("plus-int", "_plus_scalar", [np.arange(6, dtype=np.int32)], {"scalar": 2.7}),
    ("negative", "negative", [_f(3, 4)], {}),
    ("cast-f16", "Cast", [_f(3, 4)], {"dtype": "float16"}),
    ("cast-int", "Cast", [_f(3, 4) * 10], {"dtype": "int32"}),
    ("gelu", "gelu", [_f(4, 6) * 3], {}),
    ("gelu-tanh", "gelu", [_f(4, 6) * 3], {"approximate": True}),
    ("reshape-copy-infer", "Reshape", [_X4], {"shape": (0, -1)}),
    ("reshape-infer", "Reshape", [_X4], {"shape": (-1,)}),
    ("reshape-rest", "Reshape", [_X4], {"shape": (0, -2)}),
    ("reshape-merge-front", "Reshape", [_X4], {"shape": (-3, 0, 0)}),
    ("reshape-merge-back", "Reshape", [_X4], {"shape": (0, 0, -3)}),
    ("reshape-split", "Reshape", [_X4], {"shape": (-4, 1, 2, 0, 0, 0)}),
    ("reshape-split-infer", "Reshape", [_X4], {"shape": (0, 0, -4, -1, 2, 0)}),
    ("reshape-literal", "Reshape", [_X4], {"shape": (6, 20)}),
    ("reshape-bert-heads", "Reshape", [_f(2, 7, 3, 2, 4)],
     {"shape": (0, 0, -3, 0)}),
    ("reshape-reverse", "Reshape", [_X4], {"shape": (-1, 0), "reverse": True}),
    ("transpose", "transpose", [_X4], {"axes": (0, 2, 1, 3)}),
    ("transpose-rev", "transpose", [_X4], {}),
    ("expand0", "expand_dims", [_f(3, 4)], {"axis": 0}),
    ("expand-last", "expand_dims", [_f(3, 4)], {"axis": -1}),
    ("slice", "slice_axis", [_X4], {"axis": 2, "begin": 1, "end": 3}),
    ("slice-end-none", "slice_axis", [_X4], {"axis": 1, "begin": 1, "end": None}),
    ("slice-negative", "slice_axis", [_X4], {"axis": -1, "begin": -2, "end": 5}),
    ("batch_dot", "batch_dot", [_f(3, 4, 5), _f(3, 5, 2)], {}),
    ("batch_dot-ta", "batch_dot", [_f(3, 5, 4), _f(3, 5, 2)], {"transpose_a": True}),
    ("batch_dot-tb", "batch_dot", [_f(3, 4, 5), _f(3, 2, 5)], {"transpose_b": True}),
    ("arange-int", "_arange", [], {"start": 0, "stop": 10, "dtype": "int32"}),
    ("arange-float", "_arange", [], {"start": 2.5, "stop": 7, "step": 0.5,
                                     "dtype": "float32"}),
    ("arange-repeat", "_arange", [], {"start": 4, "repeat": 2, "dtype": "float32"}),
    ("fc-flatten", "FullyConnected", [_f(2, 3, 4), _f(5, 12), _f(5)],
     {"num_hidden": 5}),
    ("fc-3d", "FullyConnected", [_f(2, 3, 4), _f(5, 4), _f(5)],
     {"num_hidden": 5, "flatten": False}),
    ("fc-nobias", "FullyConnected", [_f(2, 4), _f(5, 4)],
     {"num_hidden": 5, "no_bias": True}),
    ("layernorm", "LayerNorm", [_f(2, 3, 8) * 2 + 1, _f(8), _f(8)], {}),
    ("layernorm-axis1", "LayerNorm", [_f(2, 6, 3), _f(6), _f(6)],
     {"axis": 1, "eps": 1e-3}),
    ("act-relu", "Activation", [_f(3, 4)], {"act_type": "relu"}),
    ("act-sigmoid", "Activation", [_f(3, 4)], {"act_type": "sigmoid"}),
    ("act-tanh", "Activation", [_f(3, 4)], {"act_type": "tanh"}),
    ("act-softrelu", "Activation", [_f(3, 4)], {"act_type": "softrelu"}),
    ("act-softsign", "Activation", [_f(3, 4)], {"act_type": "softsign"}),
    ("act-gelu", "Activation", [_f(3, 4)], {"act_type": "gelu"}),
    ("act-silu", "Activation", [_f(3, 4)], {"act_type": "silu"}),
    ("softmax", "softmax", [_f(2, 3, 7)], {"axis": -1}),
    ("softmax-axis1", "softmax", [_f(2, 3, 7)], {"axis": 1}),
    ("softmax-temp", "softmax", [_f(2, 7)], {"temperature": 2.0}),
    ("softmax-length", "softmax", [_f(2, 7), np.array([3, 7], np.int32)],
     {"use_length": True}),
    ("softmax-f16", "softmax", [_f(2, 7)], {"dtype": "float16"}),
    ("embedding", "Embedding", [np.array([[0, 3], [9, 3]], np.int32), _f(10, 4)],
     {"input_dim": 10, "output_dim": 4}),
    ("embedding-float-ids", "Embedding", [np.array([1.0, 4.0], np.float32),
                                          _f(5, 3)], {}),
    ("flash", "_contrib_flash_attention", [_f(1, 2, 130, 32), _f(1, 2, 130, 32),
                                           _f(1, 2, 130, 32)], {}),
    ("flash-causal", "_contrib_flash_attention",
     [_f(1, 2, 64, 32), _f(1, 2, 64, 32), _f(1, 2, 64, 32)],
     {"causal": True, "block_size": 32}),
    ("sum-axis", "sum", [_X4], {"axis": 1}),
    ("sum-all", "sum", [_X4], {}),
    ("sum-exclude-keepdims", "sum", [_X4], {"axis": (0, 2), "exclude": True,
                                             "keepdims": True}),
    ("sum-int", "sum", [np.arange(12, dtype=np.int32).reshape(3, 4)], {"axis": 0}),
    ("mean-exclude", "mean", [_f(4, 3, 1)], {"axis": 0, "exclude": True}),
    ("mean-keepdims", "mean", [_X4], {"axis": -1, "keepdims": True}),
    ("log_softmax", "log_softmax", [_f(2, 3, 7) * 4], {"axis": -1}),
    ("log_softmax-axis1", "log_softmax", [_f(2, 3, 7)], {"axis": 1,
                                                         "temperature": 2.0}),
    ("pick-clip", "pick", [_f(3, 5), np.array([0, 4, 7], np.float32)], {}),
    ("pick-keepdims-axis0", "pick", [_f(3, 5), np.array([2, 0, 1, 1, 2], np.int32)],
     {"axis": 0, "keepdims": True}),
    ("pick-wrap", "pick", [_f(2, 3, 4), np.array([[5, -1, 2], [0, 3, 9]], np.int32)],
     {"mode": "wrap"}),
    ("sgd_update", "sgd_update", [_f(3, 4), _f(3, 4)],
     {"lr": 0.1, "wd": 0.01, "rescale_grad": 0.5, "clip_gradient": 0.3}),
    ("sgd_mom_update", "sgd_mom_update", [_f(3, 4), _f(3, 4), _f(3, 4)],
     {"lr": 0.1, "momentum": 0.9, "wd": 0.01, "rescale_grad": 2.0}),
    ("adam_update", "adam_update", [_f(3, 4), _f(3, 4), _f(3, 4), _f(3, 4) ** 2],
     {"lr": 0.01, "wd": 0.1, "rescale_grad": 0.5, "clip_gradient": 0.2}),
    ("flatten", "Flatten", [_X4], {}),
    ("conv2d", "Convolution", [_f(2, 3, 7, 7), _f(4, 3, 3, 3), _f(4)],
     {"kernel": (3, 3), "num_filter": 4, "stride": (2, 2), "pad": (1, 1)}),
    ("pool-max-full", "Pooling", [_f(2, 3, 5, 5)],
     {"kernel": (3, 3), "stride": (3, 3), "pad": (1, 1), "pooling_convention": "full"}),
    ("pool-avg", "Pooling", [_f(2, 3, 6, 6)],
     {"kernel": (2, 2), "stride": (2, 2), "pool_type": "avg"}),
    ("batchnorm", "BatchNorm", [_X4, _f(3), _f(3), _f(3), _f(3) ** 2 + 0.5],
     {"fix_gamma": False}),
    ("square", "square", [_f(3, 4)], {}),
    ("abs", "abs", [_f(3, 4)], {}),
    ("relu", "relu", [_f(3, 4)], {}),
    ("log", "log", [np.abs(_f(3, 4)) + 0.1], {}),
    ("exp", "exp", [_f(3, 4)], {}),
    ("zeros_like", "zeros_like", [_f(2, 3)], {}),
    ("zeros_like-int", "zeros_like", [np.arange(4, dtype=np.int32)], {}),
    ("where", "where", [(_f(3, 4) > 0).astype(np.float32), _f(3, 4), _f(3, 4)], {}),
    ("where-broadcast", "where", [np.array([1, 0, 1], np.float32), _f(3), _f(1)], {}),
    ("swapaxes", "swapaxes", [_X4], {"dim1": 0, "dim2": 2}),
    ("norm-all", "norm", [_X4], {}),
    ("norm-axis", "norm", [_X4], {"axis": -1}),
    ("norm-l1-keepdims", "norm", [_X4], {"ord": 1, "axis": (1, 2), "keepdims": True}),
    ("norm-p3", "norm", [_f(3, 5)], {"ord": 3, "axis": 1}),
    ("ctc-last", "CTCLoss", [_f(6, 2, 5), np.array([[0, 1, -1], [2, 2, 3]], np.float32)],
     {"blank_label": "last"}),
    ("ctc-first-lengths", "CTCLoss",
     [_f(7, 2, 4), np.array([[1, 2, 0], [3, 0, 0]], np.int32), np.array([7, 5], np.int32),
      np.array([2, 1], np.int32)],
     {"use_data_lengths": True, "use_label_lengths": True}),
    *[(f"cmp-{n}", n, [_f(3, 4), _f(4)], {}) for n in
      ("broadcast_equal", "broadcast_not_equal", "broadcast_greater",
       "broadcast_greater_equal", "broadcast_lesser", "broadcast_lesser_equal")],
    ("cmp-equal-ints", "broadcast_equal", [np.array([1, 2, 3], np.int32),
                                           np.array([1, 0, 3], np.int32)], {}),
    *[(f"cmp-{n}", n, [np.round(_f(3, 4))], {"scalar": 0.0}) for n in
      ("_equal_scalar", "_not_equal_scalar", "_greater_scalar", "_greater_equal_scalar",
       "_lesser_scalar", "_lesser_equal_scalar")],
    ("cmp-scalar-int", "_lesser_equal_scalar", [np.arange(6, dtype=np.int32)],
     {"scalar": 2.5}),
    *OPTIMIZER_CASES,
]
_ra = np.random.RandomState(20)   # the A5 cases' own stream: the cases above keep theirs


def _a(*shape):
    return _ra.normal(0, 1, shape).astype(np.float32)


def _spd(*batch, n=4):
    m = _a(*batch, n, n)
    return (m @ np.swapaxes(m, -1, -2) + n * np.eye(n, dtype=np.float32)).astype(np.float32)


def _lower(*batch, n=4):
    return (np.tril(_a(*batch, n, n)) + 3 * np.eye(n, dtype=np.float32)).astype(np.float32)


_X3 = _a(2, 3, 4)
# the NDArray methods' ops, the reductions, linalg (well-conditioned: the
# symmetric positive definite and triangular inputs are shifted by a
# multiple of the identity) and the elementwise ops that A5 added
A5_CASES = [
    ("power", "broadcast_power", [np.abs(_a(3, 4)) + 0.5, _a(4)], {}),
    ("mod", "broadcast_mod", [_a(3, 4) * 5, np.float32([1.5, -2.0, 3.0, 0.7])], {}),
    ("maximum", "_maximum", [_a(3, 4), _a(3, 4)], {}),
    ("minimum", "_minimum", [_a(3, 4), _a(1, 4)], {}),
    *[(f"sc-{n}", n, [np.abs(_a(3, 4)) + 0.5], {"scalar": 1.5}) for n in
      ("_mod_scalar", "_rmod_scalar", "_power_scalar", "_rpower_scalar",
       "_maximum_scalar", "_minimum_scalar")],
    ("mod-int", "_mod_scalar", [np.arange(-6, 6, dtype=np.int32)], {"scalar": 4}),
    *[(n, n, [_a(3, 4)], {}) for n in ("sign", "sigmoid", "tanh", "floor", "ceil",
                                       "ones_like")],
    ("round-halves", "round", [np.float32([-2.5, -1.5, -0.5, 0.5, 1.5, 2.5, 0.7])], {}),
    ("sqrt", "sqrt", [np.abs(_a(3, 4))], {}),
    ("clip", "clip", [_a(3, 4)], {"a_min": -0.5, "a_max": 0.3}),
    ("squeeze", "squeeze", [_a(2, 1, 3, 1)], {}),
    ("squeeze-axis", "squeeze", [_a(2, 1, 3, 1)], {"axis": (1,)}),
    ("broadcast_to", "broadcast_to", [_a(1, 3, 1)], {"shape": (2, 0, 4)}),
    ("broadcast_like", "broadcast_like", [_a(1, 4), _a(3, 4)], {}),
    ("broadcast_like-axes", "broadcast_like", [_a(1, 4), _a(5, 6)],
     {"lhs_axes": (0,), "rhs_axes": (0,)}),
    ("slice", "slice", [_X3], {"begin": (0, 1), "end": (2, 3)}),
    ("slice-step", "slice", [_X3], {"begin": (None, 2, 3), "end": (None, None, 0),
                                    "step": (1, -1, -2)}),
    ("reverse", "reverse", [_X3], {"axis": 1}),
    ("reverse-2", "reverse", [_X3], {"axis": (0, 2)}),
    ("tile", "tile", [_a(2, 3)], {"reps": (2, 1, 2)}),
    ("repeat", "repeat", [_a(2, 3)], {"repeats": 2, "axis": 1}),
    ("repeat-flat", "repeat", [_a(2, 3)], {"repeats": 3}),
    ("concat", "Concat", [_a(2, 3), _a(2, 1)], {"dim": 1}),
    ("stack", "stack", [_a(2, 3), _a(2, 3), _a(2, 3)], {"axis": 1}),
    ("split", "SliceChannel", [_a(2, 6)], {"num_outputs": 3}),
    ("split-squeeze", "SliceChannel", [_a(3, 2)], {"num_outputs": 3, "axis": 0,
                                                    "squeeze_axis": True}),
    ("take", "take", [_a(5, 3), np.array([[0, 4], [7, -1]], np.int32)], {}),
    ("take-wrap-axis1", "take", [_a(2, 5), np.array([1, 6, -2], np.float32)],
     {"axis": 1, "mode": "wrap"}),
    ("one_hot", "one_hot", [np.array([0, 2, 5, -1], np.int32)], {"depth": 4}),
    ("one_hot-values", "one_hot", [np.array([[1, 0]], np.float32)],
     {"depth": 3, "on_value": 2.0, "off_value": -1.0, "dtype": "int32"}),
    ("sort", "sort", [_a(3, 5)], {}),
    ("sort-desc-axis0", "sort", [_a(3, 5)], {"axis": 0, "is_ascend": False}),
    ("argsort", "argsort", [_a(3, 5)], {}),
    ("argsort-desc", "argsort", [_a(3, 5)], {"is_ascend": False, "dtype": "int32"}),
    ("topk", "topk", [_a(3, 6)], {"k": 2}),
    ("topk-value-asc", "topk", [_a(3, 6)], {"k": 3, "axis": 0, "ret_typ": "value",
                                            "is_ascend": True}),
    ("topk-both", "topk", [_a(4, 5)], {"k": 2, "ret_typ": "both"}),
    ("dot", "dot", [_a(2, 3, 4), _a(4, 5)], {}),
    ("dot-vec", "dot", [_a(4), _a(4)], {}),
    ("dot-transpose", "dot", [_a(4, 3), _a(5, 4)], {"transpose_a": True,
                                                   "transpose_b": True}),
    ("prod", "prod", [_a(2, 3, 4) * 0.5 + 1], {"axis": (0, 2)}),
    ("prod-int", "prod", [np.arange(1, 7, dtype=np.int32).reshape(2, 3)], {"axis": 1}),
    ("max", "max", [_X3], {"axis": 1, "keepdims": True}),
    ("max-exclude", "max", [_X3], {"axis": 1, "exclude": True}),
    ("min", "min", [_X3], {}),
    ("nansum", "nansum", [np.where(_X3 > 1, np.nan, _X3).astype(np.float32)], {"axis": -1}),
    ("nanprod", "nanprod", [np.where(_X3 > 1, np.nan, _X3).astype(np.float32)], {"axis": 0}),
    ("argmax", "argmax", [_X3], {"axis": 2}),
    ("argmax-flat", "argmax", [_X3], {}),
    ("argmin-keepdims", "argmin", [_X3], {"axis": 0, "keepdims": True}),
    ("argmax_channel", "argmax_channel", [_X3], {}),
    ("logsumexp", "logsumexp", [_X3 * 10], {"axis": (1, 2)}),
    ("logsumexp-all", "logsumexp", [_X3], {"keepdims": True}),
    ("moments", "moments", [_X3], {"axes": (0, 2)}),
    ("moments-keepdims", "moments", [_X3], {"axes": 1, "keepdims": True}),
    ("square_sum", "_square_sum", [_X3], {"axis": 1}),
    ("square_sum-exclude", "_square_sum", [_X3], {"axis": 1, "exclude": True,
                                                   "keepdims": True}),
    ("gemm", "linalg_gemm", [_a(2, 3, 4), _a(2, 5, 4), _a(2, 3, 5)],
     {"transpose_b": True, "alpha": 0.5, "beta": 2.0}),
    ("gemm2", "linalg_gemm2", [_a(4, 3), _a(4, 5)], {"transpose_a": True, "alpha": 3.0}),
    ("potrf", "linalg_potrf", [_spd(2)], {}),
    ("potri", "linalg_potri", [np.linalg.cholesky(_spd(2)).astype(np.float32)], {}),
    ("trsm", "linalg_trsm", [_lower(2), _a(2, 4, 3)], {"alpha": 2.0}),
    ("trsm-right-t", "linalg_trsm", [_lower(2), _a(2, 3, 4)], {"rightside": True,
                                                               "transpose": True}),
    ("trsm-upper", "linalg_trsm", [np.swapaxes(_lower(2), -1, -2).copy(), _a(2, 4, 3)],
     {"lower": False}),
    ("trmm", "linalg_trmm", [_a(2, 4, 4), _a(2, 4, 3)], {"alpha": 0.5}),
    ("trmm-right-t", "linalg_trmm", [_a(4, 4), _a(3, 4)], {"rightside": True,
                                                          "transpose": True}),
    ("sumlogdiag", "linalg_sumlogdiag", [_spd(3)], {}),
    ("syrk", "linalg_syrk", [_a(2, 3, 4)], {"alpha": 2.0}),
    ("syrk-t", "linalg_syrk", [_a(3, 4)], {"transpose": True}),
    ("extractdiag", "linalg_extractdiag", [_a(2, 4, 4)], {"offset": -1}),
    ("makediag", "linalg_makediag", [_a(2, 3)], {"offset": 1}),
    ("extracttrian", "linalg_extracttrian", [_a(2, 4, 4)], {}),
    ("extracttrian-upper", "linalg_extracttrian", [_a(4, 4)], {"offset": 1, "lower": False}),
    ("maketrian", "linalg_maketrian", [_a(2, 10)], {}),
    ("maketrian-upper", "linalg_maketrian", [_a(6)], {"lower": False}),
    ("gelqf", "linalg_gelqf", [_a(2, 3, 5)], {}),
    ("inverse", "linalg_inverse", [_spd(2)], {}),
    ("det", "linalg_det", [_spd(3) * 0.5], {}),
    ("slogdet", "linalg_slogdet", [_a(2, 4, 4) + 3 * np.eye(4, dtype=np.float32)], {}),
]
CASES += A5_CASES
# ops held elsewhere, not by value here: the random draws (the two packages'
# generators differ) by moments and a KS test, and syevd (an eigenvector's
# sign is its solver's) by its reconstruction, in test_torch_linalg_random.py
HELD_ELSEWHERE = {"linalg_syevd", "_random_uniform", "_random_normal",
                  "_random_uniform_like", "_random_normal_like", "_sample_multinomial",
                  "_sample_uniform", "_sample_normal", "_sample_gamma",
                  "_sample_exponential", "_sample_poisson", "_sample_negative_binomial",
                  "_sample_generalized_negative_binomial"}

# Dropout outside training, or at p=0, is the identity. The reference op
# takes an RNG key as a second input; the port draws from its generator.
DROPOUT = [("dropout-predict", {"p": 0.5, "training": False}),
           ("dropout-p0", {"p": 0.0, "training": True})]


@pytest.fixture(scope="module")
def ref_op():
    import jax.numpy as jnp
    from mxnet_tpu.ops.registry import get_op as ref_get_op
    def run(name, *arrays, **params):
        out = ref_get_op(name)(*(jnp.asarray(a) for a in arrays), **params)
        return [np.asarray(o) for o in out] if isinstance(out, tuple) else np.asarray(out)
    return run


def _port(name, arrays, params):
    out = get_op(name)(*(torch.from_numpy(a) for a in arrays), **params)
    if isinstance(out, tuple):  # one array per output, as for the reference
        return [_port_array(o) for o in out]
    return _port_array(out)


def _port_array(out):
    return out.float().numpy() if out.dtype == torch.bfloat16 else out.numpy()


@pytest.mark.parametrize("name,arrays,params",
                         [c[1:] for c in CASES], ids=[c[0] for c in CASES])
def test_op_matches_reference(ref_op, name, arrays, params):
    expect = ref_op(name, *arrays, **params)
    got = _port(name, arrays, params)
    assert isinstance(got, list) == isinstance(expect, list)
    for g, e in zip(*((got, expect) if isinstance(got, list) else ([got], [expect]))):
        assert g.shape == e.shape
        assert g.dtype == e.dtype, (g.dtype, e.dtype)
        np.testing.assert_allclose(g, e, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("params", [d[1] for d in DROPOUT],
                         ids=[d[0] for d in DROPOUT])
def test_dropout_identity_matches_reference(ref_op, params):
    x = _f(3, 4)
    expect = ref_op("Dropout", x, np.zeros(2, np.uint32), **params)
    np.testing.assert_array_equal(_port("Dropout", [x], params), expect)


def test_dropout_training_keeps_the_expected_share():
    x = torch.ones(200, 100)
    out = get_op("Dropout")(x, p=0.25, training=True)
    kept = (out != 0).float().mean().item()
    assert abs(kept - 0.75) < 0.02
    assert torch.allclose(out[out != 0], torch.tensor(1 / 0.75))


# NDArray operators and methods, applied alike to both packages' NDArrays
NDARRAY_EXPRS = {
    "add": lambda x, y: x + y, "radd": lambda x, y: 1.5 + x,
    "sub": lambda x, y: x - y, "rsub": lambda x, y: 1.0 - x,
    "mul": lambda x, y: x * 2.0, "rmul": lambda x, y: 2.0 * y,
    "div": lambda x, y: x / y, "rdiv": lambda x, y: 3.0 / y,
    "neg": lambda x, y: -x,
    "add-numpy": lambda x, y: x + np.ones((3, 1), np.float32),
    "reshape": lambda x, y: x.reshape((0, -1)),
    "reshape-args": lambda x, y: x.reshape(-1, 2),
    "transpose": lambda x, y: x.transpose((1, 0, 2)),
    "transpose-rev": lambda x, y: x.transpose(),
    "expand_dims": lambda x, y: x.expand_dims(1),
    "astype": lambda x, y: (x * 10).astype("int32"),
    "eq": lambda x, y: x == x, "ne-scalar": lambda x, y: x != 0.5,
    "gt": lambda x, y: x > y - 4.0, "ge-scalar": lambda x, y: x >= 0.0,
    "lt-scalar": lambda x, y: x < 0.25, "le": lambda x, y: x <= y - 4.0,
}


@pytest.fixture(scope="module")
def ref_nd():
    import mxnet_tpu as mx
    return lambda a: mx.nd.array(a, ctx=mx.cpu())


@pytest.mark.parametrize("expr", list(NDARRAY_EXPRS), ids=list(NDARRAY_EXPRS))
def test_ndarray_operators_match_reference(ref_nd, expr):
    x, y = _f(2, 3, 4), _f(2, 3, 4) + 4.0
    fn = NDARRAY_EXPRS[expr]
    expect = fn(ref_nd(x), ref_nd(y)).asnumpy()
    got = fn(*(mt.nd.array(a, ctx=mt.cpu()) for a in (x, y)))
    assert got.ctx == mt.cpu()
    assert got.asnumpy().dtype == expect.dtype
    np.testing.assert_allclose(got.asnumpy(), expect, rtol=TOL, atol=TOL)


def test_creation_functions_match_reference():
    import mxnet_tpu as mx
    cpu, ref_cpu = mt.cpu(), mx.cpu()
    for src in (np.arange(6), np.linspace(0, 1, 5), np.ones((2, 2), np.float16)):
        got, expect = mt.nd.array(src, ctx=cpu).asnumpy(), mx.nd.array(src, ctx=ref_cpu).asnumpy()
        assert got.dtype == expect.dtype
        np.testing.assert_array_equal(got, expect)
    np.testing.assert_array_equal(mt.nd.zeros((2, 3), ctx=cpu).asnumpy(),
                                  mx.nd.zeros((2, 3), ctx=ref_cpu).asnumpy())
    for args, kw in (((5,), {}), ((0, 7), {"dtype": "int32"}),
                     ((1, 4, 0.5), {"repeat": 2})):
        got = mt.nd.arange(*args, ctx=cpu, **kw).asnumpy()
        expect = mx.nd.arange(*args, ctx=ref_cpu, **kw).asnumpy()
        assert got.dtype == expect.dtype
        np.testing.assert_array_equal(got, expect)


def test_sweep_covers_every_registered_op(ref_op):
    from mxnet_tpu.ops.registry import get_op as ref_get_op
    covered = {c[1] for c in CASES} | {"Dropout"} | HELD_ELSEWHERE
    missing = [n for n in list_ops() if n not in covered]
    assert not missing, f"ops without a parity case: {missing}"
    for name in list_ops():
        ref_get_op(name)  # every port op has a reference op of that name
