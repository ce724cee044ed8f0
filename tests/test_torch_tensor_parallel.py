"""Tensor- and sequence-parallel pieces of the port, on the CPU.

- ``shard_params_megatron`` gives the same (structural name, spec) set as the
  reference's on ``bert_tiny(head_major_qkv=True)``.
- On two ranks of ``torch.distributed`` (gloo, spawned by
  ``_dist_util.launch_local``: one spawn for the module, a 120 s join
  timeout; the ranks import only the port and this module), each boundary
  collective of ``parallel/megatron.py`` forward and backward against the
  computation it partitions, done unsharded here: ``copy_to_tp``,
  ``reduce_from_tp``, ``gather_from_sp``, ``scatter_to_sp``,
  ``partial_grad`` and ``vocab_parallel_embedding``; a column-parallel
  ``Dense`` feeding a row-parallel one (the row-parallel bias added once),
  a vocab-sharded ``Embedding``, BERT's positions under a sequence shard
  (offset by the rank's first token), and the flash op on a sequence shard
  (``sequence_parallel_attention``: local query rows against the gathered
  keys, dK/dV reduce-scattered); and ``convert``'s shard/gather round trip.

Tolerances: float32, only the order of summation differs: 1e-5 of the
largest value (collectives move values exactly; the products sum in other
orders).
"""
import pathlib

import numpy as np
import pytest
import torch

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import _dist_util
from mxnet_tpu_torch.parallel import P, make_mesh
from torch_threads import one_torch_thread  # noqa: F401

MODULE = "test_torch_tensor_parallel"
TESTS_DIR = str(pathlib.Path(__file__).resolve().parent)
TOL = 1e-5
N = 2


def _rs(seed):
    return np.random.RandomState(seed)


def _x(seed, *shape):
    return torch.from_numpy(_rs(seed).randn(*shape).astype(np.float32))


def _lists(d):
    return {k: (v.detach().numpy().tolist() if torch.is_tensor(v) else v)
            for k, v in d.items()}


def _grad_of(fn, *xs, w=None):
    """(output, gradients) of sum(fn(*xs) * w), by default a fixed w."""
    xs = [x.clone().requires_grad_() for x in xs]
    out = fn(*xs)
    w = _x(99, *out.shape) if w is None else w
    (out * w).sum().backward()
    return out.detach(), [x.grad for x in xs]


def rank_pieces():
    """One rank's results for every case (see the module docstring)."""
    from mxnet_tpu_torch import convert
    from mxnet_tpu_torch.gluon import nn
    from mxnet_tpu_torch.models import bert
    from mxnet_tpu_torch.ops.attention import sequence_parallel_attention
    from mxnet_tpu_torch.parallel import activate, megatron
    tp = make_mesh({"tp": N}, devices=[mt.cpu()])
    sp = make_mesh({"sp": N}, devices=[mt.cpu()])
    r = tp.axis_index("tp")
    out = {"rank": r}
    x = _x(1, 4, 6)
    xr = x * (r + 1)                                  # a different input on each rank
    y, (g,) = _grad_of(lambda a: megatron.copy_to_tp(a, "tp", tp), xr)
    out["copy"], out["copy_grad"] = y, g
    y, (g,) = _grad_of(lambda a: megatron.reduce_from_tp(a, "tp", tp), xr)
    out["reduce"], out["reduce_grad"] = y, g
    y, (g,) = _grad_of(lambda a: megatron.gather_from_sp(a, "sp", 1, sp), xr)
    out["gather"], out["gather_grad"] = y, g
    y, (g,) = _grad_of(lambda a: megatron.scatter_to_sp(a, "sp", 1, sp), xr)
    out["scatter"], out["scatter_grad"] = y, g
    y, (g,) = _grad_of(lambda a: megatron.partial_grad(a, "tp", tp), xr)
    out["partial"], out["partial_grad"] = y, g
    ids = torch.from_numpy(_rs(2).randint(0, 10, (3, 5)))
    table = _x(3, 10, 4)
    local = table[r * 5:(r + 1) * 5]
    y, (g,) = _grad_of(lambda t: megatron.vocab_parallel_embedding(ids, t, "tp", tp), local)
    out["vocab_part"], out["vocab_part_grad"] = y, g

    # a column-parallel Dense into a row-parallel one, from full weights
    mlp = nn.HybridSequential()
    mlp.add(nn.Dense(16, in_units=8, flatten=False), nn.Dense(8, in_units=16, flatten=False))
    mlp.initialize(ctx=mt.cpu())
    w = {k: _x(10 + i, *p.shape) for i, (k, p) in
         enumerate(mlp._collect_params_with_prefix().items())}
    convert.load_jax_params(mlp, {k: v.numpy() for k, v in w.items()})
    mlp[0].weight.sharding, mlp[0].bias.sharding = P("tp", None), P("tp")
    mlp[1].weight.sharding = P(None, "tp")
    for p in mlp.collect_params().values():
        if p.sharding is not None:
            p._place(tp)
    xin = mt.nd.array(_x(20, 2, 3, 8).numpy(), ctx=mt.cpu())
    xin.attach_grad()
    with mt.autograd.record():
        y = mlp(xin)
    mt.autograd.backward(y, mt.nd.array(_x(99, *y.shape).numpy(), ctx=mt.cpu()))
    out["mlp"] = y._data
    out["mlp_x_grad"] = xin.grad._data
    out["mlp_grads"] = {k: v.tolist() for k, v in convert.gather_grads(mlp).items()}

    emb = nn.Embedding(10, 4)
    emb.initialize(ctx=mt.cpu())
    emb.weight.set_data(table.numpy())
    emb.weight.sharding = P("tp", None)
    emb.weight._place(tp)
    with mt.autograd.record():
        e = emb(mt.nd.array(ids.numpy(), ctx=mt.cpu(), dtype="int32"))
    mt.autograd.backward(e, mt.nd.array(_x(99, *e.shape).numpy(), ctx=mt.cpu()))
    out["embed"] = e._data
    out["embed_grad"] = convert.gather_grads(emb)["weight"].tolist()

    tokens = mt.nd.array(np.zeros((2, 6), np.int32), ctx=mt.cpu(), dtype="int32")
    with activate(sp, "sp"):
        out["positions"] = bert._position_ids(tokens)._data
    out["positions_no_shard"] = bert._position_ids(tokens)._data

    q, k, v = (_x(30 + i, 2, 2, 8, 32) for i in range(3))
    rows = slice(r * 4, (r + 1) * 4)
    y, grads = _grad_of(lambda a, b, c: sequence_parallel_attention(a, b, c, "sp", sp),
                        q[:, :, rows], k[:, :, rows], v[:, :, rows])
    out["sp_attn"], out["sp_attn_grads"] = y, [t.tolist() for t in grads]

    full = {"a": _rs(40).randn(6, 4).astype(np.float32), "b": np.arange(3.0, dtype=np.float32)}
    specs = {"a": P(None, "tp")}
    shards = convert.shard_arrays(full, specs, tp)
    out["shard_a"] = shards["a"].tolist()
    out["roundtrip"] = {k: convert.gather_tensor(torch.from_numpy(v), specs.get(k), tp).tolist()
                        for k, v in shards.items()}
    return _lists(out)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return _dist_util.launch_local(f"{MODULE}:rank_pieces", N, device="cpu",
                                   timeout=120, pythonpath=[TESTS_DIR],
                                   workdir=str(tmp_path_factory.mktemp("tp")))


def _close(got, expect):
    got, expect = np.asarray(got, np.float32), np.asarray(expect, np.float32)
    assert got.shape == expect.shape
    assert np.abs(got - expect).max() <= TOL * max(float(np.abs(expect).max()), 1.0)


def test_shard_params_megatron_matches_reference():
    from mxnet_tpu.models import bert_tiny as ref_tiny
    from mxnet_tpu.parallel import shard_params_megatron as ref_shard
    from mxnet_tpu_torch.models import bert_tiny
    from mxnet_tpu_torch.parallel import shard_params_megatron
    port, ref = bert_tiny(head_major_qkv=True), ref_tiny(head_major_qkv=True)
    assert shard_params_megatron(port) == ref_shard(ref) > 0
    got = {(k, tuple(p.sharding)) for k, p in port._collect_params_with_prefix().items()
           if p.sharding is not None}
    want = {(k, tuple(p.sharding)) for k, p in ref._collect_params_with_prefix().items()
            if p.sharding is not None}
    assert got == want


def test_copy_and_reduce(ranks):
    xs = [_x(1, 4, 6) * (r + 1) for r in range(N)]
    w = _x(99, 4, 6)
    for r, res in enumerate(ranks):
        _close(res["copy"], xs[r])                    # identity
        _close(res["copy_grad"], N * w)               # the sum of every rank's w
        _close(res["reduce"], sum(xs))                # the sum
        _close(res["reduce_grad"], w)                 # identity
        _close(res["partial"], xs[r])
        _close(res["partial_grad"], w / N)


def test_gather_and_scatter_over_the_sequence(ranks):
    xs = [_x(1, 4, 6) * (r + 1) for r in range(N)]
    full = torch.cat(xs, dim=1)
    wg, ws = _x(99, 4, 12), _x(99, 4, 3)
    for r, res in enumerate(ranks):
        _close(res["gather"], full)
        _close(res["gather_grad"], (N * wg)[:, r * 6:(r + 1) * 6])   # reduce-scattered
        _close(res["scatter"], sum(xs)[:, r * 3:(r + 1) * 3])
        _close(res["scatter_grad"], torch.cat([ws] * N, dim=1))     # all-gathered


def test_vocab_parallel_embedding(ranks):
    ids = torch.from_numpy(_rs(2).randint(0, 10, (3, 5)))
    table = _x(3, 10, 4)
    w = _x(99, 3, 5, 4)
    parts = []
    for r, res in enumerate(ranks):
        own = ((ids >= r * 5) & (ids < (r + 1) * 5)).float().unsqueeze(-1)
        expect = table[ids] * own
        _close(res["vocab_part"], expect)
        parts.append(expect)
        grad = torch.zeros(10, 4).index_add_(0, ids.reshape(-1), (w * own).reshape(-1, 4))
        _close(res["vocab_part_grad"], grad[r * 5:(r + 1) * 5])
    _close(sum(parts), table[ids])


def test_column_into_row_parallel_dense_adds_the_bias_once(ranks):
    """The tp=2 MLP's output and gradients against the unsharded layers: a
    row-parallel bias added by every rank (before the sum) would be counted
    twice in the output."""
    names = ["0.weight", "0.bias", "1.weight", "1.bias"]
    shapes = [(16, 8), (16,), (8, 16), (8,)]
    w = {k: _x(10 + i, *s) for i, (k, s) in enumerate(zip(names, shapes))}
    x = _x(20, 2, 3, 8)
    h = torch.nn.functional.linear
    y, (gx, *gw) = _grad_of(lambda a, w0, b0, w1, b1: h(h(a, w0, b0), w1, b1), x,
                            *(w[k] for k in names))
    assert float(w["1.bias"].abs().max()) > 0.1
    for res in ranks:
        _close(res["mlp"], y)
        _close(res["mlp_x_grad"], gx)
        for k, g in zip(names, gw):
            _close(res["mlp_grads"][k], g)


def test_vocab_sharded_embedding_layer(ranks):
    ids = torch.from_numpy(_rs(2).randint(0, 10, (3, 5)))
    table = _x(3, 10, 4)
    y, (g,) = _grad_of(lambda t: t[ids], table)
    for res in ranks:
        _close(res["embed"], y)
        _close(res["embed_grad"], g)


def test_positions_start_at_the_ranks_first_token(ranks):
    for r, res in enumerate(ranks):
        assert res["positions"] == list(range(6 * r, 6 * r + 6))
        assert res["positions_no_shard"] == list(range(6))


def test_flash_attention_on_a_sequence_shard(ranks):
    from mxnet_tpu_torch.ops.attention import blockwise_attention
    q, k, v = (_x(30 + i, 2, 2, 8, 32) for i in range(3))
    w = torch.cat([_x(99, 2, 2, 4, 32)] * N, dim=2)     # each rank's w on its rows
    y, grads = _grad_of(blockwise_attention, q, k, v, w=w)
    for r, res in enumerate(ranks):
        rows = slice(r * 4, (r + 1) * 4)
        _close(res["sp_attn"], y[:, :, rows])
        for got, g in zip(res["sp_attn_grads"], grads):
            _close(got, g[:, :, rows])


def test_convert_shard_gather_round_trip(ranks):
    a = _rs(40).randn(6, 4).astype(np.float32)
    for r, res in enumerate(ranks):
        np.testing.assert_array_equal(res["shard_a"], a[:, r * 2:(r + 1) * 2])
        np.testing.assert_array_equal(res["roundtrip"]["a"], a)
        np.testing.assert_array_equal(res["roundtrip"]["b"], np.arange(3.0))
