"""BERT inference in the port against the reference package.

A 2-layer BERT (units 128, 2 heads of 64, FFN 512, vocab 1024,
max_length 256) is built in both packages; weights made with numpy by
``convert.seeded_params`` are loaded into the port by ``load_jax_params``
and into the reference by ``set_data``, and the same token ids go through
both. At T=160 with ``MXNET_FLASH_ATTENTION_MIN_SEQ=128`` both take the
flash branch (the reference runs its Pallas kernel in interpret mode, the
port the kernel's plain version); at T=64 both take the plain
batch_dot/softmax branch.

Tolerance 1e-4 on logits of size ~1, f32 on the CPU: the two frameworks
sum in different orders through two layers and a 1024-way decoder.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu_torch as mt
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.convert import load_jax_params, seeded_params
from mxnet_tpu_torch.models import BertModel
from torch_threads import one_torch_thread  # noqa: F401

TOL = 1e-4
CFG = dict(vocab_size=1024, num_layers=2, units=128, hidden_size=512,
           num_heads=2, max_length=256)


def _port_net(**kw):
    net = BertModel(**{**CFG, **kw})
    net.initialize(ctx=mt.cpu())
    return net


def _tokens(seed, B, T):
    rs = np.random.RandomState(seed)
    return (rs.randint(0, CFG["vocab_size"], size=(B, T)).astype(np.int32),
            rs.randint(0, 2, size=(B, T)).astype(np.int32))


@pytest.fixture(scope="module")
def ref_bert():
    """Builds a reference BertModel carrying the given weights."""
    import mxnet_tpu as mx
    from mxnet_tpu.models.bert import BertModel as RefBertModel

    def build(weights, **kw):
        net = RefBertModel(**{**CFG, **kw})
        net.initialize(ctx=mx.cpu())
        for key, p in net._collect_params_with_prefix().items():
            p.set_data(mx.nd.array(weights[key], ctx=mx.cpu()))
        return lambda *ids: net(*(mx.nd.array(a, ctx=mx.cpu(), dtype="int32")
                                  for a in ids)).asnumpy()
    return build


@pytest.mark.parametrize("T,branch", [(160, "flash"), (64, "plain")])
@pytest.mark.parametrize("segments", [True, False])
@pytest.mark.parametrize("layout", [{}, {"head_major_qkv": True}],
                         ids=["qkv", "head_major"])
def test_logits_match_reference(monkeypatch, ref_bert, T, branch, segments, layout):
    monkeypatch.setenv("MXNET_FLASH_ATTENTION_MIN_SEQ", "128")
    monkeypatch.setenv("MXNET_PALLAS_INTERPRET", "1")
    net = _port_net(**layout)
    weights = seeded_params(net, seed=0)
    load_jax_params(net, weights)
    ids = _tokens(1, 2, T) if segments else _tokens(1, 2, T)[:1]
    op = mt.ops.get_op("_contrib_flash_attention")
    calls = op.calls
    got = net(*(mt.nd.array(a, ctx=mt.cpu(), dtype="int32") for a in ids)).asnumpy()
    assert op.calls - calls == (CFG["num_layers"] if branch == "flash" else 0)
    expect = ref_bert(weights, **layout)(*ids)
    assert got.shape == (2, T, CFG["vocab_size"]) and np.isfinite(got).all()
    np.testing.assert_allclose(got, expect, rtol=TOL, atol=TOL)


def test_unfused_qkv_matches_reference(ref_bert):
    net = _port_net(fused_qkv=False)
    weights = seeded_params(net, seed=2)
    load_jax_params(net, weights)
    ids = _tokens(3, 1, 48)
    got = net(*(mt.nd.array(a, ctx=mt.cpu()) for a in ids)).asnumpy()
    expect = ref_bert(weights, fused_qkv=False)(*ids)
    np.testing.assert_allclose(got, expect, rtol=TOL, atol=TOL)


def test_sequential_dense_matches_reference():
    import mxnet_tpu as mx
    from mxnet_tpu.gluon import nn as ref_nn

    def build(nn_mod, ctx):
        seq = nn_mod.Sequential()
        seq.add(nn_mod.Dense(8, activation="tanh", in_units=5),
                nn_mod.Dense(3, use_bias=False, in_units=8))
        seq.initialize(ctx=ctx)
        return seq
    net, ref = build(mt.gluon.nn, mt.cpu()), build(ref_nn, mx.cpu())
    weights = seeded_params(net, seed=7)
    assert set(weights) == {"0.weight", "0.bias", "1.weight"}
    load_jax_params(net, weights)
    for key, p in ref._collect_params_with_prefix().items():
        p.set_data(mx.nd.array(weights[key], ctx=mx.cpu()))
    x = np.random.RandomState(8).normal(size=(4, 5)).astype(np.float32)
    np.testing.assert_allclose(net(mt.nd.array(x, ctx=mt.cpu())).asnumpy(),
                               ref(mx.nd.array(x, ctx=mx.cpu())).asnumpy(),
                               rtol=TOL, atol=TOL)


def test_state_dict_keys_are_the_reference_paths():
    from mxnet_tpu.models.bert import BertModel as RefBertModel
    net = _port_net()
    ref = RefBertModel(**CFG)
    paths = list(ref._collect_params_with_prefix())
    assert list(net._collect_params_with_prefix()) == paths
    assert list(net.state_dict()) == paths
    assert "encoder.layers.0.attn.qkv.weight" in paths
    assert net.state_dict()["encoder.layers.1.ffn.ffn1.weight"].shape == (512, 128)


@pytest.mark.parametrize("fault", ["missing", "extra", "misshaped"])
def test_load_jax_params_rejects_bad_keys(fault):
    net = _port_net()
    weights = seeded_params(net, seed=0)
    before = net.word_embed.weight.data().asnumpy()
    if fault == "missing":
        del weights["mlm_ln.beta"]
    elif fault == "extra":
        weights["encoder.layers.2.ln1.gamma"] = np.ones(128, np.float32)
    else:
        weights["encoder.layers.0.attn.qkv.weight"] = np.zeros((384, 64), np.float32)
    with pytest.raises(MXNetError, match=fault.replace("misshaped", "shape")):
        load_jax_params(net, weights)
    # nothing was copied: the check runs before any value is loaded
    np.testing.assert_array_equal(net.word_embed.weight.data().asnumpy(), before)


def test_embedding_ids_in_range_and_out_of_range():
    emb = mt.gluon.nn.Embedding(10, 4)
    emb.initialize(ctx=mt.cpu())
    ids = mt.nd.array(np.array([[0, 9], [3, 3]]), ctx=mt.cpu())
    out = emb(ids).asnumpy()
    w = emb.weight.data().asnumpy()
    np.testing.assert_array_equal(out, w[[[0, 9], [3, 3]]])
    with pytest.raises(IndexError):
        emb(mt.nd.array(np.array([10]), ctx=mt.cpu()))


def test_layer_without_input_width_raises():
    """Without ``in_units`` the weight's shape waits for the first forward:
    reading it before then raises, and naming the input width is the way out."""
    dense = mt.gluon.nn.Dense(4)
    dense.initialize(ctx=mt.cpu())
    with pytest.raises(MXNetError, match="in_units"):
        dense.weight.data()
    assert dense(mt.nd.zeros((2, 3), ctx=mt.cpu())).shape == (2, 4)
    assert dense.weight.shape == (4, 3)


def test_save_load_parameters_round_trip(tmp_path):
    net = _port_net()
    load_jax_params(net, seeded_params(net, seed=4))
    path = str(tmp_path / "bert.pt")
    net.save_parameters(path)
    other = _port_net()
    other.load_parameters(path)
    for key, p in net._collect_params_with_prefix().items():
        np.testing.assert_array_equal(
            other._collect_params_with_prefix()[key].data().asnumpy(),
            p.data().asnumpy())


def test_forward_hooks_hybridize_and_cast():
    net = _port_net()
    load_jax_params(net, seeded_params(net, seed=5))
    ids = mt.nd.array(_tokens(6, 1, 16)[0], ctx=mt.cpu())
    seen = []
    handle = net.encoder.register_forward_hook(
        lambda blk, args, out: seen.append(out.shape))
    ref = net(ids).asnumpy()
    handle.detach()
    net(ids)
    assert seen == [(1, 16, 128)]
    net.hybridize()
    np.testing.assert_array_equal(net(ids).asnumpy(), ref)
    net.cast("bfloat16")
    out = net(ids)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.asnumpy(), ref, atol=0.1)
