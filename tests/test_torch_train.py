"""BERT training in the port against the reference package.

The model of ``tests/test_torch_bert.py`` (2 layers, units 128, 2 heads
of 64, FFN 512, vocab 1024, ``max_length=256``) is built in both packages
with the same weights
(``convert.seeded_params``, loaded into the port by ``load_jax_params`` and
into the reference by ``set_data``). Each step is the MXNet idiom in both:
``autograd.record()``, ``SoftmaxCrossEntropyLoss`` over the MLM logits of
every token, ``loss.backward()``, ``Trainer("adam", lr 1e-3).step(B)``, on
the same batch of token ids and labels from numpy.

- T=64 (plain attention branch): 10 steps; the loss trajectory, every
  gradient at step 1 and every weight after the last step.
- T=160 with ``MXNET_FLASH_ATTENTION_MIN_SEQ=128``: both take the flash
  branch (the reference runs its Pallas forward and backward in interpret
  mode, the port its plain versions); 3 steps. On the CPU the port launches
  no kernel, and its Function runs once per layer per step.

Tolerances, f32 on the CPU, where the frameworks differ only in the order of
summation (LayerNorm, softmax, the matrix products): loss 1e-5 relative;
gradients max |d| <= 1e-4 of the tensor's max |g|; weights 2e-5 absolute
after the last Adam step at lr 1e-3 (every step moves an element by about
lr, so 2e-5 is 2% of one step). Measured here: 2.4e-7, 1.0e-6 and 2.3e-6
on the plain branch.
"""
import numpy as np
import pytest

import mxnet_tpu_torch as mt
from mxnet_tpu_torch.convert import load_jax_params, seeded_params
from mxnet_tpu_torch.models import BertModel
from mxnet_tpu_torch.ops.cuda import flash_attention as fa
from torch_threads import one_torch_thread  # noqa: F401

CFG = dict(vocab_size=1024, num_layers=2, units=128, hidden_size=512,
           num_heads=2, max_length=256)
B = 2
LR = 1e-3
TOL_LOSS = 1e-5
TOL_GRAD = 1e-4
TOL_W = 2e-5


def _batch(seed, T):
    rs = np.random.RandomState(seed)
    return (rs.randint(0, CFG["vocab_size"], size=(B, T)).astype(np.int32),
            rs.randint(0, CFG["vocab_size"], size=(B, T)).astype(np.int32))


def _train(mx, net, ctx, tokens, labels, steps, params_of):
    """``steps`` training steps in package ``mx``; (losses, step-1 grads)."""
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    trainer = mx.gluon.Trainer(net.collect_params(), "adam", {"learning_rate": LR})
    x = mx.nd.array(tokens, ctx=ctx, dtype="int32")
    y = mx.nd.array(labels, ctx=ctx, dtype="int32")
    losses, grads = [], None
    for step in range(steps):
        with mx.autograd.record():
            loss = loss_fn(net(x), y)
        loss.backward()
        losses.append(loss.asnumpy().mean())
        if step == 0:
            grads = {k: p.grad().asnumpy() for k, p in params_of(net).items()
                     if p.grad_req != "null"}
        trainer.step(B)
    return np.array(losses), grads


def _port_run(weights, tokens, labels, steps):
    net = BertModel(**CFG)
    net.initialize(ctx=mt.cpu())
    load_jax_params(net, weights)
    losses, grads = _train(mt, net, mt.cpu(), tokens, labels, steps,
                           lambda n: n._collect_params_with_prefix())
    final = {k: p.data().asnumpy() for k, p in net._collect_params_with_prefix().items()}
    return losses, grads, final


def _ref_run(weights, tokens, labels, steps):
    import mxnet_tpu as mx
    from mxnet_tpu.models.bert import BertModel as RefBertModel
    net = RefBertModel(**CFG)
    net.initialize(ctx=mx.cpu())
    for key, p in net._collect_params_with_prefix().items():
        p.set_data(mx.nd.array(weights[key], ctx=mx.cpu()))
    losses, grads = _train(mx, net, mx.cpu(), tokens, labels, steps,
                           lambda n: n._collect_params_with_prefix())
    final = {k: p.data().asnumpy() for k, p in net._collect_params_with_prefix().items()}
    return losses, grads, final


def _compare(port, ref, steps):
    p_losses, p_grads, p_final = port
    r_losses, r_grads, r_final = ref
    assert p_losses.shape == (steps,) and np.isfinite(p_losses).all()
    np.testing.assert_allclose(p_losses, r_losses, rtol=TOL_LOSS)
    assert p_losses[-1] < p_losses[0]        # the same batch: the loss falls
    assert set(p_grads) == set(r_grads)
    for key, g in r_grads.items():
        scale = max(np.abs(g).max(), 1e-12)
        assert np.abs(p_grads[key] - g).max() <= TOL_GRAD * scale, key
    assert set(p_final) == set(r_final)
    for key, w in r_final.items():
        assert np.abs(p_final[key] - w).max() <= TOL_W, key


def test_plain_branch_matches_reference():
    weights = seeded_params(BertModel(**CFG), seed=0)
    tokens, labels = _batch(1, 64)
    calls = fa.FlashAttentionFunction.backward_calls
    port = _port_run(weights, tokens, labels, 10)
    assert fa.FlashAttentionFunction.backward_calls == calls
    _compare(port, _ref_run(weights, tokens, labels, 10), 10)


def test_flash_branch_matches_reference(monkeypatch):
    monkeypatch.setenv("MXNET_FLASH_ATTENTION_MIN_SEQ", "128")
    monkeypatch.setenv("MXNET_PALLAS_INTERPRET", "1")
    weights = seeded_params(BertModel(**CFG), seed=3)
    tokens, labels = _batch(4, 160)
    before = (fa.flash_attention_fwd.launches, fa.flash_attention_bwd_dq.launches,
              fa.flash_attention_bwd_dkv.launches)
    calls = fa.FlashAttentionFunction.backward_calls
    op = mt.ops.get_op("_contrib_flash_attention")
    op_calls = op.calls
    port = _port_run(weights, tokens, labels, 3)
    assert (fa.flash_attention_fwd.launches, fa.flash_attention_bwd_dq.launches,
            fa.flash_attention_bwd_dkv.launches) == before
    assert op.calls - op_calls == 3 * CFG["num_layers"]
    assert fa.FlashAttentionFunction.backward_calls - calls == 3 * CFG["num_layers"]
    _compare(port, _ref_run(weights, tokens, labels, 3), 3)


def test_trainer_refuses_what_is_not_ported():
    net = mt.gluon.nn.Dense(3, in_units=4)
    net.initialize(ctx=mt.cpu())
    params = net.collect_params()
    with pytest.raises(mt.MXNetError, match="kvstore"):
        mt.gluon.Trainer(params, "sgd", kvstore="dist_asynchronous")
    with pytest.raises(mt.MXNetError, match="lr_scheduler"):
        mt.gluon.Trainer(params, "sgd", {"lr_scheduler": object()})
    with pytest.raises(mt.MXNetError, match="unknown optimizer 'lambda'"):
        mt.gluon.Trainer(params, "lambda")
    assert type(mt.gluon.Trainer(params, "lamb")._optimizer).__name__ == "LAMB"
    trainer = mt.gluon.Trainer(params, "sgd")
    # states are ported; a states blob naming a reference class the port
    # has no counterpart of is refused, never imported
    blob = b"(dp0\nVstates\np1\n(dp2\nI0\ncmxnet_tpu.ndarray\nNDArray\np3\nss."
    with pytest.raises(mt.MXNetError, match="mxnet_tpu.ndarray.NDArray"):
        trainer._updater.set_states(blob)
