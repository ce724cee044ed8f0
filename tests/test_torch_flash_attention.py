"""The port's flash-attention forward against the reference's.

The port (``mxnet_tpu_torch/ops/cuda/flash_attention.py``) runs its plain
PyTorch version for CPU tensors; the reference's Pallas forward ``_fwd``
runs in interpret mode (the same kernel code the TPU executes), as
``tests/test_pallas_kernels.py`` runs it. Both get the same numpy inputs.

Tolerances: f32 2e-5, as in ``tests/test_pallas_kernels.py``: both sides
keep scores, statistics and the accumulator in f32 and differ only in the
order of summation. bf16 5e-2: both round p to bf16 before the PV product
and the output to bf16 (ulp 2^-8 of the value), and a one-ulp difference in
either can flip a rounding.

The CUDA kernel itself runs only on the card: the ``gpu``-marked tests skip
here. Its f32 route multiplies on the tensor cores by the 3xTF32 split, in
64-key tiles with an online softmax kept in log2 units;
``test_3xtf32_emulation_matches_reference`` emulates that arithmetic in
plain torch (``_mm_3xtf32`` of the backward's tests) and holds it to the
reference, before any run on the card. The reference package is imported by
the ``ref`` fixture, not at the top, so that the gpu tests also run on a card
host without jax (``python -m pytest -m gpu --noconftest tests/test_torch_*.py``).
"""
import math
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops.attention import blockwise_attention
from mxnet_tpu_torch.ops.cuda import flash_attention as fa
from torch_threads import one_torch_thread  # noqa: F401
from test_torch_flash_attention_bwd import _mm_1xtf32, _mm_3xtf32, _offset_view

TOL_F32 = 2e-5
TOL_BF16 = 5e-2


def _qkv(seed, B, H, T, Tk, D):
    rs = np.random.RandomState(seed)
    return tuple(rs.normal(0, 1, (B, H, n, D)).astype(np.float32)
                 for n in (T, Tk, Tk))


@pytest.fixture(scope="module")
def ref():
    import jax.numpy as jnp
    from mxnet_tpu.ops.attention import blockwise_attention
    from mxnet_tpu.ops.pallas.flash_attention import _fwd, flash_attention
    return SimpleNamespace(jnp=jnp, blockwise=blockwise_attention, fwd=_fwd,
                           flash=flash_attention)


@pytest.fixture()
def interpret_mode(monkeypatch):
    monkeypatch.setenv("MXNET_PALLAS_INTERPRET", "1")


# (B, H, T, Tk, D, causal): the shapes of tests/test_pallas_kernels.py
CASES = [(2, 2, 160, 160, 64, False), (2, 2, 160, 160, 64, True),
         (2, 2, 96, 224, 32, False), (1, 1, 100, 150, 32, False),
         (1, 1, 100, 150, 32, True)]


@pytest.mark.parametrize("B,H,T,Tk,D,causal", CASES)
def test_plain_fwd_matches_pallas_fwd(ref, B, H, T, Tk, D, causal):
    jnp = ref.jnp
    q, k, v = _qkv(T + Tk + D, B, H, T, Tk, D)
    scale = 1.0 / np.sqrt(D)
    q3, k3, v3 = (a.reshape(B * H, -1, D) for a in (q, k, v))
    o_ref, lse_ref = ref.fwd(jnp.asarray(q3), jnp.asarray(k3), jnp.asarray(v3),
                             causal, scale, 128, 128, True)
    before = fa.flash_attention_fwd.launches
    o, lse = fa.flash_attention_fwd(*(torch.from_numpy(a) for a in (q3, k3, v3)),
                                    causal, scale)
    assert fa.flash_attention_fwd.launches == before  # CPU: plain version
    assert o.dtype == torch.float32 and lse.shape == (B * H, T)
    np.testing.assert_allclose(o.numpy(), np.asarray(o_ref), rtol=TOL_F32, atol=TOL_F32)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_ref), rtol=TOL_F32, atol=TOL_F32)


@pytest.mark.parametrize("B,H,T,Tk,D,causal", CASES)
def test_blockwise_matches_reference_blockwise(ref, B, H, T, Tk, D, causal):
    jnp = ref.jnp
    q, k, v = _qkv(7 + T, B, H, T, Tk, D)
    expect = ref.blockwise(*(jnp.asarray(a) for a in (q, k, v)),
                           block_size=128, causal=causal)
    out = blockwise_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                              block_size=128, causal=causal)
    np.testing.assert_allclose(out.numpy(), np.asarray(expect), rtol=TOL_F32, atol=TOL_F32)


@pytest.mark.parametrize("causal", [False, True])
def test_flash_attention_matches_reference(ref, interpret_mode, causal):
    jnp = ref.jnp
    q, k, v = _qkv(11, 2, 2, 160, 160, 64)
    expect = ref.flash(*(jnp.asarray(a) for a in (q, k, v)), causal=causal,
                       block_q=128, block_k=128)
    out = fa.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                             causal=causal, block_q=128, block_k=128)
    assert out.shape == (2, 2, 160, 64)
    np.testing.assert_allclose(out.numpy(), np.asarray(expect), rtol=TOL_F32, atol=TOL_F32)


def test_plain_fwd_bf16_matches_pallas_fwd(ref):
    jnp = ref.jnp
    q, k, v = _qkv(5, 2, 2, 128, 128, 64)
    q3, k3, v3 = (a.reshape(4, 128, 64) for a in (q, k, v))
    o_ref, lse_ref = ref.fwd(*(jnp.asarray(a, jnp.bfloat16) for a in (q3, k3, v3)),
                             False, 0.125, 128, 128, True)
    o, lse = fa.flash_attention_fwd(
        *(torch.from_numpy(a).to(torch.bfloat16) for a in (q3, k3, v3)))
    assert o.dtype == torch.bfloat16 and lse.dtype == torch.float32
    np.testing.assert_allclose(o.float().numpy(), np.asarray(o_ref, np.float32),
                               rtol=TOL_BF16, atol=TOL_BF16)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_ref), rtol=TOL_BF16,
                               atol=TOL_BF16)


def test_forward_refuses_inputs_that_need_a_gradient():
    q = torch.zeros(1, 8, 32, requires_grad=True)
    with pytest.raises(MXNetError, match="backward"):
        fa.flash_attention_fwd(q, q, q)
    with torch.no_grad():
        o, _ = fa.flash_attention_fwd(q, q, q)
    assert o.shape == (1, 8, 32)


def test_non_cuda_device_raises_instead_of_falling_back():
    q = torch.empty(1, 8, 32, device="meta")
    with pytest.raises(MXNetError, match="unsupported device"):
        fa.flash_attention_fwd(q, q, q)


@pytest.mark.parametrize("bad", ["dtype", "head_dim", "contiguous", "shape",
                                 "rank"])
def test_kernel_argument_checks(bad):
    q = torch.zeros(2, 16, 64)
    k = torch.zeros(2, 24, 64)
    if bad == "dtype":
        q = k = q.double()
    elif bad == "head_dim":
        q, k = torch.zeros(2, 16, 48), torch.zeros(2, 24, 48)
    elif bad == "contiguous":
        q = torch.zeros(2, 64, 16).transpose(1, 2)
    elif bad == "shape":
        k = torch.zeros(3, 24, 64)
    elif bad == "rank":
        q = torch.zeros(1, 2, 16, 64)
    with pytest.raises(MXNetError):
        fa._check(q, k, k)


def _fwd_emulated(mm, q, k, v, causal, scale, block=64):
    """The kernel's f32 arithmetic on (BH, T, D) tensors, every product taken
    by ``mm``: 64-key tiles, scores in log2 units (scale * log2 e), the
    running max m and sum l, O rescaled by exp2(m_old - m_new) a tile, then
    O / l and LSE = m ln 2 + log(l)."""
    T, Tk = q.shape[1], k.shape[1]
    scale2 = torch.tensor(scale * math.log2(math.e), dtype=torch.float32)
    neg = torch.tensor(-1e30)
    m = torch.full(q.shape[:2] + (1,), -1e30)
    l = torch.zeros(q.shape[:2] + (1,))
    acc = torch.zeros(q.shape)
    q_pos = torch.arange(T)[:, None]
    for k0 in range(0, Tk, block):
        kb, vb = k[:, k0:k0 + block], v[:, k0:k0 + block]
        s = mm(q, kb.transpose(1, 2)) * scale2
        if causal:
            s = torch.where(q_pos >= k0 + torch.arange(kb.shape[1])[None, :], s, neg)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(s - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + mm(p, vb)
        m = m_new
    l = l.clamp_min(1e-30)
    return acc / l, (m * math.log(2.0) + torch.log(l))[..., 0]


TOL_O_F32 = 1e-4   # chip_smoke.py's TOL_O["float32"], the kernel against its plain version


@pytest.mark.parametrize("causal", [False, True])
def test_3xtf32_emulation_matches_reference(ref, causal):
    """The f32 kernel's products in 3xTF32 stay within 1e-5 of the Pallas
    forward's O and LSE at BH=6, T=160, a ragged Tk=150, D=64 (emulated on
    the CPU: 1.1e-6 / 4.8e-7 at most, 70x under TOL_O). One TF32 product
    (``_mm_1xtf32``) gives 6e-4 - 1.1e-3 on O, 6-11x TOL_O, which is why
    the kernel splits."""
    jnp = ref.jnp
    rs = np.random.RandomState(23 + int(causal))
    q, k, v = (rs.normal(0, 1, (6, n, 64)).astype(np.float32) for n in (160, 150, 150))
    o_ref, lse_ref = (np.asarray(a) for a in ref.fwd(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal, 0.125, 128, 128, True))
    qt, kt, vt = (torch.from_numpy(a) for a in (q, k, v))
    o, lse = _fwd_emulated(_mm_3xtf32, qt, kt, vt, causal, 0.125)
    err_o = np.abs(o.numpy() - o_ref).max()
    err_lse = np.abs(lse.numpy() - lse_ref).max()
    assert err_o <= 1e-5 and err_lse <= 1e-5
    assert 10 * err_o <= TOL_O_F32
    o1, _ = _fwd_emulated(_mm_1xtf32, qt, kt, vt, causal, 0.125)
    assert np.abs(o1.numpy() - o_ref).max() > TOL_O_F32


def test_forward_refuses_misaligned_input():
    """The kernel copies rows 16 B at a time (cp.async): its checks refuse a
    contiguous view that does not start on a 16-byte boundary."""
    q = torch.zeros(2, 16, 64)
    k = _offset_view(torch.zeros(2, 24, 64))
    assert k.is_contiguous() and k.data_ptr() % 16 == 4
    q_off = _offset_view(q)
    fa._check(q, q, q)
    for args in ((q, k, k), (q_off, q, q)):
        with pytest.raises(MXNetError, match="16-byte"):
            fa._check(*args)


def _cuda_qkv(dtype, T, Tk, D, seed=3):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run on the card")
    q, k, v = _qkv(seed, 2, 3, T, Tk, D)
    return tuple(torch.from_numpy(a.reshape(6, -1, D)).to("cuda", dtype)
                 for a in (q, k, v))


# (T, Tk, D, causal) at the tiles' edges: a block keeps 64 query rows (f32,
# and 16-bit at D=128) or 128 (16-bit at D<=64) and streams 64 keys a tile
# (32 for f32 at D=128); single rows, T < Tk and T > Tk, causal with T != Tk,
# every head dim
KERNEL_CASES = [(160, 160, 64, False), (160, 160, 64, True), (96, 224, 32, False),
                (100, 150, 128, True), (1, 1, 64, False), (1, 17, 32, True),
                (17, 1, 128, False), (17, 65, 64, True), (65, 17, 32, True),
                (129, 1000, 64, False), (1000, 129, 128, True), (65, 129, 128, False),
                (200, 300, 32, True), (1000, 1000, 64, True)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2),
                                       (torch.float16, 4e-3)])
@pytest.mark.parametrize("T,Tk,D,causal", KERNEL_CASES)
def test_kernel_matches_plain(dtype, tol, T, Tk, D, causal):
    q3, k3, v3 = _cuda_qkv(dtype, T, Tk, D)
    before = fa.flash_attention_fwd.launches
    name = str(dtype).rpartition(".")[2]
    by_dtype = dict(fa.flash_attention_fwd.launches_by_dtype)
    o, lse = fa.flash_attention_fwd(q3, k3, v3, causal)
    torch.cuda.synchronize()
    assert fa.flash_attention_fwd.launches == before + 1
    by_dtype[name] = by_dtype.get(name, 0) + 1
    assert fa.flash_attention_fwd.launches_by_dtype == by_dtype
    assert o.dtype == dtype and o.shape == q3.shape and lse.shape == (6, T)
    o_ref, lse_ref = fa.flash_attention_fwd_plain(q3, k3, v3, causal)
    assert (o.float() - o_ref.float()).abs().max().item() <= tol
    assert (lse - lse_ref).abs().max().item() <= 1e-4


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("causal", [False, True])
def test_kernel_bit_identical_across_runs(dtype, causal):
    """No block writes another's output: two launches on the same inputs
    give the same bits."""
    q3, k3, v3 = _cuda_qkv(dtype, 1000, 1000, 64, seed=5)
    first = fa.flash_attention_fwd(q3, k3, v3, causal)
    second = fa.flash_attention_fwd(q3, k3, v3, causal)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a.view(torch.int16 if a.element_size() == 2 else torch.int32),
                           b.view(torch.int16 if b.element_size() == 2 else torch.int32))


@pytest.mark.gpu
def test_kernel_refuses_misaligned_input():
    """The raw wrapper refuses a CUDA view off a 16-byte boundary;
    flash_attention passes an aligned copy and gives the same result."""
    q3, k3, v3 = _cuda_qkv(torch.float32, 65, 65, 64)
    flat = torch.empty(k3.numel() + 1, device="cuda")
    k_off = flat[1:].view(k3.shape)
    k_off.copy_(k3)
    assert k_off.is_contiguous() and k_off.data_ptr() % 16 == 4
    with pytest.raises(MXNetError, match="16-byte"):
        fa.flash_attention_fwd(q3, k_off, v3)
    expect = fa.flash_attention(*(t.view(2, 3, 65, 64) for t in (q3, k3, v3)))
    got = fa.flash_attention(*(t.view(2, 3, 65, 64) for t in (q3, k_off, v3)))
    assert torch.equal(got, expect)
