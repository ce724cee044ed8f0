"""The port's flash-attention backward against the reference's and torch's.

The port's plain backward (``ops/attention.blockwise_attention_bwd``, what
``flash_attention_bwd`` runs for CPU tensors) and its autograd.Function
(``FlashAttentionFunction`` through ``flash_attention``) are held against:

- the reference's Pallas backward ``_bwd`` in interpret mode (the same
  kernel code the TPU runs), as ``tests/test_pallas_kernels.py`` runs it,
  fed the same q, k, v, dO and the reference forward's O and LSE;
- ``torch.autograd`` through naive attention (softmax of the full score
  matrix) on the same inputs.

Tolerances: f32 5e-5 against the Pallas backward (both accumulate in f32
and differ in the order of summation over up to 224 keys, and the
reference pads and scales per tile where the port masks and scales once);
f32 1e-4 against naive autograd (a different algorithm: the softmax
gradient formed from the full row, not from the LSE). bf16 5e-2: dS and P
are rounded to bf16 (ulp 2^-8 of the value) before each product, at the
same places in both, and a one-ulp difference can flip a rounding.
``gradcheck`` runs the Function in f64 on the CPU (the plain version takes
f64), with its default tolerances.

The CUDA kernels run only on the card: the ``gpu``-marked tests skip
here. Their f32 route multiplies on the tensor cores by the 3xTF32 split
(a = hi + lo, each rounded to TF32, a*b = lo*hi + hi*lo + hi*hi);
``test_3xtf32_emulation_within_f32_tolerance`` emulates that product in
plain torch and holds the backward computed with it to the kernels' f32
tolerance against the plain version, before any run on the card.
"""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops.attention import blockwise_attention_bwd
from mxnet_tpu_torch.ops.cuda import flash_attention as fa
from torch_threads import one_torch_thread  # noqa: F401

TOL_PALLAS = 5e-5
TOL_NAIVE = 1e-4
TOL_BF16 = 5e-2

# (B, H, T, Tk, D, causal): BERT-like, padded, cross-attention, and the
# widest head the kernels take (D = 256, two passes of 128 columns on the card)
CASES = [(1, 2, 128, 128, 32, False), (1, 2, 128, 128, 32, True),
         (1, 1, 100, 150, 32, False), (1, 1, 100, 150, 32, True),
         (1, 2, 96, 224, 32, False), (1, 1, 64, 80, 256, True)]


def _inputs(seed, B, H, T, Tk, D):
    rs = np.random.RandomState(seed)
    q, k, v = (rs.normal(0, 1, (B, H, n, D)).astype(np.float32)
               for n in (T, Tk, Tk))
    do = rs.normal(0, 1, (B, H, T, D)).astype(np.float32)
    return q, k, v, do


@pytest.fixture(scope="module")
def ref():
    import jax.numpy as jnp
    from mxnet_tpu.ops.pallas.flash_attention import _bwd, _fwd
    return SimpleNamespace(jnp=jnp, fwd=_fwd, bwd=_bwd)


def _naive_grads(q, k, v, do, causal, scale):
    q, k, v = (torch.from_numpy(a).double().requires_grad_() for a in (q, k, v))
    s = torch.matmul(q, k.transpose(-1, -2)) * scale
    if causal:
        T, Tk = s.shape[-2:]
        s = s.masked_fill(~torch.ones(T, Tk, dtype=torch.bool).tril(), float("-inf"))
    out = torch.matmul(torch.softmax(s, dim=-1), v)
    out.backward(torch.from_numpy(do).double())
    return [t.grad.numpy() for t in (q, k, v)]


@pytest.mark.parametrize("B,H,T,Tk,D,causal", CASES)
def test_plain_bwd_matches_pallas_bwd(ref, B, H, T, Tk, D, causal):
    jnp = ref.jnp
    q, k, v, do = _inputs(T + Tk + int(causal), B, H, T, Tk, D)
    scale = 1.0 / np.sqrt(D)
    q3, k3, v3, do3 = (a.reshape(B * H, -1, D) for a in (q, k, v, do))
    jq, jk, jv, jdo = (jnp.asarray(a) for a in (q3, k3, v3, do3))
    o, lse = ref.fwd(jq, jk, jv, causal, scale, 128, 128, True)
    expect = ref.bwd(jq, jk, jv, o, lse, jdo, causal, scale, 128, 128, True)
    got = blockwise_attention_bwd(
        *(torch.from_numpy(np.array(a)) for a in (q3, k3, v3, o, lse, do3)),
        causal=causal, scale=scale)
    for g, e in zip(got, expect):
        assert g.dtype == torch.float32 and g.shape == e.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(e), rtol=TOL_PALLAS,
                                   atol=TOL_PALLAS)


@pytest.mark.parametrize("B,H,T,Tk,D,causal", CASES)
def test_function_matches_naive_autograd(B, H, T, Tk, D, causal):
    q, k, v, do = _inputs(7 * T + Tk, B, H, T, Tk, D)
    qt, kt, vt = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    before = (fa.flash_attention_bwd_dq.launches, fa.flash_attention_bwd_dkv.launches)
    calls = fa.FlashAttentionFunction.backward_calls
    out = fa.flash_attention(qt, kt, vt, causal=causal)
    out.backward(torch.from_numpy(do))
    # CPU tensors: the plain backward ran, no kernel was launched
    assert (fa.flash_attention_bwd_dq.launches,
            fa.flash_attention_bwd_dkv.launches) == before
    assert fa.FlashAttentionFunction.backward_calls == calls + 1
    expect = _naive_grads(q, k, v, do, causal, 1.0 / np.sqrt(D))
    for t, e in zip((qt, kt, vt), expect):
        np.testing.assert_allclose(t.grad.numpy(), e, rtol=TOL_NAIVE, atol=TOL_NAIVE)


def test_function_backward_with_strided_grad():
    """dO out of a transpose is strided; the Function makes it contiguous."""
    q, k, v, do = _inputs(3, 1, 2, 64, 64, 32)
    qt, kt, vt = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = fa.flash_attention(qt, kt, vt)
    dot = torch.from_numpy(np.ascontiguousarray(do.transpose(0, 2, 1, 3)))
    (out * dot.transpose(1, 2)).sum().backward()
    expect = _naive_grads(q, k, v, do, False, 1.0 / np.sqrt(32))
    np.testing.assert_allclose(qt.grad.numpy(), expect[0], rtol=TOL_NAIVE,
                               atol=TOL_NAIVE)


def test_plain_bwd_bf16_matches_pallas_bwd(ref):
    jnp = ref.jnp
    q, k, v, do = _inputs(5, 1, 2, 128, 128, 32)
    q3, k3, v3, do3 = (jnp.asarray(a.reshape(2, 128, 32), jnp.bfloat16)
                       for a in (q, k, v, do))
    o, lse = ref.fwd(q3, k3, v3, False, 32 ** -0.5, 128, 128, True)
    expect = ref.bwd(q3, k3, v3, o, lse, do3, False, 32 ** -0.5, 128, 128, True)

    def t(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(
            torch.bfloat16 if a.dtype == jnp.bfloat16 else torch.float32)
    got = blockwise_attention_bwd(*(t(a) for a in (q3, k3, v3, o, lse, do3)),
                                  scale=32 ** -0.5)
    for g, e in zip(got, expect):
        assert g.dtype == torch.bfloat16
        np.testing.assert_allclose(g.float().numpy(), np.asarray(e, np.float32),
                                   rtol=TOL_BF16, atol=TOL_BF16)


@pytest.mark.parametrize("causal", [False, True])
def test_gradcheck_f64(causal):
    rs = np.random.RandomState(11)
    q, k, v = (torch.from_numpy(rs.normal(0, 1, (2, n, 32))).requires_grad_()
               for n in (24, 40, 40))
    if causal:
        k, v = (torch.from_numpy(rs.normal(0, 1, (2, 24, 32))).requires_grad_()
                for _ in range(2))
    assert torch.autograd.gradcheck(
        lambda a, b, c: fa.FlashAttentionFunction.apply(a, b, c, causal, 0.3),
        (q, k, v))


def test_backward_wrappers_refuse_non_cuda_tensors():
    q = torch.zeros(1, 8, 32)
    lse = torch.zeros(1, 8)
    with pytest.raises(MXNetError, match="unsupported device"):
        fa.flash_attention_bwd_dq(q, q, q, q, lse, lse)
    with pytest.raises(MXNetError, match="unsupported device"):
        fa.flash_attention_bwd_dkv(q, q, q, q, lse, lse)
    m = torch.empty(1, 8, 32, device="meta")
    with pytest.raises(MXNetError, match="unsupported device"):
        fa.flash_attention_bwd(m, m, m, m, lse, m)


def _offset_view(t):
    """A contiguous copy of ``t`` that starts 4 bytes past a 16-byte
    boundary: a view at storage offset 1 of a larger buffer."""
    flat = torch.zeros(t.numel() + 4, dtype=t.dtype)
    base = (-flat.data_ptr() % 16) // t.element_size()
    view = flat[base + 1:base + 1 + t.numel()].view(t.shape)
    view.copy_(t)
    return view


@pytest.mark.parametrize("bad", ["do-shape", "lse-dtype", "delta-shape",
                                 "k-misaligned"])
def test_backward_argument_checks(bad):
    q = k = torch.zeros(2, 16, 64)
    do, lse, delta = torch.zeros(2, 16, 64), torch.zeros(2, 16), torch.zeros(2, 16)
    if bad == "do-shape":
        do = torch.zeros(2, 8, 64)
    elif bad == "lse-dtype":
        lse = lse.double()
    elif bad == "delta-shape":
        delta = torch.zeros(2, 8)
    else:
        k = _offset_view(k)
        assert k.is_contiguous() and k.data_ptr() % 16 == 4
        # the forward kernel's row copies refuse it too, as the backward's do
        with pytest.raises(MXNetError, match="16-byte"):
            fa._check(q, k, k)
    with pytest.raises(MXNetError, match=None if bad != "k-misaligned" else "16-byte"):
        fa._check(q, k, k, do, lse, delta, who="flash_attention_bwd_dq")


def test_aligned_copies_only_misaligned_inputs():
    t = torch.arange(2 * 16 * 32, dtype=torch.float32).view(2, 16, 32)
    assert fa._aligned(t) is t
    off = _offset_view(t)
    got = fa._aligned(off)
    assert got.data_ptr() % 16 == 0 and torch.equal(got, t)


def _tf32(x):
    """x rounded to TF32 (10 mantissa bits), to nearest with ties away from
    zero, as cvt.rna.tf32.f32 rounds: add half an ulp of the 13 dropped
    bits to the bit pattern, then clear them."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _mm_3xtf32(a, b):
    """a @ b in f32 from TF32 pieces: the two small terms, then the big one."""
    ah, bh = _tf32(a), _tf32(b)
    al, bl = _tf32(a - ah), _tf32(b - bh)
    return (al @ bh + ah @ bl) + ah @ bh


def _mm_1xtf32(a, b):
    return _tf32(a) @ _tf32(b)


def _bwd_emulated(mm, q, k, v, o, lse, do, causal, scale):
    """The kernels' arithmetic on (BH, T, D) f32 tensors with every product
    taken by ``mm``: S, dP, then dQ, dV, dK from P and dS."""
    T, Tk = q.shape[1], k.shape[1]
    delta = (do * o).sum(-1, keepdim=True)
    s = mm(q, k.transpose(1, 2)) * scale
    if causal:
        keep = torch.arange(T)[:, None] >= torch.arange(Tk)[None, :]
        s = torch.where(keep, s, torch.tensor(-1e30))
    p = torch.exp(s - lse[..., None])
    ds = p * (mm(do, v.transpose(1, 2)) - delta)
    return (mm(ds, k) * scale, mm(ds.transpose(1, 2), q) * scale,
            mm(p.transpose(1, 2), do))


@pytest.mark.parametrize("causal", [False, True])
def test_3xtf32_emulation_within_f32_tolerance(causal):
    """The f32 kernels' 3xTF32 products hold TOL_BWD["float32"] = 1e-4 of
    each gradient's max against the plain backward (chip_smoke.py's f32
    check, the kernels' GPU test); 1xTF32 (one product of the rounded
    operands) does not, which is why the kernels split."""
    tol = 1e-4
    q, k, v, do = (torch.from_numpy(a.reshape(6, 160, 64))
                   for a in _inputs(19 + int(causal), 2, 3, 160, 160, 64))
    scale = 1.0 / 8.0
    o, lse = fa.flash_attention_fwd_plain(q, k, v, causal, scale)
    expect = fa.flash_attention_bwd_plain(q, k, v, o, lse, do, causal, scale)
    worst_1x = 0.0
    for mm in (_mm_3xtf32, _mm_1xtf32):
        got = _bwd_emulated(mm, q, k, v, o, lse, do, causal, scale)
        for g, e in zip(got, expect):
            rel = ((g - e).abs().max() / e.abs().max()).item()
            if mm is _mm_3xtf32:
                assert rel <= tol
            else:
                worst_1x = max(worst_1x, rel)
    assert worst_1x > tol


TOL_KERNEL = {torch.float32: 1e-4, torch.bfloat16: 3e-2, torch.float16: 1e-2}
# (T, Tk, D, causal) at the tiles' edges: a block keeps 128 resident rows
# (64 at D=128) and streams 32 rows a tile (16 in the f32 dK/dV kernel).
# 129 and 1000 cross the 128-row blocks, 65 the 64-row ones at D=128, 17 a
# streamed tile; also single rows, T < Tk and T > Tk, causal with T != Tk,
# and every head dim in every dtype
KERNEL_CASES = [(160, 160, 64, False), (160, 160, 64, True), (96, 224, 32, False),
                (100, 150, 128, True), (1, 1, 64, False), (1, 17, 32, True),
                (17, 1, 128, False), (17, 65, 64, True), (65, 17, 32, True),
                (129, 1000, 64, False), (1000, 129, 128, True),
                (65, 129, 128, False), (1000, 1000, 64, True)]


def _cuda_inputs(dtype, T, Tk, D, seed=3):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run on the card")
    q, k, v, do = _inputs(seed, 2, 3, T, Tk, D)
    q3, k3, v3 = (torch.from_numpy(a.reshape(6, -1, D)).to("cuda", dtype)
                  for a in (q, k, v))
    do3 = torch.from_numpy(do.reshape(6, -1, D)).to("cuda", dtype)
    return q3, k3, v3, do3


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", list(TOL_KERNEL))
@pytest.mark.parametrize("T,Tk,D,causal", KERNEL_CASES)
def test_kernels_match_plain(dtype, T, Tk, D, causal):
    q3, k3, v3, do3 = _cuda_inputs(dtype, T, Tk, D)
    tol = TOL_KERNEL[dtype]
    o, lse = fa.flash_attention_fwd(q3, k3, v3, causal)
    before = (fa.flash_attention_bwd_dq.launches, fa.flash_attention_bwd_dkv.launches)
    name = str(dtype).rpartition(".")[2]
    by_dtype = [dict(w.launches_by_dtype)
                for w in (fa.flash_attention_bwd_dq, fa.flash_attention_bwd_dkv)]
    got = fa.flash_attention_bwd(q3, k3, v3, o, lse, do3, causal)
    torch.cuda.synchronize()
    assert (fa.flash_attention_bwd_dq.launches,
            fa.flash_attention_bwd_dkv.launches) == (before[0] + 1, before[1] + 1)
    for w, counts in zip((fa.flash_attention_bwd_dq, fa.flash_attention_bwd_dkv), by_dtype):
        counts[name] = counts.get(name, 0) + 1
        assert w.launches_by_dtype == counts
    expect = fa.flash_attention_bwd_plain(q3, k3, v3, o, lse, do3, causal)
    for g, e in zip(got, expect):
        assert g.dtype == dtype and g.shape == e.shape
        scale = max(e.float().abs().max().item(), 1.0)
        assert (g.float() - e.float()).abs().max().item() <= tol * scale


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", list(TOL_KERNEL))
def test_kernels_bit_identical_across_runs(dtype):
    """No block writes another's output: two launches on the same inputs
    give the same bits."""
    q3, k3, v3, do3 = _cuda_inputs(dtype, 1000, 1000, 64, seed=5)
    o, lse = fa.flash_attention_fwd(q3, k3, v3)
    delta = (do3.float() * o.float()).sum(-1)
    first = (fa.flash_attention_bwd_dq(q3, k3, v3, do3, lse, delta),
             *fa.flash_attention_bwd_dkv(q3, k3, v3, do3, lse, delta))
    second = (fa.flash_attention_bwd_dq(q3, k3, v3, do3, lse, delta),
              *fa.flash_attention_bwd_dkv(q3, k3, v3, do3, lse, delta))
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a.view(torch.int16 if a.element_size() == 2 else torch.int32),
                           b.view(torch.int16 if b.element_size() == 2 else torch.int32))


@pytest.mark.gpu
def test_kernels_refuse_misaligned_input():
    """A contiguous view at a storage offset that is not 16-byte aligned:
    the raw wrappers refuse it, flash_attention passes an aligned copy."""
    q3, k3, v3, do3 = _cuda_inputs(torch.float32, 65, 65, 64)
    flat = torch.empty(k3.numel() + 1, device="cuda")
    k_off = flat[1:].view(k3.shape)
    k_off.copy_(k3)
    assert k_off.is_contiguous() and k_off.data_ptr() % 16 == 4
    o, lse = fa.flash_attention_fwd(q3, k3, v3)
    delta = (do3.float() * o.float()).sum(-1)
    with pytest.raises(MXNetError, match="16-byte"):
        fa.flash_attention_bwd_dq(q3, k_off, v3, do3, lse, delta)
    with pytest.raises(MXNetError, match="16-byte"):
        fa.flash_attention_bwd_dkv(q3, k_off, v3, do3, lse, delta)
    q4, k4, v4 = (t.view(2, 3, 65, 64).clone().requires_grad_() for t in (q3, k3, v3))
    k4_off = k_off.view(2, 3, 65, 64).detach().requires_grad_()
    for kk in (k4, k4_off):
        fa.flash_attention(q4, kk, v4).backward(do3.view(2, 3, 65, 64))
    assert torch.equal(k4.grad, k4_off.grad)


# Long sequences, f32: each kernel's output no further from the exact result
# (the plain version in f64) than TOL_LONG of its max. The plain version in
# f32 lies up to 4e-6 from it at T = 8192. One mma accumulator fed a whole
# long loop drifts with its length (8e-5 at T = 8192, 2.5e-4 at 32768), so
# the f32 kernels add their partial sums into the output every 512 rows
# (6e-6 at T = 8192).
TOL_LONG = 1e-5


@pytest.mark.gpu
@pytest.mark.parametrize("causal", [True, False])
def test_kernels_long_sequence_against_f64(causal):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run on the card")
    gen = torch.Generator(device="cuda").manual_seed(11)
    q3, k3, v3, do3 = (torch.randn(2, 8192, 32, generator=gen, device="cuda")
                       for _ in range(4))
    o, lse = fa.flash_attention_fwd(q3, k3, v3, causal)
    delta = (do3 * o).sum(-1)
    dq = fa.flash_attention_bwd_dq(q3, k3, v3, do3, lse, delta, causal)
    dk, dv = fa.flash_attention_bwd_dkv(q3, k3, v3, do3, lse, delta, causal)
    q64, k64, v64, do64 = (t.double() for t in (q3, k3, v3, do3))
    o64, lse64 = fa.flash_attention_fwd_plain(q64, k64, v64, causal)
    exact = (o64, *fa.flash_attention_bwd_plain(q64, k64, v64, o64, lse64, do64, causal))
    for name, g, e in zip(("o", "dq", "dk", "dv"), (o, dq, dk, dv), exact):
        rel = ((g.double() - e).abs().max() / e.abs().max()).item()
        assert rel <= TOL_LONG, (name, rel)


# Head dims besides the instantiated 32, 64 and 128: D = 16 has kernels of
# its own (dryrun_multichip's long-context shape, units 32 over 2 heads), so
# does D = 256 (two passes of 128 output columns); any other D up to 256 is
# zero-padded by the wrappers to the next instantiated width and sliced
# back. Padding adds zero columns, which leave Q K^T, and so P, LSE and
# delta, as they were.
PAD_DIMS = [(16, 16), (24, 32), (48, 64), (80, 128), (128, 128), (144, 256), (256, 256)]


@pytest.mark.parametrize("D,Dk", PAD_DIMS)
def test_kernel_dim_rule(D, Dk):
    assert fa._kernel_dim(D, "t") == Dk
    t = torch.ones(2, 3, D)
    padded = fa._pad_dim(t, Dk)
    assert padded.shape == (2, 3, Dk) and padded.is_contiguous()
    assert torch.equal(fa._unpad(padded, D), t)


def test_kernel_dim_above_256_raises():
    with pytest.raises(MXNetError, match="head dim 257 above 256"):
        fa._kernel_dim(257, "flash_attention_fwd")


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("D,Dk", [(16, 32), (80, 128), (144, 256)])
def test_zero_padded_head_dim_gives_the_unpadded_result(causal, D, Dk):
    """The wrappers' padding rule on the plain versions: the scale of the
    original D, then O and the gradients sliced back, equal the unpadded
    attention's to f32 rounding."""
    q, k, v, do = (torch.from_numpy(a.reshape(6, -1, D))
                   for a in _inputs(7, 2, 3, 100, 100, D))
    scale = 1.0 / np.sqrt(D)
    o, lse = fa.flash_attention_fwd_plain(q, k, v, causal, scale)
    grads = fa.flash_attention_bwd_plain(q, k, v, o, lse, do, causal, scale)
    qp, kp, vp, dop = (fa._pad_dim(t, Dk) for t in (q, k, v, do))
    op, lsep = fa.flash_attention_fwd_plain(qp, kp, vp, causal, scale)
    gp = fa.flash_attention_bwd_plain(qp, kp, vp, op, lsep, dop, causal, scale)
    assert float(op[..., D:].abs().max()) == 0.0
    torch.testing.assert_close(fa._unpad(op, D), o, rtol=0, atol=1e-6)
    torch.testing.assert_close(lsep, lse, rtol=0, atol=1e-6)
    for g, e in zip(gp, grads):
        assert float(g[..., D:].abs().max()) == 0.0
        torch.testing.assert_close(fa._unpad(g, D), e, rtol=0, atol=1e-5)


# chip_smoke.py's TOL_BWD: of each output's max, against the plain version
TOL_PAD = {torch.float32: 1e-4, torch.bfloat16: 3e-2}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", list(TOL_PAD))
@pytest.mark.parametrize("D", [16, 80])
@pytest.mark.parametrize("causal", [False, True])
def test_kernels_at_head_dims_16_and_80(dtype, D, causal):
    """K1-K3 at D = 16 (instantiated) and D = 80 (zero-padded to 128) against
    their plain versions; the counters see the caller's shape."""
    q3, k3, v3, do3 = _cuda_inputs(dtype, 300, 300, D)
    shape = f"6x300x300x{D}"
    before = {w: w.launches_by_shape.get(shape, 0) for w in (
        fa.flash_attention_fwd, fa.flash_attention_bwd_dq, fa.flash_attention_bwd_dkv)}
    o, lse = fa.flash_attention_fwd(q3, k3, v3, causal)
    got = fa.flash_attention_bwd(q3, k3, v3, o, lse, do3, causal)
    torch.cuda.synchronize()
    for w, n in before.items():
        assert w.launches_by_shape[shape] == n + 1
    o_ref, lse_ref = fa.flash_attention_fwd_plain(q3, k3, v3, causal)
    expect = fa.flash_attention_bwd_plain(q3, k3, v3, o, lse, do3, causal)
    tol = TOL_PAD[dtype]
    assert o.shape == q3.shape and o.is_contiguous()
    assert (o.float() - o_ref.float()).abs().max().item() <= tol * max(
        o_ref.float().abs().max().item(), 1.0)
    assert (lse - lse_ref).abs().max().item() <= 1e-4
    for g, e in zip(got, expect):
        assert g.shape == e.shape and g.dtype == dtype
        rel = ((g.float() - e.float()).abs().max() / e.float().abs().max()).item()
        assert rel <= tol, rel


# (T, Tk) at D = 256: the forward's 64-row query blocks and 32- (f32) or
# 64-key tiles, the backward's 64-row blocks and 16- (f32) or 32-row tiles;
# 300 crosses each, 17 is a part tile, T != Tk under the causal mask
HEAD256_SHAPES = [(300, 300), (17, 130)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", list(TOL_PAD))
@pytest.mark.parametrize("D", [144, 256])
@pytest.mark.parametrize("causal", [False, True])
def test_kernels_at_head_dims_144_and_256(dtype, D, causal):
    """K1-K3 at D = 256 (instantiated: two passes of 128 output columns,
    each forming S and dP from the full D) and D = 144 (zero-padded to 256)
    against their plain versions, at the tolerances of the D <= 128 cases;
    the counters see the caller's shape."""
    for T, Tk in HEAD256_SHAPES:
        q3, k3, v3, do3 = _cuda_inputs(dtype, T, Tk, D)
        shape = f"6x{T}x{Tk}x{D}"
        before = {w: w.launches_by_shape.get(shape, 0) for w in (
            fa.flash_attention_fwd, fa.flash_attention_bwd_dq, fa.flash_attention_bwd_dkv)}
        o, lse = fa.flash_attention_fwd(q3, k3, v3, causal)
        got = fa.flash_attention_bwd(q3, k3, v3, o, lse, do3, causal)
        torch.cuda.synchronize()
        for w, n in before.items():
            assert w.launches_by_shape[shape] == n + 1
        o_ref, lse_ref = fa.flash_attention_fwd_plain(q3, k3, v3, causal)
        expect = fa.flash_attention_bwd_plain(q3, k3, v3, o, lse, do3, causal)
        tol = TOL_PAD[dtype]
        assert o.shape == q3.shape and o.is_contiguous()
        assert (o.float() - o_ref.float()).abs().max().item() <= tol * max(
            o_ref.float().abs().max().item(), 1.0)
        assert (lse - lse_ref).abs().max().item() <= 1e-4
        for g, e in zip(got, expect):
            assert g.shape == e.shape and g.dtype == dtype
            rel = ((g.float() - e.float()).abs().max() / e.float().abs().max()).item()
            assert rel <= tol, (T, Tk, rel)
