"""The blocked matrix product (``ops/cuda/blocked_matmul.py``) against the
reference's Pallas kernel ``_pallas_matmul`` (``benchmark/conv_kernel_probe.py``).

On the CPU the reference kernel runs in the Pallas interpreter
(``force_tpu_interpret_mode``) and the port's wrapper takes its plain
version; only shapes that divide into the Pallas blocks are compared, since
the Pallas grid leaves the rows past the last whole block unwritten (the
CUDA kernel masks them). Tolerances, relative to the output's largest
|value|: 1e-5 in float32 (both sum f32 products, in another order); 1e-2 in
bfloat16, where the one rounding of the f32 sum to bfloat16 (ulp 2^-8 of
the value) can go either way when the two sums differ in their last bits.

The 16-bit kernel reads its operands through TMA tensor maps, whose rows
must start 16 bytes apart: ``tma_operand`` (pure Python) decides which
operand is copied into a zero-padded buffer, and its tests run here.

The ``gpu`` tests hold the kernels against the plain version on the card,
ragged edges, strided inputs and the probe's ResNet-50 shapes included, and
skip here.
"""
import importlib.util
import pathlib

import numpy as np
import pytest
import torch

from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops.cuda import blocked_matmul as bm
from torch_threads import one_torch_thread  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parents[1]
TOL = {"float32": 1e-5, "bfloat16": 1e-2, "float16": 1e-2}


@pytest.fixture(scope="module")
def pallas_matmul():
    spec = importlib.util.spec_from_file_location(
        "conv_kernel_probe", ROOT / "benchmark" / "conv_kernel_probe.py")
    probe = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(probe)
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu

    def run(a, b, blocks):
        dt = jnp.bfloat16 if a.dtype == torch.bfloat16 else jnp.float32
        with pltpu.force_tpu_interpret_mode():
            out = probe._pallas_matmul(jnp.asarray(a.float().numpy(), dt),
                                       jnp.asarray(b.float().numpy(), dt), *blocks)
        assert out.dtype == dt
        return np.asarray(out.astype(jnp.float32))
    return run


def _inputs(seed, m, k, n, dtype):
    rs = np.random.RandomState(seed)
    a = torch.from_numpy(rs.standard_normal((m, k)).astype(np.float32)).to(dtype)
    b = torch.from_numpy(rs.standard_normal((k, n)).astype(np.float32)).to(dtype)
    return a, b


def _rel(got, expect):
    return float(np.abs(got - expect).max() / np.abs(expect).max())


@pytest.mark.parametrize("m,k,n,blocks,dtype", [
    (256, 512, 256, (128, 256, 128), "bfloat16"),
    (512, 256, 128, (256, 128, 128), "bfloat16"),
    (128, 384, 256, (128, 128, 128), "float32"),
])
def test_plain_matches_pallas_kernel(pallas_matmul, m, k, n, blocks, dtype):
    a, b = _inputs(m + k + n, m, k, n, getattr(torch, dtype))
    expect = pallas_matmul(a, b, blocks)
    before = bm.blocked_matmul.launches
    got = bm.blocked_matmul(a, b)
    assert bm.blocked_matmul.launches == before          # CPU: no kernel
    assert got.dtype == a.dtype and got.shape == (m, n)
    assert _rel(got.float().numpy(), expect) <= TOL[dtype]


def test_plain_sums_every_k_block_and_edge():
    """Ragged M, N and K (K not a multiple of the 256-deep blocks): the f32
    sum of every product, then one rounding."""
    a, b = _inputs(0, 37, 600, 19, torch.bfloat16)
    got = bm.blocked_matmul_plain(a, b)
    expect = (a.double() @ b.double()).to(torch.bfloat16)
    assert got.dtype == torch.bfloat16
    diff = (got.double() - expect.double()).abs().max().item()
    assert diff <= 2 ** -7 * expect.double().abs().max().item()


@pytest.mark.parametrize("a,b", [
    (torch.zeros(4, 5), torch.zeros(4, 5)),
    (torch.zeros(4, 5), torch.zeros(5, 3, dtype=torch.bfloat16)),
    (torch.zeros(4, 5, dtype=torch.int32), torch.zeros(5, 3, dtype=torch.int32)),
    (torch.zeros(2, 4, 5), torch.zeros(5, 3)),
])
def test_wrapper_refuses_what_the_kernel_does_not_take(a, b):
    with pytest.raises(MXNetError):
        bm.blocked_matmul(a, b)


def _cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run on the card")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("m,k,n", [(256, 512, 256), (300, 1000, 70), (1, 33, 129),
                                   (2048, 4608, 512)])
def test_kernel_matches_plain(dtype, m, k, n):
    _cuda_or_skip()
    a, b = (t.cuda() for t in _inputs(m * 7 + n, m, k, n, getattr(torch, dtype)))
    before = bm.blocked_matmul.launches
    got = bm.blocked_matmul(a, b)
    torch.cuda.synchronize()
    assert bm.blocked_matmul.launches == before + 1
    expect = bm.blocked_matmul_plain(a, b)
    assert got.dtype == a.dtype and got.shape == (m, n)
    assert _rel(got.float().cpu().numpy(), expect.float().cpu().numpy()) <= TOL[dtype]


@pytest.mark.gpu
def test_kernel_reads_strided_inputs():
    _cuda_or_skip()
    a, b = (t.cuda() for t in _inputs(5, 200, 96, 64, torch.float32))
    got = bm.blocked_matmul(a.t().contiguous().t(), b[:, :64])
    expect = bm.blocked_matmul_plain(a, b)
    assert _rel(got.cpu().numpy(), expect.cpu().numpy()) <= TOL["float32"]


@pytest.mark.parametrize("m,k,n,pad_a,pad_b", [
    (5, 16, 24, False, False),   # both row lengths multiples of 8: no copy
    (5, 7, 24, True, False),     # K = 7: A's rows are padded
    (5, 16, 9, False, True),     # N = 9: B's rows are padded
    (3, 129, 127, True, True),
    (1, 1, 1, True, True),
])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_tma_operand_pads_only_rows_tma_cannot_step(m, k, n, pad_a, pad_b, dtype):
    a, b = _inputs(m + k + n, m, k, n, dtype)
    a2, b2 = bm.tma_operand(a), bm.tma_operand(b)
    for t, t2, padded in ((a, a2, pad_a), (b, b2, pad_b)):
        rows, cols = t.shape
        assert (t2 is not t) == padded
        assert t2.shape == (rows, -(-cols // 8) * 8) and t2.dtype == dtype
        assert t2.is_contiguous() and t2.data_ptr() % 16 == 0
        assert torch.equal(t2[:, :cols], t)
        assert not t2[:, cols:].any()
    # the product over the padded buffers: A's zero columns meet B's zero rows
    k8 = a2.shape[1]
    b_rows = torch.cat([b2, b2.new_zeros((k8 - k, b2.shape[1]))])
    got = bm.blocked_matmul_plain(a2, b_rows)[:, :n]
    expect = bm.blocked_matmul_plain(a, b)
    assert got.dtype == dtype and got.shape == (m, n)
    assert torch.equal(got, expect)


def test_tma_operand_copies_layouts_tma_cannot_read():
    """A transposed view and a view off a 16-byte boundary are copied; a
    contiguous operand with 16-byte rows is used as it is."""
    a, b = _inputs(1, 64, 32, 16, torch.bfloat16)
    at = a.t().contiguous().t()
    flat = torch.zeros(b.numel() + 8, dtype=b.dtype)
    start = (-flat.data_ptr() % 16) // 2 + 1
    b_off = flat[start:start + b.numel()].view(b.shape)
    b_off.copy_(b)
    assert b_off.is_contiguous() and b_off.data_ptr() % 16 == 2
    a2, b2 = bm.tma_operand(at), bm.tma_operand(b_off)
    assert a2 is not at and torch.equal(a2, a) and a2.is_contiguous()
    assert b2 is not b_off and torch.equal(b2, b) and b2.data_ptr() % 16 == 0
    assert bm.tma_operand(a) is a


EDGES = [1, 7, 9, 127, 129]
PROBE_SHAPES = [(6656, 2560, 256), (2048, 4608, 512), (6656, 1024, 256)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
@pytest.mark.parametrize("m", EDGES)
@pytest.mark.parametrize("k", EDGES)
@pytest.mark.parametrize("n", EDGES)
def test_wgmma_kernel_edges(dtype, m, k, n):
    """M, N and K across the 128 x 64 tile and the 64-deep K slice, and
    below the 8-element step of TMA's rows (a padded operand)."""
    _cuda_or_skip()
    a, b = (t.cuda() for t in _inputs(m * 7 + n + k, m, k, n, getattr(torch, dtype)))
    before = bm.blocked_matmul.launches
    got = bm.blocked_matmul(a, b)
    torch.cuda.synchronize()
    assert bm.blocked_matmul.launches == before + 1
    expect = bm.blocked_matmul_plain(a, b)
    assert got.dtype == a.dtype and got.shape == (m, n) and got.is_contiguous()
    assert _rel(got.float().cpu().numpy(), expect.float().cpu().numpy()) <= TOL[dtype]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
@pytest.mark.parametrize("m,k,n", PROBE_SHAPES)
def test_wgmma_kernel_probe_shapes(dtype, m, k, n):
    _cuda_or_skip()
    gen = torch.Generator(device="cuda").manual_seed(m + k + n)
    a = torch.randn((m, k), generator=gen, device="cuda").to(getattr(torch, dtype))
    b = (0.05 * torch.randn((k, n), generator=gen, device="cuda")).to(a.dtype)
    got = bm.blocked_matmul(a, b)
    expect = bm.blocked_matmul_plain(a, b)
    torch.cuda.synchronize()
    assert _rel(got.float().cpu().numpy(), expect.float().cpu().numpy()) <= TOL[dtype]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
@pytest.mark.parametrize("layout", ["transposed", "column-slice", "row-offset"])
def test_wgmma_kernel_reads_strided_inputs(dtype, layout):
    _cuda_or_skip()
    a, b = (t.cuda() for t in _inputs(5, 200, 96, 136, getattr(torch, dtype)))
    if layout == "transposed":
        a_in, b_in = a.t().contiguous().t(), b.t().contiguous().t()
    elif layout == "column-slice":
        wide = torch.zeros((96, 200), dtype=b.dtype, device="cuda")
        wide[:, :136] = b
        a_in, b_in = a, wide[:, :136]
    else:
        flat = torch.zeros(a.numel() + 8, dtype=a.dtype, device="cuda")
        a_in = flat[1:1 + a.numel()].view(a.shape)
        a_in.copy_(a)
        b_in = b
    got = bm.blocked_matmul(a_in, b_in)
    expect = bm.blocked_matmul_plain(a, b)
    torch.cuda.synchronize()
    assert _rel(got.float().cpu().numpy(), expect.float().cpu().numpy()) <= TOL[dtype]


@pytest.mark.gpu
def test_wgmma_kernel_replays_in_a_cuda_graph():
    """The launch, tensor maps and all, is captured and replayed."""
    _cuda_or_skip()
    a, b = (t.cuda() for t in _inputs(9, 300, 256, 192, torch.bfloat16))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        bm.blocked_matmul(a, b)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = bm.blocked_matmul(a, b)
    a.copy_(a.flip(0))
    graph.replay()
    torch.cuda.synchronize()
    expect = bm.blocked_matmul_plain(a, b)
    assert _rel(out.float().cpu().numpy(), expect.float().cpu().numpy()) <= TOL["bfloat16"]
