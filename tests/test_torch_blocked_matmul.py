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

The ``gpu`` tests hold the kernel against the plain version on the card,
ragged edges and the probe's ResNet-50 shapes included, and skip here.
"""
import importlib.util
import pathlib

import numpy as np
import pytest
import torch

from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops.cuda import blocked_matmul as bm

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
