"""Blocked matrix product: CUDA kernels, wrapper and plain version.

Counterpart of the Pallas TPU kernel ``benchmark/conv_kernel_probe.py``
``_pallas_matmul`` (:39-74): (M, K) x (K, N), products summed in f32, the
result in ``a``'s dtype. It is the probe of whether a hand-tiled product
beats the library's convolution on the im2col form of ResNet-50's batch-32
convolutions; ``chip_smoke.py`` runs it over those shapes (phase
``probe``). The kernels are ``csrc/blocked_matmul.cu``, built at first use
by ``ops/cuda.load_library`` and called through ctypes: bf16 and f16 on the
tensor cores (``wgmma`` fed by TMA), f32 on the FMA units.

``blocked_matmul(a, b)`` launches a kernel for CUDA tensors (and counts its
launches in ``blocked_matmul.launches``), takes the plain version for CPU
tensors, and raises for anything else. Inputs are 2-D, of one dtype
(float32, bfloat16 or float16) and on one device. Every edge is masked, so
any M, N, K >= 1 is computed: the Pallas grid's block sizes (``bm``,
``bk``, ``bn``) have no counterpart. The f32 kernel reads its inputs
contiguous (a strided input is copied once). The 16-bit kernel reads them
through TMA tensor maps, which need rows that start on 16-byte boundaries:
``tma_operand`` decides for each operand whether it is used as it is or
copied once into a zero-padded buffer (a row length, K for ``a`` or N for
``b``, that is not a multiple of 8, or a layout that is not contiguous).

``blocked_matmul_plain(a, b)`` repeats the arithmetic: f32 products of
k-blocks of 256 added into an f32 sum, then one cast to ``a``'s dtype.
"""
from __future__ import annotations

import ctypes

import torch

from ... import engine
from ...base import MXNetError
from . import load_library

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def _library() -> ctypes.CDLL:
    lib = load_library("blocked_matmul", ["blocked_matmul.cu"])
    fn = lib.mxt_blocked_matmul
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.mxt_cuda_error_string.argtypes = [ctypes.c_int]
        lib.mxt_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _check(a, b):
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise MXNetError(f"blocked_matmul: shapes {tuple(a.shape)} x "
                         f"{tuple(b.shape)} do not make a matrix product")
    if a.dtype != b.dtype or a.dtype not in _DTYPE_CODES:
        raise MXNetError(f"blocked_matmul: dtypes {a.dtype}, {b.dtype} (one of "
                         f"float32, bfloat16, float16 for both)")
    if a.device != b.device:
        raise MXNetError(f"blocked_matmul: a on {a.device}, b on {b.device}")


def blocked_matmul_plain(a, b, block_k: int = 256):
    """The kernel's arithmetic in PyTorch: f32 sums of k-blocks, cast once."""
    _check(a, b)
    acc = torch.zeros((a.shape[0], b.shape[1]), dtype=torch.float32, device=a.device)
    for k0 in range(0, a.shape[1], block_k):
        acc += a[:, k0:k0 + block_k].float() @ b[k0:k0 + block_k].float()
    return acc.to(a.dtype)


def tma_operand(t):
    """``t`` (rows, cols), 16-bit, as the wgmma kernel reads it: rows
    ceil8(cols) elements apart (16-byte steps, as TMA needs) from a 16-byte
    aligned start. ``t`` itself when it is contiguous with such rows, else a
    copy into a zero-filled (rows, ceil8(cols)) buffer whose first ``cols``
    columns are ``t``."""
    rows, cols = t.shape
    pitch = -(-cols // 8) * 8
    if pitch == cols and t.is_contiguous() and t.data_ptr() % 16 == 0:
        return t
    buf = t.new_zeros((rows, pitch))
    buf[:, :cols] = t
    return buf


def blocked_matmul(a, b):
    """``a @ b`` with an f32 sum, in ``a``'s dtype: the kernel on CUDA
    tensors, the plain version on CPU tensors."""
    _check(a, b)
    if a.device.type == "cpu":
        return blocked_matmul_plain(a, b)
    if a.device.type != "cuda":
        raise MXNetError(f"blocked_matmul: unsupported device {a.device}")
    m, k = a.shape
    n = b.shape[1]
    if max(m, n, k) >= 2 ** 31 or -(-m // 128) > 65535:
        raise MXNetError(f"blocked_matmul: {m}x{k}x{n} is too large for the grid")
    c = torch.empty((m, n), dtype=a.dtype, device=a.device)
    if c.numel() == 0 or k == 0:
        return c.zero_()
    if a.dtype == torch.float32:
        a, b = a.contiguous(), b.contiguous()
    else:
        a, b = tma_operand(a), tma_operand(b)
    lib = _library()
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = lib.mxt_blocked_matmul(a.data_ptr(), b.data_ptr(), c.data_ptr(),
                                     m, n, k, _DTYPE_CODES[a.dtype], stream)
    if err != 0:
        raise MXNetError(f"blocked_matmul kernel launch failed: "
                         f"{lib.mxt_cuda_error_string(err).decode()}")
    blocked_matmul.launches += 1
    return c


blocked_matmul.launches = 0
engine.register_counter(blocked_matmul, "launches")
