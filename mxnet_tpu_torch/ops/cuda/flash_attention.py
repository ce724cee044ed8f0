"""Flash attention: CUDA kernels, wrappers, plain versions, autograd.

Counterpart of ``mxnet_tpu/ops/pallas/flash_attention.py``. The three Pallas
kernels become hand-written Hopper kernels, built at first use by
``ops/cuda.load_library`` and called through ctypes:

- ``_fwd_kernel`` (:86, launched by ``_fwd`` at :136) ->
  ``csrc/flash_attention_fwd.cu``, wrapper ``flash_attention_fwd(q3, k3,
  v3, causal, scale) -> (o, lse)``;
- ``_bwd_dq_kernel`` (:181, launched at :294) -> ``csrc/flash_attention_bwd.cu``,
  wrapper ``flash_attention_bwd_dq(q3, k3, v3, do3, lse, delta, ...) -> dq``;
- ``_bwd_dkv_kernel`` (:229, launched at :321) -> the same source, wrapper
  ``flash_attention_bwd_dkv(...) -> (dk, dv)``.

Each wrapper works on (BH, T, D) tensors, launches its kernel for CUDA
tensors, raises if the launch fails, and counts its launches in
``<wrapper>.launches``. ``flash_attention_fwd`` and ``flash_attention_bwd``
take their plain versions (``flash_attention_fwd_plain``,
``flash_attention_bwd_plain``) for CPU tensors; there is no other branch.

``FlashAttentionFunction`` (a ``torch.autograd.Function``) is the
counterpart of ``_flash``'s ``custom_vjp`` (:362-379): its forward runs
``flash_attention_fwd`` and saves q, k, v, O and the LSE; its backward makes
dO contiguous and aligned, computes delta = rowsum(dO * O) with torch ops (the reference
leaves it to XLA, :283) and launches the two backward kernels, or, for CPU
tensors, runs the plain backward. ``flash_attention(q, k, v, causal, scale,
block_q, block_k)`` is the public (B, H, T, D) entry point with the
reference's signature (:382-412); its reshape to (BH, T, D) and the
contiguous, aligned copies stay outside the Function, so torch differentiates
them. ``block_q`` and ``block_k`` are accepted for that signature and change
nothing: the kernels' tiles are their own, and the plain versions take keys
in blocks of 256.

The raw ``flash_attention_fwd`` has no backward of its own: called directly
on inputs that require a gradient while autograd is enabled it raises,
rather than return a result that silently has none. Inside the Function's
forward autograd is off, so the differentiable path is ``flash_attention``.

Strides: q, k and v reach this module as (B, H, T, D) views out of a
``transpose``, not contiguous, and so does dO; the wrappers take contiguous
tensors (one copy each), and kernels that take strides are left for a
later PR. The backward kernels copy rows into shared memory 16 bytes at a
time (``cp.async``), so their wrappers also refuse a tensor whose data does
not start on a 16-byte boundary, as a contiguous view at a storage offset
may; ``flash_attention`` and the Function's backward pass such inputs on as
aligned copies (``_aligned``).
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from ...base import MXNetError
from ..attention import blockwise_attention_bwd, blockwise_attention_lse
from . import load_library

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_HEAD_DIMS = (32, 64, 128)


def _library() -> ctypes.CDLL:
    lib = load_library("flash_attention_fwd", ["flash_attention_fwd.cu"])
    fn = lib.mxt_flash_attention_fwd
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + \
            [ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.mxt_cuda_error_string.argtypes = [ctypes.c_int]
        lib.mxt_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _bwd_library() -> ctypes.CDLL:
    lib = load_library("flash_attention_bwd", ["flash_attention_bwd.cu"])
    if lib.mxt_flash_attention_bwd_dq.argtypes is None:
        # dq: q k v do lse delta dq; dkv: q k v do lse delta dk dv
        lib.mxt_flash_attention_bwd_dq.argtypes = [ctypes.c_void_p] * 7 + \
            [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_void_p]
        lib.mxt_flash_attention_bwd_dkv.argtypes = [ctypes.c_void_p] * 8 + \
            [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_void_p]
        lib.mxt_flash_attention_bwd_dq.restype = ctypes.c_int
        lib.mxt_flash_attention_bwd_dkv.restype = ctypes.c_int
        # (dkv, d, dtype code) -> dynamic shared memory of a block, bytes
        lib.mxt_flash_attention_bwd_smem_bytes.argtypes = [ctypes.c_int] * 3
        lib.mxt_flash_attention_bwd_smem_bytes.restype = ctypes.c_int
        lib.mxt_cuda_error_string.argtypes = [ctypes.c_int]
        lib.mxt_cuda_error_string.restype = ctypes.c_char_p
    return lib


def flash_attention_fwd_plain(q3, k3, v3, causal: bool = False,
                              scale: Optional[float] = None):
    """Plain PyTorch version of the kernel: the same arithmetic (f32 scores
    and statistics, masked entries at -1e30, p rounded to V's dtype before
    the PV product), on any device."""
    return blockwise_attention_lse(q3, k3, v3, block_size=256, causal=causal,
                                   scale=scale, round_p=True)


def _check(q3, k3, v3, do3=None, lse=None, delta=None,
           who="flash_attention_fwd"):
    named = [("q", q3), ("k", k3), ("v", v3)]
    if do3 is not None:
        named.append(("do", do3))
    for name, t in named:
        if t.device != q3.device:
            raise MXNetError(f"{who}: {name} on {t.device}, q on {q3.device}")
        if t.dtype != q3.dtype:
            raise MXNetError(f"{who}: {name} is {t.dtype}, q is {q3.dtype}")
        if t.dim() != 3:
            raise MXNetError(f"{who}: {name} must be (BH, T, D), "
                             f"got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise MXNetError(f"{who}: {name} is not contiguous")
        if do3 is not None and t.data_ptr() % 16:
            raise MXNetError(f"{who}: {name} does not start on a 16-byte "
                             f"boundary (storage offset {t.storage_offset()}); "
                             f"the backward kernels copy rows 16 B at a time")
    if q3.dtype not in _DTYPE_CODES:
        raise MXNetError(f"{who}: dtype {q3.dtype} not supported "
                         f"(float32, bfloat16, float16)")
    BH, T, D = q3.shape
    if k3.shape != v3.shape or k3.shape[0] != BH or k3.shape[2] != D:
        raise MXNetError(f"{who}: shapes q {tuple(q3.shape)} "
                         f"k {tuple(k3.shape)} v {tuple(v3.shape)} disagree")
    if do3 is not None and do3.shape != q3.shape:
        raise MXNetError(f"{who}: do {tuple(do3.shape)} is not q's shape")
    for name, t in (("lse", lse), ("delta", delta)):
        if t is not None and (t.shape != (BH, T) or t.dtype != torch.float32
                              or t.device != q3.device or not t.is_contiguous()):
            raise MXNetError(f"{who}: {name} must be contiguous ({BH}, {T}) "
                             f"float32 on {q3.device}")
    if D not in _HEAD_DIMS:
        raise MXNetError(f"{who}: head dim {D} not in {_HEAD_DIMS}")
    if BH >= 2 ** 31 or -(-max(T, k3.shape[1]) // 32) > 65535:
        raise MXNetError(f"{who}: grid too large for {tuple(q3.shape)}")


def flash_attention_fwd(q3, k3, v3, causal: bool = False,
                        scale: Optional[float] = None):
    """softmax(q k^T * scale) v on (BH, T, D) -> (O like q, LSE (BH, T) f32)."""
    D = q3.shape[-1]
    scale = float(scale) if scale is not None else 1.0 / math.sqrt(D)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q3, k3, v3)):
        raise MXNetError("flash_attention_fwd has no backward of its own; "
                         "call flash_attention (the autograd.Function) for "
                         "a gradient, or this under torch.no_grad()")
    if q3.device.type == "cpu":
        return flash_attention_fwd_plain(q3, k3, v3, causal, scale)
    if q3.device.type != "cuda":
        raise MXNetError(f"flash_attention_fwd: unsupported device {q3.device}")
    _check(q3, k3, v3)
    BH, T, _ = q3.shape
    o = torch.empty_like(q3)
    lse = torch.empty((BH, T), dtype=torch.float32, device=q3.device)
    if o.numel() == 0:
        return o, lse
    lib = _library()
    with torch.cuda.device(q3.device):
        stream = torch.cuda.current_stream(q3.device).cuda_stream
        err = lib.mxt_flash_attention_fwd(
            q3.data_ptr(), k3.data_ptr(), v3.data_ptr(), o.data_ptr(),
            lse.data_ptr(), BH, T, k3.shape[1], D, _DTYPE_CODES[q3.dtype],
            int(bool(causal)), scale, stream)
    if err != 0:
        msg = lib.mxt_cuda_error_string(err).decode()
        raise MXNetError(f"flash_attention_fwd kernel launch failed: {msg}")
    flash_attention_fwd.launches += 1
    return o, lse


flash_attention_fwd.launches = 0


def flash_attention_bwd_plain(q3, k3, v3, o, lse, do3, causal: bool = False,
                              scale: Optional[float] = None):
    """Plain PyTorch version of the two backward kernels (the same
    arithmetic and roundings, ``ops/attention.blockwise_attention_bwd``)."""
    return blockwise_attention_bwd(q3, k3, v3, o, lse, do3, causal=causal,
                                   scale=scale, block_size=256)


def _launch_bwd(entry, who, args):
    err = entry(*args)
    if err != 0:
        msg = _bwd_library().mxt_cuda_error_string(err).decode()
        raise MXNetError(f"{who} kernel launch failed: {msg}")


def flash_attention_bwd_dq(q3, k3, v3, do3, lse, delta, causal: bool = False,
                           scale: Optional[float] = None):
    """dQ on CUDA (BH, T, D) tensors, by the kernel; raises for others."""
    if q3.device.type != "cuda":
        raise MXNetError(f"flash_attention_bwd_dq: unsupported device {q3.device}")
    _check(q3, k3, v3, do3, lse, delta, who="flash_attention_bwd_dq")
    BH, T, D = q3.shape
    scale = float(scale) if scale is not None else 1.0 / math.sqrt(D)
    dq = torch.empty_like(q3)
    if dq.numel() == 0:
        return dq
    lib = _bwd_library()
    with torch.cuda.device(q3.device):
        stream = torch.cuda.current_stream(q3.device).cuda_stream
        _launch_bwd(lib.mxt_flash_attention_bwd_dq, "flash_attention_bwd_dq", (
            q3.data_ptr(), k3.data_ptr(), v3.data_ptr(), do3.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), BH, T,
            k3.shape[1], D, _DTYPE_CODES[q3.dtype], int(bool(causal)), scale,
            stream))
    flash_attention_bwd_dq.launches += 1
    return dq


def flash_attention_bwd_dkv(q3, k3, v3, do3, lse, delta, causal: bool = False,
                            scale: Optional[float] = None):
    """(dK, dV) on CUDA (BH, Tk, D) tensors, by the kernel; raises for others."""
    if q3.device.type != "cuda":
        raise MXNetError(f"flash_attention_bwd_dkv: unsupported device {q3.device}")
    _check(q3, k3, v3, do3, lse, delta, who="flash_attention_bwd_dkv")
    BH, T, D = q3.shape
    scale = float(scale) if scale is not None else 1.0 / math.sqrt(D)
    dk, dv = torch.empty_like(k3), torch.empty_like(v3)
    if dk.numel() == 0:
        return dk, dv
    lib = _bwd_library()
    with torch.cuda.device(q3.device):
        stream = torch.cuda.current_stream(q3.device).cuda_stream
        _launch_bwd(lib.mxt_flash_attention_bwd_dkv, "flash_attention_bwd_dkv", (
            q3.data_ptr(), k3.data_ptr(), v3.data_ptr(), do3.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), BH,
            T, k3.shape[1], D, _DTYPE_CODES[q3.dtype], int(bool(causal)),
            scale, stream))
    flash_attention_bwd_dkv.launches += 1
    return dk, dv


flash_attention_bwd_dq.launches = 0
flash_attention_bwd_dkv.launches = 0


def flash_attention_bwd(q3, k3, v3, o, lse, do3, causal: bool = False,
                        scale: Optional[float] = None):
    """(dq, dk, dv) of attention on (BH, T, D) tensors from the forward's O
    and LSE: the two kernels for CUDA tensors, the plain version for CPU
    tensors (reference ``_bwd`` :279)."""
    if q3.device.type == "cpu":
        return flash_attention_bwd_plain(q3, k3, v3, o, lse, do3, causal, scale)
    if q3.device.type != "cuda":
        raise MXNetError(f"flash_attention_bwd: unsupported device {q3.device}")
    delta = (do3.float() * o.float()).sum(dim=-1)
    dq = flash_attention_bwd_dq(q3, k3, v3, do3, lse, delta, causal, scale)
    dk, dv = flash_attention_bwd_dkv(q3, k3, v3, do3, lse, delta, causal, scale)
    return dq, dk, dv


def _aligned(t):
    """``t`` contiguous and starting on a 16-byte boundary (a copy if not)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


class FlashAttentionFunction(torch.autograd.Function):
    """Differentiable flash attention on (BH, T, D) tensors (reference
    ``_flash`` custom_vjp :362-379). ``backward_calls`` counts backward
    passes, on any device."""

    backward_calls = 0

    @staticmethod
    def forward(ctx, q3, k3, v3, causal, scale):
        o, lse = flash_attention_fwd(q3, k3, v3, causal, scale)
        ctx.save_for_backward(q3, k3, v3, o, lse)
        ctx.causal, ctx.scale = causal, scale
        return o

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, do):
        FlashAttentionFunction.backward_calls += 1
        q3, k3, v3, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q3, k3, v3, o, lse, _aligned(do),
                                         ctx.causal, ctx.scale)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, causal: bool = False, scale=None,
                    block_q: int = 256, block_k: int = 256):
    """Flash attention on (B, H, T, D) tensors; differentiable."""
    B, H, T, D = q.shape
    Tk = k.shape[2]
    scale = float(scale) if scale is not None else 1.0 / math.sqrt(D)
    o = FlashAttentionFunction.apply(_aligned(q.reshape(B * H, T, D)),
                                     _aligned(k.reshape(B * H, Tk, D)),
                                     _aligned(v.reshape(B * H, Tk, D)),
                                     bool(causal), scale)
    return o.reshape(B, H, T, D)
