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
``<wrapper>.launches``, by the inputs' dtype (``"float32"``,
``"bfloat16"``, ``"float16"``) in ``<wrapper>.launches_by_dtype``, by
the shape ``"BHxTqxTkxD"`` in ``<wrapper>.launches_by_shape`` and by the
mask (``"causal"``, ``"full"``) in ``<wrapper>.launches_by_mask``; a CUDA
graph that captured launches adds them again at each replay (``engine``).
A launch also adds its FLOPs by the kernel's formula to any open
``engine.count_flops()`` (``engine.attention_flops``: ``FlopCounterMode``
sees nothing inside a kernel launched through ctypes).
``flash_attention_fwd`` and ``flash_attention_bwd`` take their plain versions
(``flash_attention_fwd_plain``, ``flash_attention_bwd_plain``) for CPU
tensors; there is no other branch.

``FlashAttentionFunction`` (a ``torch.autograd.Function``) is the
counterpart of ``_flash``'s ``custom_vjp`` (:362-379): its forward runs
``flash_attention_fwd`` and saves q, k, v, O and the LSE; its backward makes
dO contiguous and aligned, computes delta = rowsum(dO * O) with torch ops (the reference
leaves it to XLA, :283) and launches the two backward kernels, or, for CPU
tensors, runs the plain backward. Under ``create_graph`` (a backward with
grad enabled) the same two kernels give the gradients through a second
Function, ``_FlashAttentionGrads``, whose own backward (the double
backward) is plain torch ops (its docstring says why); the first-order
path launches and saves nothing more. ``flash_attention(q, k, v, causal, scale,
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
tensors (one copy each); kernels that take strides are not written yet.
Head dims: the kernels are instantiated at D = 16, 32, 64, 128 and 256
(D = 256 in two passes of 128 output columns, ``csrc/tensor_core.cuh``).
The wrappers zero-pad Q, K, V and dO of any other D up to 256 on the last
axis to the next instantiated width (``_kernel_dim``; 129-255 to 256),
launch with the scale of the original D, and slice O, dQ, dK and dV back;
the counters see the original shape. A zero column adds nothing to the
scores and gives zero columns of every output, so the result is the
unpadded one. D above 256 raises (the reference's Pallas kernels take it;
no model of the repository has such a head).

All three kernels copy rows into shared memory 16 bytes at a time
(``cp.async``), so their wrappers also refuse a CUDA tensor whose data
does not start on a 16-byte boundary, as a contiguous view at a storage
offset may; ``flash_attention`` and the Function's backward pass such
inputs on as aligned copies (``_aligned``).
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from ... import engine
from ...base import MXNetError
from ..attention import blockwise_attention_bwd, blockwise_attention_lse
from . import load_library

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_HEAD_DIMS = (16, 32, 64, 128, 256)    # the kernels' instantiations


def _kernel_dim(D: int, who: str) -> int:
    """The instantiated head dim a CUDA call of head dim ``D`` runs at: the
    least one not below ``D``; above 256 none, and the call raises."""
    for d in _HEAD_DIMS:
        if D <= d:
            return d
    raise MXNetError(f"{who}: head dim {D} above {_HEAD_DIMS[-1]}, the widest the "
                     f"kernels take")


def _pad_dim(t, d: int):
    """``t`` zero-padded on its last axis to ``d`` (``t`` itself at ``d``). A
    zero column adds nothing to Q K^T, and gives zero columns of O, dQ, dK
    and dV, which the wrappers slice off."""
    return t if t.shape[-1] == d else torch.nn.functional.pad(t, (0, d - t.shape[-1]))


def _unpad(t, D: int):
    return t if t.shape[-1] == D else t[..., :D].contiguous()


def _library() -> ctypes.CDLL:
    lib = load_library("flash_attention_fwd", ["flash_attention_fwd.cu"])
    fn = lib.mxt_flash_attention_fwd
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + \
            [ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        # (d, dtype code) -> dynamic shared memory of a block, bytes
        lib.mxt_flash_attention_fwd_smem_bytes.argtypes = [ctypes.c_int] * 2
        lib.mxt_flash_attention_fwd_smem_bytes.restype = ctypes.c_int
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
        if t.data_ptr() % 16:
            raise MXNetError(f"{who}: {name} does not start on a 16-byte "
                             f"boundary (storage offset {t.storage_offset()}); "
                             f"the kernels copy rows 16 B at a time")
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


def _count(wrapper, q3, k3, causal) -> None:
    """One launch of ``wrapper``'s kernel on inputs of ``q3``'s dtype and the
    shape (BH, Tq, Tk, D), with or without the causal mask."""
    wrapper.launches += 1
    mask = "causal" if causal else "full"
    wrapper.launches_by_mask[mask] = wrapper.launches_by_mask.get(mask, 0) + 1
    name = str(q3.dtype).rpartition(".")[2]
    wrapper.launches_by_dtype[name] = wrapper.launches_by_dtype.get(name, 0) + 1
    shape = f"{q3.shape[0]}x{q3.shape[1]}x{k3.shape[1]}x{q3.shape[2]}"
    wrapper.launches_by_shape[shape] = wrapper.launches_by_shape.get(shape, 0) + 1
    engine.add_flops(engine.attention_flops(wrapper.flop_kind, q3.shape[0], q3.shape[1],
                                            k3.shape[1], q3.shape[2], causal))


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
    Dk = _kernel_dim(D, "flash_attention_fwd")
    qp, kp, vp = (_pad_dim(t, Dk) for t in (q3, k3, v3))
    _check(qp, kp, vp)
    BH, T, _ = q3.shape
    o = torch.empty_like(qp)
    lse = torch.empty((BH, T), dtype=torch.float32, device=q3.device)
    if o.numel() == 0:
        return _unpad(o, D), lse
    lib = _library()
    with torch.cuda.device(q3.device):
        stream = torch.cuda.current_stream(q3.device).cuda_stream
        err = lib.mxt_flash_attention_fwd(
            qp.data_ptr(), kp.data_ptr(), vp.data_ptr(), o.data_ptr(),
            lse.data_ptr(), BH, T, k3.shape[1], Dk, _DTYPE_CODES[q3.dtype],
            int(bool(causal)), scale, stream)
    if err != 0:
        msg = lib.mxt_cuda_error_string(err).decode()
        raise MXNetError(f"flash_attention_fwd kernel launch failed: {msg}")
    _count(flash_attention_fwd, q3, k3, causal)
    return _unpad(o, D), lse


flash_attention_fwd.launches = 0
flash_attention_fwd.flop_kind = "fwd"
flash_attention_fwd.launches_by_dtype = {}
flash_attention_fwd.launches_by_shape = {}
flash_attention_fwd.launches_by_mask = {}


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
    D = q3.shape[-1]
    scale = float(scale) if scale is not None else 1.0 / math.sqrt(D)
    Dk = _kernel_dim(D, "flash_attention_bwd_dq")
    qp, kp, vp, dop = (_pad_dim(t, Dk) for t in (q3, k3, v3, do3))
    _check(qp, kp, vp, dop, lse, delta, who="flash_attention_bwd_dq")
    BH, T = q3.shape[:2]
    dq = torch.empty_like(qp)
    if dq.numel() == 0:
        return _unpad(dq, D)
    lib = _bwd_library()
    with torch.cuda.device(q3.device):
        stream = torch.cuda.current_stream(q3.device).cuda_stream
        _launch_bwd(lib.mxt_flash_attention_bwd_dq, "flash_attention_bwd_dq", (
            qp.data_ptr(), kp.data_ptr(), vp.data_ptr(), dop.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), BH, T,
            k3.shape[1], Dk, _DTYPE_CODES[q3.dtype], int(bool(causal)), scale,
            stream))
    _count(flash_attention_bwd_dq, q3, k3, causal)
    return _unpad(dq, D)


def flash_attention_bwd_dkv(q3, k3, v3, do3, lse, delta, causal: bool = False,
                            scale: Optional[float] = None):
    """(dK, dV) on CUDA (BH, Tk, D) tensors, by the kernel; raises for others."""
    if q3.device.type != "cuda":
        raise MXNetError(f"flash_attention_bwd_dkv: unsupported device {q3.device}")
    D = q3.shape[-1]
    scale = float(scale) if scale is not None else 1.0 / math.sqrt(D)
    Dk = _kernel_dim(D, "flash_attention_bwd_dkv")
    qp, kp, vp, dop = (_pad_dim(t, Dk) for t in (q3, k3, v3, do3))
    _check(qp, kp, vp, dop, lse, delta, who="flash_attention_bwd_dkv")
    BH, T = q3.shape[:2]
    dk, dv = torch.empty_like(kp), torch.empty_like(vp)
    if dk.numel() == 0:
        return _unpad(dk, D), _unpad(dv, D)
    lib = _bwd_library()
    with torch.cuda.device(q3.device):
        stream = torch.cuda.current_stream(q3.device).cuda_stream
        _launch_bwd(lib.mxt_flash_attention_bwd_dkv, "flash_attention_bwd_dkv", (
            qp.data_ptr(), kp.data_ptr(), vp.data_ptr(), dop.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), BH,
            T, k3.shape[1], Dk, _DTYPE_CODES[q3.dtype], int(bool(causal)),
            scale, stream))
    _count(flash_attention_bwd_dkv, q3, k3, causal)
    return _unpad(dk, D), _unpad(dv, D)


flash_attention_bwd_dq.launches = 0
flash_attention_bwd_dkv.launches = 0
flash_attention_bwd_dq.flop_kind = "dq"
flash_attention_bwd_dkv.flop_kind = "dkv"
flash_attention_bwd_dq.launches_by_dtype = {}
flash_attention_bwd_dkv.launches_by_dtype = {}
flash_attention_bwd_dq.launches_by_shape = {}
flash_attention_bwd_dkv.launches_by_shape = {}
flash_attention_bwd_dq.launches_by_mask = {}
flash_attention_bwd_dkv.launches_by_mask = {}
for _wrapper in (flash_attention_fwd, flash_attention_bwd_dq, flash_attention_bwd_dkv):
    for _attr in ("launches", "launches_by_dtype", "launches_by_shape", "launches_by_mask"):
        engine.register_counter(_wrapper, _attr)
del _wrapper, _attr


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
    passes, on any device; ``double_backward_calls`` counts the backwards of
    those passes (``_FlashAttentionGrads``)."""

    backward_calls = 0
    double_backward_calls = 0

    @staticmethod
    def forward(ctx, q3, k3, v3, causal, scale):
        o, lse = flash_attention_fwd(q3, k3, v3, causal, scale)
        ctx.save_for_backward(q3, k3, v3, o, lse)
        ctx.causal, ctx.scale = causal, scale
        return o

    @staticmethod
    def backward(ctx, do):
        FlashAttentionFunction.backward_calls += 1
        q3, k3, v3, o, lse = ctx.saved_tensors
        if not torch.is_grad_enabled():
            dq, dk, dv = flash_attention_bwd(q3, k3, v3, o, lse, _aligned(do),
                                             ctx.causal, ctx.scale)
        else:                     # create_graph: the gradients join the graph
            dq, dk, dv = _FlashAttentionGrads.apply(q3, k3, v3, o, lse, do,
                                                    ctx.causal, ctx.scale)
        return dq, dk, dv, None, None


def attention_grads_plain(q, k, v, do, causal: bool, scale: float):
    """(dq, dk, dv) of attention on (BH, T, D) tensors in differentiable
    torch ops, the scores in full: P = softmax(q k^T scale) (masked where
    the key follows the query under ``causal``), O = P v, dv = P^T dO,
    dS = P * (dO v^T - rowsum(dO * O)), dq = dS k scale, dk = dS^T q scale."""
    s = torch.matmul(q, k.transpose(-1, -2)) * scale
    if causal:
        T, Tk = q.shape[-2], k.shape[-2]
        keep = torch.arange(T, device=q.device)[:, None] >= torch.arange(Tk, device=q.device)
        s = torch.where(keep, s, torch.full_like(s, -1e30))
    p = torch.softmax(s, dim=-1)
    o = torch.matmul(p, v)
    delta = (do * o).sum(dim=-1, keepdim=True)
    ds = p * (torch.matmul(do, v.transpose(-1, -2)) - delta)
    return (torch.matmul(ds, k) * scale, torch.matmul(ds.transpose(-1, -2), q) * scale,
            torch.matmul(p.transpose(-1, -2), do))


class _FlashAttentionGrads(torch.autograd.Function):
    """The first-order gradients under ``create_graph``: the forward is the
    backward kernels K2/K3 (``flash_attention_bwd``), as in the first-order
    path; the backward (the double backward) is plain torch ops, the
    derivative of ``attention_grads_plain`` at Q, K, V and dO, in float32
    (float64 for float64 inputs). The reference has no kernel for it: JAX
    differentiates its kernels' bodies, the Pallas calls included, so its
    double backward is whatever XLA makes of that derivative. P is
    recomputed from Q and K rather than read from the saved LSE, whose own
    derivative the second order needs. A third order raises the reference's
    ``MXNetError``."""

    @staticmethod
    def forward(ctx, q3, k3, v3, o, lse, do, causal, scale):
        ctx.save_for_backward(q3, k3, v3, do)
        ctx.causal, ctx.scale = causal, scale
        return flash_attention_bwd(q3, k3, v3, o, lse, _aligned(do), causal, scale)

    @staticmethod
    def backward(ctx, gdq, gdk, gdv):
        if torch.is_grad_enabled():           # a third order
            from ...autograd import _NO_SECOND_ORDER
            raise MXNetError(_NO_SECOND_ORDER)
        FlashAttentionFunction.double_backward_calls += 1
        q3, k3, v3, do = ctx.saved_tensors
        f = torch.float64 if q3.dtype == torch.float64 else torch.float32
        scale = ctx.scale if ctx.scale is not None else 1.0 / math.sqrt(q3.shape[-1])
        with torch.enable_grad():
            leaves = [t.detach().to(f).requires_grad_() for t in (q3, k3, v3, do)]
            grads = attention_grads_plain(*leaves, ctx.causal, scale)
            cots = [torch.zeros_like(g) if c is None else c.to(f) for g, c in
                    zip(grads, (gdq, gdk, gdv))]
            gq, gk, gv, gdo = torch.autograd.grad(grads, leaves, cots, allow_unused=True)
        out = [None if g is None else g.to(t.dtype) for g, t in
               zip((gq, gk, gv, gdo), (q3, k3, v3, do))]
        return out[0], out[1], out[2], None, None, out[3], None, None


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
