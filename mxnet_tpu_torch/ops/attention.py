"""Blockwise attention, the plain version of the flash-attention kernel.

Counterpart of ``mxnet_tpu/ops/attention.py:26-92``: ``blockwise_attention``
(:43), a loop over key blocks with an online log-sum-exp, f32 throughout and
masking by the finite ``_NEG = -1e30``, and the registered op
``_contrib_flash_attention`` (:85). ``blockwise_attention_lse`` is the same
loop returning the LSE too; it is the plain PyTorch version of the CUDA
forward kernel (``ops/cuda/flash_attention.py``), on the CPU its only path
and on the card what ``chip_smoke.py`` holds the kernel against.
``blockwise_attention_bwd`` is the plain version of the two backward
kernels (``_bwd_dq_kernel``/``_bwd_dkv_kernel``, reference
``ops/pallas/flash_attention.py:181-355``) in the same roles.

``sequence_parallel_attention`` is the flash op on a sequence shard, what
GSPMD computes for the reference's step under ``data_spec=P("dp", "sp")``:
each rank keeps its T/sp query rows and gathers K and V over the sequence
axis, so K1 runs with Tq = T/sp against Tk = T; in the backward K2 gives the
local dQ and K3 dK/dV for all Tk keys from the local rows, which the gather's
backward reduce-scatters over the axis. The reference's ring and Ulysses
variants (:95-149), which serve ``recipes/long_context.py``, wait for that
slice.
"""
from __future__ import annotations

from typing import Optional

import torch

from .registry import register

_NEG = -1e30  # finite mask: -inf makes exp(-inf - -inf) = nan on fully
              # masked (q-row, k-block) pairs under causal blocking


def _acc_dtype(q):
    """f32 accumulation, as the kernels; f64 inputs stay f64 (gradcheck)."""
    return torch.float64 if q.dtype == torch.float64 else torch.float32


def blockwise_attention_lse(q, k, v, block_size: int = 512,
                            causal: bool = False,
                            scale: Optional[float] = None,
                            round_p: bool = False):
    """Attention over (..., T, D) by key blocks -> (O in q's dtype, LSE f32).
    Accumulates in f32 (f64, with an f64 LSE, for f64 inputs).

    ``round_p`` rounds the probabilities to V's dtype before the PV
    product, as the Pallas kernel does (``flash_attention.py:124-126``); the
    reference's ``blockwise_attention`` keeps them in f32. For f32 inputs the
    two are the same.
    """
    T, D = q.shape[-2], q.shape[-1]
    Tk = k.shape[-2]
    scale = scale if scale is not None else 1.0 / (D ** 0.5)
    block_size = max(1, min(block_size, Tk))
    f = _acc_dtype(q)
    qf = q.to(f)
    q_pos = torch.arange(T, device=q.device)[:, None]
    lead = q.shape[:-2]
    acc = torch.zeros(lead + (T, v.shape[-1]), dtype=f, device=q.device)
    l = torch.zeros(lead + (T, 1), dtype=f, device=q.device)
    m = torch.full(lead + (T, 1), _NEG, dtype=f, device=q.device)
    for start in range(0, Tk, block_size):
        kb = k[..., start:start + block_size, :]
        vb = v[..., start:start + block_size, :]
        s = torch.matmul(qf, kb.to(f).transpose(-1, -2)) * scale
        k_pos = start + torch.arange(kb.shape[-2], device=q.device)[None, :]
        if causal:
            s = torch.where(q_pos >= k_pos, s, _NEG)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        if round_p:
            p = p.to(v.dtype).to(f)
        acc = acc * alpha + torch.matmul(p, vb.to(f))
        m = m_new
    l = torch.clamp_min(l, 1e-30)
    return (acc / l).to(q.dtype), (m + torch.log(l))[..., 0]


def blockwise_attention_bwd(q, k, v, o, lse, do, causal: bool = False,
                            scale: Optional[float] = None,
                            block_size: int = 256):
    """Gradients of attention over (..., T, D) from the forward's O and LSE
    -> (dq, dk, dv) in the inputs' dtypes, by key blocks.

    The arithmetic of the backward kernels: delta = rowsum(dO * O) in f32;
    for each key block, P = exp(S - LSE) with S = q k^T * scale masked to
    -1e30, dP = dO v^T, dS = P * (dP - delta); dq += (dS in k's dtype) k *
    scale, dv = (P in dO's dtype)^T dO, dk = (dS in q's dtype)^T q * scale.
    Products accumulate in f32 (f64 for f64 inputs), and the casts round
    where the kernels round.
    """
    T, D = q.shape[-2], q.shape[-1]
    Tk = k.shape[-2]
    scale = scale if scale is not None else 1.0 / (D ** 0.5)
    block_size = max(1, min(block_size, Tk))
    f = _acc_dtype(q)
    qf, dof = q.to(f), do.to(f)
    delta = (dof * o.to(f)).sum(dim=-1, keepdim=True)
    lse = lse.to(f)[..., None]
    q_pos = torch.arange(T, device=q.device)[:, None]
    dq = torch.zeros(qf.shape, dtype=f, device=q.device)
    dks, dvs = [], []
    for start in range(0, Tk, block_size):
        kb = k[..., start:start + block_size, :].to(f)
        vb = v[..., start:start + block_size, :].to(f)
        s = torch.matmul(qf, kb.transpose(-1, -2)) * scale
        if causal:
            k_pos = start + torch.arange(kb.shape[-2], device=q.device)[None, :]
            s = torch.where(q_pos >= k_pos, s, _NEG)
        p = torch.exp(s - lse)
        dp = torch.matmul(dof, vb.transpose(-1, -2))
        ds = p * (dp - delta)
        dq = dq + torch.matmul(ds.to(k.dtype).to(f), kb) * scale
        dvs.append(torch.matmul(p.to(do.dtype).to(f).transpose(-1, -2), dof))
        dks.append(torch.matmul(ds.to(q.dtype).to(f).transpose(-1, -2), qf)
                   * scale)
    return (dq.to(q.dtype), torch.cat(dks, dim=-2).to(k.dtype),
            torch.cat(dvs, dim=-2).to(v.dtype))


def blockwise_attention(q, k, v, block_size: int = 512, causal: bool = False,
                        scale: Optional[float] = None):
    """Flash-style attention on (B, H, T, D) by key blocks, f32 inside."""
    return blockwise_attention_lse(q, k, v, block_size, causal, scale)[0]


@register("_contrib_flash_attention")
def flash_attention_op(q, k, v, *, causal=False, block_size=512):
    """Registered op form (reference ``attention.py:85-92``): the CUDA kernel
    for CUDA tensors, its plain version for CPU tensors."""
    from .cuda.flash_attention import flash_attention
    return flash_attention(q, k, v, causal=causal,
                           block_q=min(block_size, 256),
                           block_k=min(block_size, 256))


def sequence_parallel_attention(q, k, v, axis: str = "sp", mesh=None):
    """Non-causal flash attention of this rank's query rows (B, H, T/n, D)
    against the keys and values of the whole sequence, gathered over
    ``axis`` (``parallel.megatron.gather_from_sp``) -> (B, H, T/n, D)."""
    from ..parallel.megatron import gather_from_sp
    return flash_attention_op(q, gather_from_sp(k, axis, 2, mesh),
                              gather_from_sp(v, axis, 2, mesh))
