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
backward reduce-scatters over the axis.

``ring_attention`` (reference :95) and ``ulysses_attention`` (:139) serve
``recipes/long_context.py``. Each rank of the axis holds the contiguous
sequence chunk ``[s T/n, (s+1) T/n)`` of q, k and v, (B, H, T/n, D).

- Ring: one ``torch.autograd.Function``. The K/V shards rotate to the next
  rank of the axis (``_dist_util.ring_shift``: ``batch_isend_irecv``, the
  reference's ``ppermute``), n - 1 hops. At hop s a rank holds the chunk of
  rank (idx - s) mod n: the diagonal hop (s = 0) is K1 with ``causal`` (local
  q and k share one offset), a hop from an earlier rank K1 without it, and
  under ``causal`` a hop from a later rank is wholly masked and skipped (in
  the reference it adds exactly zero: its finite -1e30 mask meets the
  diagonal hop's finite max). The hops' (O, LSE) merge in f32: the LSE by
  logaddexp, O by the weights exp(LSE_hop - LSE). The backward takes delta =
  rowsum(dO * O) once from the merged O, rotates K/V again, and accumulates
  dQ hop by hop (K2) and dK/dV (K3) into f32 accumulators that travel with
  their K/V and take one last hop home to their owner. The reference's
  ``lax.scan`` of ``_block_attn`` is the same function on the same layout.
- Ulysses: ``all_to_all`` from sequence to heads (each rank then holds H/n
  heads of the whole sequence), ``flash_attention_op`` (K1-K3) with
  ``causal`` over the whole sequence, and back; each exchange is a
  ``torch.autograd.Function`` whose backward is the opposite exchange. The
  reference calls ``blockwise_attention`` here, which in the port is K1's
  plain version.

Every hop runs the kernels' wrappers: the kernels for CUDA tensors (a head
dim they do not take raises), the plain versions
(``blockwise_attention_lse``, ``blockwise_attention_bwd``) for CPU tensors.
On a mesh of one device, or an axis of size 1, the ring is its diagonal hop.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from ..base import MXNetError
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


# -- sequence parallelism over a mesh axis ------------------------------------------

def _axis(axis: str, mesh):
    """(n, this rank's index, group or None) of ``axis`` of ``mesh`` (default:
    the active mesh); (1, 0, None) on a mesh of one device."""
    from ..parallel.mesh import active_mesh
    mesh = mesh if mesh is not None else active_mesh()
    if mesh is None:
        raise MXNetError(f"no mesh given and none active for the {axis!r} axis")
    n = mesh.axis_size(axis)
    if not mesh.distributed or n == 1:
        return 1, 0, None
    return n, mesh.axis_index(axis), mesh.group(axis)


def _hop_bwd(q3, k3, v3, o, lse, delta, do3, causal, scale):
    """(dq, dk, dv) of one hop given the merged O and LSE: K2 and K3 for CUDA
    tensors, their plain version for CPU tensors."""
    from .cuda import flash_attention as fa
    if q3.device.type == "cpu":
        return fa.flash_attention_bwd_plain(q3, k3, v3, o, lse, do3, causal, scale)
    dq = fa.flash_attention_bwd_dq(q3, k3, v3, do3, lse, delta, causal, scale)
    dk, dv = fa.flash_attention_bwd_dkv(q3, k3, v3, do3, lse, delta, causal, scale)
    return dq, dk, dv


def _hops(n, idx, causal):
    """(hop, whether it runs, whether it is the causal diagonal) of a ring of
    ``n`` seen from rank ``idx``."""
    for s in range(n):
        kv_rank = (idx - s) % n
        yield s, not (causal and kv_rank > idx), causal and kv_rank == idx


class _RingAttention(torch.autograd.Function):
    """Ring attention on this rank's (BH, T/n, D) chunks; see the module
    docstring."""

    @staticmethod
    def forward(ctx, q3, k3, v3, n, idx, group, causal, scale):
        from .. import _dist_util
        from .cuda.flash_attention import flash_attention_fwd
        f = _acc_dtype(q3)
        o = lse = None
        kb, vb = k3, v3
        for s, runs, diag in _hops(n, idx, causal):
            if runs:
                o_h, lse_h = flash_attention_fwd(q3, kb, vb, diag, scale)
                if o is None:
                    o, lse = o_h.to(f), lse_h.to(f)
                else:
                    new = torch.logaddexp(lse, lse_h.to(f))
                    o = o * torch.exp(lse - new)[..., None] \
                        + o_h.to(f) * torch.exp(lse_h.to(f) - new)[..., None]
                    lse = new
            if s < n - 1:
                kb, vb = _dist_util.ring_shift([kb, vb], group)
        o = o.to(q3.dtype)
        lse = lse.contiguous()
        ctx.save_for_backward(q3, k3, v3, o, lse)
        ctx.ring = (n, idx, group, causal, scale)
        return o

    @staticmethod
    def backward(ctx, do):
        from .. import _dist_util
        from ..autograd import _NO_SECOND_ORDER
        from .cuda.flash_attention import _aligned
        if torch.is_grad_enabled():      # create_graph: the ring has no double backward
            raise MXNetError(_NO_SECOND_ORDER)
        q3, k3, v3, o, lse = ctx.saved_tensors
        n, idx, group, causal, scale = ctx.ring
        do3 = _aligned(do)
        f = _acc_dtype(q3)
        delta = (do3.to(f) * o.to(f)).sum(dim=-1)
        dq = torch.zeros(q3.shape, dtype=f, device=q3.device)
        kb, vb = k3, v3
        dkb = torch.zeros(k3.shape, dtype=f, device=k3.device)
        dvb = torch.zeros(v3.shape, dtype=f, device=v3.device)
        for s, runs, diag in _hops(n, idx, causal):
            if runs:
                dq_h, dk_h, dv_h = _hop_bwd(q3, kb, vb, o, lse, delta, do3, diag, scale)
                dq += dq_h
                dkb += dk_h
                dvb += dv_h
            if s < n - 1:
                kb, vb, dkb, dvb = _dist_util.ring_shift([kb, vb, dkb, dvb], group)
        if n > 1:            # the accumulators of rank idx+1's chunk go home
            dkb, dvb = _dist_util.ring_shift([dkb, dvb], group)
        return (dq.to(q3.dtype), dkb.to(k3.dtype), dvb.to(v3.dtype),
                None, None, None, None, None)


def ring_attention(q, k, v, axis_name: str, causal: bool = False,
                   scale: Optional[float] = None, mesh=None):
    """Ring attention over mesh axis ``axis_name`` (default mesh: the active
    one) on this rank's sequence chunks (B, H, T/n, D) -> (B, H, T/n, D);
    differentiable."""
    from .cuda.flash_attention import _aligned
    B, H, T, D = q.shape
    scale = float(scale) if scale is not None else 1.0 / (D ** 0.5)
    n, idx, group = _axis(axis_name, mesh)
    o = _RingAttention.apply(*(_aligned(t.reshape(B * H, T, D)) for t in (q, k, v)),
                             n, idx, group, bool(causal), scale)
    return o.reshape(B, H, T, D)


class _AllToAll(torch.autograd.Function):
    """Split dim ``split`` into n chunks, chunk j to rank j of ``group``, and
    concatenate what arrives along dim ``concat`` in rank order; the
    backward is the opposite exchange."""

    @staticmethod
    def forward(ctx, x, group, n, split, concat):
        ctx.a2a = (group, n, split, concat)
        return _all_to_all(x, group, n, split, concat)

    @staticmethod
    def backward(ctx, g):
        group, n, split, concat = ctx.a2a
        # the opposite exchange through the Function, so that a second
        # derivative (create_graph) records it
        return _AllToAll.apply(g, group, n, concat, split), None, None, None, None


def _all_to_all(x, group, n, split, concat):
    send = torch.stack(x.chunk(n, dim=split)).contiguous()
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)
    return torch.cat(recv.unbind(0), dim=concat)


def ulysses_attention(q, k, v, axis_name: str, causal: bool = False, mesh=None):
    """Ulysses sequence parallelism over ``axis_name`` on this rank's
    sequence chunks (B, H, T/n, D): all-to-all to (B, H/n, T, D), flash
    attention over the whole sequence, all-to-all back; differentiable."""
    n, _, group = _axis(axis_name, mesh)
    if n == 1:
        return flash_attention_op(q, k, v, causal=causal)
    if q.shape[1] % n:
        raise MXNetError(f"ulysses_attention: {q.shape[1]} heads do not split over {n} ranks")
    qh, kh, vh = (_AllToAll.apply(t, group, n, 1, 2) for t in (q, k, v))
    out = flash_attention_op(qh, kh, vh, causal=causal)
    return _AllToAll.apply(out, group, n, 2, 1)
