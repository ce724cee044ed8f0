"""Mixture-of-Experts with expert parallelism.

Counterpart of ``mxnet_tpu/parallel/moe.py``:

- ``topk_gating`` (:30), ``load_balance_loss`` (:77), ``dropped_tokens``
  (:97), ``moe_capacity`` (:160), ``all_to_all_wire_bytes`` (:166) and
  ``load_balancing_loss`` (:283), with the reference's determinism contract:
  expert ties break toward the lower expert index (``argmax`` for k = 1,
  which returns the first maximum, and a stable descending sort for k > 1,
  on every device), capacity slots are claimed in token order, and all
  first choices claim their slots before any second choice.
- ``wire_all_to_all`` (:138): ``all_to_all_single`` over the process group
  of one mesh axis, split and concatenated along dim 0, optionally
  compressed on the wire (``None``, ``"bfloat16"``, ``"int8"`` with one f32
  scale per outbound row); a ``torch.autograd.Function`` whose backward runs
  the same compressed exchange on the gradient (the exchange is a block
  permutation, its own transpose). On a group of one rank it keeps the
  wire's rounding and skips the collective.
- ``moe_ffn`` (:201) and ``expert_parallel_moe`` (:230); their aux dict
  also holds each (token, choice)'s expert, -1 where dropped
  (``assignment``), so that two runs' routing can be compared. The reference
  dispatches and combines with one-hot einsums over (N, E, C), 2·N·E·C·D
  multiply-adds each. A slot holds at most one token, so the port computes
  the same numbers by indexing: the dispatch gathers each slot's token row
  (an empty slot reads a zero row), and the combine gathers each token's
  k-th slot back, weights it by its gate and sums over the k choices, both
  by ``index_select``, whose backward adds into a row once per choice that
  reads it (atomics onto zero: at top_k <= 2 the card gives the same bits
  every run; the sentinel rows of empty slots and dropped choices are
  discarded). With top-1 routing
  the result equals the einsum form bit for bit (``_einsum_ffn`` keeps that
  form for the tests). The expert FFNs are batched products (``torch.bmm``).
- The context stacks (:304-365): ``expert_axis`` / ``current_expert_axis``
  (which mesh axis the MoE cells dispatch over) and ``collect_metrics`` /
  ``report_metrics`` / ``MoEMetrics`` (where each cell's aux loss and
  dropped count go). The cells read the active mesh
  (``parallel.activate``).
"""
from __future__ import annotations

import contextlib
from typing import List, Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..base import MXNetError, torch_dtype
from .megatron import _resolve
from .mesh import Mesh

__all__ = ["topk_gating", "load_balance_loss", "dropped_tokens", "wire_all_to_all",
           "moe_capacity", "all_to_all_wire_bytes", "moe_ffn", "expert_parallel_moe",
           "load_balancing_loss", "expert_axis", "current_expert_axis", "collect_metrics",
           "report_metrics", "MoEMetrics"]


# -- gating ------------------------------------------------------------------------

def _topk_indices(probs: torch.Tensor, top_k: int) -> torch.Tensor:
    """(N, K) expert indices by descending probability, ties to the lower
    index (``lax.top_k``'s order)."""
    if top_k == 1:
        return torch.argmax(probs, dim=-1, keepdim=True)
    return torch.sort(probs, dim=-1, descending=True, stable=True).indices[:, :top_k]


class _Route:
    """One gating call: ``probs`` (N, E); per (token, choice) the expert
    ``idx`` (N, K), the slot ``pos`` within it (N, K) and whether it ``fits``
    under the capacity; ``gate`` (N, K) the chosen probabilities."""

    __slots__ = ("probs", "idx", "pos", "fits", "gate", "capacity")

    def __init__(self, logits: torch.Tensor, top_k: int, capacity: int):
        E = logits.shape[1]
        self.probs = torch.softmax(logits, dim=-1)
        self.idx = _topk_indices(self.probs, top_k)
        counts = torch.zeros((E, 1), dtype=torch.int64, device=logits.device)
        pos = []
        for k in range(top_k):
            # (E, N): the scan runs along the contiguous token dim (on the card
            # a scan over the outer dim of (N, E) took 1.4 ms at N = 8192)
            onehot = F.one_hot(self.idx[:, k], E).t().contiguous()
            prior = torch.cumsum(onehot, dim=1) - onehot          # earlier tokens' count
            pos.append((onehot * (prior + counts)).sum(dim=0))
            counts = counts + onehot.sum(dim=1, keepdim=True)
        self.pos = torch.stack(pos, dim=1)
        self.fits = self.pos < capacity
        self.gate = torch.gather(self.probs, 1, self.idx)
        self.capacity = capacity

    def weights(self, normalize: bool) -> torch.Tensor:
        """(N, K) combine weights: the gate of each kept choice, divided by
        their sum with ``normalize``; 0 for a dropped one."""
        w = self.gate * self.fits.to(self.gate.dtype)
        if normalize:
            w = w / torch.clamp_min(w.sum(dim=1, keepdim=True), 1e-9)
        return w

    def slots(self) -> torch.Tensor:
        """(N, K) flat slot ``e * C + pos`` of each choice; E*C (a zero row)
        for a dropped one."""
        E = self.probs.shape[1]
        flat = self.idx * self.capacity + self.pos
        return torch.where(self.fits, flat, torch.full_like(flat, E * self.capacity))

    def assigned(self) -> torch.Tensor:
        """(E,) f32 count of kept assignments per expert."""
        E = self.probs.shape[1]
        onehot = F.one_hot(self.idx, E) * self.fits[..., None]
        return onehot.sum(dim=(0, 1)).to(self.probs.dtype)

    def dropped(self) -> torch.Tensor:
        return self.fits.numel() - self.fits.sum()


def topk_gating(logits: torch.Tensor, top_k: int, capacity: int):
    """Top-k capacity gating (Switch/GShard). logits (N, E); returns dense
    (dispatch (N, E, C) 0/1, combine (N, E, C)), the reference's tensors.
    Token n's k-th choice lands in expert e's slot c if fewer than C
    earlier assignments chose e; an overflowing one is dropped (all-zero
    rows). The MoE layers below use the routing without these tensors."""
    N, E = logits.shape
    r = _Route(logits, top_k, capacity)
    dispatch = logits.new_zeros((N, E, capacity))
    combine = logits.new_zeros((N, E, capacity))
    for k in range(top_k):
        fits = r.fits[:, k]
        slot = F.one_hot(torch.where(fits, r.pos[:, k], torch.full_like(r.pos[:, k],
                                                                        capacity)),
                         capacity + 1)[:, :capacity].to(logits.dtype)
        d_k = F.one_hot(r.idx[:, k], E).to(logits.dtype)[:, :, None] * slot[:, None, :]
        d_k = d_k * fits[:, None, None].to(logits.dtype)
        dispatch = dispatch + d_k
        combine = combine + d_k * r.gate[:, k, None, None]
    return dispatch, combine


def load_balance_loss(probs: torch.Tensor, dispatch: torch.Tensor) -> torch.Tensor:
    """Switch's auxiliary load-balancing loss ``E * sum_e f_e * P_e``: f the
    realized (post-capacity) share of assignments per expert (no gradient),
    P the mean router probability; 1 at uniform routing."""
    return _balance(probs, dispatch.sum(dim=2).sum(dim=0))


def _balance(probs: torch.Tensor, assigned: torch.Tensor) -> torch.Tensor:
    E = probs.shape[1]
    f = (assigned / torch.clamp_min(assigned.sum(), 1.0)).detach()
    return E * torch.sum(f * probs.mean(dim=0))


def dropped_tokens(dispatch: torch.Tensor, n_tokens: int, top_k: int) -> torch.Tensor:
    """(token, choice) assignments that found no free slot: an int32 scalar."""
    made = dispatch.float().sum()
    return (n_tokens * top_k - made).to(torch.int32)


def moe_capacity(n_tokens_local: int, top_k: int, capacity_factor: float,
                 n_experts: int) -> int:
    """The per-expert slot count every gating call in this module uses."""
    return max(1, int(capacity_factor * n_tokens_local * top_k / n_experts))


def all_to_all_wire_bytes(n_tokens_local: int, d_model: int, *, n_experts: int, top_k: int,
                          capacity_factor: float, ep: int, comm_dtype: Optional[str] = None,
                          dtype="float32") -> int:
    """Per-device wire bytes of ONE dispatch or combine exchange: (ep-1)/ep
    of the E*C*D payload (bf16: 2 bytes an element, int8: 1 plus one f32
    scale per outbound row). Times 4 * n_layers for a training step."""
    if ep <= 1:
        return 0
    cap = moe_capacity(n_tokens_local, top_k, capacity_factor, n_experts)
    elems = n_experts * cap * d_model
    if comm_dtype == "bfloat16":
        item, extra = 2, 0
    elif comm_dtype == "int8":
        item, extra = 1, ep * 4
    else:
        item, extra = torch_dtype(dtype).itemsize, 0
    return elems * item * (ep - 1) // ep + extra


def load_balancing_loss(logits: torch.Tensor, top_k: int = 2) -> torch.Tensor:
    """Switch's eq. 4 from raw logits, before capacity (for callers that
    gate elsewhere; the post-capacity form is ``load_balance_loss``)."""
    E = logits.shape[1]
    probs = torch.softmax(logits, dim=-1)
    idx = _topk_indices(probs, top_k)
    ce = F.one_hot(idx[:, 0], E).to(probs.dtype).mean(dim=0)
    return E * torch.sum(probs.mean(dim=0) * ce)


# -- the wire ------------------------------------------------------------------------

def _a2a(t: torch.Tensor, group, n: int) -> torch.Tensor:
    if n == 1:
        return t
    t = t.contiguous()
    out = torch.empty_like(t)
    dist.all_to_all_single(out, t, group=group)
    return out


def _wire_exchange(x: torch.Tensor, group, n: int, comm_dtype: Optional[str]) -> torch.Tensor:
    if comm_dtype is None:
        return _a2a(x, group, n)
    if comm_dtype == "bfloat16":
        return _a2a(x.to(torch.bfloat16), group, n).to(x.dtype)
    if comm_dtype == "int8":
        flat = x.reshape(n, -1)
        scale = torch.clamp_min(flat.abs().amax(dim=1, keepdim=True) / 127.0, 1e-12)
        q = torch.clamp(torch.round(flat / scale), -127, 127).to(torch.int8)
        q, scale = _a2a(q, group, n), _a2a(scale, group, n)
        return (q.to(x.dtype) * scale).reshape(x.shape)
    raise MXNetError(f"unsupported comm_dtype {comm_dtype!r}")


class _WireAllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, n, comm_dtype):
        ctx.wire = (group, n, comm_dtype)
        return _wire_exchange(x, group, n, comm_dtype)

    @staticmethod
    def backward(ctx, g):
        # the exchange is its own transpose: through the Function, so that a
        # second derivative (create_graph) records it and exchanges again
        return _WireAllToAll.apply(g, *ctx.wire), None, None, None


def wire_all_to_all(x: torch.Tensor, axis_name: str, comm_dtype: Optional[str] = None,
                    mesh: Optional[Mesh] = None) -> torch.Tensor:
    """Block ``i`` of dim 0 of ``x`` (dim 0 = the axis size) goes to rank
    ``i`` of ``axis_name``; block ``j`` of the result came from rank ``j``.
    ``comm_dtype`` compresses both directions of the exchange alike, so the
    wire volume is ``all_to_all_wire_bytes`` each way."""
    mesh = _resolve(mesh, axis_name)
    n = mesh.axis_size(axis_name)
    if x.shape[0] != n:
        raise MXNetError(f"wire_all_to_all: dim 0 of {tuple(x.shape)} must be the size "
                         f"{n} of {axis_name!r}")
    return _WireAllToAll.apply(x, mesh.group(axis_name), n, comm_dtype)


# -- the layers ------------------------------------------------------------------------

def _dispatch(x: torch.Tensor, r: _Route, E: int) -> torch.Tensor:
    """(E, C, D): each slot's token row (the einsum "nd,nec->ecd")."""
    N, D = x.shape
    C = r.capacity
    src = torch.full((E * C + 1,), N, dtype=torch.int64, device=x.device)
    tokens = torch.arange(N, device=x.device)[:, None].expand_as(r.idx)
    src[r.slots().reshape(-1)] = tokens.reshape(-1)
    padded = torch.cat([x, x.new_zeros((1, D))])
    return torch.index_select(padded, 0, src[:-1]).view(E, C, D)


def _combine(out: torch.Tensor, r: _Route, normalize: bool) -> torch.Tensor:
    """(N, D): each token's kept slots weighted by their gates and summed
    (the einsum "ecd,nec->nd")."""
    E, C, D = out.shape
    flat = torch.cat([out.reshape(E * C, D), out.new_zeros((1, D))])
    slots, w = r.slots(), r.weights(normalize).to(out.dtype)
    y = torch.index_select(flat, 0, slots[:, 0]) * w[:, :1]
    for k in range(1, slots.shape[1]):
        y = y + torch.index_select(flat, 0, slots[:, k]) * w[:, k:k + 1]
    return y


def _aux(r: _Route):
    """The reference's aux dict, plus each (token, choice)'s expert, or -1
    where it was dropped (``assignment``, for comparing two runs' routing)."""
    return {"aux_loss": _balance(r.probs, r.assigned()), "dropped": r.dropped(),
            "assignment": torch.where(r.fits, r.idx, torch.full_like(r.idx, -1))}


def moe_ffn(x, gate_w, w1, w2, *, top_k: int = 2, capacity_factor: float = 1.5,
            activation=torch.relu, normalize_gates: bool = True, return_aux: bool = False):
    """Single-shard MoE FFN: x (N, D), gate_w (D, E), w1 (E, D, H), w2 (E,
    H, D) -> (N, D), or ``(y, {"aux_loss", "dropped", "assignment"})``
    with ``return_aux``."""
    N, D = x.shape
    E = gate_w.shape[1]
    r = _Route(x @ gate_w, top_k, moe_capacity(N, top_k, capacity_factor, E))
    h = activation(torch.bmm(_dispatch(x, r, E), w1))
    y = _combine(torch.bmm(h, w2), r, normalize_gates)
    return (y, _aux(r)) if return_aux else y


def expert_parallel_moe(x, gate_w, w1_local, w2_local, *, axis_name: str, top_k: int = 2,
                        capacity_factor: float = 1.5, activation=torch.relu,
                        normalize_gates: bool = True, comm_dtype: Optional[str] = None,
                        return_aux: bool = False, mesh: Optional[Mesh] = None):
    """Expert-parallel MoE FFN over ``axis_name`` of ``mesh`` (default: the
    active one): x is this rank's (Nl, D) token shard, w1_local/w2_local its
    E/ep experts. Gate locally over all E experts, send each rank the slots
    of its experts (``wire_all_to_all``), run the local experts on the
    (El, ep*C, D) slots, send them back, combine locally. With one rank on
    the axis it equals ``moe_ffn`` bitwise."""
    mesh = _resolve(mesh, axis_name)
    n_dev = mesh.axis_size(axis_name)
    Nl, D = x.shape
    El = w1_local.shape[0]
    E = El * n_dev
    if gate_w.shape[1] != E:
        raise MXNetError(f"expert_parallel_moe: gate over {gate_w.shape[1]} experts, "
                         f"{El} local experts x {n_dev} ranks of {axis_name!r}")
    C = moe_capacity(Nl, top_k, capacity_factor, E)
    r = _Route(x @ gate_w, top_k, C)
    # regroup the slots by owner rank and exchange: dim 0 becomes the source rank
    expert_in = wire_all_to_all(_dispatch(x, r, E).reshape(n_dev, El, C, D), axis_name,
                                comm_dtype, mesh)
    gathered = expert_in.transpose(0, 1).reshape(El, n_dev * C, D)
    out = torch.bmm(activation(torch.bmm(gathered, w1_local)), w2_local)
    out = out.reshape(El, n_dev, C, D).transpose(0, 1)
    out = wire_all_to_all(out, axis_name, comm_dtype, mesh).reshape(E, C, D)
    y = _combine(out, r, normalize_gates)
    return (y, _aux(r)) if return_aux else y


def _einsum_ffn(x, gate_w, w1, w2, *, top_k=2, capacity_factor=1.5, activation=torch.relu,
                normalize_gates=True):
    """``moe_ffn`` in the reference's one-hot einsum form (for the tests)."""
    N, _ = x.shape
    E = gate_w.shape[1]
    dispatch, combine = topk_gating(x @ gate_w, top_k,
                                    moe_capacity(N, top_k, capacity_factor, E))
    if normalize_gates:
        combine = combine / torch.clamp_min(combine.sum(dim=(1, 2), keepdim=True), 1e-9)
    expert_in = torch.einsum("nd,nec->ecd", x, dispatch)
    h = activation(torch.einsum("ecd,edh->ech", expert_in, w1))
    return torch.einsum("ecd,nec->nd", torch.einsum("ech,ehd->ecd", h, w2), combine)


# -- which axis the MoE cells dispatch over, where they report -------------------------

class _ExpertCtx:
    __slots__ = ("axis_name", "comm_dtype")

    def __init__(self, axis_name, comm_dtype):
        self.axis_name = axis_name
        self.comm_dtype = comm_dtype


_EXPERT_STACK: List[_ExpertCtx] = []
_COLLECT_STACK: List["MoEMetrics"] = []


class MoEMetrics:
    """The aux losses, dropped counts and assignments of the MoE cells run
    inside one ``collect_metrics`` block (tensors on the device)."""

    def __init__(self):
        self.aux_losses = []
        self.dropped = []
        self.assignments = []

    def add(self, aux):
        self.aux_losses.append(aux["aux_loss"])
        self.dropped.append(aux["dropped"])
        if "assignment" in aux:
            self.assignments.append(aux["assignment"])

    def aux_loss(self) -> torch.Tensor:
        return sum(self.aux_losses) if self.aux_losses else torch.zeros((), dtype=torch.float32)

    def dropped_total(self) -> torch.Tensor:
        return sum(self.dropped) if self.dropped else torch.zeros((), dtype=torch.int64)


@contextlib.contextmanager
def expert_axis(axis_name: str, comm_dtype: Optional[str] = None):
    """Inside it, the MoE cells dispatch with ``expert_parallel_moe`` over
    ``axis_name`` of the active mesh (their expert parameters are this
    rank's shards) instead of the single-shard ``moe_ffn``."""
    _EXPERT_STACK.append(_ExpertCtx(axis_name, comm_dtype))
    try:
        yield
    finally:
        _EXPERT_STACK.pop()


def current_expert_axis() -> Optional[_ExpertCtx]:
    return _EXPERT_STACK[-1] if _EXPERT_STACK else None


@contextlib.contextmanager
def collect_metrics():
    """Collect every MoE cell's (aux_loss, dropped) run inside the block;
    yields the ``MoEMetrics``."""
    mc = MoEMetrics()
    _COLLECT_STACK.append(mc)
    try:
        yield mc
    finally:
        _COLLECT_STACK.pop()


def report_metrics(aux):
    """Called by the MoE cells after each gated forward."""
    if _COLLECT_STACK:
        _COLLECT_STACK[-1].add(aux)
