"""Linear-algebra ops, the ``linalg_*`` family.

Counterpart of ``mxnet_tpu/ops/linalg.py`` (reference
``src/operator/tensor/la_op.cc``), on ``torch.linalg``: every op works on
the last two axes and is batched over the leading ones, and every op is
differentiable (torch's own derivatives), as the reference's are. The
conventions are the reference's:

- ``linalg_gemm``/``gemm2``: ``alpha * op(A) op(B) (+ beta * C)``;
- ``linalg_potrf``: the lower Cholesky factor; ``linalg_potri``: the
  inverse of ``L L^T`` from its factor ``L``;
- ``linalg_trsm``: solves ``op(A) X = alpha B`` (``rightside``: ``X op(A) =
  alpha B``) with ``A`` triangular, ``lower`` read before the transpose;
  ``linalg_trmm``: ``alpha op(tri(A)) B`` (``rightside``: ``B op(tri(A))``);
- ``linalg_syrk``: ``alpha A A^T`` (``transpose``: ``A^T A``);
- ``linalg_gelqf``: ``A = L Q`` with ``Q`` of orthonormal rows, returned as
  ``(L, Q)`` from the QR of ``A^T``;
- ``linalg_syevd``: ``A = U^T diag(L) U``, the eigenvectors as the rows of
  ``U``, returned as ``(U, L)`` (an eigenvector's sign is the solver's);
- ``linalg_extractdiag``/``makediag`` and ``linalg_extracttrian``/
  ``maketrian`` (the triangle row by row, ``offset`` from the diagonal),
  ``linalg_sumlogdiag``, ``linalg_inverse``, ``linalg_det`` and
  ``linalg_slogdet`` (sign, log of the absolute determinant).
"""
from __future__ import annotations

import math

import numpy as _np
import torch

from .registry import register


def _t(x):
    return x.transpose(-1, -2)


@register("linalg_gemm")
def linalg_gemm(A, B, C, *, transpose_a=False, transpose_b=False, alpha=1.0,
                beta=1.0, axis=-2):
    a = _t(A) if transpose_a else A
    b = _t(B) if transpose_b else B
    return alpha * torch.matmul(a, b) + beta * C


@register("linalg_gemm2")
def linalg_gemm2(A, B, *, transpose_a=False, transpose_b=False, alpha=1.0, axis=-2):
    a = _t(A) if transpose_a else A
    b = _t(B) if transpose_b else B
    return alpha * torch.matmul(a, b)


@register("linalg_potrf")
def linalg_potrf(A):
    return torch.linalg.cholesky(A)


@register("linalg_potri")
def linalg_potri(L):
    eye = torch.eye(L.shape[-1], dtype=L.dtype, device=L.device).expand(L.shape)
    linv = torch.linalg.solve_triangular(L, eye, upper=False)
    return torch.matmul(_t(linv), linv)


@register("linalg_trsm")
def linalg_trsm(A, B, *, transpose=False, rightside=False, lower=True, alpha=1.0):
    a = _t(A) if transpose else A
    low = lower != transpose
    return alpha * torch.linalg.solve_triangular(a, B, upper=not low, left=not rightside)


@register("linalg_trmm")
def linalg_trmm(A, B, *, transpose=False, rightside=False, lower=True, alpha=1.0):
    a = _t(A) if transpose else A
    a = torch.tril(a) if (lower != transpose) else torch.triu(a)
    return alpha * (torch.matmul(B, a) if rightside else torch.matmul(a, B))


@register("linalg_sumlogdiag")
def linalg_sumlogdiag(A):
    return torch.sum(torch.log(torch.diagonal(A, dim1=-2, dim2=-1)), dim=-1)


@register("linalg_syrk")
def linalg_syrk(A, *, transpose=False, alpha=1.0):
    return alpha * (torch.matmul(_t(A), A) if transpose else torch.matmul(A, _t(A)))


@register("linalg_extractdiag")
def linalg_extractdiag(A, *, offset=0):
    return torch.diagonal(A, offset=offset, dim1=-2, dim2=-1)


@register("linalg_makediag")
def linalg_makediag(x, *, offset=0):
    return torch.diag_embed(x, offset=offset)


def _trian(n, offset, lower):
    rows, cols = (_np.tril_indices(n, offset) if lower else _np.triu_indices(n, offset))
    return torch.from_numpy(rows), torch.from_numpy(cols)


@register("linalg_extracttrian")
def linalg_extracttrian(A, *, offset=0, lower=True):
    rows, cols = _trian(A.shape[-1], offset, lower)
    return A[..., rows.to(A.device), cols.to(A.device)]


@register("linalg_maketrian")
def linalg_maketrian(x, *, offset=0, lower=True):
    L = x.shape[-1]
    n = (math.isqrt(8 * L + 1) - 1) // 2 + abs(offset)
    rows, cols = _trian(n, offset, lower)
    idx = (rows * n + cols).to(x.device).expand(x.shape)
    flat = x.new_zeros(x.shape[:-1] + (n * n,)).scatter(-1, idx, x)
    return flat.reshape(x.shape[:-1] + (n, n))


@register("linalg_gelqf")
def linalg_gelqf(A):
    q, r = torch.linalg.qr(_t(A))
    return _t(r), _t(q)


@register("linalg_inverse", aliases=("inverse",))
def linalg_inverse(A):
    return torch.linalg.inv(A)


@register("linalg_det", aliases=("det",))
def linalg_det(A):
    return torch.linalg.det(A)


@register("linalg_slogdet", aliases=("slogdet",))
def linalg_slogdet(A):
    sign, logdet = torch.linalg.slogdet(A)
    return sign, logdet


@register("linalg_syevd", aliases=("_linalg_syevd",))
def linalg_syevd(A):
    L, V = torch.linalg.eigh(A)
    return _t(V), L
