"""`mx.nd.linalg`: the ``linalg_*`` ops by their short names.

Counterpart of ``mxnet_tpu/ndarray/linalg.py``; the ops are
``ops/linalg.py``'s, recorded and differentiable like any op.
"""
from __future__ import annotations

from .ndarray import invoke


def gemm(A, B, C, transpose_a=False, transpose_b=False, alpha=1.0, beta=1.0, axis=-2):
    return invoke("linalg_gemm", [A, B, C], dict(transpose_a=transpose_a,
                  transpose_b=transpose_b, alpha=alpha, beta=beta))


def gemm2(A, B, transpose_a=False, transpose_b=False, alpha=1.0, axis=-2):
    return invoke("linalg_gemm2", [A, B], dict(transpose_a=transpose_a,
                  transpose_b=transpose_b, alpha=alpha))


def potrf(A):
    return invoke("linalg_potrf", [A], {})


def potri(A):
    return invoke("linalg_potri", [A], {})


def trsm(A, B, transpose=False, rightside=False, lower=True, alpha=1.0):
    return invoke("linalg_trsm", [A, B], dict(transpose=transpose,
                  rightside=rightside, lower=lower, alpha=alpha))


def trmm(A, B, transpose=False, rightside=False, lower=True, alpha=1.0):
    return invoke("linalg_trmm", [A, B], dict(transpose=transpose,
                  rightside=rightside, lower=lower, alpha=alpha))


def sumlogdiag(A):
    return invoke("linalg_sumlogdiag", [A], {})


def syrk(A, transpose=False, alpha=1.0):
    return invoke("linalg_syrk", [A], dict(transpose=transpose, alpha=alpha))


def extractdiag(A, offset=0):
    return invoke("linalg_extractdiag", [A], dict(offset=offset))


def makediag(A, offset=0):
    return invoke("linalg_makediag", [A], dict(offset=offset))


def extracttrian(A, offset=0, lower=True):
    return invoke("linalg_extracttrian", [A], dict(offset=offset, lower=lower))


def maketrian(A, offset=0, lower=True):
    return invoke("linalg_maketrian", [A], dict(offset=offset, lower=lower))


def gelqf(A):
    return invoke("linalg_gelqf", [A], {})


def inverse(A):
    return invoke("linalg_inverse", [A], {})


def det(A):
    return invoke("linalg_det", [A], {})


def slogdet(A):
    return invoke("linalg_slogdet", [A], {})


def syevd(A):
    return invoke("linalg_syevd", [A], {})
