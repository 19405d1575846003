"""Linear-algebra operators — the port of ``mxnet_tpu/ops/linalg.py``,
the ``linalg.*`` namespace (``mx.nd.linalg.gemm2`` ...) and ``einsum``,
over the last two axes of batched operands, with MXNet's attributes
(``transpose_a/b``, ``alpha``, ``beta``, ``rightside``, ``lower``,
``offset``).  The math is ``torch.linalg``: cuBLAS and cuSOLVER on the
card, LAPACK on the host.  ``potrf`` gives the lower Cholesky factor and
``potri`` the inverse of the matrix that factor came from.  ``svd``,
``eigh``, ``qr``, ``matrix_rank`` and ``pinv`` are not differentiable, as
in the reference.
"""

from __future__ import annotations

import numpy as np
import torch

from ..base import MXNetError
from .registry import register


def _t(x):
    return x.transpose(-1, -2)


@register("linalg.gemm")
def _gemm(A, B, C, transpose_a=False, transpose_b=False, alpha=1.0,
          beta=1.0, axis=-2):  # noqa: N803,ARG001
    """alpha op(A) op(B) + beta C."""
    a = _t(A) if transpose_a else A
    b = _t(B) if transpose_b else B
    return alpha * torch.matmul(a, b) + beta * C


@register("linalg.gemm2")
def _gemm2(A, B, transpose_a=False, transpose_b=False, alpha=1.0,
           axis=-2):  # noqa: N803,ARG001
    """alpha op(A) op(B)."""
    a = _t(A) if transpose_a else A
    b = _t(B) if transpose_b else B
    return alpha * torch.matmul(a, b)


@register("linalg.syrk")
def _syrk(A, transpose=False, alpha=1.0):  # noqa: N803
    """alpha A^T A (``transpose``) or alpha A A^T."""
    return alpha * (torch.matmul(_t(A), A) if transpose
                    else torch.matmul(A, _t(A)))


def _sym(A):  # noqa: N803
    """(A + A^T) / 2: the reference's factorizations symmetrize their
    input, so the value and the gradient see both triangles."""
    return (A + _t(A)) / 2


@register("linalg.potrf")
def _potrf(A):  # noqa: N803
    """The lower Cholesky factor L of A = L L^T (A symmetrized)."""
    return torch.linalg.cholesky(_sym(A))


@register("linalg.potri")
def _potri(L):  # noqa: N803
    """(L L^T)^-1 from the Cholesky factor L."""
    eye = torch.eye(L.shape[-1], dtype=L.dtype, device=L.device) \
        .expand(L.shape)
    linv = torch.linalg.solve_triangular(L, eye, upper=False)
    return torch.matmul(_t(linv), linv)


@register("linalg.trsm")
def _trsm(A, B, transpose=False, rightside=False, lower=True,
          alpha=1.0):  # noqa: N803
    """X with op(A) X = alpha B (X op(A) = alpha B with ``rightside``),
    A triangular."""
    a = _t(A) if transpose else A
    lo = lower != transpose
    if rightside:
        return _t(torch.linalg.solve_triangular(_t(a), _t(alpha * B),
                                                upper=lo))
    return torch.linalg.solve_triangular(a, alpha * B, upper=not lo)


@register("linalg.trmm")
def _trmm(A, B, transpose=False, rightside=False, lower=True,
          alpha=1.0):  # noqa: N803
    """alpha op(A) B (B op(A) with ``rightside``), A triangular."""
    a = _t(A) if transpose else A
    tri = torch.tril(a) if lower != transpose else torch.triu(a)
    return alpha * (torch.matmul(B, tri) if rightside
                    else torch.matmul(tri, B))


@register("linalg.sumlogdiag")
def _sumlogdiag(A):  # noqa: N803
    return torch.log(torch.diagonal(A, dim1=-2, dim2=-1)).sum(dim=-1)


@register("linalg.extractdiag")
def _extractdiag(A, offset=0):  # noqa: N803
    return torch.diagonal(A, offset=offset, dim1=-2, dim2=-1)


@register("linalg.makediag")
def _makediag(d, offset=0):
    """Square matrices with ``d`` on diagonal ``offset``."""
    return torch.diag_embed(d, offset=offset)


def _trian_indices(n, offset, lower):
    return np.tril_indices(n, offset) if lower else np.triu_indices(n, offset)


@register("linalg.extracttrian")
def _extracttrian(A, offset=0, lower=True):  # noqa: N803
    """The lower (upper) triangle from diagonal ``offset``, packed row by
    row."""
    rows, cols = _trian_indices(A.shape[-1], offset, lower)
    return A[..., torch.as_tensor(rows, device=A.device),
             torch.as_tensor(cols, device=A.device)]


@register("linalg.maketrian")
def _maketrian(d, offset=0, lower=True):
    """The inverse of ``extracttrian``: the packed triangle unpacked into a
    square matrix, zero elsewhere."""
    m = d.shape[-1]
    n = 1
    while len(_trian_indices(n, offset, lower)[0]) < m:
        n += 1
    rows, cols = _trian_indices(n, offset, lower)
    if len(rows) != m:
        raise MXNetError(f"maketrian: packed length {m} does not match any "
                         f"square size at offset {offset}")
    out = torch.zeros(d.shape[:-1] + (n, n), dtype=d.dtype, device=d.device)
    out[..., torch.as_tensor(rows, device=d.device),
        torch.as_tensor(cols, device=d.device)] = d
    return out


register("linalg.inverse")(torch.linalg.inv)
register("linalg.det")(torch.linalg.det)


@register("linalg.slogdet", num_outputs=2)
def _slogdet(A):  # noqa: N803
    """(sign, log |det A|)."""
    sign, logabs = torch.linalg.slogdet(A)
    return sign, logabs


@register("linalg.svd", num_outputs=3, differentiable=False)
def _svd(A):  # noqa: N803
    """U, S, V^T of the reduced SVD."""
    u, s, vt = torch.linalg.svd(A, full_matrices=False)
    return u, s, vt


@register("linalg.eigh", num_outputs=2, differentiable=False)
def _eigh(A):  # noqa: N803
    """Ascending eigenvalues and eigenvectors (columns) of A
    symmetrized."""
    w, v = torch.linalg.eigh(_sym(A))
    return w, v


@register("linalg.qr", num_outputs=2, differentiable=False)
def _qr(A):  # noqa: N803
    q, r = torch.linalg.qr(A)
    return q, r


@register("linalg.gelqf", num_outputs=2)
def _gelqf(A):  # noqa: N803
    """A = L Q with L lower triangular and Q row-orthonormal, from the QR
    factorization of A^T."""
    q, r = torch.linalg.qr(_t(A))
    return _t(r), _t(q)


register("linalg.solve")(torch.linalg.solve)


@register("linalg.tensorinv")
def _tensorinv(A, ind=2):  # noqa: N803
    return torch.linalg.tensorinv(A, ind=ind)


@register("linalg.norm")
def _linalg_norm(A, ord=None, axis=None, keepdims=False):  # noqa: N803,A002
    """numpy's ``linalg.norm``: the vector 2-norm of the flattened array
    without ``ord`` and ``axis``."""
    return torch.linalg.norm(A, ord=ord, dim=axis, keepdim=keepdims)


@register("linalg.matrix_rank", differentiable=False)
def _matrix_rank(A, tol=None):  # noqa: N803
    """The count of singular values above ``tol`` (default: the largest
    times max(M, N) times the dtype's epsilon)."""
    if tol is None:
        return torch.linalg.matrix_rank(A)
    return torch.linalg.matrix_rank(A, atol=tol, rtol=0.0)


@register("linalg.pinv", differentiable=False)
def _pinv(A, rcond=1e-15):  # noqa: N803
    """The pseudo-inverse, singular values below ``rcond`` times the
    largest taken as zero."""
    return torch.linalg.pinv(A, rtol=rcond)


@register("einsum")
def _einsum(*operands, subscripts=""):
    return torch.einsum(subscripts, *operands)
