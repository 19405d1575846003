"""The functions of ``mx.np.linalg`` over ``torch.linalg``, on tensors
(bound as the registry ops ``np.linalg.<name>`` by ``numpy/linalg.py``).

numpy's conventions where torch's differ: ``lstsq`` gives numpy's four
outputs from an SVD, rank-deficient inputs included (torch's CUDA
``lstsq`` takes only the full-rank ``gels`` routine and returns neither
residuals, rank nor singular values), its cut at eps(dtype) x max(M, N)
of the largest singular value; ``matrix_rank`` and ``cond`` use numpy's
default tolerances, ``pinv`` numpy's 1e-15 for float64 and, for a
narrower dtype, numpy's ``rtol=None`` rule (max(M, N) x eps), since
numpy's 1e-15 is relative to singular values it computes in float64; ``norm`` reads ``ord`` and
``axis`` as numpy does; ``trace`` and ``diagonal`` run over the last two
axes (the array API's).  ``inv``, ``solve``, ``cholesky`` and what is
built on them (``cond``, ``tensorinv``, ``tensorsolve``) do not check
LAPACK's info, as ``jnp``'s do not: a singular matrix gives inf/nan and a
matrix that is not positive definite a factor of nan, without an error and
without a wait for the info on the card.
"""

from __future__ import annotations

import torch

from ..base import MXNetError
from ._impl import _a, _common, _float, _is_int, _tensordot


def _f(x):
    return _float(_a(x))


def _inv(A):
    return torch.linalg.inv_ex(A).inverse


def _solve(A, B):
    return torch.linalg.solve_ex(A, B).result


def norm(x, ord=None, axis=None, keepdims=False):  # noqa: A002
    t = _f(x)
    if axis is None and ord is None:
        r = torch.linalg.vector_norm(t.reshape(-1), 2)
        return r.reshape((1,) * t.ndim) if keepdims else r
    if axis is None:
        axis = tuple(range(t.ndim))
    if isinstance(axis, int) or len(axis) == 1:
        return torch.linalg.vector_norm(t, 2 if ord is None else ord,
                                        dim=axis, keepdim=keepdims)
    return torch.linalg.matrix_norm(t, "fro" if ord is None else ord,
                                    dim=tuple(axis), keepdim=keepdims)


def vector_norm(x, axis=None, keepdims=False, ord=2):  # noqa: A002
    return torch.linalg.vector_norm(_f(x), ord, dim=axis, keepdim=keepdims)


def matrix_norm(x, keepdims=False, ord="fro"):  # noqa: A002
    return torch.linalg.matrix_norm(_f(x), ord, keepdim=keepdims)


def inv(a):
    return _inv(_f(a))


def det(a):
    return torch.linalg.det(_f(a))


def slogdet(a):
    r = torch.linalg.slogdet(_f(a))
    return r.sign, r.logabsdet


def solve(a, b):
    A = _f(a)
    B = _a(b).to(A.dtype)
    if B.ndim == 1:
        return _solve(A, B[:, None])[..., 0] if A.ndim == 2 \
            else _solve(A, B)
    return _solve(A, B)


def _lstsq(A, B, rcond, residuals=True):
    """numpy's lstsq from an SVD: (x, residuals, rank, s).  The residuals
    exist only at full column rank, so asking for them reads the rank to
    the host."""
    A = _float(A)
    B = B.to(A.dtype)
    vec = B.ndim == 1
    Bm = B[:, None] if vec else B
    m, n = A.shape[-2:]
    U, s, Vh = torch.linalg.svd(A, full_matrices=False)
    rc = torch.finfo(A.dtype).eps * max(m, n) if rcond is None else rcond
    cut = rc * s.max() if s.numel() else torch.zeros((), device=A.device)
    keep = s > cut
    sinv = torch.where(keep, 1 / torch.where(keep, s, torch.ones_like(s)),
                       torch.zeros_like(s))
    x = Vh.mT.conj() @ (sinv[:, None] * (U.mT.conj() @ Bm))
    rank = keep.sum()
    if residuals and m > n and bool(rank == n):
        r = Bm - A @ x
        resid = (r.abs() ** 2).sum(0)
    else:
        resid = torch.zeros((0,), dtype=s.dtype, device=A.device)
    return (x[:, 0] if vec else x), resid, rank, s


def lstsq(a, b, rcond=None):
    return _lstsq(_a(a), _a(b), rcond)


def pinv(a, rcond=None, hermitian=False, *, rtol=None):
    A = _f(a)
    if rcond is None and rtol is None:
        # numpy's 1e-15 is relative to singular values it computes in
        # float64; a narrower dtype gets numpy's rtol=None rule instead
        rc = 1e-15 if A.dtype in (torch.float64, torch.complex128) else \
            max(A.shape[-2:]) * torch.finfo(A.dtype).eps
    elif rcond is None:
        rc = rtol
    else:
        rc = rcond
    if hermitian:
        w, V = torch.linalg.eigh(A)
        s = w.abs()
        cut = rc * s.amax(-1, keepdim=True)
        winv = torch.where(s > cut, 1 / torch.where(s > cut, w,
                                                    torch.ones_like(w)),
                           torch.zeros_like(w))
        return (V * winv.unsqueeze(-2)) @ V.mT.conj()
    U, s, Vh = torch.linalg.svd(A, full_matrices=False)
    cut = rc * s.amax(-1, keepdim=True)
    sinv = torch.where(s > cut, 1 / torch.where(s > cut, s,
                                                torch.ones_like(s)),
                       torch.zeros_like(s))
    return (Vh.mT.conj() * sinv.unsqueeze(-2)) @ U.mT.conj()


def matrix_rank(A, tol=None, hermitian=False, *, rtol=None):
    t = _f(A)
    if t.ndim < 2:
        return (t != 0).any().to(torch.int64)
    S = torch.linalg.eigvalsh(t).abs() if hermitian else \
        torch.linalg.svdvals(t)
    if tol is None:
        r = max(t.shape[-2:]) * torch.finfo(S.dtype).eps if rtol is None \
            else rtol
        cut = S.amax(-1, keepdim=True) * r
    else:
        cut = torch.as_tensor(tol, dtype=S.dtype, device=S.device)[..., None]
    return (S > cut).sum(-1)


def cond(x, p=None):
    t = _f(x)
    if p is None or p in (2, -2):
        s = torch.linalg.svdvals(t)
        r = s[..., 0] / s[..., -1]
        return 1 / r if p == -2 else r
    return torch.linalg.matrix_norm(t, p) * torch.linalg.matrix_norm(
        _inv(t), p)


def matrix_power(a, n):
    t = _a(a)
    if _is_int(t) and t.is_cuda:
        return torch.linalg.matrix_power(t.double(), int(n)).round().to(
            t.dtype)
    return torch.linalg.matrix_power(t, int(n))


def cholesky(a, upper=False):
    L, info = torch.linalg.cholesky_ex(_f(a), upper=upper)
    # not positive definite: jnp's factor is nan over its triangle
    tri = torch.ones(L.shape[-2:], dtype=torch.bool, device=L.device)
    tri = tri.triu() if upper else tri.tril()
    return torch.where((info != 0)[..., None, None] & tri, torch.nan, L)


def qr(a, mode="reduced"):
    t = _f(a)
    if mode == "r":
        return torch.linalg.qr(t, mode="r").R
    if mode not in ("reduced", "complete"):
        raise MXNetError(f"qr: mode {mode!r} is not supported")
    r = torch.linalg.qr(t, mode=mode)
    return r.Q, r.R


def svd(a, full_matrices=True, compute_uv=True, hermitian=False):  # noqa: ARG001
    t = _f(a)
    if not compute_uv:
        return torch.linalg.svdvals(t)
    r = torch.linalg.svd(t, full_matrices=full_matrices)
    return r.U, r.S, r.Vh


def svdvals(x):
    return torch.linalg.svdvals(_f(x))


def eig(a):
    r = torch.linalg.eig(_f(a))
    return r.eigenvalues, r.eigenvectors


def eigvals(a):
    return torch.linalg.eigvals(_f(a))


def eigh(a, UPLO="L", symmetrize_input=True):  # noqa: N803,ARG001
    r = torch.linalg.eigh(_f(a), UPLO=UPLO)
    return r.eigenvalues, r.eigenvectors


def eigvalsh(a, UPLO="L", symmetrize_input=True):  # noqa: N803,ARG001
    return torch.linalg.eigvalsh(_f(a), UPLO=UPLO)


def tensorinv(a, ind=2):
    t = _f(a)
    ind = int(ind)
    if ind <= 0:
        raise MXNetError("tensorinv: ind must be a positive integer")
    out_shape = t.shape[ind:] + t.shape[:ind]
    return _inv(t.reshape(t.shape[:ind].numel(), -1)).reshape(out_shape)


def tensorsolve(a, b, axes=None):
    A = _f(a)
    B = _a(b).to(A.dtype)
    if axes is not None:
        order = [k for k in range(A.ndim) if k not in
                 {ax % A.ndim for ax in axes}] + [ax % A.ndim for ax in axes]
        A = A.permute(order)
    x_shape = A.shape[B.ndim:]
    return _solve(A.reshape(-1, x_shape.numel()),
                  B.reshape(-1)).reshape(x_shape)


def multi_dot(arrays):
    ts = _common(*[_a(t) for t in arrays])
    return torch.linalg.multi_dot(ts)


def cross(x1, x2, axis=-1):
    a, b = _common(_a(x1), _a(x2))
    return torch.linalg.cross(a, b, dim=int(axis))


def outer(x1, x2):
    a, b = _common(_a(x1), _a(x2))
    if a.ndim != 1 or b.ndim != 1:
        raise MXNetError("linalg.outer takes two 1-D arrays")
    return a[:, None] * b[None, :]


def matmul(x1, x2):
    from ._impl import _mm
    return _mm(_a(x1), _a(x2))


def trace(x, offset=0, dtype=None):
    from ._impl import _acc_dtype
    t = _a(x)
    d = torch.diagonal(t, int(offset), -2, -1)
    return torch.sum(d, -1, dtype=_acc_dtype(d, dtype))


def diagonal(x, offset=0):
    return torch.diagonal(_a(x), int(offset), -2, -1)


def matrix_transpose(x):
    return torch.transpose(_a(x), -1, -2)


def tensordot(x1, x2, axes=2):
    return _tensordot(_a(x1), _a(x2), axes)


def vecdot(x1, x2, axis=-1):
    from ._impl import vecdot as _vd
    return _vd(x1, x2, axis=axis)
