"""Sparse-storage operators — the port of ``mxnet_tpu/ops/sparse_ops.py``
(MXNet's ``dot.cc`` sparse paths, ``square_sum.cc``, ``sparse_retain.cc``,
``contrib.getnnz``).

A sparse array is dense component tensors (``ndarray/sparse.py``); these
ops work on the components: a gather, then a sum per row with
``index_add`` (on the card its float adds are atomics, so the order of a
row's terms, and the last bits, vary from run to run).  Each csr element's
row comes from a ``searchsorted`` over ``indptr``.  They are ordinary
registry ops, differentiable in the float components and the dense
operand under torch autograd, and reachable from ``mx.nd`` and ``mx.sym``.
"""

from __future__ import annotations

import torch

from .registry import register


def _csr_rows(indptr, nnz):
    """Row id of each csr element: r with indptr[r] <= k < indptr[r+1]."""
    k = torch.arange(nnz, dtype=indptr.dtype, device=indptr.device)
    return torch.searchsorted(indptr.contiguous(), k, right=True) - 1


def _segment_sum(vals, seg, n):
    return torch.zeros((n,) + tuple(vals.shape[1:]), dtype=vals.dtype,
                       device=vals.device).index_add(0, seg, vals)


@register("_sparse_dot_csr")
def _sparse_dot_csr(data, indptr, indices, rhs, transpose_a=False,
                    num_cols=0):
    """csr (lhs) @ dense rhs, or csr.T @ rhs with ``transpose_a``.

    data (nnz,), indptr (n_rows + 1,), indices (nnz,), rhs (n_cols, k) for
    the plain product, (n_rows, k) for the transposed one; ``num_cols`` is
    the csr's column count (the transposed output's rows)."""
    nnz = data.shape[0]
    n_rows = indptr.shape[0] - 1
    rows = _csr_rows(indptr, nnz)
    cols = indices.to(torch.int64)
    if not transpose_a:
        # out[r] = sum over row r's elements k of data[k] * rhs[indices[k]]
        return _segment_sum(rhs[cols] * data[:, None], rows, n_rows)
    if not num_cols:
        raise ValueError("_sparse_dot_csr(transpose_a=True) needs the "
                         "num_cols attr (the csr's column count)")
    # out[c] = sum over elements k in column c of data[k] * rhs[row_k]
    return _segment_sum(rhs[rows] * data[:, None], cols, int(num_cols))


@register("_square_sum_rs")
def _square_sum_rs(data, indices, num_rows=0, axis=None, keepdims=False):
    """sum(x ** 2) of a row_sparse array over its stored rows: all of it
    (axis None), per row (axis 1: dense (num_rows,)) or per column (axis
    0).  float32 and float64 sum in their own type, narrower ones in
    float32."""
    acc = data.dtype if data.dtype in (torch.float32, torch.float64) \
        else torch.float32
    sq = data.to(acc) ** 2
    if axis is None:
        out = sq.sum()
        return out.reshape((1,) * data.ndim) if keepdims else out
    axis = int(axis)
    if axis in (1, -1):
        if not num_rows:
            raise ValueError("_square_sum_rs(axis=1) needs num_rows")
        out = _segment_sum(sq.sum(dim=1), indices.to(torch.int64),
                           int(num_rows))
        return out[:, None] if keepdims else out
    if axis == 0:
        out = sq.sum(dim=0)
        return out[None, :] if keepdims else out
    raise ValueError(f"square_sum: unsupported axis {axis}")


@register("_sparse_retain_values")
def _sparse_retain_values(data, indices, row_ids):
    """``data`` with the rows whose index is not in ``row_ids`` zeroed
    (the shape kept; the container drops them)."""
    mask = torch.isin(indices, row_ids.to(indices.dtype))
    return data * mask[:, None].to(data.dtype)


@register("contrib.getnnz", differentiable=False)
def _getnnz(data, axis=None):
    """The count of non-zeros, over ``axis`` or all."""
    nz = (data != 0).to(torch.int64)
    return nz.sum() if axis is None else nz.sum(dim=int(axis))
