"""Sparse NDArrays, row_sparse and CSR — the port of
``mxnet_tpu/ndarray/sparse.py`` (MXNet's ``python/mxnet/ndarray/sparse.py``
over ``kRowSparseStorage`` / ``kCSRStorage``).

A sparse array is dense component NDArrays on its device: (``data``,
``indices``) for row_sparse, (``data``, ``indptr``, ``indices``) for CSR.
The storage-aware functions (``dot``, ``square_sum``, ``sparse_retain``)
run the registry's sparse ops (``ops/sparse_ops.py``) on the components,
so they record under ``autograd.record()`` like any op.  Compactions whose
size depends on the values (the rows a mask keeps) reduce on the device
and gather there; only the count crosses to the host, as ``nonzero``
needs it.
"""

from __future__ import annotations

import numpy as np
import torch

from ..base import MXNetError, numpy_dtype, torch_dtype
from ..context import Context, current_context
from .ndarray import NDArray, _placed, array as _dense_array, \
    zeros as _dense_zeros

__all__ = ["BaseSparseNDArray", "RowSparseNDArray", "CSRNDArray",
           "row_sparse_array", "row_sparse_view", "csr_matrix",
           "cast_storage", "zeros", "dot", "square_sum", "sparse_retain",
           "merge_rows"]


def _nd(v, ctx, dtype=None):
    """``v`` as an NDArray: an NDArray as it is, anything else copied
    onto ``ctx``."""
    if isinstance(v, NDArray):
        return v
    return _dense_array(v if dtype is None else np.asarray(v, dtype),
                        ctx=ctx)


class BaseSparseNDArray:
    def __init__(self, shape, ctx=None, dtype=None):
        self._shape = tuple(shape)
        self._ctx = ctx if ctx is not None else current_context()
        self._dtype = numpy_dtype(torch_dtype(dtype))

    @property
    def shape(self):
        return self._shape

    @property
    def dtype(self):
        return self._dtype

    @property
    def ctx(self):
        return self._ctx

    context = ctx

    @property
    def size(self):
        return int(np.prod(self._shape, dtype=np.int64))

    def asnumpy(self):
        return self.tostype("default").asnumpy()

    def wait_to_read(self):
        self.data.wait_to_read()

    def __repr__(self):
        return (f"\n<{type(self).__name__} "
                f"{'x'.join(map(str, self.shape))} @{self.ctx}>")


class RowSparseNDArray(BaseSparseNDArray):
    """(indices, values): ``data[i]`` is the dense row ``indices[i]``; every
    other row is zero (the gradient of a sparse Embedding, a kvstore's
    pulled rows)."""

    def __init__(self, data, indices, shape, ctx=None, dtype=None):
        dtype = dtype if dtype is not None else getattr(data, "dtype", None)
        super().__init__(shape, ctx, dtype)
        self.data = _nd(data, ctx)
        self.indices = _nd(indices, ctx, np.int64)

    @property
    def stype(self):
        return "row_sparse"

    def tostype(self, stype):
        if stype == "row_sparse":
            return self
        if stype != "default":
            raise MXNetError(f"cannot convert row_sparse to {stype}")
        vals = self.data._data
        dense = torch.zeros(self._shape, dtype=vals.dtype,
                            device=vals.device)
        dense[self.indices._data.to(torch.int64)] = vals
        return _placed(dense, self.data.ctx)

    def copyto(self, other):
        if isinstance(other, NDArray):
            other._set_data(self.tostype("default")._data)
            return other
        if isinstance(other, Context):
            return RowSparseNDArray(self.data.copyto(other),
                                    self.indices.copyto(other), self._shape,
                                    ctx=other, dtype=self._dtype)
        raise MXNetError(f"copyto does not support type {type(other)}")

    def retain(self, row_ids):
        """The stored rows listed in ``row_ids`` (MXNet's sparse_retain),
        selected on the device."""
        rid = _ids(row_ids, self.indices._data.device)
        keep = torch.isin(self.indices._data, rid).nonzero().flatten()
        return RowSparseNDArray(NDArray(self.data._data[keep]),
                                NDArray(self.indices._data[keep]),
                                self._shape, ctx=self.ctx, dtype=self._dtype)

    def __add__(self, other):
        if isinstance(other, RowSparseNDArray):
            return self.tostype("default") + other.tostype("default")
        return self.tostype("default") + other


class CSRNDArray(BaseSparseNDArray):
    """Compressed sparse rows: row r holds ``data[indptr[r]:indptr[r+1]]``
    at the columns ``indices[indptr[r]:indptr[r+1]]``."""

    def __init__(self, data, indptr, indices, shape, ctx=None, dtype=None):
        dtype = dtype if dtype is not None else getattr(data, "dtype", None)
        super().__init__(shape, ctx, dtype)
        self.data = _nd(data, ctx)
        self.indptr = _nd(indptr, ctx, np.int64)
        self.indices = _nd(indices, ctx, np.int64)

    @property
    def stype(self):
        return "csr"

    def tostype(self, stype):
        if stype == "csr":
            return self
        if stype != "default":
            raise MXNetError(f"cannot convert csr to {stype}")
        vals = self.data._data
        indptr = self.indptr._data.to(torch.int64)
        rows = torch.repeat_interleave(
            torch.arange(self._shape[0], device=indptr.device),
            indptr[1:] - indptr[:-1])
        dense = torch.zeros(self._shape, dtype=vals.dtype,
                            device=vals.device)
        dense[rows, self.indices._data.to(torch.int64)] = vals
        return _placed(dense, self.data.ctx)

    def copyto(self, other):
        if isinstance(other, NDArray):
            other._set_data(self.tostype("default")._data)
            return other
        if isinstance(other, Context):
            return CSRNDArray(self.data.copyto(other),
                              self.indptr.copyto(other),
                              self.indices.copyto(other), self._shape,
                              ctx=other, dtype=self._dtype)
        raise MXNetError(f"copyto does not support type {type(other)}")

    def dot(self, dense):
        """csr @ dense through ``_sparse_dot_csr``."""
        return dot(self, dense)


def merge_rows(indices, values):
    """Row-sparse ``values`` at ``indices`` (duplicates allowed) summed
    by row: (sorted unique indices, their summed rows), on the values'
    device."""
    uniq, inv = torch.unique(indices, return_inverse=True)
    merged = torch.zeros((len(uniq),) + tuple(values.shape[1:]),
                         dtype=values.dtype, device=values.device)
    return uniq, merged.index_add_(0, inv, values)


def _ids(row_ids, device):
    """Row ids (an NDArray, a tensor, or a sequence) as int64 on
    ``device``."""
    if isinstance(row_ids, NDArray):
        row_ids = row_ids._data
    if isinstance(row_ids, torch.Tensor):
        return row_ids.to(device=device, dtype=torch.int64)
    return torch.as_tensor(np.asarray(row_ids, np.int64), device=device)


def row_sparse_array(arg1, shape=None, ctx=None, dtype=None):
    """A RowSparseNDArray from ``(data, indices)``, from a dense NDArray
    (:func:`row_sparse_view`) or from a dense numpy array (its non-zero
    rows)."""
    if isinstance(arg1, tuple) and len(arg1) == 2:
        data, indices = arg1
        return RowSparseNDArray(data, indices, shape, ctx=ctx, dtype=dtype)
    if isinstance(arg1, NDArray):
        return row_sparse_view(arg1, ctx=ctx, dtype=dtype)
    dense = np.asarray(arg1)
    nz = np.where(np.any(dense != 0, axis=tuple(range(1, dense.ndim))))[0]
    return RowSparseNDArray(dense[nz], nz.astype(np.int64), dense.shape,
                            ctx=ctx, dtype=dtype or dense.dtype)


def row_sparse_view(dense_nd, ctx=None, dtype=None):
    """The non-zero rows of a dense NDArray as a RowSparseNDArray, taken on
    its device: the row mask reduces there, only the kept rows are
    gathered, and only their count reaches the host.  A snapshot, not a
    live view: writes to either side do not reach the other (what
    ``Parameter.grad(stype="row_sparse")`` returns after a backward)."""
    with torch.no_grad():
        gd = dense_nd._data
        mask = (gd != 0).reshape(gd.shape[0], -1).any(dim=1) \
            if gd.ndim > 1 else gd != 0
        idx = mask.nonzero().flatten()
        vals = gd[idx]
    return RowSparseNDArray(NDArray(vals, dense_nd._ctx),
                            NDArray(idx, dense_nd._ctx), dense_nd.shape,
                            ctx=ctx or dense_nd.ctx,
                            dtype=dtype or dense_nd.dtype)


def csr_matrix(arg1, shape=None, ctx=None, dtype=None):
    """A CSRNDArray from ``(data, indices, indptr)`` or from a dense array
    (numpy or NDArray; its non-zeros in row-major order)."""
    if isinstance(arg1, tuple) and len(arg1) == 3:
        data, indices, indptr = arg1
        return CSRNDArray(data, indptr, indices, shape, ctx=ctx, dtype=dtype)
    dense = np.asarray(arg1.asnumpy() if isinstance(arg1, NDArray)
                       else arg1)
    rows, cols = np.nonzero(dense)
    indptr = np.zeros(dense.shape[0] + 1, dtype=np.int64)
    np.add.at(indptr, rows + 1, 1)
    return CSRNDArray(dense[rows, cols], np.cumsum(indptr),
                      cols.astype(np.int64), dense.shape, ctx=ctx,
                      dtype=dtype or dense.dtype)


def cast_storage(arr, stype):
    """``arr`` in the storage type ``stype`` (MXNet's cast_storage)."""
    if stype == "default":
        return arr.tostype("default") if not isinstance(arr, NDArray) \
            else arr
    if isinstance(arr, NDArray):
        if stype == "row_sparse":
            return row_sparse_array(arr, ctx=arr.ctx, dtype=arr.dtype)
        if stype == "csr":
            return csr_matrix(arr, ctx=arr.ctx, dtype=arr.dtype)
    raise MXNetError(f"cast_storage: unsupported target {stype}")


def dot(lhs, rhs, transpose_a=False):
    """Storage-aware dot: csr @ dense and csr.T @ dense run
    ``_sparse_dot_csr`` (differentiable in the csr's values and in
    ``rhs``); a row_sparse lhs is made dense; dense inputs run ``dot``."""
    from .. import nd as _nd
    if isinstance(lhs, CSRNDArray):
        if not isinstance(rhs, NDArray):
            raise MXNetError("sparse.dot: rhs must be a dense NDArray")
        return _nd._sparse_dot_csr(lhs.data, lhs.indptr, lhs.indices, rhs,
                                   transpose_a=transpose_a,
                                   num_cols=lhs.shape[1])
    if isinstance(lhs, RowSparseNDArray):
        return _nd.dot(lhs.tostype("default"), rhs, transpose_a=transpose_a)
    return _nd.dot(lhs, rhs, transpose_a=transpose_a)


def square_sum(rsp, axis=None, keepdims=False):
    """sum(x ** 2) of a row_sparse array over its stored rows (the lazy
    optimizers' helper)."""
    from .. import nd as _nd
    if not isinstance(rsp, RowSparseNDArray):
        raise MXNetError("square_sum expects a RowSparseNDArray")
    return _nd._square_sum_rs(rsp.data, rsp.indices, num_rows=rsp.shape[0],
                              axis=axis, keepdims=keepdims)


def sparse_retain(rsp, row_ids):
    """The stored rows of ``rsp`` listed in ``row_ids``.  The values go
    through the differentiable ``take`` (its backward scatters to the kept
    slots); the slots are chosen on the device."""
    from .. import nd as _nd
    if not isinstance(rsp, RowSparseNDArray):
        raise MXNetError("sparse_retain expects a RowSparseNDArray")
    idx = rsp.indices._data
    keep = torch.isin(idx, _ids(row_ids, idx.device)).nonzero().flatten()
    kept_vals = _nd.take(rsp.data, NDArray(keep, rsp.data._ctx), axis=0)
    return RowSparseNDArray(kept_vals, NDArray(idx[keep], rsp.indices._ctx),
                            rsp.shape, ctx=rsp.ctx, dtype=rsp.dtype)


def zeros(stype, shape, ctx=None, dtype=None):
    """An all-zero array of storage type ``stype``."""
    if stype == "default":
        return _dense_zeros(shape, ctx=ctx, dtype=dtype)
    dt = np.dtype(dtype) if dtype is not None else np.float32
    if stype == "row_sparse":
        return RowSparseNDArray(np.zeros((0,) + tuple(shape[1:]), dt),
                                np.zeros((0,), np.int64), shape, ctx, dtype)
    if stype == "csr":
        return CSRNDArray(np.zeros((0,), dt),
                          np.zeros(shape[0] + 1, np.int64),
                          np.zeros((0,), np.int64), shape, ctx, dtype)
    raise MXNetError(f"unknown stype {stype}")
