"""Base utilities of the PyTorch/CUDA port: the error type every API raises
and the dtype conversions between the reference's numpy names and torch.

Counterpart of ``mxnet_tpu/base.py``.  ``MXNetError`` keeps user
``except MXNetError`` code working across both packages; ``mx_real_t``
(float32) is MXNet's default dtype.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["MXNetError", "NotSupportedForSparseNDArray", "mx_real_t",
           "numeric_types", "integer_types", "string_types", "torch_dtype",
           "numpy_dtype"]

mx_real_t = np.float32
string_types = (str,)
integer_types = (int, np.integer)
numeric_types = (float, int, np.generic)


class MXNetError(RuntimeError):
    """Default error type for all mxnet_tpu_torch API failures."""


class NotSupportedForSparseNDArray(MXNetError):
    """A function that a sparse array does not support."""

    def __init__(self, function, alias, *args):
        argstr = ", ".join(str(a) for a in args)
        super().__init__(
            f"Function {getattr(function, '__name__', function)} "
            f"(alias {alias}) with arguments ({argstr}) is not supported "
            "for SparseNDArray")


def torch_dtype(dtype):
    """A torch dtype from a torch dtype, a numpy dtype or type, or a name
    (``"float32"``, ``"bfloat16"``); ``None`` is MXNet's float32."""
    if isinstance(dtype, torch.dtype):
        return dtype
    if dtype is None:
        return torch.float32
    if str(dtype) == "bfloat16":
        return torch.bfloat16
    return torch.from_numpy(np.empty(0, np.dtype(dtype))).dtype


def numpy_dtype(dtype):
    """The numpy dtype of a torch dtype, as the reference reports dtypes;
    bfloat16, which numpy lacks, stays ``torch.bfloat16``."""
    if dtype == torch.bfloat16:
        return dtype
    return torch.empty(0, dtype=dtype).numpy().dtype
