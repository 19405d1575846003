"""mx.rtc — user kernels compiled at run time (the port of
``mxnet_tpu/rtc.py``).

MXNet's ``CudaModule`` compiles user CUDA C source with NVRTC.  The port
does not compile user source: its own kernels are built ahead of the run
from ``kernels/csrc`` (``kernels/_build.py``), and a user's op is written
as a ``mx.operator.CustomOp``.  The module imports, and constructing either
class raises ``MXNetError``, as the reference's does.
"""

from __future__ import annotations

from .base import MXNetError

__all__ = ["CudaModule", "CudaKernel"]

_MSG = ("mx.rtc does not compile user CUDA source in mxnet_tpu_torch: "
        "write the op as mx.operator.CustomOp over torch tensors")


class CudaModule:
    def __init__(self, *args, **kwargs):  # noqa: ARG002
        raise MXNetError(_MSG)


class CudaKernel:
    def __init__(self, *args, **kwargs):  # noqa: ARG002
        raise MXNetError(_MSG)
