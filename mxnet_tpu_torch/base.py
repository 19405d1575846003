"""Base utilities of the PyTorch/CUDA port: the error type every API raises.

Counterpart of ``mxnet_tpu/base.py``.  Only the semantic surface the
serving slice needs is kept: ``MXNetError`` (user ``except MXNetError``
code keeps working across both packages).
"""

from __future__ import annotations

__all__ = ["MXNetError"]


class MXNetError(RuntimeError):
    """Default error type for all mxnet_tpu_torch API failures."""
