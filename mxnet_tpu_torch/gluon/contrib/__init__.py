"""gluon.contrib — the port of ``mxnet_tpu/gluon/contrib/``: the
``estimator``, the contributed layers of ``nn`` (``SyncBatchNorm``,
``Identity``, ``Concurrent``, ``HybridConcurrent``) and ``SparseMoE``."""

from . import estimator  # noqa: F401
from . import nn  # noqa: F401
from .moe import SparseMoE  # noqa: F401
from .nn import Concurrent, HybridConcurrent, Identity, SyncBatchNorm  # noqa: F401
