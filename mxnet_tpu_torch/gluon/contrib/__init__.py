"""gluon.contrib — the port's ``estimator``.  The reference's contrib
layers (SyncBatchNorm, Concurrent, ...) and MoE are not yet ported."""

from . import estimator  # noqa: F401
