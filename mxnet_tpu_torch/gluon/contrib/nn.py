"""gluon.contrib.nn — the port of ``mxnet_tpu/gluon/contrib/nn.py``:
``SyncBatchNorm``, ``Identity`` and ``Concurrent`` (= ``HybridConcurrent``).

``SyncBatchNorm`` is a ``BatchNorm`` over axis 1 that records
``num_devices``.  On one device that is all synchronized statistics are;
the cross-device reduction comes with the port's multi-GPU data
parallelism.
"""

from __future__ import annotations

from ..block import HybridBlock
from ..nn.basic_layers import BatchNorm, HybridSequential

__all__ = ["SyncBatchNorm", "Identity", "Concurrent", "HybridConcurrent"]


class SyncBatchNorm(BatchNorm):
    """BatchNorm with axis 1; ``num_devices`` is accepted and recorded."""

    def __init__(self, in_channels=0, num_devices=None, momentum=0.9,
                 epsilon=1e-5, center=True, scale=True,
                 use_global_stats=False, beta_initializer="zeros",
                 gamma_initializer="ones",
                 running_mean_initializer="zeros",
                 running_variance_initializer="ones", **kwargs):
        super().__init__(axis=1, momentum=momentum, epsilon=epsilon,
                         center=center, scale=scale,
                         use_global_stats=use_global_stats,
                         beta_initializer=beta_initializer,
                         gamma_initializer=gamma_initializer,
                         running_mean_initializer=running_mean_initializer,
                         running_variance_initializer=(
                             running_variance_initializer),
                         in_channels=in_channels, **kwargs)
        self._num_devices = num_devices


class Identity(HybridBlock):
    """Returns its input."""

    def hybrid_forward(self, F, x):  # noqa: ARG002
        return x


class Concurrent(HybridSequential):
    """Runs every child on the same input and concatenates their outputs
    along ``axis``."""

    def __init__(self, axis=-1, **kwargs):
        super().__init__(**kwargs)
        self._axis = axis

    def hybrid_forward(self, F, x):
        return F.concat(*[child(x) for child in self._children.values()],
                        dim=self._axis)


HybridConcurrent = Concurrent
