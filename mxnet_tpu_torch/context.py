"""Device handles: ``mx.gpu(i)`` / ``mx.cpu()`` as ``torch.device``.

Counterpart of ``mxnet_tpu/context.py``.  The port has no context stack:
every entry point takes an explicit ``device`` and defaults to the CUDA
card.  The CPU is used only when a caller asks for it (the CPU tests do);
with no card and no explicit CPU request, :func:`resolve_device` raises
instead of silently running on the host.
"""

from __future__ import annotations

import torch

from .base import MXNetError

__all__ = ["cpu", "gpu", "resolve_device"]


def gpu(device_id=0):
    """The CUDA card ``device_id``."""
    return torch.device("cuda", int(device_id))


def cpu(device_id=0):
    """The host (the id is accepted for reference-API parity and ignored)."""
    del device_id
    return torch.device("cpu")


def resolve_device(device=None):
    """``None`` -> the default CUDA card; anything else -> ``torch.device``.
    Raises MXNetError when a CUDA device is wanted and none is present."""
    dev = gpu() if device is None else torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise MXNetError(
            "no CUDA device is available; pass device='cpu' to run on the "
            "host explicitly")
    return dev
