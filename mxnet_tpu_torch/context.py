"""Device context: ``mx.gpu(i)`` / ``mx.cpu()`` as ``Context`` objects.

Counterpart of ``mxnet_tpu/context.py``: a ``Context(kind, dev_id)`` value
object with ``==``/hash on both fields, and a thread-local current context
(``with mx.cpu(): ...``) consulted by every array-creating call that does
not pass ``ctx=``.

One difference from the reference: the default context is ``gpu(0)``, the
CUDA card, not ``cpu(0)``.  The CPU is used only when a caller asks for it
(``ctx=mx.cpu()``, ``with mx.cpu():`` or ``device="cpu"``; the CPU tests
do), and with no card and no explicit CPU request :func:`resolve_device`
raises instead of silently running on the host.
"""

from __future__ import annotations

import threading

import torch

from .base import MXNetError

__all__ = ["Context", "cpu", "gpu", "current_context", "resolve_device",
           "context_of", "num_gpus"]


class Context:
    """A device: ``Context("gpu", i)`` is CUDA card i, ``Context("cpu")``
    the host.  ``with ctx:`` makes it the current context."""

    devtype2num = {"cpu": 1, "gpu": 2}
    _default = threading.local()

    def __init__(self, device_type, device_id=0):
        if isinstance(device_type, Context):
            device_type, device_id = device_type.device_type, \
                device_type.device_id
        if device_type not in self.devtype2num:
            raise MXNetError(f"unknown device type {device_type!r}; expected "
                             f"one of {sorted(self.devtype2num)}")
        self.device_type = device_type
        self.device_id = int(device_id)
        self._old = []

    def torch_device(self):
        """The ``torch.device`` this context denotes."""
        if self.device_type == "cpu":
            return torch.device("cpu")
        return torch.device("cuda", self.device_id)

    def __eq__(self, other):
        return (isinstance(other, Context)
                and self.device_type == other.device_type
                and self.device_id == other.device_id)

    def __hash__(self):
        return hash((self.device_type, self.device_id))

    def __repr__(self):
        return f"{self.device_type}({self.device_id})"

    __str__ = __repr__

    def __enter__(self):
        self._old.append(current_context())
        Context._default.value = self
        return self

    def __exit__(self, *exc):
        Context._default.value = self._old.pop()
        return False


def gpu(device_id=0):
    """The CUDA card ``device_id``."""
    return Context("gpu", device_id)


def cpu(device_id=0):
    """The host (the id is kept for reference-API parity)."""
    return Context("cpu", device_id)


def num_gpus():
    """The number of CUDA cards this process sees."""
    return torch.cuda.device_count()


def current_context():
    """The innermost ``with ctx:`` context of this thread, else ``gpu(0)``."""
    return getattr(Context._default, "value", None) or gpu(0)


def context_of(device):
    """The ``Context`` of a ``torch.device``."""
    if device.type == "cpu":
        return cpu()
    return gpu(device.index or 0)


def resolve_device(device=None):
    """``None`` -> the current context's device (the CUDA card unless a
    ``with mx.cpu():`` scope is active); a ``Context``, ``torch.device`` or
    string -> that ``torch.device``.  Raises MXNetError when a CUDA device
    is wanted and none is present."""
    if device is None:
        device = current_context()
    dev = device.torch_device() if isinstance(device, Context) \
        else torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise MXNetError(
            "no CUDA device is available; pass ctx=mx.cpu() (or "
            "device='cpu') to run on the host explicitly")
    return dev
