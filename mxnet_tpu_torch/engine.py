"""Execution-engine facade — the port of ``mxnet_tpu/engine.py``.

MXNet's C++ dependency engine orders work per variable on worker threads.
On the card, torch's CUDA stream is that engine: every op returns at once
and the stream runs them in order.  What this module keeps is MXNet's
contract:

- ``MXNET_ENGINE_TYPE=NaiveEngine`` synchronizes after every op that
  ``mx.nd`` dispatches, so an asynchronous CUDA error raises at the op
  that caused it (the reference's debugging escape hatch);
- ``waitall()`` waits until every CUDA device the port has used is idle;
- ``bulk()`` is a scope that does nothing and ``set_bulk_size`` returns its
  argument: a captured ``TrainStep`` is the port's bulking.

Nothing synchronizes while a CUDA graph is being captured (a
synchronisation would break the capture), as the reference skips jit
tracers.
"""

from __future__ import annotations

import contextlib

import torch

from . import config
from .context import used_cuda_devices

__all__ = ["is_naive", "set_engine_type", "on_dispatch", "waitall", "bulk",
           "set_bulk_size", "capturing"]

_engine_type = None


def _current_type():
    global _engine_type
    if _engine_type is None:
        _engine_type = config.get("MXNET_ENGINE_TYPE")
    return _engine_type


def set_engine_type(name):
    """Override ``MXNET_ENGINE_TYPE`` at run time (MXNet reads it from the
    environment only)."""
    global _engine_type
    _engine_type = name


def is_naive():
    return _current_type() == "NaiveEngine"


def capturing():
    """Whether the current CUDA stream is capturing a graph (never before
    CUDA is initialized)."""
    return torch.cuda.is_initialized() and \
        torch.cuda.is_current_stream_capturing()


def on_dispatch(outputs):
    """Called by the op dispatcher with each op's output tensors: under
    NaiveEngine it synchronizes the outputs' CUDA device."""
    if not is_naive() or capturing():
        return
    for t in outputs:
        if isinstance(t, torch.Tensor) and t.is_cuda:
            torch.cuda.synchronize(t.device)
            return


def waitall():
    """``Engine::WaitForAll``: block until the current CUDA device and every
    one the port has used is idle (nothing to wait for on the CPU).  A card
    the port never touched is left alone: synchronizing it would make a
    CUDA context there."""
    if not torch.cuda.is_initialized():
        return
    for i in sorted(used_cuda_devices() | {torch.cuda.current_device()}):
        torch.cuda.synchronize(i)


@contextlib.contextmanager
def bulk(size):  # noqa: ARG001 - accepted as in MXNet
    """``mxnet.engine.bulk``: a scope that changes nothing."""
    yield


def set_bulk_size(size):
    """MXNet returns the previous bulk size; there is none to keep."""
    return size
