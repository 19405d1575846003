"""Stateful random numbers: ``mx.random.seed`` over one ``torch.Generator``
per device.

Counterpart of ``mxnet_tpu/random.py``.  The reference hides a per-context
JAX key behind MXNet's stateful API and splits it for every draw; the port
keeps one explicit ``torch.Generator`` per device instead, which ops that
draw (``Dropout``, the initializers) take from :func:`generator`.  Each
device's stream is offset from the seed by a stable hash of the device, as
the reference's per-device generators are.  Parity with the reference is
distribution-level, not bitwise.  The package binds the shorthands
``uniform``, ``normal``, ``randn``, ``randint``, ``multinomial`` and
``shuffle`` here to the generated ``mx.nd.random`` functions (the
samplers of ``ops/random_ops.py``), as the reference does.

Two helpers serve code that must replay draws: :func:`get_state` /
:func:`set_state` save and restore a device's generator (two runs from one
state draw the same masks), and :func:`register_with_graph` registers the
generators with a CUDA graph being captured, so that each replay of the
graph advances them and draws new numbers instead of repeating the
captured ones.  A generator cannot be rewound while a capture is under way
(torch refuses to read or clone its state then): ``get_state`` raises
``MXNetError`` there.
"""

from __future__ import annotations

import threading
import zlib

import numpy as np
import torch

from .base import MXNetError
from .context import Context, context_of, resolve_device

__all__ = ["seed", "generator", "get_state", "set_state",
           "register_with_graph"]

_state = threading.local()
_DEFAULT_SEED = 0


def _generators():
    if not hasattr(_state, "gens"):
        _state.gens = {}
        _state.seed = _DEFAULT_SEED
    return _state.gens


def _offset(ctx):
    return zlib.crc32(f"{ctx.device_type}:{ctx.device_id}".encode()) & 0xFFFF


def generator(ctx=None):
    """The generator of ``ctx`` (a ``Context`` or ``torch.device``; None is
    the current context), created and seeded on first use."""
    if not isinstance(ctx, Context):
        ctx = context_of(resolve_device(ctx))
    gens = _generators()
    gen = gens.get(ctx)
    if gen is None:
        gen = torch.Generator(device=ctx.torch_device())
        gen.manual_seed(_state.seed + _offset(ctx))
        gens[ctx] = gen
    return gen


def seed(seed_state, ctx="all"):
    """Reseed the generators of every device (``ctx="all"``) or of one."""
    if not isinstance(seed_state, (int, np.integer)):
        raise ValueError("seed_state must be an integer")
    gens = _generators()
    if ctx == "all":
        _state.seed = int(seed_state)
        gens.clear()
    else:
        ctx = Context(ctx)
        gen = torch.Generator(device=ctx.torch_device())
        gen.manual_seed(int(seed_state) + _offset(ctx))
        gens[ctx] = gen


def _capturing(gen):
    return gen.device.type == "cuda" and \
        torch.cuda.is_current_stream_capturing()


def get_state(ctx=None):
    """A copy of the state of ``ctx``'s generator (see :func:`generator`),
    for :func:`set_state`."""
    gen = generator(ctx)
    if _capturing(gen):
        raise MXNetError("random.get_state: a generator cannot be saved "
                         "while a CUDA graph is being captured")
    return gen.get_state()


def set_state(state, ctx=None):
    """Put ``ctx``'s generator back to ``state`` (from :func:`get_state`):
    the draws that follow repeat those that followed the save."""
    gen = generator(ctx)
    if _capturing(gen):
        raise MXNetError("random.set_state: a generator cannot be restored "
                         "while a CUDA graph is being captured")
    gen.set_state(state)


def register_with_graph(graph, device):
    """Register ``device``'s generator with ``graph`` (a
    ``torch.cuda.CUDAGraph`` about to be captured): every replay then
    draws the numbers that follow the previous replay's, as eager calls
    would, instead of the captured ones again."""
    graph.register_generator_state(generator(device))
