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
"""

from __future__ import annotations

import threading
import zlib

import numpy as np
import torch

from .context import Context, context_of, resolve_device

__all__ = ["seed", "generator"]

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
