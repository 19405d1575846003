"""mx.np.random — NumPy's stateful sampling names over the port's
per-device ``torch.Generator`` (``mx.random.generator``, reseeded by
``mx.random.seed`` or :func:`seed`).

Draws are made on the device of ``ctx=`` / ``device=`` (default the current
context) with that device's generator passed explicitly; floats are
float32 and integers int64 unless ``dtype`` says otherwise.  The stream is
the port's, so values differ from the reference's (JAX keys) and from
NumPy's; distributions, shapes and dtypes agree.  Not registry ops, as in
the reference.
"""

from __future__ import annotations

import numpy as _onp
import torch as _torch

from .. import random as _mxr
from ..base import MXNetError, torch_dtype
from ..context import Context, resolve_device
from ..ndarray.ndarray import NDArray, _placed

__all__ = ["uniform", "normal", "randint", "rand", "randn", "choice",
           "shuffle", "seed"]


def _size(size):
    if size is None:
        return ()
    return (int(size),) if isinstance(size, (int, _onp.integer)) \
        else tuple(int(s) for s in size)


def _where(ctx, device, *arrays):
    """(torch device, context label) of a draw."""
    for a in arrays:
        if isinstance(a, NDArray):
            return a._data.device, a._ctx
        if isinstance(a, _torch.Tensor):
            return a.device, None
    c = ctx if ctx is not None else device
    dev = resolve_device(c)
    return dev, c if isinstance(c, Context) else None


def _param(v, dev, dt):
    if isinstance(v, NDArray):
        v = v._data
    if isinstance(v, _torch.Tensor):
        return v.to(dev, dt)
    if isinstance(v, (int, float, _onp.number)):
        # a number is written by a fill: no copy from the host
        return _torch.full((), v.item() if isinstance(v, _onp.number)
                           else v, dtype=dt, device=dev)
    return _torch.as_tensor(_onp.asarray(v), device=dev).to(dt)


def _out(t, label, bare):
    return t if bare else _placed(t, label)


def _bare(*arrays):
    return any(isinstance(a, _torch.Tensor) for a in arrays) and not any(
        isinstance(a, NDArray) for a in arrays)


def uniform(low=0.0, high=1.0, size=None, dtype=None, ctx=None, device=None):
    dev, label = _where(ctx, device, low, high)
    dt = torch_dtype(dtype) if dtype is not None else _torch.float32
    lo, hi = _param(low, dev, dt), _param(high, dev, dt)
    shape = _size(size) if size is not None else _torch.broadcast_shapes(
        lo.shape, hi.shape)
    u = _torch.rand(shape, generator=_mxr.generator(dev), device=dev,
                    dtype=dt)
    return _out(lo + (hi - lo) * u, label, _bare(low, high))


def normal(loc=0.0, scale=1.0, size=None, dtype=None, ctx=None, device=None):
    dev, label = _where(ctx, device, loc, scale)
    dt = torch_dtype(dtype) if dtype is not None else _torch.float32
    mu, sd = _param(loc, dev, dt), _param(scale, dev, dt)
    shape = _size(size) if size is not None else _torch.broadcast_shapes(
        mu.shape, sd.shape)
    z = _torch.randn(shape, generator=_mxr.generator(dev), device=dev,
                     dtype=dt)
    return _out(mu + sd * z, label, _bare(loc, scale))


def randint(low, high=None, size=None, dtype=None, ctx=None, device=None):
    if high is None:
        low, high = 0, low
    dev, label = _where(ctx, device)
    dt = torch_dtype(dtype) if dtype is not None else _torch.int64
    t = _torch.randint(int(low), int(high), _size(size),
                       generator=_mxr.generator(dev), device=dev,
                       dtype=_torch.int64)
    return _out(t.to(dt), label, False)


def rand(*dims, ctx=None, device=None):
    return uniform(0.0, 1.0, size=dims, ctx=ctx, device=device)


def randn(*dims, ctx=None, device=None):
    return normal(0.0, 1.0, size=dims, ctx=ctx, device=device)


def choice(a, size=None, replace=True, p=None, ctx=None, device=None):
    """Samples of ``a`` (an array, or ``arange(a)`` for an int), uniform or
    with probabilities ``p``; without replacement each index once."""
    dev, label = _where(ctx, device, a, p)
    gen = _mxr.generator(dev)
    if isinstance(a, (int, _onp.integer)):
        pool = None
        n = int(a)
    else:
        pool = a._data if isinstance(a, NDArray) else (
            a if isinstance(a, _torch.Tensor) else
            _torch.as_tensor(_onp.asarray(a), device=dev))
        n = pool.shape[0]
    shape = _size(size)
    k = int(_onp.prod(shape)) if shape else 1
    if not replace and k > n:
        raise MXNetError("choice: cannot take a larger sample than the "
                         "population without replacement")
    if p is not None:
        w = _param(p, dev, _torch.float64)
        idx = _torch.multinomial(w, k, replacement=replace, generator=gen)
    elif replace:
        idx = _torch.randint(0, n, (k,), generator=gen, device=dev)
    else:
        idx = _torch.randperm(n, generator=gen, device=dev)[:k]
    idx = idx.reshape(shape)
    out = idx if pool is None else pool[idx]
    return _out(out, label, _bare(a, p))


def shuffle(x):
    """Permute ``x`` along its first axis, in place."""
    t = x._data if isinstance(x, NDArray) else x
    perm = _torch.randperm(t.shape[0], generator=_mxr.generator(t.device),
                           device=t.device)
    with _torch.no_grad():
        t.copy_(t[perm])


def seed(s):
    """Reseed every device's generator (``mx.random.seed``)."""
    _mxr.seed(s)
