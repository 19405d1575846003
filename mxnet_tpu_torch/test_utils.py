"""Test utilities — the port of ``mxnet_tpu/test_utils.py`` (MXNet's
``python/mxnet/test_utils.py``): ``assert_almost_equal`` with tolerances
by dtype, ``check_numeric_gradient`` (central differences against
autograd), ``check_consistency`` (one computation on several contexts),
``default_context`` and the random array helpers.

``default_context()`` is ``gpu(0)``, or ``cpu(0)`` on a host with no card;
``check_consistency`` runs over ``[gpu(0), cpu(0)]`` there by default (the
reference's ``[cpu, tpu]``).  bfloat16 arrays, which numpy lacks, compare
as float32 at bfloat16's tolerances.
"""

from __future__ import annotations

import numpy as _np
import torch

from .base import MXNetError
from .context import cpu, gpu, num_gpus
from . import ndarray as nd
from .ndarray.ndarray import NDArray

__all__ = ["default_context", "set_default_context", "assert_almost_equal",
           "almost_equal", "same", "rand_ndarray", "rand_shape_2d",
           "rand_shape_3d", "rand_shape_nd", "check_numeric_gradient",
           "check_consistency", "default_rtols", "effective_dtype"]

_default_ctx = None


def default_context():
    """The context tests run on: the one set by
    :func:`set_default_context`, else ``gpu(0)``, else ``cpu(0)``."""
    if _default_ctx is not None:
        return _default_ctx
    return gpu(0) if num_gpus() > 0 else cpu(0)


def set_default_context(ctx):
    global _default_ctx
    _default_ctx = ctx


_RTOLS = {"float16": 1e-2, "bfloat16": 2e-2, "float32": 1e-4,
          "float64": 1e-6}
_ATOLS = {"float16": 1e-3, "bfloat16": 2e-2, "float32": 1e-5,
          "float64": 1e-8}


def effective_dtype(arr):
    """The dtype's name: ``"bfloat16"`` for a bfloat16 NDArray or tensor,
    numpy's name otherwise (a list or a scalar: numpy's for its array)."""
    dt = getattr(arr, "dtype", None)
    if dt is None:
        return _np.asarray(arr).dtype.name
    if dt == torch.bfloat16:
        return "bfloat16"
    if isinstance(dt, torch.dtype):
        return str(dt).replace("torch.", "")
    return _np.dtype(dt).name


def default_rtols(a=None, b=None):
    """(rtol, atol): the loosest of ``a``'s and ``b``'s dtypes."""
    cands = [x for x in (a, b) if x is not None]
    rtol = max((_RTOLS.get(effective_dtype(x), 1e-4) for x in cands),
               default=1e-4)
    atol = max((_ATOLS.get(effective_dtype(x), 1e-5) for x in cands),
               default=1e-5)
    return rtol, atol


def _to_np(x):
    if isinstance(x, NDArray):
        return x.asnumpy()
    if isinstance(x, torch.Tensor):
        t = x.detach()
        return (t.float() if t.dtype == torch.bfloat16 else t).cpu().numpy()
    return _np.asarray(x)


def _tolerances(a, b, rtol, atol):
    if rtol is None or atol is None:
        drtol, datol = default_rtols(a, b)
        rtol = rtol if rtol is not None else drtol
        atol = atol if atol is not None else datol
    return rtol, atol


def same(a, b):
    return _np.array_equal(_to_np(a), _to_np(b))


def almost_equal(a, b, rtol=None, atol=None, equal_nan=False):
    rtol, atol = _tolerances(a, b, rtol, atol)
    return _np.allclose(_to_np(a), _to_np(b), rtol=rtol, atol=atol,
                        equal_nan=equal_nan)


def assert_almost_equal(a, b, rtol=None, atol=None, names=("a", "b"),
                        equal_nan=False):
    rtol, atol = _tolerances(a, b, rtol, atol)
    an, bn = _to_np(a), _to_np(b)
    if not _np.allclose(an, bn, rtol=rtol, atol=atol, equal_nan=equal_nan):
        diff = _np.abs(an.astype(_np.float64) - bn.astype(_np.float64))
        rel = diff / (_np.abs(bn).astype(_np.float64) + atol)
        raise AssertionError(
            f"{names[0]} and {names[1]} differ: max abs {diff.max():.3g}, "
            f"max rel {rel.max():.3g} (rtol={rtol}, atol={atol})\n"
            f"{names[0]}: {an.ravel()[:8]}...\n{names[1]}: "
            f"{bn.ravel()[:8]}...")


def rand_shape_2d(dim0=10, dim1=10):
    return (_np.random.randint(1, dim0 + 1), _np.random.randint(1, dim1 + 1))


def rand_shape_3d(dim0=10, dim1=10, dim2=10):
    return (_np.random.randint(1, dim0 + 1), _np.random.randint(1, dim1 + 1),
            _np.random.randint(1, dim2 + 1))


def rand_shape_nd(num_dim, dim=10):
    return tuple(_np.random.randint(1, dim + 1, size=num_dim))


def rand_ndarray(shape, stype="default", density=None,  # noqa: ARG001
                 dtype=_np.float32, ctx=None):
    """Uniform values in [-1, 1); sparse storage types raise."""
    if stype != "default":
        raise MXNetError(f"rand_ndarray(stype={stype!r}) needs sparse "
                         "storage, which is not yet ported to "
                         "mxnet_tpu_torch (ROADMAP A.10)")
    return nd.array(_np.random.uniform(-1, 1, shape).astype(dtype),
                    ctx=ctx if ctx is not None else default_context())


def check_numeric_gradient(f, inputs, eps=1e-3, rtol=1e-2, atol=1e-3,
                           ctx=None):
    """Central differences of ``sum(f(*inputs))`` in float64 against its
    autograd gradient, for every input (numpy arrays go to ``ctx``,
    default :func:`default_context`)."""
    from . import autograd
    ctx = ctx if ctx is not None else default_context()
    ins = [x if isinstance(x, NDArray) else nd.array(x, ctx=ctx)
           for x in inputs]
    for x in ins:
        x.attach_grad()
    with autograd.record():
        y = f(*ins)
        if y.size != 1:
            y = y.sum()
    y.backward()
    for i, x in enumerate(ins):
        xn = x.asnumpy().astype(_np.float64)
        num = _np.zeros_like(xn)
        for idx in _np.ndindex(*xn.shape):
            vals = []
            for sign in (1, -1):
                xp = xn.copy()
                xp[idx] += sign * eps
                args = [nd.array(xp, ctx=x.context, dtype=x.dtype)
                        if j == i else ins[j] for j in range(len(ins))]
                vals.append(float(f(*args).sum().asnumpy()))
            num[idx] = (vals[0] - vals[1]) / (2 * eps)
        assert_almost_equal(x.grad.asnumpy(), num, rtol=rtol, atol=atol,
                            names=(f"autograd[{i}]", f"numeric[{i}]"))


def check_consistency(f, inputs_np, ctx_list=None, rtol=None, atol=None):
    """``f`` on the same inputs on every context of ``ctx_list`` (default
    ``[gpu(0), cpu(0)]`` with a card, ``[cpu(0)]`` without), each output
    held to the first context's; returns the outputs as numpy."""
    if ctx_list is None:
        ctx_list = ([gpu(0)] if num_gpus() > 0 else []) + [cpu(0)]
    outs, raw = [], []
    for ctx in ctx_list:
        ins = [nd.array(x, ctx=ctx) for x in inputs_np]
        out = f(*ins)
        raw.append(out)
        outs.append(_to_np(out))
    for i in range(1, len(outs)):
        r, a = _tolerances(raw[0], raw[i], rtol, atol)
        assert_almost_equal(outs[0], outs[i], rtol=r, atol=a,
                            names=(str(ctx_list[0]), str(ctx_list[i])))
    return outs
