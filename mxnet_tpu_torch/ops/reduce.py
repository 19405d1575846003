"""Reductions and ordering — the port of ``mxnet_tpu/ops/reduce.py``
(``sum``, ``mean``, ``prod``, ``nansum``, ``logsumexp``, ``norm``,
``argmax``, ``sort``, ``topk``, ``cumsum``, ``moments``, ``histogram`` ...)
with MXNet's axis semantics: ``axis=None`` reduces every axis, and
``exclude=True`` reduces every axis except the given ones.  Index results
are float32, as the reference's are.
"""

from __future__ import annotations

import torch

from .registry import register


def _axes(x, axis, exclude=False):
    if axis is None:
        return tuple(range(x.ndim))
    if isinstance(axis, int):
        axis = (axis,)
    axis = tuple(a % x.ndim for a in axis)
    if exclude:
        axis = tuple(a for a in range(x.ndim) if a not in axis)
    return axis


def _reduce(name, f):
    def impl(x, axis=None, keepdims=False, exclude=False):
        axes = _axes(x, axis, exclude)
        return f(x, axes, keepdims) if axes else x
    register(name)(impl)


_reduce("sum", lambda x, ax, kd: torch.sum(x, dim=ax, keepdim=kd))
_reduce("mean", lambda x, ax, kd: torch.mean(
    x if x.is_floating_point() else x.float(), dim=ax, keepdim=kd))
_reduce("max", lambda x, ax, kd: torch.amax(x, dim=ax, keepdim=kd))
_reduce("min", lambda x, ax, kd: torch.amin(x, dim=ax, keepdim=kd))
_reduce("nansum", lambda x, ax, kd: torch.nansum(x, dim=ax, keepdim=kd))
_reduce("sum_axis", lambda x, ax, kd: torch.sum(x, dim=ax, keepdim=kd))
_reduce("logsumexp", lambda x, ax, kd: torch.logsumexp(x, dim=ax,
                                                        keepdim=kd))


def _prod(x, axes, keepdims):
    """torch.prod takes one axis: reduce the given ones last first."""
    for a in sorted(axes, reverse=True):
        x = torch.prod(x, dim=a, keepdim=keepdims)
    return x


_reduce("prod", _prod)
_reduce("nanprod", lambda x, ax, kd: _prod(
    torch.where(torch.isnan(x), torch.ones_like(x), x), ax, kd))


@register("norm")
def _norm(x, ord=2, axis=None, keepdims=False):  # noqa: A002
    """The L1 norm for ``ord=1``, else the L2 norm, over ``axis``."""
    axes = _axes(x, axis)
    if ord == 1:
        return torch.sum(x.abs(), dim=axes, keepdim=keepdims)
    return torch.sqrt(torch.sum(x * x, dim=axes, keepdim=keepdims))


def _arg(f):
    def impl(x, axis=None, keepdims=False):
        r = f(x if axis is not None else x.reshape(-1),
              dim=0 if axis is None else axis, keepdim=keepdims)
        return r.to(torch.float32)
    return impl


register("argmax", differentiable=False)(_arg(torch.argmax))
register("argmin", differentiable=False)(_arg(torch.argmin))


@register("argmax_channel", differentiable=False)
def _argmax_channel(x):
    return torch.argmax(x, dim=1).to(torch.float32)


@register("sort")
def _sort(x, axis=-1, is_ascend=True):
    return torch.sort(x, dim=axis, descending=not is_ascend).values


@register("argsort", differentiable=False)
def _argsort(x, axis=-1, is_ascend=True):
    return torch.sort(x, dim=axis, descending=not is_ascend,
                      stable=True).indices.to(torch.float32)


@register("topk", differentiable=False, num_outputs=-1)
def _topk(x, axis=-1, k=1, ret_typ="indices", is_ascend=False):
    vals, idx = torch.topk(x, k, dim=axis, largest=not is_ascend)
    idx = idx.to(torch.float32)
    if ret_typ == "value":
        return vals
    if ret_typ == "both":
        return [vals, idx]
    return idx


def _flat_axis(x, axis):
    return (x.reshape(-1), 0) if axis is None else (x, axis)


@register("cumsum")
def _cumsum(x, axis=None, dtype=None):
    from ..base import torch_dtype
    x, axis = _flat_axis(x, axis)
    r = torch.cumsum(x, dim=axis)
    return r.to(torch_dtype(dtype)) if dtype else r


@register("cumprod")
def _cumprod(x, axis=None):
    x, axis = _flat_axis(x, axis)
    return torch.cumprod(x, dim=axis)


@register("moments", num_outputs=2)
def _moments(x, axes=None, keepdims=False):
    """Mean and biased variance over ``axes`` (every axis when None)."""
    ax = _axes(x, axes)
    var, mean = torch.var_mean(x, dim=ax, unbiased=False, keepdim=keepdims)
    return mean, var


@register("histogram", differentiable=False, num_outputs=2)
def _histogram(x, bin_cnt=10, range=None):  # noqa: A002
    """Counts of ``x`` (in its dtype, as the reference's) in ``bin_cnt``
    equal bins over ``range`` (the data's min and max when None; the last
    bin is closed) and the bin edges, numpy's rule.  Without a ``range`` the edges are read back to the host
    first, a sync on the card."""
    flat = x.reshape(-1)
    if range is None:
        lo, hi = flat.min().item(), flat.max().item()
    else:
        lo, hi = range
    if lo == hi:
        lo, hi = lo - 0.5, hi + 0.5
    edges = torch.linspace(lo, hi, bin_cnt + 1, dtype=x.dtype,
                           device=x.device)
    idx = torch.searchsorted(edges, flat, right=True)
    idx = torch.where(flat == edges[-1], idx - 1, idx) - 1
    inside = (idx >= 0) & (idx < bin_cnt)
    counts = torch.zeros(bin_cnt, dtype=x.dtype, device=x.device)
    counts.index_add_(0, idx.clamp(0, bin_cnt - 1), inside.to(x.dtype))
    return counts, edges
