"""Reductions and ordering — the port of ``mxnet_tpu/ops/reduce.py``
(``sum``, ``mean``, ``max``, ``min``, ``argmax``, ``sort``, ``topk`` ...)
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


def _arg(f):
    def impl(x, axis=None, keepdims=False):
        r = f(x if axis is not None else x.reshape(-1),
              dim=0 if axis is None else axis, keepdim=keepdims)
        return r.to(torch.float32)
    return impl


register("argmax", differentiable=False)(_arg(torch.argmax))
register("argmin", differentiable=False)(_arg(torch.argmin))


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
