"""Matrix, shape and indexing operators — the port of
``mxnet_tpu/ops/matrix.py``: ``dot``, ``batch_dot``, ``reshape`` with
MXNet's special codes, ``transpose``, ``expand_dims``, ``slice_axis``,
``concat``, ``take``, ``Embedding``, ``pick``, ``reshape_like``, ``pad``
and the few shape ops the NDArray methods use.  Float32 products run in
full float32 (the package turns TF32 off), as the reference's "highest"
precision.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .registry import register

__all__ = ["infer_reshape"]


@register("dot")
def _dot(lhs, rhs, transpose_a=False, transpose_b=False):
    """2-D product; for N-D inputs, contracts lhs's last axis with rhs's
    first (``tensordot`` with one axis)."""
    a = lhs.movedim(0, -1) if transpose_a else lhs
    b = rhs.movedim(-1, 0) if transpose_b else rhs
    if a.ndim <= 2 and b.ndim <= 2:
        return torch.matmul(a, b)
    return torch.tensordot(a, b, dims=1)


@register("batch_dot")
def _batch_dot(lhs, rhs, transpose_a=False, transpose_b=False):
    a = lhs.transpose(-1, -2) if transpose_a else lhs
    b = rhs.transpose(-1, -2) if transpose_b else rhs
    return torch.matmul(a, b)


def infer_reshape(old_shape, new_shape):
    """MXNet's reshape codes: 0 copies a dim, -1 infers one, -2 copies the
    rest, -3 merges two, -4 splits one into the next two."""
    if all(isinstance(d, int) and d > 0 for d in new_shape):
        return tuple(new_shape)
    out, src, i, j = [], list(old_shape), 0, 0
    ns = list(new_shape)
    while j < len(ns):
        d = ns[j]
        if d == 0:
            out.append(src[i])
            i += 1
        elif d == -1:
            out.append(-1)
            i += 1
        elif d == -2:
            out.extend(src[i:])
            i = len(src)
        elif d == -3:
            out.append(src[i] * src[i + 1])
            i += 2
        elif d == -4:
            a, b = ns[j + 1], ns[j + 2]
            if a == -1:
                a = src[i] // b
            if b == -1:
                b = src[i] // a
            out.extend([a, b])
            i += 1
            j += 2
        else:
            out.append(d)
            i += 1
        j += 1
    if -1 in out:
        known = 1
        for d in out:
            if d != -1:
                known *= d
        total = 1
        for d in old_shape:
            total *= d
        out[out.index(-1)] = total // max(known, 1)
    return tuple(out)


@register("reshape")
def _reshape(x, shape=None, reverse=False):  # noqa: ARG001
    return x.reshape(infer_reshape(x.shape, tuple(shape)))


@register("reshape_like")
def _reshape_like(lhs, rhs, lhs_begin=None, lhs_end=None, rhs_begin=None,
                  rhs_end=None):
    """Reshape lhs dims [lhs_begin, lhs_end) to rhs dims [rhs_begin,
    rhs_end); the whole of rhs's shape when no range is given."""
    if lhs_begin is None and lhs_end is None and rhs_begin is None \
            and rhs_end is None:
        return lhs.reshape(rhs.shape)
    lb = 0 if lhs_begin is None else int(lhs_begin)
    le = lhs.ndim if lhs_end is None else int(lhs_end)
    rb = 0 if rhs_begin is None else int(rhs_begin)
    re_ = rhs.ndim if rhs_end is None else int(rhs_end)
    return lhs.reshape(tuple(lhs.shape[:lb]) + tuple(rhs.shape[rb:re_])
                       + tuple(lhs.shape[le:]))


@register("transpose")
def _transpose(x, axes=None):
    return x.permute(*(axes if axes else range(x.ndim - 1, -1, -1)))


@register("swapaxes")
def _swapaxes(x, dim1=0, dim2=0):
    return x.transpose(dim1, dim2)


@register("expand_dims")
def _expand_dims(x, axis=0):
    return x.unsqueeze(axis)


@register("flatten")
def _flatten(x):
    return x.reshape(x.shape[0], -1)


@register("flip")
def _flip(x, axis=0):
    return torch.flip(x, (axis,) if isinstance(axis, int) else tuple(axis))


@register("tile")
def _tile(x, reps=()):
    return torch.tile(x, tuple(reps))


@register("slice")
def _slice(x, begin=None, end=None, step=None):
    return x[tuple(slice(b, e, step[i] if step else None)
                   for i, (b, e) in enumerate(zip(begin, end)))]


@register("slice_axis")
def _slice_axis(x, axis=0, begin=0, end=None):
    return x[(slice(None),) * (axis % x.ndim) + (slice(begin, end),)]


@register("concat")
def _concat(*args, dim=1):
    return torch.cat(args, dim=dim)


@register("stack")
def _stack(*args, axis=0):
    return torch.stack(args, dim=axis)


@register("split", num_outputs=-1)
def _split(x, num_outputs=1, axis=1, squeeze_axis=False):
    parts = torch.chunk(x, num_outputs, dim=axis)
    if squeeze_axis:
        parts = [p.squeeze(axis) for p in parts]
    return list(parts) if len(parts) > 1 else parts[0]


@register("take")
def _take(a, indices, axis=0, mode="clip"):
    n = a.shape[axis]
    idx = indices.long()
    idx = idx.remainder(n) if mode == "wrap" else idx.clamp(0, n - 1)
    out = torch.index_select(a, axis, idx.reshape(-1))
    return out.reshape(a.shape[:axis] + idx.shape + a.shape[axis + 1:])


@register("Embedding")
def _embedding(data, weight, input_dim=0, output_dim=0, dtype="float32",
               sparse_grad=False):  # noqa: ARG001
    """Rows of ``weight`` at the integer values of ``data``."""
    idx = data if data.dtype == torch.int64 else data.long()
    return F.embedding(idx, weight)


@register("one_hot", differentiable=False)
def _one_hot(indices, depth=0, on_value=1.0, off_value=0.0, dtype="float32"):
    from ..base import torch_dtype
    oh = F.one_hot(indices.long(), depth).to(torch_dtype(dtype))
    return oh * (on_value - off_value) + off_value


@register("pick")
def _pick(data, index, axis=-1, keepdims=False, mode="clip"):  # noqa: ARG001
    """``data`` at ``index`` along ``axis`` (indices clipped)."""
    axis = axis % data.ndim
    idx = index.long().clamp(0, data.shape[axis] - 1).unsqueeze(axis)
    picked = torch.gather(data, axis, idx)
    return picked if keepdims else picked.squeeze(axis)


_PAD_MODES = {"constant": "constant", "edge": "replicate",
              "reflect": "reflect"}


@register("pad")
def _pad(x, mode="constant", pad_width=(), constant_value=0.0):
    """Pad each axis by ``pad_width`` = (lo0, hi0, lo1, hi1, ...) with a
    constant, the edge value (``edge``) or the mirror image without the
    edge (``reflect``).  Torch pads edge and reflect over at most the
    trailing three axes of a tensor with one or two more, so those modes
    name the axes from ``ndim - 2`` on (MXNet pads no others there)."""
    pw = list(zip(pad_width[::2], pad_width[1::2]))
    first = next((i for i, p in enumerate(pw) if any(p)), len(pw))
    if mode != "constant":
        first = min(first, max(x.ndim - 2, 1))
    pads = [v for p in reversed(pw[first:]) for v in p]
    if mode == "constant":
        return F.pad(x, pads, value=constant_value)
    return F.pad(x, pads, mode=_PAD_MODES[mode])
