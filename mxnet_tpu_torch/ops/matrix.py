"""Matrix, shape and indexing operators — the port of
``mxnet_tpu/ops/matrix.py``: the matmul family, ``reshape`` with MXNet's
special codes, the shape ops (``transpose``, ``squeeze``, the broadcasts,
``slice`` with any step, ``split_v2``, ``depth_to_space`` ...), indexing
(``take``, ``Embedding``, ``pick``, ``gather_nd``, ``scatter_nd``,
``index_add``, ``boolean_mask``, the sequence ops), ``where`` and the
creation ops (``_zeros``, ``eye``, ``linspace``, ``_arange`` ...), which
create their output on the device dispatch names.  Float32 products run
in full float32 (the package turns TF32 off), as the reference's "highest"
precision.  Indices are clipped into range where an out-of-range index
would trip a device-side assert on the card.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..base import torch_dtype
from .registry import register

__all__ = ["infer_reshape", "basic_index"]


def _neg_step(key):
    return any(isinstance(k, slice) and k.step is not None and k.step < 0
               for k in key)


def _key_dims(key, ndim):
    """For each entry of ``key`` (a tuple), the tensor axis it indexes and
    the output axis it makes (None where it makes or consumes none)."""
    consumed = sum(1 for k in key if k is not None and k is not Ellipsis)
    dims, d, o = [], 0, 0
    for k in key:
        if k is Ellipsis:
            n = ndim - consumed
            d, o = d + n, o + n
            dims.append((None, None))
        elif k is None:
            dims.append((None, o))
            o += 1
        elif isinstance(k, slice):
            dims.append((d, o))
            d, o = d + 1, o + 1
        else:                                   # an int: the axis goes
            dims.append((d, None))
            d += 1
    return dims


def _ascending(k, n):
    """The positive-step slice over the same elements as the negative-step
    slice ``k`` of an axis of length ``n``, in increasing order."""
    idx = range(*k.indices(n))
    if not idx:
        return slice(0, 0)
    return slice(idx[-1], idx[0] + 1, -k.step)


def basic_index(t, key, value=None):
    """``t[key]`` for a basic key (ints, slices of any step, None,
    Ellipsis), or ``t[key] = value`` when ``value`` is given.  Torch takes
    no negative step: such a slice reads the same elements with a positive
    step and flips them on the output axis (a copy), and a write flips the
    value instead, so it lands in ``t`` itself; every other key keeps
    torch's view that writes through.  A negative step beside index
    arrays in one key is not supported."""
    tkey = key if isinstance(key, tuple) else (key,)
    if not _neg_step(tkey):
        if value is None:
            return t[key]
        t[key] = value
        return t
    if not all(k is None or k is Ellipsis or isinstance(k, (int, slice))
               for k in tkey):
        from ..base import MXNetError
        raise MXNetError("a negative step beside index arrays in one key is "
                         "not supported")
    dims = _key_dims(tkey, t.ndim)
    pos, flips = [], []
    for k, (d, o) in zip(tkey, dims):
        if isinstance(k, slice) and k.step is not None and k.step < 0:
            k = _ascending(k, t.shape[d])
            flips.append(o)
        pos.append(k)
    view = t[tuple(pos)]
    if value is None:
        return view.flip(flips)
    if not isinstance(value, torch.Tensor):
        value = torch.as_tensor(value, dtype=t.dtype, device=t.device)
    view.copy_(torch.broadcast_to(value, view.shape).flip(flips))
    return t


@register("dot", promote="common")
def _dot(lhs, rhs, transpose_a=False, transpose_b=False):
    """2-D product; for N-D inputs, contracts lhs's last axis with rhs's
    first (``tensordot`` with one axis)."""
    a = lhs.movedim(0, -1) if transpose_a else lhs
    b = rhs.movedim(-1, 0) if transpose_b else rhs
    if a.ndim <= 2 and b.ndim <= 2:
        return torch.matmul(a, b)
    return torch.tensordot(a, b, dims=1)


@register("batch_dot", promote="common")
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


def _all_or(x, axis):
    if axis is None:
        return tuple(range(x.ndim))
    return (axis,) if isinstance(axis, int) else tuple(axis)


@register("flip")
def _flip(x, axis=None):
    """Reverse ``axis`` (an int or a tuple); every axis when None."""
    return torch.flip(x, _all_or(x, axis))


register("reverse")(_flip)


@register("tile")
def _tile(x, reps=()):
    return torch.tile(x, tuple(reps))


@register("slice")
def _slice(x, begin=None, end=None, step=None):
    """``x[begin:end:step]`` per axis; a step may be negative."""
    return basic_index(x, tuple(slice(b, e, step[i] if step else None)
                                for i, (b, e) in enumerate(zip(begin, end))))


def _thaw_index(fk):
    """The basic index frozen by the reference's ``_freeze_index``
    (``("slice", start, stop, step)``, ``("int", i)``, ``("ellipsis",)``,
    ``("newaxis",)``, under ``("tuple", ...)``)."""
    def g(t):
        if t[0] == "slice":
            return slice(t[1], t[2], t[3])
        if t[0] == "ellipsis":
            return Ellipsis
        if t[0] == "newaxis":
            return None
        return t[1]
    if fk[0] == "tuple":
        return tuple(g(t) for t in fk[1:])
    return g(fk)


@register("_slice_basic")
def _slice_basic(x, key=None):
    return basic_index(x, _thaw_index(key))


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
    """Rows of ``weight`` at the integer values of ``data``, clipped into
    ``[0, rows)`` as ``take`` clips (the reference gives NaN rows for an
    index out of range)."""
    idx = data.long().clamp(0, weight.shape[0] - 1)
    return F.embedding(idx, weight)


@register("one_hot", differentiable=False)
def _one_hot(indices, depth=0, on_value=1.0, off_value=0.0, dtype="float32"):
    """``on_value`` where the index equals the position, else
    ``off_value``; an index outside ``[0, depth)`` gives a row of
    ``off_value``."""
    hit = indices.long().unsqueeze(-1) == torch.arange(
        depth, device=indices.device)
    oh = hit.to(torch_dtype(dtype))
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


# -- products and shapes ------------------------------------------------------

@register("matmul", promote="common")
def _matmul(a, b):
    return torch.matmul(a, b)


@register("khatri_rao")
def _khatri_rao(*mats):
    """Column-wise Kronecker product of (n_i, k) matrices."""
    out = mats[0]
    for m in mats[1:]:
        out = torch.einsum("i...,j...->ij...", out, m).reshape(
            -1, out.shape[-1])
    return out


@register("squeeze")
def _squeeze(x, axis=None):
    if axis is None:
        return torch.squeeze(x)
    return torch.squeeze(x, axis if isinstance(axis, int) else tuple(axis))


@register("broadcast_to")
def _broadcast_to(x, shape=None):
    """``x`` broadcast to ``shape``; a 0 keeps that axis's size."""
    shape = tuple(s if s != 0 else x.shape[i] for i, s in enumerate(shape))
    return torch.broadcast_to(x, shape).contiguous()


@register("broadcast_like")
def _broadcast_like(x, like):
    return torch.broadcast_to(x, like.shape).contiguous()


@register("broadcast_axis")
def _broadcast_axis(x, axis=None, size=None):
    axes = (axis,) if isinstance(axis, int) else tuple(axis)
    sizes = (size,) if isinstance(size, int) else tuple(size)
    shape = list(x.shape)
    for a, n in zip(axes, sizes):
        shape[a] = n
    return torch.broadcast_to(x, tuple(shape)).contiguous()


@register("repeat")
def _repeat(x, repeats=1, axis=None):
    """Each element ``repeats`` times along ``axis`` (of the flattened
    array when None), numpy's ``repeat``."""
    return torch.repeat_interleave(x, repeats, dim=axis)


@register("slice_like")
def _slice_like(x, like, axes=()):
    key = [slice(None)] * x.ndim
    for a in (axes if axes else range(x.ndim)):
        key[a] = slice(0, like.shape[a])
    return x[tuple(key)]


def _squeezed(parts, axis, squeeze_axis):
    if squeeze_axis:
        parts = [p.squeeze(axis) for p in parts]
    return list(parts) if len(parts) > 1 else parts[0]


@register("split_v2", num_outputs=-1)
def _split_v2(x, indices=None, axis=0, squeeze_axis=False, sections=0):
    """``sections`` equal parts, or the parts between ``indices``."""
    parts = torch.tensor_split(x, sections if sections else list(indices),
                               dim=axis)
    return _squeezed(parts, axis, squeeze_axis)


@register("slice_channel", num_outputs=-1)
def _slice_channel(x, num_outputs=1, axis=1, squeeze_axis=False):
    return _squeezed(torch.chunk(x, num_outputs, dim=axis), axis,
                     squeeze_axis)


@register("depth_to_space")
def _depth_to_space(x, block_size=1):
    b, c, h, w = x.shape
    bs = block_size
    y = x.reshape(b, bs, bs, c // (bs * bs), h, w).permute(0, 3, 4, 1, 5, 2)
    return y.reshape(b, c // (bs * bs), h * bs, w * bs)


@register("space_to_depth")
def _space_to_depth(x, block_size=1):
    b, c, h, w = x.shape
    bs = block_size
    y = x.reshape(b, c, h // bs, bs, w // bs, bs).permute(0, 3, 5, 1, 2, 4)
    return y.reshape(b, c * bs * bs, h // bs, w // bs)


@register("where")
def _where(cond, x, y):
    return torch.where(cond != 0, x, y)


@register("diag")
def _diag(x, k=0):
    """A matrix with ``x`` on diagonal ``k`` (1-D ``x``), else diagonal
    ``k`` of the last two axes."""
    if x.ndim == 1:
        return torch.diag(x, k)
    return torch.diagonal(x, offset=k, dim1=-2, dim2=-1)


# -- indexing -----------------------------------------------------------------

def _in_range(idx, n):
    """Indices wrapped once from the end (numpy's negative index) and then
    clipped into ``[0, n)``."""
    idx = idx.long()
    return torch.where(idx < 0, idx + n, idx).clamp(0, n - 1)


@register("gather_nd")
def _gather_nd(data, indices):
    """``data[indices[0], ..., indices[M-1]]``: indices (M, ...)."""
    return data[tuple(_in_range(indices[i], data.shape[i])
                      for i in range(indices.shape[0]))]


@register("scatter_nd")
def _scatter_nd(data, indices, shape=None):
    """A zero array of ``shape`` with ``data`` added at ``indices`` (M,
    ...), the reference's ``.at[].add``."""
    out = torch.zeros(tuple(shape), dtype=data.dtype, device=data.device)
    idx = tuple(_in_range(indices[i], shape[i])
                for i in range(indices.shape[0]))
    return out.index_put(idx, data, accumulate=True)


@register("index_add", promote="first")
def _index_add(old, index, new):
    """``old`` with ``new`` added at rows ``index``."""
    return old.index_put((_in_range(index, old.shape[0]),), new,
                         accumulate=True)


@register("index_copy", promote="first")
def _index_copy(old, index, new):
    """``old`` with rows ``index`` replaced by ``new``."""
    return old.index_put((_in_range(index, old.shape[0]),), new)


@register("batch_take")
def _batch_take(a, indices):
    """``a[i, indices[i]]`` for each row i."""
    idx = _in_range(indices, a.shape[1])
    return a.gather(1, idx[:, None])[:, 0]


@register("boolean_mask", differentiable=False)
def _boolean_mask(data, index, axis=0):
    """The slices of ``data`` along ``axis`` where ``index`` is non-zero.
    The output's length depends on the data: on the card the count is read
    back to the host, a sync."""
    return torch.index_select(data, axis, torch.nonzero(index != 0)[:, 0])


def _lengths_mask(steps, lengths, axis, ndim):
    """(L, B) mask ``step < length`` (transposed for ``axis=1``), with
    singleton trailing axes up to ``ndim``."""
    mask = steps[:, None] < lengths.long()[None, :]
    if axis == 1:
        mask = mask.T
    return mask.reshape(mask.shape + (1,) * (ndim - 2))


@register("sequence_mask")
def _sequence_mask(data, sequence_length=None, use_sequence_length=False,
                   value=0.0, axis=0):
    """``value`` at the steps at or past each sequence's length; the time
    axis is ``axis`` (0 or 1) and the batch axis the other."""
    if not use_sequence_length or sequence_length is None:
        return data
    steps = torch.arange(data.shape[axis], device=data.device)
    mask = _lengths_mask(steps, sequence_length, axis, data.ndim)
    return torch.where(mask, data, torch.as_tensor(value, dtype=data.dtype,
                                                   device=data.device))


@register("sequence_last")
def _sequence_last(data, sequence_length=None, use_sequence_length=False,
                   axis=0):
    """Each sequence's last valid step."""
    if not use_sequence_length or sequence_length is None:
        return data.select(axis, -1)
    idx = (sequence_length.long() - 1).clamp(0, data.shape[axis] - 1)
    if axis == 0:
        idx = idx.reshape((1, -1) + (1,) * (data.ndim - 2))
    else:
        idx = idx.reshape((-1, 1) + (1,) * (data.ndim - 2))
    idx = idx.expand(tuple(1 if i == axis else n
                           for i, n in enumerate(data.shape)))
    return torch.gather(data, axis, idx).squeeze(axis)


@register("sequence_reverse")
def _sequence_reverse(data, sequence_length=None, use_sequence_length=False,
                      axis=0):  # noqa: ARG001 (time-major only, as upstream)
    """Each sequence's valid steps reversed in place along axis 0; the
    padding stays where it is."""
    if not use_sequence_length or sequence_length is None:
        return torch.flip(data, (0,))
    steps = torch.arange(data.shape[0], device=data.device)[:, None]
    lens = sequence_length.long()[None, :]
    rev = torch.where(steps < lens, lens - 1 - steps, steps)
    rev = rev.reshape(rev.shape + (1,) * (data.ndim - 2)).expand(data.shape)
    return torch.gather(data, 0, rev)


@register("ravel_multi_index", differentiable=False)
def _ravel_multi_index(data, shape=()):
    """(ndim, N) coordinates -> flat indices into ``shape``."""
    strides = np.cumprod((1,) + tuple(shape[::-1]))[:-1][::-1].copy()
    s = torch.as_tensor(strides, dtype=data.dtype, device=data.device)
    return (data * s[:, None]).sum(dim=0)


@register("unravel_index", differentiable=False)
def _unravel_index(data, shape=()):
    """Flat indices -> (ndim, N) coordinates into ``shape``."""
    return torch.stack(torch.unravel_index(data, tuple(shape)), dim=0) \
        .to(data.dtype)


# -- creation -----------------------------------------------------------------

def _created(name):
    """Register a creation op: dispatch passes the device as ``_device``."""
    return register(name, differentiable=False, wrap_device="_device")


@_created("_zeros")
def _zeros(shape=(), dtype="float32", _device=None):
    return torch.zeros(tuple(shape), dtype=torch_dtype(dtype),
                       device=_device)


@_created("_ones")
def _ones(shape=(), dtype="float32", _device=None):
    return torch.ones(tuple(shape), dtype=torch_dtype(dtype), device=_device)


@_created("_full")
def _full(shape=(), value=0.0, dtype="float32", _device=None):
    return torch.full(tuple(shape), value, dtype=torch_dtype(dtype),
                      device=_device)


@_created("_arange")
def _arange(start=0, stop=None, step=1.0, repeat=1, dtype="float32",
            _device=None):
    if stop is None:
        start, stop = 0, start
    r = torch.arange(start, stop, step, dtype=torch_dtype(dtype),
                     device=_device)
    return torch.repeat_interleave(r, repeat) if repeat != 1 else r


@_created("linspace")
def _linspace(start=0.0, stop=1.0, num=50, endpoint=True, dtype="float32",
              _device=None):
    num = int(num)
    if endpoint:
        return torch.linspace(start, stop, num, dtype=torch_dtype(dtype),
                              device=_device)
    step = (stop - start) / num
    return (start + step * torch.arange(num, dtype=torch.float64,
                                        device=_device)) \
        .to(torch_dtype(dtype))


@_created("eye")
def _eye(N=1, M=0, k=0, dtype="float32", _device=None):  # noqa: N803
    """ones on diagonal ``k`` of an (N, M) matrix (M = N when 0)."""
    rows = torch.arange(int(N), device=_device)[:, None]
    cols = torch.arange(int(M) if M else int(N), device=_device)[None, :]
    return (cols - rows == int(k)).to(torch_dtype(dtype))
