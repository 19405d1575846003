"""gluon.utils — the port of ``mxnet_tpu/gluon/utils.py``: ``split_data``,
``split_and_load``, ``clip_global_norm``, ``check_sha1`` and ``download``
(which only finds a file already on disk: nothing here fetches).

Not ported: ``remat_call`` (rematerialisation, with ``TrainStep``'s
``remat``)."""

from __future__ import annotations

import hashlib
import math
import os
import warnings

import torch

from ..base import MXNetError
from ..ndarray.ndarray import NDArray, array

__all__ = ["split_data", "split_and_load", "clip_global_norm", "check_sha1",
           "download"]


def split_data(data, num_slice, batch_axis=0, even_split=True):
    """``data`` cut into ``num_slice`` slices along ``batch_axis`` (the
    last takes the remainder unless ``even_split`` demands none)."""
    size = data.shape[batch_axis]
    if even_split and size % num_slice != 0:
        raise MXNetError(
            f"data with shape {data.shape} cannot be evenly split into "
            f"{num_slice} slices along axis {batch_axis}")
    step = size // num_slice
    return [data.slice_axis(batch_axis, i * step,
                            (i + 1) * step if i < num_slice - 1 else size)
            for i in range(num_slice)]


def split_and_load(data, ctx_list, batch_axis=0, even_split=True):
    """One slice of ``data`` on each context of ``ctx_list``."""
    if not isinstance(data, NDArray):
        data = array(data, ctx=ctx_list[0])
    if len(ctx_list) == 1:
        return [data.as_in_context(ctx_list[0])]
    slices = split_data(data, len(ctx_list), batch_axis, even_split)
    return [s.as_in_context(ctx) for s, ctx in zip(slices, ctx_list)]


def clip_global_norm(arrays, max_norm, check_isfinite=True):
    """Scale ``arrays`` in place so that their joint L2 norm is at most
    ``max_norm``; returns that norm before scaling (a float)."""
    tensors = [a._data for a in arrays]
    dev = tensors[0].device
    norms = torch._foreach_norm([t.float() for t in tensors])
    norm = float(torch.linalg.vector_norm(
        torch.stack([n.to(dev) for n in norms])))
    if check_isfinite and not math.isfinite(norm):
        warnings.warn("nan or inf found in clip_global_norm", stacklevel=2)
    scale = max_norm / (norm + 1e-8)
    if scale < 1.0:
        with torch.no_grad():
            torch._foreach_mul_(tensors, scale)
    return norm


def check_sha1(filename, sha1_hash):
    """Whether ``filename``'s SHA-1 is ``sha1_hash``."""
    sha1 = hashlib.sha1()
    with open(filename, "rb") as f:
        for chunk in iter(lambda: f.read(1048576), b""):
            sha1.update(chunk)
    return sha1.hexdigest() == sha1_hash


def download(url, path=None, overwrite=False, sha1_hash=None,
             retries=5, verify_ssl=True):  # noqa: ARG001
    """The reference's signature; returns the file only when it is already
    on disk (and matches ``sha1_hash``), else raises: the port fetches
    nothing."""
    fname = path if path and not os.path.isdir(path) else \
        os.path.join(path or ".", url.split("/")[-1])
    if os.path.exists(fname) and not overwrite and \
            (not sha1_hash or check_sha1(fname, sha1_hash)):
        return fname
    raise MXNetError(f"cannot download {url}: mxnet_tpu_torch fetches "
                     f"nothing, and {fname} is not on disk")
