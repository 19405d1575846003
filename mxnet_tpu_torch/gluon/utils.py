"""gluon.utils — the port of ``mxnet_tpu/gluon/utils.py``: ``split_data``,
``split_and_load``, ``clip_global_norm``, ``check_sha1``, ``download``
(which only finds a file already on disk: nothing here fetches) and
``remat_call`` (activation rematerialisation)."""

from __future__ import annotations

import hashlib
import math
import os
import warnings

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from .. import autograd
from ..base import MXNetError
from ..ndarray.ndarray import NDArray, array

__all__ = ["split_data", "split_and_load", "clip_global_norm", "check_sha1",
           "download", "remat_call"]


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


def _keep_draws(ctx, func, *args, **kwargs):  # noqa: ARG001
    """Checkpoint policy: keep what an op that draws random numbers
    returned (Dropout's uniforms), recompute everything else."""
    if torch.Tag.nondeterministic_seeded in func.tags:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _block_tensors(block):
    """Every tensor of ``block`` (a Gluon Block: its parameters' values on
    every context; a torch module: its parameters and buffers)."""
    from .block import Block
    if isinstance(block, Block):
        return [d._data for p in block.collect_params().values()
                if p._data is not None for d in p._data_list]
    return list(block.parameters()) + list(block.buffers())


def remat_call(block, *inputs):
    """``block(*inputs)`` with activation rematerialisation: the block's
    inner activations are not kept for backward but recomputed from its
    inputs during the gradient pass (``torch.utils.checkpoint``,
    non-reentrant).  MXNet's ``MXNET_BACKWARD_DO_MIRROR`` trade: about one
    more forward of compute for activation memory of O(1) per wrapped
    block.

    ``inputs`` are NDArrays (the block runs on their tensors and its
    parameters become variables of the ``autograd.record`` session, as a
    hybridized block's do) or tensors (inside a hybridized parent or
    ``parallel.TrainStep``).  Outside recording (``autograd.record`` for
    NDArrays, torch's grad mode for tensors) it is ``block(*inputs)``.
    Ops that draw random numbers (Dropout) keep their draws from the
    forward and the recompute draws nothing, so its masks are the
    forward's: a generator cannot be rewound inside a captured CUDA graph.
    Raises ``MXNetError`` for a block with several outputs and for one
    that writes its own state in the forward (BatchNorm's running
    statistics in training), whose write the recompute would repeat."""
    from .block import Block, HybridBlock, _forward_ctx
    nd_in = next((a for a in inputs if isinstance(a, NDArray)), None)
    recording = autograd.is_recording() if nd_in is not None \
        else torch.is_grad_enabled()
    if not recording:
        return block(*inputs)
    ctx = nd_in.ctx if nd_in is not None \
        else getattr(_forward_ctx, "value", None)
    tensor_path = not isinstance(block, Block) or \
        isinstance(block, HybridBlock)
    train = autograd.is_training()
    state = _block_tensors(block)
    versions = [t._version for t in state]

    def run(*tensors):
        prev = (getattr(_forward_ctx, "value", None),
                autograd.set_recording(True), autograd.set_training(train))
        _forward_ctx.value = ctx
        try:
            out = block(*tensors) if tensor_path else \
                block(*[NDArray(t, ctx) for t in tensors])
        finally:
            _forward_ctx.value = prev[0]
            autograd.set_recording(prev[1])
            autograd.set_training(prev[2])
        if isinstance(out, (list, tuple)):
            raise MXNetError("remat_call supports single-output blocks")
        return out._data if isinstance(out, NDArray) else out

    tensors = [a._data if isinstance(a, NDArray) else a for a in inputs]
    out = checkpoint(
        run, *tensors, use_reentrant=False, preserve_rng_state=False,
        context_fn=lambda: create_selective_checkpoint_contexts(_keep_draws))
    if any(t._version != v for t, v in zip(state, versions)):
        raise MXNetError(
            "remat_call: the block writes its own state in the forward "
            "(BatchNorm's running statistics?); the recompute would write "
            "it again: wrap only blocks without such writes")
    if nd_in is None:
        return out
    autograd._note_inputs(
        [a for a in inputs if isinstance(a, NDArray)]
        + ([d for p in block.collect_params().values() if p._data is not None
            for d in p._data_list] if isinstance(block, Block) else []))
    return NDArray(out, nd_in._ctx)
