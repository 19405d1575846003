"""Neural-network operators — the port of ``mxnet_tpu/ops/nn.py``'s
``FullyConnected``, ``Activation``, ``LeakyReLU``, ``softmax``,
``log_softmax``, ``softmax_cross_entropy``, ``LayerNorm`` and ``Dropout``,
as plain PyTorch (the reference leaves them to XLA).  Dense weights are
(out, in), as in the reference.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .elemwise import gelu
from .registry import register

__all__ = ["softmax_cross_entropy"]


@register("FullyConnected")
def _fully_connected(data, weight, bias=None, num_hidden=0, no_bias=False,
                     flatten=True):  # noqa: ARG001
    x = data.reshape(data.shape[0], -1) if flatten else data
    return F.linear(x, weight, None if no_bias else bias)


_ACTIVATIONS = {"relu": torch.relu, "sigmoid": torch.sigmoid,
                "tanh": torch.tanh, "softrelu": F.softplus,
                "softsign": F.softsign}


@register("Activation")
def _activation(data, act_type="relu"):
    if act_type not in _ACTIVATIONS:
        raise ValueError(f"unknown act_type {act_type}")
    return _ACTIVATIONS[act_type](data)


@register("LeakyReLU")
def _leaky_relu(data, gamma=None, act_type="leaky", slope=0.25,
                lower_bound=0.125, upper_bound=0.334, approximate=None):
    if act_type == "leaky":
        return torch.where(data > 0, data, slope * data)
    if act_type == "prelu":
        g = gamma.reshape((1, -1) + (1,) * (data.ndim - 2)) \
            if gamma.ndim == 1 and data.ndim > 2 else gamma
        return torch.where(data > 0, data, g * data)
    if act_type == "elu":
        return torch.where(data > 0, data, slope * torch.expm1(data))
    if act_type == "selu":
        return F.selu(data)
    if act_type == "gelu":
        return gelu(data, approximate)
    if act_type == "rrelu":
        return torch.where(data > 0, data,
                           (lower_bound + upper_bound) / 2.0 * data)
    raise ValueError(f"unknown act_type {act_type}")


@register("softmax")
def _softmax(data, length=None, axis=-1, temperature=None, dtype=None,
             use_length=False):
    from ..base import torch_dtype
    x = data / temperature if temperature else data
    if use_length and length is not None:
        steps = torch.arange(data.shape[axis], device=data.device)
        shape = [1] * data.ndim
        shape[axis] = -1
        mask = steps.reshape(shape) < length.reshape(
            tuple(length.shape) + (1,) * (data.ndim - length.ndim))
        x = torch.where(mask, x, torch.tensor(float("-inf"),
                                              device=data.device))
    r = torch.softmax(x, dim=axis)
    if use_length and length is not None:
        r = torch.nan_to_num(r, nan=0.0)
    return r.to(torch_dtype(dtype)) if dtype else r


@register("log_softmax")
def _log_softmax(data, axis=-1, temperature=None, dtype=None):
    from ..base import torch_dtype
    x = data / temperature if temperature else data
    r = torch.log_softmax(x, dim=axis)
    return r.to(torch_dtype(dtype)) if dtype else r


@register("softmax_cross_entropy")
def softmax_cross_entropy(data, label):
    """Summed negative log-likelihood of integer ``label`` under
    softmax(``data``) over the last axis; data (N, C), label (N,)."""
    logp = torch.log_softmax(data, dim=-1)
    return -logp.gather(-1, label.long().reshape(-1, 1)).sum()


@register("LayerNorm")
def _layer_norm(data, gamma, beta, axis=-1, eps=1e-5,
                output_mean_var=False):  # noqa: ARG001
    """(data - mean) / sqrt(var + eps) * gamma + beta over ``axis``
    (biased variance, as the reference's ``jnp.var``)."""
    if axis % data.ndim == data.ndim - 1:
        return F.layer_norm(data, data.shape[-1:], gamma, beta, eps)
    mean = data.mean(dim=axis, keepdim=True)
    var = data.var(dim=axis, keepdim=True, unbiased=False)
    shape = [1] * data.ndim
    shape[axis] = -1
    return (data - mean) / torch.sqrt(var + eps) * gamma.reshape(shape) \
        + beta.reshape(shape)


@register("Dropout", wrap_key="_generator", wrap_train="_training")
def _dropout(data, p=0.5, mode="training", axes=(), cudnn_off=False,
             _generator=None, _training=False):  # noqa: ARG001
    """Zero each element with probability ``p`` and scale the rest by
    1 / (1 - p) while training (or always with ``mode="always"``); the keep
    mask is drawn from the device's generator, shared along ``axes``."""
    if (not _training and mode != "always") or p <= 0:
        return data
    shape = list(data.shape)
    for a in axes:
        shape[a] = 1
    keep = 1.0 - p
    mask = torch.rand(shape, generator=_generator, device=data.device) < keep
    return data * mask.to(data.dtype) / keep
