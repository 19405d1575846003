"""Neural-network operators — the port of ``mxnet_tpu/ops/nn.py``'s
``FullyConnected``, ``Convolution``, ``Deconvolution``, ``Pooling``,
``Activation``, ``LeakyReLU``, ``softmax``, ``log_softmax``,
``softmax_cross_entropy``, ``BatchNorm``, ``LayerNorm``, ``GroupNorm``,
``InstanceNorm`` and ``Dropout``, as PyTorch library math (the reference
leaves them to XLA): convolution, pooling and batch norm through
``torch.nn.functional``, which runs cuDNN's or torch's CUDA kernels on the
card.  Dense weights are (out, in) and convolution weights OIHW, as in the
reference.
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


# -- convolution --------------------------------------------------------------

_CONV = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}
_DECONV = {1: F.conv_transpose1d, 2: F.conv_transpose2d,
           3: F.conv_transpose3d}


def _norm_tuple(v, n, default):
    if not v:
        return (default,) * n
    if isinstance(v, int):
        return (v,) * n
    return tuple(v)


@register("Convolution")
def _convolution(data, weight, bias=None, kernel=(), stride=(), dilate=(),
                 pad=(), num_filter=0, num_group=1, no_bias=False,
                 layout=None, workspace=0, cudnn_tune=None,
                 cudnn_off=False):  # noqa: ARG001
    """NC(D)HW data, (out_c, in_c/num_group, *kernel) weight, 1-3 spatial
    dims (cuDNN on the card)."""
    n = len(kernel) if kernel else data.ndim - 2
    return _CONV[n](data, weight, None if no_bias else bias,
                    stride=_norm_tuple(stride, n, 1),
                    padding=_norm_tuple(pad, n, 0),
                    dilation=_norm_tuple(dilate, n, 1), groups=num_group)


@register("Deconvolution")
def _deconvolution(data, weight, bias=None, kernel=(), stride=(), dilate=(),
                   pad=(), adj=(), num_filter=0, num_group=1, no_bias=True,
                   layout=None, target_shape=None, workspace=0,
                   cudnn_tune=None, cudnn_off=False):  # noqa: ARG001
    """Transposed convolution (the gradient of Convolution with respect to
    its data); weight (in_c, out_c/num_group, *kernel), ``adj`` extra
    high-side output rows.  The bias is added unless ``no_bias``: the
    reference drops it (ROADMAP.md, queue C)."""
    n = len(kernel) if kernel else data.ndim - 2
    return _DECONV[n](data, weight, None if no_bias else bias,
                      stride=_norm_tuple(stride, n, 1),
                      padding=_norm_tuple(pad, n, 0),
                      output_padding=_norm_tuple(adj, n, 0),
                      groups=num_group, dilation=_norm_tuple(dilate, n, 1))


# -- pooling ------------------------------------------------------------------

_MAX_POOL = {1: F.max_pool1d, 2: F.max_pool2d, 3: F.max_pool3d}
_AVG_POOL = {2: F.avg_pool2d, 3: F.avg_pool3d}


def _avg_pool(x, kernel, stride, pad, count_include_pad=True,
              divisor_override=None):
    """avg_pool in 1-3 dims (1-D as 2-D, which has ``divisor_override``)."""
    if x.ndim == 3:
        return _avg_pool(x.unsqueeze(2), (1,) + kernel, (1,) + stride,
                         (0,) + pad, count_include_pad,
                         divisor_override).squeeze(2)
    return _AVG_POOL[x.ndim - 2](x, kernel, stride, pad,
                                 count_include_pad=count_include_pad,
                                 divisor_override=divisor_override)


@register("Pooling")
def _pooling(data, kernel=(), pool_type="max", global_pool=False,
             stride=(), pad=(), pooling_convention="valid",
             count_include_pad=True, cudnn_off=False, layout=None,
             p_value=2):  # noqa: ARG001
    """max, avg, sum or lp pooling over NC(D)HW.

    ``pooling_convention="full"`` takes ceil output sizes by growing the
    high-side padding, as the reference does; torch's ``ceil_mode``
    instead drops a last window that would start in the right padding.
    Where the padding is not torch's (asymmetric, or wider than half the
    window) it is made explicitly: -inf for max, 0 otherwise."""
    n = data.ndim - 2
    if global_pool:
        kernel, stride, pad = data.shape[2:], (1,) * n, (0,) * n
    kernel = _norm_tuple(kernel, n, 1)
    stride = _norm_tuple(stride, n, 1)
    pad = _norm_tuple(pad, n, 0)
    hi = list(pad)
    if pooling_convention == "full":
        for i in range(n):
            rem = (data.shape[2 + i] + 2 * pad[i] - kernel[i]) % stride[i]
            if rem:
                hi[i] = pad[i] + stride[i] - rem
    x = data
    native = tuple(hi) == pad and all(2 * p <= k
                                      for p, k in zip(pad, kernel))
    if not native:
        pads = []
        for lo_, hi_ in zip(reversed(pad), reversed(hi)):
            pads += [lo_, hi_]
        x = F.pad(x, pads, value=float("-inf") if pool_type == "max"
                  else 0.0)
        pad = (0,) * n
    if pool_type == "max":
        return _MAX_POOL[n](x, kernel, stride, pad)
    if pool_type == "avg":
        if count_include_pad or native:
            return _avg_pool(x, kernel, stride, pad, count_include_pad)
        ones = F.pad(torch.ones_like(data[:1, :1]), pads)
        return _avg_pool(x, kernel, stride, pad, divisor_override=1) \
            / _avg_pool(ones, kernel, stride, pad, divisor_override=1)
    if pool_type == "sum":
        return _avg_pool(x, kernel, stride, pad, divisor_override=1)
    if pool_type == "lp":
        p = float(p_value)
        return _avg_pool(x.abs() ** p, kernel, stride, pad,
                         divisor_override=1) ** (1.0 / p)
    raise ValueError(f"unknown pool_type {pool_type}")


# -- normalization ------------------------------------------------------------

@register("BatchNorm", num_outputs=3, visible_outputs=1,
          mutate_inputs=((1, 3), (2, 4)), wrap_train="_training")
def _batch_norm(data, gamma, beta, moving_mean, moving_var, eps=1e-3,
                momentum=0.9, fix_gamma=True, use_global_stats=False,
                output_mean_var=False, axis=1, cudnn_off=False,
                _training=False):  # noqa: ARG001
    """Outputs (out, new_moving_mean, new_moving_var); dispatch writes the
    last two back into inputs 3 and 4.

    While training (and not ``use_global_stats``) the batch's mean and
    biased variance normalize, and the moving statistics become MXNet's
    ``momentum * old + (1 - momentum) * batch``; otherwise the moving
    statistics normalize and come back unchanged (the same tensors).
    Data narrower than 4 bytes is normalized in float32 with float32
    gamma, beta and statistics and comes back in its own dtype: torch's
    mixed batch norm takes such data with float32 parameters, on the card
    and on the CPU alike.  ``torch.nn.functional.batch_norm`` never
    updates the statistics here (torch's would take the unbiased variance
    and the other momentum)."""
    axis = axis % data.ndim
    x = data.movedim(axis, 1) if axis != 1 else data
    narrow = data.dtype.itemsize < 4
    pdt = torch.float32 if narrow else data.dtype
    g = torch.ones_like(gamma, dtype=pdt) if fix_gamma else gamma.to(pdt)
    b = beta.to(pdt)
    if _training and not use_global_stats:
        out = F.batch_norm(x, None, None, g, b, True, 0.0, eps)
        with torch.no_grad():
            red = [i for i in range(x.ndim) if i != 1]
            var, mean = torch.var_mean(x.to(pdt), dim=red, unbiased=False)
            new_mm = moving_mean * momentum \
                + mean.to(moving_mean.dtype) * (1 - momentum)
            new_mv = moving_var * momentum \
                + var.to(moving_var.dtype) * (1 - momentum)
    else:
        out = F.batch_norm(x, moving_mean.to(pdt), moving_var.to(pdt), g, b,
                           False, 0.0, eps)
        new_mm, new_mv = moving_mean, moving_var
    if axis != 1:
        out = out.movedim(1, axis)
    return out, new_mm, new_mv


@register("GroupNorm")
def _group_norm(data, gamma, beta, num_groups=1, eps=1e-5,
                output_mean_var=False):  # noqa: ARG001
    return F.group_norm(data, num_groups, gamma, beta, eps)


@register("InstanceNorm")
def _instance_norm(data, gamma, beta, eps=1e-3):
    return F.instance_norm(data, weight=gamma, bias=beta, eps=eps)
