"""Neural-network operators — the port of ``mxnet_tpu/ops/nn.py``'s
``FullyConnected``, ``Convolution``, ``Deconvolution``, ``Pooling``,
``Activation``, ``LeakyReLU``, the softmax family, ``BatchNorm`` (and
``BatchNormWithReLU``), ``LayerNorm``, ``GroupNorm``, ``InstanceNorm``,
``L2Normalization``, ``LRN``, ``Dropout``, ``im2col``/``col2im`` and the
loss heads (``SoftmaxOutput``, the three regression outputs,
``center_loss``), as PyTorch library math (the reference leaves them to
XLA): convolution, pooling and batch norm through ``torch.nn.functional``,
which runs cuDNN's or torch's CUDA kernels on the card.  Dense weights are
(out, in) and convolution weights OIHW, as in the reference.  A loss head's
backward is MXNet's loss gradient, not the autodiff of its forward: each is
a ``torch.autograd.Function`` that ignores the head gradient.

``RNN`` (the fused multi-layer LSTM, GRU and Elman op) takes MXNet's flat
parameter vector in the reference's packing (all weights layer-major,
direction, i2h then h2h, then all biases in the same order), slices it
into views and runs the stack through torch's RNN functions
(``torch._VF.lstm``, ``gru``, ``rnn_tanh``, ``rnn_relu``): cuDNN's RNN
kernels on the card, torch's own on the CPU.  Their gate orders are the
reference's (LSTM i, f, g, o; GRU r, z, n with the h2h bias inside
``r * (W_hn h + b_hn)``).  Dropout between layers draws its mask from the
device's generator, so a stack that drops runs one library call per layer
(cuDNN's own dropout would draw from torch's global generator).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..base import MXNetError
from .elemwise import gelu
from .registry import register

__all__ = ["softmax_cross_entropy", "rnn_infer"]


@register("FullyConnected", promote="common")
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


@register("LayerNorm", promote="common")
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


# -- fused RNN ------------------------------------------------------------------

_RNN_GATES = {"rnn_relu": 1, "rnn_tanh": 1, "lstm": 4, "gru": 3}


def rnn_infer(shapes, attrs):
    """The reference's shape rule for ``RNN``'s inputs (data, parameters,
    state, state_cell): from the (T, N, I) data shape, the flat parameter
    vector's (size,) and the states' (layers * directions, N, H); a shape
    already given (not None) is kept."""
    data = shapes[0]
    if data is None:
        return shapes
    mode = attrs.get("mode", "lstm")
    H = attrs.get("state_size", 0)
    L = attrs.get("num_layers", 1)
    d = 2 if attrs.get("bidirectional", False) else 1
    ng = _RNN_GATES[mode]
    size = 0
    for layer in range(L):
        in_sz = data[2] if layer == 0 else H * d
        size += d * (ng * H * in_sz + ng * H * H + 2 * ng * H)
    out = list(shapes)
    if len(out) > 1 and out[1] is None:
        out[1] = (size,)
    for i in (2, 3):
        if len(out) > i and out[i] is None:
            out[i] = (L * d, data[1], H)
    return out


def _unpack_rnn_params(params, mode, num_layers, input_size, hidden, d):
    """Views [layer][direction] = [w_i2h, w_h2h, b_i2h, b_h2h] of the flat
    vector: all weights (layer-major, direction, i2h then h2h), then all
    biases in the same order."""
    ng = _RNN_GATES[mode]
    layers, off = [], 0

    def take(n, shape):
        nonlocal off
        v = params[off:off + n].view(shape)
        off += n
        return v

    for layer in range(num_layers):
        in_sz = input_size if layer == 0 else hidden * d
        layers.append([[take(ng * hidden * in_sz, (ng * hidden, in_sz)),
                        take(ng * hidden * hidden, (ng * hidden, hidden))]
                       for _ in range(d)])
    for layer in range(num_layers):
        for dd in range(d):
            layers[layer][dd] += [take(ng * hidden, (ng * hidden,)),
                                  take(ng * hidden, (ng * hidden,))]
    return layers


@register("RNN", num_outputs=-1, wrap_key="_generator",
          wrap_train="_training", promote="common", host_f32=True)
def _rnn(data, parameters, state, state_cell=None, state_size=0,
         num_layers=1, mode="lstm", bidirectional=False, p=0.0,
         state_outputs=False, projection_size=None,
         use_sequence_length=False, sequence_length=None,
         lstm_state_clip_min=None, lstm_state_clip_max=None,
         lstm_state_clip_nan=False, _generator=None, _training=False):
    """Fused multi-layer RNN over (T, N, I) data, states (layers *
    directions, N, H): the output (T, N, directions * H), and with
    ``state_outputs`` the final h (and c for an LSTM).  The reference
    accepts ``projection_size``, sequence lengths and the LSTM state clip
    and ignores them; the port raises on a value other than the default."""
    if projection_size is not None or use_sequence_length \
            or sequence_length is not None \
            or lstm_state_clip_min is not None \
            or lstm_state_clip_max is not None or lstm_state_clip_nan:
        raise MXNetError(
            "RNN: projection_size, use_sequence_length/sequence_length and "
            "lstm_state_clip_* are not supported")
    if mode not in _RNN_GATES:
        raise MXNetError(f"RNN: unknown mode {mode!r}")
    T, N, I = data.shape
    H, d = state_size, 2 if bidirectional else 1
    want = rnn_infer([tuple(data.shape), None], {
        "mode": mode, "state_size": H, "num_layers": num_layers,
        "bidirectional": bidirectional})[1]
    if tuple(parameters.shape) != want:
        raise MXNetError(f"RNN: parameters of shape "
                         f"{tuple(parameters.shape)}, expected {want}")
    layers = _unpack_rnn_params(parameters, mode, num_layers, I, H, d)
    fn = getattr(torch._VF, mode)       # lstm, gru, rnn_tanh, rnn_relu
    lstm = mode == "lstm"
    drop = p > 0 and _training
    # the library's backward needs its training-mode forward
    train = torch.is_grad_enabled()
    # without inter-layer dropout the stack is one call; with it, one per
    # layer and the mask drawn in between
    groups = [range(num_layers)] if not drop else \
        [range(k, k + 1) for k in range(num_layers)]
    out, h_n, c_n = data, [], []
    for group in groups:
        lo, hi = group[0] * d, (group[-1] + 1) * d
        weights = [w for k in group for per_dir in layers[k]
                   for w in per_dir]
        hx = (state[lo:hi], state_cell[lo:hi]) if lstm else state[lo:hi]
        res = fn(out.contiguous(), hx, weights, True, len(group), 0.0,
                 train, bidirectional, False)
        out = res[0]
        h_n.append(res[1])
        if lstm:
            c_n.append(res[2])
        if drop and group[0] < num_layers - 1:
            keep = 1.0 - p
            mask = torch.rand(out.shape, generator=_generator,
                              device=out.device) < keep
            out = out * mask.to(out.dtype) / keep
    if not state_outputs:
        return out
    results = [out, torch.cat(h_n, 0)]
    if lstm:
        results.append(torch.cat(c_n, 0))
    return results


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


@register("GroupNorm", promote="common")
def _group_norm(data, gamma, beta, num_groups=1, eps=1e-5,
                output_mean_var=False):  # noqa: ARG001
    return F.group_norm(data, num_groups, gamma, beta, eps)


@register("InstanceNorm", promote="common")
def _instance_norm(data, gamma, beta, eps=1e-3):
    return F.instance_norm(data, weight=gamma, bias=beta, eps=eps)


@register("BatchNormWithReLU", num_outputs=3, visible_outputs=1,
          mutate_inputs=((1, 3), (2, 4)), wrap_train="_training")
def _batch_norm_with_relu(data, gamma, beta, moving_mean, moving_var,
                          **kwargs):
    """BatchNorm, then ReLU; the same moving-statistics contract."""
    out, mm, mv = _batch_norm(data, gamma, beta, moving_mean, moving_var,
                              **kwargs)
    return torch.relu(out), mm, mv


# -- softmax family and normalizations ----------------------------------------

@register("softmin")
def _softmin(data, axis=-1, temperature=None, dtype=None):
    from ..base import torch_dtype
    x = -data
    if temperature:
        x = x / temperature
    r = torch.softmax(x, dim=axis)
    return r.to(torch_dtype(dtype)) if dtype else r


@register("SoftmaxActivation")
def _softmax_activation(data, mode="instance"):
    """Softmax over axis 1 (``mode="channel"``) or over each sample's
    flattened values."""
    if mode == "channel":
        return torch.softmax(data, dim=1)
    return torch.softmax(data.reshape(data.shape[0], -1), dim=-1) \
        .reshape(data.shape)


@register("L2Normalization")
def _l2_normalization(data, eps=1e-10, mode="instance"):
    """``data / sqrt(sum(data^2) + eps)`` over each instance, the channel
    axis or the spatial axes."""
    red = {"instance": tuple(range(1, data.ndim)), "channel": (1,)}.get(
        mode, tuple(range(2, data.ndim)))
    return data / torch.sqrt(torch.sum(data * data, dim=red, keepdim=True)
                             + eps)


@register("LRN")
def _lrn(data, alpha=1e-4, beta=0.75, knorm=2.0, nsize=5):
    """Local response normalization across ``nsize`` channels."""
    half = nsize // 2
    sq = F.pad(data * data, (0, 0) * (data.ndim - 2) + (half, half))
    acc = sum(sq[:, i:i + data.shape[1]] for i in range(nsize))
    return data / torch.pow(knorm + alpha * acc / nsize, beta)


# -- loss heads ---------------------------------------------------------------

class _SoftmaxOutput(torch.autograd.Function):
    """Forward softmax over the last axis; backward ``p - onehot(label)``
    (label smoothing, ignore_label masking, normalization and grad_scale
    as the reference), whatever the head gradient."""

    @staticmethod
    def forward(ctx, data, label, grad_scale, ignore_label, use_ignore,
                normalization, smooth_alpha):
        p = torch.softmax(data, dim=-1)
        ctx.save_for_backward(p, label)
        ctx.attrs = (grad_scale, ignore_label, use_ignore, normalization,
                     smooth_alpha)
        return p

    @staticmethod
    def backward(ctx, g):  # noqa: ARG004 (a loss head ignores it)
        p, label = ctx.saved_tensors
        grad_scale, ignore_label, use_ignore, normalization, smooth = \
            ctx.attrs
        oh = (label.long().unsqueeze(-1) == torch.arange(
            p.shape[-1], device=p.device)).to(p.dtype)
        if smooth:
            oh = oh * (1 - smooth) + smooth / p.shape[-1]
        grad = p - oh
        keep = label != ignore_label
        if use_ignore:
            grad = grad * keep.to(p.dtype)[..., None]
        if normalization == "batch":
            grad = grad / p.shape[0]
        elif normalization == "valid" and use_ignore:
            grad = grad / keep.sum().clamp(min=1).to(p.dtype)
        return (grad * grad_scale, None if not ctx.needs_input_grad[1]
                else torch.zeros_like(label), None, None, None, None, None)


@register("SoftmaxOutput")
def _softmax_output(data, label, grad_scale=1.0, ignore_label=-1.0,
                    multi_output=False, use_ignore=False,
                    preserve_shape=False, normalization="null",
                    out_grad=False, smooth_alpha=0.0):  # noqa: ARG001
    """The legacy classifier head: softmax forward, MXNet's
    ``p - onehot(label)`` backward (``_SoftmaxOutput``)."""
    return _SoftmaxOutput.apply(data, label, grad_scale, ignore_label,
                                use_ignore, normalization, smooth_alpha)


class _RegressionOutput(torch.autograd.Function):
    """Forward ``fwd(data)``; backward ``bwd(out, label) * grad_scale /
    num_output`` (the per-sample output count), whatever the head
    gradient."""

    @staticmethod
    def forward(ctx, data, label, kind, grad_scale):
        out = torch.sigmoid(data) if kind == "logistic" else data.clone()
        ctx.save_for_backward(out, label)
        ctx.kind, ctx.grad_scale = kind, grad_scale
        return out

    @staticmethod
    def backward(ctx, g):  # noqa: ARG004 (a loss head ignores it)
        out, label = ctx.saved_tensors
        diff = out - label.reshape(out.shape).to(out.dtype)
        grad = torch.sign(diff) if ctx.kind == "mae" else diff
        num_output = max(out[0].numel(), 1) if out.ndim > 1 else 1
        return (grad * (ctx.grad_scale / num_output),
                None if not ctx.needs_input_grad[1]
                else torch.zeros_like(label), None, None)


def _regression_head(name, kind, doc):
    def head(data, label, grad_scale=1.0):
        return _RegressionOutput.apply(data, label, kind, grad_scale)
    head.__doc__ = doc
    register(name)(head)


_regression_head("LinearRegressionOutput", "linear",
                 "L2 head: identity forward, gradient out - label.")
_regression_head("MAERegressionOutput", "mae",
                 "L1 head: identity forward, gradient sign(out - label).")
_regression_head("LogisticRegressionOutput", "logistic",
                 "Sigmoid head: sigmoid forward, gradient out - label.")


@register("center_loss", num_outputs=2, visible_outputs=1,
          mutate_inputs=((1, 2),), wrap_train="_training")
def _center_loss(data, label, center, grad_scale=1.0, alpha=0.1,
                 _training=False):
    """0.5 ||data_i - center[label_i]||^2 * grad_scale per sample; the
    centers take no gradient and, while training, each moves toward its
    class: c_j += alpha * sum(diff_j) / (1 + n_j), written back into
    ``center`` by dispatch."""
    li = label.long().reshape(-1)
    c = center.detach()
    diff = data - c[li]
    loss = 0.5 * torch.sum(diff * diff, dim=1) * grad_scale
    if not _training:
        return loss, center
    with torch.no_grad():
        n = torch.zeros(center.shape[0], dtype=data.dtype,
                        device=data.device).index_add_(
            0, li, torch.ones_like(li, dtype=data.dtype))
        s = torch.zeros_like(c).index_add_(0, li, diff.detach().to(c.dtype))
        new_center = c + alpha * s / (1.0 + n)[:, None]
    return loss, new_center.to(center.dtype)


# -- im2col / col2im ----------------------------------------------------------

def _patch_geometry(spatial, kernel, stride, dilate, pad):
    n = len(kernel)
    stride = _norm_tuple(stride, n, 1)
    dilate = _norm_tuple(dilate, n, 1)
    pad = _norm_tuple(pad, n, 0)
    out = tuple((s + 2 * p - d * (k - 1) - 1) // st + 1
                for s, k, st, d, p in zip(spatial, kernel, stride, dilate,
                                          pad))
    return stride, dilate, pad, out


def _taps(kernel, stride, dilate, out):
    """For each kernel offset (channel-major order: k1, k2, ...), the
    strided window of the padded image it reads."""
    import itertools
    for offs in itertools.product(*(range(k) for k in kernel)):
        yield tuple(slice(o * d, o * d + (n - 1) * st + 1, st)
                    for o, d, n, st in zip(offs, dilate, out, stride))


@register("im2col")
def _im2col(data, kernel, stride=(), dilate=(), pad=()):
    """Conv patches of NC(D)HW ``data`` as (N, C * prod(kernel), L)
    columns, channel-major (c, k1, k2, ...), the reference's layout."""
    kernel = tuple(kernel)
    stride, dilate, pad, out = _patch_geometry(data.shape[2:], kernel,
                                               stride, dilate, pad)
    x = F.pad(data, [p for q in reversed(pad) for p in (q, q)])
    cols = [x[(slice(None), slice(None)) + w]
            for w in _taps(kernel, stride, dilate, out)]
    n, c = data.shape[:2]
    return torch.stack(cols, dim=2).reshape(n, -1, math.prod(out))


@register("col2im")
def _col2im(data, output_size, kernel, stride=(), dilate=(), pad=()):
    """im2col's transpose: columns folded back into an image of
    ``output_size``, overlapping patches added."""
    kernel = tuple(kernel)
    spatial = tuple(output_size)
    stride, dilate, pad, out = _patch_geometry(spatial, kernel, stride,
                                               dilate, pad)
    n = data.shape[0]
    c = data.shape[1] // math.prod(kernel)
    cols = data.reshape((n, c, math.prod(kernel)) + out)
    img = torch.zeros((n, c) + tuple(s + 2 * p for s, p in
                                     zip(spatial, pad)),
                      dtype=data.dtype, device=data.device)
    for i, w in enumerate(_taps(kernel, stride, dilate, out)):
        img[(slice(None), slice(None)) + w] += cols[:, :, i]
    return img[(slice(None), slice(None))
               + tuple(slice(p, p + s) for p, s in zip(pad, spatial))]


# -- what the symbolic API reads (mxnet_tpu/ops/nn.py's rules) ----------------
# ``infer_args`` fills a parameter's shape from the data's, as nnvm's
# InferShape pass does for simple_bind; ``_wire_inputs`` declares the inputs
# composition creates as "<name>_<input>" variables when they are not passed.

from .registry import get as _get_op  # noqa: E402


def _fc_infer(shapes, attrs):
    data = shapes[0]
    if data is None:
        return shapes
    nh = attrs.get("num_hidden", 0)
    in_units = math.prod(data[1:]) if attrs.get("flatten", True) \
        else data[-1]
    out = list(shapes)
    if len(out) > 1 and out[1] is None:
        out[1] = (nh, in_units)
    if len(out) > 2 and out[2] is None and not attrs.get("no_bias", False):
        out[2] = (nh,)
    return out


def _conv_infer(shapes, attrs):
    data = shapes[0]
    if data is None:
        return shapes
    k = tuple(attrs.get("kernel", ()))
    nf = attrs.get("num_filter", 0)
    g = attrs.get("num_group", 1)
    out = list(shapes)
    if len(out) > 1 and out[1] is None:
        out[1] = (nf, data[1] // g) + k
    if len(out) > 2 and out[2] is None and not attrs.get("no_bias", False):
        out[2] = (nf,)
    return out


def _deconv_infer(shapes, attrs):
    data = shapes[0]
    if data is None:
        return shapes
    k = tuple(attrs.get("kernel", ()))
    nf = attrs.get("num_filter", 0)
    g = attrs.get("num_group", 1)
    out = list(shapes)
    if len(out) > 1 and out[1] is None:
        out[1] = (data[1], nf // g) + k
    if len(out) > 2 and out[2] is None and not attrs.get("no_bias", True):
        out[2] = (nf,)
    return out


def _channel_infer(axis_of):
    """Every input after the data is (C,), C the data's ``axis_of(attrs)``
    extent."""
    def infer(shapes, attrs):
        if shapes[0] is None:
            return shapes
        c = shapes[0][axis_of(attrs)]
        return [shapes[0]] + [(c,) if s is None else s for s in shapes[1:]]
    return infer


def _embedding_infer(shapes, attrs):
    out = list(shapes)
    if len(out) > 1 and out[1] is None:
        out[1] = (attrs.get("input_dim", 0), attrs.get("output_dim", 0))
    return out


_get_op("FullyConnected").infer_args = _fc_infer
_get_op("Convolution").infer_args = _conv_infer
_get_op("Deconvolution").infer_args = _deconv_infer
_get_op("BatchNorm").infer_args = _channel_infer(
    lambda attrs: attrs.get("axis", 1))
_get_op("LayerNorm").infer_args = _channel_infer(
    lambda attrs: attrs.get("axis", -1))
_get_op("GroupNorm").infer_args = _channel_infer(lambda attrs: 1)
_get_op("InstanceNorm").infer_args = _channel_infer(lambda attrs: 1)
_get_op("Embedding").infer_args = _embedding_infer
_get_op("RNN").infer_args = rnn_infer


def _wire_inputs(opname, names, aux=(), omit=None):
    op = _get_op(opname)
    op.input_names = tuple(names)
    op.aux_names = frozenset(aux)
    op.omit_inputs = omit


def _omit_bias(default):
    return lambda attrs: {"bias"} if attrs.get("no_bias", default) \
        else set()


_wire_inputs("FullyConnected", ("data", "weight", "bias"),
             omit=_omit_bias(False))
_wire_inputs("Convolution", ("data", "weight", "bias"),
             omit=_omit_bias(False))
_wire_inputs("Deconvolution", ("data", "weight", "bias"),
             omit=_omit_bias(True))
_wire_inputs("BatchNorm",
             ("data", "gamma", "beta", "moving_mean", "moving_var"),
             aux=("moving_mean", "moving_var"))
_wire_inputs("LayerNorm", ("data", "gamma", "beta"))
_wire_inputs("InstanceNorm", ("data", "gamma", "beta"))
_wire_inputs("GroupNorm", ("data", "gamma", "beta"))
_wire_inputs("Embedding", ("data", "weight"))
_wire_inputs("RNN", ("data", "parameters", "state", "state_cell"),
             omit=lambda attrs: set()
             if attrs.get("mode", "lstm") == "lstm" else {"state_cell"})
_wire_inputs("SoftmaxOutput", ("data", "label"))
