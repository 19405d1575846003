"""Vision operators — the port of the three ops of
``mxnet_tpu/ops/vision.py`` that are not detection ops: ``UpSampling``
(nearest, or bilinear as a grouped transposed convolution with the given
weight), ``Crop`` and the ``SVMOutput`` loss head, whose backward is the
one-vs-all hinge gradient (a ``torch.autograd.Function``).  The sampling,
ROI and detection ops of that module are not ported yet.
"""

from __future__ import annotations

import torch

from .nn import _deconvolution
from .registry import register


@register("UpSampling")
def _upsampling(*args, scale=2, sample_type="nearest", num_args=1,
                num_filter=0, multi_input_mode="concat",
                workspace=0):  # noqa: ARG001
    """nearest: each input's pixels repeated up to the first input's
    size times ``scale``, then concatenated on channels (or summed with
    ``multi_input_mode="sum"``).  bilinear: a stride-``scale``
    transposed convolution of ``args[0]`` with the weight ``args[1]``,
    kernel 2 scale - scale % 2, one group per channel."""
    if sample_type == "bilinear":
        data, weight = args[0], args[1]
        C = data.shape[1]
        k = 2 * scale - scale % 2
        pad = scale // 2
        return _deconvolution(data, weight, None, kernel=(k, k),
                              stride=(scale, scale), pad=(pad, pad),
                              num_filter=num_filter or C, num_group=C,
                              no_bias=True)
    H = args[0].shape[2]
    outs = []
    for a in args[:max(num_args, 1)]:
        s = (H * scale) // a.shape[2]
        outs.append(a.repeat_interleave(s, dim=2).repeat_interleave(s, dim=3))
    if len(outs) == 1:
        return outs[0]
    if multi_input_mode == "sum":
        return sum(outs[1:], outs[0])
    return torch.cat(outs, dim=1)


@register("Crop")
def _crop(data, *like, offset=(0, 0), h_w=(0, 0), num_args=1,
          center_crop=False):  # noqa: ARG001
    """The (h, w) window of ``data`` at ``offset`` (or centered), of size
    ``h_w`` or of the second input's spatial size."""
    th, tw = (like[0].shape[2], like[0].shape[3]) if like else h_w
    H, W = data.shape[2], data.shape[3]
    oy, ox = ((H - th) // 2, (W - tw) // 2) if center_crop else offset
    return data[:, :, oy:oy + th, ox:ox + tw]


class _SVMOutput(torch.autograd.Function):
    """Identity forward; backward the one-vs-all hinge gradient (t = +1 for
    the labeled class, -1 elsewhere): -reg t (L1) or -2 reg t (margin -
    s t) (L2) where margin > s t, else 0, times the head gradient."""

    @staticmethod
    def forward(ctx, scores, label, margin, reg, use_linear):
        ctx.save_for_backward(scores, label)
        ctx.attrs = (margin, reg, use_linear)
        return scores.clone()

    @staticmethod
    def backward(ctx, g):
        scores, label = ctx.saved_tensors
        margin, reg, use_linear = ctx.attrs
        onehot = (label.long().unsqueeze(-1) == torch.arange(
            scores.shape[1], device=scores.device)).to(scores.dtype)
        t = 2.0 * onehot - 1.0
        viol = (margin - scores * t) > 0
        gs = -reg * t if use_linear else -2.0 * reg * t * (margin
                                                          - scores * t)
        gs = torch.where(viol, gs, torch.zeros_like(gs))
        return g * gs, None, None, None, None


@register("SVMOutput")
def _svm_output(data, label, margin=1.0, regularization_coefficient=1.0,
                use_linear=False):
    return _SVMOutput.apply(data, label, margin, regularization_coefficient,
                            use_linear)
