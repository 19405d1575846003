"""Vision and detection operators — the port of ``mxnet_tpu/ops/vision.py``.

- ``UpSampling`` (nearest, or bilinear as a grouped transposed convolution
  with the given weight), ``Crop`` and the ``SVMOutput`` loss head, whose
  backward is the one-vs-all hinge gradient (a ``torch.autograd.Function``);
- the sampling ops over one shared bilinear gather (``_bilinear_gather``:
  four taps, each reading zero outside the image): ``GridGenerator``,
  ``BilinearSampler``, ``SpatialTransformer``, ``contrib.roi_align``,
  ``contrib.BilinearResize2D`` and ``contrib.DeformableConvolution``;
- ``ROIPooling`` and ``contrib.PSROIPooling``, ``Correlation`` (one
  displacement at a time) and ``contrib.AdaptiveAvgPooling2D``;
- the SSD and RPN heads ``contrib.MultiBoxPrior``, ``MultiBoxTarget``,
  ``MultiBoxDetection``, ``Proposal`` and ``MultiProposal``, whose greedy
  NMS runs on the tensors' device (``contrib.greedy_nms``), where the
  reference runs it in numpy on the host.

Each computes what the reference computes, its approximations included:
``ROIPooling`` takes the max over a 4 x 4 grid of samples snapped to
pixels in each bin (exact for bins up to 4 px a side), ``roi_align``
samples a fixed 2 x 2 grid a bin when ``sample_ratio`` is -1.  Coordinates
are computed in float32, or float64 for float64 inputs.  Where the
reference sorts with numpy's unstable sort, the port's sorts are stable.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from ..base import MXNetError
from .contrib import _box_iou, compact_rows, greedy_nms
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


# -- the shared bilinear gather ------------------------------------------------

def _coord_dtype(t):
    """float32, or float64 for a float64 tensor."""
    return torch.promote_types(t.dtype, torch.float32)


def _div(a, d):
    """a / d, correctly rounded on every device: CUDA multiplies by the
    reciprocal of a Python divisor, which moves a coordinate that lies on
    a pixel boundary (where the ROI bins snap, floor or ceil) to the
    other side of it."""
    return a / torch.tensor(d, dtype=a.dtype, device=a.device)


def _bilinear_gather(data, xs, ys, batch=None):
    """Sample ``data`` (N, C, H, W) at float pixel coordinates ``xs``/``ys``
    (R, *S) with bilinear interpolation -> (R, C, *S): sample r reads image
    ``batch[r]`` (r when None).  Each of the four taps outside the image
    reads zero (the reference's clamped index weighted by 0)."""
    N, C, H, W = data.shape
    flat = data.permute(0, 2, 3, 1).reshape(N * H * W, C)
    R, S = xs.shape[0], xs.shape[1:]
    b = torch.arange(R, device=data.device) if batch is None \
        else batch.long()
    base = (b * (H * W)).reshape((R,) + (1,) * len(S))
    x0, y0 = torch.floor(xs), torch.floor(ys)
    wx, wy = (xs - x0)[..., None], (ys - y0)[..., None]

    def tap(yi, xi):
        inb = (xi >= 0) & (xi <= W - 1) & (yi >= 0) & (yi <= H - 1)
        idx = base + yi.clamp(0, H - 1).long() * W + xi.clamp(0, W - 1).long()
        return flat[idx] * inb[..., None].to(data.dtype)

    out = (tap(y0, x0) * (1 - wx) * (1 - wy)
           + tap(y0, x0 + 1) * wx * (1 - wy)
           + tap(y0 + 1, x0) * (1 - wx) * wy
           + tap(y0 + 1, x0 + 1) * wx * wy)
    return out.movedim(-1, 1).to(data.dtype)


@register("GridGenerator")
def _grid_generator(data, transform_type="affine", target_shape=(0, 0)):
    """affine: theta (N, 6) -> the sampling grid (N, 2, Ho, Wo) in [-1, 1],
    x then y; warp: a flow (N, 2, H, W) added to the identity grid, scaled
    to [-1, 1]."""
    if transform_type == "affine":
        N = data.shape[0]
        Ho, Wo = target_shape
        dt = _coord_dtype(data)
        ys, xs = torch.meshgrid(
            torch.linspace(-1.0, 1.0, Ho, dtype=dt, device=data.device),
            torch.linspace(-1.0, 1.0, Wo, dtype=dt, device=data.device),
            indexing="ij")
        src = torch.stack([xs, ys, torch.ones_like(xs)]).reshape(3, -1)
        out = torch.einsum("nij,jk->nik", data.reshape(N, 2, 3).to(dt), src)
        return out.reshape(N, 2, Ho, Wo).to(data.dtype)
    N, _, H, W = data.shape
    ys, xs = torch.meshgrid(torch.arange(H, device=data.device),
                            torch.arange(W, device=data.device),
                            indexing="ij")
    gx = 2.0 * (xs + data[:, 0]) / max(W - 1, 1) - 1.0
    gy = 2.0 * (ys + data[:, 1]) / max(H - 1, 1) - 1.0
    return torch.stack([gx, gy], 1).to(data.dtype)


def _sample_with_grid(data, grid):
    """grid (N, 2, Ho, Wo) in [-1, 1] -> bilinear samples (N, C, Ho, Wo):
    -1 is pixel 0 and 1 pixel W - 1 (H - 1)."""
    H, W = data.shape[2], data.shape[3]
    g = grid.to(_coord_dtype(grid))
    xs = (g[:, 0] + 1.0) * (W - 1) / 2.0
    ys = (g[:, 1] + 1.0) * (H - 1) / 2.0
    return _bilinear_gather(data, xs, ys)


@register("BilinearSampler")
def _bilinear_sampler(data, grid, cudnn_off=False):  # noqa: ARG001
    return _sample_with_grid(data, grid)


@register("SpatialTransformer")
def _spatial_transformer(data, loc, target_shape=(0, 0),
                         transform_type="affine", sampler_type="bilinear",
                         cudnn_off=False):  # noqa: ARG001
    """The affine grid of ``loc`` (N, 6), then the bilinear sample."""
    grid = _grid_generator(loc, "affine", tuple(target_shape))
    return _sample_with_grid(data, grid)


# -- ROI pooling ---------------------------------------------------------------

_ROI_POOL_SAMPLES = 4   # samples a bin side, each snapped to a pixel


@register("ROIPooling")
def _roi_pooling(data, rois, pooled_size=(1, 1), spatial_scale=1.0):
    """Max-pool each roi (R, 5) [batch, x1, y1, x2, y2] of ``data`` into a
    (Ph, Pw) grid: the max over 4 x 4 samples a bin, each snapped to its
    pixel (the reference's static-shape form: exact for bins up to 4 px a
    side).  The max's gradient splits evenly among equal values (``amax``),
    as the reference's does."""
    N, C, H, W = data.shape
    Ph, Pw = pooled_size
    s = _ROI_POOL_SAMPLES
    r = rois.to(_coord_dtype(rois))
    x1, y1, x2, y2 = torch.round(r[:, 1:5] * spatial_scale).unbind(1)
    bh = _div(torch.clamp(y2 - y1 + 1, min=1.0), Ph)[:, None]
    bw = _div(torch.clamp(x2 - x1 + 1, min=1.0), Pw)[:, None]
    iy = y1[:, None] + (torch.arange(Ph * s, device=data.device) + 0.5) \
        * _div(bh, s)
    ix = x1[:, None] + (torch.arange(Pw * s, device=data.device) + 0.5) \
        * _div(bw, s)
    yi = torch.round(iy - 0.5).clamp(0, H - 1).long()
    xi = torch.round(ix - 0.5).clamp(0, W - 1).long()
    idx = (r[:, 0].long() * (H * W))[:, None, None] + yi[:, :, None] * W \
        + xi[:, None, :]
    samp = data.permute(0, 2, 3, 1).reshape(N * H * W, C)[idx]
    R = rois.shape[0]
    out = samp.reshape(R, Ph, s, Pw, s, C).amax(dim=(2, 4))
    return out.permute(0, 3, 1, 2)


@register("contrib.roi_align")
def _roi_align(data, rois, pooled_size=(1, 1), spatial_scale=1.0,
               sample_ratio=-1, aligned=False, position_sensitive=False):
    """The mean of ``sample_ratio``^2 bilinear samples a bin (a fixed 2 x 2
    when -1: the reference's static form of the adaptive count);
    ``aligned`` shifts the roi by half a pixel.  ``position_sensitive``
    raises, as in the reference."""
    if position_sensitive:
        raise MXNetError("contrib.roi_align: position_sensitive=True "
                         "(PS-ROI pooling) is not implemented; use "
                         "contrib.PSROIPooling")
    Ph, Pw = pooled_size
    s = int(sample_ratio) if int(sample_ratio) > 0 else 2
    r = rois.to(_coord_dtype(rois))
    offset = 0.5 if aligned else 0.0
    x1, y1, x2, y2 = (r[:, 1:5] * spatial_scale - offset).unbind(1)
    bh = _div(y2 - y1, Ph)[:, None]
    bw = _div(x2 - x1, Pw)[:, None]
    iy = y1[:, None] + (torch.arange(Ph * s, device=data.device) + 0.5) \
        * _div(bh, s)
    ix = x1[:, None] + (torch.arange(Pw * s, device=data.device) + 0.5) \
        * _div(bw, s)
    R = rois.shape[0]
    ys = iy[:, :, None].expand(R, Ph * s, Pw * s)
    xs = ix[:, None, :].expand(R, Ph * s, Pw * s)
    samp = _bilinear_gather(data, xs, ys, batch=r[:, 0])
    C = data.shape[1]
    return samp.reshape(R, C, Ph, s, Pw, s).mean(dim=(3, 5))


@register("contrib.PSROIPooling", promote="common")
def _psroi_pooling(data, rois, spatial_scale=1.0, output_dim=1,
                   pooled_size=7, group_size=0):
    """Position-sensitive ROI pooling (R-FCN): ``data`` (N, D g g, H, W);
    output bin (ph, pw) of each roi (R, 5) averages, over the pixels whose
    centers its edges (floor, ceil) take in, its own channel group
    (D channels at group (ph g // P, pw g // P)) -> (R, D, P, P)."""
    g = int(group_size) if group_size else int(pooled_size)
    P = int(pooled_size)
    N, _, H, W = data.shape
    D = int(output_dim)
    dt = _coord_dtype(rois)
    r = rois.to(dt)
    x0, y0, x1, y1 = (r[:, 1:5] * spatial_scale).unbind(1)
    bw = _div(torch.clamp(x1 - x0, min=0.1), P)[:, None]
    bh = _div(torch.clamp(y1 - y0, min=0.1), P)[:, None]
    p = torch.arange(P, device=data.device)

    def mask(start, size, n):
        """(R, P, n): pixel i in [floor(edge_p), ceil(edge_p+1))."""
        lo = torch.floor(start[:, None] + p * size)
        hi = torch.ceil(start[:, None] + (p + 1) * size)
        i = torch.arange(n, device=data.device, dtype=dt)
        return ((i >= lo[..., None]) & (i < hi[..., None])).to(data.dtype)

    my, mx = mask(y0, bh, H), mask(x0, bw, W)
    cnt = torch.clamp(my.sum(-1)[:, :, None] * mx.sum(-1)[:, None, :],
                      min=1.0)                                  # (R, P, P)
    grp = [min((i * g) // P, g - 1) for i in range(P)]
    sel = data.reshape(N, D, g, g, H, W)[:, :, grp][:, :, :, grp]
    b = r[:, 0].long()
    out = None
    for n in range(N):
        on = (b == n).to(data.dtype)[:, None, None]
        part = torch.einsum("dpqhw,rph,rqw->rdpq", sel[n], my * on, mx)
        out = part if out is None else out + part
    return out / cnt[:, None].to(out.dtype)


# -- correlation and deformable convolution -----------------------------------

@register("Correlation")
def _correlation(data1, data2, kernel_size=1, max_displacement=1, stride1=1,
                 stride2=1, pad_size=0, is_multiply=True):
    """FlowNet's cost volume: for each displacement (dy, dx) in stride2 *
    [-d // stride2, d // stride2]^2 (centered on 0 whatever stride2), the
    mean over channels and the kernel window of data1 times the displaced
    data2 (or |data1 - data2| when not ``is_multiply``), taps outside the
    image reading zero; output positions span the padded image less the
    border d + k // 2, every ``stride1``.  One displacement at a time:
    (N, D^2, Ho, Wo), never D^2 windows of (N, C, H, W)."""
    if kernel_size % 2 == 0:
        raise MXNetError("Correlation: kernel_size must be odd")
    N, C, H, W = data1.shape
    d, k = max_displacement, kernel_size // 2
    m = pad_size + d + k
    a = F.pad(data1, (m, m, m, m))
    b = F.pad(data2, (m, m, m, m))
    Hp, Wp = H + 2 * pad_size, W + 2 * pad_size
    border = d + k
    # rows [border, Hp - border) of the padded image, every stride1
    Ho = len(range(border, Hp - border, stride1))
    Wo = len(range(border, Wp - border, stride1))
    base = d + k

    def window(arr, oy, ox):
        y = base + border + oy
        x = base + border + ox
        return arr[:, :, y:y + (Ho - 1) * stride1 + 1:stride1,
                   x:x + (Wo - 1) * stride1 + 1:stride1]

    radius = d // stride2
    disps = [stride2 * i for i in range(-radius, radius + 1)]
    norm = C * kernel_size * kernel_size
    outs = []
    for dy in disps:
        for dx in disps:
            acc = None
            for ky in range(-k, k + 1):
                for kx in range(-k, k + 1):
                    a_tap, b_tap = window(a, ky, kx), window(b, dy + ky,
                                                             dx + kx)
                    prod = a_tap * b_tap if is_multiply \
                        else (a_tap - b_tap).abs()
                    term = prod.sum(1)
                    acc = term if acc is None else acc + term
            outs.append(acc / norm)
    return torch.stack(outs, 1).to(data1.dtype)


@register("contrib.DeformableConvolution", promote="common")
def _deformable_convolution(data, offset, weight, bias=None, kernel=(3, 3),
                            stride=(1, 1), pad=(0, 0), dilate=(1, 1),
                            num_filter=0, num_group=1,
                            num_deformable_group=1,
                            no_bias=False):  # noqa: ARG001
    """Deformable convolution v1: tap (i, j) of output (y, x) samples the
    zero-padded input bilinearly at (y s + i dil + dy, x s + j dil + dx),
    the offsets (N, 2 kh kw, Ho, Wo) in (dy, dx) pairs per tap; the
    patches are contracted with the weight in one product.  Only
    ``num_group = num_deformable_group = 1``, as in the reference."""
    if num_group != 1 or num_deformable_group != 1:
        raise MXNetError("DeformableConvolution: only num_group=1 and "
                         "num_deformable_group=1 are supported")

    def pair(v):
        return (v, v) if isinstance(v, int) else tuple(v)

    kh, kw = pair(kernel)
    (sh, sw), (ph, pw), (dh, dw) = pair(stride), pair(pad), pair(dilate)
    N, C, H, W = data.shape
    Ho = (H + 2 * ph - dh * (kh - 1) - 1) // sh + 1
    Wo = (W + 2 * pw - dw * (kw - 1) - 1) // sw + 1
    x = F.pad(data, (pw, pw, ph, ph))
    T = kh * kw
    off = offset.reshape(N, T, 2, Ho, Wo).to(_coord_dtype(offset))
    dev = data.device
    ty = torch.tensor([i * dh for i in range(kh) for _ in range(kw)],
                      device=dev)
    tx = torch.tensor([j * dw for _ in range(kh) for j in range(kw)],
                      device=dev)
    py = (torch.arange(Ho, device=dev) * sh)[None, None, :, None] \
        + ty[None, :, None, None] + off[:, :, 0]             # (N, T, Ho, Wo)
    px = (torch.arange(Wo, device=dev) * sw)[None, None, None, :] \
        + tx[None, :, None, None] + off[:, :, 1]
    patches = _bilinear_gather(x, px, py)                    # (N, C, T, Ho, Wo)
    out = torch.einsum("fk,nkp->nfp", weight.reshape(weight.shape[0], -1),
                       patches.reshape(N, C * T, Ho * Wo))
    out = out.reshape(N, weight.shape[0], Ho, Wo)
    if bias is not None and not no_bias:
        out = out + bias.reshape(1, -1, 1, 1)
    return out


# -- the SSD heads --------------------------------------------------------------

@register("contrib.MultiBoxPrior", differentiable=False)
def _multibox_prior(data, sizes=(1.0,), ratios=(1.0,), clip=False,
                    steps=(-1.0, -1.0), offsets=(0.5, 0.5)):
    """Anchors for an (N, C, H, W) feature map: (1, H W A, 4) corners, A =
    len(sizes) + len(ratios) - 1 per cell (every size at ratios[0], then
    sizes[0] at each later ratio)."""
    H, W = data.shape[2], data.shape[3]
    sizes = [float(v) for v in sizes]
    ratios = [float(v) for v in ratios]
    step_y = steps[0] if steps[0] > 0 else 1.0 / H
    step_x = steps[1] if steps[1] > 0 else 1.0 / W
    dev = data.device
    cy = (torch.arange(H, dtype=torch.float32, device=dev) + offsets[0]) \
        * step_y
    cx = (torch.arange(W, dtype=torch.float32, device=dev) + offsets[1]) \
        * step_x
    whs = [(v * math.sqrt(ratios[0]), v / math.sqrt(ratios[0]))
           for v in sizes]
    whs += [(sizes[0] * math.sqrt(v), sizes[0] / math.sqrt(v))
            for v in ratios[1:]]
    wh = torch.tensor(whs, dtype=torch.float32, device=dev)       # (A, 2)
    gy, gx = torch.meshgrid(cy, cx, indexing="ij")
    cxy = torch.stack([gx, gy], -1).reshape(-1, 1, 2)           # (H W, 1, 2)
    out = torch.cat([cxy - wh / 2, cxy + wh / 2], -1).reshape(1, -1, 4)
    return out.clamp(0.0, 1.0) if clip else out


def _center_size(boxes):
    """Corner boxes (..., 4) -> (w, h, cx, cy)."""
    w = boxes[..., 2] - boxes[..., 0]
    h = boxes[..., 3] - boxes[..., 1]
    return w, h, (boxes[..., 0] + boxes[..., 2]) / 2, \
        (boxes[..., 1] + boxes[..., 3]) / 2


@register("contrib.MultiBoxTarget", num_outputs=3, differentiable=False)
def _multibox_target(anchor, label, cls_pred, overlap_threshold=0.5,
                     ignore_label=-1.0, negative_mining_ratio=-1.0,
                     negative_mining_thresh=0.5, minimum_negative_samples=0,
                     variances=(0.1, 0.1, 0.2, 0.2)):
    """Match anchors (1, A, 4) to the ground truths of ``label`` (N, G, 5)
    rows [cls, x0, y0, x1, y1] (cls -1 pads): an anchor whose best IoU
    clears ``overlap_threshold`` takes that box, and each box takes its
    best anchor outright (where two boxes share a best anchor, the later
    row wins, as the reference's scatter does on the CPU).  Returns
    (loc_target (N, A 4), loc_mask (N, A 4), cls_target (N, A)): the
    variance-scaled center-size offsets, 1 where assigned, and 1 + the class
    (0 background).  With ``negative_mining_ratio`` > 0 the hardest
    unassigned anchors below ``negative_mining_thresh`` (by their best
    foreground score of ``cls_pred`` (N, C+1, A), ties by index) stay
    background, ratio x positives of them (at least
    ``minimum_negative_samples``), and the rest take ``ignore_label``."""
    A = anchor.shape[-2]
    anc = anchor.reshape(A, 4)
    aw, ah, acx, acy = _center_size(anc)
    cls, boxes = label[..., 0], label[..., 1:5]
    N, G = cls.shape
    valid = cls >= 0                                             # (N, G)
    ious = torch.where(valid[:, None, :], _box_iou(anc, boxes),
                       torch.tensor(-1.0, dtype=anc.dtype,
                                    device=anc.device))         # (N, A, G)
    best_iou, best_gt = ious.max(2)
    best_anchor = ious.argmax(1)                                 # (N, G)
    claims = (best_anchor[:, :, None]
              == torch.arange(A, device=anc.device)) & valid[..., None]
    g_idx = torch.arange(G, device=anc.device)[None, :, None]
    forced_gt = torch.where(claims, g_idx, -1).amax(1)           # (N, A)
    forced = forced_gt >= 0
    gt_idx = torch.where(forced, forced_gt, best_gt)
    assigned = (best_iou > overlap_threshold) | forced
    g = torch.gather(boxes, 1, gt_idx[..., None].expand(N, A, 4))
    gw, gh, gcx, gcy = _center_size(g)
    gw, gh = gw.clamp(min=1e-12), gh.clamp(min=1e-12)
    loc = torch.stack([(gcx - acx) / aw / variances[0],
                       (gcy - acy) / ah / variances[1],
                       torch.log(gw / aw) / variances[2],
                       torch.log(gh / ah) / variances[3]], -1)   # (N, A, 4)
    m = assigned.to(anc.dtype)[..., None]
    cls_of = torch.gather(cls, 1, gt_idx) + 1
    if float(negative_mining_ratio) > 0:
        neg_score = cls_pred[:, 1:].amax(1)                      # (N, A)
        candidate = ~assigned & (best_iou < negative_mining_thresh)
        num_pos = assigned.sum(1, keepdim=True).to(torch.float32)
        num_neg = torch.clamp(negative_mining_ratio * num_pos,
                              min=float(minimum_negative_samples))
        key = -torch.where(candidate, neg_score,
                           torch.tensor(float("-inf"), dtype=neg_score.dtype,
                                        device=neg_score.device))
        ranked = torch.argsort(torch.argsort(key, dim=1, stable=True),
                               dim=1, stable=True)
        selected = candidate & (ranked < num_neg)
        fill = torch.where(selected, 0.0, float(ignore_label))
    else:
        fill = torch.zeros_like(cls_of)
    cls_t = torch.where(assigned, cls_of, fill.to(cls_of.dtype))
    return ((loc * m).reshape(N, -1), m.expand(N, A, 4).reshape(N, -1),
            cls_t)


def _area(b, offset=0.0):
    return (b[..., 2] - b[..., 0] + offset) * (b[..., 3] - b[..., 1] + offset)


def _iou_clipped(a, b):
    """MultiBoxDetection's IoU: areas clipped at 0, the union at least
    1e-12."""
    l, r = a[..., :, None, :], b[..., None, :, :]
    wh = (torch.minimum(l[..., 2:], r[..., 2:])
          - torch.maximum(l[..., :2], r[..., :2])).clamp(min=0)
    inter = wh[..., 0] * wh[..., 1]

    def area(x):
        side = (x[..., 2:] - x[..., :2]).clamp(min=0)
        return side[..., 0] * side[..., 1]

    return inter / torch.clamp(area(l) + area(r) - inter, min=1e-12)


def _iou_pixels(a, b):
    """Proposal's IoU on pixel boxes: sides + 1, the union at least
    1e-12."""
    l, r = a[..., :, None, :], b[..., None, :, :]
    wh = (torch.minimum(l[..., 2:], r[..., 2:])
          - torch.maximum(l[..., :2], r[..., :2]) + 1).clamp(min=0)
    inter = wh[..., 0] * wh[..., 1]
    return inter / torch.clamp(_area(l, 1.0) + _area(r, 1.0) - inter,
                               min=1e-12)


@register("contrib.MultiBoxDetection", differentiable=False)
def _multibox_detection(cls_prob, loc_pred, anchor, clip=True,
                        threshold=0.01, nms_threshold=0.5,
                        force_suppress=False,
                        variances=(0.1, 0.1, 0.2, 0.2), nms_topk=-1):
    """Decode SSD predictions to (N, A, 6) rows [class, score, x0, y0, x1,
    y1], -1 past the kept ones: a candidate per (anchor, foreground class)
    whose probability of ``cls_prob`` (N, C+1, A) reaches ``threshold``,
    best first (the first ``nms_topk``), then greedy NMS at
    ``nms_threshold`` within a class (across classes with
    ``force_suppress``), on the device."""
    N, _, A = cls_prob.shape
    anc = anchor.reshape(-1, 4)
    aw, ah, acx, acy = _center_size(anc)
    loc = loc_pred.reshape(N, A, 4)
    cx = loc[..., 0] * variances[0] * aw + acx
    cy = loc[..., 1] * variances[1] * ah + acy
    w = torch.exp(loc[..., 2] * variances[2]) * aw
    h = torch.exp(loc[..., 3] * variances[3]) * ah
    boxes = torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1)
    if clip:
        boxes = boxes.clamp(0.0, 1.0)
    prob = cls_prob[:, 1:].reshape(N, -1)                  # (N, C A): c * A + a
    valid = prob >= max(threshold, 1e-12)
    order = torch.sort(torch.where(valid, prob, float("-inf")), dim=1,
                       descending=True, stable=True).indices
    if nms_topk > 0:
        order = order[:, :nms_topk]
    c_cls, c_anchor = order // A, order % A
    c_box = torch.gather(boxes, 1, c_anchor[..., None].expand(-1, -1, 4))
    keep = greedy_nms(c_box, torch.gather(valid, 1, order), nms_threshold,
                      _iou_clipped, None if force_suppress else c_cls)
    rows = torch.cat([c_cls[..., None].to(boxes.dtype),
                      torch.gather(prob, 1, order)[..., None], c_box], -1)
    return compact_rows(rows, keep, A)


# -- the RPN proposals ----------------------------------------------------------

def _rpn_generate_anchors(ratios, scales, stride):
    """Base anchors (A, 4) centered on one stride cell (rcnn's
    generate_anchors, which proposal.cc uses)."""
    base = np.array([0, 0, stride - 1, stride - 1], np.float32)
    w = base[2] - base[0] + 1
    h = base[3] - base[1] + 1
    cx = base[0] + (w - 1) / 2
    cy = base[1] + (h - 1) / 2
    out = []
    for r in ratios:
        ws = np.round(np.sqrt(w * h / r))
        hs = np.round(ws * r)
        for s in scales:
            wss, hss = ws * s, hs * s
            out.append([cx - (wss - 1) / 2, cy - (hss - 1) / 2,
                        cx + (wss - 1) / 2, cy + (hss - 1) / 2])
    return np.asarray(out, np.float32)


@register("contrib.Proposal", differentiable=False, num_outputs=-1)
def _proposal(cls_prob, bbox_pred, im_info, rpn_pre_nms_top_n=6000,
              rpn_post_nms_top_n=300, threshold=0.7, rpn_min_size=16,
              scales=(4, 8, 16, 32), ratios=(0.5, 1, 2), feature_stride=16,
              output_score=False, iou_loss=False):
    """Faster R-CNN's RPN proposals: decode the (dx, dy, dw, dh) deltas
    ``bbox_pred`` (N, 4A, H, W) of every anchor on the feature grid, clip to
    the image (``im_info`` rows [height, width, scale]), drop boxes below
    ``rpn_min_size`` x scale, keep the ``rpn_pre_nms_top_n`` best by the
    foreground score of ``cls_prob`` (N, 2A, H, W), greedy NMS at
    ``threshold`` on the device, and return (N post, 5) rois [n, x1, y1,
    x2, y2] (and (N post, 1) scores with ``output_score``); an image with
    fewer picks repeats its top roi, or [n, 0, 0, 15, 15] with score 0
    when none.  ``iou_loss=True`` raises, as in the reference."""
    if iou_loss:
        raise MXNetError("contrib.Proposal: iou_loss=True (direct corner "
                         "offsets) is not implemented; use the center-size "
                         "delta parameterization")
    N, _, H, W = cls_prob.shape
    dev = cls_prob.device
    anchors = torch.from_numpy(_rpn_generate_anchors(
        ratios, scales, feature_stride)).to(dev)
    A = anchors.shape[0]
    shift_x = torch.arange(W, device=dev, dtype=torch.float32) \
        * feature_stride
    shift_y = torch.arange(H, device=dev, dtype=torch.float32) \
        * feature_stride
    sy, sx = torch.meshgrid(shift_y, shift_x, indexing="ij")
    shifts = torch.stack([sx, sy, sx, sy], -1).reshape(-1, 1, 4)
    allanc = (anchors[None] + shifts).reshape(-1, 4)              # (H W A, 4)
    scores = cls_prob[:, A:].reshape(N, A, H * W).transpose(1, 2) \
        .reshape(N, -1)
    deltas = bbox_pred.reshape(N, A, 4, H * W).permute(0, 3, 1, 2) \
        .reshape(N, -1, 4)
    ws = allanc[:, 2] - allanc[:, 0] + 1
    hs = allanc[:, 3] - allanc[:, 1] + 1
    cx = allanc[:, 0] + (ws - 1) / 2
    cy = allanc[:, 1] + (hs - 1) / 2
    pcx = deltas[..., 0] * ws + cx
    pcy = deltas[..., 1] * hs + cy
    pw = torch.exp(deltas[..., 2].clamp(-10, 10)) * ws
    phh = torch.exp(deltas[..., 3].clamp(-10, 10)) * hs
    ih, iw, iscale = (im_info[:, i:i + 1].to(torch.float32)
                      for i in range(3))
    zero = torch.zeros((), device=dev)
    x1 = torch.minimum(torch.maximum(pcx - (pw - 1) / 2, zero), iw - 1)
    y1 = torch.minimum(torch.maximum(pcy - (phh - 1) / 2, zero), ih - 1)
    x2 = torch.minimum(torch.maximum(pcx + (pw - 1) / 2, zero), iw - 1)
    y2 = torch.minimum(torch.maximum(pcy + (phh - 1) / 2, zero), ih - 1)
    boxes = torch.stack([x1, y1, x2, y2], -1)                     # (N, HWA, 4)
    min_sz = rpn_min_size * iscale
    valid = (x2 - x1 + 1 >= min_sz) & (y2 - y1 + 1 >= min_sz)
    order = torch.sort(torch.where(valid, scores, float("-inf")), dim=1,
                       descending=True, stable=True).indices
    order = order[:, :rpn_pre_nms_top_n]
    c_box = torch.gather(boxes, 1, order[..., None].expand(-1, -1, 4))
    c_score = torch.gather(scores, 1, order)
    keep = greedy_nms(c_box, torch.gather(valid, 1, order), threshold,
                      _iou_pixels)
    post = int(rpn_post_nms_top_n)
    picked = compact_rows(torch.cat([c_box, c_score[..., None]], -1), keep,
                          post, fill=0.0)                         # (N, post, 5)
    n_picked = keep.sum(1)[:, None, None]
    j = torch.arange(post, device=dev)[None, :, None]
    empty = torch.tensor([0.0, 0.0, 15.0, 15.0, 0.0], device=dev)
    top = torch.where(n_picked > 0, picked[:, :1], empty)
    picked = torch.where(j < n_picked, picked, top)
    batch = torch.arange(N, device=dev, dtype=torch.float32)[:, None, None] \
        .expand(N, post, 1)
    rois = torch.cat([batch, picked[..., :4]], -1).reshape(N * post, 5)
    if output_score:
        return rois, picked[..., 4:].reshape(N * post, 1)
    return rois


@register("contrib.MultiProposal", differentiable=False, num_outputs=-1)
def _multi_proposal(cls_prob, bbox_pred, im_info, **kwargs):
    """The batch form of ``contrib.Proposal`` (which loops the batch
    already)."""
    return _proposal(cls_prob, bbox_pred, im_info, **kwargs)


# -- resizing ---------------------------------------------------------------------

@register("contrib.AdaptiveAvgPooling2D")
def _adaptive_avg_pooling2d(data, output_size=(1, 1)):
    """Average-pool NCHW to ``output_size`` with bins [floor(i h / oh),
    ceil((i + 1) h / oh)), which are ``F.adaptive_avg_pool2d``'s."""
    if isinstance(output_size, int):
        output_size = (output_size, output_size)
    if len(output_size) == 1:
        output_size = (output_size[0],) * 2
    return F.adaptive_avg_pool2d(data, (int(output_size[0]),
                                        int(output_size[1])))


@register("contrib.BilinearResize2D")
def _bilinear_resize2d(data, height=0, width=0, scale_height=None,
                       scale_width=None, align_corners=True):
    """Bilinear NCHW resize to ``height``/``width``, or to round(h x
    ``scale_height``) and round(w x ``scale_width``).  ``align_corners``:
    the corners map to the corners (an axis of output size 1 samples pixel
    0); else output i samples (i + 0.5) h / oh - 0.5, clamped into the
    image.  The shared bilinear gather does the blend."""
    n, _, h, w = data.shape
    oh = int(height) if height else int(round(h * (scale_height or 1.0)))
    ow = int(width) if width else int(round(w * (scale_width or 1.0)))
    dt = _coord_dtype(data)

    def axis(size_in, size_out):
        if align_corners and size_out > 1:
            return torch.linspace(0.0, size_in - 1.0, size_out, dtype=dt,
                                  device=data.device)
        if align_corners:
            return torch.zeros(size_out, dtype=dt, device=data.device)
        c = (torch.arange(size_out, dtype=dt, device=data.device) + 0.5) \
            * (size_in / size_out) - 0.5
        return c.clamp(0, size_in - 1)

    ys = axis(h, oh)[:, None].expand(oh, ow)
    xs = axis(w, ow)[None, :].expand(oh, ow)
    return _bilinear_gather(data, xs.expand(n, oh, ow), ys.expand(n, oh, ow))
