"""YOLOv3 with the DarkNet-53 backbone — the port of
``mxnet_tpu/gluon/model_zoo/yolo.py`` (GluonCV's ``yolo3.py`` and
``darknet.py``), with the reference's prefixes, so weights carry across
by name (``convert.load_by_name``).

- ``Darknet``/``darknet53``: conv-BN-leaky stages with residual units,
  returning the stride 8, 16 and 32 features;
- ``YOLOV3``: three detection scales (stride 32 first), each head's raw
  output (B, H W A, 5 + C) = [tx, ty, tw, th, obj, cls...] before the
  sigmoid;
- ``YOLOV3TargetGenerator``: the dense, static-shape targets, computed in
  numpy on the host once a batch, as in the reference (its ignore rule
  uses the anchor priors, not the predictions);
- ``YOLOV3Loss``: sigmoid BCE on objectness, center and class, L2 on the
  log sizes, over the generator's masks;
- ``yolo3_decode``: the boxes of the raw outputs and ``contrib.box_nms``,
  on the outputs' device (the reference decodes in numpy on the host).
"""

from __future__ import annotations

import numpy as _np
import torch

from ...ndarray.ndarray import NDArray
from ...ops.contrib import _box_nms
from ..block import HybridBlock
from ..nn import BatchNorm, Conv2D, HybridSequential

__all__ = ["darknet53", "yolo3_darknet53", "YOLOV3", "YOLOV3Loss",
           "YOLOV3TargetGenerator", "yolo3_decode", "DEFAULT_ANCHORS"]

# COCO-tuned anchors (w, h) in input pixels, 3 per output scale,
# large-stride scale first (stride 32, 16, 8) — the GluonCV defaults
DEFAULT_ANCHORS = (
    ((116, 90), (156, 198), (373, 326)),     # stride 32
    ((30, 61), (62, 45), (59, 119)),         # stride 16
    ((10, 13), (16, 30), (33, 23)),          # stride 8
)


def _conv_bn_leaky(channels, kernel, stride=1, padding=None, prefix=""):
    if padding is None:
        padding = kernel // 2
    blk = HybridSequential(prefix=prefix)
    with blk.name_scope():
        blk.add(Conv2D(channels, kernel, strides=stride, padding=padding,
                       use_bias=False))
        blk.add(BatchNorm(epsilon=1e-5, momentum=0.9))
    blk.add(_Leaky())
    return blk


class _Leaky(HybridBlock):
    def hybrid_forward(self, F, x):
        return F.LeakyReLU(x, slope=0.1)


class DarknetBasicBlock(HybridBlock):
    """1x1 squeeze + 3x3 expand with residual add (darknet53 unit)."""

    def __init__(self, channels, **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            self.body = HybridSequential()
            self.body.add(_conv_bn_leaky(channels // 2, 1))
            self.body.add(_conv_bn_leaky(channels, 3))

    def hybrid_forward(self, F, x):
        return x + self.body(x)


class Darknet(HybridBlock):
    """DarkNet backbone returning the three detection-scale features
    (strides 8, 16, 32 relative to the input)."""

    def __init__(self, layers=(1, 2, 8, 8, 4),
                 channels=(32, 64, 128, 256, 512, 1024), **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            self.stem = _conv_bn_leaky(channels[0], 3)
            self.stages = []
            for i, n in enumerate(layers):
                stage = HybridSequential(prefix=f"stage{i}_")
                with stage.name_scope():
                    stage.add(_conv_bn_leaky(channels[i + 1], 3, stride=2))
                    for _ in range(n):
                        stage.add(DarknetBasicBlock(channels[i + 1]))
                self.register_child(stage, f"stage{i}")
                self.stages.append(stage)

    def hybrid_forward(self, F, x):
        x = self.stem(x)
        feats = []
        for stage in self.stages:
            x = stage(x)
            feats.append(x)
        return feats[-3], feats[-2], feats[-1]   # strides 8, 16, 32


def darknet53(**kwargs):
    """The full DarkNet-53 backbone (GluonCV darknet.py)."""
    return Darknet(layers=(1, 2, 8, 8, 4), **kwargs)


class _YoloDetBlock(HybridBlock):
    """5-conv transition producing the scale's route (for the lateral
    branch) and tip (for the prediction head)."""

    def __init__(self, channels, **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            self.body = HybridSequential()
            for i in range(2):
                self.body.add(_conv_bn_leaky(channels, 1))
                self.body.add(_conv_bn_leaky(channels * 2, 3))
            self.body.add(_conv_bn_leaky(channels, 1))
            self.tip = _conv_bn_leaky(channels * 2, 3)

    def hybrid_forward(self, F, x):
        route = self.body(x)
        return route, self.tip(route)


class YOLOV3(HybridBlock):
    """YOLOv3 detector: backbone -> 3 detection scales -> per-anchor
    raw predictions.

    ``forward(x)`` returns a list of 3 tensors, one per scale
    (stride 32 first), each (B, H*W*A, 5+C) raw (pre-sigmoid) —
    [tx, ty, tw, th, obj, cls...] in the grid parameterization.  Use
    ``YOLOV3Loss`` for training and ``yolo3_decode`` for boxes.
    """

    def __init__(self, backbone=None, classes=80, anchors=DEFAULT_ANCHORS,
                 channels=(512, 256, 128), **kwargs):
        super().__init__(**kwargs)
        self._classes = classes
        self._num_anchors = len(anchors[0])
        self.anchors = anchors
        with self.name_scope():
            self.backbone = backbone if backbone is not None else darknet53()
            self.det_blocks = []
            self.laterals = []
            self.heads = []
            out_ch = self._num_anchors * (5 + classes)
            for i, ch in enumerate(channels):
                blk = _YoloDetBlock(ch, prefix=f"det{i}_")
                self.register_child(blk, f"det{i}")
                self.det_blocks.append(blk)
                head = Conv2D(out_ch, 1, prefix=f"head{i}_")
                self.register_child(head, f"head{i}")
                self.heads.append(head)
                if i < len(channels) - 1:
                    lat = _conv_bn_leaky(channels[i + 1], 1,
                                         prefix=f"lat{i}_")
                    self.register_child(lat, f"lat{i}")
                    self.laterals.append(lat)

    def hybrid_forward(self, F, x):
        b = x.shape[0]
        c8, c16, c32 = self.backbone(x)
        feats = [c32, c16, c8]               # large stride first
        outputs = []
        route = None
        for i, blk in enumerate(self.det_blocks):
            f = feats[i]
            if route is not None:
                up = F.UpSampling(self.laterals[i - 1](route), scale=2,
                                  sample_type="nearest")
                f = F.concat(up, f, dim=1)
            route, tip = blk(f)
            raw = self.heads[i](tip)          # (B, A*(5+C), H, W)
            raw = F.transpose(raw, axes=(0, 2, 3, 1))
            outputs.append(raw.reshape((b, -1, 5 + self._classes)))
        return outputs


def yolo3_darknet53(classes=80, **kwargs):
    """GluonCV ``yolo3_darknet53_coco`` analog (randomly initialized)."""
    return YOLOV3(backbone=darknet53(), classes=classes, **kwargs)


class YOLOV3TargetGenerator:
    """Host-side dense target assignment (numpy) — one call per batch.

    For each gt box the best-IoU anchor (across all scales) is assigned:
    that grid cell's [tx, ty, tw, th, obj=1, one-hot cls] targets are set.
    Anchors whose DECODED prediction would overlap any gt above
    ``ignore_iou`` are excluded from the negative-objectness loss via the
    returned mask (the YOLOv3 ignore rule, applied here statically from
    anchor priors — GluonCV computes it dynamically from predictions; the
    static form keeps the train step shape-stable).

    Returns per scale: obj_t (B,N,1), center_t (B,N,2), scale_t (B,N,2),
    cls_t (B,N,C), pos_mask (B,N,1), neg_mask (B,N,1).
    """

    def __init__(self, classes, anchors=DEFAULT_ANCHORS, strides=(32, 16, 8),
                 input_size=416, ignore_iou=0.5):
        self.classes = classes
        self.anchors = anchors
        self.strides = strides
        self.size = input_size
        self.ignore_iou = ignore_iou

    def _grids(self):
        return [self.size // s for s in self.strides]

    def __call__(self, labels):
        """labels: (B, M, 5) [cls, x0, y0, x1, y1] normalized 0..1,
        -1-padded rows (ImageDetIter contract)."""
        B = labels.shape[0]
        C = self.classes
        grids = self._grids()
        A = len(self.anchors[0])
        out = []
        for g in grids:
            n = g * g * A
            out.append([_np.zeros((B, n, 1), _np.float32),
                        _np.zeros((B, n, 2), _np.float32),
                        _np.zeros((B, n, 2), _np.float32),
                        _np.zeros((B, n, C), _np.float32),
                        _np.zeros((B, n, 1), _np.float32),
                        _np.ones((B, n, 1), _np.float32)])
        flat_anchors = _np.array(
            [a for scale in self.anchors for a in scale], _np.float32)
        for b in range(B):
            for row in labels[b]:
                cls = int(row[0])
                if cls < 0:
                    continue
                x0, y0, x1, y1 = row[1:5] * self.size
                w, h = max(x1 - x0, 1e-3), max(y1 - y0, 1e-3)
                cx, cy = (x0 + x1) / 2, (y0 + y1) / 2
                # best anchor by shape IoU (centered overlap)
                inter = _np.minimum(flat_anchors[:, 0], w) * \
                    _np.minimum(flat_anchors[:, 1], h)
                union = flat_anchors[:, 0] * flat_anchors[:, 1] + w * h \
                    - inter
                ious = inter / union
                best = int(ious.argmax())
                si, ai = divmod(best, A)
                g = grids[si]
                stride = self.strides[si]
                gx, gy = min(int(cx / stride), g - 1), \
                    min(int(cy / stride), g - 1)
                idx = (gy * g + gx) * A + ai
                obj, ctr, scl, clst, pos, neg = out[si]
                obj[b, idx, 0] = 1.0
                ctr[b, idx] = (cx / stride - gx, cy / stride - gy)
                aw, ah = self.anchors[si][ai]
                scl[b, idx] = (_np.log(w / aw), _np.log(h / ah))
                clst[b, idx, cls] = 1.0
                pos[b, idx, 0] = 1.0
                neg[b, idx, 0] = 0.0
                # the static ignore rule: other anchors in cells the gt
                # covers whose prior IoU clears the threshold drop out of
                # the negative loss
                for sj in range(len(grids)):
                    gj = grids[sj]
                    sx0 = max(int(x0 / self.strides[sj]), 0)
                    sx1 = min(int(x1 / self.strides[sj]), gj - 1)
                    sy0 = max(int(y0 / self.strides[sj]), 0)
                    sy1 = min(int(y1 / self.strides[sj]), gj - 1)
                    for aj in range(A):
                        if ious[sj * A + aj] < self.ignore_iou:
                            continue
                        for yy in range(sy0, sy1 + 1):
                            for xx in range(sx0, sx1 + 1):
                                out[sj][5][b, (yy * gj + xx) * A + aj, 0] \
                                    = 0.0
        return out


class YOLOV3Loss:
    """Dense YOLOv3 loss over the generator's static targets: sigmoid-BCE
    objectness (pos + unignored neg) + BCE center + L2 log-wh + BCE class
    (GluonCV yolo3 loss composition)."""

    def __init__(self, obj_weight=1.0, center_weight=2.0, scale_weight=2.0,
                 cls_weight=1.0):
        self.w = (obj_weight, center_weight, scale_weight, cls_weight)

    def __call__(self, F, preds, targets):
        wo, wc, ws, wk = self.w
        total = None
        for raw, (obj_t, ctr_t, scl_t, cls_t, pos, neg) in \
                zip(preds, targets):
            tx_ty = F.slice_axis(raw, axis=-1, begin=0, end=2)
            tw_th = F.slice_axis(raw, axis=-1, begin=2, end=4)
            obj = F.slice_axis(raw, axis=-1, begin=4, end=5)
            cls = F.slice_axis(raw, axis=-1, begin=5, end=None)

            def bce(logit, target, mask):
                per = F.relu(logit) - logit * target + \
                    F.log(1 + F.exp(-F.abs(logit)))
                return (per * mask).sum()

            n_pos = F.maximum(pos.sum(), F.ones_like(pos.sum()))
            l_obj = (bce(obj, obj_t, pos) + bce(obj, obj_t, neg)) / n_pos
            l_ctr = bce(tx_ty, ctr_t, pos) / n_pos
            l_scl = ((tw_th - scl_t) ** 2 * pos).sum() / n_pos
            l_cls = bce(cls, cls_t, pos) / n_pos
            part = wo * l_obj + wc * l_ctr + ws * l_scl + wk * l_cls
            total = part if total is None else total + part
        return total


def yolo3_decode(preds, anchors=DEFAULT_ANCHORS, strides=(32, 16, 8),
                 input_size=416, conf_thresh=0.1, nms_thresh=0.45,
                 topk=100):
    """Decode raw head outputs (NDArrays or tensors) to (B, topk, 6) rows
    [cls, score, x0, y0, x1, y1] (coordinates over the input size),
    NMS-filtered per class by ``contrib.box_nms``, -1 past the kept rows:
    an NDArray on the outputs' device, computed there in float32."""
    rows = []
    for raw, sc_anchors, stride in zip(preds, anchors, strides):
        p = (raw._data if isinstance(raw, NDArray) else raw).detach().float()
        B, A = p.shape[0], len(sc_anchors)
        g = input_size // stride
        xy = torch.sigmoid(p[..., 0:2])
        obj = torch.sigmoid(p[..., 4:5])
        cls = torch.sigmoid(p[..., 5:])
        gy, gx = torch.meshgrid(torch.arange(g, device=p.device),
                                torch.arange(g, device=p.device),
                                indexing="ij")
        grid = torch.stack([gx, gy], -1).reshape(-1, 1, 2)    # (g g, 1, 2)
        anc = torch.tensor(sc_anchors, dtype=torch.float32,
                           device=p.device).reshape(1, A, 2)
        cxy = (xy.reshape(B, -1, A, 2) + grid) * stride
        pwh = torch.exp(p[..., 2:4].reshape(B, -1, A, 2).clamp(-8, 8)) * anc
        sc, cid = (obj * cls).reshape(B, -1, A, cls.shape[-1]).max(-1)
        rows.append(torch.cat(
            [cid[..., None].float(), sc[..., None],
             (cxy - pwh / 2) / input_size, (cxy + pwh / 2) / input_size],
            -1).reshape(B, -1, 6))
    out = _box_nms(torch.cat(rows, 1), overlap_thresh=nms_thresh,
                   valid_thresh=conf_thresh, topk=topk, coord_start=2,
                   score_index=1, id_index=0)
    return NDArray(out[:, :topk])
