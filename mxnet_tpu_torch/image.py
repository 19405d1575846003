"""mx.image — image decode, resize, crops and augmenters, ``ImageIter`` and
the detection pipeline: the port of ``mxnet_tpu/image.py``.

Decoding goes through the port's codec (``codec``: JPEG in C++, PNG in
Python) where the reference calls cv2.  ``imdecode`` returns an HxWxC uint8
NDArray on the current context, RGB unless ``to_rgb=False`` (then BGR, as
cv2 stores it), HxWx1 for ``flag=0``.

``imresize`` computes cv2's ``resize`` on NDArrays (and tensors) on their
own device, for all five ``interp`` codes (0 nearest, 1 linear, 2 cubic,
3 area, 4 lanczos4): each axis is one weight matrix built to cv2's
definition of that code, and the resize is two matmuls in float32 on the
input's device, rounded and clamped back to uint8 for a uint8 input (so
that the host and the card round alike).  A numpy image takes the same
weights as gathers of a few taps in numpy (what the decode workers use:
they hold numpy only).  The result is within 1 of cv2's on uint8 (cv2
rounds its weights to 11-bit fixed point).

The random crops draw from Python's ``random`` module, as the reference
does; the detection augmenters from numpy's global generator.
"""

from __future__ import annotations

import functools
import math
import os
import random as _pyrandom

import numpy as np
import torch

from .base import MXNetError
from . import ndarray as nd
from .ndarray.ndarray import NDArray

__all__ = ["imdecode", "imread", "imresize", "resize_short", "fixed_crop",
           "center_crop", "random_crop", "random_size_crop",
           "color_normalize", "Augmenter", "HorizontalFlipAug", "CastAug",
           "ColorNormalizeAug", "ResizeAug", "ForceResizeAug",
           "RandomCropAug", "CenterCropAug", "RandomSizedCropAug",
           "CreateAugmenter", "ImageIter",
           "DetAugmenter", "DetBorrowAug", "DetRandomSelectAug",
           "DetHorizontalFlipAug", "DetRandomCropAug", "DetRandomPadAug",
           "CreateDetAugmenter", "ImageDetIter"]


def imdecode(buf, flag=1, to_rgb=True, out=None):  # noqa: ARG001
    """Decode JPEG or PNG bytes into an HxWx3 (``flag=0``: HxWx1) uint8
    NDArray on the current context."""
    from . import codec
    if isinstance(buf, NDArray):
        buf = buf.asnumpy().astype(np.uint8).tobytes()
    img = codec.imdecode_bgr(bytes(buf), 1 if flag else 0)
    if flag and to_rgb:
        img = img[:, :, ::-1]
    if not flag:
        img = img[:, :, None]
    return nd.array(np.ascontiguousarray(img), dtype=np.uint8)


def imread(filename, flag=1, to_rgb=True):
    with open(filename, "rb") as f:
        return imdecode(f.read(), flag, to_rgb)


# -- resize -------------------------------------------------------------------

def _cubic(x):
    """cv2's interpolateCubic (A = -0.75), in float32."""
    x = np.float32(x)
    A = np.float32(-0.75)
    one = np.float32(1)
    c0 = ((A * (x + one) - 5 * A) * (x + one) + 8 * A) * (x + one) - 4 * A
    c1 = ((A + 2) * x - (A + 3)) * x * x + one
    c2 = ((A + 2) * (one - x) - (A + 3)) * (one - x) * (one - x) + one
    return [c0, c1, c2, one - c0 - c1 - c2]


_S45 = 0.70710678118654752440084436210485
_LANCZOS_CS = [(1, 0), (-_S45, -_S45), (0, 1), (_S45, -_S45), (-1, 0),
               (_S45, _S45), (0, -1), (-_S45, _S45)]


def _lanczos4(x):
    """cv2's interpolateLanczos4: float32 weights normalised to sum 1."""
    x = np.float32(x)
    if x < np.finfo(np.float32).eps:
        return [np.float32(v) for v in (0, 0, 0, 1, 0, 0, 0, 0)]
    y0 = -(float(x) + 3) * math.pi * 0.25
    s0, c0 = math.sin(y0), math.cos(y0)
    coeffs, total = [], np.float32(0)
    for i in range(8):
        y = -(float(x) + 3 - i) * math.pi * 0.25
        c = np.float32((_LANCZOS_CS[i][0] * s0 + _LANCZOS_CS[i][1] * c0)
                       / (y * y))
        coeffs.append(c)
        total = np.float32(total + c)
    inv = np.float32(1) / total
    return [np.float32(c * inv) for c in coeffs]


@functools.lru_cache(maxsize=512)
def _taps(n_in, n_out, interp, area_box):
    """cv2.resize along one axis as taps: (index (n_out, K) int64,
    weight (n_out, K) float32), indices clamped into the input (border
    replication); cached per size pair, read-only."""
    if n_in == n_out:
        return (np.arange(n_out)[:, None],
                np.ones((n_out, 1), np.float32))
    inv = n_out / n_in
    scale = 1.0 / inv
    if interp == 0:
        idx = np.minimum(np.floor(np.arange(n_out) * scale).astype(np.int64),
                         n_in - 1)
        return idx[:, None], np.ones((n_out, 1), np.float32)
    if area_box:
        rows = []
        for d in range(n_out):
            f1 = d * scale
            f2 = f1 + scale
            cell = min(scale, n_in - f1)
            s1, s2 = math.ceil(f1), math.floor(f2)
            s2 = min(s2, n_in - 1)
            s1 = min(s1, s2)
            taps = []
            if s1 - f1 > 1e-3:
                taps.append((s1 - 1, np.float32((s1 - f1) / cell)))
            for s in range(s1, s2):
                taps.append((s, np.float32(1.0 / cell)))
            if f2 - s2 > 1e-3:
                taps.append((s2, np.float32(min(min(f2 - s2, 1.0), cell)
                                            / cell)))
            rows.append(taps)
        k = max(len(t) for t in rows)
        idx = np.zeros((n_out, k), np.int64)
        w = np.zeros((n_out, k), np.float32)
        for d, taps in enumerate(rows):
            for j, (s, a) in enumerate(taps):
                idx[d, j], w[d, j] = s, a
        return idx, w
    ksize = {1: 2, 2: 4, 3: 2, 4: 8}[interp]
    k2 = ksize // 2
    idx = np.zeros((n_out, ksize), np.int64)
    w = np.zeros((n_out, ksize), np.float32)
    for d in range(n_out):
        if interp == 3:
            sx = math.floor(d * scale)
            fx = np.float32((d + 1) - (sx + 1) * inv)
            fx = np.float32(0) if fx <= 0 else np.float32(fx - math.floor(fx))
        else:
            fx = np.float32((d + 0.5) * scale - 0.5)
            sx = math.floor(fx)
            fx = np.float32(fx - np.float32(sx))
        if interp in (1, 3):
            if sx < 0:
                fx, sx = np.float32(0), 0
            if sx >= n_in - 1:
                fx, sx = np.float32(0), n_in - 1
            cbuf = [np.float32(1) - fx, fx]
        elif interp == 2:
            cbuf = _cubic(fx)
        else:
            cbuf = _lanczos4(fx)
        for j in range(ksize):
            idx[d, j] = min(max(sx - k2 + 1 + j, 0), n_in - 1)
            w[d, j] = cbuf[j]
    return idx, w


def _resize_taps(h_in, w_in, h_out, w_out, interp):
    if interp not in (0, 1, 2, 3, 4):
        interp = 1
    area_box = interp == 3 and h_in >= h_out and w_in >= w_out
    return (_taps(h_in, h_out, interp, area_box),
            _taps(w_in, w_out, interp, area_box))


def _dense(taps, n_in):
    idx, w = taps
    m = np.zeros((idx.shape[0], n_in), np.float32)
    np.add.at(m, (np.arange(idx.shape[0])[:, None], idx), w)
    return m


@functools.lru_cache(maxsize=64)
def _matrices(h_in, w_in, h_out, w_out, interp, device):
    """The two resize matrices on ``device`` (cached per shape)."""
    ty, tx = _resize_taps(h_in, w_in, h_out, w_out, interp)
    return (torch.from_numpy(_dense(ty, h_in)).to(device),
            torch.from_numpy(_dense(tx, w_in)).to(device))


def _finish(out, dtype):
    if dtype == np.uint8 or dtype == torch.uint8:
        out = out.round().clip(0, 255)
    return out


def resize_numpy(img, w, h, interp=1):
    """cv2.resize(img, (w, h), interpolation=interp) of an HxW(xC) numpy
    image, in numpy (float32 taps)."""
    squeeze = img.ndim == 2
    x = img[:, :, None] if squeeze else img
    (iy, wy), (ix, wx) = _resize_taps(x.shape[0], x.shape[1], h, w, interp)
    xf = x.astype(np.float32)
    rows = sum(wy[:, k, None, None] * xf[iy[:, k]] for k in range(iy.shape[1]))
    out = sum(wx[None, :, k, None] * rows[:, ix[:, k]]
              for k in range(ix.shape[1]))
    out = _finish(out, img.dtype).astype(img.dtype)
    return out[:, :, 0] if squeeze else out


def _resize_tensor(t, w, h, interp):
    """The resize of an HxWxC tensor on its device: two float32 matmuls."""
    my, mx = _matrices(t.shape[0], t.shape[1], h, w, interp, t.device)
    x = t.to(torch.float32)
    hwc = x.shape
    out = (my @ x.reshape(hwc[0], -1)).reshape(h, hwc[1], hwc[2])
    out = (mx @ out.permute(1, 0, 2).reshape(hwc[1], -1)) \
        .reshape(w, h, hwc[2]).permute(1, 0, 2)
    return _finish(out, t.dtype).to(t.dtype).contiguous()


def imresize(src, w, h, interp=1):
    """Resize an HxWxC image to (h, w) as cv2.resize does: an NDArray on
    its own context, a torch tensor on its device, a numpy image in numpy
    (returned as an NDArray on the current context, as the reference)."""
    if isinstance(src, torch.Tensor):
        return _resize_tensor(src if src.ndim == 3 else src[:, :, None],
                              w, h, interp)
    if isinstance(src, NDArray):
        t = src._data
        return NDArray(_resize_tensor(t if t.ndim == 3 else t[:, :, None],
                                      w, h, interp), src._ctx)
    out = resize_numpy(np.asarray(src), w, h, interp)
    if out.ndim == 2:
        out = out[:, :, None]
    return nd.array(out, dtype=out.dtype)


def resize_short(src, size, interp=2):
    h, w = src.shape[0], src.shape[1]
    if h > w:
        new_h, new_w = size * h // w, size
    else:
        new_h, new_w = size, size * w // h
    return imresize(src, new_w, new_h, interp)


def fixed_crop(src, x0, y0, w, h, size=None, interp=2):
    out = src[y0:y0 + h, x0:x0 + w]
    if size is not None and (w, h) != size:
        out = imresize(out, size[0], size[1], interp)
    elif isinstance(out, NDArray):
        out = NDArray(out._data.contiguous().clone(), out._ctx)
    return out


def center_crop(src, size, interp=2):
    h, w = src.shape[0], src.shape[1]
    new_w, new_h = size
    x0 = max((w - new_w) // 2, 0)
    y0 = max((h - new_h) // 2, 0)
    out = fixed_crop(src, x0, y0, min(new_w, w), min(new_h, h), size, interp)
    return out, (x0, y0, new_w, new_h)


def random_crop(src, size, interp=2):
    h, w = src.shape[0], src.shape[1]
    new_w, new_h = min(size[0], w), min(size[1], h)
    x0 = _pyrandom.randint(0, w - new_w)
    y0 = _pyrandom.randint(0, h - new_h)
    out = fixed_crop(src, x0, y0, new_w, new_h, size, interp)
    return out, (x0, y0, new_w, new_h)


def random_size_crop(src, size, area, ratio, interp=2):
    h, w = src.shape[0], src.shape[1]
    src_area = h * w
    if isinstance(area, (int, float)):
        area = (area, 1.0)
    for _ in range(10):
        target_area = _pyrandom.uniform(*area) * src_area
        log_ratio = (np.log(ratio[0]), np.log(ratio[1]))
        new_ratio = np.exp(_pyrandom.uniform(*log_ratio))
        new_w = int(round(np.sqrt(target_area * new_ratio)))
        new_h = int(round(np.sqrt(target_area / new_ratio)))
        if new_w <= w and new_h <= h:
            x0 = _pyrandom.randint(0, w - new_w)
            y0 = _pyrandom.randint(0, h - new_h)
            out = fixed_crop(src, x0, y0, new_w, new_h, size, interp)
            return out, (x0, y0, new_w, new_h)
    return center_crop(src, size, interp)


def _on(value, like):
    """``value`` as a float32 NDArray beside ``like`` (or as numpy)."""
    if isinstance(value, NDArray):
        value = value.asnumpy()
    if isinstance(like, NDArray):
        return nd.array(np.asarray(value, np.float32), ctx=like.ctx)
    return np.asarray(value, np.float32)


def color_normalize(src, mean, std=None):
    src = src.astype(np.float32) if src.dtype == np.uint8 else src
    out = src - _on(mean, src)
    if std is not None:
        out = out / _on(std, src)
    return out


class Augmenter:
    def __init__(self, **kwargs):
        self._kwargs = kwargs

    def __call__(self, src):
        raise NotImplementedError


class ResizeAug(Augmenter):
    def __init__(self, size, interp=2):
        super().__init__(size=size)
        self.size, self.interp = size, interp

    def __call__(self, src):
        return resize_short(src, self.size, self.interp)


class ForceResizeAug(Augmenter):
    def __init__(self, size, interp=2):
        super().__init__(size=size)
        self.size, self.interp = size, interp

    def __call__(self, src):
        return imresize(src, self.size[0], self.size[1], self.interp)


class RandomCropAug(Augmenter):
    def __init__(self, size, interp=2):
        super().__init__(size=size)
        self.size, self.interp = size, interp

    def __call__(self, src):
        return random_crop(src, self.size, self.interp)[0]


class RandomSizedCropAug(Augmenter):
    def __init__(self, size, area=(0.08, 1.0), ratio=(3 / 4, 4 / 3),
                 interp=2):
        super().__init__(size=size, area=area, ratio=ratio)
        self.size, self.area, self.ratio = size, area, ratio
        self.interp = interp

    def __call__(self, src):
        return random_size_crop(src, self.size, self.area, self.ratio,
                                self.interp)[0]


class CenterCropAug(Augmenter):
    def __init__(self, size, interp=2):
        super().__init__(size=size)
        self.size, self.interp = size, interp

    def __call__(self, src):
        return center_crop(src, self.size, self.interp)[0]


class HorizontalFlipAug(Augmenter):
    def __init__(self, p=0.5):
        super().__init__(p=p)
        self.p = p

    def __call__(self, src):
        if _pyrandom.random() < self.p:
            return src.flip(axis=1)
        return src


class CastAug(Augmenter):
    def __init__(self, typ=np.float32):
        super().__init__(typ=typ)
        self.typ = typ

    def __call__(self, src):
        return src.astype(self.typ)


class ColorNormalizeAug(Augmenter):
    def __init__(self, mean, std):
        super().__init__()
        self.mean = np.asarray(mean, np.float32)
        self.std = None if std is None else np.asarray(std, np.float32)

    def __call__(self, src):
        return color_normalize(src, self.mean, self.std)


def CreateAugmenter(data_shape, resize=0, rand_crop=False, rand_resize=False,
                    rand_mirror=False, mean=None, std=None, brightness=0,
                    contrast=0, saturation=0, hue=0, pca_noise=0,
                    rand_gray=0, inter_method=2):  # noqa: ARG001
    """The standard augmenter list (the reference's CreateAugmenter)."""
    auglist = []
    if resize > 0:
        auglist.append(ResizeAug(resize, inter_method))
    crop_size = (data_shape[2], data_shape[1])
    if rand_resize:
        auglist.append(RandomSizedCropAug(crop_size, (0.08, 1.0),
                                          (3 / 4, 4 / 3), inter_method))
    elif rand_crop:
        auglist.append(RandomCropAug(crop_size, inter_method))
    else:
        auglist.append(CenterCropAug(crop_size, inter_method))
    if rand_mirror:
        auglist.append(HorizontalFlipAug(0.5))
    auglist.append(CastAug())
    if mean is True:
        mean = np.array([123.68, 116.28, 103.53])
    if std is True:
        std = np.array([58.395, 57.12, 57.375])
    if mean is not None and not isinstance(mean, bool):
        auglist.append(ColorNormalizeAug(np.asarray(mean),
                                         np.asarray(std)
                                         if std is not None else None))
    return auglist


class ImageIter:
    """Python-side augmenting iterator over a .rec or an image list (the
    reference's ImageIter).  Samples decode and augment on the current
    context; batches are NDArrays on the current context."""

    def __init__(self, batch_size, data_shape, label_width=1,
                 path_imgrec=None, path_imglist=None, path_root="",
                 shuffle=False, aug_list=None, imglist=None, **kwargs):
        self.batch_size = batch_size
        self.data_shape = tuple(data_shape)
        self.label_width = label_width
        self.auglist = aug_list if aug_list is not None else \
            CreateAugmenter(data_shape, **kwargs)
        self.shuffle = shuffle
        self._rec = None
        self.imglist = []
        if path_imgrec:
            from . import recordio
            idx = os.path.splitext(path_imgrec)[0] + ".idx"
            self._rec = recordio.MXIndexedRecordIO(idx, path_imgrec, "r")
            self.seq = list(self._rec.keys)
        elif path_imglist or imglist is not None:
            if path_imglist:
                with open(path_imglist) as fin:
                    for line in fin:
                        parts = line.strip().split("\t")
                        # label_width=-1: every middle column (the packed
                        # variable-width detection format)
                        stop = len(parts) - 1 if label_width < 0 \
                            else 1 + label_width
                        label = np.asarray(parts[1:stop], dtype=np.float32)
                        self.imglist.append(
                            (label, os.path.join(path_root, parts[-1])))
            else:
                for item in imglist:
                    self.imglist.append(
                        (np.asarray(item[:-1], np.float32),
                         os.path.join(path_root, item[-1])))
            self.seq = list(range(len(self.imglist)))
        else:
            raise MXNetError("need path_imgrec, path_imglist or imglist")
        self.cur = 0
        self._rec_cache = {}   # read-ahead window (key -> record bytes)
        self.reset()

    def reset(self):
        self.cur = 0
        if self.shuffle:
            _pyrandom.shuffle(self.seq)

    def next_sample(self):
        if self.cur >= len(self.seq):
            raise StopIteration
        idx = self.seq[self.cur]
        self.cur += 1
        if self._rec is not None:
            from . import recordio
            header, img_bytes = recordio.unpack(self._read_rec(idx))
            return header.label, imdecode(img_bytes)
        label, fname = self.imglist[idx]
        return label, imread(fname)

    def _read_rec(self, idx):
        """Record bytes of key ``idx`` from a read-ahead window: one bulk
        read per window of the epoch's sequence."""
        hit = self._rec_cache.get(idx)
        if hit is not None:
            return hit
        pos = self.cur - 1
        window = self.seq[pos:pos + max(2 * self.batch_size, 64)]
        self._rec_cache = dict(zip(window, self._rec.read_batch(window)))
        return self._rec_cache[idx]

    def __iter__(self):
        return self

    def __next__(self):
        from .io.io import DataBatch
        if self.label_width < 0:
            raise MXNetError(
                "label_width=-1 (variable-width packed labels) has no "
                "fixed batch layout; iterate with ImageDetIter instead")
        c, h, w = self.data_shape
        batch_data = np.zeros((self.batch_size, c, h, w), np.float32)
        batch_label = np.zeros((self.batch_size, self.label_width),
                               np.float32)
        for i in range(self.batch_size):
            label, img = self.next_sample()
            for aug in self.auglist:
                img = aug(img)
            arr = img.asnumpy() if isinstance(img, NDArray) else img
            batch_data[i] = arr.transpose(2, 0, 1)
            batch_label[i] = label
        return DataBatch([nd.array(batch_data)],
                         [nd.array(batch_label.squeeze(-1)
                                   if self.label_width == 1 else batch_label)],
                         pad=0)

    next = __next__


# -- the detection pipeline ---------------------------------------------------
# Labels are object lists [cls, xmin, ymin, xmax, ymax, ...] with coordinates
# normalized to [0, 1]; the packed header is [A, B, <A-2 extras>, objs] where A
# is the header width and B the width of an object (im2rec --pack-label).


class DetAugmenter:
    """``__call__(src, label) -> (src, label)``; label is an (N, B >= 5)
    float array of [cls, x0, y0, x1, y1, ...]."""

    def __init__(self, **kwargs):
        self._kwargs = kwargs

    def __call__(self, src, label):
        raise NotImplementedError


class DetBorrowAug(DetAugmenter):
    """An image-only Augmenter (colour, cast, resize: normalized boxes do
    not move)."""

    def __init__(self, augmenter):
        super().__init__(augmenter=augmenter.__class__.__name__)
        self.augmenter = augmenter

    def __call__(self, src, label):
        return self.augmenter(src), label


class DetRandomSelectAug(DetAugmenter):
    """Apply a sub-chain unless a draw falls below ``skip_prob``."""

    def __init__(self, aug_list, skip_prob=0.0):
        super().__init__(skip_prob=skip_prob)
        self.aug_list = list(aug_list)
        self.skip_prob = skip_prob

    def __call__(self, src, label):
        if np.random.rand() >= self.skip_prob:
            for aug in self.aug_list:
                src, label = aug(src, label)
        return src, label


class DetHorizontalFlipAug(DetAugmenter):
    """Mirror the image and its boxes with probability p."""

    def __init__(self, p=0.5):
        super().__init__(p=p)
        self.p = p

    def __call__(self, src, label):
        if np.random.rand() < self.p:
            src = src[:, ::-1]
            label = label.copy()
            x0 = label[:, 1].copy()
            label[:, 1] = 1.0 - label[:, 3]
            label[:, 3] = 1.0 - x0
        return src, label


def _box_coverage(boxes, crop):
    """Share of each box's area inside crop (normalized corners)."""
    ix0 = np.maximum(boxes[:, 0], crop[0])
    iy0 = np.maximum(boxes[:, 1], crop[1])
    ix1 = np.minimum(boxes[:, 2], crop[2])
    iy1 = np.minimum(boxes[:, 3], crop[3])
    inter = np.maximum(ix1 - ix0, 0) * np.maximum(iy1 - iy0, 0)
    area = np.maximum((boxes[:, 2] - boxes[:, 0])
                      * (boxes[:, 3] - boxes[:, 1]), 1e-12)
    return inter / area


class DetRandomCropAug(DetAugmenter):
    """SSD's random crop: draw (area, aspect) crops until one keeps an
    object at coverage >= min_object_covered; objects below
    min_eject_coverage go, the rest are clipped to the crop."""

    def __init__(self, min_object_covered=0.3, aspect_ratio_range=(0.75, 1.33),
                 area_range=(0.3, 1.0), min_eject_coverage=0.3,
                 max_attempts=30):
        super().__init__(min_object_covered=min_object_covered,
                         aspect_ratio_range=aspect_ratio_range,
                         area_range=area_range,
                         min_eject_coverage=min_eject_coverage,
                         max_attempts=max_attempts)
        self.min_object_covered = min_object_covered
        self.aspect_ratio_range = aspect_ratio_range
        self.area_range = area_range
        self.min_eject_coverage = min_eject_coverage
        self.max_attempts = max_attempts

    def _sample_crop(self, label):
        for _ in range(self.max_attempts):
            area = np.random.uniform(*self.area_range)
            ratio = np.random.uniform(*self.aspect_ratio_range)
            cw = min(np.sqrt(area * ratio), 1.0)
            ch = min(np.sqrt(area / ratio), 1.0)
            cx = np.random.uniform(0, 1 - cw)
            cy = np.random.uniform(0, 1 - ch)
            crop = (cx, cy, cx + cw, cy + ch)
            if len(label) == 0:
                return crop
            cov = _box_coverage(label[:, 1:5], crop)
            if (cov >= self.min_object_covered).any():
                return crop
        return None

    def __call__(self, src, label):
        crop = self._sample_crop(label)
        if crop is None:
            return src, label
        h, w = src.shape[:2]
        x0, y0, x1, y1 = crop
        px0, py0 = int(x0 * w), int(y0 * h)
        px1, py1 = max(int(x1 * w), px0 + 1), max(int(y1 * h), py0 + 1)
        src = src[py0:py1, px0:px1]
        if len(label):
            cov = _box_coverage(label[:, 1:5], crop)
            label = label[cov >= self.min_eject_coverage].copy()
            cw, ch = x1 - x0, y1 - y0
            label[:, 1] = np.clip((label[:, 1] - x0) / cw, 0, 1)
            label[:, 2] = np.clip((label[:, 2] - y0) / ch, 0, 1)
            label[:, 3] = np.clip((label[:, 3] - x0) / cw, 0, 1)
            label[:, 4] = np.clip((label[:, 4] - y0) / ch, 0, 1)
        return src, label


class DetRandomPadAug(DetAugmenter):
    """Zoom out: the image on a larger pad_val canvas, boxes shrunk."""

    def __init__(self, aspect_ratio_range=(0.75, 1.33), area_range=(1.0, 3.0),
                 max_attempts=30, pad_val=(127, 127, 127)):
        super().__init__(aspect_ratio_range=aspect_ratio_range,
                         area_range=area_range, max_attempts=max_attempts,
                         pad_val=pad_val)
        self.aspect_ratio_range = aspect_ratio_range
        self.area_range = area_range
        self.max_attempts = max_attempts
        self.pad_val = pad_val

    def __call__(self, src, label):
        h, w = src.shape[:2]
        for _ in range(self.max_attempts):
            area = np.random.uniform(*self.area_range)
            ratio = np.random.uniform(*self.aspect_ratio_range)
            nw = int(w * np.sqrt(area * ratio))
            nh = int(h * np.sqrt(area / ratio))
            if nw >= w and nh >= h:
                ox = np.random.randint(0, nw - w + 1)
                oy = np.random.randint(0, nh - h + 1)
                canvas = np.full((nh, nw, src.shape[2]),
                                 np.asarray(self.pad_val, src.dtype),
                                 src.dtype)
                canvas[oy:oy + h, ox:ox + w] = src
                if len(label):
                    label = label.copy()
                    label[:, 1] = (label[:, 1] * w + ox) / nw
                    label[:, 3] = (label[:, 3] * w + ox) / nw
                    label[:, 2] = (label[:, 2] * h + oy) / nh
                    label[:, 4] = (label[:, 4] * h + oy) / nh
                return canvas, label
        return src, label


class _NumpyNormalize(Augmenter):
    def __init__(self, mean, std):
        super().__init__()
        self.mean, self.std = mean, std

    def __call__(self, src):
        return (np.asarray(src, np.float32) - self.mean) / self.std


def CreateDetAugmenter(data_shape, resize=0, rand_crop=0, rand_pad=0,
                       rand_mirror=False, mean=None, std=None,
                       min_object_covered=0.3, min_eject_coverage=0.3,
                       aspect_ratio_range=(0.75, 1.33),
                       area_range=(0.3, 3.0), max_attempts=30,
                       pad_val=(127, 127, 127), **kwargs):  # noqa: ARG001
    """The standard detection augmenter chain; rand_crop/rand_pad are
    probabilities (each wrapped in a DetRandomSelectAug)."""
    auglist = []
    if resize > 0:
        auglist.append(DetBorrowAug(ResizeAug(resize)))
    if rand_crop > 0:
        crop = DetRandomCropAug(
            min_object_covered=min_object_covered,
            aspect_ratio_range=aspect_ratio_range,
            area_range=(min(area_range[0], 1.0), min(area_range[1], 1.0)),
            min_eject_coverage=min_eject_coverage,
            max_attempts=max_attempts)
        auglist.append(DetRandomSelectAug([crop],
                                          skip_prob=1.0 - rand_crop))
    if rand_pad > 0:
        pad = DetRandomPadAug(
            aspect_ratio_range=aspect_ratio_range,
            area_range=(max(area_range[0], 1.0), max(area_range[1], 1.0)),
            max_attempts=max_attempts, pad_val=pad_val)
        auglist.append(DetRandomSelectAug([pad], skip_prob=1.0 - rand_pad))
    if rand_mirror:
        auglist.append(DetHorizontalFlipAug(0.5))
    # the network's input size last (normalized boxes do not change)
    auglist.append(DetBorrowAug(ForceResizeAug(
        (data_shape[2], data_shape[1]))))
    if mean is not None or std is not None:
        mean = np.asarray(mean if mean is not None else [0, 0, 0],
                          np.float32)
        std = np.asarray(std if std is not None else [1, 1, 1], np.float32)
        auglist.append(DetBorrowAug(_NumpyNormalize(mean, std)))
    return auglist


def _parse_det_label(raw):
    """Packed header label -> (N, B) object array ([A, B, extras, objs])."""
    raw = np.asarray(raw, np.float32).ravel()
    if raw.size < 2:
        return np.zeros((0, 5), np.float32)
    A, B = int(raw[0]), int(raw[1])
    if A < 2 or B < 5 or raw.size < A:
        raise MXNetError(
            f"invalid packed detection label: header ({raw[:2]}), "
            f"size {raw.size}")
    objs = raw[A:]
    n = objs.size // B
    return objs[: n * B].reshape(n, B).copy()


class ImageDetIter(ImageIter):
    """Detection iterator over packed records or a .lst: batches of data
    (N, C, H, W) and label (N, max_objs, B), unused object slots -1.
    ``label_shape`` fixes (max_objs, B); None infers it from the labels
    (the first 1024 records of a .rec)."""

    def __init__(self, batch_size, data_shape, path_imgrec=None,
                 path_imglist=None, path_root="", shuffle=False,
                 label_shape=None, aug_list=None, imglist=None, **kwargs):
        if aug_list is None:
            aug_list = CreateDetAugmenter(data_shape, **kwargs)
        super().__init__(batch_size, data_shape, label_width=-1,
                         path_imgrec=path_imgrec, path_imglist=path_imglist,
                         path_root=path_root, shuffle=shuffle,
                         aug_list=[], imglist=imglist)
        self.det_auglist = aug_list
        self.label_shape = tuple(label_shape) if label_shape \
            else self._infer_label_shape()

    _LABEL_SCAN_LIMIT = 1024

    def _infer_label_shape(self):
        max_objs, width = 1, 5
        if self._rec is not None:
            from . import recordio
            if len(self.seq) > self._LABEL_SCAN_LIMIT:
                import warnings
                warnings.warn(
                    f"ImageDetIter: inferring label_shape from the first "
                    f"{self._LABEL_SCAN_LIMIT} of {len(self.seq)} records; "
                    "later records with more objects are truncated at "
                    "batch time; pass label_shape=(max_objs, width) for "
                    "exact bounds", stacklevel=3)
            labels = [recordio.unpack(self._rec.read_idx(k))[0].label
                      for k in self.seq[:self._LABEL_SCAN_LIMIT]]
        else:
            labels = [label for label, _ in self.imglist]
        for label in labels:
            objs = _parse_det_label(label)
            max_objs = max(max_objs, objs.shape[0])
            width = max(width, objs.shape[1] if objs.size else 5)
        return (max_objs, width)

    def __next__(self):
        from .io.io import DataBatch
        c, h, w = self.data_shape
        m, bwidth = self.label_shape
        batch_data = np.zeros((self.batch_size, c, h, w), np.float32)
        batch_label = np.full((self.batch_size, m, bwidth), -1.0, np.float32)
        for i in range(self.batch_size):
            raw_label, img = self.next_sample()
            label = _parse_det_label(raw_label)
            img = img.asnumpy() if isinstance(img, NDArray) else img
            for aug in self.det_auglist:
                img, label = aug(img, label)
            img = img.asnumpy() if isinstance(img, NDArray) else img
            n = min(len(label), m)
            bw = min(label.shape[1], bwidth) if label.size else bwidth
            if n:
                batch_label[i, :n, :bw] = label[:n, :bw]
            batch_data[i] = np.asarray(img, np.float32).transpose(2, 0, 1)
        return DataBatch([nd.array(batch_data)], [nd.array(batch_label)],
                         pad=0)

    next = __next__
