"""gluon.data.vision.transforms — the port of
``mxnet_tpu/gluon/data/vision/transforms.py``: Compose, Cast, ToTensor,
Normalize, Resize, CenterCrop, RandomResizedCrop (over ``image``'s
resize and crops), the random flips, the random colour jitters
(brightness, contrast, saturation, hue, and all of them in a random
order), RandomLighting and RandomGray.

They run on NDArrays on the input's own context (a DataLoader worker's
samples are on the host).  The random ones draw from Python's ``random``
module (RandomLighting from numpy's), as the reference does, so the same
seeds give both packages the same choices.
"""

from __future__ import annotations

import random as _pyrandom

import numpy as _np

from .... import ndarray as nd
from ....ndarray.ndarray import NDArray
from ...block import Block, HybridBlock
from ...nn import Sequential

__all__ = ["Compose", "Cast", "ToTensor", "Normalize", "Resize", "CenterCrop",
           "RandomResizedCrop", "RandomFlipLeftRight", "RandomFlipTopBottom",
           "RandomBrightness", "RandomContrast", "RandomSaturation",
           "RandomHue", "RandomColorJitter", "RandomLighting", "RandomGray"]

_GRAY = _np.array([0.299, 0.587, 0.114], dtype=_np.float32).reshape(1, 1, 3)


def _const(value, like):
    """A float32 constant beside ``like`` (an NDArray, or a tensor in a
    hybridized block)."""
    if isinstance(like, NDArray):
        return nd.array(value, ctx=like.ctx, dtype=_np.float32)
    import torch
    return torch.as_tensor(_np.asarray(value, _np.float32), device=like.device)


class Compose(Sequential):
    def __init__(self, transforms):
        super().__init__()
        for t in transforms:
            self.add(t)


class Cast(HybridBlock):
    def __init__(self, dtype="float32"):
        super().__init__()
        self._dtype = dtype

    def hybrid_forward(self, F, x):
        return F.cast(x, dtype=self._dtype)


class ToTensor(HybridBlock):
    """HWC (or NHWC) uint8 in [0, 255] -> CHW (NCHW) float32 in [0, 1]."""

    def hybrid_forward(self, F, x):
        x = F.cast(x, dtype="float32") / 255.0
        return F.transpose(x, axes=(2, 0, 1) if x.ndim == 3
                           else (0, 3, 1, 2))


class Normalize(HybridBlock):
    """(x - mean) / std per channel of a CHW image."""

    def __init__(self, mean=0.0, std=1.0):
        super().__init__()
        self._mean = _np.asarray(mean, _np.float32).reshape(-1, 1, 1)
        self._std = _np.asarray(std, _np.float32).reshape(-1, 1, 1)

    def hybrid_forward(self, F, x):
        return F.broadcast_div(F.broadcast_sub(x, _const(self._mean, x)),
                               _const(self._std, x))


class Resize(Block):
    """Resize an HxWxC image to ``size`` ((w, h), or an int: a square, or
    the shorter side with ``keep_ratio``)."""

    def __init__(self, size, keep_ratio=False, interpolation=1):
        super().__init__()
        self._size = size
        self._keep = keep_ratio
        self._interpolation = interpolation

    def forward(self, x):
        from .... import image
        if isinstance(self._size, int):
            if self._keep:
                h, w = x.shape[0], x.shape[1]
                if w < h:
                    size = (self._size, int(h * self._size / w))
                else:
                    size = (int(w * self._size / h), self._size)
            else:
                size = (self._size, self._size)
        else:
            size = self._size
        return image.imresize(x, size[0], size[1], self._interpolation)


class CenterCrop(Block):
    def __init__(self, size, interpolation=1):
        super().__init__()
        self._size = (size, size) if isinstance(size, int) else size
        self._interpolation = interpolation

    def forward(self, x):
        from .... import image
        return image.center_crop(x, self._size, self._interpolation)[0]


class RandomResizedCrop(Block):
    def __init__(self, size, scale=(0.08, 1.0), ratio=(3 / 4, 4 / 3),
                 interpolation=1):
        super().__init__()
        self._size = (size, size) if isinstance(size, int) else size
        self._scale = scale
        self._ratio = ratio
        self._interpolation = interpolation

    def forward(self, x):
        from .... import image
        return image.random_size_crop(x, self._size, self._scale,
                                      self._ratio, self._interpolation)[0]


class _RandomFlip(Block):
    axis = 1

    def forward(self, x):
        if _pyrandom.random() < 0.5:
            return nd.flip(x, axis=self.axis)
        return x


class RandomFlipLeftRight(_RandomFlip):
    axis = 1


class RandomFlipTopBottom(_RandomFlip):
    axis = 0


class _RandomJitter(Block):
    def __init__(self, amount):
        super().__init__()
        self._amount = amount

    def _factor(self):
        return 1.0 + _pyrandom.uniform(-self._amount, self._amount)


class RandomBrightness(_RandomJitter):
    def forward(self, x):
        return (x * self._factor()).clip(0, 255 if x.dtype == _np.uint8
                                         else 1e30)


class RandomContrast(_RandomJitter):
    def forward(self, x):
        f = self._factor()
        x = x.astype("float32")
        return x * f + x.mean() * (1 - f)


def _gray(x):
    return (x * _const(_GRAY, x)).sum(axis=2, keepdims=True)


class RandomSaturation(_RandomJitter):
    def forward(self, x):
        f = self._factor()
        x = x.astype("float32")
        return x * f + _gray(x) * (1 - f)


class RandomHue(_RandomJitter):
    """A hue rotation in YIQ space, as the reference does it."""

    _YIQ = _np.array([[0.299, 0.587, 0.114], [0.596, -0.274, -0.321],
                      [0.211, -0.523, 0.311]], dtype=_np.float32)
    _RGB = _np.array([[1, 0.956, 0.621], [1, -0.272, -0.647],
                      [1, -1.107, 1.705]], dtype=_np.float32)

    def forward(self, x):
        f = _pyrandom.uniform(-self._amount, self._amount)
        u, w = _np.cos(f * _np.pi), _np.sin(f * _np.pi)
        rot = _np.array([[1, 0, 0], [0, u, -w], [0, w, u]], dtype=_np.float32)
        m = self._RGB.dot(rot).dot(self._YIQ).T
        return x.astype("float32").dot(_const(m, x))


class RandomColorJitter(Block):
    def __init__(self, brightness=0, contrast=0, saturation=0, hue=0):
        super().__init__()
        self._ts = []
        for amount, klass in ((brightness, RandomBrightness),
                              (contrast, RandomContrast),
                              (saturation, RandomSaturation),
                              (hue, RandomHue)):
            if amount:
                self._ts.append(klass(amount))

    def forward(self, x):
        ts = list(self._ts)
        _pyrandom.shuffle(ts)
        for t in ts:
            x = t(x)
        return x


class RandomLighting(Block):
    """AlexNet's PCA noise (numpy's generator, as the reference)."""

    _eigval = _np.array([55.46, 4.794, 1.148], dtype=_np.float32)
    _eigvec = _np.array([[-0.5675, 0.7192, 0.4009],
                         [-0.5808, -0.0045, -0.8140],
                         [-0.5836, -0.6948, 0.4203]], dtype=_np.float32)

    def __init__(self, alpha):
        super().__init__()
        self._alpha = alpha

    def forward(self, x):
        a = _np.random.normal(0, self._alpha, size=(3,)).astype(_np.float32)
        rgb = (self._eigvec * a * self._eigval).sum(axis=1)
        return x.astype("float32") + _const(rgb, x)


class RandomGray(Block):
    def __init__(self, p=0.5):
        super().__init__()
        self._p = p

    def forward(self, x):
        if _pyrandom.random() < self._p:
            return nd.tile(_gray(x.astype("float32")), reps=(1, 1, 3))
        return x
