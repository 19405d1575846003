"""The functions of ``mx.np.fft`` over ``torch.fft``, on tensors (bound
as the registry ops ``np.fft.<name>`` by ``numpy/fft.py``).  numpy's
keywords (``axis``, ``axes``) become torch's ``dim``; an integer input is
transformed as float32."""

from __future__ import annotations

import torch

from ._impl import _a, _dev, _float, _tdt


def _one(fn):
    def impl(a, n=None, axis=-1, norm=None):
        return fn(_float(_a(a)), n=n, dim=int(axis), norm=norm)
    impl.__name__ = fn.__name__
    return impl


def _many(fn, default_axes):
    def impl(a, s=None, axes=default_axes, norm=None):
        return fn(_float(_a(a)), s=s, dim=axes, norm=norm)
    impl.__name__ = fn.__name__
    return impl


fft = _one(torch.fft.fft)
ifft = _one(torch.fft.ifft)
rfft = _one(torch.fft.rfft)
irfft = _one(torch.fft.irfft)
hfft = _one(torch.fft.hfft)
ihfft = _one(torch.fft.ihfft)
fft2 = _many(torch.fft.fft2, (-2, -1))
ifft2 = _many(torch.fft.ifft2, (-2, -1))
rfft2 = _many(torch.fft.rfft2, (-2, -1))
irfft2 = _many(torch.fft.irfft2, (-2, -1))
fftn = _many(torch.fft.fftn, None)
ifftn = _many(torch.fft.ifftn, None)
rfftn = _many(torch.fft.rfftn, None)
irfftn = _many(torch.fft.irfftn, None)


def fftfreq(n, d=1.0, dtype=None):
    return torch.fft.fftfreq(int(n), float(d), dtype=_tdt(dtype) or torch.float32,
                             device=_dev())


def rfftfreq(n, d=1.0, dtype=None):
    return torch.fft.rfftfreq(int(n), float(d), dtype=_tdt(dtype) or torch.float32,
                              device=_dev())


def fftshift(x, axes=None):
    return torch.fft.fftshift(_a(x), dim=axes)


def ifftshift(x, axes=None):
    return torch.fft.ifftshift(_a(x), dim=axes)
