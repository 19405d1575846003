"""mx.np.fft — the reference's 18 ``np.fft`` names over ``torch.fft``,
each the registry op ``np.fft.<name>``.  A float32 input transforms to
complex64, float64 to complex128; ``fftfreq`` and ``rfftfreq`` are
float32 (ROADMAP C.7)."""

from __future__ import annotations

import sys as _sys

from . import _fft_impl
from ._dispatch import dispatch as _dispatch

_NAMES = ("fft", "ifft", "rfft", "irfft", "fft2", "ifft2", "fftn", "ifftn",
          "rfft2", "irfft2", "rfftn", "irfftn", "hfft", "ihfft", "fftfreq",
          "rfftfreq", "fftshift", "ifftshift")

_self = _sys.modules[__name__]
for _n in _NAMES:
    setattr(_self, _n, _dispatch("fft." + _n, getattr(_fft_impl, _n)))
del _n
