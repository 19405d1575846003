"""2-bit gradient compression with error feedback — the port of
``mxnet_tpu/kvstore/compression.py`` (MXNet's
``src/kvstore/gradient_compression.cc``).

With threshold t, each element of (gradient + residual) becomes +t, -t or
0; the residual keeps what the quantization dropped, so the signal is
unbiased over steps.  The codes are the reference's: 0 for 0, 1 for +t,
2 for -t, four codes a byte with the first in the low bits, the last byte
padded with zero codes, so the packed bytes equal the reference's for the
same gradient.  Quantizing is a few elementwise torch passes and one pack,
on the gradient's device.
"""

from __future__ import annotations

import torch

from ..base import MXNetError

__all__ = ["GradientCompression"]

_SHIFTS = (0, 2, 4, 6)


def _quantize_2bit(grad, residual, t):
    """(packed uint8 codes, new residual) of ``grad + residual`` with the
    threshold ``t`` a 0-d tensor of the gradient's dtype and device."""
    g = grad + residual
    pos, neg = g >= t, g <= -t
    q = torch.where(pos, t, torch.where(neg, -t, 0))
    codes = pos.to(torch.uint8) | (neg.to(torch.uint8) << 1)
    flat = codes.reshape(-1)
    pad = (-flat.numel()) % 4
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    c = flat.view(-1, 4)
    packed = c[:, 0] | (c[:, 1] << 2) | (c[:, 2] << 4) | (c[:, 3] << 6)
    return packed, g - q


def _dequantize_2bit(packed, t, shifts, shape):
    n = 1
    for d in shape:
        n *= int(d)
    codes = ((packed.unsqueeze(-1) >> shifts) & 3).reshape(-1)[:n]
    return torch.where(codes == 1, t, torch.where(codes == 2, -t, 0)) \
        .reshape(tuple(shape))


class GradientCompression:
    """Compressor state: ``compress(key, slot, grad)`` quantizes ``grad``
    plus the running residual of ``(key, slot)`` (one a replica, as MXNet
    keeps one a worker) and returns the packed codes; ``decompress`` gives
    the dense values back."""

    def __init__(self, params):
        params = dict(params or {})
        ctype = params.pop("type", params.pop("compression", "2bit"))
        if ctype != "2bit":
            raise MXNetError(
                f"unsupported gradient compression type {ctype!r}: the "
                "reference implements only '2bit' "
                "(src/kvstore/gradient_compression.cc)")
        self.type = ctype
        self.threshold = float(params.pop("threshold", 0.5))
        if self.threshold <= 0:
            raise MXNetError("gradient compression threshold must be > 0")
        if params:
            raise MXNetError(f"unknown compression params {sorted(params)}")
        self._residuals = {}
        self._consts = {}

    def _const(self, dtype, device):
        """The threshold in ``dtype`` and the code shifts, on ``device``:
        made once (a host scalar copied to the card each call would wait
        for the card)."""
        c = self._consts.get((dtype, device))
        if c is None:
            c = self._consts[(dtype, device)] = (
                torch.tensor(self.threshold, dtype=dtype, device=device),
                torch.tensor(_SHIFTS, dtype=torch.uint8, device=device))
        return c

    def compress(self, key, slot, grad):
        """``grad`` (a tensor) -> (packed uint8 codes, shape, dtype)."""
        rkey = (key, slot)
        res = self._residuals.get(rkey)
        if res is None:
            res = torch.zeros_like(grad)
        t, _ = self._const(grad.dtype, grad.device)
        packed, self._residuals[rkey] = _quantize_2bit(grad, res, t)
        return packed, tuple(grad.shape), grad.dtype

    def decompress(self, packed, shape, dtype):
        t, shifts = self._const(dtype, packed.device)
        return _dequantize_2bit(packed, t, shifts, shape)

    def decompress_sum(self, packed2d, shape, dtype):
        """The sum of the dequantized rows of ``packed2d`` (one process's
        codes a row): t times (count of +t codes - count of -t codes)."""
        t, shifts = self._const(dtype, packed2d.device)
        n = 1
        for d in shape:
            n *= int(d)
        codes = ((packed2d.unsqueeze(-1) >> shifts) & 3).reshape(
            packed2d.shape[0], -1)[:, :n]
        plus = (codes == 1).sum(dim=0).to(dtype)
        minus = (codes == 2).sum(dim=0).to(dtype)
        return ((plus - minus) * t).reshape(tuple(shape))
