"""INT8 quantization operators — the port of
``mxnet_tpu/ops/quantization.py`` (MXNet's ``src/operator/quantization/``):
``contrib.quantize_v2``, ``contrib.dequantize``, ``contrib.requantize``,
``contrib.quantized_dot``, ``contrib.quantized_fully_connected`` and
``contrib.quantized_conv``.

The reference's conventions hold: signed symmetric int8 only (``real =
max(|min|, |max|)``, ``scale = 127 / real``, values clipped to +-127,
rounding half to even), every op carrying (data, min, max) triples, a
product's range the product of its operands' ranges, and the int8 x int8
contraction summed exactly in int32.

The products are the library's int8 GEMM: ``torch._int_mm`` (cuBLASLt's
int8 kernels on the card, int32 out; the CPU's own kernel on the host),
never a float matmul, so an int32 sum is exact at any depth (BERT's FFN
reaches 127^2 * 3072 = 5.0e7, past float32's 2^24).  ``_int_mm`` on CUDA
wants more than 16 rows and K and N multiples of 8: :func:`int8_matmul`
zero-pads the operands up to that (on either device, so the CPU tests run
the padding too), which leaves every int32 sum unchanged.  Torch has no
int8 convolution on CUDA: ``quantized_conv`` gathers the int8 patches
(``Tensor.unfold`` views, one int8 copy) and runs the same GEMM.

A calibrated range is a constant, computed on the host in float32 as the
reference's ``jnp.float32`` arithmetic is; an online range (the data's min
and max) stays a 0-d tensor on the data's device, so no op reads a range
back to the host.  Constants enter the device arithmetic as kernel
arguments (``torch.full``), never by a host-to-device copy.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .registry import register

__all__ = ["QMAX", "int8_matmul", "quantize", "dequantize",
           "product_range", "quantized_fc", "quantized_conv2d"]

QMAX = {"int8": 127.0, "uint8": 255.0}
_Q = np.float32(QMAX["int8"])
_TINY = np.float32(1e-12)


def _is_const(v):
    return not isinstance(v, torch.Tensor)


def _tensor(v, device):
    """``v`` as a tensor on ``device``: a constant becomes a 0-d float32
    tensor filled by a kernel (no host copy)."""
    if isinstance(v, torch.Tensor):
        return v
    return torch.full((), float(np.float32(v)), dtype=torch.float32,
                      device=device)


def _real(lo, hi, device):
    """max(|lo|, |hi|): a float32 numpy scalar when both are constants,
    else a 0-d tensor."""
    if _is_const(lo) and _is_const(hi):
        return np.maximum(np.abs(np.float32(lo)), np.abs(np.float32(hi)))
    return torch.maximum(_tensor(lo, device).abs(), _tensor(hi, device).abs())


def _div(num, den, device):
    """num / den in float32, as a constant or a 0-d tensor (a tensor
    divisor: CUDA multiplies by the reciprocal of a Python divisor)."""
    if _is_const(num) and _is_const(den):
        return np.float32(np.float32(num) / np.float32(den))
    return _tensor(num, device) / _tensor(den, device)


def _mul(a, b, device):
    if _is_const(a) and _is_const(b):
        return np.float32(np.float32(a) * np.float32(b))
    return _tensor(a, device) * _tensor(b, device)


def _scaled(x, scale):
    """float32 ``x * scale`` (a float32 constant or a 0-d tensor)."""
    x = x.to(torch.float32)
    return x * (float(scale) if _is_const(scale) else scale)


def _to_int8(f):
    return torch.clamp(torch.round(f), -127, 127).to(torch.int8)


def quantize(data, real):
    """``data`` in int8 against the symmetric range ``real``."""
    return _to_int8(_scaled(data, _div(_Q, real, data.device)))


def dequantize(q, real):
    """An int8 (``real / 127`` a step) or int32 product (``real / 127^2``)
    back to float32."""
    den = _Q * _Q if q.dtype == torch.int32 else _Q
    return _scaled(q, _div(real, den, q.device))


def product_range(real_a, real_b, device):
    """The range of an int8 product: the product of its operands'."""
    return _mul(real_a, real_b, device)


def _round_up(n, m):
    return -(-n // m) * m


def int8_matmul(a, b_t):
    """(M, K) int8 @ (N, K)^T int8 -> (M, N) int32 through ``_int_mm``,
    the second operand column-major (cuBLASLt's int8 layout); rows padded
    above 16, K and N to multiples of 8, with zeros."""
    M, K = a.shape
    N = b_t.shape[0]
    Mp, Kp, Np = max(M, 17), _round_up(K, 8), _round_up(N, 8)
    if (Mp, Kp) != (M, K):
        a = F.pad(a, (0, Kp - K, 0, Mp - M))
    if (Np, Kp) != (N, K):
        b_t = F.pad(b_t, (0, Kp - K, 0, Np - N))
    out = torch._int_mm(a.contiguous(), b_t.contiguous().t())
    if (Mp, Np) != (M, N):
        out = out[:M, :N]
    return out


def _ranges(min_a, max_a, min_b, max_b, device):
    return product_range(_real(min_a, max_a, device),
                         _real(min_b, max_b, device), device)


def _range_pair(real, device):
    real = _tensor(real, device)
    return -real, real


def quantized_fc(qx, qw, flatten=True):
    """int8 x (..., K) . int8 w (N, K)^T -> int32 (..., N)."""
    if flatten and qx.ndim > 2:
        qx = qx.reshape(qx.shape[0], -1)
    lead = qx.shape[:-1]
    out = int8_matmul(qx.reshape(-1, qx.shape[-1]), qw)
    return out.reshape(*lead, qw.shape[0])


def _pair(v):
    return (v, v) if isinstance(v, int) else tuple(v)


def quantized_conv2d(qx, qw, stride=(1, 1), pad=(0, 0), dilate=(1, 1)):
    """NCHW int8 x, OIHW int8 w -> NCHW int32: the patches gathered by
    ``unfold`` views and multiplied by :func:`int8_matmul`."""
    stride, pad, dilate = _pair(stride), _pair(pad), _pair(dilate)
    N, C, _, _ = qx.shape
    O, _, kh, kw = qw.shape
    if pad != (0, 0):
        qx = F.pad(qx, (pad[1], pad[1], pad[0], pad[0]))
    eh, ew = dilate[0] * (kh - 1) + 1, dilate[1] * (kw - 1) + 1
    p = qx.unfold(2, eh, stride[0]).unfold(3, ew, stride[1])
    if dilate != (1, 1):
        p = p[..., ::dilate[0], ::dilate[1]]
    Ho, Wo = p.shape[2], p.shape[3]
    cols = p.permute(0, 2, 3, 1, 4, 5).reshape(N * Ho * Wo, C * kh * kw)
    out = int8_matmul(cols, qw.reshape(O, C * kh * kw))
    return out.reshape(N, Ho, Wo, O).permute(0, 3, 1, 2).contiguous()


@register("contrib.quantize_v2")
def _quantize_v2(data, min_calib_range=None, max_calib_range=None,
                 out_type="int8"):
    """float -> (int8, min, max).  With no calibrated range the range is
    the data's (the online path); ``out_type`` 'int8' only (symmetric)."""
    if out_type != "int8":
        raise ValueError("quantize_v2: only out_type='int8' (the symmetric "
                         "int8 convention)")
    dev = data.device
    if min_calib_range is None or max_calib_range is None:
        real = _real(data.min().to(torch.float32),
                     data.max().to(torch.float32), dev)
        real = torch.maximum(real, _tensor(_TINY, dev))
    else:
        real = np.maximum(_real(min_calib_range, max_calib_range, dev),
                          _TINY)
    return (quantize(data, real),) + _range_pair(real, dev)


@register("contrib.dequantize")
def _dequantize(qdata, min_range, max_range, out_type="float32"):
    from ..base import torch_dtype
    real = _real(min_range, max_range, qdata.device)
    return dequantize(qdata, real).to(torch_dtype(out_type))


@register("contrib.requantize")
def _requantize(qdata, min_range, max_range, min_calib_range=None,
                max_calib_range=None):
    """int32 (a quantized product's) -> int8 against a new range: the
    calibrated one when given, else the data's."""
    dev = qdata.device
    f = _scaled(qdata, _div(_real(min_range, max_range, dev), _Q * _Q, dev))
    if min_calib_range is None or max_calib_range is None:
        real = torch.maximum(_real(f.min(), f.max(), dev),
                             _tensor(_TINY, dev))
    else:
        real = np.maximum(_real(min_calib_range, max_calib_range, dev),
                          _TINY)
    return (quantize(f, real),) + _range_pair(real, dev)


@register("contrib.quantized_dot")
def _quantized_dot(qa, qb, min_a, max_a, min_b, max_b):
    """int8 a (..., K) . int8 b (K, ...) -> (int32, min, max)."""
    K = qa.shape[-1]
    out = int8_matmul(qa.reshape(-1, K), qb.reshape(K, -1).t())
    out = out.reshape(*qa.shape[:-1], *qb.shape[1:])
    return (out,) + _range_pair(
        _ranges(min_a, max_a, min_b, max_b, qa.device), qa.device)


@register("contrib.quantized_fully_connected")
def _quantized_fully_connected(qx, qw, min_x, max_x, min_w, max_w,
                               num_hidden=0, flatten=True):  # noqa: ARG001
    """x (int8) . w (int8)^T -> int32 with the product's range; the bias
    is added after ``dequantize`` (the reference's choice)."""
    return (quantized_fc(qx, qw, flatten),) + _range_pair(
        _ranges(min_x, max_x, min_w, max_w, qx.device), qx.device)


@register("contrib.quantized_conv")
def _quantized_conv(qx, qw, min_x, max_x, min_w, max_w, stride=(1, 1),
                    pad=(0, 0), dilate=(1, 1)):
    """NCHW int8 convolution -> int32 with the product's range."""
    return (quantized_conv2d(qx, qw, stride, pad, dilate),) + _range_pair(
        _ranges(min_x, max_x, min_w, max_w, qx.device), qx.device)
