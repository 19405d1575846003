"""INT8 post-training quantization of Gluon nets — the port of
``mxnet_tpu/contrib/quantization.py`` (MXNet's
``python/mxnet/contrib/quantization.py`` and the roles of
``quantize_graph_pass.cc`` / ``calibrate.cc``).

``quantize_net`` walks a Gluon block tree and swaps each ``Dense`` and
``Conv2D`` child for an inference-only wrapper that runs the int8 ops of
``ops/quantization.py``: the weight is quantized once, at conversion; the
input is quantized each call against a range from calibration:

- ``calib_mode='naive'``: each layer's input min and max over the
  calibration batches;
- ``calib_mode='entropy'``: the KL-optimal symmetric threshold of each
  layer's input histogram (8 bits, 2048 bins);
- ``calib_mode='none'``: the range of each call's own input (online).

A calibrated range is a float32 constant; an online one stays on the
device.  The wrappers are ``Block``s (``torch.nn.Module``s) that take the
float layer's place in its parent's ``_modules`` and ``_children``, so
attribute access (``cell.attn_qkv``), ``collect_params()``,
``state_dict()`` and ``.to(device)`` all see the quantized net; their
int8 weight and float bias are buffers, not Parameters.  The reference's
wrappers are plain objects it writes into ``vars(parent)``; a
``torch.nn.Module`` parent keeps its children in ``_modules``, where such
a write would not reach.

Calibration runs the net imperatively (hybridization is switched off
first, as the reference drops its cached ops) so each target's forward
pre-hook sees its input.
"""

from __future__ import annotations

import fnmatch

import numpy as np
import torch

from ..base import MXNetError
from ..gluon.block import Block
from ..ndarray.ndarray import NDArray
from ..ops import quantization as _q

__all__ = ["quantize_net", "QuantizedDense", "QuantizedConv2D",
           "optimal_threshold_kl"]


def _histogram_collect(hist_state, arr, bins=2048):
    """Add ``|arr|`` to a layer's histogram (calibrate.cc keeps one a
    layer across the calibration batches), widening the range, and
    re-binning what was collected, when a batch reaches past it."""
    a = np.abs(arr.ravel())
    amax = float(a.max()) if a.size else 0.0
    if hist_state is None:
        width = max(amax, 1e-8)
        hist, _ = np.histogram(a, bins=bins, range=(0, width))
        return {"hist": hist.astype(np.float64), "width": width}
    if amax > hist_state["width"]:
        old_edges = np.linspace(0, hist_state["width"],
                                len(hist_state["hist"]) + 1)
        centers = (old_edges[:-1] + old_edges[1:]) / 2
        new_hist, _ = np.histogram(centers, bins=bins, range=(0, amax),
                                   weights=hist_state["hist"])
        hist_state = {"hist": new_hist, "width": amax}
    hist, _ = np.histogram(a, bins=len(hist_state["hist"]),
                           range=(0, hist_state["width"]))
    hist_state["hist"] += hist
    return hist_state


def optimal_threshold_kl(hist, hist_width, num_quantized_bins=255):
    """The KL-divergence-optimal symmetric threshold of a histogram of
    |x| over [0, ``hist_width``] (calibrate.cc's GetOptimalThreshold).

    For each candidate threshold T, [0, T] is quantized into
    ``num_quantized_bins`` levels and everything above T saturates into
    the top level; Q is that mapping's distribution over the whole
    histogram, and the T of least KL(P || Q) wins.  Comparing against the
    whole distribution, not the clipped window, is what penalizes
    clipping."""
    hist = np.asarray(hist, np.float64)
    nbins = len(hist)
    total = hist.sum()
    if total == 0:
        return hist_width
    p_full = hist / total
    eps = 1e-10
    best_kl, best_t = np.inf, hist_width
    step = max(1, (nbins - num_quantized_bins) // 64)
    for i in range(num_quantized_bins, nbins + 1, step):
        t = hist_width * i / nbins
        edges = np.linspace(0, i, num_quantized_bins + 1).astype(int)
        q = np.full(nbins, eps)
        clipped = hist[i:].sum()
        for j in range(num_quantized_bins):
            lo, hi = edges[j], max(edges[j + 1], edges[j] + 1)
            seg = hist[lo:hi]
            seg_sum = seg.sum()
            if j == num_quantized_bins - 1:
                seg_sum += clipped      # saturated values hit the top level
            nz = (seg > 0).sum()
            if nz and seg_sum > 0:
                q[lo:hi] = np.where(seg > 0, seg_sum / nz / total, eps)
        mask = p_full > 0
        kl = float(np.sum(p_full[mask] * np.log(p_full[mask] / q[mask])))
        if kl < best_kl:
            best_kl, best_t = kl, t
    return best_t


class _QuantizedBase(Block):
    """What both wrappers share: the float layer's int8 weight (a buffer)
    and its weight range (a constant), its float bias (a buffer) and
    activation, the input's calibrated range; inference only."""

    def __init__(self, layer, calib_range):
        super().__init__(prefix=layer.prefix)
        w = layer.weight.data()._data.detach()
        qw, _, real_w = _q._quantize_v2(w)
        self.register_buffer("qweight", qw)
        self._real_w = np.float32(real_w.item())
        bias = layer.bias.data()._data.detach().clone() \
            if layer.bias is not None else None
        self.register_buffer("qbias", bias)
        self.act = layer.act
        self._calib = None if calib_range is None else \
            tuple(float(v) for v in calib_range)
        self._real_x = None if calib_range is None else np.maximum(
            _q._real(calib_range[0], calib_range[1], None), _q._TINY)

    def _input_range(self, x):
        if self._real_x is not None:
            return self._real_x
        real = torch.maximum(x.min().to(torch.float32).abs(),
                             x.max().to(torch.float32).abs())
        return torch.maximum(real, _q._tensor(_q._TINY, x.device))

    def _int8(self, x):
        """float32 output of the layer's int8 product, bias and activation
        apart."""
        raise NotImplementedError

    def forward(self, x):
        t = x._data if isinstance(x, NDArray) else x
        with torch.no_grad():
            y = self._int8(t)
        if isinstance(x, NDArray):
            y = NDArray(y, x._ctx)
        return y if self.act is None else self.act(y)

    def cast(self, dtype):
        raise MXNetError("quantized layers are int8-frozen; cast() is not "
                         "supported (re-quantize from the float net instead)")


class QuantizedDense(_QuantizedBase):
    """Inference-only int8 replacement for ``gluon.nn.Dense``."""

    def __init__(self, dense, calib_range=None):
        super().__init__(dense, calib_range)
        self._units = dense._units
        self._flatten = dense._flatten

    def _int8(self, x):
        real_x = self._input_range(x)
        out32 = _q.quantized_fc(_q.quantize(x, real_x), self.qweight,
                                self._flatten)
        y = _q.dequantize(out32, _q.product_range(real_x, self._real_w,
                                                  x.device))
        return y if self.qbias is None else y + self.qbias


class QuantizedConv2D(_QuantizedBase):
    """Inference-only int8 replacement for ``gluon.nn.Conv2D`` (NCHW)."""

    def __init__(self, conv, calib_range=None):
        if conv._kwargs.get("num_group", 1) != 1:
            raise MXNetError("QuantizedConv2D: grouped conv stays float "
                             "(exclude it via exclude_layers_match)")
        super().__init__(conv, calib_range)
        self._stride = conv._kwargs.get("stride", (1, 1))
        self._pad = conv._kwargs.get("pad", (0, 0))
        self._dilate = conv._kwargs.get("dilate", (1, 1))

    def _int8(self, x):
        real_x = self._input_range(x)
        out32 = _q.quantized_conv2d(_q.quantize(x, real_x), self.qweight,
                                    self._stride, self._pad, self._dilate)
        y = _q.dequantize(out32, _q.product_range(real_x, self._real_w,
                                                  x.device))
        return y if self.qbias is None else \
            y + self.qbias.reshape(1, -1, 1, 1)


def _quantizable_children(block, prefix=""):
    from ..gluon import nn
    out = []
    for name, child in block._children.items():
        path = f"{prefix}{name}"
        if isinstance(child, (nn.Dense, nn.Conv2D)):
            out.append((block, name, path, child))
        else:
            out.extend(_quantizable_children(child, path + "."))
    return out


def _swap(parent, child, q):
    """Put ``q`` wherever ``parent`` holds ``child``: its registered
    modules, its Gluon children and its plain attributes."""
    for store in (parent._modules, parent._children, vars(parent)):
        for k, v in list(store.items()):
            if v is child:
                store[k] = q


def _as_numpy(x):
    if isinstance(x, NDArray):
        return x.asnumpy()
    return x.detach().float().cpu().numpy()


def quantize_net(net, calib_data=None, calib_mode="naive",
                 quantized_dtype="int8", exclude_layers_match=None,
                 logger=None):
    """Convert a float Gluon net to int8 inference in place and return it.

    ``calib_data``: an iterable of input batches (NDArray or numpy) for
    the calibration that ``naive`` and ``entropy`` need.
    ``exclude_layers_match``: fnmatch patterns of child paths (``"2"``,
    ``"encoder.layer0.*"``) kept in float."""
    from .. import ndarray as nd
    from ..gluon import nn
    if quantized_dtype != "int8":
        raise MXNetError("quantization supports int8 only (symmetric, "
                         "cuBLASLt's int8 GEMM)")
    if calib_mode not in ("none", "naive", "entropy"):
        raise MXNetError(f"unknown calib_mode {calib_mode!r}")
    targets = _quantizable_children(net)
    if exclude_layers_match:
        targets = [t for t in targets
                   if not any(fnmatch.fnmatch(t[2], pat)
                              for pat in exclude_layers_match)]
    if not targets:
        return net

    # calibration and int8 inference run imperatively
    net.hybridize(False)
    calib_ranges = {}
    if calib_mode in ("naive", "entropy"):
        if calib_data is None:
            raise MXNetError(f"calib_mode={calib_mode!r} needs calib_data")
        stats = {path: None for _, _, path, _ in targets}

        def make_hook(path):
            def pre_hook(blk, inputs):  # noqa: ARG001
                a = _as_numpy(inputs[0])
                if calib_mode == "naive":
                    cur = stats[path]
                    mn, mx = float(a.min()), float(a.max())
                    stats[path] = (mn, mx) if cur is None else \
                        (min(cur[0], mn), max(cur[1], mx))
                else:
                    stats[path] = _histogram_collect(stats[path], a)
            return pre_hook

        handles = [child.register_forward_pre_hook(make_hook(path))
                   for _, _, path, child in targets]
        try:
            with torch.no_grad():
                for batch in calib_data:
                    net(batch if isinstance(batch, NDArray)
                        else nd.array(batch))
        finally:
            for h in handles:
                h.remove()
        for _, _, path, _ in targets:
            st = stats[path]
            if st is None:
                continue
            if calib_mode == "naive":
                calib_ranges[path] = st
            else:
                t = optimal_threshold_kl(st["hist"], st["width"])
                calib_ranges[path] = (-t, t)

    for parent, _name, path, child in targets:
        rng = calib_ranges.get(path)
        if isinstance(child, nn.Dense):
            q = QuantizedDense(child, calib_range=rng)
        else:
            q = QuantizedConv2D(child, calib_range=rng)
        _swap(parent, child, q)
        if logger:
            logger.info("quantized %s (calib=%s)", path, rng)
    return net
