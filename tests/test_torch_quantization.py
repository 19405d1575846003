"""INT8 quantization of the port held against the JAX package on the CPU:
the six ops of ``ops/quantization.py``, the KL calibrator,
``contrib.quantization.quantize_net`` (naive, entropy and none) on an MLP,
a small CNN and a 2-layer BERT (64 units, 4 heads, seq 128), and the
``INT8`` pass of ``Symbol.optimize_for``; the reference's
``tests/test_quantization.py`` case by case, each against the reference
itself.

Tolerances: int8 outputs equal and int32 outputs bit-equal (the products
sum exactly in int32: ``torch._int_mm`` in the port, ``lax.dot_general``
with int32 accumulation in the reference); ranges to 1e-7 relative;
``dequantize`` 1e-6 relative; calibration ranges 1e-5 relative.  A
quantized net's float output differs where a float input to some
quantizer differs in its last bit (the packages' float ops round apart)
and flips one int8 rounding: each test states how many quantization steps
of its output it allows and reports the share of equal int8 activations
a layer.
"""

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu.contrib import quantization as jqz
from mxnet_tpu.gluon.model_zoo import bert as jbert
import mxnet_tpu_torch as mx
from mxnet_tpu_torch.contrib import quantization as qz
from mxnet_tpu_torch.gluon.model_zoo import bert as tbert
from mxnet_tpu_torch.ops import quantization as tq

RANGE_RTOL = 1e-7
DEQ_RTOL = 1e-6
CALIB_RTOL = 1e-5


@pytest.fixture(autouse=True)
def _on_cpu():
    with mx.cpu():
        yield


def _run(pkg, name, arrays, attrs):
    reg = pkg.ops.registry
    out = reg.invoke(reg.get(name), [pkg.nd.array(a, ctx=pkg.cpu(),
                                                   dtype=a.dtype)
                                     for a in arrays], dict(attrs))
    return [o.asnumpy() for o in (out if isinstance(out, list) else [out])]


def _q8(r, *shape):
    return r.randint(-127, 128, shape).astype(np.int8)


def _f0(v):
    return np.array(v, np.float32)


def _op_cases():
    r = np.random.RandomState(0)
    x = (r.randn(33, 147) * 3).astype(np.float32)
    rng = [_f0(-2.5), _f0(1.75), _f0(-0.5), _f0(0.625)]
    return {
        "quantize_v2 online": ("contrib.quantize_v2", [x], {}),
        "quantize_v2 calibrated": ("contrib.quantize_v2", [x],
                                   {"min_calib_range": -2.0,
                                    "max_calib_range": 1.5}),
        "dequantize int8": ("contrib.dequantize",
                            [_q8(r, 33, 147), _f0(-2.5), _f0(1.75)], {}),
        "dequantize int32": ("contrib.dequantize",
                             [r.randint(-2 ** 30, 2 ** 30, (7, 9))
                              .astype(np.int32), _f0(-3.0), _f0(7.0)], {}),
        "requantize online": ("contrib.requantize",
                              [r.randint(-2 ** 24, 2 ** 24, (9, 10))
                               .astype(np.int32), _f0(-3.0), _f0(7.0)], {}),
        "requantize calibrated": ("contrib.requantize",
                                  [r.randint(-2 ** 24, 2 ** 24, (9, 10))
                                   .astype(np.int32), _f0(-3.0), _f0(7.0)],
                                  {"min_calib_range": -1.0,
                                   "max_calib_range": 2.0}),
        # K 3 x 7 x 7 = 147 and N 2: _int_mm's padding on both sides
        "quantized_dot": ("contrib.quantized_dot",
                          [_q8(r, 5, 147), _q8(r, 147, 2)] + rng, {}),
        "quantized_fully_connected": (
            "contrib.quantized_fully_connected",
            [_q8(r, 20, 147), _q8(r, 2, 147)] + rng, {"num_hidden": 2}),
        "quantized_fully_connected flatten": (
            "contrib.quantized_fully_connected",
            [_q8(r, 4, 3, 7, 7), _q8(r, 10, 147)] + rng,
            {"num_hidden": 10}),
        "quantized_fully_connected 3-d": (
            "contrib.quantized_fully_connected",
            [_q8(r, 6, 3, 64), _q8(r, 24, 64)] + rng,
            {"num_hidden": 24, "flatten": False}),
        "quantized_conv stem": (
            "contrib.quantized_conv",
            [_q8(r, 2, 3, 23, 23), _q8(r, 8, 3, 7, 7)] + rng,
            {"stride": (2, 2), "pad": (3, 3)}),
        "quantized_conv 3x3": (
            "contrib.quantized_conv",
            [_q8(r, 2, 16, 9, 9), _q8(r, 16, 16, 3, 3)] + rng,
            {"stride": 1, "pad": 1}),
        "quantized_conv dilated": (
            "contrib.quantized_conv",
            [_q8(r, 1, 4, 11, 10), _q8(r, 6, 4, 3, 3)] + rng,
            {"stride": (1, 2), "pad": (2, 1), "dilate": (2, 1)}),
    }


OP_CASES = _op_cases()


@pytest.mark.parametrize("case", sorted(OP_CASES))
def test_quantized_ops_match_reference(case):
    name, arrays, attrs = OP_CASES[case]
    got = _run(mx, name, arrays, attrs)
    want = _run(jmx, name, arrays, attrs)
    assert [g.dtype for g in got] == [w.dtype for w in want], case
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape, (case, i)
        if w.dtype.kind == "i":
            assert np.array_equal(g, w), (case, i)
        else:
            tol = RANGE_RTOL if w.ndim == 0 else DEQ_RTOL
            np.testing.assert_allclose(g, w, rtol=tol, atol=0,
                                       err_msg=f"{case} output {i}")


@pytest.mark.parametrize("M,K,N", [(1, 6, 3), (16, 8, 8), (17, 147, 2),
                                   (40, 768, 30)])
def test_int8_matmul_pads_and_stays_exact(M, K, N):
    r = np.random.RandomState(M + K)
    a, b = _q8(r, M, K), _q8(r, N, K)
    got = tq.int8_matmul(torch.from_numpy(a), torch.from_numpy(b))
    assert got.dtype == torch.int32 and tuple(got.shape) == (M, N)
    assert np.array_equal(got.numpy(), a.astype(np.int64)
                          @ b.astype(np.int64).T)


def test_out_type_uint8_raises_like_the_reference():
    x = np.ones((2, 2), np.float32)
    for pkg in (jmx, mx):
        with pytest.raises(ValueError, match="int8"):
            pkg.nd.contrib.quantize_v2(pkg.nd.array(x), out_type="uint8")


# -- the reference's op tests, each against the reference --------------------

def test_quantize_dequantize_roundtrip():
    x = np.random.RandomState(0).randn(64, 32).astype(np.float32) * 3
    outs = {}
    for pkg in (jmx, mx):
        q, mn, mxr = pkg.nd.contrib.quantize_v2(pkg.nd.array(x))
        back = pkg.nd.contrib.dequantize(q, mn, mxr).asnumpy()
        outs[pkg] = (q.asnumpy(), float(mxr.asnumpy()), back)
    (tq_, tr, tb), (jq, jr, jb) = outs[mx], outs[jmx]
    assert tq_.dtype == np.int8 and np.array_equal(tq_, jq)
    real = max(abs(x.min()), abs(x.max()))
    np.testing.assert_allclose(tr, real, rtol=1e-6)
    assert tr == jr
    np.testing.assert_allclose(tb, jb, rtol=DEQ_RTOL, atol=0)
    assert np.abs(tb - x).max() <= real / 127 * 0.5 + 1e-6


def test_quantize_with_calib_range_clips():
    x = np.array([[-10.0, -1.0, 0.5, 9.0]], np.float32)
    for pkg in (jmx, mx):
        q, _, mxr = pkg.nd.contrib.quantize_v2(
            pkg.nd.array(x), min_calib_range=-2.0, max_calib_range=2.0)
        qa = q.asnumpy()
        assert qa[0, 0] == -127 and qa[0, 3] == 127
        np.testing.assert_allclose(float(mxr.asnumpy()), 2.0)


def _fc_chain(pkg, x, w, requant):
    nd = pkg.nd
    qx, xmin, xmax = nd.contrib.quantize_v2(nd.array(x))
    qw, wmin, wmax = nd.contrib.quantize_v2(nd.array(w))
    out32, omin, omax = nd.contrib.quantized_fully_connected(
        qx, qw, xmin, xmax, wmin, wmax, num_hidden=w.shape[0])
    if requant:
        q8, nmin, nmax = nd.contrib.requantize(out32, omin, omax)
        return q8.asnumpy(), nd.contrib.dequantize(q8, nmin, nmax).asnumpy()
    return out32.asnumpy(), nd.contrib.dequantize(out32, omin,
                                                  omax).asnumpy()


@pytest.mark.parametrize("requant", [False, True])
def test_quantized_fc_chain_accuracy(requant):
    r = np.random.RandomState(2 if requant else 1)
    x = r.randn(16, 32).astype(np.float32)
    w = (r.randn(8, 32) * (1.0 if requant else 0.5)).astype(np.float32)
    q_t, y_t = _fc_chain(mx, x, w, requant)
    q_j, y_j = _fc_chain(jmx, x, w, requant)
    assert q_t.dtype == (np.int8 if requant else np.int32)
    assert np.array_equal(q_t, q_j)
    np.testing.assert_allclose(y_t, y_j, rtol=DEQ_RTOL, atol=0)
    ref = x @ w.T
    assert np.abs(y_t - ref).max() / np.abs(ref).max() < \
        (0.03 if requant else 0.02)


def test_kl_threshold_matches_reference():
    """A gaussian bulk and one outlier: the same histogram and the same
    threshold as the reference, near the bulk."""
    r = np.random.RandomState(3)
    vals = np.concatenate([r.randn(100000).astype(np.float32),
                           np.array([50.0], np.float32)])
    st = qz._histogram_collect(None, vals)
    jst = jqz._histogram_collect(None, vals)
    assert np.array_equal(st["hist"], jst["hist"])
    assert st["width"] == jst["width"]
    more = r.randn(5000).astype(np.float32) * 80
    st = qz._histogram_collect(st, more)
    jst = jqz._histogram_collect(jst, more)
    np.testing.assert_array_equal(st["hist"], jst["hist"])
    t = qz.optimal_threshold_kl(st["hist"], st["width"])
    assert t == jqz.optimal_threshold_kl(jst["hist"], jst["width"])
    t0 = qz.optimal_threshold_kl(*(lambda s: (s["hist"], s["width"]))(
        qz._histogram_collect(None, vals)))
    assert 2.0 < t0 < 25.0


# -- quantize_net --------------------------------------------------------------

def _copy_params(tnet, jnet):
    """The port's values into the reference net, parameter by parameter
    in creation order."""
    tp = list(tnet.collect_params().values())
    jp = list(jnet.collect_params().values())
    assert len(tp) == len(jp)
    for t, j in zip(tp, jp):
        v = t.data().asnumpy()
        assert tuple(j.shape) == v.shape, (t.name, j.name)
        j.set_data(jmx.nd.array(v))


def _mlp(pkg):
    nn = pkg.gluon.nn
    net = nn.HybridSequential()
    net.add(nn.Dense(64, activation="relu", in_units=16))
    net.add(nn.Dense(32, activation="relu", in_units=64))
    net.add(nn.Dense(10, in_units=32))
    return net


def _cnn(pkg):
    nn = pkg.gluon.nn
    net = nn.HybridSequential()
    net.add(nn.Conv2D(8, kernel_size=3, padding=1, activation="relu",
                      in_channels=3))
    net.add(nn.Conv2D(16, kernel_size=3, strides=2, activation="relu",
                      in_channels=8))
    net.add(nn.Dense(10, in_units=16 * 7 * 7))
    return net


def _pair(make, seed):
    tnet = make(mx)
    mx.random.seed(seed)
    tnet.initialize(mx.init.Xavier())
    jnet = make(jmx)
    jnet.initialize(jmx.init.Zero())
    _copy_params(tnet, jnet)
    return tnet, jnet


def _wrappers(net, pkg_qz):
    """{path: wrapper} of every quantized layer of ``net``."""
    out = {}

    def walk(block, prefix):
        for name, child in block._children.items():
            path = f"{prefix}{name}"
            if isinstance(child, (pkg_qz.QuantizedDense,
                                  pkg_qz.QuantizedConv2D)):
                out[path] = child
            else:
                walk(child, path + ".")
    walk(net, "")
    return out


def _kl_at(hist, i, nq=255):
    """``optimal_threshold_kl``'s divergence at candidate ``i`` (its loop
    body)."""
    hist = np.asarray(hist, np.float64)
    nbins, total, eps = len(hist), hist.sum(), 1e-10
    p_full = hist / total
    edges = np.linspace(0, i, nq + 1).astype(int)
    q = np.full(nbins, eps)
    clipped = hist[i:].sum()
    for j in range(nq):
        lo, hi = edges[j], max(edges[j + 1], edges[j] + 1)
        seg = hist[lo:hi]
        seg_sum = seg.sum() + (clipped if j == nq - 1 else 0)
        nz = (seg > 0).sum()
        if nz and seg_sum > 0:
            q[lo:hi] = np.where(seg > 0, seg_sum / nz / total, eps)
    m = p_full > 0
    return float(np.sum(p_full[m] * np.log(p_full[m] / q[m])))


class _Inputs:
    """Each target layer's float inputs during calibration, in both
    packages (forward pre-hooks on the float layers, which leave the tree
    at the swap)."""

    def __init__(self, tnet, jnet):
        self.t, self.j = {}, {}
        for pkg_qz, net, sink in ((qz, tnet, self.t), (jqz, jnet, self.j)):
            for _, _, path, child in pkg_qz._quantizable_children(net):
                child.register_forward_pre_hook(
                    lambda b, a, p=path, s=sink: s.setdefault(p, []).append(
                        a[0].asnumpy()))

    def tie(self, path, t_port, t_ref):
        """The reference's histogram of ``path``'s inputs: the KL of the
        port's threshold, of the reference's, and the candidate step."""
        h = None
        for a in self.j[path]:
            h = jqz._histogram_collect(h, a)
        nb = len(h["hist"])
        i_t = int(round(t_port / h["width"] * nb))
        i_j = int(round(t_ref / h["width"] * nb))
        return (_kl_at(h["hist"], i_t), _kl_at(h["hist"], i_j),
                h["width"] * max(1, (nb - 255) // 64) / nb)


# two entropy thresholds may differ where the KL search has two candidates
# within this relative KL of each other: a last-bit difference of the
# float inputs (the packages' float ops round apart) moves a value across
# a histogram bin and decides the tie
KL_TIE = 1e-3


def _calib_close(tnet, jnet, inputs=None):
    """The same layers swapped, to the same wrapper types, with calibrated
    ranges within ``CALIB_RTOL``; with ``inputs`` (entropy), a threshold
    that differs must be one candidate step off the reference's, at a KL
    within ``KL_TIE`` of its minimum on the reference's own histogram."""
    tw, jw = _wrappers(tnet, qz), _wrappers(jnet, jqz)
    assert sorted(tw) == sorted(jw)
    for path in tw:
        assert type(tw[path]).__name__ == type(jw[path]).__name__
        a, b = tw[path]._calib, jw[path]._calib
        assert (a is None) == (b is None), path
        if a is None:
            continue
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        if inputs is not None and not np.allclose(a, b, rtol=CALIB_RTOL,
                                                  atol=0):
            kl_t, kl_j, step = inputs.tie(path, a[1], b[1])
            print(f"{path}: threshold {a[1]:.6g} against {b[1]:.6g}, KL "
                  f"{kl_t:.6g} against {kl_j:.6g}")
            assert abs(a[1] - b[1]) <= step * 1.001 and \
                kl_t <= kl_j * (1 + KL_TIE), path
            continue
        np.testing.assert_allclose(a, b, rtol=CALIB_RTOL, atol=0,
                                   err_msg=path)
    return tw, jw


class _Recorder:
    """The int8 input of each quantized layer, each package quantizing its
    own float input (the port's by a forward pre-hook; the reference's
    wrappers are plain objects, so by a patched ``__call__``)."""

    def __init__(self, monkeypatch, tnet, jnet):
        self.t, self.j = {}, {}
        tw, jw = _wrappers(tnet, qz), _wrappers(jnet, jqz)
        jpath = {id(v): k for k, v in jw.items()}
        for path, w in tw.items():
            w.register_forward_pre_hook(
                lambda b, args, p=path: self.t.setdefault(p, []).append(
                    tq.quantize(args[0]._data, b._input_range(
                        args[0]._data)).numpy()))
        for cls in (jqz.QuantizedDense, jqz.QuantizedConv2D):
            orig = cls.__call__

            def call(w, x, _orig=orig):
                cal = w._calib
                kw = {} if cal is None else {
                    "min_calib_range": float(cal[0]),
                    "max_calib_range": float(cal[1])}
                q = jmx.nd.contrib.quantize_v2(x, **kw)[0].asnumpy()
                self.j.setdefault(jpath[id(w)], []).append(q)
                return _orig(w, x)
            monkeypatch.setattr(cls, "__call__", call)

    @staticmethod
    def head_input(net, x):
        """The float input of ``net``'s last child on ``x``."""
        seen = []
        h = list(net._children.values())[-1].register_forward_pre_hook(
            lambda b, a: seen.append(a[0].asnumpy()))
        try:
            net(mx.nd.array(x))
        finally:
            h.remove()
        return seen[0]

    def shares(self):
        out = {}
        for path, qs in self.t.items():
            a = np.concatenate([q.ravel() for q in qs])
            b = np.concatenate([q.ravel() for q in self.j[path]])
            out[path] = float((a == b).mean())
        return out


def _net_out(pkg, net, x):
    out = net(pkg.nd.array(x))
    outs = out if isinstance(out, (list, tuple)) else [out]
    return [o.asnumpy() for o in outs]


@pytest.mark.parametrize("calib_mode", ["none", "naive", "entropy"])
def test_quantize_net_mlp_matches_reference(calib_mode, monkeypatch):
    tnet, jnet = _pair(_mlp, 4)
    r = np.random.RandomState(5)
    x = r.randn(32, 16).astype(np.float32)
    ref = _net_out(mx, tnet, x)[0]
    calib = [r.randn(32, 16).astype(np.float32) for _ in range(4)] + [x]
    inputs = _Inputs(tnet, jnet) if calib_mode == "entropy" else None
    for pkg, pqz, net in ((mx, qz, tnet), (jmx, jqz, jnet)):
        pqz.quantize_net(net, calib_data=[pkg.nd.array(c) for c in calib],
                         calib_mode=calib_mode)
    _calib_close(tnet, jnet, inputs)
    rec = _Recorder(monkeypatch, tnet, jnet)
    got, want = _net_out(mx, tnet, x)[0], _net_out(jmx, jnet, x)[0]
    shares = rec.shares()
    print(f"{calib_mode}: equal int8 activations a layer {shares}")
    assert min(shares.values()) >= 0.99
    # one int8 flip of the head's input moves an output by at most one
    # input step times max |w| of the head
    head = _wrappers(tnet, qz)["2"]
    step = float(head._input_range(torch.from_numpy(x))) / 127 \
        if head._real_x is None else float(head._real_x) / 127
    assert np.abs(got - want).max() <= 4 * step * float(
        np.abs(head.qweight.numpy()).max()) * float(head._real_w) / 127 \
        + 1e-6
    scale = np.abs(ref).max()
    if calib_mode == "entropy":     # the reference's own bounds
        assert np.abs(got - ref).mean() / scale < 0.03
        assert np.abs(got - ref).max() / scale < 0.30
    else:
        assert np.abs(got - ref).max() / scale < 0.05


def test_quantize_net_excludes_layers():
    tnet, jnet = _pair(_mlp, 6)
    x = np.random.RandomState(6).randn(4, 16).astype(np.float32)
    for pkg, pqz, net in ((mx, qz, tnet), (jmx, jqz, jnet)):
        pqz.quantize_net(net, calib_data=[pkg.nd.array(x)],
                         calib_mode="naive", exclude_layers_match=["2"])
    kinds = [type(c).__name__ for c in tnet._children.values()]
    assert kinds == [type(c).__name__ for c in jnet._children.values()]
    assert kinds.count("QuantizedDense") == 2 and kinds.count("Dense") == 1
    assert isinstance(tnet[2], mx.gluon.nn.Dense)


def test_quantize_net_on_hybridized_net():
    """A hybridized float net calibrates imperatively and runs int8 after
    (the reference drops its cached op; the port switches hybridization
    off)."""
    tnet, jnet = _pair(_mlp, 9)
    x = np.random.RandomState(9).randn(8, 16).astype(np.float32)
    outs = []
    for pkg, pqz, net in ((mx, qz, tnet), (jmx, jqz, jnet)):
        net.hybridize()
        ref = _net_out(pkg, net, x)[0]
        pqz.quantize_net(net, calib_data=[pkg.nd.array(x)],
                         calib_mode="naive")
        out = _net_out(pkg, net, x)[0]
        assert np.abs(out - ref).max() / np.abs(ref).max() < 0.05
        outs.append(out)
    assert not tnet._active
    np.testing.assert_allclose(outs[0], outs[1], rtol=0, atol=1e-5)


@pytest.mark.parametrize("calib_mode", ["none", "naive", "entropy"])
def test_quantize_net_cnn_matches_reference(calib_mode, monkeypatch):
    tnet, jnet = _pair(_cnn, 7)
    r = np.random.RandomState(8)
    x = r.randn(2, 3, 16, 16).astype(np.float32)
    ref = _net_out(mx, tnet, x)[0]
    calib = [x, r.randn(2, 3, 16, 16).astype(np.float32)]
    inputs = _Inputs(tnet, jnet) if calib_mode == "entropy" else None
    for pkg, pqz, net in ((mx, qz, tnet), (jmx, jqz, jnet)):
        pqz.quantize_net(net, calib_data=[pkg.nd.array(c) for c in calib],
                         calib_mode=calib_mode)
    tw, _ = _calib_close(tnet, jnet, inputs)
    assert [type(tw[k]).__name__ for k in sorted(tw)] == [
        "QuantizedConv2D", "QuantizedConv2D", "QuantizedDense"]
    rec = _Recorder(monkeypatch, tnet, jnet)
    got, want = _net_out(mx, tnet, x)[0], _net_out(jmx, jnet, x)[0]
    shares = rec.shares()
    print(f"cnn {calib_mode}: equal int8 activations a layer {shares}")
    assert min(shares.values()) >= 0.99
    # as the MLP's: 4 flips of the head's input, each its step times max |w|
    head = tw["2"]
    real_x = float(head._real_x) if head._real_x is not None else float(
        np.abs(_Recorder.head_input(tnet, x)).max())
    assert np.abs(got - want).max() <= 4 * real_x / 127 * float(
        head._real_w) + 1e-6
    if calib_mode == "entropy":
        # the reference's CNN test calibrates naively; its KL thresholds
        # clip this net's tails too (a mean error of 0.036 of max), and the
        # port's distance from float is the reference's to 1 %
        ref_err = np.abs(want - ref).mean()
        assert abs(np.abs(got - ref).mean() - ref_err) <= 0.01 * ref_err
    else:                            # the reference's bound
        assert np.abs(got - ref).max() / np.abs(ref).max() < 0.06


def test_grouped_conv_stays_float():
    conv = mx.gluon.nn.Conv2D(4, 3, groups=2, in_channels=4)
    conv.initialize()
    with pytest.raises(mx.MXNetError, match="grouped"):
        qz.QuantizedConv2D(conv)


def test_quantize_net_argument_errors():
    net = _mlp(mx)
    net.initialize()
    with pytest.raises(mx.MXNetError, match="int8"):
        qz.quantize_net(net, quantized_dtype="uint8")
    with pytest.raises(mx.MXNetError, match="calib_mode"):
        qz.quantize_net(net, calib_mode="kl")
    with pytest.raises(mx.MXNetError, match="calib_data"):
        qz.quantize_net(net, calib_mode="naive")


# -- BERT ----------------------------------------------------------------------

BERT = {"vocab_size": 97, "num_layers": 2, "units": 64, "hidden_size": 256,
        "num_heads": 4, "max_length": 128, "dropout": 0.0}


def _bert_pair(seed):
    tnet = tbert.BERTModel(prefix="bert_", **BERT)
    mx.random.seed(seed)
    tnet.initialize(mx.init.Normal(0.2))
    jnet = jbert.BERTModel(prefix="bert_", **BERT)
    jnet.initialize(jmx.init.Zero())
    tp = tnet.collect_params()
    for name, p in jnet.collect_params().items():
        p.set_data(jmx.nd.array(tp[name].data().asnumpy()))
    return tnet, jnet


@pytest.fixture(scope="module")
def bert_batches():
    r = np.random.RandomState(11)
    return [r.randint(0, 97, (2, 128)).astype(np.int32) for _ in range(3)]


@pytest.mark.parametrize("calib_mode", ["none", "naive", "entropy"])
def test_quantize_net_bert_matches_reference(calib_mode, bert_batches,
                                             monkeypatch):
    """Every Dense of the 2-layer BERT (attention projections, FFN, pooler,
    decoder) swapped in both packages, ranges within 1e-5, outputs within
    a few steps of the decoder's output."""
    tnet, jnet = _bert_pair(12)
    x = bert_batches[2]
    inputs = _Inputs(tnet, jnet) if calib_mode == "entropy" else None
    for pkg, pqz, net in ((mx, qz, tnet), (jmx, jqz, jnet)):
        pqz.quantize_net(net, calib_data=[pkg.nd.array(b)
                                          for b in bert_batches[:2]],
                         calib_mode=calib_mode,
                         exclude_layers_match=["encoder.layer1.ffn_2"])
    tw, _ = _calib_close(tnet, jnet, inputs)
    assert len(tw) == 2 * 4 + 2 - 1
    assert isinstance(tnet.encoder.cells[1].ffn_2, mx.gluon.nn.Dense)
    assert isinstance(tnet.encoder.cells[0].attn_qkv, qz.QuantizedDense)
    rec = _Recorder(monkeypatch, tnet, jnet)
    got, want = _net_out(mx, tnet, x), _net_out(jmx, jnet, x)
    shares = rec.shares()
    print(f"bert {calib_mode}: equal int8 activations a layer {shares}")
    assert min(shares.values()) >= 0.99
    # the decoder's input is the sequence output; one int8 flip of it
    # moves a logit by at most its step times max |w|
    dec = tw["decoder"]
    seq_step = (float(dec._real_x) if dec._real_x is not None
                else float(np.abs(want[0]).max())) / 127
    out_step = seq_step * float(dec._real_w)
    for name, g, w in zip(("sequence", "pooled", "logits"), got, want):
        assert g.shape == w.shape, name
        bound = {"sequence": 4 * seq_step, "pooled": 4 * seq_step,
                 "logits": 4 * out_step}[name]
        assert np.abs(g - w).max() <= bound, (name, np.abs(g - w).max(),
                                             bound)


def test_quantized_bert_is_a_module_tree(bert_batches):
    """The wrappers take the float layers' places in ``_modules``: the
    state dict holds the int8 weights and no float Dense weight, the
    parameters are the float layers' that stayed, and attribute access
    resolves to the wrapper (the reference writes its wrappers into
    ``vars(parent)``, which a ``torch.nn.Module`` parent keeps its
    children out of)."""
    tnet, _ = _bert_pair(13)
    before = set(tnet.collect_params().keys())
    qz.quantize_net(tnet, calib_mode="none")
    cell = tnet.encoder.cells[0]
    assert cell.attn_qkv is cell._modules["attn_qkv"] \
        is cell._children["attn_qkv"]
    assert isinstance(cell.ffn_1, qz.QuantizedDense)
    sd = tnet.state_dict()
    assert sd["encoder.layer0.attn_qkv.qweight"].dtype == torch.int8
    assert not any(k.endswith("attn_qkv.weight") for k in sd)
    after = set(tnet.collect_params().keys())
    assert after == {k for k in before if not any(
        s in k for s in ("attn_qkv_", "attn_proj_", "ffn1_", "ffn2_",
                         "pooler_", "decoder_"))}
    out = tnet(mx.nd.array(bert_batches[0]))
    assert all(np.isfinite(o.asnumpy()).all() for o in out)
    with pytest.raises(mx.MXNetError, match="int8-frozen"):
        cell.attn_qkv.cast("float16")


# -- the INT8 symbol pass -------------------------------------------------------

def _fc_net(pkg):
    S = pkg.sym
    x = S.var("data")
    w1, b1 = S.var("w1"), S.var("b1")
    w2 = S.var("w2")
    h = S.relu(S.FullyConnected(x, w1, b1, num_hidden=8, name="fc1"))
    return S.FullyConnected(h, w2, None, num_hidden=3, no_bias=True,
                            name="fc2")


def _graph(sym):
    return [(s._name, None if s._op is None else
             (s._op if isinstance(s._op, str) else s._op.name),
             {k: v for k, v in s._attrs.items()})
            for s in sym._walk()]


@pytest.mark.parametrize("kw", [
    {}, {"excluded_sym_names": ["fc1"]},
    {"calib_ranges": {"fc1": (-3.0, 3.0)}},
    {"calib_ranges": {"fc2": (-1.0, 2.0)}, "excluded_sym_names": ["fc1"]}],
    ids=["online", "exclude", "calibrated", "both"])
def test_optimize_for_int8_matches_reference(kw):
    r = np.random.RandomState(0)
    vals = {"data": r.randn(4, 6).astype(np.float32),
            "w1": (r.randn(8, 6) * 0.4).astype(np.float32),
            "b1": r.randn(8).astype(np.float32) * 0.1,
            "w2": (r.randn(3, 8) * 0.4).astype(np.float32)}
    res = {}
    for pkg in (jmx, mx):
        out = _fc_net(pkg)
        args = {k: pkg.nd.array(v, ctx=pkg.cpu()) for k, v in vals.items()}
        ref = out.bind(pkg.cpu(), dict(args)).forward()[0].asnumpy()
        q = out.optimize_for("INT8", **kw)
        got = q.bind(pkg.cpu(), dict(args)).forward()[0].asnumpy()
        res[pkg] = (_graph(q), q.attr("__int8_quantized_nodes__"), got, ref)
    (tg, tn, tgot, tref), (jg, jn, jgot, jref) = res[mx], res[jmx]
    assert tg == jg and tn == jn
    assert tn == str(2 - len(kw.get("excluded_sym_names", ())))
    np.testing.assert_allclose(tgot, jgot, rtol=0,
                               atol=DEQ_RTOL * np.abs(jgot).max())
    np.testing.assert_allclose(tgot, tref, rtol=0.1, atol=0.05)
    assert not np.allclose(tgot, tref, rtol=1e-7, atol=1e-8)
