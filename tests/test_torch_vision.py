"""The port's convolution, pooling and normalization ops, the conv and norm
layers, the ResNet zoo and their training loops, held against the JAX
package's on the CPU.

Each case runs the same code on the same numpy inputs, made from a seed,
through ``mxnet_tpu`` and ``mxnet_tpu_torch`` (``with mx.cpu():``).  Nets
are built in a fresh thread in each package (the prefix counters start at
0 on both sides, so the names agree) and take the same weights by name:
numpy draws set with ``set_data``, which also resolves deferred shapes,
so the JAX side compiles nothing to initialize them.

Tolerances, stated once: float32 forward ``rtol=1e-4, atol=1e-5``, as
``tests/test_model_zoo.py:85`` holds its hybridized ResNet to its
imperative one; gradients ``rtol=1e-4, atol=1e-5``; losses and running
statistics ``rtol=1e-4`` (atol 1e-6 for statistics near 0; after three
training steps, 1e-4 of the vector's largest magnitude); bfloat16
outputs one bfloat16 ulp (``rtol=2**-7``, atol 1e-2 near 0), the
statistics under bfloat16 data, computed in float32, ``rtol=1e-4``.
"""

import threading

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx

PKGS = (jmx, mx)
TOL = {"rtol": 1e-4, "atol": 1e-5}
STATS_TOL = {"rtol": 1e-4, "atol": 1e-6}


@pytest.fixture(autouse=True)
def _on_cpu():
    with mx.cpu():
        yield


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """torch's CPU convolution and batch norm on one thread: at these sizes
    a pool of threads waits on itself (3 training steps of the small
    ResNet: 0.03 s on one thread, 8.8 s on eight, on a loaded 8-core
    host)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _fresh(build):
    """``build()`` in a new thread: fresh prefix counters and name scopes."""
    out = {}
    t = threading.Thread(target=lambda: out.setdefault("v", build()))
    t.start()
    t.join(timeout=120)
    assert not t.is_alive() and "v" in out
    return out["v"]


def _pair(build):
    return _fresh(lambda: build(jmx)), _fresh(lambda: build(mx))


def _rand(seed, *shape, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale) \
        .astype(np.float32)


def _np(x):
    return x.asnumpy() if hasattr(x, "asnumpy") else np.asarray(x)


def _both(fn, **tol):
    """fn(package) -> array or list of arrays, on both packages; they must
    agree within ``tol`` (TOL by default)."""
    want, got = fn(jmx), fn(mx)
    if not isinstance(want, (list, tuple)):
        want, got = [want], [got]
    assert len(want) == len(got)
    for w, g in zip(want, got):
        w, g = _np(w), _np(g)
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, **(tol or TOL))
    return got


# -- Convolution / Deconvolution ----------------------------------------------

CONV_CASES = {
    "1d-strided": ((2, 3, 11), (4, 3, 3), dict(kernel=(3,), stride=(2,),
                                                pad=(1,), num_filter=4)),
    "2d-grouped-dilated": ((2, 4, 9, 10), (6, 2, 3, 3), dict(
        kernel=(3, 3), stride=(2, 1), dilate=(1, 2), pad=(1, 2),
        num_filter=6, num_group=2)),
    "2d-no-bias": ((2, 3, 8, 8), (5, 3, 1, 1), dict(
        kernel=(1, 1), stride=(2, 2), num_filter=5, no_bias=True)),
    "3d": ((1, 2, 5, 6, 7), (3, 2, 2, 3, 2), dict(
        kernel=(2, 3, 2), pad=(1, 0, 1), num_filter=3)),
}


@pytest.mark.parametrize("case", list(CONV_CASES))
def test_convolution(case):
    dshape, wshape, attrs = CONV_CASES[case]
    x, w = _rand(1, *dshape), _rand(2, *wshape, scale=0.3)
    b = _rand(3, wshape[0])
    _both(lambda m: m.nd.Convolution(m.nd.array(x), m.nd.array(w),
                                     m.nd.array(b), **attrs))


DECONV_CASES = {
    "2d-adj": ((2, 3, 5, 6), (3, 4, 3, 3), dict(
        kernel=(3, 3), stride=(2, 2), pad=(1, 1), adj=(1, 0), num_filter=4)),
    "2d-grouped": ((2, 4, 5, 5), (4, 3, 3, 2), dict(
        kernel=(3, 2), stride=(2, 1), pad=(1, 0), num_filter=6,
        num_group=2)),
    "1d": ((2, 3, 7), (3, 2, 4), dict(kernel=(4,), stride=(3,),
                                      num_filter=2)),
}


@pytest.mark.parametrize("case", list(DECONV_CASES))
def test_deconvolution(case):
    """Weight (in_c, out_c/num_group, *kernel); no_bias, the op's default
    (the reference drops the bias even when asked for one)."""
    dshape, wshape, attrs = DECONV_CASES[case]
    x, w = _rand(4, *dshape), _rand(5, *wshape, scale=0.3)
    _both(lambda m: m.nd.Deconvolution(m.nd.array(x), m.nd.array(w),
                                       **attrs))


def test_deconvolution_adds_its_bias():
    dshape, wshape, attrs = DECONV_CASES["2d-adj"]
    x, w, b = _rand(4, *dshape), _rand(5, *wshape), _rand(6, 4)
    plain = mx.nd.Deconvolution(mx.nd.array(x), mx.nd.array(w), **attrs)
    biased = mx.nd.Deconvolution(mx.nd.array(x), mx.nd.array(w),
                                 mx.nd.array(b), no_bias=False, **attrs)
    np.testing.assert_allclose(biased.asnumpy(),
                               plain.asnumpy() + b[None, :, None, None],
                               **TOL)


# -- Pooling ------------------------------------------------------------------

POOL_CASES = {
    "max-2d": ((2, 3, 8, 8), dict(kernel=(3, 3), stride=(2, 2),
                                  pad=(1, 1), pool_type="max")),
    "avg-2d": ((2, 3, 8, 8), dict(kernel=(2, 2), stride=(2, 2),
                                  pool_type="avg")),
    "avg-pad-count-include": ((2, 3, 7, 7), dict(
        kernel=(3, 3), stride=(2, 2), pad=(1, 1), pool_type="avg")),
    "avg-pad-count-exclude": ((2, 3, 7, 7), dict(
        kernel=(3, 3), stride=(2, 2), pad=(1, 1), pool_type="avg",
        count_include_pad=False)),
    "sum-2d": ((2, 3, 6, 6), dict(kernel=(3, 3), stride=(1, 1),
                                  pool_type="sum")),
    "lp-2d": ((2, 3, 6, 6), dict(kernel=(2, 2), stride=(2, 2),
                                 pool_type="lp", p_value=3)),
    "global-avg": ((2, 3, 7, 5), dict(global_pool=True, pool_type="avg")),
    "global-max": ((2, 3, 7, 5), dict(kernel=(1, 1), global_pool=True,
                                      pool_type="max")),
    "max-1d": ((2, 3, 9), dict(kernel=(3,), stride=(2,), pad=(1,),
                               pool_type="max")),
    "avg-3d": ((1, 2, 4, 6, 5), dict(kernel=(2, 2, 2), stride=(2, 2, 1),
                                     pool_type="avg")),
    # "full" grows the high padding to the ceil size; at H=W=7, k=2, s=2
    # ceil and torch's ceil_mode agree, at H=5, k=2, s=2, pad 1 they part
    # (the reference keeps a last window that lies in the padding)
    "max-full-ceil": ((2, 3, 7, 7), dict(kernel=(2, 2), stride=(2, 2),
                                         pool_type="max",
                                         pooling_convention="full")),
    "max-full-parts-from-ceil-mode": ((2, 3, 5, 5), dict(
        kernel=(2, 2), stride=(2, 2), pad=(1, 1), pool_type="max",
        pooling_convention="full")),
    "avg-full-parts-from-ceil-mode": ((2, 3, 5, 5), dict(
        kernel=(2, 2), stride=(2, 2), pad=(1, 1), pool_type="avg",
        pooling_convention="full")),
    "avg-full-count-exclude": ((2, 3, 6, 6), dict(
        kernel=(3, 3), stride=(2, 2), pad=(1, 1), pool_type="avg",
        pooling_convention="full", count_include_pad=False)),
    "max-valid-wide-pad": ((2, 3, 6, 6), dict(
        kernel=(2, 2), stride=(2, 2), pad=(2, 2), pool_type="max")),
}


@pytest.mark.parametrize("case", list(POOL_CASES))
def test_pooling(case):
    shape, attrs = POOL_CASES[case]
    x = _rand(7, *shape)
    _both(lambda m: m.nd.Pooling(m.nd.array(x), **attrs))


def test_pooling_full_against_ceil_mode_shapes():
    """The reference's ``full`` sizes are ceil((H + 2p - k) / s) + 1 where
    torch's ``ceil_mode`` is one less: the port keeps the reference's."""
    x = _rand(8, 1, 1, 5, 5)
    out = mx.nd.Pooling(mx.nd.array(x), kernel=(2, 2), stride=(2, 2),
                        pad=(1, 1), pool_type="max",
                        pooling_convention="full")
    ceil_mode = torch.nn.functional.max_pool2d(torch.tensor(x), 2, 2, 1,
                                               ceil_mode=True)
    assert out.shape == (1, 1, 4, 4) and ceil_mode.shape == (1, 1, 3, 3)


# -- normalization ops --------------------------------------------------------

def _bn_inputs(seed=9, c=4):
    r = np.random.RandomState(seed)
    return (r.uniform(-1, 1, (8, c, 3, 3)).astype(np.float32),
            r.uniform(0.5, 1.5, c).astype(np.float32),
            r.uniform(-0.5, 0.5, c).astype(np.float32),
            r.uniform(-0.2, 0.2, c).astype(np.float32),
            r.uniform(0.5, 1.5, c).astype(np.float32))


def _batch_norm(m, x, gamma, beta, mm, mv, train, **attrs):
    """(out, moving mean, moving var) after one BatchNorm call."""
    mm_nd, mv_nd = m.nd.array(mm), m.nd.array(mv)
    mode = m.autograd.train_mode if train else m.autograd.predict_mode
    with mode():
        out = m.nd.BatchNorm(m.nd.array(x), m.nd.array(gamma),
                             m.nd.array(beta), mm_nd, mv_nd, **attrs)
    return [out, mm_nd, mv_nd]


def test_batchnorm_train_stats():
    """``tests/test_operator.py:139`` through both packages: the moving
    variance moves toward the BIASED batch variance, with MXNet's momentum
    (the weight of the old value)."""
    x = np.random.RandomState(1).uniform(-1, 1, (8, 4, 3, 3)) \
        .astype(np.float32)
    zeros, ones = np.zeros(4, np.float32), np.ones(4, np.float32)
    out, mm, mv = _both(lambda m: _batch_norm(
        m, x, ones, zeros, zeros, ones, True, fix_gamma=False,
        momentum=0.9), **STATS_TOL)
    mean, var = x.mean(axis=(0, 2, 3)), x.var(axis=(0, 2, 3))
    ref = (x - mean[None, :, None, None]) / np.sqrt(
        var[None, :, None, None] + 1e-3)
    np.testing.assert_allclose(out, ref, rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(mm, 0.1 * mean, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(mv, 0.9 + 0.1 * var, rtol=1e-4, atol=1e-5)


BN_CASES = {
    "train": (True, dict(fix_gamma=False)),
    "train-fix-gamma": (True, dict()),
    "train-use-global-stats": (True, dict(fix_gamma=False,
                                          use_global_stats=True)),
    "predict": (False, dict(fix_gamma=False, eps=1e-5)),
    "train-momentum": (True, dict(fix_gamma=False, momentum=0.5)),
}


@pytest.mark.parametrize("case", list(BN_CASES))
def test_batchnorm(case):
    train, attrs = BN_CASES[case]
    args = _bn_inputs()
    out, mm, mv = _both(lambda m: _batch_norm(m, *args, train, **attrs))
    if not train or attrs.get("use_global_stats"):
        np.testing.assert_array_equal(mm, args[3])
        np.testing.assert_array_equal(mv, args[4])


def test_batchnorm_axis():
    """Channels last; a negative axis is the same axis in the port (the
    reference reduces over every axis for one, ROADMAP.md queue C)."""
    x, gamma, beta, mm, mv = _bn_inputs(c=3)
    got = _both(lambda m: _batch_norm(m, x, gamma, beta, mm, mv, True,
                                      fix_gamma=False, axis=3))
    neg = _batch_norm(mx, x, gamma, beta, mm, mv, True, fix_gamma=False,
                      axis=-1)
    for g, n in zip(got, neg):
        np.testing.assert_array_equal(n.asnumpy(), g)


def test_batchnorm_statistics_written_only_when_they_move():
    """Predict mode hands the statistics back unchanged: the port writes
    nothing (torch's version counter stays), so a graph that saved them
    still runs backward."""
    x, gamma, beta, mm, mv = _bn_inputs()
    mm_nd, mv_nd = mx.nd.array(mm), mx.nd.array(mv)
    xs = mx.nd.array(x)
    xs.attach_grad()
    version = mm_nd._data._version
    with mx.autograd.record(train_mode=False):
        out = mx.nd.BatchNorm(xs, mx.nd.array(gamma), mx.nd.array(beta),
                              mm_nd, mv_nd, fix_gamma=False)
    out.backward()
    assert mm_nd._data._version == version
    assert np.isfinite(xs.grad.asnumpy()).all()


def test_batchnorm_bf16_data_f32_statistics():
    """bf16 data with f32 gamma, beta and statistics: normalized in f32,
    returned in bf16 (one bf16 ulp); the statistics, from f32 sums, as in
    f32."""
    x, gamma, beta, mm, mv = _bn_inputs()
    outs = {}
    for m in PKGS:
        mm_nd, mv_nd = m.nd.array(mm), m.nd.array(mv)
        with m.autograd.train_mode():
            out = m.nd.BatchNorm(m.nd.array(x).astype("bfloat16"),
                                 m.nd.array(gamma), m.nd.array(beta), mm_nd,
                                 mv_nd, fix_gamma=False)
        assert "bfloat16" in str(out.dtype)
        assert mm_nd.dtype == np.float32
        outs[m] = [out.astype("float32").asnumpy(), mm_nd.asnumpy(),
                   mv_nd.asnumpy()]
    np.testing.assert_allclose(outs[mx][0], outs[jmx][0], rtol=2 ** -7,
                               atol=1e-2)
    for g, w in zip(outs[mx][1:], outs[jmx][1:]):
        np.testing.assert_allclose(g, w, **STATS_TOL)


def test_group_and_instance_norm():
    x = _rand(10, 2, 6, 4, 5)
    g, b = _rand(11, 6), _rand(12, 6)
    _both(lambda m: [
        m.nd.GroupNorm(m.nd.array(x), m.nd.array(g), m.nd.array(b),
                       num_groups=3),
        m.nd.InstanceNorm(m.nd.array(x), m.nd.array(g), m.nd.array(b)),
        m.nd.InstanceNorm(m.nd.array(x), m.nd.array(g), m.nd.array(b),
                          eps=1e-5)])


@pytest.mark.parametrize("mode", ["reflect", "edge", "constant"])
def test_pad(mode):
    x = _rand(13, 2, 3, 5, 6)
    attrs = dict(mode=mode, pad_width=(0, 0, 0, 0, 2, 1, 1, 3))
    if mode == "constant":
        attrs["constant_value"] = 1.5
    _both(lambda m: m.nd.pad(m.nd.array(x), **attrs), rtol=0, atol=0)


# -- gradients against the reference's autograd -------------------------------

def _grads(m, fn, arrays, head_seed=20):
    """Gradients of sum(fn(*arrays) * head) with respect to every array."""
    nds = [m.nd.array(a) for a in arrays]
    for a in nds:
        a.attach_grad()
    with m.autograd.record():
        out = fn(m, *nds)
        loss = (out * m.nd.array(_rand(head_seed, *out.shape))).sum()
    loss.backward()
    return [out] + [a.grad for a in nds]


GRAD_CASES = {
    "conv": (lambda m, x, w, b: m.nd.Convolution(
        x, w, b, kernel=(3, 3), stride=(2, 2), pad=(1, 1), num_filter=4),
        [(2, 3, 7, 7), (4, 3, 3, 3), (4,)]),
    "conv-grouped": (lambda m, x, w: m.nd.Convolution(
        x, w, kernel=(3, 3), num_filter=4, num_group=2, no_bias=True),
        [(2, 4, 6, 6), (4, 2, 3, 3)]),
    "max-pool": (lambda m, x: m.nd.Pooling(
        x, kernel=(3, 3), stride=(2, 2), pad=(1, 1), pool_type="max"),
        [(2, 3, 7, 7)]),
    "avg-pool-full": (lambda m, x: m.nd.Pooling(
        x, kernel=(2, 2), stride=(2, 2), pad=(1, 1), pool_type="avg",
        pooling_convention="full", count_include_pad=False),
        [(2, 3, 6, 6)]),
    "global-avg-pool": (lambda m, x: m.nd.Pooling(
        x, global_pool=True, pool_type="avg"), [(2, 3, 5, 5)]),
    "batchnorm-train": (lambda m, x, g, b: m.nd.BatchNorm(
        x, g, b, m.nd.zeros((3,)), m.nd.ones((3,)), fix_gamma=False,
        eps=1e-5, _training=True), [(4, 3, 5, 5), (3,), (3,)]),
    "batchnorm-predict": (lambda m, x, g, b: m.nd.BatchNorm(
        x, g, b, m.nd.zeros((3,)) + 0.1, m.nd.ones((3,)) * 2,
        fix_gamma=False, eps=1e-5, _training=False),
        [(4, 3, 5, 5), (3,), (3,)]),
}


@pytest.mark.parametrize("case", list(GRAD_CASES))
def test_gradients(case):
    fn, shapes = GRAD_CASES[case]
    arrays = [_rand(30 + i, *s, scale=0.5) + (1.0 if len(s) == 1 else 0.0)
              for i, s in enumerate(shapes)]
    _both(lambda m: _grads(m, fn, arrays))


# -- layers -------------------------------------------------------------------

def _weights(net, seed):
    """A numpy value per parameter (full name): weights scaled by fan-in,
    gamma near 1, running variance positive."""
    r = np.random.RandomState(seed)
    out = {}
    for name, p in net.collect_params().items():
        shape = p.shape
        if name.endswith(("gamma", "running_var")):
            w = r.uniform(0.5, 1.5, shape)
        elif name.endswith(("beta", "bias", "running_mean")):
            w = r.uniform(-0.2, 0.2, shape)
        else:
            fan_in = max(1, int(np.prod(shape[1:])))
            w = r.randn(*shape) / np.sqrt(fan_in)
        out[name] = w.astype(np.float32)
    return out


def _set(net, weights):
    for name, p in net.collect_params().items():
        p.set_data(weights[name])


def _layers(m):
    nn = m.gluon.nn
    net = nn.HybridSequential()
    with net.name_scope():
        # 10x10 -> 5x5 -> 4x4 -> 3x3 (ceil: the last window holds one
        # real row and two of padding) -> 6x6 -> 8x8 -> 1x1
        net.add(nn.Conv2D(6, 3, padding=1, in_channels=3),
                nn.BatchNorm(in_channels=6),
                nn.Activation("relu"),
                nn.MaxPool2D(3, 2, 1),
                nn.Conv2D(8, 2, groups=2, in_channels=6),
                nn.InstanceNorm(in_channels=8, scale=True),
                nn.AvgPool2D(3, strides=2, padding=1, ceil_mode=True,
                             count_include_pad=False),
                nn.Conv2DTranspose(4, 3, strides=2, padding=1,
                                   output_padding=1, in_channels=8,
                                   use_bias=False),
                nn.GroupNorm(num_groups=2, in_channels=4),
                nn.ReflectionPad2D(1),
                nn.GlobalAvgPool2D(),
                nn.Flatten(),
                nn.Dense(5, in_units=4))
    return net


def _deferred_layers(m):
    nn = m.gluon.nn
    net = nn.HybridSequential()
    with net.name_scope():
        net.add(nn.Conv1D(4, 3), nn.BatchNorm(), nn.MaxPool1D(2),
                nn.Conv1DTranspose(3, 2, strides=2, use_bias=False),
                nn.GlobalMaxPool1D())
    return net


def _deferred_3d(m):
    nn = m.gluon.nn
    net = nn.HybridSequential()
    with net.name_scope():
        net.add(nn.Conv3D(3, 2, padding=1), nn.BatchNorm(axis=1),
                nn.AvgPool3D(2),
                nn.Conv3DTranspose(2, 2, strides=2, use_bias=False),
                nn.GlobalAvgPool3D())
    return net


# transposed convolutions without a bias: the reference drops it
LAYER_NETS = {"2d": (_layers, (2, 3, 10, 10)),
              "1d-deferred": (_deferred_layers, (2, 3, 10)),
              "3d-deferred": (_deferred_3d, (1, 2, 4, 5, 6))}


@pytest.mark.parametrize("hybridize", [False, True],
                         ids=["imperative", "hybridized"])
@pytest.mark.parametrize("case", list(LAYER_NETS))
def test_layers(case, hybridize):
    """Deferred shapes resolve alike (the first forward, predict mode),
    then a train-mode forward agrees and moves the statistics alike."""
    build, shape = LAYER_NETS[case]
    x = _rand(40, *shape)
    jnet, tnet = _pair(build)

    def run(m, net):
        net.initialize(m.init.Zero())
        net(m.nd.array(x))
        if hybridize:
            net.hybridize()
        return net

    run(jmx, jnet)
    run(mx, tnet)
    weights = _weights(jnet, 41)
    assert list(tnet.collect_params().keys()) == list(weights)
    _set(jnet, weights)
    _set(tnet, weights)

    def forward(m):
        net = jnet if m is jmx else tnet
        with m.autograd.train_mode():
            out = net(m.nd.array(x))
        return [out] + [p.data() for p in net.collect_params().values()]

    assert np.isfinite(_both(forward)[0]).all()


def test_conv_layer_repr_and_shapes():
    conv = mx.gluon.nn.Conv2D(8, 3, strides=2, in_channels=4)
    deconv = mx.gluon.nn.Conv2DTranspose(8, 3, in_channels=4, groups=2)
    assert conv.weight.shape == (8, 4, 3, 3)
    assert deconv.weight.shape == (4, 4, 3, 3)
    assert "Conv2D(8" in repr(conv)
    assert mx.gluon.nn.ReflectionPad2D(2)._padding == (0, 0, 0, 0, 2, 2, 2, 2)


# -- the ResNet zoo -----------------------------------------------------------

@pytest.mark.parametrize("name", ["resnet50_v1", "resnet18_v1", "resnet50_v2",
                                  "resnet18_v2"])
def test_resnet_names_match_reference(name):
    """collect_params() names and shapes (deferred dims 0) letter for
    letter, and the structural names ``save_parameters`` writes."""
    jnet, tnet = _pair(lambda m: m.gluon.model_zoo.get_model(name,
                                                             classes=11))
    j, t = jnet.collect_params(), tnet.collect_params()
    assert list(t.keys()) == list(j.keys())
    for k in j.keys():
        assert tuple(t[k].shape) == tuple(j[k].shape), k
        assert t[k].grad_req == j[k].grad_req, k
    assert list(tnet._collect_params_with_prefix()) == \
        list(jnet._collect_params_with_prefix())


def test_resnet50_structure():
    """``tests/test_model_zoo.py:66`` on the port."""
    net = mx.gluon.model_zoo.vision.resnet50_v1(classes=11)
    params = net.collect_params()
    keys = list(params.keys())
    assert keys[0] == "resnetv10_conv2d0_weight"
    assert "resnetv10_stage1_batchnorm0_running_mean" in keys
    n_convs = sum(1 for k in keys if "conv" in k and k.endswith("weight"))
    assert n_convs == 1 + (3 + 4 + 6 + 3) * 3 + 4
    dense_w = next(k for k in keys if "dense" in k and k.endswith("weight"))
    assert params[dense_w].shape[0] == 11
    assert "features.4.0.body.0.weight" in net._collect_params_with_prefix()
    assert bool(net.features[4][0].downsample)
    assert net.features[4][1].downsample is None


def test_get_model_errors():
    vision = mx.gluon.model_zoo.vision
    with pytest.raises(mx.MXNetError, match="not in the model zoo"):
        vision.get_model("resnet51_v1")
    with pytest.raises(mx.MXNetError, match="pretrained"):
        vision.get_model("resnet18_v1", pretrained=True)
    with pytest.raises(mx.MXNetError, match="pretrained"):
        vision.get_model("densenet121", pretrained=True)
    assert type(vision.get_model("densenet121")).__name__ == "DenseNet"
    with pytest.raises(mx.MXNetError, match="invalid resnet depth"):
        vision.get_resnet(1, 20)


def _bottleneck(m):
    v = m.gluon.model_zoo.vision
    return v.ResNetV1(v.BottleneckV1, [1, 1], [8, 16, 32],
                      classes=5)


def _basic_v2_thumbnail(m):
    v = m.gluon.model_zoo.vision
    return v.ResNetV2(v.BasicBlockV2, [1, 1], [4, 8, 16],
                      classes=5, thumbnail=True)


RESNETS = {"bottleneck_v1": (_bottleneck, (4, 3, 32, 32)),
           "basic_v2_thumbnail": (_basic_v2_thumbnail, (2, 3, 12, 12))}


def _resnet_pair(name, seed=50):
    """The ResNet ``name`` in both packages on the same weights: the port
    resolves the deferred shapes (a predict-mode forward), and both take
    numpy draws of those shapes by ``set_data``."""
    build, shape = RESNETS[name]
    jnet, tnet = _pair(build)
    x = _rand(seed, *shape)
    tnet.initialize(mx.init.Zero())
    tnet(mx.nd.array(x))
    weights = _weights(tnet, seed + 1)
    _set(jnet, weights)
    _set(tnet, weights)
    return jnet, tnet, x


@pytest.mark.parametrize("train", [False, True], ids=["predict", "train"])
@pytest.mark.parametrize("name", list(RESNETS))
def test_resnet_forward_matches_reference(name, train):
    jnet, tnet, x = _resnet_pair(name)

    def forward(m):
        net = jnet if m is jmx else tnet
        mode = m.autograd.train_mode if train else m.autograd.predict_mode
        with mode():
            out = net(m.nd.array(x))
        return [out] + [p.data() for k, p in net.collect_params().items()
                        if "running" in k]

    _both(forward)


def _labels(n, classes=5):
    return np.random.RandomState(n).randint(0, classes, n).astype(np.float32)


# lr 0.01: at 0.1 the 4-image batch is fit in one step and the loss sits
# near 0, where float32 rounding of the logits alone moves it by 3e-4 of
# itself
SGD = {"learning_rate": 0.01, "momentum": 0.9}


def _gluon_loop(m, net, x, y, steps=3, hybridize=False):
    """record, SoftmaxCELoss, backward, Trainer("sgd", momentum).step(B):
    per-step mean losses, then every parameter's value."""
    if hybridize:
        net.hybridize()
    loss_fn = m.gluon.loss.SoftmaxCELoss()
    trainer = m.gluon.Trainer(net.collect_params(), "sgd", SGD)
    losses = []
    for _ in range(steps):
        with m.autograd.record():
            loss = loss_fn(net(m.nd.array(x)), m.nd.array(y))
        loss.backward()
        trainer.step(x.shape[0])
        losses.append(float(loss.mean().asnumpy()))
    return losses, {k: p.data().asnumpy()
                    for k, p in net.collect_params().items()}


@pytest.fixture(scope="module")
def resnet_reference():
    """The reference's hybridized Gluon loop over the bottleneck net (3
    steps): (weights before, batch, losses, parameters after)."""
    with mx.cpu():
        jnet, _, x = _resnet_pair("bottleneck_v1")
    start = {k: p.data().asnumpy() for k, p in jnet.collect_params().items()}
    y = _labels(x.shape[0])
    losses, after = _gluon_loop(jmx, jnet, x, y, hybridize=True)
    return start, x, y, losses, after


def _port_bottleneck(start):
    tnet = _fresh(lambda: _bottleneck(mx))
    _set(tnet, start)
    return tnet


def _check_stats(got, want):
    """The running statistics after training agree; the weights are held
    through the losses (a weight's gradient comes back through BatchNorm's
    cancelling sums, so its last bits are the summation order's)."""
    stats = [k for k in want if "running" in k]
    assert stats
    for k in stats:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4,
                                   atol=1e-4 * np.abs(want[k]).max(),
                                   err_msg=k)


@pytest.mark.parametrize("hybridize", [False, True],
                         ids=["imperative", "hybridized"])
def test_resnet_trainer_matches_reference(resnet_reference, hybridize):
    """3 SGD-momentum steps: the reference's per-step losses, and the
    running statistics after them."""
    start, x, y, want, after = resnet_reference
    got, params = _gluon_loop(mx, _port_bottleneck(start), x, y,
                              hybridize=hybridize)
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert got[-1] < got[0]
    _check_stats(params, after)


def test_resnet_trainstep_matches_reference(resnet_reference):
    """``parallel.TrainStep`` (``run(..., steps=3)``, one batch; the mean
    loss, SGD momentum, rescale 1) against the reference's Gluon loop: the
    same updates, since SoftmaxCELoss's mean over the batch and step(B)
    give the same gradient; the statistics are carried by the step."""
    from mxnet_tpu_torch import parallel
    from mxnet_tpu_torch.ops.nn import softmax_cross_entropy
    start, x, y, want, after = resnet_reference
    tnet = _port_bottleneck(start)
    B = x.shape[0]
    step = parallel.TrainStep(
        tnet, lambda out, lab: softmax_cross_entropy(out, lab) / B, "sgd",
        optimizer_params=SGD)
    got = step.run(torch.tensor(x), torch.tensor(y), steps=3)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4)
    _check_stats({k: p.data().asnumpy()
                  for k, p in tnet.collect_params().items()}, after)


def test_trainstep_resolves_deferred_shapes_without_moving_statistics():
    """A net never called: TrainStep's probe forward (predict mode)
    resolves the deferred shapes; only the training step moves the
    statistics, once per step."""
    from mxnet_tpu_torch import parallel
    from mxnet_tpu_torch.ops.nn import softmax_cross_entropy
    net = _fresh(lambda: _basic_v2_thumbnail(mx))
    net.initialize(mx.init.Xavier())
    x = _rand(60, 2, 3, 12, 12)
    y = _labels(2)
    step = parallel.TrainStep(net, lambda o, l: softmax_cross_entropy(o, l),
                              "sgd", optimizer_params={"learning_rate": 0.0})
    rm = net.features[0].running_mean
    step(torch.tensor(x), torch.tensor(y))
    mean = x.mean(axis=(0, 2, 3))
    np.testing.assert_allclose(rm.data().asnumpy(), 0.1 * mean, rtol=1e-4,
                               atol=1e-6)
    step(torch.tensor(x), torch.tensor(y))
    np.testing.assert_allclose(rm.data().asnumpy(), 0.19 * mean, rtol=1e-4,
                               atol=1e-6)


def test_cast_bf16_keeps_batchnorm_f32():
    net = _fresh(lambda: _bottleneck(mx))
    net.initialize(mx.init.Xavier())
    x = _rand(61, 2, 3, 32, 32)
    net(mx.nd.array(x))
    net.cast("bfloat16")
    for name, p in net.collect_params().items():
        want = torch.float32 if "batchnorm" in name else torch.bfloat16
        assert p.data()._data.dtype == want, name
    with mx.autograd.record():
        out = net(mx.nd.array(x).astype("bfloat16"))
    assert out._data.dtype == torch.bfloat16
    out.astype("float32").sum().backward()
    assert np.isfinite(out.astype("float32").asnumpy()).all()
