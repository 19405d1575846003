"""The port's parameter files held against the JAX package's, on the CPU:
``dmlc_params`` (the reference ``.params`` byte layout) against the golden
bytes of ``tests/test_checkpoint.py``, ``nd.save``/``nd.load`` files
crossing between the two packages in both formats, and
``Block.save_parameters``/``load_parameters`` and ``ParameterDict.save``/
``load`` moving a trained ResNet, running statistics included, from one
package to the other.

Every value that crosses is compared exactly (``assert_array_equal``,
bfloat16 by its bits); the outputs of a loaded net against the net that
was saved, in the same package, exactly; across packages at the float32
forward tolerance of ``test_torch_vision.py`` (``rtol=1e-4, atol=1e-5``).
"""

import struct
import threading

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import dmlc_params

PKGS = (jmx, mx)
TOL = {"rtol": 1e-4, "atol": 1e-5}


@pytest.fixture(autouse=True)
def _on_cpu():
    with mx.cpu():
        yield


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """torch's CPU convolution on one thread (see test_torch_vision.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -- the dmlc byte layout -----------------------------------------------------

def test_dmlc_exact_golden_bytes():
    """``tests/test_checkpoint.py::test_dmlc_exact_golden_bytes`` on the
    port's copy, and the reference's writer gives the same bytes."""
    arr = np.array([[1.0, 2.0]], np.float32)
    blob = dmlc_params.save_bytes([arr], ["arg:w"])
    expect = b"".join([
        struct.pack("<QQ", 0x112, 0),
        struct.pack("<Q", 1),
        struct.pack("<I", 0xF993FAC9),
        struct.pack("<i", 0),
        struct.pack("<I", 2),
        struct.pack("<qq", 1, 2),
        struct.pack("<ii", 1, 0),
        struct.pack("<i", 0),
        arr.tobytes(),
        struct.pack("<Q", 1),
        struct.pack("<Q", 5), b"arg:w",
    ])
    assert blob == expect
    from mxnet_tpu import dmlc_params as jdmlc
    assert jdmlc.save_bytes([arr], ["arg:w"]) == expect
    back, names = dmlc_params.load_bytes(blob)
    np.testing.assert_array_equal(back[0], arr)
    assert names == ["arg:w"]


def test_dmlc_reads_v1_era_32bit_dims():
    arr = np.array([3.0, 4.0, 5.0], np.float32)
    blob = b"".join([
        struct.pack("<QQ", 0x112, 0), struct.pack("<Q", 1),
        struct.pack("<I", 0xF993FAC9), struct.pack("<i", 0),
        struct.pack("<I", 1), struct.pack("<i", 3),
        struct.pack("<ii", 1, 0), struct.pack("<i", 0),
        arr.tobytes(), struct.pack("<Q", 0),
    ])
    back, names = dmlc_params.load_bytes(blob)
    np.testing.assert_array_equal(back[0], arr)
    assert names == []


def test_dmlc_reads_v1_era_2d_f64():
    arr = np.zeros((3, 4), np.float64)
    arr[0, 1] = 2.5
    blob = b"".join([
        struct.pack("<QQ", 0x112, 0), struct.pack("<Q", 1),
        struct.pack("<I", 0xF993FAC9), struct.pack("<i", 0),
        struct.pack("<I", 2), struct.pack("<ii", 3, 4),
        struct.pack("<ii", 1, 0), struct.pack("<i", 1),
        arr.tobytes(), struct.pack("<Q", 0),
    ])
    back, _ = dmlc_params.load_bytes(blob)
    np.testing.assert_array_equal(back[0], arr)


def test_dmlc_rejects_garbage_and_bf16(tmp_path):
    with pytest.raises(mx.MXNetError, match="magic"):
        dmlc_params.load_bytes(b"\x00" * 64)
    assert not dmlc_params.is_dmlc_params(b"PK\x03\x04....")
    for m in PKGS:
        with pytest.raises(m.MXNetError, match="predates bfloat16"):
            m.nd.save(str(tmp_path / "b.params"),
                      {"w": m.nd.ones((2,)).astype("bfloat16")},
                      format="dmlc")


# -- files crossing between the packages --------------------------------------

DTYPES = ["float32", "float64", "float16", "int32", "int64", "uint8"]


def _arrays(dtype):
    r = np.random.RandomState(len(dtype))
    a = (r.randn(3, 4) * 50).astype(dtype)
    b = (r.randn(5) * 50).astype(dtype)
    return {"arg:w": a, "aux:b": b}


@pytest.mark.parametrize("fmt", ["npz", "dmlc"])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_files_cross_packages(tmp_path, writer, dtype, fmt):
    """A dict and a list saved by one package load in the other with every
    value and dtype kept."""
    src, dst = (jmx, mx) if writer == "jax" else (mx, jmx)
    arrays = _arrays(dtype)
    f = str(tmp_path / "x.params")
    src.nd.save(f, {k: src.nd.array(v, dtype=dtype)
                    for k, v in arrays.items()}, format=fmt)
    back = dst.nd.load(f)
    assert set(back) == set(arrays)
    for k, v in arrays.items():
        assert np.dtype(back[k].dtype) == np.dtype(dtype)
        np.testing.assert_array_equal(back[k].asnumpy(), v)
    src.nd.save(f, [src.nd.array(v, dtype=dtype) for v in arrays.values()],
                format=fmt)
    back = dst.nd.load(f)
    assert isinstance(back, list) and len(back) == 2
    np.testing.assert_array_equal(back[0].asnumpy(), arrays["arg:w"])


def test_params_format_knob(tmp_path, monkeypatch):
    """``MXNET_PARAMS_FORMAT`` picks the default container; load tells."""
    f = str(tmp_path / "k.params")
    mx.nd.save(f, {"w": mx.nd.ones((2,))})
    with open(f, "rb") as fh:
        assert fh.read(2) == b"PK"
    monkeypatch.setenv("MXNET_PARAMS_FORMAT", "dmlc")
    mx.nd.save(f, {"w": mx.nd.ones((2,))})
    with open(f, "rb") as fh:
        assert dmlc_params.is_dmlc_params(fh.read(8))
    np.testing.assert_array_equal(jmx.nd.load(f)["w"].asnumpy(), [1, 1])
    with pytest.raises(mx.MXNetError, match="unknown params format"):
        mx.nd.save(f, {"w": mx.nd.ones((2,))}, format="hdf5")


def test_bf16_npz_from_the_reference_reads_bit_exact(tmp_path):
    """The reference writes bfloat16 into its npz as a 2-byte void (and
    cannot read it back, ROADMAP.md queue C); the port reads those bits as
    bfloat16, and its own bf16 npz holds the same payload bytes."""
    x = np.random.RandomState(4).randn(6, 5).astype(np.float32)
    want = torch.tensor(x).bfloat16()
    f, g = str(tmp_path / "j.params"), str(tmp_path / "t.params")
    jmx.nd.save(f, {"w": jmx.nd.array(x).astype("bfloat16")})
    got = mx.nd.load(f)["w"]._data
    assert got.dtype == torch.bfloat16
    assert torch.equal(got.view(torch.int16), want.view(torch.int16))
    mx.nd.save(g, {"w": mx.nd.array(x).astype("bfloat16")})
    with np.load(f) as zj, np.load(g) as zt:
        assert zj["name:w"].tobytes() == zt["name:w"].tobytes()
        assert zt["name:w"].dtype.itemsize == 2
    assert torch.equal(mx.nd.load(g)["w"]._data, got)


# -- nets ---------------------------------------------------------------------

def _fresh(build):
    out = {}
    t = threading.Thread(target=lambda: out.setdefault("v", build()))
    t.start()
    t.join(timeout=120)
    assert not t.is_alive() and "v" in out
    return out["v"]


def _resnet(m):
    """The 7x7 stem, max-pool and one bottleneck stage with a downsample:
    small, so the JAX side's one training compile stays short."""
    v = m.gluon.model_zoo.vision
    return v.ResNetV1(v.BottleneckV1, [1], [8, 16], classes=5)


X = np.random.RandomState(70).randn(4, 3, 32, 32).astype(np.float32)
Y = np.random.RandomState(71).randint(0, 5, 4).astype(np.float32)


def _shapes():
    """The small ResNet's parameter shapes, deferred ones resolved (by the
    port, without a compile)."""
    net = _fresh(lambda: _resnet(mx))
    net.initialize(mx.init.Zero())
    net(mx.nd.array(X))
    return {k: p.shape for k, p in net.collect_params().items()}


def _trained(m, shapes, seed=72):
    """A small bottleneck ResNet in package ``m`` on weights drawn in numpy,
    after 2 SGD steps in train mode: its running statistics have moved."""
    net = _fresh(lambda: _resnet(m))
    r = np.random.RandomState(seed)
    start = {}
    for name, p in net.collect_params().items():
        shape = shapes[name]
        if name.endswith(("gamma", "running_var")):
            w = r.uniform(0.5, 1.5, shape)
        elif name.endswith(("beta", "bias", "running_mean")):
            w = r.uniform(-0.2, 0.2, shape)
        else:
            w = r.randn(*shape) / np.sqrt(np.prod(shape[1:]))
        start[name] = w.astype(np.float32)
        p.set_data(start[name])
    net.hybridize()             # one compile on the JAX side
    trainer = m.gluon.Trainer(net.collect_params(), "sgd",
                              {"learning_rate": 0.01, "momentum": 0.9})
    loss_fn = m.gluon.loss.SoftmaxCELoss()
    for _ in range(2):
        with m.autograd.record():
            loss = loss_fn(net(m.nd.array(X)), m.nd.array(Y))
        loss.backward()
        trainer.step(X.shape[0])
    after = _values(net)
    assert all(not np.array_equal(after[k], start[k])
               for k in after if "running" in k)
    return net


def _predict(m, net):
    with m.autograd.predict_mode():
        return net(m.nd.array(X)).asnumpy()


def _values(net):
    return {k: p.data().asnumpy() for k, p in net.collect_params().items()}


@pytest.fixture(scope="module")
def trained():
    """The small ResNet trained in each package: {package: net}."""
    with mx.cpu():
        shapes = _shapes()
        return {m: _trained(m, shapes) for m in PKGS}


@pytest.mark.parametrize("fmt", ["npz", "dmlc"])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_save_parameters_cross_packages(trained, tmp_path, writer, fmt,
                                        monkeypatch):
    """``save_parameters`` of a trained net in one package, then
    ``load_parameters`` into a fresh, never-called net of the other: every
    value (running statistics included) equal, and the same outputs."""
    src, dst = (jmx, mx) if writer == "jax" else (mx, jmx)
    net = trained[src]
    f = str(tmp_path / "r.params")
    monkeypatch.setenv("MXNET_PARAMS_FORMAT", fmt)
    net.save_parameters(f)
    fresh = _fresh(lambda: _resnet(dst))
    fresh.load_parameters(f)
    want, got = _values(net), _values(fresh)
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    np.testing.assert_allclose(_predict(dst, fresh), _predict(src, net),
                               **TOL)


def test_load_parameters_same_package_is_exact(trained, tmp_path):
    net = trained[mx]
    f = str(tmp_path / "s.params")
    net.save_parameters(f)
    keys = list(mx.nd.load(f))
    assert "features.1.running_var" in keys
    assert "features.4.0.body.0.weight" in keys
    fresh = _fresh(lambda: _resnet(mx))
    fresh.load_parameters(f, ctx=mx.cpu())
    np.testing.assert_array_equal(_predict(mx, fresh), _predict(mx, net))


def test_load_parameters_by_full_name(trained, tmp_path):
    """A file keyed by ``collect_params()`` names (``ParameterDict.save``)
    loads through ``load_parameters`` too, as in the reference."""
    net = trained[mx]
    f = str(tmp_path / "p.params")
    net.collect_params().save(f)
    assert "resnetv10_conv2d0_weight" in mx.nd.load(f)
    fresh = _fresh(lambda: _resnet(mx))
    fresh.load_parameters(f)
    np.testing.assert_array_equal(_predict(mx, fresh), _predict(mx, net))


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_parameter_dict_strip_and_restore_prefix(trained, tmp_path, writer):
    src, dst = (jmx, mx) if writer == "jax" else (mx, jmx)
    f = str(tmp_path / "d.params")
    trained[src].collect_params().save(f, strip_prefix="resnetv10_")
    keys = list(dst.nd.load(f))
    assert "conv2d0_weight" in keys and "stage1_batchnorm0_running_mean" \
        in keys
    fresh = _fresh(lambda: _resnet(dst))
    params = fresh.collect_params()
    params.load(f, restore_prefix="resnetv10_")
    want = _values(trained[src])
    for k, p in params.items():
        np.testing.assert_array_equal(p.data().asnumpy(), want[k], err_msg=k)


def test_missing_and_extra_names_raise(trained, tmp_path):
    net = trained[mx]
    f = str(tmp_path / "m.params")
    params = net._collect_params_with_prefix()
    values = {k: p.data() for k, p in params.items()}
    mx.nd.save(f, {k: v for k, v in values.items()
                   if k != "features.1.running_mean"})
    fresh = _fresh(lambda: _resnet(mx))
    with pytest.raises(mx.MXNetError, match="features.1.running_mean"):
        fresh.load_parameters(f)
    fresh = _fresh(lambda: _resnet(mx))
    fresh.load_parameters(f, allow_missing=True)
    mx.nd.save(f, dict(values, extra_weight=mx.nd.ones((2,))))
    fresh = _fresh(lambda: _resnet(mx))
    with pytest.raises(mx.MXNetError, match="extra_weight"):
        fresh.load_parameters(f)
    fresh.load_parameters(f, ignore_extra=True)
    pd = fresh.collect_params()
    full = {k: p.data() for k, p in net.collect_params().items()}
    mx.nd.save(f, dict(full, extra_weight=mx.nd.ones((2,))))
    with pytest.raises(mx.MXNetError, match="extra parameters"):
        pd.load(f)
    pd.load(f, ignore_extra=True)
    g = str(tmp_path / "n.params")
    mx.nd.save(g, {"resnetv10_conv2d0_weight": values["features.0.weight"]})
    with pytest.raises(mx.MXNetError, match="missing"):
        pd.load(g)
    pd.load(g, allow_missing=True)


def test_resnet_from_gluon_carries_statistics(trained):
    """``convert.resnet_from_gluon``: the reference net's collect_params()
    values, running statistics included, by name in both directions."""
    from mxnet_tpu_torch import convert
    jnet = trained[jmx]
    params = _values(jnet)
    with pytest.raises(mx.MXNetError, match="resnet_from_gluon"):
        convert.resnet_from_gluon(params)      # resnet50_v1: other names
    net = convert.load_by_name(_fresh(lambda: _resnet(mx)), params,
                               device="cpu")
    got = _values(net)
    for k in params:
        np.testing.assert_array_equal(got[k], params[k], err_msg=k)
    np.testing.assert_allclose(_predict(mx, net), _predict(jmx, jnet), **TOL)
    bad = dict(params)
    bad.pop("resnetv10_batchnorm0_running_var")
    with pytest.raises(mx.MXNetError, match="missing"):
        convert.load_by_name(_fresh(lambda: _resnet(mx)), bad)


def test_bf16_net_roundtrips_through_npz(trained, tmp_path):
    """A bf16-cast net (BatchNorm kept in f32) saves and loads into a net
    cast the same way, bit for bit."""
    net = _fresh(lambda: _resnet(mx))
    net.initialize(mx.init.Zero())
    net(mx.nd.array(X))
    for k, p in net.collect_params().items():
        p.set_data(trained[mx].collect_params()[k].data())
    net.cast("bfloat16")
    f = str(tmp_path / "b.params")
    net.save_parameters(f)
    fresh = _fresh(lambda: _resnet(mx))
    fresh.initialize(mx.init.Zero())
    fresh(mx.nd.array(X))
    fresh.cast("bfloat16")
    fresh.load_parameters(f)
    for (k, p), q in zip(net.collect_params().items(),
                         fresh.collect_params().values()):
        assert q.data()._data.dtype == p.data()._data.dtype, k
        assert torch.equal(q.data()._data, p.data()._data), k
