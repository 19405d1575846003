"""The port's small training utilities held against the JAX package's on the
CPU: ``engine`` (the reference's ``tests/test_engine.py`` cases),
``runtime``, ``test_utils``, ``monitor``, ``callback``, ``model`` (its
``.params`` files crossing both ways), and ``operator``/``library`` (the
reference's ``tests/test_components.py`` cases).

Tolerances: the op battery under NaiveEngine bit for bit against the
default engine (the same torch calls); the monitor's stats against the
reference's within 1e-6 relative (a mean over float32 values, summed in
another order); ``.params`` round trips bit for bit.
"""

import logging
import os

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import autograd, engine, gluon
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops import registry


@pytest.fixture(autouse=True)
def _on_cpu():
    with mx.cpu():
        yield


@pytest.fixture
def naive_engine():
    engine.set_engine_type("NaiveEngine")
    try:
        yield
    finally:
        engine.set_engine_type("ThreadedEnginePerDevice")


@pytest.fixture
def restore_registries():
    """Ops a test registers leave both registries and ``mx.nd`` again."""
    from mxnet_tpu import operator as jop
    from mxnet_tpu.ops import registry as jreg
    before = (set(registry._REGISTRY), set(mx.operator._REGISTRY),
              set(vars(mx.nd)), set(jreg._REGISTRY), set(jop._REGISTRY))
    yield
    for reg, keys in ((registry._REGISTRY, before[0]),
                      (mx.operator._REGISTRY, before[1]),
                      (jreg._REGISTRY, before[3]),
                      (jop._REGISTRY, before[4])):
        for k in set(reg) - keys:
            del reg[k]
    for k in set(vars(mx.nd)) - before[2]:
        delattr(mx.nd, k)


# -- engine -------------------------------------------------------------------

def _op_battery(m):
    r = np.random.RandomState(42)
    a = m.nd.array(r.randn(4, 5).astype(np.float32))
    b = m.nd.array(r.randn(5, 3).astype(np.float32))
    idx = m.nd.array(np.array([0, 2], np.int32))
    outs = [m.nd.dot(a, b), (a * 2 + 1).sum(axis=1),
            m.nd.softmax(a, axis=-1), m.nd.take(a, idx, axis=0),
            m.nd.relu(a) - m.nd.sigmoid(a),
            m.nd.topk(a, k=2, axis=-1, ret_typ="value")]
    w = m.nd.array(r.randn(5, 3).astype(np.float32))
    w.attach_grad()
    with m.autograd.record():
        loss = (m.nd.dot(a, w) ** 2).sum()
    loss.backward()
    outs.append(w.grad)
    return [o.asnumpy() for o in outs]


def test_naive_vs_async_differential():
    """NaiveEngine gives the default engine's bits, and the reference's
    values."""
    default = _op_battery(mx)
    engine.set_engine_type("NaiveEngine")
    try:
        assert engine.is_naive()
        naive = _op_battery(mx)
    finally:
        engine.set_engine_type("ThreadedEnginePerDevice")
    assert not engine.is_naive()
    for d, n, w in zip(default, naive, _op_battery(jmx)):
        np.testing.assert_array_equal(d, n)
        np.testing.assert_allclose(d, w, rtol=1e-5, atol=1e-6)


def test_engine_type_reads_the_config_key(monkeypatch):
    monkeypatch.setattr(engine, "_engine_type", None)
    monkeypatch.setenv("MXNET_ENGINE_TYPE", "NaiveEngine")
    assert engine.is_naive()
    monkeypatch.setattr(engine, "_engine_type", None)
    monkeypatch.delenv("MXNET_ENGINE_TYPE")
    assert not engine.is_naive()
    assert engine._current_type() == "ThreadedEnginePerDevice"


def test_naive_engine_training(naive_engine):
    net = gluon.nn.Dense(3, in_units=4)
    net.initialize()
    tr = gluon.Trainer(net.collect_params(), "sgd", {"learning_rate": 0.1})
    with autograd.record():
        loss = (net(mx.nd.ones((2, 4))) ** 2).sum()
    loss.backward()
    tr.step(2)
    assert np.isfinite(loss.asnumpy()).all()


def test_invalid_shape_raises_promptly():
    with pytest.raises(Exception):  # noqa: B017 - torch's shape error
        mx.nd.dot(mx.nd.ones((2, 3)), mx.nd.ones((4, 5)))


def test_custom_function_error_propagates():
    class Bad(autograd.Function):
        def forward(self, x):
            raise RuntimeError("boom in custom forward")

        def backward(self, dy):
            return dy

    with pytest.raises(RuntimeError, match="boom"):
        with autograd.record():
            Bad()(mx.nd.ones((2,)))


def test_waitall_noop_and_bulk_scope():
    with engine.bulk(16):
        x = mx.nd.ones((8,)) * 3
    mx.nd.waitall()
    engine.waitall()
    np.testing.assert_array_equal(x.asnumpy(), 3.0)
    assert engine.set_bulk_size(7) == jmx.engine.set_bulk_size(7) == 7
    assert not engine.capturing()


def test_waitall_synchronizes_only_the_devices_the_port_used(monkeypatch):
    """Four visible cards, the port on card 2 (and the current card 0):
    ``waitall`` synchronizes those two and makes no context on 1 or 3."""
    from mxnet_tpu_torch import context
    synced = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "synchronize", synced.append)
    monkeypatch.setattr(context, "_used_cuda", set())
    engine.waitall()
    assert synced == [0]
    assert context.resolve_device(mx.gpu(2)) == torch.device("cuda", 2)
    synced.clear()
    engine.waitall()
    assert synced == [0, 2]


def test_on_dispatch_sees_each_ops_outputs(naive_engine, monkeypatch):
    seen = []
    monkeypatch.setattr(engine, "on_dispatch",
                        lambda outs: seen.append(len(outs)))
    mx.nd.topk(mx.nd.ones((2, 3)), k=1, ret_typ="both")
    mx.nd.relu(mx.nd.ones((2,)))
    assert seen[-2:] == [2, 1]


# -- runtime ------------------------------------------------------------------

def test_features_keep_the_reference_names_and_add_nccl():
    want = set(jmx.runtime.Features())
    got = mx.runtime.Features()
    assert set(got) == want | {"NCCL"}
    for name in ("TPU", "XLA", "PALLAS", "OPENCV", "DIST_KVSTORE"):
        assert not got.is_enabled(name), name
    assert got.is_enabled("profiler") and got.is_enabled("CPU")
    assert got.is_enabled("CUDA") == torch.cuda.is_available()
    assert got.is_enabled("CUDNN") <= got.is_enabled("CUDA")
    assert mx.runtime.Features() is got
    assert [f.name for f in mx.runtime.feature_list()] == list(got)
    with pytest.raises(RuntimeError, match="does not exist"):
        got.is_enabled("quantum")
    assert "✖ TPU" in repr(got)


# -- test_utils ---------------------------------------------------------------

def test_default_context_is_the_card_else_the_cpu():
    tu = mx.test_utils
    want = mx.gpu(0) if mx.num_gpus() else mx.cpu(0)
    assert tu.default_context() == want
    tu.set_default_context(mx.cpu(1))
    try:
        assert tu.default_context() == mx.cpu(1)
    finally:
        tu.set_default_context(None)


def test_tolerances_are_the_references():
    tu = mx.test_utils
    for dt in ("float16", "float32", "float64"):
        a = np.zeros(2, dt)
        assert tu.default_rtols(a) == jmx.test_utils.default_rtols(a), dt
    bf = mx.nd.zeros((2,)).astype("bfloat16")
    assert tu.effective_dtype(bf) == "bfloat16"
    assert tu.default_rtols(bf, np.zeros(2, np.float32)) == (2e-2, 2e-2)


def test_assert_almost_equal_and_same():
    tu = mx.test_utils
    a = mx.nd.array([1.0, 2.0])
    tu.assert_almost_equal(a, np.array([1.0, 2.00001], np.float32))
    assert tu.almost_equal(a, a) and tu.same(a, a.asnumpy())
    assert not tu.same(a, np.array([1.0, 2.5], np.float32))
    with pytest.raises(AssertionError, match="differ"):
        tu.assert_almost_equal(a, np.array([1.0, 2.1], np.float32))
    with pytest.raises(AssertionError):
        jmx.test_utils.assert_almost_equal(
            jmx.nd.array([1.0, 2.0]), np.array([1.0, 2.1], np.float32))


def test_rand_helpers_and_sparse_raises():
    tu = mx.test_utils
    np.random.seed(0)
    s2, s3, sn = tu.rand_shape_2d(), tu.rand_shape_3d(), tu.rand_shape_nd(4)
    np.random.seed(0)
    assert (s2, s3, sn) == (jmx.test_utils.rand_shape_2d(),
                            jmx.test_utils.rand_shape_3d(),
                            jmx.test_utils.rand_shape_nd(4))
    x = tu.rand_ndarray((3, 4))
    assert x.shape == (3, 4) and np.abs(x.asnumpy()).max() <= 1.0
    for stype in ("csr", "row_sparse"):
        with pytest.raises(MXNetError, match="A.10"):
            tu.rand_ndarray((3, 4), stype)


def test_check_numeric_gradient_passes_and_catches_a_wrong_gradient():
    tu = mx.test_utils
    r = np.random.RandomState(0)
    x, w = r.randn(3, 4), r.randn(5, 4)
    tu.check_numeric_gradient(
        lambda a, b: mx.nd.FullyConnected(a, b, num_hidden=5,
                                          no_bias=True).tanh(),
        [x, w])

    class Wrong(autograd.Function):
        def forward(self, a):
            return a * a

        def backward(self, dy):
            return dy * 3.0

    with pytest.raises(AssertionError, match="autograd"):
        tu.check_numeric_gradient(lambda a: Wrong()(a), [x])


def test_check_consistency_over_contexts():
    tu = mx.test_utils
    r = np.random.RandomState(1)
    x, w = r.randn(4, 8).astype(np.float32), r.randn(3, 8).astype(np.float32)
    outs = tu.check_consistency(
        lambda a, b: mx.nd.FullyConnected(a.astype("bfloat16"), b,
                                          num_hidden=3, no_bias=True),
        [x, w], ctx_list=[mx.cpu(0), mx.cpu(1)])
    assert len(outs) == 2 and outs[0].dtype == np.float32
    assert len(tu.check_consistency(lambda a: a * 2, [x])) == \
        (2 if mx.num_gpus() else 1)


# -- monitor ------------------------------------------------------------------

def _monitored(m, pattern, sort=False):
    mon = m.monitor.Monitor(1, pattern=pattern, sort=sort)
    mon.install()
    r = np.random.RandomState(3)
    x = m.nd.array(r.randn(4, 6).astype(np.float32))
    w = m.nd.array(r.randn(5, 6).astype(np.float32))
    rows = []
    try:
        for _ in range(2):
            mon.tic()
            y = m.nd.FullyConnected(x, w, num_hidden=5, no_bias=True)
            m.nd.topk(y, k=2, ret_typ="both")
            rows.append(mon.toc())
    finally:
        mon.uninstall()
    mon.activated = True            # an uninstalled monitor sees nothing
    m.nd.FullyConnected(x, w, num_hidden=5, no_bias=True)
    rows.append(mon.toc())
    return rows


@pytest.mark.parametrize("pattern,sort", [(".*", True),
                                          (".*FullyConnected.*", False),
                                          ("topk.*", True)])
def test_monitor_stats_match_the_reference(pattern, sort):
    got, want = _monitored(mx, pattern, sort), _monitored(jmx, pattern, sort)
    assert [[r[:2] for r in b] for b in got] == \
        [[r[:2] for r in b] for b in want]
    assert got[-1] == [] and got[0]
    for gb, wb in zip(got, want):
        for g, w in zip(gb, wb):
            assert abs(g[2] - w[2]) <= 1e-6 * max(abs(w[2]), 1.0), g[1]


def test_monitor_interval_custom_stat_and_hybridized_blocks():
    mon = mx.monitor.Monitor(2, stat_func=lambda t: t.max(),
                             pattern="relu")
    got = []
    for _ in range(4):
        mon.tic()
        mx.nd.relu(mx.nd.array([-1.0, 3.0]))
        got.append(mon.toc())
    mon.uninstall()
    assert [len(g) for g in got] == [1, 0, 1, 0]
    assert got[0][0][1:] == ("relu", 3.0)
    net = gluon.nn.HybridSequential()
    net.add(gluon.nn.Dense(2, in_units=3, activation="relu"))
    net.initialize()
    net.hybridize()
    mon = mx.monitor.Monitor(1, pattern=".*FullyConnected.*").install()
    mon.tic()
    net(mx.nd.ones((1, 3)))
    assert mon.toc() == []          # not observable, as in the reference
    mon.uninstall()
    assert not registry._monitor_hooks


# -- callback and model -------------------------------------------------------

def test_speedometer_logs_samples_per_second(caplog, monkeypatch):
    clock = iter([100.0, 102.0, 103.0])

    class _Clock:
        @staticmethod
        def time():
            return next(clock)

    monkeypatch.setattr(mx.callback, "time", _Clock)
    metric = mx.metric.Accuracy()
    metric.update([mx.nd.array([1, 0])], [mx.nd.array([[0.1, 0.9],
                                                        [0.8, 0.2]])])
    sp = mx.callback.Speedometer(batch_size=16, frequent=2)
    with caplog.at_level(logging.INFO):
        for nbatch in (0, 1, 2):
            sp(mx.model.BatchEndParam(epoch=1, nbatch=nbatch,
                                      eval_metric=metric, locals=None))
    msg = [r.getMessage() for r in caplog.records if "Speed" in r.getMessage()]
    assert msg == ["Epoch[1] Batch [2]\tSpeed: 16.00 samples/sec\t"
                   "accuracy=1.000000"]
    assert metric.get_name_value()[0][1] != 1.0 or \
        metric.num_inst == 0                        # auto_reset


def test_log_train_metric_progress_bar_and_do_checkpoint(caplog, tmp_path):
    metric = mx.metric.Accuracy()
    metric.update([mx.nd.array([1])], [mx.nd.array([[0.2, 0.8]])])
    with caplog.at_level(logging.INFO):
        mx.callback.log_train_metric(2)(mx.model.BatchEndParam(
            0, 4, metric, None))
        mx.callback.ProgressBar(total=4, length=8)(
            mx.model.BatchEndParam(0, 2, None, None))
    text = "\n".join(r.getMessage() for r in caplog.records)
    assert "Iter[0] Batch[4] Train-accuracy=1.000000" in text
    assert "[====----] 50%" in text
    prefix = str(tmp_path / "m")
    cb = mx.callback.do_checkpoint(prefix, period=2)
    arg = {"w": mx.nd.array([1.0, 2.0])}
    cb(0, None, arg, {})
    assert not os.path.exists(prefix + "-0001.params")
    cb(1, None, arg, {"s": mx.nd.array([3.0])})
    a, x = mx.model.load_params(prefix, 2)
    assert a["w"].asnumpy().tolist() == [1.0, 2.0]
    assert x["s"].asnumpy().tolist() == [3.0]


@pytest.mark.parametrize("direction", ["port_to_reference",
                                       "reference_to_port"])
def test_params_files_cross_between_packages(tmp_path, direction):
    r = np.random.RandomState(0)
    arg = {"fc_weight": r.randn(3, 4).astype(np.float32),
           "fc_bias": r.randn(3).astype(np.float32)}
    aux = {"bn_moving_mean": r.randn(3).astype(np.float32)}
    src, dst = (mx, jmx) if direction == "port_to_reference" else (jmx, mx)
    prefix = str(tmp_path / "net")
    src.model.save_checkpoint(
        prefix, 7, None, {k: src.nd.array(v) for k, v in arg.items()},
        {k: src.nd.array(v) for k, v in aux.items()})
    got_arg, got_aux = dst.model.load_params(prefix, 7)
    assert sorted(got_arg) == sorted(arg) and sorted(got_aux) == sorted(aux)
    for want, got in ((arg, got_arg), (aux, got_aux)):
        for k, v in want.items():
            assert got[k].asnumpy().tobytes() == v.tobytes(), k


def test_model_symbol_half_raises_naming_the_roadmap():
    bep = mx.model.BatchEndParam(1, 2, None, None)
    assert (bep.epoch, bep.nbatch) == (1, 2)
    assert type(bep).__name__ == type(jmx.model.BatchEndParam(
        1, 2, None, None)).__name__
    for call in (lambda: mx.model.save_checkpoint("p", 1, object(), {}, {}),
                 lambda: mx.model.load_checkpoint("p", 1),
                 lambda: mx.model.FeedForward(None)):
        with pytest.raises(MXNetError, match="A.10"):
            call()


# -- CustomOp and library -----------------------------------------------------

def _register_straight_through(m, name):
    @m.operator.register(name)
    class _Prop(m.operator.CustomOpProp):
        """Sign forward, identity backward: autodiff would give zero."""

        def create_operator(self, ctx, shapes, dtypes):  # noqa: ARG002
            class Op(m.operator.CustomOp):
                def forward(self, is_train, req, in_data, out_data, aux):  # noqa: ARG002
                    self.assign(out_data[0], req[0], m.nd.sign(in_data[0]))

                def backward(self, req, out_grad, in_data, out_data,
                             in_grad, aux):  # noqa: ARG002
                    self.assign(in_grad[0], req[0], out_grad[0])
            return Op()


def test_custom_op_straight_through(restore_registries):
    got = {}
    for m in (jmx, mx):
        _register_straight_through(m, "torch_test_straight_through")
        x = m.nd.array(np.array([0.7, -0.2, 1.5], np.float32))
        x.attach_grad()
        with m.autograd.record():
            y = m.nd.Custom(x, op_type="torch_test_straight_through")
        y.backward(m.nd.array(np.array([1.0, 2.0, 3.0], np.float32)))
        got[m] = (y.asnumpy(), x.grad.asnumpy())
    assert got[mx][0].tolist() == [1.0, -1.0, 1.0]
    assert got[mx][1].tolist() == [1.0, 2.0, 3.0]
    for a, b in zip(got[mx], got[jmx]):
        assert a.tobytes() == b.tobytes()
    assert "torch_test_straight_through" in mx.operator.get_all_registered()


def test_custom_op_kwargs_are_strings_and_assign_honours_req(
        restore_registries):
    seen = {}

    @mx.operator.register("torch_test_kwarg_echo")
    class P(mx.operator.CustomOpProp):
        def __init__(self, alpha="1"):
            super().__init__()
            seen["alpha"] = alpha

        def create_operator(self, ctx, shapes, dtypes):  # noqa: ARG002
            class Op(mx.operator.CustomOp):
                def forward(self, is_train, req, in_data, out_data, aux):  # noqa: ARG002
                    self.assign(out_data[0], req[0], in_data[0])
                    self.assign(out_data[0], "add", in_data[0])
                    self.assign(out_data[0], "null", in_data[0] * 100)
            return Op()

    out = mx.nd.Custom(mx.nd.ones((2,)), op_type="torch_test_kwarg_echo",
                       alpha=2.5)
    assert seen["alpha"] == "2.5"
    assert out.asnumpy().tolist() == [2.0, 2.0]
    with pytest.raises(MXNetError, match="already registered"):
        mx.operator.register("torch_test_kwarg_echo")(P)


def test_custom_op_errors(restore_registries):
    _register_straight_through(mx, "torch_test_st2")
    with pytest.raises(MXNetError, match="not registered"):
        mx.nd.Custom(mx.nd.ones((2,)), op_type="nope_never")
    with pytest.raises(MXNetError, match="expects 1 inputs"):
        mx.nd.Custom(mx.nd.ones((2,)), mx.nd.ones((2,)),
                     op_type="torch_test_st2")
    with pytest.raises(MXNetError, match="op_type"):
        mx.nd.Custom(mx.nd.ones((2,)))


def test_custom_op_backward_against_numeric_gradient(restore_registries):
    """A custom op with a true backward (2 x w for x^2 w) passes
    ``check_numeric_gradient`` in float64."""
    @mx.operator.register("torch_test_square_scale")
    class P(mx.operator.CustomOpProp):
        def list_arguments(self):
            return ["data", "scale"]

        def create_operator(self, ctx, shapes, dtypes):  # noqa: ARG002
            class Op(mx.operator.CustomOp):
                def forward(self, is_train, req, in_data, out_data, aux):  # noqa: ARG002
                    x, s = in_data
                    self.assign(out_data[0], req[0], x * x * s)

                def backward(self, req, out_grad, in_data, out_data,
                             in_grad, aux):  # noqa: ARG002
                    x, s = in_data
                    self.assign(in_grad[0], req[0], 2 * x * s * out_grad[0])
                    self.assign(in_grad[1], req[1], x * x * out_grad[0])
            return Op()

    r = np.random.RandomState(2)
    mx.test_utils.check_numeric_gradient(
        lambda x, s: mx.nd.Custom(x, s, op_type="torch_test_square_scale"),
        [r.randn(3, 2), r.randn(3, 2)], rtol=1e-4, atol=1e-6)


def _write(path, text):
    with open(path, "w") as f:
        f.write(text)
    return str(path)


def test_library_load_python_oplib(tmp_path, restore_registries):
    lib = _write(tmp_path / "myops.py",
                 "from mxnet_tpu_torch.ops.registry import register\n"
                 "@register('torch_my_plus_two')\n"
                 "def _my_plus_two(x):\n"
                 "    return x + 2\n")
    new = mx.library.load(lib, verbose=False)
    assert new == ["torch_my_plus_two"]
    out = mx.nd.torch_my_plus_two(mx.nd.ones((2, 2)))
    np.testing.assert_allclose(out.asnumpy(), np.full((2, 2), 3.0))
    assert lib in mx.library.loaded_libraries()
    fake = tmp_path / "lib.so"
    fake.write_bytes(b"")
    with pytest.raises(MXNetError, match="PYTHON") as got:
        mx.library.load(str(fake))
    with pytest.raises(jmx.MXNetError) as want:
        jmx.library.load(str(fake))
    assert str(got.value) == str(want.value)
    with pytest.raises(MXNetError, match="registered no"):
        mx.library.load(_write(tmp_path / "empty.py", "x = 1\n"))
    with pytest.raises(MXNetError, match="not found"):
        mx.library.load(str(tmp_path / "absent.py"))


def test_library_load_idempotent_and_rolls_back(tmp_path,
                                                restore_registries):
    lib = _write(tmp_path / "relib.py",
                 "from mxnet_tpu_torch.ops.registry import register\n"
                 "@register('torch_relib_op')\n"
                 "def _f(x):\n    return x * 3\n")
    first = mx.library.load(lib, verbose=False)
    assert mx.library.load(lib, verbose=False) == first
    broken = tmp_path / "broken.py"
    _write(broken, "from mxnet_tpu_torch.ops.registry import register\n"
                   "@register('torch_broken_ok')\n"
                   "def _a(x):\n    return x\n"
                   "raise RuntimeError('boom')\n")
    with pytest.raises(RuntimeError, match="boom"):
        mx.library.load(str(broken), verbose=False)
    assert "torch_broken_ok" not in registry.list_ops()
    _write(broken, "from mxnet_tpu_torch.ops.registry import register\n"
                   "@register('torch_broken_ok')\n"
                   "def _a(x):\n    return x + 1\n")
    assert "torch_broken_ok" in mx.library.load(str(broken), verbose=False)
    custom = _write(tmp_path / "custom_lib.py",
                    "import mxnet_tpu_torch as mx\n"
                    "@mx.operator.register('torch_lib_custom')\n"
                    "class P(mx.operator.CustomOpProp):\n"
                    "    pass\n")
    assert mx.library.load(custom, verbose=False) == ["torch_lib_custom"]
