"""The port's ``amp`` held against the JAX package's on the CPU: the op
lists, the dtype each op returns under ``amp.init``, the dynamic loss
scaler's sequence, the skipped update of an overflowing step, ``off()``
restoring dispatch (and TF32), and ``convert_model`` refusing.

Both packages keep amp as process state: every test turns it off again.
"""

import numpy as np
import pytest

import mxnet_tpu as mx
from mxnet_tpu import amp as jamp
import torch

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import amp as tamp, parallel
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.gluon import loss as tloss, nn as tnn
from mxnet_tpu_torch.ops import registry


@pytest.fixture(autouse=True)
def _cpu_and_amp_off():
    with tmx.cpu():
        try:
            yield
        finally:
            tamp.off()
            jamp.off()


def test_op_lists_are_the_references():
    assert tamp.TARGET_OPS == jamp.TARGET_OPS
    assert tamp.FP32_OPS == jamp.FP32_OPS
    assert tamp.WIDEST_OPS == jamp.WIDEST_OPS
    assert tamp.list_lp16_ops() == jamp.list_lp16_ops()
    assert tamp.list_fp32_ops() == jamp.list_fp32_ops()
    assert tamp.list_widest_ops() == jamp.list_widest_ops()


def _f(shape, seed):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


# (op, [input dtypes], attrs): one of each list and ops on none
_CASES = [
    ("dot", ["float32", "float32"], {}),
    ("FullyConnected", ["float32", "float32", "float32"],
     {"num_hidden": 4}),
    ("batch_dot", ["float32", "float32"], {}),
    ("softmax", ["bfloat16"], {}),
    ("log_softmax", ["float32"], {}),
    ("exp", ["bfloat16"], {}),
    ("mean", ["bfloat16"], {}),
    ("LayerNorm", ["bfloat16", "bfloat16", "bfloat16"], {}),
    ("broadcast_add", ["bfloat16", "float32"], {}),
    ("elemwise_mul", ["bfloat16", "bfloat16"], {}),
    ("concat", ["float32", "bfloat16"], {"dim": 0}),
    ("relu", ["float32"], {}),
    ("tanh", ["bfloat16"], {}),
]
_SHAPES = {"dot": [(3, 4), (4, 5)], "FullyConnected": [(3, 5), (4, 5), (4,)],
           "batch_dot": [(2, 3, 4), (2, 4, 5)],
           "LayerNorm": [(3, 4), (4,), (4,)]}


def _dtype_of(pkg, op, dtypes, attrs):
    shapes = _SHAPES.get(op, [(3, 4)] * len(dtypes))
    args = []
    for i, (s, d) in enumerate(zip(shapes, dtypes)):
        a = pkg.nd.array(_f(s, i))
        args.append(a.astype(d) if d != "float32" else a)
    out = getattr(pkg.nd, op)(*args, **attrs)
    return str(np.dtype(out.dtype)) if pkg is mx \
        else str(out._data.dtype).replace("torch.", "")


@pytest.mark.parametrize("op,dtypes,attrs", _CASES,
                         ids=[c[0] + "-" + "-".join(c[1]) for c in _CASES])
def test_op_output_dtypes_match_jax_under_amp(op, dtypes, attrs):
    plain = _dtype_of(tmx, op, dtypes, attrs)
    assert plain == _dtype_of(mx, op, dtypes, attrs)
    jamp.init("bfloat16")
    tamp.init("bfloat16")
    assert _dtype_of(tmx, op, dtypes, attrs) == \
        _dtype_of(mx, op, dtypes, attrs)
    tamp.off()
    assert _dtype_of(tmx, op, dtypes, attrs) == plain


def test_small_net_runs_in_the_target_dtype_and_trains_f32_weights():
    """A hybridized Dense -> LayerNorm -> Dense net under amp: the dense
    layers compute in bf16, the norm in f32, the weights stay f32 and
    take their gradients."""
    net = tnn.HybridSequential(prefix="amp_")
    with net.name_scope():
        net.add(tnn.Dense(8, in_units=4), tnn.LayerNorm(in_channels=8),
                tnn.Dense(3, in_units=8))
    net.initialize(tmx.init.Normal(0.1))
    net.hybridize()
    x = tmx.nd.array(_f((5, 4), 0))
    tamp.init("bfloat16")
    with tmx.autograd.record():
        out = net(x)
        loss = tloss.L2Loss()(out, tmx.nd.zeros((5, 3))).mean()
    loss.backward()
    assert out.dtype == torch.bfloat16
    for p in net.collect_params().values():
        assert p.data()._data.dtype == torch.float32
        assert np.isfinite(p.grad().asnumpy()).all()
        assert np.abs(p.grad().asnumpy()).max() > 0


def test_loss_scaler_sequence_matches_jax():
    pattern = [False, False, True, False, False, False, True, True, False,
               False, False, False]
    seqs = []
    for pkg, arr in ((jamp, mx.nd.array), (tamp, tmx.nd.array)):
        sc = pkg.LossScaler(init_scale=2.0 ** 10, scale_window=3,
                            target_dtype="float16")
        seq = []
        for bad in pattern:
            g = _f((4,), 0)
            if bad:
                g[2] = np.inf
            seq.append((sc.has_overflow([arr(g), arr(_f((3,), 1))]),
                        sc.loss_scale))
        seqs.append(seq)
    assert seqs[0] == seqs[1]
    assert tamp.LossScaler(target_dtype="bfloat16").loss_scale == 1.0


def test_an_overflowing_step_skips_the_update():
    net = tnn.Dense(3, in_units=4, prefix="ovf_")
    net.initialize(tmx.init.Normal(0.1))
    tamp.init("float16")
    tr = tmx.gluon.Trainer(net.collect_params(), "sgd",
                           {"learning_rate": 0.1})
    tamp.init_trainer(tr)
    assert tr._amp_loss_scaler.loss_scale == 2.0 ** 16
    # a scale this net's float16 gradients stay finite under
    tr._amp_loss_scaler.loss_scale = scale0 = 16.0
    before = net.weight.data().asnumpy().copy()
    x = tmx.nd.array(_f((2, 4), 0))
    with tmx.autograd.record():
        loss = net(x).sum()
        with tamp.scale_loss(loss, tr) as scaled:
            pass
    scaled.backward()
    net.weight.grad()[:] = float("inf")
    tr.step(2)
    np.testing.assert_array_equal(net.weight.data().asnumpy(), before)
    assert tr._amp_loss_scaler.loss_scale == scale0 / 2
    with tmx.autograd.record():
        loss = net(x).sum()
        with tamp.scale_loss(loss, tr) as scaled:
            pass
    scaled.backward()
    tr.step(2)
    assert not np.array_equal(net.weight.data().asnumpy(), before)


def test_off_restores_dispatch_and_tf32():
    tf32 = torch.backends.cuda.matmul.allow_tf32
    epoch = registry.dispatch_epoch()
    fast = registry.tensor_ops.relu
    tamp.init()
    assert registry.dispatch_epoch() == epoch + 1
    assert torch.backends.cuda.matmul.allow_tf32
    assert registry.tensor_ops.relu is not fast
    assert registry.tensor_ops.dot(torch.ones(2, 2), torch.ones(2, 2)) \
        .dtype == torch.bfloat16
    tamp.off()
    assert registry.dispatch_epoch() == epoch + 2
    assert torch.backends.cuda.matmul.allow_tf32 == tf32
    assert registry.tensor_ops.relu is registry.get("relu").fn
    assert registry.tensor_ops.dot(torch.ones(2, 2), torch.ones(2, 2)) \
        .dtype == torch.float32


def test_trainstep_drops_its_graphs_when_amp_toggles():
    net = tnn.Dense(3, in_units=4, prefix="ts_")
    net.initialize(tmx.init.Normal(0.1))
    st = parallel.TrainStep(net, lambda o, l: tloss.L2Loss()(o, l), "sgd")
    x, y = _f((2, 4), 0), _f((2, 3), 1)
    st(x, y)
    st._graphs["marker"] = None
    st(x, y)
    assert "marker" in st._graphs
    tamp.init()
    assert st(x, y).dtype == torch.float32
    assert "marker" not in st._graphs


def test_convert_hybrid_block_keeps_norm_parameters_f32():
    net = tnn.HybridSequential(prefix="cv_")
    with net.name_scope():
        net.add(tnn.Dense(8, in_units=4), tnn.BatchNorm(in_channels=8))
    net.initialize()
    tamp.convert_hybrid_block(net, "bfloat16")
    for k, p in net.collect_params().items():
        want = torch.float32 if any(m in k for m in (
            "gamma", "beta", "running_mean", "running_var")) \
            else torch.bfloat16
        assert p.data()._data.dtype == want, k


def test_convert_model_raises():
    with pytest.raises(MXNetError, match="symbol"):
        tamp.convert_model(None, {}, {})
    with pytest.raises(MXNetError, match="float16"):
        tamp.init("float32")
