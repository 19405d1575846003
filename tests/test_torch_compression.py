"""2-bit gradient compression (``kvstore/compression.py``) held against the
JAX package's on the CPU: the packed codes and the residuals equal the
reference's byte for byte on the same gradient, the error feedback over
steps, the store's push path, and ``Trainer(compression_params=)`` with a
store object against the reference's Trainer.

Tolerances: codes, residuals and dequantized values bit for bit (both
packages do the same float32 add, compare and subtract); Trainer weights
after 3 steps within 1e-5 of each tensor's max |ref| (the forward and
backward are torch's and XLA's CPU matmuls; their gradients are then
quantized alike but for an element within an ulp of the threshold, which
these seeds do not produce).
"""

import threading

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu.kvstore.compression import GradientCompression as JGC
import mxnet_tpu_torch as mx
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.kvstore.compression import GradientCompression

TOL = 1e-5


@pytest.fixture(autouse=True)
def _on_cpu():
    with mx.cpu():
        yield


def _bytes(x):
    return np.asarray(x).tobytes()


@pytest.mark.parametrize("n", [1, 3, 4, 7, 1000, 4097])
@pytest.mark.parametrize("threshold", [0.5, 0.05])
def test_packed_codes_and_residuals_equal_the_references(n, threshold):
    """Three compressions of one key (the residual feeds back each time):
    the packed bytes and the residual after each equal the reference's."""
    r = np.random.RandomState(n)
    gc, jgc = GradientCompression({"threshold": threshold}), \
        JGC({"threshold": threshold})
    for step in range(3):
        g = (r.randn(n) * 0.3).astype(np.float32)
        p, shape, dtype = gc.compress("w", 0, torch.from_numpy(g))
        jp, jshape, jdtype = jgc.compress("w", 0, jmx.nd.array(g)._data)
        assert p.dtype == torch.uint8 and p.numel() == -(-n // 4)
        assert _bytes(p.numpy()) == _bytes(jp), step
        assert _bytes(gc._residuals[("w", 0)].numpy()) == \
            _bytes(jgc._residuals[("w", 0)]), step
        assert _bytes(gc.decompress(p, shape, dtype).numpy()) == \
            _bytes(jgc.decompress(jp, jshape, jdtype)), step


def test_code_layout_low_bits_first_zero_padded():
    """0 -> 0, +t -> 1, -t -> 2, four codes a byte, the first in the low
    bits; the last byte's missing codes are 0."""
    gc = GradientCompression({"type": "2bit", "threshold": 0.5})
    g = torch.tensor([0.7, -0.6, 0.1, -0.5, 0.5], dtype=torch.float32)
    p, shape, dtype = gc.compress("k", 0, g)
    assert p.tolist() == [1 | (2 << 2) | (0 << 4) | (2 << 6), 1]
    assert gc.decompress(p, shape, dtype).tolist() == \
        [0.5, -0.5, 0.0, -0.5, 0.5]


def test_error_feedback_accumulates():
    """The reference's case: 0.3 < t quantizes to 0 and keeps 0.3; the
    next 0.3 crosses t and leaves 0.1."""
    gc = GradientCompression({"type": "2bit", "threshold": 0.5})
    g = torch.full((4,), 0.3)
    p1, shape, dtype = gc.compress("k", 0, g)
    assert torch.all(gc.decompress(p1, shape, dtype) == 0.0)
    p2, _, _ = gc.compress("k", 0, g)
    assert torch.all(gc.decompress(p2, shape, dtype) == 0.5)
    np.testing.assert_allclose(gc._residuals[("k", 0)].numpy(), 0.1,
                               rtol=1e-6)


def test_residuals_per_key_and_slot():
    gc = GradientCompression({"threshold": 1.0})
    a = torch.tensor([0.4])
    gc.compress("k1", 0, a)
    gc.compress("k1", 1, a)
    gc.compress("k2", 0, a)
    assert set(gc._residuals) == {("k1", 0), ("k1", 1), ("k2", 0)}


def test_invalid_params_raise_the_references_messages():
    for bad, match in (({"type": "1bit"}, "only '2bit'"),
                       ({"type": "2bit", "threshold": 0}, "threshold"),
                       ({"type": "2bit", "bogus": 1}, "unknown")):
        with pytest.raises(MXNetError, match=match) as got:
            GradientCompression(bad)
        with pytest.raises(jmx.MXNetError) as want:
            JGC(bad)
        assert str(got.value) == str(want.value)


def test_store_push_applies_compression_as_the_reference():
    """The reference's push case, through both stores: 0.7 -> +t, then
    the residual 0.2 + 0.4 -> +t, then 0.1 + 0.1 -> 0."""
    shape = (3, 3)
    for m in (jmx, mx):
        kv = m.kv.create("local")
        kv.set_gradient_compression({"type": "2bit", "threshold": 0.5})
        kv.init(0, m.nd.zeros(shape))
        out = m.nd.zeros(shape)
        for value, want in ((0.7, 0.5), (0.4, 0.5), (0.1, 0.0)):
            kv.push(0, m.nd.array(np.full(shape, value, np.float32)))
            kv.pull(0, out)
            np.testing.assert_allclose(out.asnumpy(), want)


def test_replicas_quantize_apart_then_sum():
    """Two replicas on two host contexts, each with its own residual:
    +t + -t = 0, then +t + +t = 2t, in both packages."""
    for m in (jmx, mx):
        kv = m.kv.create("local")
        kv.set_gradient_compression({"threshold": 0.5})
        kv.init(1, m.nd.zeros((4,)))
        out = m.nd.zeros((4,))
        for vals, want in (((0.6, -0.6), 0.0), ((0.6, 0.7), 1.0)):
            kv.push(1, [m.nd.array(np.full((4,), v, np.float32),
                                   ctx=m.cpu(i)) for i, v in enumerate(vals)])
            kv.pull(1, out)
            np.testing.assert_allclose(out.asnumpy(), want)


def test_pushpull_list_compresses_key_by_key():
    """A compressed store reduces key by key: pushpull_list gives what
    push and pull of each key give."""
    r = np.random.RandomState(0)
    vals = [r.randn(5, 3).astype(np.float32) for _ in range(3)]
    got = []
    for fused in (True, False):
        kv = mx.kv.create("local")
        kv.set_gradient_compression({"threshold": 0.4})
        for k, v in enumerate(vals):
            kv.init(k, mx.nd.zeros(v.shape))
        arrs = [mx.nd.array(v) for v in vals]
        if fused:
            kv.pushpull_list(list(range(3)), arrs, arrs)
        else:
            for k, a in enumerate(arrs):
                kv.pushpull(k, a, out=a)
        got.append([a.asnumpy() for a in arrs])
    for a, b in zip(*got):
        assert a.tobytes() == b.tobytes()
    assert set(np.unique(np.concatenate([g.ravel() for g in got[0]]))) <= \
        {-0.4, 0.0, 0.4} | {np.float32(-0.4), np.float32(0.4)}


def _fresh(build):
    out = {}
    t = threading.Thread(target=lambda: out.setdefault("v", build()))
    t.start()
    t.join(timeout=120)
    assert not t.is_alive()
    return out["v"]


def _net(m, n_ctx, seed=1):
    def build():
        net = m.gluon.nn.HybridSequential(prefix="net_")
        with net.name_scope():
            net.add(m.gluon.nn.Dense(16, activation="relu", in_units=10),
                    m.gluon.nn.Dense(4, in_units=16))
        return net
    net = _fresh(build)
    net.initialize(m.init.Zero(), ctx=[m.cpu(i) for i in range(n_ctx)])
    r = np.random.RandomState(seed)
    for p in net.collect_params().values():
        p.set_data(m.nd.array(r.randn(*p.shape).astype(np.float32) * 0.3))
    return net


def _steps(m, net, trainer, n_ctx, steps, seed=2):
    r = np.random.RandomState(seed)
    lossf = m.gluon.loss.SoftmaxCrossEntropyLoss()
    ctxs = [m.cpu(i) for i in range(n_ctx)]
    for _ in range(steps):
        x = r.randn(8, 10).astype(np.float32)
        y = r.randint(0, 4, (8,)).astype(np.float32)
        xs = m.gluon.utils.split_and_load(x, ctxs)
        ys = m.gluon.utils.split_and_load(y, ctxs)
        with m.autograd.record():
            losses = [lossf(net(a), b) for a, b in zip(xs, ys)]
        for L in losses:
            L.backward()
        trainer.step(8)


@pytest.mark.parametrize("n_ctx", [1, 2])
@pytest.mark.parametrize("opt", ["sgd", "adam"])
def test_trainer_with_compression_matches_reference(n_ctx, opt):
    """``Trainer(kvstore=mx.kv.create("local"), compression_params=...)``:
    the store compresses every step's gradients, in both packages alike."""
    params = {"type": "2bit", "threshold": 0.05}
    got = {}
    for m in (jmx, mx):
        net = _net(m, n_ctx)
        tr = m.gluon.Trainer(net.collect_params(), opt,
                             {"learning_rate": 0.1},
                             kvstore=m.kv.create("local"),
                             compression_params=params)
        _steps(m, net, tr, n_ctx, 3)
        assert tr._kvstore._compression is not None
        assert tr._kvstore._compression.threshold == 0.05
        got[m] = {k: [d.asnumpy() for d in p.list_data()]
                  for k, p in net.collect_params().items()}
    for k, want in got[jmx].items():
        for d in got[mx][k]:
            err = np.abs(d - want[0]).max() / np.abs(want[0]).max()
            assert err <= TOL, k


def test_one_replica_string_store_has_no_store_and_no_compression():
    """As in the reference: ``kvstore="local"`` with one replica skips the
    store, so ``compression_params`` compress nothing, and the weights are
    the uncompressed trainer's."""
    got = []
    for params in ({"type": "2bit", "threshold": 0.5}, None):
        net = _net(mx, 1)
        tr = mx.gluon.Trainer(net.collect_params(), "sgd",
                              {"learning_rate": 0.1}, kvstore="local",
                              compression_params=params)
        _steps(mx, net, tr, 1, 2)
        assert tr._kvstore is None
        got.append([p.data().asnumpy() for p in
                    net.collect_params().values()])
    for a, b in zip(*got):
        assert a.tobytes() == b.tobytes()
