"""The port's fused optimizer update (``optimizer_fusion``: one
``update_multi`` over all parameters) on the CPU: bitwise equal to the
per-key path (``MXNET_OPTIMIZER_FUSED=0``) for Adam and SGD, float32 and
bfloat16, multi-precision, ``lr_mult``/``wd_mult``, mixed dtypes and two
replicas; the fallbacks (``update_on_kvstore``, a loss-scale overflow
skip, other optimizers and subclasses); ``exec_builds()`` flat after the
first step; a bucket bound of 0 (fusion off) and a positive one (bounds
nothing); ``traced_update`` and ``TrainStep``'s update equal to the
per-key update; and the weights against the reference's fused path after
six steps, within 1e-5 of each tensor's max |ref| (torch's and XLA's CPU
matmuls differ in the last bits, the update does not add to that).
"""

import threading

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import optimizer_fusion as jfus
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import autograd, gluon, optimizer_fusion as fus
from mxnet_tpu_torch import parallel

TOL = 1e-5


@pytest.fixture(autouse=True)
def _defaults(monkeypatch):
    """Every test starts from the default knobs and no plans, on the CPU."""
    monkeypatch.delenv("MXNET_OPTIMIZER_FUSED", raising=False)
    monkeypatch.delenv("MXNET_OPTIMIZER_BUCKET_MB", raising=False)
    fus.reset()
    jfus.reset()
    with mx.cpu():
        yield
    fus.reset()
    jfus.reset()


def _fresh(build):
    """Build in a new thread: Gluon's name counters start anew, so both
    packages name the layers alike."""
    out = {}
    t = threading.Thread(target=lambda: out.setdefault("v", build()))
    t.start()
    t.join(timeout=120)
    assert not t.is_alive()
    return out["v"]


def _mlp(m, n_layers=4, units=16, dtype=None, ctx=None, half_layer=False):
    def build():
        net = m.gluon.nn.HybridSequential(prefix="net_")
        with net.name_scope():
            for _ in range(n_layers):
                net.add(m.gluon.nn.Dense(units, activation="relu",
                                         in_units=units))
        return net
    net = _fresh(build)
    net.initialize(m.init.Zero(), ctx=ctx)
    r = np.random.RandomState(7)
    for p in net.collect_params().values():
        p.set_data(m.nd.array(r.randn(*p.shape).astype(np.float32) * 0.3))
    if dtype is not None:
        net.cast(dtype)
    if half_layer:
        net[1].cast("bfloat16")
    return net


def _params_np(net):
    return {k: [d.astype("float32").asnumpy() for d in p.list_data()]
            for k, p in net.collect_params().items()}


def _train(m, fused, opt_name, opt_kw, monkeypatch, steps=6, dtype=None,
           lr_mult=False, n_ctx=1, half_layer=False):
    monkeypatch.setenv("MXNET_OPTIMIZER_FUSED", "1" if fused else "0")
    ctxs = [m.cpu(i) for i in range(n_ctx)]
    net = _mlp(m, dtype=dtype, ctx=ctxs, half_layer=half_layer)
    kw = dict(opt_kw)
    if not fused and m is jmx:
        kw["aggregate_num"] = 1     # the reference's per-param path
    tr = m.gluon.Trainer(net.collect_params(), opt_name, kw,
                         kvstore="local")
    if lr_mult:
        for k, p in net.collect_params().items():
            p.lr_mult = 0.5 if k.endswith("bias") else 1.5
            p.wd_mult = 0.0 if k.endswith("bias") else 2.0
    lf = m.gluon.loss.L2Loss()
    r = np.random.RandomState(3)
    x = r.randn(4 * n_ctx, 16).astype(np.float32)
    y = r.randn(4 * n_ctx, 16).astype(np.float32)
    xdt = dtype if dtype is not None else "float32"
    for _ in range(steps):
        xs = m.gluon.utils.split_and_load(x, ctxs)
        ys = m.gluon.utils.split_and_load(y, ctxs)
        with m.autograd.record():
            losses = [lf(net(a.astype(xdt)), b.astype(xdt))
                      for a, b in zip(xs, ys)]
        m.autograd.backward(losses)
        tr.step(4 * n_ctx)
    return _params_np(net), tr


def _assert_bitwise(a, b):
    assert a.keys() == b.keys()
    for k in a:
        for x, y in zip(a[k], b[k]):
            assert x.tobytes() == y.tobytes(), k


CASES = [
    ("adam", {"learning_rate": 1e-3, "wd": 0.01}, None, False),
    ("sgd", {"learning_rate": 0.05, "momentum": 0.9, "wd": 0.01}, None,
     False),
    ("sgd", {"learning_rate": 0.05}, None, False),
    ("sgd", {"learning_rate": 0.05, "clip_gradient": 0.1}, None, False),
    ("adam", {"learning_rate": 1e-3, "wd": 0.01}, None, True),
    ("sgd", {"learning_rate": 0.05, "momentum": 0.9, "wd": 0.01}, None,
     True),
    ("adam", {"learning_rate": 1e-2, "wd": 0.01,
              "multi_precision": True}, "bfloat16", False),
    ("adam", {"learning_rate": 1e-2}, "bfloat16", False),
    ("sgd", {"learning_rate": 0.05, "momentum": 0.9,
             "multi_precision": True}, "bfloat16", False),
    ("sgd", {"learning_rate": 0.05, "multi_precision": True}, "bfloat16",
     True),
]


@pytest.mark.parametrize("opt_name,kw,dtype,lr_mult", CASES)
def test_fused_bit_identical_to_per_param(opt_name, kw, dtype, lr_mult,
                                          monkeypatch):
    a, _ = _train(mx, False, opt_name, kw, monkeypatch, dtype=dtype,
                  lr_mult=lr_mult)
    b, tr = _train(mx, True, opt_name, kw, monkeypatch, dtype=dtype,
                   lr_mult=lr_mult)
    assert tr._fused_kind() == opt_name
    _assert_bitwise(a, b)


def test_mixed_dtypes_bit_identically(monkeypatch):
    """A bfloat16 layer among float32 ones (masters for the half one
    only): one update over both dtypes, the same bits as key by key."""
    kw = {"learning_rate": 1e-2, "wd": 0.01, "multi_precision": True}
    a, _ = _train(mx, False, "adam", kw, monkeypatch, half_layer=True)
    b, tr = _train(mx, True, "adam", kw, monkeypatch, half_layer=True)
    _assert_bitwise(a, b)
    assert sorted({str(p.data()._data.dtype) for p in tr._params}) == \
        ["torch.bfloat16", "torch.float32"]


def test_two_replicas_bit_identical(monkeypatch):
    """Two host contexts through the local store: every replica's weights
    equal the per-parameter path's, and the replicas agree."""
    kw = {"learning_rate": 1e-3, "wd": 0.01}
    a, _ = _train(mx, False, "adam", kw, monkeypatch, steps=4, n_ctx=2)
    b, _ = _train(mx, True, "adam", kw, monkeypatch, steps=4, n_ctx=2)
    _assert_bitwise(a, b)
    for k, (r0, r1) in b.items():
        assert r0.tobytes() == r1.tobytes(), k


@pytest.mark.parametrize("opt_name,kw", [
    ("adam", {"learning_rate": 1e-3, "wd": 0.01}),
    ("sgd", {"learning_rate": 0.05, "momentum": 0.9, "wd": 0.01})])
def test_weights_match_the_references_fused_path(opt_name, kw,
                                                 monkeypatch):
    want, _ = _train(jmx, True, opt_name, kw, monkeypatch, lr_mult=True)
    got, _ = _train(mx, True, opt_name, kw, monkeypatch, lr_mult=True)
    for k in want:
        w, g = want[k][0], got[k][0]
        assert np.abs(g - w).max() <= TOL * np.abs(w).max(), k


def _one_step(net, tr):
    lf = gluon.loss.L2Loss()
    r = np.random.RandomState(3)
    x = mx.nd.array(r.randn(4, 16).astype(np.float32))
    y = mx.nd.array(r.randn(4, 16).astype(np.float32))
    with autograd.record():
        loss = lf(net(x), y)
    loss.backward()
    tr.step(4)


def test_loss_scale_overflow_skips_the_fused_update(monkeypatch):
    """An overflowing float16 step updates nothing and halves the scale."""
    from mxnet_tpu_torch import amp
    monkeypatch.setenv("MXNET_OPTIMIZER_FUSED", "1")
    amp.init(target_dtype="float16")
    try:
        net = _mlp(mx, n_layers=1, units=3)
        tr = gluon.Trainer(net.collect_params(), "adam",
                           {"learning_rate": 0.5})
        amp.init_trainer(tr)
        with autograd.record():
            loss = net(mx.nd.ones((2, 3))).sum()
        loss.backward()
        w = list(net.collect_params().values())[0]
        w.list_grad()[0][:] = float("inf")
        before = w.data().asnumpy().copy()
        scale0 = tr._amp_loss_scaler.loss_scale
        tr.step(1)
        assert np.array_equal(w.data().asnumpy(), before)
        assert tr._amp_loss_scaler.loss_scale == scale0 / 2
    finally:
        amp.off()


def test_update_on_kvstore_keeps_the_per_key_path(monkeypatch):
    monkeypatch.setenv("MXNET_OPTIMIZER_FUSED", "1")
    net = _mlp(mx, n_layers=2)
    tr = gluon.Trainer(net.collect_params(), "sgd", {"learning_rate": 0.05},
                       kvstore="local", update_on_kvstore=True)
    before = _params_np(net)
    builds = fus.exec_builds()
    _one_step(net, tr)
    assert tr._fused_kind() is None
    assert fus.exec_builds() == builds
    after = _params_np(net)
    assert any(not np.array_equal(before[k][0], after[k][0])
               for k in before)


def test_only_exact_adam_and_sgd_are_fused(monkeypatch):
    monkeypatch.setenv("MXNET_OPTIMIZER_FUSED", "1")
    assert fus.supported_kind(mx.optimizer.Adam()) == "adam"
    assert fus.supported_kind(mx.optimizer.SGD()) == "sgd"
    for o in (mx.optimizer.AdamW(), mx.optimizer.LARS(), mx.optimizer.LAMB(),
              mx.optimizer.NAG()):
        assert fus.supported_kind(o) is None

    class MySGD(mx.optimizer.SGD):
        pass

    net = _mlp(mx, n_layers=2)
    for o in ("lamb", MySGD(learning_rate=0.05, momentum=0.9)):
        tr = gluon.Trainer(net.collect_params(), o)
        assert tr._fused_kind() is None
        before = _params_np(net)
        _one_step(net, tr)           # the update over all parameters
        after = _params_np(net)
        assert any(not np.array_equal(before[k][0], after[k][0])
                   for k in before)
    with pytest.raises(RuntimeError, match="does not support"):
        fus.fused_update(mx.optimizer.LAMB(), [0], [torch.zeros(2)],
                         [torch.zeros(2)], [None])


def test_exec_builds_stay_flat_after_the_first_step(monkeypatch):
    net = _mlp(mx)
    tr = gluon.Trainer(net.collect_params(), "adam",
                       {"learning_rate": 1e-3})
    b0 = fus.exec_builds()
    _one_step(net, tr)
    assert fus.exec_builds() == b0 + 1
    for _ in range(3):
        _one_step(net, tr)
    assert fus.exec_builds() == b0 + 1


def test_bucket_mb_zero_disables_fusion(monkeypatch):
    monkeypatch.setenv("MXNET_OPTIMIZER_BUCKET_MB", "0")
    assert not fus.fusion_active(mx.optimizer.SGD())
    assert fus.plan_trainstep(mx.optimizer.SGD(), [torch.zeros(2)]) is None
    net = _mlp(mx, n_layers=2)
    tr = gluon.Trainer(net.collect_params(), "sgd", {"learning_rate": 0.1})
    assert tr._fused_kind() is None
    b0 = fus.exec_builds()
    _one_step(net, tr)
    assert fus.exec_builds() == b0


def test_positive_bucket_mb_bounds_nothing(monkeypatch):
    """A bound smaller than any parameter still fuses all of them in one
    update, with the bits of the per-key path."""
    monkeypatch.setenv("MXNET_OPTIMIZER_BUCKET_MB", "0.0001")
    kw = {"learning_rate": 1e-3, "wd": 0.01}
    a, _ = _train(mx, False, "adam", kw, monkeypatch)
    b0 = fus.exec_builds()
    b, tr = _train(mx, True, "adam", kw, monkeypatch)
    assert tr._fused_kind() == "adam"
    assert fus.exec_builds() == b0 + 1
    _assert_bitwise(a, b)


def test_flat_handoff_by_a_direct_call(monkeypatch):
    """``fused_update_flat`` on one flat gradient buffer gives the bits of
    ``fused_update`` on the same gradients per parameter (the local store
    hands over no flat buffer: ``pushpull_flat`` is None)."""
    monkeypatch.setenv("MXNET_OPTIMIZER_FUSED", "1")
    r = np.random.RandomState(0)
    shapes = [(4, 3), (5,), (2, 2, 2)]
    grads = [torch.from_numpy(r.randn(*s).astype(np.float32))
             for s in shapes]
    w0 = [torch.from_numpy(r.randn(*s).astype(np.float32)) for s in shapes]
    out = []
    for flat in (False, True):
        o = mx.optimizer.Adam(learning_rate=0.01, wd=0.01)
        ws = [w.clone() for w in w0]
        sts = [o.create_state(i, w) for i, w in enumerate(ws)]
        for _ in range(2):
            if flat:
                fus.fused_update_flat(o, [0, 1, 2], ws, sts, shapes,
                                      [g.numel() for g in grads],
                                      torch.cat([g.reshape(-1)
                                                 for g in grads]))
            else:
                fus.fused_update(o, [0, 1, 2], ws, grads, sts)
        out.append(ws)
    for a, b in zip(*out):
        assert torch.equal(a, b)
    assert mx.kv.create("local").pushpull_flat([0], [], []) is None


def test_save_load_states_resume_bit_identically(monkeypatch, tmp_path):
    """Three fused steps, states saved, three more, against a trainer that
    loads the states into the weights after three and runs three."""
    monkeypatch.setenv("MXNET_OPTIMIZER_FUSED", "1")
    kw = {"learning_rate": 1e-2, "wd": 0.01}
    net = _mlp(mx)
    tr = gluon.Trainer(net.collect_params(), "adam", dict(kw))
    for _ in range(3):
        _one_step(net, tr)
    tr.save_states(str(tmp_path / "s"))
    mid = {k: p.data().asnumpy() for k, p in net.collect_params().items()}
    for _ in range(3):
        _one_step(net, tr)
    want = _params_np(net)
    net2 = _mlp(mx)
    for k, p in net2.collect_params().items():
        p.set_data(mx.nd.array(mid[k]))
    tr2 = gluon.Trainer(net2.collect_params(), "adam", dict(kw))
    tr2.load_states(str(tmp_path / "s"))
    for _ in range(3):
        _one_step(net2, tr2)
    _assert_bitwise(want, _params_np(net2))


@pytest.mark.parametrize("opt_name,kw", [
    ("adam", {"learning_rate": 1e-2, "wd": 0.01, "multi_precision": True}),
    ("sgd", {"learning_rate": 0.05, "momentum": 0.9, "wd": 0.01})])
def test_traced_update_equals_the_per_key_update(opt_name, kw):
    """``plan_trainstep`` covers every tensor; ``traced_update`` over it
    gives the bits of one update a key, float32 and bfloat16 tensors."""
    r = np.random.RandomState(5)
    shapes = [(4, 3), (5,), (2, 2, 2)]
    w0 = [torch.from_numpy(r.randn(*s).astype(np.float32)) for s in shapes]
    w0[1] = w0[1].to(torch.bfloat16)
    grads = [[torch.from_numpy(r.randn(*s).astype(np.float32)).to(w.dtype)
              for s, w in zip(shapes, w0)] for _ in range(3)]
    out = []
    for traced in (True, False):
        o = mx.optimizer.create(opt_name, **kw)
        ws = [w.clone() for w in w0]
        sts = [o.create_state_multi_precision(i, w)
               for i, w in enumerate(ws)]
        kind, plan = fus.plan_trainstep(o, ws)
        assert kind == opt_name and plan == [0, 1, 2]
        for g in grads:
            if traced:
                fus.traced_update(o, kind, plan, ws, sts, g)
            else:
                for i in plan:
                    o.update_multi([i], [ws[i]], [g[i]], [sts[i]])
        out.append(ws)
    for a, b in zip(*out):
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("n_micro", [1, 2])
def test_trainstep_update_equals_the_per_key_update(monkeypatch, n_micro):
    """``TrainStep``'s one update over all parameters gives the losses and
    weights of the same steps updated key by key."""
    r = np.random.RandomState(3)
    x = torch.from_numpy(r.randn(4, 16).astype(np.float32))
    y = torch.from_numpy(r.randn(4, 16).astype(np.float32))
    runs = []
    for per_key in (False, True):
        net = _mlp(mx)
        step = parallel.TrainStep(net, gluon.loss.L2Loss(), "adam",
                                  {"learning_rate": 1e-2, "wd": 0.01},
                                  n_micro=n_micro)
        if per_key:
            multi = step.optimizer.update_multi

            def one_by_one(indices, weights, grads, states, _m=multi):
                for a in zip(indices, weights, grads, states):
                    _m(*([v] for v in a))
            monkeypatch.setattr(step.optimizer, "update_multi", one_by_one)
        losses = step.run(x, y, steps=4)
        runs.append((losses, _params_np(net)))
    assert torch.equal(runs[0][0], runs[1][0])
    _assert_bitwise(runs[0][1], runs[1][1])
