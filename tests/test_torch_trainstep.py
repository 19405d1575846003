"""The rest of the port's ``TrainStep`` (microbatching, rematerialisation,
the device scalars its update reads) and ``gluon.utils.remat_call``, held
against the JAX package on the CPU, f32.

On the CPU the step runs its body eagerly each call, the same body that is
captured as a CUDA graph on the card; the capture itself is checked by
``chip_smoke.py`` on the card.

Tolerances: ``n_micro`` against the reference 2e-4 relative (the reference
test's bar: the slices' means sum in another order than the full batch's
mean); ``remat_call`` outputs and gradients 1e-5 (f32, other matmul
order); an update from device-tensor scalars against Python floats 1e-6
relative (one rounding moves: a division and a product where
``addcdiv`` fused them, and the bias correction computed in float64 on the
device instead of on the host); remat against no remat bit for bit (the
same ops recomputed).
"""

import numpy as np
import pytest

import jax
import mxnet_tpu as mx
from mxnet_tpu import autograd as jautograd, parallel as jparallel
from mxnet_tpu.gluon import loss as jloss, nn as jnn
from mxnet_tpu.gluon.utils import remat_call as jremat_call
import torch

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import optimizer as topt, parallel
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.gluon import loss as tloss, nn as tnn
from mxnet_tpu_torch.gluon.model_zoo import llama as tllama
from mxnet_tpu_torch.gluon.utils import remat_call
from mxnet_tpu_torch.ops.nn import softmax_cross_entropy

X = np.random.RandomState(0).randn(8, 8).astype(np.float32)
Y = np.random.RandomState(1).randn(8, 4).astype(np.float32)


@pytest.fixture(autouse=True)
def _on_cpu():
    with tmx.cpu():
        yield


def _weights(seed=5):
    r = np.random.RandomState(seed)
    return {"0_weight": r.randn(16, 8).astype(np.float32) * 0.3,
            "0_bias": r.randn(16).astype(np.float32) * 0.1,
            "1_weight": r.randn(4, 16).astype(np.float32) * 0.3,
            "1_bias": r.randn(4).astype(np.float32) * 0.1}


def _tiny(pkg_nn, pkg, weights, prefix):
    """Dense(16, tanh) -> Dense(4) on ``weights`` in either package."""
    net = pkg_nn.HybridSequential(prefix=prefix)
    with net.name_scope():
        net.add(pkg_nn.Dense(16, activation="tanh", in_units=8,
                             prefix="0_"))
        net.add(pkg_nn.Dense(4, in_units=16, prefix="1_"))
    net.initialize(pkg.initializer.Zero())
    for k, p in net.collect_params().items():
        p.set_data(pkg.nd.array(weights[k[len(prefix):]]))
    return net


def _jax_run(n_micro, steps=3):
    net = _tiny(jnn, mx, _weights(), "mlp_")
    mesh = jparallel.DeviceMesh(shape=(1,), devices=jax.devices()[:1])
    st = jparallel.TrainStep(net, lambda o, l: jloss.L2Loss()(o, l),
                             mx.optimizer.Adam(learning_rate=1e-2),
                             mesh=mesh, n_micro=n_micro, donate=False)
    losses = [float(st(mx.nd.array(X), mx.nd.array(Y)).asnumpy())
              for _ in range(steps)]
    return losses, {k: p.data().asnumpy()
                    for k, p in net.collect_params().items()}


def _port_run(n_micro, steps=3, remat=None, **kw):
    net = _tiny(tnn, tmx, _weights(), "mlp_")
    st = parallel.TrainStep(net, lambda o, l: tloss.L2Loss()(o, l),
                            topt.Adam(learning_rate=1e-2), n_micro=n_micro,
                            remat=remat, **kw)
    losses = [float(st(X, Y)) for _ in range(steps)]
    return losses, {k: p.data().asnumpy()
                    for k, p in net.collect_params().items()}


@pytest.mark.parametrize("n_micro", [2, 4])
def test_n_micro_matches_jax(n_micro):
    want_l, want_p = _jax_run(n_micro)
    got_l, got_p = _port_run(n_micro)
    np.testing.assert_allclose(got_l, want_l, rtol=2e-4)
    for k in want_p:
        np.testing.assert_allclose(got_p[k], want_p[k], rtol=2e-4,
                                   atol=1e-6, err_msg=k)


def test_n_micro_1_is_bit_identical_and_n_micro_is_deterministic():
    l_def, p_def = _port_run(None)
    l_one, p_one = _port_run(1)
    assert l_def == l_one
    for k in p_def:
        np.testing.assert_array_equal(p_def[k], p_one[k])
    for n in (2, 4):
        (l1, p1), (l2, p2) = _port_run(n), _port_run(n)
        assert l1 == l2
        for k in p1:
            np.testing.assert_array_equal(p1[k], p2[k])


def test_n_micro_errors():
    with pytest.raises(MXNetError, match="n_micro"):
        _port_run(0)
    net = _tiny(tnn, tmx, _weights(), "mlp_")
    st = parallel.TrainStep(net, lambda o, l: tloss.L2Loss()(o, l), "sgd",
                            n_micro=3)
    with pytest.raises(MXNetError, match="divisible"):
        st(X, Y)


def test_defaults_from_the_environment_and_donate(monkeypatch):
    net = _tiny(tnn, tmx, _weights(), "mlp_")
    monkeypatch.setenv("MXNET_MICROBATCH", "2")
    monkeypatch.setenv("MXNET_REMAT", "1")
    st = parallel.TrainStep(net, lambda o, l: tloss.L2Loss()(o, l), "sgd",
                            donate=True)
    assert st._n_micro == 2 and st._remat
    st = parallel.TrainStep(net, lambda o, l: tloss.L2Loss()(o, l), "sgd",
                            n_micro=1, remat=False, donate=False)
    assert st._n_micro == 1 and not st._remat
    # donate changes nothing: the same losses either way
    monkeypatch.delenv("MXNET_MICROBATCH")
    monkeypatch.delenv("MXNET_REMAT")
    assert _port_run(1, donate=True)[0] == _port_run(1, donate=False)[0]


def test_remat_trainstep_equals_plain():
    l_plain, p_plain = _port_run(2)
    l_remat, p_remat = _port_run(2, remat=True)
    assert l_plain == l_remat
    for k in p_plain:
        np.testing.assert_array_equal(p_plain[k], p_remat[k])


def _block_pair():
    w = _weights(7)
    return _tiny(jnn, mx, w, "blk_"), _tiny(tnn, tmx, w, "blk_")


@pytest.mark.parametrize("hybridize", [False, True])
def test_remat_call_matches_jax(hybridize):
    jnet, tnet = _block_pair()
    tnet.hybridize(hybridize)
    x = np.random.RandomState(3).randn(5, 8).astype(np.float32)
    with jautograd.record():
        jout = jremat_call(jnet, mx.nd.array(x))
        jl = (jout * jout).sum()
    jl.backward()
    with tmx.autograd.record():
        tout = remat_call(tnet, tmx.nd.array(x))
        tl = (tout * tout).sum()
    tl.backward()
    np.testing.assert_allclose(tout.asnumpy(), jout.asnumpy(), rtol=1e-5,
                               atol=1e-5)
    jp, tp = jnet.collect_params(), tnet.collect_params()
    for k in jp.keys():
        np.testing.assert_allclose(tp[k].grad().asnumpy(),
                                   jp[k].grad().asnumpy(), rtol=1e-5,
                                   atol=1e-5, err_msg=k)


def test_remat_call_outside_record_is_the_plain_call():
    _, tnet = _block_pair()
    x = tmx.nd.array(X)
    np.testing.assert_array_equal(remat_call(tnet, x).asnumpy(),
                                  tnet(x).asnumpy())


def test_remat_call_refuses_state_writes_and_several_outputs():
    bn = tnn.BatchNorm(in_channels=8)
    bn.initialize()
    with pytest.raises(MXNetError, match="writes its own state"):
        with tmx.autograd.record():
            remat_call(bn, tmx.nd.array(X))

    class Two(tnn.HybridBlock):
        def hybrid_forward(self, F, x):
            return x * 2, x * 3

    x = tmx.nd.array(X)
    x.attach_grad()
    with pytest.raises(MXNetError, match="single-output"):
        with tmx.autograd.record():
            remat_call(Two(), x)


class _Dropped(tnn.HybridBlock):
    def __init__(self, **kw):
        super().__init__(**kw)
        with self.name_scope():
            self.dense = tnn.Dense(16, in_units=8)
            self.drop = tnn.Dropout(0.1)

    def hybrid_forward(self, F, x):
        return self.drop(F.tanh(self.dense(x)))


@pytest.mark.parametrize("hybridize", [False, True])
def test_remat_with_dropout_gives_the_plain_gradients(hybridize):
    """From one generator state, remat with dropout 0.1 gives the plain
    run's gradients: the recompute reuses the forward's draws."""
    net = _Dropped(prefix="drop_")
    net.initialize(tmx.init.Normal(0.3))
    net.hybridize(hybridize)
    x = tmx.nd.array(np.random.RandomState(4).randn(32, 8)
                     .astype(np.float32))
    state = tmx.random.get_state()
    grads = []
    for use in (False, True):
        tmx.random.set_state(state)
        with tmx.autograd.record():
            y = remat_call(net, x) if use else net(x)
            loss = (y * y).sum()
        loss.backward()
        grads.append(net.dense.weight.grad().asnumpy().copy())
        assert (y.asnumpy() == 0).mean() > 0.05      # dropout did drop
    np.testing.assert_array_equal(grads[0], grads[1])
    # and with another state the masks differ
    with tmx.autograd.record():
        loss = (remat_call(net, x) ** 2).sum()
    loss.backward()
    assert not np.array_equal(net.dense.weight.grad().asnumpy(), grads[0])


def _llama_loss(out, labels):
    return softmax_cross_entropy(out.reshape(-1, out.shape[-1]).float(),
                                 labels.reshape(-1)) / labels.numel()


def _llama_run(remat, step_remat=False):
    tmx.random.seed(1)
    net = tllama.llama_model("llama_tiny", vocab_size=101, prefix="llm_",
                             remat=remat)
    net.initialize(tmx.init.Normal(0.05), ctx=tmx.cpu())
    r = np.random.RandomState(2)
    toks, labs = r.randint(0, 101, (3, 2, 16)), r.randint(0, 101, (3, 2, 16))
    st = parallel.TrainStep(net, _llama_loss, "adam",
                            {"learning_rate": 1e-2}, remat=step_remat)
    losses = st.run(toks, labs).numpy()
    return losses, {k: p.data().asnumpy()
                    for k, p in net.collect_params().items()}


@pytest.mark.parametrize("remat,step_remat", [(True, False), (False, True),
                                              (True, True)])
def test_llama_remat_equals_plain(remat, step_remat):
    want_l, want_p = _llama_run(False)
    got_l, got_p = _llama_run(remat, step_remat)
    np.testing.assert_array_equal(got_l, want_l)
    for k in want_p:
        np.testing.assert_array_equal(got_p[k], want_p[k])


class _AsStep(dict):
    def __init__(self, t):
        super().__init__()
        self._t = t

    def __getitem__(self, k):
        return self._t

    def get(self, k, d=None):
        return self._t


_OPTIMIZERS = {
    "sgd": dict(momentum=0.9), "nag": dict(momentum=0.9), "adam": {},
    "adamw": {}, "lars": dict(momentum=0.9), "rmsprop": dict(centered=True),
    "ftrl": {}, "signum": dict(momentum=0.9), "lamb": {}, "adagrad": {},
    "adadelta": {}}


@pytest.mark.parametrize("name", sorted(_OPTIMIZERS))
def test_device_scalars_match_python_floats(name):
    """Each optimizer's update with the rates, ``t`` and ``rescale_grad``
    as 0-d tensors (as ``TrainStep`` passes them) equals its update with
    Python floats, over 3 steps under a schedule and multipliers."""
    r = np.random.RandomState(0)
    w0 = [r.randn(5, 3).astype(np.float32), r.randn(4).astype(np.float32),
          r.randn(2, 2, 2).astype(np.float32)]
    grads = [[torch.tensor(r.randn(*w.shape).astype(np.float32))
              for w in w0] for _ in range(3)]
    out = []
    for tensors in (False, True):
        o = topt.create(name, learning_rate=0.1, wd=0.01, rescale_grad=0.5,
                        clip_gradient=2.0, lr_scheduler=tmx.lr_scheduler
                        .FactorScheduler(step=1, factor=0.7),
                        **_OPTIMIZERS[name])
        o.idx2name = {0: "w", 1: "bias", 2: "x"}
        o.set_lr_mult({2: 0.5})
        ws = [torch.tensor(w) for w in w0]
        states = [o.create_state_multi_precision(i, w)
                  for i, w in enumerate(ws)]
        for g in grads:
            if not tensors:
                o.update_multi([0, 1, 2], ws, g, states)
                continue
            for i in range(3):
                o._update_count(i)
            lr = torch.tensor([o._get_lr(i) for i in range(3)],
                              dtype=torch.float64)
            t = torch.tensor(float(o._index_update_count[0]),
                             dtype=torch.float64)
            saved = (o._update_count, o._index_update_count, o._get_lr,
                     o.rescale_grad)
            o._update_count = lambda i: None
            o._index_update_count = _AsStep(t)
            o._get_lr = lambda i, lr=lr: lr[i]
            o.rescale_grad = torch.tensor(0.5, dtype=torch.float64)
            try:
                o.update_multi([0, 1, 2], ws, g, states)
            finally:
                (o._update_count, o._index_update_count, o._get_lr,
                 o.rescale_grad) = saved
        out.append(ws)
    for a, b in zip(*out):
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1e-6,
                                   atol=1e-7)


def test_trainstep_follows_the_schedule_step_by_step():
    """TrainStep's device scalars carry the schedule: its steps equal the
    Trainer-style updates with Python floats."""
    sched = dict(learning_rate=0.05,
                 lr_scheduler=tmx.lr_scheduler.FactorScheduler(
                     step=1, factor=0.5))
    net = _tiny(tnn, tmx, _weights(), "mlp_")
    st = parallel.TrainStep(net, lambda o, l: tloss.L2Loss()(o, l),
                            topt.SGD(momentum=0.9, **sched))
    ref = _tiny(tnn, tmx, _weights(), "mlp_")
    o = topt.SGD(momentum=0.9, learning_rate=0.05,
                 lr_scheduler=tmx.lr_scheduler.FactorScheduler(
                     step=1, factor=0.5))
    params = list(ref.collect_params().values())
    states = [o.create_state_multi_precision(i, p.data()._data)
              for i, p in enumerate(params)]
    for _ in range(3):
        st(X, Y)
        ts = [p.data()._data for p in params]
        for t in ts:
            t.grad = None
        loss = tloss.L2Loss()(ref(torch.tensor(X)), torch.tensor(Y)).mean()
        loss.backward()
        o.update_multi(list(range(len(ts))), ts, [t.grad for t in ts],
                       states)
    for k, p in net.collect_params().items():
        np.testing.assert_allclose(p.data().asnumpy(),
                                   ref.collect_params()[k].data().asnumpy(),
                                   rtol=1e-6, atol=1e-7, err_msg=k)
    assert st.optimizer.num_update == o.num_update == 3


def test_trainstep_follows_lr_mult_changes():
    """A multiplier set between steps regroups the device rates: the
    steps equal updates with Python floats under the same multipliers."""
    net = _tiny(tnn, tmx, _weights(), "mlp_")
    ref = _tiny(tnn, tmx, _weights(), "mlp_")
    st = parallel.TrainStep(net, lambda o, l: tloss.L2Loss()(o, l),
                            topt.Adam(learning_rate=0.01))
    o = topt.Adam(learning_rate=0.01)
    params = list(ref.collect_params().values())
    o.param_dict = dict(enumerate(params))      # lr_mult by Parameter
    states = [o.create_state_multi_precision(i, p.data()._data)
              for i, p in enumerate(params)]
    for k in range(3):
        if k == 1:
            for block in (net, ref):
                block.collect_params()["mlp_0_weight"].lr_mult = 0.25
        st(X, Y)
        ts = [p.data()._data for p in params]
        for t in ts:
            t.grad = None
        tloss.L2Loss()(ref(torch.tensor(X)), torch.tensor(Y)).mean() \
            .backward()
        o.update_multi(list(range(len(ts))), ts, [t.grad for t in ts],
                       states)
    assert len(st._leaders) == 2
    for k, p in net.collect_params().items():
        np.testing.assert_allclose(p.data().asnumpy(),
                                   ref.collect_params()[k].data().asnumpy(),
                                   rtol=1e-6, atol=1e-7, err_msg=k)


def test_run_returns_distinct_per_step_losses():
    net = _tiny(tnn, tmx, _weights(), "mlp_")
    st = parallel.TrainStep(net, lambda o, l: tloss.L2Loss()(o, l), "sgd",
                            {"learning_rate": 0.1})
    losses = st.run(X, Y, steps=4).numpy()
    assert losses.shape == (4,) and len(set(losses.tolist())) == 4
    assert np.all(np.diff(losses) < 0)
    stacked = st.run(np.stack([X, X]), np.stack([Y, Y])).numpy()
    assert stacked.shape == (2,) and stacked[1] < stacked[0]


def test_replaced_parameters_are_read_again():
    """A cast replaces the parameters' tensors: the step re-reads them and
    makes the optimizer state of the new dtype."""
    net = _tiny(tnn, tmx, _weights(), "mlp_")
    st = parallel.TrainStep(net, lambda o, l: tloss.L2Loss()(o, l), "adam")
    st(X, Y)
    net.cast("float64")
    loss = st(X.astype(np.float64), Y.astype(np.float64))
    assert loss.dtype == torch.float64
    assert all(s.dtype == torch.float64 for st_ in st._states for s in st_)
