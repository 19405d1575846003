"""The rest of the port's vision zoo, the Block API (MXNet's forward hooks,
``apply``, ``summary``, ``infer_shape``) and the initializers, held
against the JAX package's on the CPU.

Every name of the reference's zoo table constructs in both packages with
the same parameter names and shapes.  One forward per family, on the
port's Xavier weights carried to the reference by name, agrees within
1e-4 of max |ref| at the reference's ``test_small_models_forward`` size
(2, 3, 32, 32) where the net accepts it: AlexNet takes 224 and Inception
V3 299 (their fixed pools), and DenseNet, whose final 7x7 pool needs 224,
runs a small configuration of the same class there.  The reference's nets
run hybridized (one compile instead of one per layer).
"""

import threading

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx

NET_TOL = 1e-4
ZOO = sorted(jmx.gluon.model_zoo.vision._models)


@pytest.fixture(autouse=True)
def _on_cpu():
    with mx.cpu():
        yield


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """torch's CPU convolutions on one thread, as the vision tests."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _fresh(build):
    out = {}
    t = threading.Thread(target=lambda: out.setdefault("v", build()))
    t.start()
    t.join(timeout=120)
    assert not t.is_alive() and "v" in out
    return out["v"]


def _pair(build):
    return _fresh(lambda: build(jmx)), _fresh(lambda: build(mx))


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def test_the_zoo_table_is_the_reference_table():
    assert sorted(mx.gluon.model_zoo.vision._models) == ZOO
    assert len(ZOO) == 34


@pytest.mark.parametrize("name", [n for n in ZOO
                                  if not n.startswith("resnet")])
def test_zoo_name_constructs_with_the_reference_parameters(name):
    """Names and declared shapes (0 where the reference defers a dim) of
    ``collect_params()``, and the structural names of
    ``save_parameters``."""
    jnet, tnet = _pair(lambda m: m.gluon.model_zoo.vision.get_model(
        name, classes=7))
    jp, tp = jnet.collect_params(), tnet.collect_params()
    assert list(tp.keys()) == list(jp.keys())
    assert [tp[k].shape for k in tp.keys()] == \
        [jp[k].shape for k in jp.keys()]
    assert list(tnet._collect_params_with_prefix()) == \
        list(jnet._collect_params_with_prefix())
    assert type(tnet).__name__ == type(jnet).__name__
    with pytest.raises(mx.MXNetError, match="pretrained"):
        mx.gluon.model_zoo.vision.get_model(name, pretrained=True)


FAMILIES = {
    "alexnet": (lambda m: m.gluon.model_zoo.vision.alexnet(classes=10), 224),
    "vgg11_bn": (lambda m: m.gluon.model_zoo.vision.vgg11_bn(classes=10),
                 32),
    "densenet": (lambda m: m.gluon.model_zoo.vision.DenseNet(
        8, 4, [1, 1, 1, 1], classes=10), 224),
    "squeezenet1.0": (lambda m: m.gluon.model_zoo.vision.squeezenet1_0(
        classes=10), 32),
    "squeezenet1.1": (lambda m: m.gluon.model_zoo.vision.squeezenet1_1(
        classes=10), 32),
    "inceptionv3": (lambda m: m.gluon.model_zoo.vision.inception_v3(
        classes=10), 299),
    "mobilenet0.25": (lambda m: m.gluon.model_zoo.vision.mobilenet0_25(
        classes=10), 32),
    "mobilenetv2_0.25": (lambda m: m.gluon.model_zoo.vision.
                         mobilenet_v2_0_25(classes=10), 32),
}


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_family_forward_matches_reference(family):
    """Predict-mode logits of (2, 3, size, size) on the same weights."""
    build, size = FAMILIES[family]
    jnet, tnet = _pair(build)
    x = np.random.RandomState(3).randn(2, 3, size, size).astype(np.float32)
    tnet.initialize(mx.init.Xavier())
    with mx.autograd.predict_mode():
        got = tnet(mx.nd.array(x)).asnumpy()
    for name, p in tnet.collect_params().items():
        jnet.collect_params()[name].set_data(p.data().asnumpy())
    jnet.hybridize()
    with jmx.autograd.predict_mode():
        want = jnet(jmx.nd.array(x)).asnumpy()
    assert got.shape == (2, 10)
    assert _rel(got, want) <= NET_TOL


def test_small_model_trains_one_step():
    """mobilenet0.25 (hybridized, Xavier): one SGD step lowers the loss of
    its batch, with the BatchNorm statistics moving."""
    net = mx.gluon.model_zoo.vision.mobilenet0_25(classes=4)
    net.initialize(mx.init.Xavier())
    net.hybridize()
    r = np.random.RandomState(4)
    x = mx.nd.array(r.randn(8, 3, 32, 32).astype(np.float32))
    y = mx.nd.array(r.randint(0, 4, 8).astype(np.float32))
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    trainer = mx.gluon.Trainer(net.collect_params(), "sgd",
                               {"learning_rate": 0.05})
    losses = []
    for _ in range(2):
        with mx.autograd.record():
            loss = loss_fn(net(x), y)
        loss.backward()
        trainer.step(8)
        losses.append(float(loss.mean().asscalar()))
    assert np.isfinite(losses).all() and losses[1] < losses[0]


# -- the Block API ------------------------------------------------------------------

def _mlp(m):
    net = m.gluon.nn.HybridSequential()
    with net.name_scope():
        net.add(m.gluon.nn.Dense(16, activation="relu"), m.gluon.nn.Dense(4))
    return net


@pytest.mark.parametrize("hybridize", [False, True])
def test_hook_return_values_are_ignored(hybridize):
    """A forward hook that returns a value and a pre-hook that returns
    other inputs change nothing in either package; both run once per
    call, in order, and ``remove()`` takes a hook off in the port."""
    x = np.random.RandomState(5).randn(2, 10).astype(np.float32)
    jnet, tnet = _pair(_mlp)
    tnet.initialize(mx.init.Xavier())
    tnet(mx.nd.array(x))
    for name, p in tnet.collect_params().items():
        jnet.collect_params()[name].set_data(p.data().asnumpy())
    outs, calls = {}, {jmx: [], mx: []}
    for net, m in ((jnet, jmx), (tnet, mx)):
        if hybridize:
            net.hybridize()
        seen = calls[m]
        net.register_forward_pre_hook(
            lambda b, a, seen=seen: seen.append("pre") or ("replaced",))
        net.register_forward_hook(
            lambda b, a, o, seen=seen: seen.append("post") or "replaced")
        net[0].register_forward_hook(lambda b, a, o: o * 0)
        outs[m] = net(m.nd.array(x))
    assert isinstance(outs[mx], mx.nd.NDArray)
    assert calls[mx] == calls[jmx] == ["pre", "post"]
    np.testing.assert_allclose(outs[mx].asnumpy(), outs[jmx].asnumpy(),
                               rtol=0, atol=1e-6)
    handle = tnet.register_forward_hook(lambda b, a, o: calls[mx].append(1))
    handle.remove()
    tnet(mx.nd.array(x))
    assert calls[mx] == ["pre", "post", "pre", "post"]


def test_apply_visits_children_first_and_returns_the_block():
    for m in (jmx, mx):
        net = _fresh(lambda m=m: _mlp(m))
        seen = []
        assert net.apply(lambda b: seen.append(b.name)) is net
        assert seen == [c.name for c in net._children.values()
                        for c in [*c._children.values(), c]] + [net.name]


@pytest.mark.parametrize("hybridize", [False, True])
def test_summary_prints_the_reference_table(capsys, hybridize):
    """The same table, row for row, on a small squeezenet and on the MLP."""
    x = np.ones((2, 3, 32, 32), np.float32)
    for build, data in ((lambda m: m.gluon.model_zoo.vision.squeezenet1_1(
            classes=5), x), (_mlp, np.ones((2, 10), np.float32))):
        jnet, tnet = _pair(build)
        text = {}
        for net, m in ((jnet, jmx), (tnet, mx)):
            net.initialize(m.init.One())
            net(m.nd.array(data))
            if hybridize and m is mx:
                net.hybridize()
            capsys.readouterr()
            net.summary(m.nd.array(data))
            text[m] = capsys.readouterr().out
        assert text[mx] == text[jmx]
        assert "Total params" in text[mx]


def test_infer_shape_resolves_deferred_parameters():
    for m in (jmx, mx):
        net = _fresh(lambda m=m: _mlp(m))
        net.initialize()
        net.infer_shape(m.nd.ones((3, 7)))
        assert [p.shape for p in net.collect_params().values()] == \
            [(16, 7), (16,), (4, 16), (4,)]


# -- the initializers -----------------------------------------------------------

def _filled(m, init, shape, name="w_weight"):
    a = m.nd.zeros(shape)
    init(name, a)
    return a.asnumpy()


@pytest.mark.parametrize("make,shape,name", [
    (lambda m: m.init.Bilinear(), (3, 2, 4, 4), "up_weight"),
    (lambda m: m.init.Bilinear(), (2, 1, 5, 3), "up_weight"),
    (lambda m: m.init.LSTMBias(forget_bias=2.5), (12,), "lstm_weight"),
    (lambda m: m.init.Mixed([".*bias", ".*"],
                            [m.init.Constant(3.0), m.init.One()]),
     (2, 3), "dense_bias"),
    (lambda m: m.init.Mixed([".*bias", ".*"],
                            [m.init.Constant(3.0), m.init.One()]),
     (2, 3), "dense_weight"),
])
def test_deterministic_initializers_equal_the_reference(make, shape, name):
    np.testing.assert_array_equal(_filled(mx, make(mx), shape, name),
                                  _filled(jmx, make(jmx), shape, name))


def test_lstm_bias_on_a_bias_name():
    """The reference dispatches a ``*bias`` name to ``_init_bias`` (zeros)
    and never reaches LSTMBias's forget gate (ROADMAP C.7); the port sets
    it there too, as ``i2h_bias_initializer=LSTMBias()`` means."""
    want = np.zeros(8, np.float32)
    want[2:4] = 1.0
    np.testing.assert_array_equal(
        _filled(mx, mx.init.LSTMBias(), (8,), "l0_i2h_bias"), want)
    np.testing.assert_array_equal(
        _filled(jmx, jmx.init.LSTMBias(), (8,), "l0_i2h_bias"), 0 * want)
    lstm = mx.gluon.rnn.LSTM(2, input_size=3,
                             i2h_bias_initializer=mx.init.LSTMBias())
    lstm.initialize()
    np.testing.assert_array_equal(lstm.l0_i2h_bias.data().asnumpy(), want)


def test_mixed_without_a_match_raises():
    for m in (jmx, mx):
        init = m.init.Mixed(["bias$"], [m.init.Zero()])
        with pytest.raises(m.MXNetError, match="no initializer pattern"):
            _filled(m, init, (2, 2))


@pytest.mark.parametrize("rand_type", ["uniform", "normal"])
@pytest.mark.parametrize("shape", [(6, 20), (20, 6), (4, 3, 2, 2)])
def test_orthogonal(shape, rand_type):
    """scale^2 I on the short side: q q^T over rows when they are fewer,
    q^T q over columns otherwise."""
    q = _filled(mx, mx.init.Orthogonal(scale=1.5, rand_type=rand_type),
                shape).reshape(shape[0], -1).astype(np.float64)
    gram = q @ q.T if q.shape[0] <= q.shape[1] else q.T @ q
    np.testing.assert_allclose(gram, 2.25 * np.eye(gram.shape[0]),
                               atol=1e-5)


def test_msra_prelu_std_and_the_aliases():
    shape = (300, 200)
    w = _filled(mx, mx.init.MSRAPrelu(slope=0.5), shape)
    want = np.sqrt(2.0 / (1 + 0.25) / 250.0)
    # the sample std of 6e4 normal draws is within 1 % of sigma
    assert abs(w.std() / want - 1) < 0.01 and abs(w.mean()) < 3 * want / 245
    assert repr(mx.init.get("msra_prelu")) == repr(jmx.init.get("msra_prelu"))
    assert type(mx.init.get("gaussian")).__name__ == "Normal"
    w = _filled(mx, mx.init.get("msra_prelu", factor_type="in"), shape)
    assert abs(w.std() / np.sqrt(2.0 / 1.0625 / 200) - 1) < 0.01
