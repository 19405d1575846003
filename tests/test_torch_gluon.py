"""The port's Gluon (Parameter, Block/HybridBlock, nn, loss, Trainer, the
zoo BERT) held against the JAX package's, on the CPU.  Mirrors
``tests/test_gluon.py`` except CTC, which the port does not have yet;
BatchNorm, the conv layers and save/load are held to the reference in
``test_torch_vision.py`` and ``test_torch_checkpoint.py``.

Each case builds the same nets in both packages (in a fresh thread, so the
prefix counters start at 0 on both sides and the names agree), gives the
port the JAX net's weights by name, feeds both the same numpy inputs made
from a seed, and compares.  Tolerances: outputs of small nets atol 1e-6;
gradients rtol 1e-5 (atol 1e-7 for entries near 0); the Gluon BERT
``bert_3_128_2`` atol 2e-5, as ``test_torch_bert.py``; loss trajectories
of the Gluon training loop rtol 1e-4, as the training oracle on the card.
"""

import threading

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from mxnet_tpu.gluon.model_zoo import bert as jbert
from mxnet_tpu_torch.gluon.model_zoo import bert as tbert

PKGS = (jmx, mx)
VOCAB = 97


@pytest.fixture(autouse=True)
def _on_cpu():
    with mx.cpu():
        yield


def _fresh(build):
    """``build()`` in a new thread: fresh prefix counters and name scopes,
    so both packages name the same construction sequence alike."""
    out = {}
    t = threading.Thread(target=lambda: out.setdefault("v", build()))
    t.start()
    t.join(timeout=120)
    assert not t.is_alive() and "v" in out
    return out["v"]


def _pair(build):
    """The net ``build(package)`` in both packages, from fresh counters."""
    return _fresh(lambda: build(jmx)), _fresh(lambda: build(mx))


def _sync(jnet, tnet):
    """Give the port net the JAX net's weights by name (both initialized,
    deferred shapes resolved)."""
    jp, tp = jnet.collect_params(), tnet.collect_params()
    assert list(jp.keys()) == list(tp.keys())
    for name, p in jp.items():
        tp[name].set_data(p.data().asnumpy())


def _mlp(m):
    net = m.gluon.nn.HybridSequential()
    with net.name_scope():
        net.add(m.gluon.nn.Dense(16, activation="relu"), m.gluon.nn.Dense(4))
    return net


def _synced_mlp(x, init=None):
    jnet, tnet = _pair(_mlp)
    for net, m in ((jnet, jmx), (tnet, mx)):
        net.initialize(init)
        net(m.nd.array(x))
    _sync(jnet, tnet)
    return jnet, tnet


X10 = np.random.RandomState(0).randn(4, 10).astype(np.float32)


def test_parameter_basic():
    for m in PKGS:
        p = m.gluon.Parameter("weight", shape=(3, 4))
        p.initialize(ctx=m.cpu())
        assert p.data().shape == (3, 4) and p.grad().shape == (3, 4)
        p.set_data(m.nd.ones((3, 4)))
        assert p.data().asnumpy().sum() == 12
        assert p.list_ctx() == [m.cpu()]


def test_parameter_deferred_init():
    for m in PKGS:
        d = m.gluon.nn.Dense(8)
        d.initialize()
        with pytest.raises(m.MXNetError):
            d.weight.data()
        d(m.nd.ones((2, 5)))
        assert d.weight.shape == (8, 5)
    # the port registers the deferred weight with torch once it exists
    assert [n for n, _ in d.named_parameters()] == ["bias", "weight"]


def test_collect_params_prefix_and_select():
    for m in PKGS:
        net = _fresh(lambda: _mlp(m))
        names = list(net.collect_params().keys())
        assert names and all(n.startswith(net.prefix) for n in names)
        ws = net.collect_params(".*weight")
        assert len(ws) == 2 and all(n.endswith("weight") for n in ws.keys())


def test_shared_params():
    for m in PKGS:
        d1 = m.gluon.nn.Dense(8, in_units=4)
        d2 = m.gluon.nn.Dense(8, in_units=4, params=d1.params)
        d1.initialize()
        x = m.nd.ones((2, 4))
        np.testing.assert_array_equal(d1(x).asnumpy(), d2(x).asnumpy())
        assert d2.weight is d1.weight


def test_dense_flatten_modes():
    x = np.random.RandomState(1).randn(2, 3, 5).astype(np.float32)
    outs = []
    for flatten in (False, True):
        jnet, tnet = _pair(lambda m: m.gluon.nn.Dense(6, flatten=flatten))
        for net, m in ((jnet, jmx), (tnet, mx)):
            net.initialize()
            net(m.nd.array(x))
        _sync(jnet, tnet)
        want = jnet(jmx.nd.array(x)).asnumpy()
        got = tnet(mx.nd.array(x)).asnumpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
        outs.append(got.shape)
    assert outs == [(2, 3, 6), (2, 6)]


def test_sequential_indexing():
    for m in PKGS:
        net = _mlp(m)
        assert len(net) == 2 and isinstance(net[0], m.gluon.nn.Dense)
        assert len(net[0:1]) == 1


@pytest.mark.parametrize("hybridize", [False, True])
def test_hybridize_parity(hybridize):
    jnet, tnet = _synced_mlp(X10)
    if hybridize:
        jnet.hybridize()
        tnet.hybridize()
    want = jnet(jmx.nd.array(X10)).asnumpy()
    got = tnet(mx.nd.array(X10))
    assert isinstance(got, mx.nd.NDArray)
    np.testing.assert_allclose(got.asnumpy(), want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("hybridize", [False, True])
def test_hybridize_grad_parity(hybridize):
    jnet, tnet = _synced_mlp(X10)
    grads = []
    for net, m in ((jnet, jmx), (tnet, mx)):
        if hybridize:
            net.hybridize()
        with m.autograd.record():
            loss = (net(m.nd.array(X10)) ** 2).sum()
        loss.backward()
        grads.append({k: p.grad().asnumpy()
                      for k, p in net.collect_params().items()})
    assert grads[0].keys() == grads[1].keys()
    for k in grads[0]:
        np.testing.assert_allclose(grads[1][k], grads[0][k], rtol=1e-5,
                                   atol=1e-7, err_msg=k)


def test_trainer_adam_training_converges():
    """20 Adam steps of the Gluon loop: the same losses as the reference,
    falling."""
    x = np.random.RandomState(2).randn(32, 10).astype(np.float32)
    y = np.random.RandomState(3).randint(0, 4, (32,))
    jnet, tnet = _synced_mlp(x, init="xavier")
    losses = []
    for net, m in ((jnet, jmx), (tnet, mx)):
        lossf = m.gluon.loss.SoftmaxCrossEntropyLoss()
        tr = m.gluon.Trainer(net.collect_params(), "adam",
                             {"learning_rate": 0.01})
        seen = []
        for _ in range(20):
            with m.autograd.record():
                L = lossf(net(m.nd.array(x)), m.nd.array(y)).mean()
            L.backward()
            tr.step(1)
            seen.append(float(L.asnumpy()))
        losses.append(seen)
    np.testing.assert_allclose(losses[1], losses[0], rtol=1e-4)
    assert losses[1][-1] < losses[1][0] * 0.7


def test_trainer_sgd_momentum_and_save_load_states(tmp_path):
    """SGD with momentum matches the reference over 3 steps, and states
    saved after step 1 and loaded back give the same steps 2-3."""
    x = np.ones((2, 10), np.float32)
    jnet, tnet = _synced_mlp(x)
    weights = []
    for net, m in ((jnet, jmx), (tnet, mx)):
        tr = m.gluon.Trainer(net.collect_params(), "sgd",
                             {"learning_rate": 0.1, "momentum": 0.9,
                              "wd": 0.01})
        for i in range(3):
            with m.autograd.record():
                L = net(m.nd.array(x)).sum()
            L.backward()
            tr.step(2)
            if i == 0:
                f = str(tmp_path / f"{m.__name__}.states")
                tr.save_states(f)
                tr.load_states(f)
        weights.append({k: p.data().asnumpy()
                        for k, p in net.collect_params().items()})
    for k in weights[0]:
        np.testing.assert_allclose(weights[1][k], weights[0][k], rtol=1e-5,
                                   atol=1e-7, err_msg=k)


def test_block_repr_and_children():
    net = _mlp(mx)
    assert "Dense" in repr(net) and len(net._children) == 2
    assert set(dict(net.named_children())) == {"0", "1"}


@pytest.mark.parametrize("loss", ["softmax_ce", "l2", "l1", "sigmoid_bce",
                                  "sigmoid_bce_from_sigmoid"])
def test_losses(loss):
    r = np.random.RandomState(4)
    pred, lab = r.randn(4, 5).astype(np.float32), r.randint(0, 5, (4,))
    a, b = r.randn(4, 3).astype(np.float32), r.rand(4, 3).astype(np.float32)

    def run(m):
        gl = m.gluon.loss
        if loss == "softmax_ce":
            out = gl.SoftmaxCrossEntropyLoss()(m.nd.array(pred),
                                               m.nd.array(lab))
        elif loss == "l2":
            out = gl.L2Loss()(m.nd.array(a), m.nd.array(b))
        elif loss == "l1":
            out = gl.L1Loss()(m.nd.array(a), m.nd.array(b))
        elif loss == "sigmoid_bce":
            out = gl.SigmoidBCELoss()(m.nd.array(a), m.nd.array(b))
        else:
            out = gl.SigmoidBCELoss(from_sigmoid=True)(
                m.nd.array(1 / (1 + np.exp(-a))), m.nd.array(b))
        return out.asnumpy()
    want, got = run(jmx), run(mx)
    assert got.shape == (4,)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_softmax_ce_over_a_sequence_is_the_mean_over_positions():
    """(B, L, V) logits give (B,) losses: the mean over L."""
    r = np.random.RandomState(5)
    pred, lab = r.randn(2, 7, 11).astype(np.float32), r.randint(0, 11, (2, 7))
    out = [m.gluon.loss.SoftmaxCELoss()(m.nd.array(pred), m.nd.array(lab))
           .asnumpy() for m in PKGS]
    assert out[1].shape == (2,)
    np.testing.assert_allclose(out[1], out[0], rtol=0, atol=1e-6)


def test_constant_param():
    def build(m):
        class Net(m.gluon.nn.HybridBlock):
            def __init__(self):
                super().__init__()
                self.c = self.params.get_constant("c", [[1.0, 2.0]])

            def hybrid_forward(self, F, x, c):
                return x * c
        return Net()
    for net, m in zip(_pair(build), PKGS):
        net.initialize()
        np.testing.assert_array_equal(net(m.nd.ones((2, 2))).asnumpy(),
                                      [[1, 2], [1, 2]])
        assert net.c.grad_req == "null"


def test_embedding_layer():
    idx = np.array([1, 2, 3])
    jnet, tnet = _pair(lambda m: m.gluon.nn.Embedding(10, 6))
    for net in (jnet, tnet):
        net.initialize()
    _sync(jnet, tnet)
    got = tnet(mx.nd.array(idx)).asnumpy()
    assert got.shape == (3, 6)
    np.testing.assert_array_equal(got, jnet(jmx.nd.array(idx)).asnumpy())


def test_apply_and_hooks():
    net = _mlp(mx)
    net.initialize()
    seen = []
    net.apply(lambda b: seen.append(type(b).__name__))
    assert "Dense" in seen and "HybridSequential" in seen
    calls = []
    net.register_forward_hook(lambda blk, inp, out: calls.append(out.shape))
    net(mx.nd.ones((1, 10)))
    assert calls == [(1, 4)]


@pytest.mark.parametrize("act", ["LeakyReLU", "PReLU", "ELU", "SELU",
                                 "GELU", "Swish"])
def test_activation_layers(act):
    x = np.random.RandomState(6).randn(3, 4).astype(np.float32)
    args = (0.1,) if act == "LeakyReLU" else ()
    jnet, tnet = _pair(lambda m: getattr(m.gluon.nn, act)(*args))
    for net in (jnet, tnet):
        net.initialize()
    np.testing.assert_allclose(tnet(mx.nd.array(x)).asnumpy(),
                               jnet(jmx.nd.array(x)).asnumpy(), rtol=0,
                               atol=1e-6)


def test_dropout_reads_the_training_flag():
    drop = mx.gluon.nn.Dropout(0.5)
    x = mx.nd.ones((64, 64))
    np.testing.assert_array_equal(drop(x).asnumpy(), x.asnumpy())
    with mx.autograd.train_mode():
        y = drop(x).asnumpy()
    assert 0.3 < (y == 0).mean() < 0.7
    assert set(np.unique(y)) <= {0.0, 2.0}


def test_parameters_are_torch_parameters():
    """Every initialized Gluon parameter is an ``nn.Parameter`` of its
    block, seen by ``parameters()``; ``grad_req="null"`` stops grad."""
    net = _mlp(mx)
    net.initialize()
    net(mx.nd.ones((1, 10)))
    tensors = {id(p) for p in net.parameters()}
    gparams = net.collect_params()
    assert len(tensors) == len(gparams) == 4
    for p in gparams.values():
        assert id(p.data()._data) in tensors
        assert isinstance(p.data()._data, torch.nn.Parameter)
    w = gparams[net.prefix + "dense0_weight"]
    w.grad_req = "null"
    assert not w.data()._data.requires_grad
    with pytest.raises(mx.MXNetError):
        w.grad()


def _names_bert(m):
    bert = jbert if m is jmx else tbert
    return bert.BERTModel(vocab_size=VOCAB, num_layers=2, units=32,
                          hidden_size=64, num_heads=2, max_length=64,
                          prefix="bert_")


def _names_stack(m):
    nn = m.gluon.nn
    outer = nn.Sequential()
    with outer.name_scope():
        inner = nn.HybridSequential()
        with inner.name_scope():
            inner.add(nn.Dense(8, in_units=3), nn.Dense(4, in_units=8,
                                                        use_bias=False))
        outer.add(inner, nn.Dense(2, in_units=4), nn.LayerNorm(in_channels=2))
    return outer


def _names_deferred(m):
    nn = m.gluon.nn
    net = nn.HybridSequential()
    with net.name_scope():
        net.add(nn.Dense(6), nn.Dense(5, activation="tanh"), nn.LayerNorm(),
                nn.Dense(3, flatten=False, use_bias=False))
    return net


@pytest.mark.parametrize("build", [_names_bert, _names_stack,
                                   _names_deferred],
                         ids=["bert", "stack", "deferred"])
def test_collect_params_names_match_reference(build):
    """The same construction sequence gives the same keys, shapes and
    dtypes, letter for letter (weights are carried across by name)."""
    jnet, tnet = _pair(build)
    for net, m in ((jnet, jmx), (tnet, mx)):
        net.initialize()
        if build is _names_deferred:
            net(m.nd.ones((2, 3)))
    j, t = jnet.collect_params(), tnet.collect_params()
    assert list(t.keys()) == list(j.keys())
    for k in j.keys():
        assert t[k].shape == j[k].shape, k
        assert np.dtype(t[k].dtype) == np.dtype(j[k].dtype), k
        assert t[k].data().shape == j[k].data().shape, k


def test_not_yet_ported_raise():
    net = _mlp(mx)
    net.initialize()
    net(mx.nd.ones((1, 10)))
    for call in (lambda: net.export("x"),
                 lambda: mx.gluon.Trainer(net.collect_params(), "sgd",
                                          kvstore="dist_sync")):
        with pytest.raises(mx.MXNetError, match="not yet ported"):
            call()
    # sparse storage is ported (tests/test_torch_sparse.py)
    np.random.seed(0)
    csr = mx.test_utils.rand_ndarray((2, 2), "csr")
    np.random.seed(0)
    assert np.array_equal(csr.asnumpy(), jmx.test_utils.rand_ndarray(
        (2, 2), "csr").asnumpy())


# -- the zoo BERT through the Gluon training loop ---------------------------

def _bert_pair(seed, L):
    """The Gluon BERT (bert_3_128_2's shape) in both packages, on the same
    weights: Normal(0.02) from numpy by the initializers' by-name policy
    (biases and beta 0, gamma 1)."""
    jnet, tnet = _pair(lambda m: (jbert if m is jmx else tbert).BERTModel(
        vocab_size=VOCAB, num_layers=3, units=128, hidden_size=512,
        num_heads=2, max_length=L, dropout=0.0, prefix="bert_"))
    r = np.random.RandomState(seed)
    for net, m in ((jnet, jmx), (tnet, mx)):
        net.initialize(m.init.Zero())
    tparams = tnet.collect_params()
    for name, p in jnet.collect_params().items():
        w = r.normal(0.0, 0.02, p.shape).astype(np.float32)
        if name.endswith(("bias", "beta")):
            w[...] = 0.0
        elif name.endswith("gamma"):
            w[...] = 1.0
        p.set_data(jmx.nd.array(w))
        tparams[name].set_data(w)
    return jnet, tnet


def _bert_batches(L, steps=3, padded=True):
    """``steps`` copies of one batch (the loss must fall on it)."""
    r = np.random.RandomState(L)
    toks = np.repeat(r.randint(0, VOCAB, (1, 2, L)), steps, 0) \
        .astype(np.int32)
    labs = np.repeat(r.randint(0, VOCAB, (1, 2, L)), steps, 0) \
        .astype(np.int32)
    vl = np.array([L - L // 4 - 1, L], np.int32) if padded else None
    return toks, labs, vl


def _gluon_loop(m, net, toks, labs, vl, hybridize):
    """The canonical MXNet loop: record, loss, backward, Trainer.step."""
    if hybridize:
        net.hybridize()
    loss_fn = m.gluon.loss.SoftmaxCELoss()
    trainer = m.gluon.Trainer(net.collect_params(), "adam",
                              {"learning_rate": 1e-3})
    losses = []
    for t, l in zip(toks, labs):
        args = [m.nd.array(t)] + ([] if vl is None else [m.nd.array(vl)])
        with m.autograd.record():
            loss = loss_fn(net(*args)[2], m.nd.array(l))
        loss.backward()
        trainer.step(t.shape[0])
        losses.append(float(loss.mean().asnumpy()))
    return losses


@pytest.mark.parametrize("L", [16, 256])
@pytest.mark.parametrize("padded", [False, True])
def test_bert_outputs_match_reference(L, padded):
    jnet, tnet = _bert_pair(7, L)
    toks, _, vl = _bert_batches(L, steps=1, padded=padded)
    args = [toks[0]] + ([] if vl is None else [vl])
    want = jnet(*[jmx.nd.array(a) for a in args])
    got = tnet(*[mx.nd.array(a) for a in args])
    for name, w, g in zip(("sequence", "pooled", "logits"), want, got):
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g.asnumpy(), w.asnumpy(), rtol=0,
                                   atol=2e-5, err_msg=name)


@pytest.fixture(scope="module")
def bert_reference():
    """The JAX package's hybridized Gluon loop (3 steps, padded batch at
    seq 256): (port net builder on the same weights, batch, losses)."""
    with mx.cpu():
        jnet, _ = _bert_pair(8, 256)
    weights = {k: p.data().asnumpy() for k, p in jnet.collect_params().items()}
    toks, labs, vl = _bert_batches(256)
    losses = _gluon_loop(jmx, jnet, toks, labs, vl, hybridize=True)

    def port_net():
        tnet = _fresh(lambda: tbert.BERTModel(
            vocab_size=VOCAB, num_layers=3, units=128, hidden_size=512,
            num_heads=2, max_length=256, dropout=0.0, prefix="bert_"))
        tnet.initialize(mx.init.Zero())
        for k, p in tnet.collect_params().items():
            p.set_data(weights[k])
        return tnet
    return port_net, (toks, labs, vl), losses


@pytest.mark.parametrize("hybridize", [False, True],
                         ids=["imperative", "hybridized"])
def test_bert_gluon_loop_matches_reference(bert_reference, hybridize):
    """3 steps of record/backward/Trainer.step on a padded batch at seq 256
    (the port's flash path), imperative (every op an NDArray op) and
    hybridized: the reference's per-step losses (its hybridized loop; the
    reference's own tests hold its two paths to each other)."""
    port_net, (toks, labs, vl), want = bert_reference
    got = _gluon_loop(mx, port_net(), toks, labs, vl, hybridize)
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert got[-1] < got[0]


def test_bert_gluon_loop_matches_trainstep():
    """The Gluon loop (SoftmaxCELoss, backward summing over the batch,
    step(B) rescaling by 1/B) and ``parallel.TrainStep`` (the per-token
    mean) train the same weights alike."""
    from mxnet_tpu_torch import parallel
    from mxnet_tpu_torch.ops.nn import softmax_cross_entropy
    toks, labs, _ = _bert_batches(128, padded=False)
    nets = [tbert.bert_model("bert_3_128_2", vocab_size=VOCAB,
                             max_length=128, dropout=0.0, device="cpu",
                             generator=torch.Generator().manual_seed(5))
            for _ in range(2)]
    got = _gluon_loop(mx, nets[0], toks, labs, None, hybridize=True)

    def loss_fn(out, labels):
        logits = out[2]
        return softmax_cross_entropy(logits.reshape(-1, logits.shape[-1]),
                                     labels.reshape(-1)) / labels.numel()
    step = parallel.TrainStep(nets[1], loss_fn, "adam",
                              optimizer_params={"learning_rate": 1e-3})
    want = step.run(toks, labs).tolist()
    np.testing.assert_allclose(got, want, rtol=1e-4)


def test_cast_bf16_trainer_reaches_the_f32_master_adam():
    """``net.cast("bfloat16")`` with ``multi_precision``: the Trainer's
    update is the multi-precision Adam of ``optimizer.py``, bit for bit."""
    from mxnet_tpu_torch import optimizer
    net = _mlp(mx)
    net.initialize(mx.init.Xavier())
    net(mx.nd.ones((1, 10)))
    net.cast("bfloat16")
    params = list(net.collect_params().values())
    assert all(p.data()._data.dtype == torch.bfloat16 for p in params)
    ref_w = [p.data()._data.detach().clone() for p in params]
    tr = mx.gluon.Trainer(net.collect_params(), "adam",
                          {"learning_rate": 0.01, "multi_precision": True})
    opt = optimizer.Adam(learning_rate=0.01, multi_precision=True)
    states = [opt.create_state_multi_precision(i, w)
              for i, w in enumerate(ref_w)]
    x = mx.nd.array(X10).astype("bfloat16")
    for _ in range(2):
        with mx.autograd.record():
            L = net(x).astype("float32").sum()
        L.backward()
        grads = [p.grad()._data.clone() for p in params]
        tr.step(4)
        opt.rescale_grad = 1.0 / 4
        opt.update_multi(list(range(len(ref_w))), ref_w, grads, states)
        for p, w in zip(params, ref_w):
            assert p.data()._data.dtype == torch.bfloat16
            assert torch.equal(p.data()._data, w)
    assert all(s[0].dtype == torch.float32 for s in tr._states.values())
