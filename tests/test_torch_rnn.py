"""The port's recurrent surface held against the JAX package's, on the CPU:
the ``RNN`` op, ``gluon.rnn``'s fused layers and cells, and the tied
word-level LSTM language model of MXNet's Gluon example
(``example/gluon/word_language_model``) trained by the canonical loop.

Each case builds the same nets in both packages (in a fresh thread, so the
prefix counters start at 0 on both sides and the names agree), gives the
port the JAX net's weights by name, feeds both the same numpy inputs made
from a seed, and compares.  Tolerances: outputs, final states and
gradients within 1e-5 of max |ref|; the LM's per-step losses within 1e-5
relative.
"""

import threading

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from mxnet_tpu.ops import nn as jnn_ops
from mxnet_tpu_torch import convert
from mxnet_tpu_torch.ops.nn import rnn_infer

TOL = 1e-5
MODES = ("lstm", "gru", "rnn_tanh", "rnn_relu")


@pytest.fixture(autouse=True)
def _on_cpu():
    with mx.cpu():
        yield


def _fresh(build):
    out = {}
    t = threading.Thread(target=lambda: out.setdefault("v", build()))
    t.start()
    t.join(timeout=120)
    assert not t.is_alive() and "v" in out
    return out["v"]


def _pair(build):
    return _fresh(lambda: build(jmx)), _fresh(lambda: build(mx))


def _init(net, m):
    """Xavier draws in the port; zeros in the reference, whose values
    :func:`_sync` then sets (a traced draw per shape costs seconds)."""
    net.initialize(mx.init.Xavier() if m is mx else jmx.init.Zero())


def _sync(jnet, tnet):
    """Give the reference net the port net's weights by name (both
    initialized, deferred shapes resolved)."""
    jp, tp = jnet.collect_params(), tnet.collect_params()
    assert list(jp.keys()) == list(tp.keys())
    for name, p in tp.items():
        assert jp[name].shape == p.shape, name
        jp[name].set_data(p.data().asnumpy())


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _op_inputs(mode, bidirectional, T=6, N=3, I=5, H=4, L=2, seed=0):
    r = np.random.RandomState(seed)
    d = 2 if bidirectional else 1
    attrs = {"state_size": H, "num_layers": L, "mode": mode,
             "bidirectional": bidirectional, "state_outputs": True}
    size = rnn_infer([(T, N, I), None], attrs)[1][0]
    arrays = [r.randn(T, N, I), r.randn(size) * 0.4, r.randn(L * d, N, H)]
    if mode == "lstm":
        arrays.append(r.randn(L * d, N, H))
    return [a.astype(np.float32) for a in arrays], attrs


def _run_op(m, arrays, attrs, **extra):
    """Outputs of ``RNN`` and the gradients of sum(out_i * w_i) with
    respect to every input."""
    ins = [m.nd.array(a) for a in arrays]
    for a in ins:
        a.attach_grad()
    with m.autograd.record():
        outs = m.nd.RNN(*ins, **attrs, **extra)
        outs = outs if isinstance(outs, list) else [outs]
        r = np.random.RandomState(1)
        head = sum((o * m.nd.array(r.randn(*o.shape).astype(np.float32)))
                   .sum() for o in outs)
    head.backward()
    return [o.asnumpy() for o in outs], [a.grad.asnumpy() for a in ins]


@pytest.mark.parametrize("bidirectional", [False, True])
@pytest.mark.parametrize("mode", MODES)
def test_rnn_op_matches_reference(mode, bidirectional):
    """Each mode, 2 layers: the output, the final states and the gradients
    of data, the flat parameters and the states (torch's gate orders are
    the reference's)."""
    arrays, attrs = _op_inputs(mode, bidirectional)
    got, got_g = _run_op(mx, arrays, attrs)
    want, want_g = _run_op(jmx, arrays, attrs)
    assert len(got) == len(want) == (3 if mode == "lstm" else 2)
    for g, w in zip(got + got_g, want + want_g):
        assert _rel(g, w) <= TOL


def test_rnn_op_without_state_outputs():
    arrays, attrs = _op_inputs("gru", True)
    attrs = dict(attrs, state_outputs=False)
    got = mx.nd.RNN(*[mx.nd.array(a) for a in arrays], **attrs)
    want = jmx.nd.RNN(*[jmx.nd.array(a) for a in arrays], **attrs)
    assert got.shape == (6, 3, 8)
    assert _rel(got.asnumpy(), want.asnumpy()) <= TOL


def test_rnn_infer_is_the_reference_rule():
    for mode in MODES:
        for bi in (False, True):
            attrs = {"mode": mode, "state_size": 7, "num_layers": 3,
                     "bidirectional": bi}
            shapes = [(4, 2, 5), None, None, None]
            assert rnn_infer(shapes, attrs) == \
                jnn_ops._rnn_infer(shapes, attrs)


def test_rnn_op_checks_the_parameter_size():
    arrays, attrs = _op_inputs("lstm", False)
    arrays[1] = arrays[1][:-1]
    with pytest.raises(mx.MXNetError, match="parameters of shape"):
        mx.nd.RNN(*[mx.nd.array(a) for a in arrays], **attrs)


def test_rnn_dropout_between_layers_from_the_generator():
    """With p > 0 while training, the mask falls between the layers (not
    after the last) and comes from the device's generator: the op equals
    layer 1, a mask drawn from the same seed, then layer 2."""
    mode, H, N, T, I, p = "lstm", 4, 3, 6, 5, 0.4
    arrays, attrs = _op_inputs(mode, False)
    x, w, h0, c0 = (mx.nd.array(a) for a in arrays)
    mx.random.seed(11)
    with mx.autograd.train_mode():
        out, hn, cn = mx.nd.RNN(x, w, h0, c0, **attrs, p=p)
        again = mx.nd.RNN(x, w, h0, c0, **attrs, p=p)[0]
    assert not np.allclose(out.asnumpy(), again.asnumpy())
    # the same stack by hand: the first layer's weights, then the second's
    n1 = rnn_infer([(T, N, I), None], dict(attrs, num_layers=1))[1][0]
    n2 = rnn_infer([(T, N, H), None], dict(attrs, num_layers=1))[1][0]
    flat = arrays[1]
    g = 4 * H
    wi1, wh1 = flat[:g * I], flat[g * I:g * I + g * H]
    rest = flat[g * I + g * H:]
    wi2, wh2 = rest[:g * H], rest[g * H:2 * g * H]
    biases = rest[2 * g * H:]
    w1 = np.concatenate([wi1, wh1, biases[:2 * g]])
    w2 = np.concatenate([wi2, wh2, biases[2 * g:]])
    assert w1.size == n1 and w2.size == n2
    one = dict(attrs, num_layers=1)
    mx.random.seed(11)
    with mx.autograd.train_mode():
        y1, h1, c1 = mx.nd.RNN(x, mx.nd.array(w1), h0[0:1], c0[0:1], **one)
        gen = mx.random.generator(mx.cpu())
        keep = (torch.rand(tuple(y1.shape), generator=gen) < 1 - p).float()
        y1 = mx.nd.array((y1._data * keep / (1 - p)).numpy())
        y2, h2, c2 = mx.nd.RNN(y1, mx.nd.array(w2), h0[1:2], c0[1:2], **one)
    np.testing.assert_allclose(out.asnumpy(), y2.asnumpy(), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(hn.asnumpy(), np.concatenate(
        [h1.asnumpy(), h2.asnumpy()]), rtol=0, atol=1e-6)
    # predict mode: no dropout, whatever p
    with mx.autograd.predict_mode():
        plain = mx.nd.RNN(x, w, h0, c0, **attrs)[0]
        dropped = mx.nd.RNN(x, w, h0, c0, **attrs, p=p)[0]
    np.testing.assert_array_equal(plain.asnumpy(), dropped.asnumpy())


@pytest.mark.parametrize("arg,value", [
    ("projection_size", 3), ("use_sequence_length", True),
    ("lstm_state_clip_min", -1.0), ("lstm_state_clip_max", 1.0)])
def test_rnn_op_raises_on_what_the_reference_ignores(arg, value):
    """The reference accepts these and computes as if they were absent
    (ROADMAP C.7); the port raises rather than give that answer."""
    arrays, attrs = _op_inputs("lstm", False)
    plain = jmx.nd.RNN(*[jmx.nd.array(a) for a in arrays], **attrs)[0]
    ignored = jmx.nd.RNN(*[jmx.nd.array(a) for a in arrays], **attrs,
                         **{arg: value})[0]
    np.testing.assert_array_equal(plain.asnumpy(), ignored.asnumpy())
    with pytest.raises(mx.MXNetError, match="not supported"):
        mx.nd.RNN(*[mx.nd.array(a) for a in arrays], **attrs,
                  **{arg: value})


# -- the fused layers -----------------------------------------------------------

def _layer(m, kind, bidirectional, layout="TNC", **kw):
    cls = {"lstm": "LSTM", "gru": "GRU"}.get(kind, "RNN")
    if cls == "RNN":
        kw["activation"] = kind.split("_")[1]
    return getattr(m.gluon.rnn, cls)(4, num_layers=2, layout=layout,
                                     bidirectional=bidirectional, **kw)


def _layer_pair(kind, bidirectional, layout, x):
    jnet, tnet = _pair(lambda m: _layer(m, kind, bidirectional, layout))
    for net, m in ((jnet, jmx), (tnet, mx)):
        _init(net, m)
        net(m.nd.array(x))
    _sync(jnet, tnet)
    return jnet, tnet


@pytest.mark.parametrize("layout", ["TNC", "NTC"])
@pytest.mark.parametrize("bidirectional", [False, True])
@pytest.mark.parametrize("kind", MODES)
def test_fused_layer_matches_reference(kind, bidirectional, layout):
    """Names ``{l|r}{k}_{i2h|h2h}_{weight|bias}`` with the reference's
    shapes (the first layer's input size deferred), the output and the
    final states from given states, and every parameter's gradient."""
    r = np.random.RandomState(2)
    x = r.randn(6, 3, 5).astype(np.float32)
    jnet, tnet = _layer_pair(kind, bidirectional, layout, x)
    d = 2 if bidirectional else 1
    names = [k[len(tnet.prefix):] for k in tnet.collect_params().keys()]
    assert names[:4] == ["l0_i2h_weight", "l0_h2h_weight", "l0_i2h_bias",
                         "l0_h2h_bias"]
    assert len(names) == 4 * 2 * d
    states = [r.randn(2 * d, 6 if layout == "NTC" else 3, 4)
              .astype(np.float32) for _ in tnet.state_info()]
    res = {}
    for net, m in ((jnet, jmx), (tnet, mx)):
        with m.autograd.record():
            out, st = net(m.nd.array(x), [m.nd.array(s) for s in states])
            head = (out * m.nd.array(np.cos(np.arange(out.size))
                                     .reshape(out.shape)
                                     .astype(np.float32))).sum() \
                + sum((s * s).sum() for s in st)
        head.backward()
        res[m] = [out.asnumpy()] + [s.asnumpy() for s in st] + [
            p.grad().asnumpy() for p in net.collect_params().values()]
    for g, w in zip(res[mx], res[jmx]):
        assert _rel(g, w) <= TOL


def test_fused_layer_without_states_and_hybridized():
    x = np.random.RandomState(3).randn(6, 3, 5).astype(np.float32)
    jnet, tnet = _layer_pair("lstm", True, "TNC", x)
    want = jnet(jmx.nd.array(x)).asnumpy()
    assert _rel(tnet(mx.nd.array(x)).asnumpy(), want) <= TOL
    tnet.hybridize()
    assert _rel(tnet(mx.nd.array(x)).asnumpy(), want) <= TOL
    assert repr(tnet) == repr(jnet)
    for m, net in ((jmx, jnet), (mx, tnet)):
        s = net.begin_state(batch_size=3)
        assert [a.shape for a in s] == [(4, 3, 4), (4, 3, 4)]


def test_fused_layer_inside_a_hybridized_parent():
    """A hybridized parent calls the layer on tensors, without states: the
    layer starts from zeros on the input's device."""
    x = np.random.RandomState(4).randn(5, 2, 3).astype(np.float32)

    def build(m):
        class Net(m.gluon.HybridBlock):
            def __init__(self):
                super().__init__()
                with self.name_scope():
                    self.rnn = m.gluon.rnn.GRU(4, num_layers=2)
                    self.out = m.gluon.nn.Dense(2, flatten=False)

            def hybrid_forward(self, F, x):
                return self.out(self.rnn(x))
        return Net()

    jnet, tnet = _pair(build)
    for net, m in ((jnet, jmx), (tnet, mx)):
        _init(net, m)
        net(m.nd.array(x))
    _sync(jnet, tnet)
    tnet.hybridize()
    assert _rel(tnet(mx.nd.array(x)).asnumpy(),
                jnet(jmx.nd.array(x)).asnumpy()) <= TOL


@pytest.mark.parametrize("kind", MODES)
def test_unfuse_gives_the_same_stack_of_cells(kind):
    """``_unfuse()`` names its cells' parameters as the layer's (in both
    packages alike), and with the layer's values its cells, unrolled layer
    by layer, give the layer's output."""
    x = np.random.RandomState(5).randn(6, 3, 5).astype(np.float32)
    jnet, tnet = _layer_pair(kind, kind == "lstm", "TNC", x)
    cells = {m: _fresh(lambda n=net: n._unfuse())
             for m, net in ((jmx, jnet), (mx, tnet))}
    assert list(cells[mx].collect_params().keys()) == \
        list(cells[jmx].collect_params().keys())
    for p in cells[mx].collect_params().values():
        p.set_data(tnet.collect_params()[p.name].data().asnumpy())
    out = mx.nd.array(x)
    for cell in cells[mx]:
        out, _ = cell.unroll(6, out, layout="TNC", merge_outputs=True)
    assert _rel(out.asnumpy(), tnet(mx.nd.array(x)).asnumpy()) <= TOL


# -- the cells ----------------------------------------------------------------

def _cell(m, kind, **kw):
    return {"rnn_tanh": lambda: m.gluon.rnn.RNNCell(5, **kw),
            "rnn_relu": lambda: m.gluon.rnn.RNNCell(5, activation="relu",
                                                    **kw),
            "lstm": lambda: m.gluon.rnn.LSTMCell(5, **kw),
            "gru": lambda: m.gluon.rnn.GRUCell(5, **kw)}[kind]()


@pytest.mark.parametrize("kind", MODES)
def test_cell_unroll_with_valid_length_matches_reference(kind):
    """``unroll`` over an NTC batch with ``valid_length``: outputs past a
    sample's length are 0, its final states are those of its last valid
    step, and the gradients of the parameters agree."""
    r = np.random.RandomState(6)
    x = r.randn(3, 6, 4).astype(np.float32)
    vl = np.array([6, 2, 4], np.float32)
    jc, tc = _pair(lambda m: _cell(m, kind))
    for c, m in ((jc, jmx), (tc, mx)):
        _init(c, m)
        c(m.nd.array(x[:, 0]), c.begin_state(batch_size=3))
    _sync(jc, tc)
    res = {}
    for c, m in ((jc, jmx), (tc, mx)):
        with m.autograd.record():
            out, st = c.unroll(6, m.nd.array(x), layout="NTC",
                               valid_length=m.nd.array(vl))
            head = (out * out).sum() + sum(s.sum() for s in st)
        head.backward()
        res[m] = [out.asnumpy()] + [s.asnumpy() for s in st] + [
            p.grad().asnumpy() for p in c.collect_params().values()]
    assert np.all(res[mx][0][1, 2:] == 0)
    for g, w in zip(res[mx], res[jmx]):
        assert _rel(g, w) <= TOL


def _stack(m):
    seq = m.gluon.rnn.HybridSequentialRNNCell()
    with seq.name_scope():
        seq.add(m.gluon.rnn.LSTMCell(6, input_size=4))
        seq.add(m.gluon.rnn.DropoutCell(0.5))
        seq.add(m.gluon.rnn.ResidualCell(m.gluon.rnn.GRUCell(6,
                                                             input_size=6)))
        seq.add(m.gluon.rnn.ZoneoutCell(m.gluon.rnn.RNNCell(6, input_size=6),
                                        zoneout_outputs=0.3,
                                        zoneout_states=0.3))
    return seq


def test_sequential_modifier_cells_match_reference():
    """A stack of LSTMCell, DropoutCell, ResidualCell(GRUCell) and
    ZoneoutCell(RNNCell) in predict mode (dropout and zoneout are the
    identity there), unrolled as a list of steps."""
    r = np.random.RandomState(7)
    steps = [r.randn(3, 4).astype(np.float32) for _ in range(5)]
    jc, tc = _pair(_stack)
    for c, m in ((jc, jmx), (tc, mx)):
        _init(c, m)
    _sync(jc, tc)
    assert len(tc) == 4 and isinstance(tc[2], mx.gluon.rnn.ResidualCell)
    res = {}
    for c, m in ((jc, jmx), (tc, mx)):
        with m.autograd.predict_mode():
            out, st = c.unroll(5, [m.nd.array(s) for s in steps])
        res[m] = [o.asnumpy() for o in out] + [s.asnumpy() for s in st]
    assert len(res[mx]) == 5 + 4
    for g, w in zip(res[mx], res[jmx]):
        assert _rel(g, w) <= TOL


def test_zoneout_and_dropout_cells_while_training():
    """In training, each zoned-out entry keeps its previous value (the
    first step's previous output is 0), the rest the new one; the dropout
    cell zeroes entries and scales the others by 1 / (1 - p)."""
    cell = mx.gluon.rnn.ZoneoutCell(mx.gluon.rnn.RNNCell(64, input_size=8),
                                    zoneout_outputs=0.5)
    cell.initialize(mx.init.Xavier())
    base = cell.base_cell
    x = mx.nd.array(np.random.RandomState(8).randn(16, 8)
                    .astype(np.float32))
    st = cell.begin_state(batch_size=16)
    with mx.autograd.train_mode():
        out, _ = cell(x, st)
    with mx.autograd.predict_mode():
        full, _ = base(x, st)
    o, f = out.asnumpy(), full.asnumpy()
    kept = o == f
    assert np.all(o[~kept] == 0) and 0.3 < kept.mean() < 0.7
    drop = mx.gluon.rnn.DropoutCell(0.5)
    with mx.autograd.train_mode():
        y, states = drop(x, [])
    y, xs = y.asnumpy(), x.asnumpy()
    assert states == [] and np.allclose(y[y != 0], 2 * xs[y != 0])


def test_bidirectional_cell_unroll_matches_reference():
    r = np.random.RandomState(9)
    x = r.randn(3, 5, 4).astype(np.float32)
    vl = np.array([5, 3, 1], np.float32)

    def build(m):
        return m.gluon.rnn.BidirectionalCell(
            m.gluon.rnn.LSTMCell(3, input_size=4),
            m.gluon.rnn.GRUCell(3, input_size=4))

    jc, tc = _pair(build)
    for c, m in ((jc, jmx), (tc, mx)):
        _init(c, m)
    _sync(jc, tc)
    for lengths in (None, vl):
        res = {}
        for c, m in ((jc, jmx), (tc, mx)):
            out, st = c.unroll(5, m.nd.array(x), layout="NTC",
                               valid_length=None if lengths is None
                               else m.nd.array(lengths))
            res[m] = [out.asnumpy()] + [s.asnumpy() for s in st]
        for g, w in zip(res[mx], res[jmx]):
            assert _rel(g, w) <= TOL
    with pytest.raises(mx.MXNetError, match="unroll"):
        tc(mx.nd.array(x[:, 0]), tc.begin_state(batch_size=3))


# -- the word-level LM ----------------------------------------------------------

def _lm(m, vocab, emb, hidden, layers, dropout, tied):
    """The Gluon word_language_model's RNNModel (LSTM): dropout on the
    embedding and on the LSTM's output, the decoder tied to the
    embedding's weight when ``tied``."""
    gluon = m.gluon

    class RNNModel(gluon.Block):
        def __init__(self, **kwargs):
            super().__init__(**kwargs)
            with self.name_scope():
                self.drop = gluon.nn.Dropout(dropout)
                self.encoder = gluon.nn.Embedding(
                    vocab, emb, weight_initializer=m.init.Uniform(0.1))
                self.rnn = gluon.rnn.LSTM(hidden, layers, dropout=dropout,
                                          input_size=emb)
                if tied:
                    self.decoder = gluon.nn.Dense(
                        vocab, in_units=hidden, params=self.encoder.params)
                else:
                    self.decoder = gluon.nn.Dense(vocab, in_units=hidden)
            self.hidden = hidden

        def forward(self, inputs, state):
            emb = self.drop(self.encoder(inputs))
            out, state = self.rnn(emb, state)
            out = self.drop(out)
            return self.decoder(out.reshape((-1, self.hidden))), state

        def begin_state(self, *args, **kwargs):
            return self.rnn.begin_state(*args, **kwargs)

    return RNNModel()


def _lm_steps(m, net, corpus, bptt, batch, steps, lr=20.0, clip=0.25):
    """The example's loop: state carried and detached, SoftmaxCE summed by
    backward, clip_global_norm(clip * bptt * batch), SGD step(bptt *
    batch) (the per-token mean's gradient clipped at ``clip``).  Returns
    the per-step mean losses."""
    trainer = m.gluon.Trainer(net.collect_params(), "sgd",
                              {"learning_rate": lr})
    loss_fn = m.gluon.loss.SoftmaxCrossEntropyLoss()
    state = net.begin_state(batch_size=batch)
    losses = []
    for i in range(steps):
        x = m.nd.array(corpus[i * bptt:(i + 1) * bptt])
        y = m.nd.array(corpus[i * bptt + 1:(i + 1) * bptt + 1])
        state = [s.detach() for s in state]
        with m.autograd.record():
            out, state = net(x, state)
            loss = loss_fn(out, y.reshape((-1,)))
        loss.backward()
        grads = [p.grad() for p in net.collect_params().values()]
        m.gluon.utils.clip_global_norm(grads, clip * bptt * batch)
        trainer.step(bptt * batch)
        losses.append(float(loss.mean().asscalar()))
    return losses


def _corpus(vocab, bptt, batch, steps, seed=0):
    """(T, batch) token ids from examples/rnn/lstm_lm.py's generator."""
    rng = np.random.RandomState(seed)
    n = bptt * steps + 1
    data = np.zeros(n * batch, np.int64)
    for i in range(1, data.size):
        data[i] = (data[i - 1] * 7 + rng.randint(0, 3)) % vocab
    return data.reshape(batch, n).T.astype(np.float32)


def test_tied_lm_trains_as_the_reference():
    """3 SGD steps (lr 20, clipping at 0.25 bptt batch) of the tied LM,
    dropout 0: per-step losses within 1e-5 relative; the weights after
    them within 1e-5 of max |ref|."""
    vocab, emb, bptt, batch = 50, 16, 7, 4
    corpus = _corpus(vocab, bptt, batch, 3)
    jnet, tnet = _pair(lambda m: _lm(m, vocab, emb, emb, 2, 0.0, True))
    for net, m in ((jnet, jmx), (tnet, mx)):
        _init(net, m)
    _sync(jnet, tnet)
    got = _lm_steps(mx, tnet, corpus, bptt, batch, 3)
    want = _lm_steps(jmx, jnet, corpus, bptt, batch, 3)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)
    for name, p in jnet.collect_params().items():
        assert _rel(tnet.collect_params()[name].data().asnumpy(),
                    p.data().asnumpy()) <= TOL, name


def test_tied_weight_is_one_parameter(tmp_path):
    """One Parameter for the embedding and the decoder: its gradient is
    the sum of both uses, the Trainer updates it once, and
    ``save_parameters(deduplicate=True)`` writes it once (without, under
    both names, as the reference does)."""
    vocab, emb = 30, 8
    tied = _fresh(lambda: _lm(mx, vocab, emb, emb, 1, 0.0, True))
    untied = _fresh(lambda: _lm(mx, vocab, emb, emb, 1, 0.0, False))
    assert tied.decoder.weight is tied.encoder.weight
    params = tied.collect_params()
    assert len(params) == len(untied.collect_params()) - 1
    tied.initialize(mx.init.Xavier())
    untied.initialize(mx.init.Xavier())
    w = tied.encoder.weight.data().asnumpy()
    src = tied._collect_params_with_prefix()
    for name, p in untied._collect_params_with_prefix().items():
        p.set_data(src[name].data().asnumpy())
    corpus = _corpus(vocab, 5, 2, 1)
    x, y = mx.nd.array(corpus[:5]), mx.nd.array(corpus[1:6]).reshape((-1,))
    grads = {}
    for net in (tied, untied):
        with mx.autograd.record():
            out, _ = net(x, net.begin_state(batch_size=2))
            loss = mx.gluon.loss.SoftmaxCrossEntropyLoss()(out, y)
        loss.backward()
        grads[net] = net.encoder.weight.grad().asnumpy(), \
            net.decoder.weight.grad().asnumpy()
    np.testing.assert_allclose(grads[tied][0],
                               grads[untied][0] + grads[untied][1],
                               rtol=1e-5, atol=1e-7)
    trainer = mx.gluon.Trainer(params, "sgd", {"learning_rate": 0.5})
    trainer.step(1)
    np.testing.assert_allclose(tied.encoder.weight.data().asnumpy(),
                               w - 0.5 * grads[tied][0], rtol=1e-6,
                               atol=1e-7)
    both, once = str(tmp_path / "both.params"), str(tmp_path / "once.params")
    tied.save_parameters(both)
    tied.save_parameters(once, deduplicate=True)
    assert {"encoder.weight", "decoder.weight"} <= set(mx.nd.load(both))
    saved = mx.nd.load(once)
    assert "decoder.weight" in saved and "encoder.weight" not in saved
    fresh = _fresh(lambda: _lm(mx, vocab, emb, emb, 1, 0.0, True))
    fresh.load_parameters(once)
    np.testing.assert_array_equal(fresh.encoder.weight.data().asnumpy(),
                                  tied.encoder.weight.data().asnumpy())


def test_load_by_name_carries_the_lm():
    """``convert.load_by_name`` fills a fresh port LM (deferred shapes
    and all) from the reference's ``collect_params()`` names: the LSTM's
    per-layer Parameters and the one tied weight."""
    vocab, emb = 40, 8
    jnet = _fresh(lambda: _lm(jmx, vocab, emb, emb, 2, 0.0, True))
    _init(jnet, jmx)
    r = np.random.RandomState(12)
    for p in jnet.collect_params().values():
        p.set_data(r.uniform(-0.3, 0.3, p.shape).astype(np.float32))
    params = {k: p.data().asnumpy() for k, p in
              jnet.collect_params().items()}
    tnet = convert.load_by_name(
        _fresh(lambda: _lm(mx, vocab, emb, emb, 2, 0.0, True)), params,
        device="cpu")
    x = _corpus(vocab, 6, 3, 1)[:6]
    got, gs = tnet(mx.nd.array(x), tnet.begin_state(batch_size=3))
    want, ws = jnet(jmx.nd.array(x), jnet.begin_state(batch_size=3))
    assert _rel(got.asnumpy(), want.asnumpy()) <= TOL
    for g, w in zip(gs, ws):
        assert _rel(g.asnumpy(), w.asnumpy()) <= TOL
