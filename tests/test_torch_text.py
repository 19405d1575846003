"""``mx.contrib`` of the port held against the JAX package on the CPU:
``contrib.text`` (token counting, ``Vocabulary``, ``CustomEmbedding`` read
from small files the tests write, ``CompositeEmbedding``) and
``contrib.svrg.SVRGTrainer``, the reference's ``tests/test_text.py`` case
by case, each against the reference itself; and the ``mx.contrib``
namespace.

Tolerances: vocabularies, indices and embedding vectors equal; SVRG's
weights and loss trajectories within 1e-5 relative of the reference's
(float32 gradients summed in another order).
"""

import os

import numpy as np
import pytest

import mxnet_tpu as jmx
from mxnet_tpu.contrib import svrg as jsvrg
from mxnet_tpu.contrib import text as jtext
import mxnet_tpu_torch as mx
from mxnet_tpu_torch.contrib import svrg, text

SVRG_RTOL = 1e-5


@pytest.fixture(autouse=True)
def _on_cpu():
    with mx.cpu():
        yield


def _write(tmp_path, name, body):
    p = os.path.join(str(tmp_path), name)
    with open(p, "w") as f:
        f.write(body)
    return p


def test_count_tokens():
    for t in (jtext, text):
        c = t.count_tokens_from_str("a b b\nc a  a", to_lower=False)
        assert c == {"a": 3, "b": 2, "c": 1}
        assert t.count_tokens_from_str("A a", to_lower=True)["a"] == 2
        c2 = t.count_tokens_from_str("x|y||x", token_delim="|",
                                     counter_to_update=c)
        assert c2 is c and c["x"] == 2


def test_vocabulary_ranking_and_lookup():
    res = []
    for t, err in ((jtext, jmx.MXNetError), (text, mx.MXNetError)):
        c = t.count_tokens_from_str("dog cat cat bird dog dog")
        v = t.Vocabulary(c, unknown_token="<unk>", reserved_tokens=["<pad>"])
        v2 = t.Vocabulary(c, most_freq_count=2, min_freq=2)
        v3 = t.Vocabulary({"<pad>": 5, "a": 3, "b": 2}, most_freq_count=2,
                          reserved_tokens=["<pad>"])
        with pytest.raises(err):
            v.to_tokens([99])
        with pytest.raises(err):
            t.Vocabulary(c, min_freq=0)
        with pytest.raises(err):
            t.Vocabulary(c, reserved_tokens=["<unk>"])
        res.append((v.idx_to_token, v.to_indices("dog"),
                    v.to_indices(["bird", "missing"]), v.to_tokens([2, 3]),
                    v.to_tokens(4), len(v), v2.idx_to_token,
                    v3.idx_to_token, v.token_to_idx))
    assert res[0] == res[1]
    assert res[1][0] == ["<unk>", "<pad>", "dog", "cat", "bird"]
    assert res[1][6] == ["<unk>", "dog", "cat"]
    assert res[1][7] == ["<unk>", "<pad>", "a", "b"]


def _embeddings(t, pkg, p1, p2):
    e1 = t.CustomEmbedding(p1)
    first = (e1.vec_len, len(e1), e1.idx_to_token,
             e1.get_vecs_by_tokens(["dog", "nope"]).asnumpy(),
             e1.get_vecs_by_tokens("cat").asnumpy())
    e1.update_token_vectors("dog", pkg.nd.array(np.array([[9., 9.]])))
    vocab = t.Vocabulary(t.count_tokens_from_str("dog cat dog"))
    comp = t.CompositeEmbedding(vocab, [e1, t.CustomEmbedding(p2)])
    return first + (e1.get_vecs_by_tokens("dog").asnumpy(), comp.vec_len,
                    comp.idx_to_token, comp.idx_to_vec.asnumpy(),
                    comp.get_vecs_by_tokens("dog").asnumpy(),
                    comp.get_vecs_by_tokens(["cat", "zzz"]).asnumpy())


def test_custom_embedding_and_composite(tmp_path):
    p1 = _write(tmp_path, "e1.txt", "dog 1 2\ncat 3 4\nbird 5 6\n")
    p2 = _write(tmp_path, "e2.txt", "dog 10\ncat 30\n")
    got = _embeddings(text, mx, p1, p2)
    want = _embeddings(jtext, jmx, p1, p2)
    for g, w in zip(got, want):
        if isinstance(g, np.ndarray):
            assert g.dtype == w.dtype and np.array_equal(g, w)
        else:
            assert g == w
    np.testing.assert_array_equal(got[3], [[1, 2], [0, 0]])
    np.testing.assert_array_equal(got[-2], [9, 9, 10])
    e = text.CustomEmbedding(p1)
    with pytest.raises(mx.MXNetError):
        e.update_token_vectors("nope", mx.nd.array(np.array([[1., 1.]])))


def test_custom_embedding_vocab_filter_header_and_errors(tmp_path):
    p = _write(tmp_path, "e.txt", "a 1 2\nb 3 4\n")
    ft = _write(tmp_path, "ft.txt", "2 3\ndog 1 2 3\ncat 4 5 6\n")
    bad = _write(tmp_path, "bad.txt", "a 1 2\nb 3\n")
    empty = _write(tmp_path, "empty.txt", "\n")
    for t, err in ((jtext, jmx.MXNetError), (text, mx.MXNetError)):
        vocab = t.Vocabulary(t.count_tokens_from_str("a c a"))
        e = t.CustomEmbedding(p, vocabulary=vocab)
        assert e.idx_to_token == ["<unk>", "a"]
        f = t.CustomEmbedding(ft, init_unknown_vec=lambda shape: np.full(
            shape, 0.5, np.float32))
        assert f.vec_len == 3
        np.testing.assert_array_equal(f.get_vecs_by_tokens("cat").asnumpy(),
                                      [4, 5, 6])
        np.testing.assert_array_equal(f.get_vecs_by_tokens("x").asnumpy(),
                                      [0.5, 0.5, 0.5])
        np.testing.assert_array_equal(
            f.get_vecs_by_tokens(["DOG"], lower_case_backup=True).asnumpy(),
            [[1, 2, 3]])
        for path in (bad, empty):
            with pytest.raises(err):
                t.CustomEmbedding(path)


def _svrg_run(pkg, mod, X, Y):
    pkg.random.seed(0)
    net = pkg.gluon.nn.Dense(1, use_bias=False, in_units=5)
    net.initialize(pkg.init.Zero())
    net.weight.set_data(pkg.nd.array(
        np.random.RandomState(1).randn(1, 5).astype(np.float32) * 0.1))

    def loss_fn(out, label):
        return ((out - label) ** 2).mean()

    tr = mod.SVRGTrainer(net, loss_fn, learning_rate=0.05, update_freq=2)
    batches = [(pkg.nd.array(X[i:i + 16]), pkg.nd.array(Y[i:i + 16]))
               for i in range(0, 64, 16)]
    w0 = net.weight.data().asnumpy().copy()
    tr.update_full_grads(iter(batches))
    losses = [tr.step(*batches[0])]
    w1 = net.weight.data().asnumpy().copy()
    for _ in range(6):
        tr.maybe_refresh(iter(batches))
        for xb, yb in batches:
            losses.append(tr.step(xb, yb))
    return w0, w1, np.array(losses), net.weight.data().asnumpy()


def test_svrg_matches_reference_and_oracle():
    """The update is the numpy SVRG oracle g(w) - g(w~) + g_full on a
    linear model, the trajectory equals the reference's, and the loss
    falls."""
    r = np.random.RandomState(0)
    X = r.randn(64, 5).astype(np.float32)
    Y = X @ r.randn(5, 1).astype(np.float32)
    w0, w1, losses, w_end = _svrg_run(mx, svrg, X, Y)
    jw0, jw1, jlosses, jw_end = _svrg_run(jmx, jsvrg, X, Y)
    assert np.array_equal(w0, jw0)

    def grad_at(w, xb, yb):
        e = xb @ w.T - yb
        return (2.0 / len(xb)) * e.T @ xb
    g_full = np.mean([grad_at(w0, X[i:i + 16], Y[i:i + 16])
                      for i in range(0, 64, 16)], axis=0)
    np.testing.assert_allclose(w1, w0 - 0.05 * g_full, rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(w1, jw1, rtol=SVRG_RTOL, atol=0)
    np.testing.assert_allclose(losses, jlosses, rtol=SVRG_RTOL, atol=0)
    np.testing.assert_allclose(w_end, jw_end, rtol=SVRG_RTOL, atol=0)
    assert losses[-1] < 0.2 * losses[0]


def test_svrg_errors():
    net = mx.gluon.nn.Dense(1, in_units=2)
    net.initialize()
    with pytest.raises(mx.MXNetError, match="update_freq"):
        svrg.SVRGTrainer(net, None, update_freq=0)
    tr = svrg.SVRGTrainer(net, lambda o, y: o.sum())
    with pytest.raises(mx.MXNetError, match="update_full_grads"):
        tr.step(mx.nd.ones((1, 2)), mx.nd.ones((1, 1)))
    with pytest.raises(mx.MXNetError, match="empty"):
        tr.update_full_grads(iter([]))


def test_contrib_namespace():
    assert mx.contrib.amp is mx.amp
    assert mx.contrib.ndarray.quantize_v2 is mx.nd.contrib.quantize_v2
    assert mx.contrib.symbol.masked_selfatt is mx.sym.contrib.masked_selfatt
    assert mx.contrib.quantization.quantize_net is not None
    assert mx.contrib.text is text and mx.contrib.svrg is svrg
    for name in ("onnx", "tensorrt"):
        with pytest.raises(AttributeError, match=name):
            getattr(mx.contrib, name)
        with pytest.raises(AttributeError):
            getattr(jmx.contrib, name)
    with pytest.raises(AttributeError):
        mx.contrib.nothing_here  # noqa: B018
