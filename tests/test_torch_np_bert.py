"""The slice as a whole on the CPU: a 2-layer, narrow Gluon BERT trained
under ``npx.set_np()`` with a loss head written in ``mx.np`` / ``npx``
(``npx.log_softmax``, ``np.take_along_axis``, ``np.mean``), in both
packages from the same weights, at sequence length 256, which takes the
flash route in both (``MXNET_FLASH_MIN_SEQ``, 256 by default).

The reference runs its hybridized loop, as its own tests run it; the port
runs imperative and hybridized.  Per-step losses agree within 1e-4
relative (3 Adam steps, float32 sums in another order, as the Gluon
oracle of ``test_torch_gluon.py``); the first step's gradients within
1e-4 of each parameter's max |reference gradient|; the np head's loss
equals ``gluon.loss.SoftmaxCELoss``'s mean on the same logits to 1e-6
relative.
"""

import threading

import numpy as onp
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from mxnet_tpu.gluon.model_zoo import bert as jbert
from mxnet_tpu_torch.gluon.model_zoo import bert as tbert

VOCAB, L, B = 97, 256, 2


@pytest.fixture(autouse=True)
def _on_cpu():
    with mx.cpu():
        yield


def _fresh(build):
    out = {}
    t = threading.Thread(target=lambda: out.setdefault("v", build()))
    t.start()
    t.join(timeout=120)
    return out["v"]


def _bert(m, weights=None):
    net = _fresh(lambda: (jbert if m is jmx else tbert).BERTModel(
        vocab_size=VOCAB, num_layers=2, units=64, hidden_size=128,
        num_heads=2, max_length=L, dropout=0.0, prefix="bert_"))
    net.initialize(m.init.Zero())
    if weights is None:
        r = onp.random.RandomState(21)
        weights = {}
        for name, p in net.collect_params().items():
            w = r.normal(0.0, 0.02, p.shape).astype(onp.float32)
            if name.endswith(("bias", "beta")):
                w[...] = 0.0
            elif name.endswith("gamma"):
                w[...] = 1.0
            weights[name] = w
    for name, p in net.collect_params().items():
        p.set_data(m.nd.array(weights[name]) if m is jmx else weights[name])
    return net, weights


def np_head(m):
    """The mean negative log-likelihood in ``mx.np`` / ``npx`` only."""
    class NpMLMLoss(m.gluon.HybridBlock):
        def hybrid_forward(self, F, logits, labels):
            logp = m.npx.log_softmax(m.np.astype(logits, "float32"), axis=-1)
            picked = m.np.take_along_axis(logp, m.np.expand_dims(labels, -1),
                                          axis=-1)
            return m.np.negative(m.np.mean(picked))
    return NpMLMLoss()


def _batches(steps=3):
    r = onp.random.RandomState(L)
    toks = r.randint(0, VOCAB, (B, L)).astype(onp.int32)
    labs = r.randint(0, VOCAB, (B, L))
    return [toks] * steps, [labs] * steps


def _train(m, net, hybridize, steps=3):
    head = np_head(m)
    if hybridize:
        net.hybridize()
        head.hybridize()
    params = net.collect_params()
    trainer = m.gluon.Trainer(params, "adam", {"learning_rate": 1e-3})
    toks, labs = _batches(steps)
    losses, grads = [], None
    m.npx.set_np()
    try:
        for t, lab in zip(toks, labs):
            with m.autograd.record():
                logits = net(m.np.array(t))[2]
                loss = head(logits, m.np.array(lab))
            loss.backward()
            if grads is None:
                grads = {k: p.grad().asnumpy() for k, p in params.items()
                         if p.grad_req != "null"}
                ce = m.gluon.loss.SoftmaxCELoss()(logits, m.nd.array(lab))
                onp.testing.assert_allclose(
                    float(loss.asnumpy()), float(ce.mean().asnumpy()),
                    rtol=1e-6)
            trainer.step(1)
            losses.append(float(loss.asnumpy()))
    finally:
        m.npx.reset_np()
    return losses, grads


@pytest.fixture(scope="module")
def reference():
    with jmx.cpu():
        net, weights = _bert(jmx)
        losses, grads = _train(jmx, net, hybridize=True)
    return weights, losses, grads


@pytest.mark.parametrize("hybridize", [False, True],
                         ids=["imperative", "hybridized"])
def test_np_bert_trains_as_the_reference(reference, hybridize):
    weights, want, want_g = reference
    net, _ = _bert(mx, weights)
    got, got_g = _train(mx, net, hybridize)
    onp.testing.assert_allclose(got, want, rtol=1e-4)
    assert got[-1] < got[0]
    assert set(got_g) == set(want_g)
    for k, w in want_g.items():
        scale = max(float(onp.abs(w).max()), 1e-12)
        assert float(onp.abs(got_g[k] - w).max()) / scale <= 1e-4, k


def test_the_step_takes_the_flash_route(monkeypatch):
    """At sequence 256 the port's attention calls ``flash_attention`` (on
    the CPU its plain version), once per layer a forward."""
    from mxnet_tpu_torch.ops import contrib
    calls = []
    real = contrib.flash_attention

    def spy(*a, **k):
        calls.append(a[0].shape)
        return real(*a, **k)
    monkeypatch.setattr(contrib, "flash_attention", spy)
    assert contrib._flash_eligible(L, 64 // 2)
    net, _ = _bert(mx)
    _train(mx, net, hybridize=True, steps=1)
    assert calls == [(B, 2, L, 32)] * 2
