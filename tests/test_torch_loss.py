"""The port's Gluon losses and the ``ctc_loss`` op held against the JAX
package's, on the CPU.

Each loss runs on the same numpy inputs made from a seed in both
packages, imperatively and hybridized: the per-sample losses and the
gradient of their sum with respect to the prediction agree within 1e-5 of
max |ref| (CTC, which sums over the time steps, within 1e-4).  ``ctc_loss``
is compared on feasible labels only: where no alignment exists the
reference (``optax.ctc_loss``) gives a large finite value and the port
``inf`` (ROADMAP C.7), which ``test_ctc_infeasible_label`` pins.
"""

import threading

import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx

TOL = 1e-5
CTC_TOL = 1e-4


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


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _run(m, make, arrays, hybridize):
    """The loss of ``arrays`` (the first is the prediction) and the
    gradient of its sum with respect to the prediction."""
    loss = _fresh(lambda: make(m))
    if hybridize:
        loss.hybridize()
    ins = [m.nd.array(a) for a in arrays]
    ins[0].attach_grad()
    with m.autograd.record():
        out = loss(*ins)
    out.backward()
    return out.asnumpy(), ins[0].grad.asnumpy()


R = np.random.RandomState(0)
F32 = np.float32
PRED = R.randn(4, 6).astype(F32)
SIGNS = np.sign(R.randn(4, 6)).astype(F32)
PROBS = np.exp(R.randn(4, 6)).astype(F32)
PROBS /= PROBS.sum(-1, keepdims=True)
LABELS = np.array([[1, 0, 5], [2, 2, 3], [0, 4, 1], [5, 5, 5]], F32)
SEQ_PRED = R.randn(4, 3, 6).astype(F32)

CASES = {
    "LabelSmoothedCELoss": (lambda m: m.gluon.loss.LabelSmoothedCELoss(
        smoothing=0.2), [SEQ_PRED, LABELS]),
    "LabelSmoothedCELoss-ignore": (
        lambda m: m.gluon.loss.LabelSmoothedCELoss(ignore_index=5),
        [SEQ_PRED, LABELS]),
    "KLDivLoss": (lambda m: m.gluon.loss.KLDivLoss(),
                  [np.log(PROBS[::-1].copy()), PROBS]),
    "KLDivLoss-logits": (lambda m: m.gluon.loss.KLDivLoss(from_logits=False),
                         [PRED, PROBS]),
    "HuberLoss": (lambda m: m.gluon.loss.HuberLoss(rho=0.7),
                  [PRED, R.randn(4, 6).astype(F32)]),
    "HingeLoss": (lambda m: m.gluon.loss.HingeLoss(), [PRED, SIGNS]),
    "SquaredHingeLoss": (lambda m: m.gluon.loss.SquaredHingeLoss(margin=2),
                         [PRED, SIGNS]),
    "LogisticLoss": (lambda m: m.gluon.loss.LogisticLoss(), [PRED, SIGNS]),
    "LogisticLoss-binary": (
        lambda m: m.gluon.loss.LogisticLoss(label_format="binary"),
        [PRED, (SIGNS > 0).astype(F32)]),
    "TripletLoss": (lambda m: m.gluon.loss.TripletLoss(margin=0.5),
                    [PRED, R.randn(4, 6).astype(F32),
                     R.randn(4, 6).astype(F32)]),
    "CosineEmbeddingLoss": (
        lambda m: m.gluon.loss.CosineEmbeddingLoss(margin=0.1),
        [PRED, R.randn(4, 6).astype(F32), np.array([1, -1, 1, -1], F32)]),
}


@pytest.mark.parametrize("hybridize", [False, True])
@pytest.mark.parametrize("case", sorted(CASES))
def test_loss_matches_reference(case, hybridize):
    make, arrays = CASES[case]
    got, got_g = _run(mx, make, arrays, hybridize)
    want, want_g = _run(jmx, make, arrays, False)
    assert got.shape == want.shape == (4,)
    assert _rel(got, want) <= TOL
    assert _rel(got_g, want_g) <= TOL


def test_losses_take_sample_weights():
    sw = np.array([[1.0], [0.5], [0.0], [2.0]], F32)
    for make in (lambda m: m.gluon.loss.HuberLoss(weight=3.0),
                 lambda m: m.gluon.loss.HingeLoss()):
        got, _ = _run(mx, make, [PRED, SIGNS, sw], False)
        want, _ = _run(jmx, make, [PRED, SIGNS, sw], False)
        assert got[2] == 0 and _rel(got, want) <= TOL


# -- CTC --------------------------------------------------------------------------

T, N, C = 12, 4, 6
DATA = R.randn(T, N, C).astype(F32)
# feasible labels (a repeat needs a blank between: 2 2 takes 3 steps)
FIRST = np.array([[1, 2, 2, 0], [3, 0, 0, 0], [5, 4, 3, 2], [1, 1, 1, 0]],
                 F32)
LAST = np.array([[0, 2, 2, -1], [3, -1, -1, -1], [4, 4, 3, 2],
                 [1, 1, 1, -1]], F32)
DATA_LENGTHS = np.array([12, 10, 9, 12], F32)
LABEL_LENGTHS = np.array([3, 1, 4, 2], F32)


def _ctc_op(m, labels, blank, lengths):
    x = m.nd.array(DATA)
    x.attach_grad()
    extra = [m.nd.array(DATA_LENGTHS), m.nd.array(LABEL_LENGTHS)] \
        if lengths else []
    with m.autograd.record():
        loss = m.nd.ctc_loss(x, m.nd.array(labels), *extra,
                             use_data_lengths=lengths,
                             use_label_lengths=lengths, blank_label=blank)
        head = (loss * m.nd.array(np.arange(1, N + 1, dtype=F32))).sum()
    head.backward()
    return loss.asnumpy(), x.grad.asnumpy()


@pytest.mark.parametrize("lengths", [False, True])
@pytest.mark.parametrize("blank", ["first", "last"])
def test_ctc_loss_op_matches_reference(blank, lengths):
    """``blank_label`` 'first' (blank 0, 0 pads) and 'last' (blank C-1,
    -1 pads), with and without explicit lengths: one loss per sequence
    and the gradient of the logits."""
    labels = FIRST if blank == "first" else LAST
    got, got_g = _ctc_op(mx, labels, blank, lengths)
    want, want_g = _ctc_op(jmx, labels, blank, lengths)
    assert got.dtype == np.float32 and got.shape == (N,)
    assert _rel(got, want) <= CTC_TOL
    assert _rel(got_g, want_g) <= CTC_TOL


def test_ctc_infeasible_label():
    """Four labels in two steps have no alignment: the port gives inf
    (``torch.nn.functional.ctc_loss``), the reference optax's finite
    stand-in near 1e5."""
    x, lab = DATA[:2], np.tile(np.array([1, 2, 3, 4], F32), (N, 1))
    got = mx.nd.ctc_loss(mx.nd.array(x), mx.nd.array(lab)).asnumpy()
    want = jmx.nd.ctc_loss(jmx.nd.array(x), jmx.nd.array(lab)).asnumpy()
    assert np.all(np.isinf(got))
    assert np.all(np.isfinite(want)) and np.all(np.abs(want - 1e5) < 10)


@pytest.mark.parametrize("hybridize", [False, True])
@pytest.mark.parametrize("layout", ["NTC", "TNC"])
def test_ctc_loss_layer_matches_reference(layout, hybridize):
    """``gluon.loss.CTCLoss`` (blank 'last') with label lengths only: the
    layer supplies every sequence's full length for the data."""
    pred = DATA.transpose(1, 0, 2).copy() if layout == "NTC" else DATA
    labels = LAST.T.copy()

    def make(m):
        return m.gluon.loss.CTCLoss(layout=layout, label_layout="TN")

    res = {}
    for m in (jmx, mx):
        loss = _fresh(lambda m=m: make(m))
        if hybridize and m is mx:
            loss.hybridize()
        x = m.nd.array(pred)
        x.attach_grad()
        with m.autograd.record():
            out = loss(x, m.nd.array(labels), None,
                       m.nd.array(LABEL_LENGTHS))
        out.backward()
        res[m] = out.asnumpy(), x.grad.asnumpy()
    assert _rel(res[mx][0], res[jmx][0]) <= CTC_TOL
    assert _rel(res[mx][1], res[jmx][1]) <= CTC_TOL
