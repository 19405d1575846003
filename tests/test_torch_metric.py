"""The port's ``mx.metric`` held against the JAX package's, on the CPU: every
metric on the same labels and predictions (numpy, from a seeded
RandomState), over two updates, local and global values, to 1e-6
relative (both read the arrays back to numpy and sum there)."""

import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx


@pytest.fixture(autouse=True)
def _on_cpu():
    with mx.cpu():
        yield


def _inputs(kind, r):
    if kind == "class":          # labels (8,), class scores (8, 5)
        return (r.randint(0, 5, (8,)).astype(np.float32),
                r.rand(8, 5).astype(np.float32))
    if kind == "prob":           # labels (8,), probabilities (8, 5)
        p = r.rand(8, 5).astype(np.float32) + 0.05
        return (r.randint(0, 5, (8,)).astype(np.float32),
                p / p.sum(1, keepdims=True))
    if kind == "binary":         # labels (8,), two-class scores (8, 2)
        return (r.randint(0, 2, (8,)).astype(np.float32),
                r.rand(8, 2).astype(np.float32))
    if kind == "regress":        # targets (8, 1), predictions (8, 1)
        return (r.randn(8, 1).astype(np.float32),
                r.randn(8, 1).astype(np.float32))
    if kind == "argmax":         # labels (4, 6), predicted ids (4, 6)
        return (r.randint(0, 3, (4, 6)).astype(np.float32),
                r.randint(0, 3, (4, 6)).astype(np.float32))
    raise ValueError(kind)


def _feval(label, pred):
    return float(np.abs(label - pred.reshape(label.shape)).sum()), label.size


CASES = {
    "acc": ("class", lambda m: m.metric.create("acc")),
    "acc_of_argmax": ("argmax", lambda m: m.metric.Accuracy()),
    "top_k_acc": ("class", lambda m: m.metric.create("top_k_acc", top_k=3)),
    "f1": ("binary", lambda m: m.metric.F1()),
    "mcc": ("binary", lambda m: m.metric.MCC()),
    "mae": ("regress", lambda m: m.metric.MAE()),
    "mse": ("regress", lambda m: m.metric.create("mse")),
    "rmse": ("regress", lambda m: m.metric.RMSE()),
    "ce": ("prob", lambda m: m.metric.create("ce")),
    "nll_loss": ("prob", lambda m: m.metric.create("nll_loss")),
    "perplexity": ("prob", lambda m: m.metric.Perplexity(ignore_label=2)),
    "pearsonr": ("regress", lambda m: m.metric.create("pearsonr")),
    "loss": ("regress", lambda m: m.metric.Loss()),
    "custom": ("regress", lambda m: m.metric.create(_feval)),
    "np": ("regress", lambda m: m.metric.np(_feval)),
    "composite": ("class", lambda m: m.metric.create(
        ["acc", m.metric.TopKAccuracy(2), "ce"])),
}


def _values(got):
    name, value = got
    return (name if isinstance(name, list) else [name],
            np.asarray(value if isinstance(value, list) else [value],
                       np.float64))


@pytest.mark.parametrize("case", sorted(CASES))
def test_metric_matches_reference(case):
    kind, build = CASES[case]
    r = np.random.RandomState(sorted(CASES).index(case))
    batches = [_inputs(kind, r) for _ in range(2)]
    if case == "composite":
        batches = [_inputs("prob", r) for _ in range(2)]
    res = {}
    for m in (jmx, mx):
        metric = build(m)
        seen = []
        for i, (label, pred) in enumerate(batches):
            if i == 1 and case != "composite":
                metric.reset_local()
            metric.update([m.nd.array(label)], [m.nd.array(pred)])
            # the reference's composite has no global sums (below)
            seen.append((metric.get(), metric.get() if case == "composite"
                         else metric.get_global()))
        res[m] = (seen, metric.get_name_value())
    for (tl, tg), (jl, jg) in zip(res[mx][0], res[jmx][0]):
        for t, j in ((tl, jl), (tg, jg)):
            (tn, tv), (jn, jv) = _values(t), _values(j)
            assert tn == jn
            np.testing.assert_allclose(tv, jv, rtol=1e-6, atol=1e-12)
    assert [n for n, _ in res[mx][1]] == [n for n, _ in res[jmx][1]]


def test_accuracy_takes_an_ndarray_and_counts_instances():
    acc = mx.metric.Accuracy()
    acc.update(mx.nd.array([0, 1, 2]), mx.nd.array([[1, 0, 0], [0, 1, 0],
                                                     [1, 0, 0]]))
    assert acc.get() == ("accuracy", 2 / 3) and acc.num_inst == 3
    acc.reset()
    assert np.isnan(acc.get()[1])


def test_create_rejects_unknown_and_registers():
    for m in (jmx, mx):
        with pytest.raises(m.MXNetError):
            m.metric.create("bleu")

    @mx.metric.register
    class HalfLoss(mx.metric.Loss):
        def update(self, labels, preds):
            super().update(labels, [p * 0.5 for p in preds])

    half = mx.metric.create("halfloss")
    half.update(None, [mx.nd.array([2.0, 4.0])])
    assert half.get()[1] == 1.5


def test_composite_resets_and_reports_its_members_globally():
    """The reference's CompositeEvalMetric has no ``get_global`` sums (it
    raises AttributeError) and its ``reset_local`` leaves the members'
    sums; the port's delegates both to the members."""
    label, pred = mx.nd.array([0, 1, 1]), mx.nd.array([[1, 0], [1, 0],
                                                        [0, 1]])
    comp = mx.metric.create(["acc", "mse"])
    comp.update([label], [pred.argmax(axis=1)])
    comp.reset_local()
    comp.update([label], [mx.nd.array([0, 1, 1])])
    names, local = comp.get()
    _, glob = comp.get_global()
    assert names == ["accuracy", "mse"]
    assert local == [1.0, 0.0] and glob[0] == 5 / 6
    with pytest.raises(AttributeError):
        jmx.metric.create(["acc"]).get_global()
