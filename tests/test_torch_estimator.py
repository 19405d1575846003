"""The port's ``gluon.contrib.estimator`` on the CPU: the reference's own
estimator tests (``tests/test_components.py``: fit and evaluate, early
stopping, the checkpoint handler) run in both packages, and one fit on the
same weights and batches gives the same weights and metric values in both
(1e-5 of max |ref|: torch's and XLA's CPU matmuls over 3 epochs)."""

import threading

import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx

PKGS = (jmx, mx)


@pytest.fixture(autouse=True)
def _on_cpu():
    with mx.cpu():
        yield


def _toy_loader(m, n=64, d=8, k=4, batch=16, seed=0):
    r = np.random.RandomState(seed)
    X = m.nd.array(r.randn(n, d).astype(np.float32))
    y = m.nd.array(r.randint(0, k, (n,)))
    return m.gluon.data.DataLoader(m.gluon.data.ArrayDataset(X, y),
                                   batch_size=batch)


def _dense(m, units, seed=1):
    out = {}

    def build():
        out["net"] = m.gluon.nn.Dense(units, in_units=8, prefix="dense_")
    t = threading.Thread(target=build)
    t.start()
    t.join(60)
    net = out["net"]
    net.initialize(m.init.Zero())
    r = np.random.RandomState(seed)
    for p in net.collect_params().values():
        p.set_data(m.nd.array(r.randn(*p.shape).astype(np.float32) * 0.2))
    return net


@pytest.mark.parametrize("m", PKGS, ids=["reference", "port"])
def test_estimator_fit_and_evaluate(m):
    from_ = m.gluon.contrib.estimator
    net = m.gluon.nn.Dense(4, in_units=8)
    net.initialize(m.initializer.Xavier())
    est = from_.Estimator(net, m.gluon.loss.SoftmaxCrossEntropyLoss(),
                          train_metrics=["acc"])
    loader = _toy_loader(m)
    est.fit(loader, epochs=3)
    rows = est.evaluate(loader)
    names = [r[0] for r in rows]
    assert any("loss" in n for n in names)
    assert any("accuracy" in n for n in names)


@pytest.mark.parametrize("m", PKGS, ids=["reference", "port"])
def test_estimator_early_stopping(m):
    from_ = m.gluon.contrib.estimator
    net = m.gluon.nn.Dense(4, in_units=8)
    net.initialize()
    est = from_.Estimator(net, m.gluon.loss.SoftmaxCrossEntropyLoss(),
                          train_metrics=["acc"],
                          trainer=m.gluon.Trainer(net.collect_params(), "sgd",
                                                  {"learning_rate": 0.0}))
    stopper = from_.EarlyStoppingHandler(monitor=est.train_loss_metric,
                                         patience=2, min_delta=1e-9,
                                         mode="min")
    est.fit(_toy_loader(m), epochs=50, event_handlers=[stopper])
    assert stopper.stopped_epoch is not None
    assert stopper.stopped_epoch <= 5


@pytest.mark.parametrize("m", PKGS, ids=["reference", "port"])
def test_estimator_checkpoint_handler(m, tmp_path):
    from_ = m.gluon.contrib.estimator
    net = m.gluon.nn.Dense(2, in_units=8)
    net.initialize()
    est = from_.Estimator(net, m.gluon.loss.SoftmaxCrossEntropyLoss())
    ck = from_.CheckpointHandler(str(tmp_path), model_prefix="m")
    est.fit(_toy_loader(m, k=2), epochs=2, event_handlers=[ck])
    assert (tmp_path / "m-epoch0.params").exists()
    assert (tmp_path / "m-epoch1.params").exists()
    assert (tmp_path / "m-epoch1.states").exists()


def test_estimator_fit_matches_reference(tmp_path):
    """The same net, weights, batches and SGD: weights, train metrics and
    the evaluation agree; the port's last checkpoint reloads bit for bit
    and the reference reads it."""
    got = {}
    for m in PKGS:
        from_ = m.gluon.contrib.estimator
        net = _dense(m, 4)
        acc = m.metric.Accuracy()
        est = from_.Estimator(
            net, m.gluon.loss.SoftmaxCrossEntropyLoss(), train_metrics=[acc],
            trainer=m.gluon.Trainer(net.collect_params(), "sgd",
                                    {"learning_rate": 0.1, "momentum": 0.9}))
        d = tmp_path / m.__name__
        est.fit(_toy_loader(m), epochs=3, event_handlers=[
            from_.CheckpointHandler(str(d), model_prefix="m"),
            from_.ValidationHandler(_toy_loader(m, seed=1), est.evaluate)])
        got[m] = ({k: p.data().asnumpy()
                   for k, p in net.collect_params().items()},
                  est.train_loss_metric.get()[1], acc.get()[1],
                  est.evaluate(_toy_loader(m, seed=1)), d)
    (tw, tl, ta, tev, tdir), (jw, jl, ja, jev, _) = got[mx], got[jmx]
    for k in jw:
        assert np.abs(tw[k] - jw[k]).max() <= 1e-5 * np.abs(jw[k]).max(), k
    assert abs(tl - jl) <= 1e-5 * abs(jl) and ta == ja
    assert [r[0] for r in tev] == [r[0] for r in jev]
    np.testing.assert_allclose([r[1] for r in tev], [r[1] for r in jev],
                               rtol=1e-5)
    f = str(tdir / "m-epoch2.params")
    for m in PKGS:
        fresh = _dense(m, 4, seed=9)
        fresh.load_parameters(f)
        for k, p in fresh.collect_params().items():
            a = p.data().asnumpy()
            assert a.tobytes() == tw[k].tobytes() if m is mx \
                else np.array_equal(a, tw[k]), k
