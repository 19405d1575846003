"""The port's ``mx.checkpoint`` (``CheckpointManager``, ``auto_resume``) on
the CPU: the reference's ``tests/test_checkpoint.py`` cases (round trip,
the manifest's world record, kill and resume, pruning, the fall-back past
a corrupted step, the optimizer state's bytes) and its
``tests/test_resilience.py`` resume cases (SIGTERM, restart policy),
against the port; and a 2-layer BERT at 64 units whose run with a raised
fault and with a SIGTERM, resumed by ``auto_resume``, gives the
uninterrupted run's losses bit for bit, and the JAX package's losses from
the same weights within 1e-4 relative (torch's and XLA's CPU matmuls sum
in another order).  The layout on disk is the port's own (no orbax): the
two packages' checkpoints do not cross, their ``.params`` files do.
"""

import json
import os
import signal
import threading
import warnings

import numpy as np
import pytest

import mxnet_tpu as jmx
from mxnet_tpu.gluon.model_zoo import bert as jbert
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import autograd, gluon
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.gluon.model_zoo import bert as tbert


@pytest.fixture(autouse=True)
def _on_cpu():
    with mx.cpu():
        yield


def _fresh(build):
    out = {}
    t = threading.Thread(target=lambda: out.setdefault("v", build()))
    t.start()
    t.join(timeout=120)
    assert not t.is_alive()
    return out["v"]


def _make_net_trainer(lr=0.05, seed=7):
    net = _fresh(lambda: gluon.nn.Dense(4, in_units=6, prefix="net_"))
    net.initialize(mx.init.Zero())
    r = np.random.RandomState(seed)
    for p in net.collect_params().values():
        p.set_data(r.randn(*p.shape).astype(np.float32) * 0.3)
    tr = gluon.Trainer(net.collect_params(), "adam", {"learning_rate": lr})
    return net, tr


def _step(net, tr, x, y, lossf):
    with autograd.record():
        loss = lossf(net(x), y)
    loss.backward()
    tr.step(x.shape[0])
    return float(loss.mean().asnumpy())


def _xy(seed=0):
    r = np.random.RandomState(seed)
    return (mx.nd.array(r.randn(8, 6).astype(np.float32)),
            mx.nd.array(r.randint(0, 4, (8,))))


def _state_bytes(trainer, path):
    trainer.save_states(str(path))
    with open(path, "rb") as f:
        return f.read()


def test_checkpoint_manager_roundtrip(tmp_path):
    net, tr = _make_net_trainer()
    x, y = mx.nd.ones((8, 6)), mx.nd.array(np.arange(8) % 4)
    lossf = gluon.loss.SoftmaxCrossEntropyLoss()
    _step(net, tr, x, y, lossf)
    mgr = mx.checkpoint.CheckpointManager(str(tmp_path / "ck"),
                                          max_to_keep=2)
    assert mgr.latest_step() is None
    assert mgr.save(0, net=net, trainer=tr,
                    extra={"epoch": mx.nd.array([3.0])})
    w0 = list(net.collect_params().values())[0].data().asnumpy().copy()
    _step(net, tr, x, y, lossf)
    step, extra = mgr.restore(net=net, trainer=tr)
    assert step == 0
    assert np.array_equal(
        list(net.collect_params().values())[0].data().asnumpy(), w0)
    assert float(extra["epoch"].asnumpy()[0]) == 3.0
    assert sorted(os.listdir(tmp_path / "ck" / "0")) == \
        ["extra.params", "params.params", "trainer.states"]
    with pytest.raises(mx.MXNetError, match="nothing to checkpoint"):
        mgr.save(1)
    assert not mgr.save(0, net=net)        # committed: not written again


def test_manifest_records_the_world_and_audits_a_resize(tmp_path):
    """The reference's manifest schema, written by a world of one; a step
    that a world of several processes committed is refused, and a
    manifest without the world record restores."""
    net, _ = _make_net_trainer()
    mgr = mx.checkpoint.CheckpointManager(str(tmp_path / "ck"))
    mgr.save(0, net=net)
    man_path = tmp_path / "ck" / "manifest.json"
    man = json.loads(man_path.read_text())
    assert man == {"committed": [0], "world": {"0": {"n": 1,
                                                     "sharded": False}}}
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert mgr.restore(net=net)[0] == 0
    for sharded in (False, True):
        man["world"]["0"] = {"n": 4, "sharded": sharded}
        man_path.write_text(json.dumps(man))
        with pytest.raises(MXNetError, match="world of 4 processes"):
            mgr.restore(0, net=net)
    del man["world"]
    man_path.write_text(json.dumps(man))
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert mgr.restore(net=net)[0] == 0


def test_kill_and_resume_reproduces_loss_curve(tmp_path):
    """Stop after 3 steps, resume with fresh objects: the joined curve is
    the unkilled one, bit for bit (weights, Adam's state and its counts)."""
    lossf = gluon.loss.SoftmaxCrossEntropyLoss()
    X, Y = _xy()
    total = 8
    net, tr = _make_net_trainer()
    ref = [_step(net, tr, X, Y, lossf) for _ in range(total)]
    ckdir = str(tmp_path / "resume")
    losses_a, losses_b = [], []
    state_a = _make_net_trainer()

    def run_a(step):
        losses_a.append(_step(*state_a, X, Y, lossf))
        return step < 2

    mx.checkpoint.auto_resume(run_a, ckdir, net=state_a[0],
                              trainer=state_a[1], save_every=1)
    state_b = _make_net_trainer(seed=11)    # other weights, overwritten

    def run_b(step):
        losses_b.append(_step(*state_b, X, Y, lossf))
        return step < total - 1

    last = mx.checkpoint.auto_resume(run_b, ckdir, net=state_b[0],
                                     trainer=state_b[1], save_every=1)
    assert last == total - 1
    assert losses_a + losses_b == ref


def test_max_to_keep_prunes_oldest_first(tmp_path):
    mgr = mx.checkpoint.CheckpointManager(str(tmp_path / "keep"),
                                          max_to_keep=2)
    for s in range(5):
        mgr.save(s, extra={"v": mx.nd.array([float(s)])})
    assert mgr.all_steps() == [3, 4]
    assert mgr.committed_steps() == [3, 4]
    assert mgr.latest_step() == 4
    step, extra = mgr.restore()
    assert step == 4 and float(extra["v"].asnumpy()[0]) == 4.0


def test_max_to_keep_defaults_to_the_config_key(tmp_path, monkeypatch):
    monkeypatch.setenv("MXNET_CHECKPOINT_KEEP", "2")
    mgr = mx.checkpoint.CheckpointManager(str(tmp_path / "k"))
    for s in range(4):
        mgr.save(s, extra={"v": mx.nd.array([float(s)])})
    assert mgr.all_steps() == [2, 3]
    monkeypatch.delenv("MXNET_CHECKPOINT_KEEP")
    assert mx.checkpoint.CheckpointManager(str(tmp_path / "d"))._keep == 3


def test_restore_falls_back_past_corrupted_latest(tmp_path):
    d = tmp_path / "corrupt"
    mgr = mx.checkpoint.CheckpointManager(str(d), max_to_keep=4)
    mgr.save(0, extra={"v": mx.nd.array([10.0])})
    mgr.save(1, extra={"v": mx.nd.array([11.0])})
    for f in (d / "1").iterdir():
        f.write_bytes(b"garbage")
    with pytest.warns(UserWarning, match="falling back"):
        step, extra = mgr.restore()
    assert step == 0
    assert float(extra["v"].asnumpy()[0]) == 10.0
    with pytest.raises(Exception):
        mgr.restore(step=1)


def test_uncommitted_step_is_invisible_and_replaced(tmp_path):
    """A step directory that never entered the manifest (a save killed
    before its commit) is not restored, and a later save of that step
    replaces it."""
    d = tmp_path / "orphan"
    mgr = mx.checkpoint.CheckpointManager(str(d))
    mgr.save(0, extra={"v": mx.nd.array([1.0])})
    (d / "1").mkdir()
    (d / "1" / "extra.params").write_bytes(b"half")
    assert mgr.committed_steps() == [0]
    assert mgr.restore()[0] == 0
    assert mgr.save(1, extra={"v": mx.nd.array([2.0])})
    assert float(mgr.restore()[1]["v"].asnumpy()[0]) == 2.0
    assert not [n for n in os.listdir(d) if ".tmp" in n]


def test_trainer_state_roundtrip_equality(tmp_path):
    lossf = gluon.loss.SoftmaxCrossEntropyLoss()
    X, Y = _xy(5)
    net, tr = _make_net_trainer()
    _step(net, tr, X, Y, lossf)
    _step(net, tr, X, Y, lossf)
    mgr = mx.checkpoint.CheckpointManager(str(tmp_path / "tr"))
    mgr.save(0, net=net, trainer=tr)
    want = _state_bytes(tr, tmp_path / "a")
    _step(net, tr, X, Y, lossf)
    assert _state_bytes(tr, tmp_path / "b") != want
    assert mgr.restore(net=net, trainer=tr)[0] == 0
    assert _state_bytes(tr, tmp_path / "c") == want


def test_sigterm_triggers_emergency_save_and_clean_stop(tmp_path):
    lossf = gluon.loss.SoftmaxCrossEntropyLoss()
    X, Y = _xy(3)
    net, tr = _make_net_trainer()
    ckdir = str(tmp_path / "sig")

    def run(step):
        _step(net, tr, X, Y, lossf)
        if step == 2:
            os.kill(os.getpid(), signal.SIGTERM)
        return step < 50

    prev = signal.getsignal(signal.SIGTERM)
    with pytest.warns(UserWarning, match="SIGTERM"):
        last = mx.checkpoint.auto_resume(run, ckdir, net=net, trainer=tr,
                                         save_every=10)
    assert last == 2
    assert mx.checkpoint.CheckpointManager(ckdir).latest_step() == 2
    assert signal.getsignal(signal.SIGTERM) == prev


def test_sigterm_during_fault_stops_without_replay(tmp_path):
    lossf = gluon.loss.SoftmaxCrossEntropyLoss()
    X, Y = mx.nd.ones((4, 6)), mx.nd.array(np.zeros(4))
    net, tr = _make_net_trainer()

    def run(step):
        if step == 0:
            _step(net, tr, X, Y, lossf)
            return True
        os.kill(os.getpid(), signal.SIGTERM)
        raise RuntimeError("collective died during preemption")

    with pytest.warns(UserWarning, match="without replay"):
        last = mx.checkpoint.auto_resume(run, str(tmp_path / "sf"), net=net,
                                         trainer=tr, save_every=1)
    assert last == 0


def test_restart_policy_replays_from_last_good(tmp_path):
    lossf = gluon.loss.SoftmaxCrossEntropyLoss()
    X, Y = _xy(1)
    net, tr = _make_net_trainer()
    steps_run = []

    def run(step):
        if step == 2 and steps_run.count(2) == 0:
            steps_run.append(step)
            raise RuntimeError("simulated worker fault")
        steps_run.append(step)
        _step(net, tr, X, Y, lossf)
        return step < 3

    with pytest.warns(UserWarning, match="resumed from checkpoint step 1"):
        last = mx.checkpoint.auto_resume(run, str(tmp_path / "rs"), net=net,
                                         trainer=tr, save_every=1)
    assert last == 3
    assert steps_run == [0, 1, 2, 2, 3]


def test_fault_before_first_checkpoint_reraises(tmp_path):
    def run(step):
        raise RuntimeError("dead on arrival")

    with pytest.raises(RuntimeError, match="dead on arrival"):
        mx.checkpoint.auto_resume(run, str(tmp_path / "doa"))


def test_restarts_are_bounded_and_policy_none_raises(tmp_path):
    net, tr = _make_net_trainer()
    lossf = gluon.loss.SoftmaxCrossEntropyLoss()
    X, Y = mx.nd.ones((4, 6)), mx.nd.array(np.zeros(4))
    for policy, d in (("restart", "bd"), ("none", "no")):
        calls = []

        def run(step):
            if step == 0 and not calls:
                calls.append("ok")
                _step(net, tr, X, Y, lossf)
                return True
            raise RuntimeError("permanent fault")

        with pytest.raises(RuntimeError, match="permanent fault"), \
                warnings.catch_warnings():
            warnings.simplefilter("ignore")
            mx.checkpoint.auto_resume(run, str(tmp_path / d), net=net,
                                      trainer=tr, save_every=1,
                                      max_restarts=2, resume_policy=policy)


# -- a BERT run interrupted and resumed, against the JAX package -----------

VOCAB, L, STEPS = 61, 32, 8


def _bert_weights(seed=4):
    """The 2-layer BERT's weights at 64 units, by the initializers'
    by-name policy, from numpy (both packages name them alike)."""
    net = _fresh(lambda: tbert.BERTModel(
        vocab_size=VOCAB, num_layers=2, units=64, hidden_size=256,
        num_heads=2, max_length=L, dropout=0.0, prefix="bert_"))
    r = np.random.RandomState(seed)
    out = {}
    for name, p in net.collect_params().items():
        w = r.normal(0.0, 0.02, p.shape).astype(np.float32)
        if name.endswith(("bias", "beta")):
            w[...] = 0.0
        elif name.endswith("gamma"):
            w[...] = 1.0
        out[name] = w
    return out


def _batches():
    """One batch each step (the loss must fall on it)."""
    r = np.random.RandomState(9)
    batch = (r.randint(0, VOCAB, (2, L)).astype(np.int32),
             r.randint(0, VOCAB, (2, L)).astype(np.int32))
    return [batch] * STEPS


def _bert_and_trainer(m, weights):
    bert = jbert if m is jmx else tbert
    net = _fresh(lambda: bert.BERTModel(
        vocab_size=VOCAB, num_layers=2, units=64, hidden_size=256,
        num_heads=2, max_length=L, dropout=0.0, prefix="bert_"))
    net.initialize(m.init.Zero())
    for k, p in net.collect_params().items():
        p.set_data(m.nd.array(weights[k]))
    net.hybridize()
    tr = m.gluon.Trainer(net.collect_params(), "adam",
                         {"learning_rate": 1e-2})
    return net, tr


def _bert_step(m, net, tr, batch):
    toks, labs = batch
    with m.autograd.record():
        loss = m.gluon.loss.SoftmaxCELoss()(net(m.nd.array(toks))[2],
                                            m.nd.array(labs))
    loss.backward()
    tr.step(toks.shape[0])
    return float(loss.mean().asnumpy())


@pytest.fixture(scope="module")
def bert_curves():
    """(weights, the JAX package's 8-step curve, the port's)."""
    weights = _bert_weights()
    batches = _batches()
    curves = {}
    with mx.cpu():
        for m in (jmx, mx):
            net, tr = _bert_and_trainer(m, weights)
            curves[m] = [_bert_step(m, net, tr, b) for b in batches]
    return weights, curves[jmx], curves[mx]


def test_uninterrupted_bert_curve_matches_the_reference(bert_curves):
    _, want, got = bert_curves
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert got[-1] < got[0]


def test_bert_resumed_after_a_raised_fault(bert_curves, tmp_path):
    """``auto_resume(save_every=2)``; ``train_fn`` raises once at step 5:
    step 4 restores and 5-7 replay.  The curve of the steps that
    completed is the uninterrupted one."""
    weights, want, ref = bert_curves
    batches = _batches()
    net, tr = _bert_and_trainer(mx, weights)
    curve, faulted = {}, []

    def train_fn(step):
        if step == 5 and not faulted:
            faulted.append(step)
            _bert_step(mx, net, tr, batches[step])   # half-done step
            raise RuntimeError("device fault")
        curve[step] = _bert_step(mx, net, tr, batches[step])
        return step < STEPS - 1

    with pytest.warns(UserWarning, match="resumed from checkpoint step 4"):
        last = mx.checkpoint.auto_resume(train_fn, str(tmp_path / "ck"),
                                         net=net, trainer=tr, save_every=2,
                                         max_to_keep=2)
    assert last == STEPS - 1
    got = [curve[s] for s in range(STEPS)]
    assert got == ref
    np.testing.assert_allclose(got, want, rtol=1e-4)


def test_bert_resumed_after_sigterm_with_fresh_objects(bert_curves,
                                                       tmp_path):
    """A run that sends itself SIGTERM during step 3 saves after it and
    returns; a fresh net and trainer resume from the directory.  The
    joined curve is the uninterrupted one."""
    weights, want, ref = bert_curves
    batches = _batches()
    ckdir = str(tmp_path / "ck")
    curve = {}

    def make_fn(net, tr, kill_at=None):
        def train_fn(step):
            curve[step] = _bert_step(mx, net, tr, batches[step])
            if step == kill_at:
                os.kill(os.getpid(), signal.SIGTERM)
            return step < STEPS - 1
        return train_fn

    net, tr = _bert_and_trainer(mx, weights)
    with pytest.warns(UserWarning, match="SIGTERM"):
        assert mx.checkpoint.auto_resume(make_fn(net, tr, kill_at=3), ckdir,
                                         net=net, trainer=tr,
                                         save_every=100) == 3
    other = {k: v * 0.5 for k, v in weights.items()}
    net2, tr2 = _bert_and_trainer(mx, other)
    assert mx.checkpoint.auto_resume(make_fn(net2, tr2), ckdir, net=net2,
                                     trainer=tr2, save_every=100) == \
        STEPS - 1
    got = [curve[s] for s in range(STEPS)]
    assert got == ref
    np.testing.assert_allclose(got, want, rtol=1e-4)
