"""The port's step clock (``telemetry.stepclock``) held against the JAX
package's, and wired through the port's ``gluon.Trainer``,
``DataLoader`` and ``parallel.TrainStep`` on the CPU.

The same notes under one scripted clock give equal summaries and equal
``report()`` text in both packages.  A Trainer and DataLoader loop whose
input dominates by a margin the test measures comes out ``input-bound``
(the reference's own verdict test assumes its sleep outweighs the step;
here the sleep is sized from a measured step first); a store whose
reduction is slowed comes out ``comms-bound``; each TrainStep call is one
step whose phases sum to its total.
"""

import time

import numpy as np
import pytest

from mxnet_tpu.telemetry import metrics as jmetrics
from mxnet_tpu.telemetry import stepclock as jsc

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import autograd, gluon, parallel, telemetry
from mxnet_tpu_torch.telemetry import metrics as tmetrics
from mxnet_tpu_torch.telemetry import stepclock as tsc


@pytest.fixture(autouse=True)
def _clean():
    """Telemetry off, the step clock empty, the CPU the context."""
    def reset():
        telemetry.disable()
        telemetry.clear()
    reset()
    with mx.cpu():
        yield
    reset()


class _Clock:
    """A scripted ``time`` module: ``perf_counter`` returns ``now``."""

    def __init__(self):
        self.now = 100.0

    def perf_counter(self):
        return self.now


def _script(mod, clock, window):
    """One fixed sequence of notes and steps on a fresh StepClock."""
    c = mod.StepClock(window=window)
    c.note("data_wait", 0.05)               # between steps: pending
    c.begin_step()
    clock.now += 0.01
    c.note("comms", 0.002)
    c.note("optimizer", 0.003)
    c.end_step()
    clock.now += 0.004                      # the gap: compute
    c.begin_step()
    clock.now += 0.02
    with c.phase("h2d"):
        clock.now += 0.001
    c.note("data_wait", 0.5)
    c.end_step()
    c.begin_step()                          # abandoned (amp overflow)
    c.begin_step()
    clock.now += 0.03
    c.note("comms", 0.02)
    c.end_step()
    c.end_step()                            # double end: no-op
    with pytest.raises(ValueError, match="unknown step phase"):
        c.note("warp", 1.0)
    return c


@pytest.mark.parametrize("window", [8, 2])
def test_summaries_and_report_equal_reference(monkeypatch, window):
    clocks = {}
    for mod in (jsc, tsc):
        clocks[mod] = _Clock()
        monkeypatch.setattr(mod, "time", clocks[mod])
    j = _script(jsc, clocks[jsc], window)
    t = _script(tsc, clocks[tsc], window)
    assert t.summary() == j.summary()
    assert t.steps == j.steps == min(window, 3)
    jreg, treg = jmetrics.MetricsRegistry(), tmetrics.MetricsRegistry()
    for reg in (jreg, treg):
        reg.counter("mxnet_trainer_steps_total").inc(3)
        reg.counter("mxnet_op_dispatch_total").inc(0)
    assert tsc.report(clock=t, registry=treg) \
        == jsc.report(clock=j, registry=jreg)
    s = t.summary()
    for rec in t._window:
        assert sum(rec[p] for p in tsc.PHASES) == pytest.approx(rec["total"])
    assert s["verdict"] == "input-bound"
    assert tsc.report(clock=tsc.StepClock(), registry=treg) \
        == jsc.report(clock=jsc.StepClock(), registry=jreg)
    assert (tsc.PHASES, tsc.VERDICT_GROUPS) \
        == (jsc.PHASES, jsc.VERDICT_GROUPS)


def _loop(sleep_s, steps=4):
    """A Trainer + DataLoader loop on a small Dense net; returns the step
    clock's summary."""
    class SlowDS(gluon.data.ArrayDataset):
        def __getitem__(self, idx):
            if sleep_s:
                time.sleep(sleep_s)
            return super().__getitem__(idx)

    r = np.random.RandomState(0)
    ds = SlowDS(mx.nd.array(r.randn(4 * steps, 3).astype(np.float32)))
    net = gluon.nn.Dense(2, in_units=3)
    net.initialize(ctx=mx.cpu())
    tr = gluon.Trainer(net.collect_params(), "sgd", {"learning_rate": 0.1})
    telemetry.clear()
    telemetry.enable()
    for x in gluon.data.DataLoader(ds, batch_size=4):
        with autograd.record():
            loss = (net(x) ** 2).sum()
        loss.backward()
        tr.step(4)
    telemetry.disable()
    return telemetry.STEP_CLOCK.summary()


def test_dataloader_loop_is_input_bound_by_a_measured_margin():
    base = _loop(0.0)
    assert base["steps"] == 4
    step_s = base["phases"]["total"]["median"]
    # each batch's 4 samples sleep 5 steps' worth in all
    per_item = max(2e-3, 5 * step_s / 4)
    h = telemetry.REGISTRY.get("mxnet_step_phase_seconds",
                               labels={"phase": "data_wait"})
    before = h.count
    s = _loop(per_item)
    ph = s["phases"]
    assert ph["data_wait"]["median"] >= 4 * per_item
    margin = ph["data_wait"]["median"] / (ph["compute"]["median"]
                                          + ph["optimizer"]["median"])
    assert margin > 2, (margin, s)
    assert s["verdict"] == "input-bound"
    rep = telemetry.report()
    assert "verdict: input-bound" in rep and "data_wait" in rep
    assert "mxnet_trainer_steps_total" in rep
    assert h.count - before == 4


def test_slow_reduction_is_comms_bound():
    kv = mx.kv.create("local")
    orig = kv.pushpull_list

    def slow(*a, **kw):
        time.sleep(0.02)
        return orig(*a, **kw)

    kv.pushpull_list = slow
    net = gluon.nn.Dense(2, in_units=3)
    net.initialize(ctx=mx.cpu())
    tr = gluon.Trainer(net.collect_params(), "sgd", {"learning_rate": 0.1},
                       kvstore=kv)
    x = mx.nd.array(np.ones((2, 3), np.float32))
    telemetry.enable()
    for _ in range(3):
        with autograd.record():
            loss = (net(x) ** 2).sum()
        loss.backward()
        tr.step(2)
    s = telemetry.STEP_CLOCK.summary()
    assert s["verdict"] == "comms-bound", s
    assert s["phases"]["comms"]["median"] >= 0.02
    assert s["phases"]["optimizer"]["median"] > 0
    assert "verdict: comms-bound" in telemetry.report()


def test_trainstep_steps_sum_to_their_totals():
    net = gluon.nn.Dense(4, in_units=8)
    net.initialize(ctx=mx.cpu())
    step = parallel.TrainStep(net, lambda o, l: ((o - l) ** 2).mean(),
                              "sgd", optimizer_params={"learning_rate": 0.1})
    r = np.random.RandomState(1)
    d = r.randn(8, 8).astype(np.float32)
    l = r.randn(8, 4).astype(np.float32)
    disp = telemetry.REGISTRY.get("mxnet_sharding_step_dispatches_total")
    retr = telemetry.REGISTRY.get("mxnet_sharding_retraces_total")
    n0, r0 = disp.value, retr.value
    step(d, l)                              # disabled: no step recorded
    telemetry.enable()
    for _ in range(5):
        step(d, l)
    assert telemetry.STEP_CLOCK.steps == 5
    for rec in telemetry.STEP_CLOCK._window:
        assert sum(rec[p] for p in tsc.PHASES) == pytest.approx(rec["total"])
        assert rec["compute"] > 0
    assert disp.value - n0 == 5 and retr.value - r0 == 0
    step(d[:4], l[:4])                      # a new signature
    assert retr.value - r0 == 1
