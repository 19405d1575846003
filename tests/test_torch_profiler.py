"""``mx.profiler`` of the port (over ``telemetry`` and ``torch.profiler``)
held against the JAX package's facade on the CPU: the same ``record_op``
sequence renders the same ``dumps`` table and JSON; ``set_config``'s
``aggregate_stats``; the state discipline (``pause`` keeps the device
trace open, ``stop`` closes and exports it, ``start`` does not take over
telemetry that the user turned on); ``dump``'s Chrome trace; scopes,
tasks and markers.
"""

import json
import os

import pytest

from mxnet_tpu import profiler as jprof
from mxnet_tpu import telemetry as jtel

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import profiler as tprof
from mxnet_tpu_torch import telemetry as ttel


@pytest.fixture(autouse=True)
def _clean():
    """Both facades stopped with their default config, both ledgers empty
    and accumulating, telemetry as it was."""
    saved = [(dict(p._state), t.enabled()) for p, t in
             ((jprof, jtel), (tprof, ttel))]
    for p in (jprof, tprof):
        p._state["running"] = False
    for t in (jtel, ttel):
        t.ledger.clear()
    yield
    for (state, on), p, t in zip(saved, (jprof, tprof), (jtel, ttel)):
        if p is tprof and p._state["device_trace"]:
            p._state["profile"].stop()
        p._state.clear()
        p._state.update(state)
        t.ledger.clear()
        t.ledger.set_aggregate_stats(True)
        (t.enable if on else t.disable)()


SEQUENCE = [("dot", 0.002), ("FullyConnected", 0.0005), ("dot", 0.004),
            ("scope:fwd", 0.0125), ("relu", 1e-6), ("dot", 0.001),
            ("task:load", 0.25), ("marker:m", 0.0)]


@pytest.mark.parametrize("fmt", ["table", "json"])
def test_dumps_equal_reference(fmt):
    for p in (jprof, tprof):
        for name, secs in SEQUENCE:
            p.record_op(name, secs)
    assert tprof.dumps(format=fmt) == jprof.dumps(format=fmt)
    assert tprof.dumps(reset=True, format=fmt) \
        == jprof.dumps(reset=True, format=fmt)
    assert tprof.dumps(format=fmt) == jprof.dumps(format=fmt)   # emptied
    for p in (jprof, tprof):
        with pytest.raises(Exception, match="unknown dumps format"):
            p.dumps(format="xml")


def test_aggregate_stats_off_skips_the_ledger(tmp_path):
    for p in (jprof, tprof):
        p.set_config(filename=str(tmp_path / "p.json"),
                     aggregate_stats=False)
        p.record_op("dot", 1.0)
    assert tprof.dumps() == jprof.dumps()
    assert "dot" not in tprof.dumps()


def test_state_discipline_and_device_trace(tmp_path):
    tprof.set_config(filename=str(tmp_path / "prof.json"))
    ttel.disable()
    tprof.start()
    assert tprof.is_running() and ttel.enabled()
    assert tprof._state["device_trace"]
    with mx.cpu():
        a = mx.nd.ones((8, 8))
        with tprof.scope("fwd"):
            mx.nd.dot(a, a)
        tprof.pause()
        assert not tprof.is_running() and not ttel.enabled()
        assert tprof._state["device_trace"]          # still open
        mx.nd.dot(a, a)                              # not recorded
        tprof.resume()
        assert ttel.enabled()
        tprof.Marker("m").mark()
        task = tprof.Task("load")
        task.start()
        task.stop()
    tprof.stop()
    assert not ttel.enabled() and not tprof._state["device_trace"]
    path = tprof.device_trace_path()
    assert path == str(tmp_path / "prof_torch_trace" / "device_trace.json")
    with open(path) as f:
        dev = json.load(f)
    names = {e.get("name") for e in dev["traceEvents"]}
    assert "fwd" in names and any("mm" in str(n) for n in names)
    rows = json.loads(tprof.dumps(format="json"))
    assert rows["dot"]["calls"] == 1 and rows["scope:fwd"]["calls"] == 1
    assert {"marker:m", "task:load"} <= set(rows)
    tprof.dump()
    with open(tmp_path / "prof.json") as f:
        trace = json.load(f)
    assert trace["otherData"]["opAggregates"]["dot"]["calls"] == 1
    assert any(e.get("name") == "scope:fwd" for e in trace["traceEvents"])


def test_start_keeps_user_telemetry(tmp_path):
    tprof.set_config(filename=str(tmp_path / "p.json"))
    ttel.enable()
    tprof.set_state("run")
    tprof.set_state("stop")
    assert ttel.enabled()
    assert os.path.exists(tprof.device_trace_path())


def test_scope_is_a_noop_when_stopped_and_counter():
    ttel.disable()
    with tprof.scope("idle"):
        pass
    assert "scope:idle" not in tprof.dumps()
    c = tprof.Counter("c", value=2)
    c += 3
    c -= 1
    c.increment()
    c.set_value(c.value * 2)
    assert c.value == 10
    assert tprof.Frame is tprof.Task
