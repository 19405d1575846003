"""The port's telemetry (``metrics`` and ``tracer``) held against the JAX
package's: the same sequence of counter, gauge and histogram calls, each
on a fresh registry, gives byte-identical Prometheus text and JSON; the
span tracer records the same events (names, categories, phases, ids,
arguments; timestamps aside) and renders the same Chrome-trace layout.
"""

import json

import pytest

from mxnet_tpu.telemetry import metrics as jmetrics
from mxnet_tpu.telemetry import tracer as jtracer

from mxnet_tpu_torch import telemetry as ttel
from mxnet_tpu_torch.telemetry import metrics as tmetrics
from mxnet_tpu_torch.telemetry import tracer as ttracer


def _drive(mod):
    reg = mod.MetricsRegistry()
    c = reg.counter("mxnet_serving_tokens_total", "Generated tokens.")
    c.inc()
    c.inc(41)
    reg.counter("mxnet_router_replica_up", "Up.",
                labels={"replica": "1"}).inc(3)
    reg.counter("mxnet_router_replica_up", "Up.",
                labels={"replica": "0"}).inc()
    g = reg.gauge("mxnet_serving_queue_depth", "Waiting requests.")
    g.set(7)
    g.inc(2.5)
    g.dec()
    reg.gauge("odd_labels", "", labels={"q": 'a"b\\c\nd', "k": 2}).set(-1)
    h = reg.histogram("mxnet_serving_ttft_seconds", "Submit -> first.")
    for v in (0.0, 1e-5, 3e-4, 0.02, 0.5, 3.0, 12.0, float("inf")):
        h.observe(v)
    h2 = reg.histogram("mxnet_serving_accepted_draft_tokens", "Accepted.",
                       buckets=(0, 1, 2, 3, 4, 6, 8, 12, 16, float("inf")))
    for v in (0, 3, 3, 1, 17):
        h2.observe(v)
    reg.histogram("mxnet_empty_seconds", "Nothing observed.")
    return reg


def test_prometheus_and_json_exports_byte_equal():
    jreg, treg = _drive(jmetrics), _drive(tmetrics)
    assert treg.to_prometheus() == jreg.to_prometheus()
    assert treg.to_json() == jreg.to_json()
    assert treg.to_json(indent=2) == jreg.to_json(indent=2)
    assert treg.export_state() == jreg.export_state()
    text = treg.to_prometheus()
    assert 'mxnet_serving_ttft_seconds_bucket{le="+Inf"} 8' in text
    assert r'q="a\"b\\c\nd"' in text
    treg.reset()
    jreg.reset()
    assert treg.to_prometheus() == jreg.to_prometheus()


def test_registry_errors_match():
    for mod in (jmetrics, tmetrics):
        reg = mod.MetricsRegistry()
        reg.counter("x_total")
        with pytest.raises(TypeError, match="already registered as"):
            reg.gauge("x_total")
        reg.histogram("h_seconds", buckets=(1, 2))
        with pytest.raises(ValueError, match="already registered with"):
            reg.histogram("h_seconds", buckets=(1, 3))
        with pytest.raises(ValueError, match="only go up"):
            reg.counter("y_total").inc(-1)
        with pytest.raises(ValueError, match="finite bucket"):
            reg.histogram("z", buckets=(float("inf"),))


def _events(mod):
    tr = mod.Tracer(capacity=4)
    tr.set_process_label("proc")
    tr.add_event("a", "serving", 100, 2100, {"rid": 3})
    tr.add_instant("chaos.exit", "resilience", {"site": "s"})
    tr.add_async("request", "serving.request", "b", 7, {"n": 1})
    tr.add_async("request", "serving.request", "e", 7)
    tr.add_event("b", "serving", 0, 1)     # ring of 4: drops "a"
    trace = tr.chrome_trace()
    evs = [{k: v for k, v in e.items() if k not in ("ts", "pid", "tid")}
           for e in trace["traceEvents"]]
    return evs, trace.get("otherData"), trace["displayTimeUnit"], \
        tr.dropped, tr.capacity


def test_tracer_events_and_chrome_trace_layout_match():
    assert _events(ttracer) == _events(jtracer)
    evs = _events(ttracer)[0]
    assert evs[0] == {"name": "process_name", "ph": "M",
                      "args": {"name": "proc"}}


def test_span_gating_and_module_api():
    was = ttel.enabled()
    ttel.disable()
    try:
        assert ttel.span("x") is ttel.NULL_SPAN
        ttel.enable()
        ttel.clear()
        with ttel.span("step", "trainer", batch=4) as sp:
            sp.set(extra=1)
        ttel.instant("mark", "host", k=1)
        ttel.async_event("request", "serving.request", "b", 9, n=2)
        evs = ttel.get_tracer().events()
        assert [(e["name"], e["ph"], e.get("args")) for e in evs] == [
            ("step", "X", {"batch": 4, "extra": 1}),
            ("mark", "i", {"k": 1}),
            ("request", "b", {"n": 2})]
        assert sp.duration_s >= 0.0
        trace = ttel.chrome_trace()
        json.dumps(trace)                   # plain JSON-serializable dict
        assert trace["traceEvents"][0]["args"]["name"] \
            == ttel.get_tracer().process_label
    finally:
        ttel.clear()
        if not was:
            ttel.disable()
