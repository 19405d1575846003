"""The port's live scrape plane (``telemetry.httpd``) on the CPU:
``/metrics`` is byte-equal to ``telemetry.to_prometheus()`` under
concurrent scrapes, ``/healthz`` answers 200 and then 503 once the
heartbeat goes stale, ``/statusz`` and ``/ledger.json`` carry the step
clock and the cost ledger, unknown paths give 404, and ``stop`` releases
the server (each test stops what it starts).
"""

import json
import os
import threading
import time
import urllib.error
import urllib.request

import pytest
import torch

from mxnet_tpu_torch import telemetry
from mxnet_tpu_torch.resilience import heartbeat as hb
from mxnet_tpu_torch.telemetry import costmodel, httpd


@pytest.fixture
def server():
    port = httpd.start(port=0, host="127.0.0.1")
    yield port
    httpd.stop()
    assert not httpd.running()


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=10) as r:
        return r.status, r.headers.get("Content-Type"), r.read().decode()


def test_metrics_byte_equal_under_concurrent_scrapes(server):
    telemetry.counter("mxnet_test_httpd_total", "t").inc(7)
    want = telemetry.to_prometheus()
    results, errors = [], []

    def scrape():
        try:
            results.append(_get(server, "/metrics"))
        except Exception as e:  # noqa: BLE001
            errors.append(e)

    threads = [threading.Thread(target=scrape) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not errors and len(results) == 8
    for status, ctype, body in results:
        assert status == 200 and ctype.startswith("text/plain")
        assert body == want
    assert "mxnet_test_httpd_total 7" in want


def test_healthz_200_then_503(server, monkeypatch, tmp_path):
    status, ctype, body = _get(server, "/healthz")
    rec = json.loads(body)
    assert status == 200 and ctype == "application/json"
    assert rec["ok"] and not rec["armed"]
    monkeypatch.setenv("MXNET_ELASTIC_HEARTBEAT_DIR", str(tmp_path))
    monkeypatch.setattr(hb, "_phase", hb._phase)
    monkeypatch.setattr(hb, "_step", hb._step)
    monkeypatch.setattr(hb, "_error", hb._error)
    try:
        assert hb.start(interval_s=600)
        status, _c, body = _get(server, "/healthz")
        rec = json.loads(body)
        assert status == 200 and rec["ok"] and rec["armed"]
        assert rec["heartbeat_age_s"] < 30
        monkeypatch.setattr(hb, "_last_beat", time.monotonic() - 10_000)
        with pytest.raises(urllib.error.HTTPError) as ei:
            _get(server, "/healthz")
        assert ei.value.code == 503
        stale = json.loads(ei.value.read())
        assert not stale["ok"] and stale["heartbeat_age_s"] > 100
    finally:
        hb.stop()


def test_statusz_and_ledger(server):
    costmodel.LEDGER.clear()
    costmodel.arm()
    try:
        costmodel.wrap(lambda x: x @ x, "t.http")(torch.ones(4, 4))
        status, ctype, body = _get(server, "/statusz")
        s = json.loads(body)
        assert status == 200 and ctype == "application/json"
        assert s["pid"] == os.getpid() and s["costmodel_armed"] is True
        assert s["stepclock"]["verdict"] \
            == telemetry.STEP_CLOCK.verdict()
        assert "MXNET_TELEMETRY_PORT" in s["knobs"]
        assert {"rank", "world", "telemetry_enabled", "serving"} <= set(s)
        _s, _c, body = _get(server, "/ledger.json")
        led = json.loads(body)
        assert [e["site"] for e in led["costmodel"]["entries"]] \
            == ["t.http"]
        assert led["costmodel_sites"]["t.http"]["flops"] == 2 * 4 ** 3
        assert "ops" in led
    finally:
        costmodel.disarm()
        costmodel.LEDGER.clear()
    _s, _c, body = _get(server, "/")
    assert "/metrics" in body and "/healthz" in body


def test_unknown_path_404_and_stop():
    port = httpd.start(port=0, host="127.0.0.1")
    try:
        assert httpd.running() and httpd.port() == port
        assert httpd.start() == port               # idempotent
        with pytest.raises(RuntimeError, match="already serving"):
            httpd.start(port=port + 1 if port < 65535 else port - 1)
        # the perf gate's live delta answers against the committed host
        # baseline
        status, ctype, body = _get(port, "/perfgate.json")
        assert status == 200 and ctype == "application/json"
        assert json.loads(body)["baseline_path"].endswith(
            "perf_baseline_torch.json")
        with pytest.raises(urllib.error.HTTPError) as ei:
            _get(port, "/no-such-endpoint")
        assert ei.value.code == 404
    finally:
        httpd.stop()
    assert not httpd.running() and httpd.port() is None
    httpd.stop()
