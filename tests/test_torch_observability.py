"""The port's job-wide observability plane held against the JAX
package's: cross-process aggregation (shards cross between the packages
and merge to the same bytes), the flight recorder (the same dump keys;
dumps on an unhandled exception, a chaos exit, a deadline and SIGUSR2 in
child processes), the decode pool's counter shipping, and the metric
catalog (every metric the reference registers in a module the port has
is registered by the port with the same name, type, help and labels).
"""

import ast
import json
import os
import subprocess
import sys

import pytest

from mxnet_tpu import telemetry as jtel
from mxnet_tpu.telemetry import aggregate as jagg
from mxnet_tpu.telemetry import flightrec as jfr

from mxnet_tpu_torch import telemetry as ttel
from mxnet_tpu_torch.telemetry import aggregate as tagg
from mxnet_tpu_torch.telemetry import flightrec as tfr

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _clean():
    """Both packages' tracer, rank and label as a fresh process has
    them."""
    saved = [(m.tracer.enabled(), m.get_tracer().process_label)
             for m in (jtel, ttel)]

    def reset():
        for m, agg, (_on, label) in zip((jtel, ttel), (jagg, tagg), saved):
            m.disable()
            m.clear()
            agg.set_rank(None)
            m.get_tracer().set_process_label(label)
    reset()
    yield
    reset()
    for m, (on, _label) in zip((jtel, ttel), saved):
        if on:
            m.enable()


def _dump_json(obj):
    return json.dumps(obj, sort_keys=True)


# -- aggregation -----------------------------------------------------------------

def _export(tel, agg, rank, directory, n):
    tel.clear()
    tel.enable()
    agg.set_rank(rank)
    with tel.span(f"work{rank}", "test", k=rank):
        pass
    tel.counter("t_agg_total", "Shipped.").inc(n)
    tel.histogram("t_agg_seconds", "Spans.", buckets=(0.5, 1.0)).observe(
        0.25 * n)
    tel.gauge("t_agg_depth", "Depth.").set(n)
    path = agg.export_snapshot(directory=directory)
    tel.disable()
    return path


def test_shards_cross_between_packages(tmp_path):
    d = str(tmp_path)
    tp = _export(ttel, tagg, 0, d, 3)
    jp = _export(jtel, jagg, 1, d, 2)
    _export(ttel, tagg, 2, d, 5)
    assert os.path.basename(tp).startswith("telemetry-rank00000-")
    assert os.path.basename(jp).startswith("telemetry-rank00001-")
    tsnaps, jsnaps = tagg.load_snapshots(d), jagg.load_snapshots(d)
    assert tsnaps == jsnaps and [s["rank"] for s in tsnaps] == [0, 1, 2]
    assert set(tsnaps[0]) == set(jsnaps[1])     # one wire format
    # the same shards merge to the same bytes in either package
    ttrace, jtrace = tagg.merged_chrome_trace(tsnaps), \
        jagg.merged_chrome_trace(jsnaps)
    assert _dump_json(ttrace) == _dump_json(jtrace)
    assert tagg.merged_prometheus(tsnaps) == jagg.merged_prometheus(jsnaps)
    # each merged counter is the sum over the shards
    prom = tagg.merged_prometheus(directory=d)
    total = sum(m["value"] for snap in tsnaps for m in snap["metrics"]
                if m["name"] == "t_agg_total")
    observed = sum(m["count"] for snap in tsnaps for m in snap["metrics"]
                   if m["name"] == "t_agg_seconds")
    assert f"t_agg_total {total}" in prom
    assert f't_agg_seconds_bucket{{le="+Inf"}} {observed}' in prom
    spans = [e for e in ttrace["traceEvents"] if e.get("ph") == "X"]
    assert {(e["name"], e["pid"]) for e in spans} \
        == {("work0", 0), ("work1", 1), ("work2", 2)}
    labels = {e["pid"]: e["args"]["name"] for e in ttrace["traceEvents"]
              if e["name"] == "process_name"}
    assert labels == {0: "mxnet_tpu_torch rank 0", 1: "mxnet_tpu rank 1",
                      2: "mxnet_tpu_torch rank 2"}


def test_port_shards_alone_merge_equal_and_corrupt_ones_skip(tmp_path):
    d = str(tmp_path)
    for r in (0, 1):
        _export(ttel, tagg, r, d, r + 1)
    with open(tmp_path / "telemetry-rank00009-pid1.json", "w") as f:
        f.write("{ truncated")
    snaps = tagg.load_snapshots(d)
    assert [s["rank"] for s in snaps] == [0, 1]
    assert _dump_json(tagg.merged_chrome_trace(snaps)) \
        == _dump_json(jagg.merged_chrome_trace(snaps))
    assert tagg.merged_prometheus(snaps) == jagg.merged_prometheus(snaps)
    snap = snaps[0]
    assert snap["stepclock"]["verdict"] == "idle"
    assert snap["costmodel"] == {"entries": [], "calls": {}}


def test_counter_deltas_ship_and_absorb():
    c = ttel.counter("t_ship_total")
    c.inc(5)
    assert [d for d in tagg.counter_deltas() if d[0] == "t_ship_total"] \
        == [("t_ship_total", {}, 5)]
    assert not [d for d in tagg.counter_deltas() if d[0] == "t_ship_total"]
    c.inc(2)
    assert [d[2] for d in tagg.counter_deltas()
            if d[0] == "t_ship_total"] == [2]
    before = ttel.counter("t_absorb_total").value
    tagg.absorb_counter_deltas([("t_absorb_total", {}, 3)])
    assert ttel.counter("t_absorb_total").value == before + 3


# -- the flight recorder ------------------------------------------------------------

def test_dump_keys_equal_reference(tmp_path, monkeypatch):
    monkeypatch.setenv("MXNET_FLIGHTREC_DIR", str(tmp_path))
    try:
        raise RuntimeError("synthetic")
    except RuntimeError as e:
        trec, jrec = tfr._record("t.reason", exc=e), \
            jfr._record("t.reason", exc=e)
    assert set(trec) == set(jrec)
    assert set(trec["exception"]) == set(jrec["exception"])
    assert set(trec["chaos"]) == set(jrec["chaos"])
    tfr._reset_dump_cap_for_test()
    ttel.enable()
    with ttel.span("pre-crash", "test"):
        pass
    tfr.note("about_to_die", step=3)
    path = tfr.dump("t.reason")
    with open(path) as f:
        rec = json.load(f)
    assert os.path.basename(path).startswith("flightrec-rank00000-")
    assert any(e["name"] == "pre-crash" for e in rec["spans"])
    assert any(c["event"] == "about_to_die" for c in rec["breadcrumbs"])
    assert "MXNET_FLIGHTREC_DIR" in rec["config"]
    monkeypatch.setenv("MXNET_FLIGHTREC_MAX_DUMPS", "1")
    assert tfr.dump("capped") is None
    monkeypatch.setenv("MXNET_FLIGHTREC", "0")
    tfr._reset_dump_cap_for_test()
    assert tfr.dump("off") is None
    tfr._reset_dump_cap_for_test()


def _child(code, tmp_path, env=None, timeout=60):
    full = {**os.environ, "MXNET_FLIGHTREC_DIR": str(tmp_path),
            **(env or {})}
    return subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=timeout,
                          env=full)


def _dumps(d):
    return sorted(f for f in os.listdir(d)
                  if f.startswith("flightrec-") and f.endswith(".json"))


def _load(d, name):
    with open(os.path.join(d, name)) as f:
        return json.load(f)


def test_unhandled_exception_dumps_and_chains(tmp_path):
    res = _child("import mxnet_tpu_torch\nraise RuntimeError('lane death')",
                 tmp_path)
    assert res.returncode == 1
    assert "lane death" in res.stderr          # the default hook still ran
    dumps = _dumps(tmp_path)
    assert len(dumps) == 1 and "exception.RuntimeError" in dumps[0]
    assert _load(tmp_path, dumps[0])["exception"]["message"] == "lane death"


def test_chaos_exit_dumps_and_exports_the_shard(tmp_path):
    code = """
from mxnet_tpu_torch import telemetry
from mxnet_tpu_torch.resilience import chaos
telemetry.enable()
with telemetry.span('doomed-work', 'test'):
    pass
chaos.inject('trainer.step', kind='exit', times=1)
chaos.hit('trainer.step')
raise AssertionError('unreachable')
"""
    res = _child(code, tmp_path, {"MXNET_TELEMETRY_DIR": str(tmp_path)})
    assert res.returncode == 1, res.stderr[-500:]
    dumps = _dumps(tmp_path)
    assert len(dumps) == 1 and "chaos.exit.trainer.step" in dumps[0]
    rec = _load(tmp_path, dumps[0])
    assert any(e["name"] == "doomed-work" for e in rec["spans"])
    assert rec["chaos"]["faults_fired"] == 1
    assert rec["chaos"]["armed_sites"] == ["trainer.step"]
    snaps = tagg.load_snapshots(str(tmp_path))
    assert len(snaps) == 1
    assert any(e["name"] == "doomed-work" for e in snaps[0]["events"])


def test_deadline_dumps(tmp_path):
    code = """
import time
from mxnet_tpu_torch.resilience import Deadline, KVStoreTimeoutError
try:
    Deadline(timeout_s=0.05, site='test.site').call(time.sleep, 5)
except KVStoreTimeoutError:
    print('timed out')
"""
    res = _child(code, tmp_path)
    assert res.returncode == 0 and "timed out" in res.stdout, res.stderr
    dumps = _dumps(tmp_path)
    assert len(dumps) == 1 and "deadline.test.site" in dumps[0]


def test_sigusr2_dumps_and_keeps_running(tmp_path):
    code = """
import os, signal, time
import mxnet_tpu_torch
os.kill(os.getpid(), signal.SIGUSR2)
end = time.time() + 10
while time.time() < end and not [
        f for f in os.listdir(os.environ['MXNET_FLIGHTREC_DIR'])
        if f.endswith('sigusr2.json')]:
    time.sleep(0.01)
print('alive')
"""
    res = _child(code, tmp_path)
    assert res.returncode == 0 and "alive" in res.stdout, res.stderr
    dumps = _dumps(tmp_path)
    assert len(dumps) == 1 and "sigusr2" in dumps[0]


# -- the metric catalog --------------------------------------------------------------

# metrics that only modules the port does not have yet register
UNPORTED = {
    "resilience/controller.py": "A.9 (ElasticController)",
}
UNPORTED_METRICS = {
    "mxnet_controller_restarts_total": "A.9 (ElasticController)",
    "mxnet_controller_resizes_total": "A.9 (ElasticController)",
    "mxnet_controller_worker_failures_total": "A.9 (ElasticController)",
    "mxnet_controller_hangs_total": "A.9 (ElasticController)",
    "mxnet_controller_stragglers_total": "A.9 (ElasticController)",
    "mxnet_controller_world_size": "A.9 (ElasticController)",
    "mxnet_controller_live_workers": "A.9 (ElasticController)",
    "mxnet_controller_heartbeat_age_seconds": "A.9 (ElasticController)",
}


# help texts the port words otherwise: the reference's names the issue
# that added the metric
HELP_DIFFERS = {
    "mxnet_kvstore_fused_bucket_errors_total": (
        "Fused buckets whose executable FAILED and were replayed through "
        "the per-key path (graceful degradation — distinct from the planned "
        "fallback rules above, which never enter a bucket)."),
}


def _const(node):
    return node.value if isinstance(node, ast.Constant) else None


def _catalog(pkg, skip=()):
    """{name: {(kind, help, label keys)}} of every ``counter``/``gauge``/
    ``histogram`` call with a literal ``mxnet_*`` name in ``pkg``'s
    sources (minus the files in ``skip``)."""
    root = os.path.join(REPO, pkg)
    out = {}
    for dirpath, _dirs, files in os.walk(root):
        for fn in files:
            path = os.path.join(dirpath, fn)
            rel = os.path.relpath(path, root)
            if not fn.endswith(".py") or rel in skip:
                continue
            with open(path) as f:
                tree = ast.parse(f.read())
            for node in ast.walk(tree):
                if not isinstance(node, ast.Call):
                    continue
                func = node.func
                kind = func.attr if isinstance(func, ast.Attribute) \
                    else getattr(func, "id", None)
                if kind not in ("counter", "gauge", "histogram") \
                        or not node.args:
                    continue
                name = _const(node.args[0])
                if not (isinstance(name, str) and name.startswith("mxnet_")):
                    continue
                kw = {k.arg: k.value for k in node.keywords}
                help_ = _const(node.args[1]) if len(node.args) > 1 \
                    else _const(kw.get("help", ast.Constant("")))
                labels = kw.get("labels")
                keys = tuple(sorted(_const(k) for k in labels.keys)) \
                    if isinstance(labels, ast.Dict) else None
                out.setdefault(name, set()).add((kind, help_, keys))
    return out


def test_metric_catalog_matches_reference():
    ref = _catalog("mxnet_tpu", skip=tuple(UNPORTED))
    ours = _catalog("mxnet_tpu_torch")
    for name, help_ in HELP_DIFFERS.items():
        (kind, _ref_help, keys), = ref[name]
        ref[name] = {(kind, help_, keys)}
    assert ours == ref
    every = _catalog("mxnet_tpu")
    only_unported = {n for n in every if n not in ref}
    assert only_unported == set(UNPORTED_METRICS)
    for name in UNPORTED_METRICS:
        assert name not in ours
    # registered at runtime too, with the same kind and help
    for m in jtel.REGISTRY.all_metrics():
        if m.name in ours and m.name not in HELP_DIFFERS:
            tm = ttel.REGISTRY.get(m.name, labels=dict(m.labels) or None)
            if tm is not None:
                assert (tm.kind, tm.help) == (m.kind, m.help)
