"""The port's perf gate (``mxnet_tpu_torch/telemetry/perfgate.py``,
``tools/torch_perfgate.py``) on the CPU: its pure half against the
reference's module on the same documents, the committed host tier, the
CLI (byte-identical rewrites, the refused reasonless write, the red path
through a pinned child, exit codes) and ``/perfgate.json``.  The lanes
beside the reference's lanes are in ``test_torch_perfgate_lanes.py``."""

import copy
import json
import os
import subprocess
import sys
import urllib.error
import urllib.request

import pytest

from mxnet_tpu.telemetry import perfgate as jpg
from mxnet_tpu_torch.telemetry import costmodel, httpd
from mxnet_tpu_torch.telemetry import perfgate as tpg

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HOST_TIER = os.path.join(REPO, "tests", "perf_baseline_torch.json")
CUDA_TIER = os.path.join(REPO, "tests", "perf_baseline_torch_cuda.json")
CLI = os.path.join(REPO, "tools", "torch_perfgate.py")


def _rec(**over):
    """A synthetic lane record shaped like _finish_record's."""
    rec = {
        "config": {"batch": 4, "seq_len": 32},
        "metrics": {
            "dispatches_per_step": 2.0, "executables": 3,
            "retraces_steady": 0, "flops": 1000000,
            "bytes_accessed": 400000, "peak_hbm_bytes": 800000,
            "analytic_mfu": 0.25, "analytic_step_s": 2e-06,
            "verdict": "compute-bound",
        },
        "sites": {"train.step": {
            "executables": 1, "calls": 4, "flops": 1000000.0,
            "bytes_accessed": 400000.0, "peak_bytes": 800000}},
        "counters": {"mxnet_op_dispatch_total": 8},
        "observed": {"steady_wall_s": 0.5, "wall_s_per_step": 0.25,
                     "measured_mfu": 0.01},
    }
    for k, v in over.items():
        if isinstance(v, dict) and isinstance(rec.get(k), dict):
            rec[k] = {**rec[k], **v}
        else:
            rec[k] = v
    return rec


# -- the pure half, beside the reference's ----------------------------------------

def test_tolerance_tables_and_schema_equal():
    assert tpg.METRIC_TOLERANCES == jpg.METRIC_TOLERANCES
    assert tpg.SITE_TOLERANCES == jpg.SITE_TOLERANCES
    assert tpg.SCHEMA_VERSION == jpg.SCHEMA_VERSION
    assert set(tpg.LANES) == set(jpg.LANES)
    for name in tpg.LANES:
        assert tpg.LANES[name][1:] == jpg.LANES[name][1:]


DIFF_CASES = {
    "identical": ({"a": _rec()}, {"a": _rec()}),
    "flops_inside_band": ({"a": _rec()},
                          {"a": _rec(metrics={"flops": 1019000})}),
    "flops_outside_band": ({"a": _rec()},
                           {"a": _rec(metrics={"flops": 1021000})}),
    "peak_inside_5pct": ({"a": _rec()},
                         {"a": _rec(metrics={"peak_hbm_bytes": 839000})}),
    "dispatches_drift": ({"a": _rec()},
                         {"a": _rec(metrics={"dispatches_per_step": 2.5})}),
    "retraces_drift": ({"a": _rec()},
                       {"a": _rec(metrics={"retraces_steady": 1})}),
    "verdict_drift": ({"a": _rec()},
                      {"a": _rec(metrics={"verdict": "memory-bound"})}),
    "counter_drift": ({"a": _rec()},
                      {"a": _rec(counters={"mxnet_op_dispatch_total": 9})}),
    "config_drift": ({"a": _rec()},
                     {"a": _rec(config={"batch": 8, "seq_len": 32})}),
    "site_gone": ({"a": _rec()}, {"a": _rec(sites={})}),
    "added_removed": ({"a": _rec(), "b": _rec()},
                      {"a": _rec(), "c": _rec()}),
    "non_numeric": ({"a": _rec()},
                    {"a": _rec(metrics={"flops": "many"})}),
}


@pytest.mark.parametrize("case", sorted(DIFF_CASES))
def test_diff_and_report_equal_the_reference(case):
    base, fresh = DIFF_CASES[case]
    want = jpg.diff_snapshots(copy.deepcopy(base), copy.deepcopy(fresh))
    got = tpg.diff_snapshots(copy.deepcopy(base), copy.deepcopy(fresh))
    assert got == want
    assert tpg.report_lines(got, baseline_path="b.json") \
        == jpg.report_lines(want, baseline_path="b.json")
    for name in base:
        if name in fresh:
            assert tpg.diff_lane(base[name], fresh[name]) \
                == jpg.diff_lane(base[name], fresh[name])


def test_canonical_doc_and_digest_byte_equal(tmp_path):
    lanes = {"a": _rec(), "b": _rec(metrics={"flops": 7})}
    reasons = [{"reason": "r", "lanes": ["a", "b"]}]
    doc = tpg.canonical_doc(lanes, reasons)
    assert doc == jpg.canonical_doc(lanes, reasons)
    assert tpg.dump_doc(doc) == jpg.dump_doc(doc)
    assert tpg.lanes_digest(lanes) == jpg.lanes_digest(lanes)
    assert "observed" not in doc["lanes"]["a"]
    p = tmp_path / "b.json"
    p.write_text(tpg.dump_doc(doc))
    assert tpg.load_baseline(str(p)) == jpg.load_baseline(str(p))


@pytest.mark.parametrize("fault", ["hand_edit", "corrupt", "bad_schema",
                                   "missing_metric", "absent", "no_lanes"])
def test_invalid_baselines_rejected_by_both(tmp_path, fault):
    p = tmp_path / "x.json"
    doc = tpg.canonical_doc({"a": _rec()}, reasons=[])
    if fault == "hand_edit":
        doc["lanes"]["a"]["metrics"]["flops"] += 1
        p.write_text(tpg.dump_doc(doc))
    elif fault == "corrupt":
        p.write_text("{not json")
    elif fault == "bad_schema":
        doc["schema"] = 99
        p.write_text(tpg.dump_doc(doc))
    elif fault == "missing_metric":
        rec = _rec()
        del rec["metrics"]["analytic_mfu"]
        p.write_text(tpg.dump_doc(tpg.canonical_doc({"a": rec}, [])))
    elif fault == "no_lanes":
        doc["lanes"] = {}
        p.write_text(tpg.dump_doc(doc))
    with pytest.raises(jpg.BaselineError) as want:
        jpg.load_baseline(str(p))
    with pytest.raises(tpg.BaselineError) as got:
        tpg.load_baseline(str(p))
    # the same diagnosis; only the tool the message names differs
    assert str(got.value).replace("torch_perfgate", "perfgate") \
        == str(want.value)


@pytest.mark.parametrize("live", [
    {"train.step": {"flops": 1010000.0, "bytes_accessed": 402000.0,
                    "peak_bytes": 820000, "executables": 5, "calls": 99}},
    {"train.step": {"flops": 2000000.0, "bytes_accessed": 400000.0,
                    "peak_bytes": 800000}},
    {"other.site": {"flops": 1.0}},
])
def test_live_delta_equals_the_reference(live):
    doc = tpg.canonical_doc({"a": _rec()}, reasons=[])
    counters = {"mxnet_op_dispatch_total": 3}
    assert tpg.live_delta(doc, live, counters) \
        == jpg.live_delta(doc, live, counters)


# -- the committed tiers -------------------------------------------------------------

def test_committed_host_tier_is_valid_and_covers_the_lanes():
    assert tpg.default_baseline_path() == HOST_TIER
    doc = tpg.load_baseline(HOST_TIER)
    assert set(doc["lanes"]) == set(tpg.lane_names())
    assert doc["reasons"]
    for name, rec in doc["lanes"].items():
        assert rec["metrics"]["retraces_steady"] == 0, name


def test_committed_card_tier_is_valid_and_covers_the_lanes():
    doc = tpg.load_baseline(CUDA_TIER)
    assert set(doc["lanes"]) == set(tpg.lane_names())
    for name, rec in doc["lanes"].items():
        # two warm-up calls on the card: the capture is outside the window
        assert rec["metrics"]["retraces_steady"] == 0, name
    for name in ("bert_headline", "bert_seq512"):
        # a replay is one armed dispatch a step; an iteration is 2 steps
        assert doc["lanes"][name]["metrics"]["dispatches_per_step"] == 2.0
    host = tpg.load_baseline(HOST_TIER)
    for name in ("serving_continuous", "serving_spec_decode",
                 "trainer_fused_kvstore"):
        assert doc["lanes"][name]["counters"] \
            == host["lanes"][name]["counters"], name


def test_default_baseline_path_env_override(monkeypatch):
    monkeypatch.setenv("MXNET_PERFGATE_BASELINE", CUDA_TIER)
    assert tpg.default_baseline_path() == CUDA_TIER
    monkeypatch.delenv("MXNET_PERFGATE_BASELINE")
    assert tpg.default_baseline_path() == HOST_TIER


# -- the CLI ---------------------------------------------------------------------------

def _cli(*args, env=None):
    return subprocess.Popen([sys.executable, CLI, *args], cwd=REPO,
                            env=dict(os.environ, **(env or {})),
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def _done(proc, timeout=120):
    out, err = proc.communicate(timeout=timeout)
    return proc.returncode, out, err


def test_cli_parent_imports_no_torch():
    code = ("import runpy, sys; sys.argv = ['torch_perfgate.py', "
            "'--list']\n"
            "try:\n    runpy.run_path('tools/torch_perfgate.py', "
            "run_name='__main__')\nexcept SystemExit as e:\n"
            "    assert e.code == 0, e.code\n"
            "assert 'torch' not in sys.modules, 'torch imported'\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=60)
    assert res.returncode == 0, res.stderr
    assert [ln.split()[0] for ln in res.stdout.splitlines()] \
        == tpg.lane_names()


def test_cli_write_baseline_requires_reason_and_bad_baseline_exits_2(
        tmp_path):
    rc, _out, err = _done(_cli("--write-baseline", "--device", "cpu",
                               "--baseline", str(tmp_path / "b.json")))
    assert rc == 2 and "--reason" in err
    assert not (tmp_path / "b.json").exists()
    bad = tmp_path / "bad.json"
    bad.write_text("{not json")
    rc, _out, err = _done(_cli("--check", "--device", "cpu",
                               "--baseline", str(bad)))
    assert rc == 2 and "not valid JSON" in err


def test_cli_write_baseline_twice_is_byte_identical(tmp_path):
    paths = [tmp_path / "one.json", tmp_path / "two.json"]
    procs = [_cli("--write-baseline", "--device", "cpu", "--lanes",
                  "trainer_fused_kvstore", "--reason", "twice",
                  "--baseline", str(p)) for p in paths]
    for proc in procs:
        rc, _out, err = _done(proc)
        assert rc == 0, err
    one, two = (p.read_bytes() for p in paths)
    assert one == two
    doc = tpg.load_baseline(str(paths[0]))
    assert doc["reasons"] == [{"reason": "twice",
                               "lanes": ["trainer_fused_kvstore"]}]
    # the host tier's record of the lane, byte for byte
    host = tpg.load_baseline(HOST_TIER)
    assert doc["lanes"]["trainer_fused_kvstore"] \
        == host["lanes"]["trainer_fused_kvstore"]


def test_cli_red_path_exits_1(tmp_path):
    """MXNET_KVSTORE_BUCKET_MB=0 reaches the pinned child and degrades the
    fused pushpull to the per-key loop: the gate goes red (exit 1) on the
    dispatch explosion; the same check without it passes."""
    args = ("--check", "--device", "cpu", "--lanes",
            "trainer_fused_kvstore", "--json")
    red = _cli(*args, env={"MXNET_KVSTORE_BUCKET_MB": "0"})
    green = _cli(*args)
    rc, out, err = _done(red)
    assert rc == 1, err
    report = json.loads(out)
    fails = report["lanes"]["trainer_fused_kvstore"]["failures"]
    metric = {f["metric"]: f for f in fails}
    assert metric["dispatches_per_step"]["got"] \
        > metric["dispatches_per_step"]["base"]
    assert "config" in metric            # the bucket bound itself moved
    rc, out, err = _done(green)
    assert rc == 0, err
    assert json.loads(out)["ok"]


# -- /perfgate.json ----------------------------------------------------------------------

def test_httpd_perfgate_endpoint(monkeypatch, tmp_path):
    port = httpd.start(port=0, host="127.0.0.1")
    url = f"http://127.0.0.1:{port}"
    try:
        monkeypatch.setenv("MXNET_PERFGATE_BASELINE",
                           str(tmp_path / "absent.json"))
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(url + "/perfgate.json", timeout=10)
        assert ei.value.code == 404
        assert json.load(ei.value)["error"] == "no committed baseline"
        with urllib.request.urlopen(url + "/statusz", timeout=10) as r:
            assert json.load(r)["perfgate"] == "no-baseline"
        # a baseline with the site the live ledger records
        b = tmp_path / "b.json"
        b.write_text(tpg.dump_doc(tpg.canonical_doc({"a": _rec()}, [])))
        monkeypatch.setenv("MXNET_PERFGATE_BASELINE", str(b))
        costmodel.LEDGER.record("train.step", {
            "flops": 1005000.0, "bytes_accessed": 400000.0,
            "peak_bytes": 800000})
        with urllib.request.urlopen(url + "/perfgate.json", timeout=10) as r:
            body = json.load(r)
        assert body["ok"] and body["overlap_sites"] == 1
        assert body["baseline_path"] == str(b)
        with urllib.request.urlopen(url + "/statusz", timeout=10) as r:
            assert json.load(r)["perfgate"] == "ok"
        costmodel.LEDGER.record("train.step", {
            "flops": 2000000.0, "bytes_accessed": 400000.0,
            "peak_bytes": 800000})
        with urllib.request.urlopen(url + "/statusz", timeout=10) as r:
            assert json.load(r)["perfgate"] == "drift"
    finally:
        httpd.stop()
        costmodel.LEDGER.clear()
