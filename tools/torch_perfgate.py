#!/usr/bin/env python3
"""The perf-regression gate CLI of the PyTorch/CUDA port — the
counterpart of ``tools/perfgate.py``.

    python tools/torch_perfgate.py --check [--json] [--baseline PATH]
    python tools/torch_perfgate.py --write-baseline --reason "why" [--lanes a,b]
    python tools/torch_perfgate.py --snapshot out.json [--lanes a,b]
    python tools/torch_perfgate.py --lane NAME     # child mode (imports torch)
    python tools/torch_perfgate.py --list

``--device cuda`` (the default) runs the lanes on the card, ``--device
cpu`` on the host; each device has its own tier of baseline
(``tests/perf_baseline_torch.json``, the default, is the host's;
``MXNET_PERFGATE_BASELINE=tests/perf_baseline_torch_cuda.json`` selects
the card's).  ``--jobs N`` runs up to N lane children at once (their
records do not depend on it: each process counts its own work).
``--records PATH`` also writes the fresh records with what no baseline
keeps: the ``observed`` walls and each lane's flash kernel launches.

The parent imports no torch: each lane runs in a fresh child process with
a PINNED environment (``--device``; on the card ``CUDA_VISIBLE_DEVICES``
narrowed to one card, on the host the cards hidden, so the cost model's
peaks are the device's own; telemetry export knobs stripped) so records
cannot be skewed by an inherited override — while deliberate regression
knobs (e.g. ``MXNET_KVSTORE_BUCKET_MB=0``) pass straight through, which
is how the red-path test injects its dispatch explosion.

Exit codes: 0 pass, 1 drift / lane failure, 2 unusable baseline.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import importlib
import json
import os
import subprocess
import sys
import types

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO_ROOT not in sys.path:
    sys.path.insert(0, REPO_ROOT)     # child mode imports the port itself

_PKG_DIR = os.path.join(REPO_ROOT, "mxnet_tpu_torch")


def _load_perfgate():
    """Load mxnet_tpu_torch.telemetry.perfgate without running the
    torch-importing package __init__s: a private package over the port's
    directory, its ``telemetry`` a bare namespace (perfgate reads only
    ``config`` at import)."""
    if "mxnet_tpu_torch" in sys.modules:
        return importlib.import_module("mxnet_tpu_torch.telemetry.perfgate")
    pkg_name = "_torch_perfgate_pkg"
    if pkg_name not in sys.modules:
        pkg = types.ModuleType(pkg_name)
        pkg.__path__ = [_PKG_DIR]
        sys.modules[pkg_name] = pkg
        tel = types.ModuleType(pkg_name + ".telemetry")
        tel.__path__ = [os.path.join(_PKG_DIR, "telemetry")]
        sys.modules[pkg_name + ".telemetry"] = tel
    return importlib.import_module(pkg_name + ".telemetry.perfgate")


_LAUNCH_COUNTERS = (("flash_fwd", "launches"),
                    ("flash_bwd_fused", "bwd_fused_launches"),
                    ("flash_bwd_dq", "bwd_dq_launches"),
                    ("flash_bwd_dkv", "bwd_dkv_launches"),
                    ("flash_fwd_f32", "fwd_f32_launches"),
                    ("flash_bwd_fused_f32", "bwd_fused_f32_launches"),
                    ("flash_bwd_dq_f32", "bwd_dq_f32_launches"),
                    ("flash_bwd_dkv_f32", "bwd_dkv_f32_launches"))


def _child_env(device):
    """The pinned lane environment: the device alone, regression knobs
    passed through."""
    env = dict(os.environ)
    if device == "cpu":
        env["CUDA_VISIBLE_DEVICES"] = ""
    else:
        visible = env.get("CUDA_VISIBLE_DEVICES", "")
        env["CUDA_VISIBLE_DEVICES"] = visible.split(",")[0].strip() or "0"
    for k in ("MXNET_TELEMETRY_DIR", "MXNET_TELEMETRY_PORT",
              "MXNET_PEAK_FLOPS", "MXNET_PEAK_HBM_GBS"):
        env.pop(k, None)
    return env


def _run_lane_child(name, device, timeout_s):
    proc = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--lane", name,
         "--device", device],
        capture_output=True, text=True, timeout=timeout_s,
        env=_child_env(device), cwd=REPO_ROOT)
    if proc.returncode != 0:
        tail = (proc.stderr or proc.stdout or "").strip().splitlines()[-8:]
        raise RuntimeError(
            f"lane {name!r} child failed (rc={proc.returncode}):\n  "
            + "\n  ".join(tail))
    for line in reversed(proc.stdout.strip().splitlines()):
        line = line.strip()
        if line.startswith("{"):
            return json.loads(line)
    raise RuntimeError(f"lane {name!r} child emitted no JSON record")


def _selected_lanes(pg, arg):
    names = pg.lane_names()
    sel = arg or os.environ.get("MXNET_PERFGATE_LANES", "")
    if not sel:
        return names
    picked = [s.strip() for s in sel.split(",") if s.strip()]
    unknown = [p for p in picked if p not in names]
    if unknown:
        raise SystemExit(f"unknown lane(s) {unknown}; have {names}")
    return picked


def _snapshot(lanes, device, timeout_s, jobs=1, quiet=False):
    for name in lanes:
        if not quiet:
            print(f"perfgate: running lane {name} on {device} …",
                  file=sys.stderr)
    with concurrent.futures.ThreadPoolExecutor(max(1, jobs)) as pool:
        futs = {name: pool.submit(_run_lane_child, name, device, timeout_s)
                for name in lanes}
        return {name: futs[name].result() for name in lanes}


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="structural perf-regression gate over the cost ledger")
    mode = ap.add_mutually_exclusive_group(required=True)
    mode.add_argument("--check", action="store_true",
                      help="diff a fresh snapshot against the committed "
                           "baseline; exit 1 on drift")
    mode.add_argument("--write-baseline", action="store_true",
                      help="snapshot and (re)write the baseline file "
                           "(requires --reason)")
    mode.add_argument("--snapshot", metavar="PATH",
                      help="write a fresh snapshot JSON and exit")
    mode.add_argument("--lane", metavar="NAME",
                      help="child mode: run ONE lane in-process and print "
                           "its record (imports torch)")
    mode.add_argument("--list", action="store_true",
                      help="list registered lanes")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the lanes run (default: the card)")
    ap.add_argument("--jobs", type=int, default=1, metavar="N",
                    help="lane children run at once (default 1)")
    ap.add_argument("--baseline", metavar="PATH",
                    help="baseline path (default: "
                         "tests/perf_baseline_torch.json or "
                         "$MXNET_PERFGATE_BASELINE)")
    ap.add_argument("--lanes", metavar="A,B",
                    help="restrict to these lanes "
                         "(or $MXNET_PERFGATE_LANES)")
    ap.add_argument("--reason", metavar="TEXT",
                    help="why the baseline legitimately moved "
                         "(logged append-only into the file)")
    ap.add_argument("--json", action="store_true",
                    help="emit the check report as JSON (stdout)")
    ap.add_argument("--records", metavar="PATH",
                    help="also write the fresh records, observed walls "
                         "and flash launches included, to PATH")
    args = ap.parse_args(argv)

    if args.lane:
        # child mode runs the real runtime: import the genuine package so
        # the armed ledger/registry are the instances the lane feeds
        importlib.import_module("mxnet_tpu_torch")

    pg = _load_perfgate()

    if args.list:
        for name in pg.lane_names():
            _fn, shards, desc = pg.LANES[name]
            print(f"  {name:<24} shards={shards}  {desc}")
        return 0

    if args.lane:
        rec = pg.run_lane(args.lane, device=args.device)
        # the lane's launches of each flash entry point (warm-up, window
        # and drain): observed, so never part of a baseline
        fa = importlib.import_module(
            "mxnet_tpu_torch.kernels.flash_attention")
        rec["observed"]["flash_launches"] = {
            name: getattr(fa, attr) for name, attr in _LAUNCH_COUNTERS}
        print(json.dumps(rec, sort_keys=True))
        return 0

    try:
        timeout_s = float(os.environ.get("MXNET_PERFGATE_CHILD_TIMEOUT_S",
                                         "420"))
    except ValueError:
        timeout_s = 420.0
    baseline_path = args.baseline or pg.default_baseline_path()
    lanes = _selected_lanes(pg, args.lanes)

    if args.snapshot:
        records = _snapshot(lanes, args.device, timeout_s, args.jobs)
        doc = pg.canonical_doc(records, reasons=[])
        with open(args.snapshot, "w") as f:
            f.write(pg.dump_doc(doc))
        print(f"perfgate snapshot ({len(records)} lanes) -> {args.snapshot}")
        return 0

    if args.write_baseline:
        if not args.reason:
            ap.error("--write-baseline requires --reason "
                     "(the legitimate-change log is append-only)")
        reasons = []
        if os.path.exists(baseline_path):
            try:
                reasons = list(
                    pg.load_baseline(baseline_path).get("reasons") or [])
            except pg.BaselineError:
                reasons = []      # corrupt file: start the log over
        records = _snapshot(lanes, args.device, timeout_s, args.jobs)
        reasons.append({"reason": args.reason, "lanes": sorted(records)})
        doc = pg.canonical_doc(records, reasons=reasons)
        os.makedirs(os.path.dirname(os.path.abspath(baseline_path)),
                    exist_ok=True)
        with open(baseline_path, "w") as f:
            f.write(pg.dump_doc(doc))
        print(f"perfgate baseline ({len(records)} lanes) -> {baseline_path}")
        return 0

    # --check
    try:
        base = pg.load_baseline(baseline_path)
    except pg.BaselineError as e:
        print(f"perfgate: {e}", file=sys.stderr)
        return 2
    base_lanes = base["lanes"]
    if args.lanes or os.environ.get("MXNET_PERFGATE_LANES"):
        base_lanes = {k: v for k, v in base_lanes.items() if k in lanes}
        lanes = [n for n in lanes if n in base_lanes or n in pg.lane_names()]
        print(f"perfgate: PARTIAL check over {lanes}", file=sys.stderr)
    else:
        # a lane registered in code but absent from the baseline must
        # surface as "added" — snapshot the full registry
        lanes = sorted(set(pg.lane_names()) | set(base_lanes))
        lanes = [n for n in lanes if n in pg.lane_names()]
    try:
        fresh = _snapshot(lanes, args.device, timeout_s, args.jobs)
    except (RuntimeError, subprocess.TimeoutExpired) as e:
        print(f"perfgate: {e}", file=sys.stderr)
        return 1
    if args.records:
        with open(args.records, "w") as f:
            json.dump(fresh, f, indent=1, sort_keys=True)
    report = pg.diff_snapshots(base_lanes, fresh)
    if args.json:
        print(json.dumps(report, indent=1, sort_keys=True))
    else:
        for line in pg.report_lines(report, baseline_path=baseline_path):
            print(line)
    return 0 if report["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
