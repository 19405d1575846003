"""The perf-regression gate — the port's copy of
``mxnet_tpu/telemetry/perfgate.py``: committed structural baselines.

The cost ledger (``telemetry.costmodel``) counts each captured step
signature's FLOPs, bytes accessed and peak device bytes, and the call
counts of every site; ``analysis.runtime`` counts the builds (CUDA-graph
captures, bucket plans, kernel libraries).  This module turns them into
*enforced invariants*:

- **snapshot**: each registered lane builds its real workload (train
  step / serving engine / kvstore pushpull) on the card or, when asked,
  the CPU, arms the ledger, warms up, and runs a short steady-state
  window with NO timing loop — the captured record is executables
  analysed, armed dispatches per iteration, steady-state builds
  (``analysis.runtime.compile_count``), FLOPs, bytes accessed, peak
  device bytes, the deterministic analytic MFU, and the lane's key
  telemetry counters.  Everything in the record is a function of
  program structure, never of wall time, so two runs on one kind of
  device produce byte-identical JSON.
- **baseline**: ``tools/torch_perfgate.py --write-baseline --reason
  "..."`` serializes the snapshot sorted-keys/no-timestamps into the
  committed ``tests/perf_baseline_torch.json`` (the host tier, the
  default) or, with ``MXNET_PERFGATE_BASELINE``,
  ``tests/perf_baseline_torch_cuda.json`` (the card tier), with a
  content digest (hand edits are rejected) and an append-only reason
  log.  The tiers differ where the device does: on the card a replay is
  one armed dispatch a step, on the host the eager body dispatches its
  ops.
- **gate**: ``tools/torch_perfgate.py --check`` re-snapshots and diffs
  against the committed file under per-metric tolerance bands — exact
  for dispatches/retraces/executables/counters, ±2% FLOPs/bytes, ±5%
  peak memory — failing red on drift, added lanes, or removed lanes.

Determinism contract: ``analytic_mfu`` is the roofline MFU *bound*
(arithmetic intensity against the machine ridge) and ``analytic_step_s``
is ``max(flops/peak_flops, bytes/peak_bw)`` — both pure functions of the
analysed program and the (env-pinnable) device peaks.  Wall-clock
readings ride each fresh snapshot under ``observed`` and are STRIPPED
before serialization.

Warm-up: a ``TrainStep`` signature's first call on the card runs eagerly
(and is analysed), its second is captured; only then does a call
replay.  So a training lane warms up with two calls on the card and one
on the host (:data:`WARMUP_CALLS`), and its steady window counts no
build on either.

Import-time this module needs no torch (it reads only ``config``; the
cost ledger and the metrics are imported where a lane runs), so the CLI
parent loads it alone: lane runners import the port lazily and only
execute in the snapshot child processes.
"""

from __future__ import annotations

import hashlib
import json
import os

from .. import config

__all__ = [
    "BaselineError", "LANES", "METRIC_TOLERANCES", "SITE_TOLERANCES",
    "SCHEMA_VERSION", "WARMUP_CALLS", "canonical_doc", "canonical_lanes",
    "default_baseline_path", "diff_lane", "diff_snapshots", "dump_doc",
    "lane_names", "lanes_digest", "live_delta", "load_baseline",
    "report_lines", "run_lane", "validate_baseline",
]

SCHEMA_VERSION = 1

# -- tolerance bands ---------------------------------------------------------
# None  -> exact string equality (verdicts)
# 0.0   -> exact numeric equality (structural counts: any drift is a real
#          program-shape change and must be re-baselined deliberately)
# r > 0 -> relative band: |got - base| / max(|base|, 1e-9) <= r
#          (the analysed counts move slightly across library versions)
METRIC_TOLERANCES = {
    "dispatches_per_step": 0.0,
    "executables": 0.0,
    "retraces_steady": 0.0,
    "flops": 0.02,
    "bytes_accessed": 0.02,
    "peak_hbm_bytes": 0.05,
    "analytic_mfu": 0.02,
    "analytic_step_s": 0.02,
    "verdict": None,
}
SITE_TOLERANCES = {
    "executables": 0.0,
    "calls": 0.0,
    "flops": 0.02,
    "bytes_accessed": 0.02,
    "peak_bytes": 0.05,
}
_VOLATILE_KEYS = ("observed",)     # wall-time block: never serialized


def default_baseline_path():
    """The committed baseline path; ``MXNET_PERFGATE_BASELINE`` overrides
    (tests, and the card tier ``tests/perf_baseline_torch_cuda.json``)."""
    p = config.get("MXNET_PERFGATE_BASELINE")
    if p:
        return p
    repo = os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    return os.path.join(repo, "tests", "perf_baseline_torch.json")


# -- canonical serialization + digest ----------------------------------------

def canonical_lanes(lanes):
    """Deep-copy with volatile (wall-clock) blocks stripped — the exact
    dict that gets digested and serialized."""
    out = {}
    for name in sorted(lanes):
        rec = {k: v for k, v in lanes[name].items()
               if k not in _VOLATILE_KEYS}
        out[name] = json.loads(json.dumps(rec, sort_keys=True))
    return out


def lanes_digest(lanes):
    blob = json.dumps(canonical_lanes(lanes), sort_keys=True,
                      separators=(",", ":"))
    return hashlib.sha256(blob.encode()).hexdigest()


def canonical_doc(lanes, reasons):
    """The full baseline document, ready for byte-stable serialization."""
    lanes = canonical_lanes(lanes)
    return {
        "schema": SCHEMA_VERSION,
        "digest": lanes_digest(lanes),
        "reasons": list(reasons),
        "lanes": lanes,
    }


def dump_doc(doc):
    """Byte-deterministic text form: sorted keys, fixed indent, trailing
    newline, no timestamps anywhere."""
    return json.dumps(doc, sort_keys=True, indent=1) + "\n"


class BaselineError(ValueError):
    """Raised on a missing/corrupt/hand-edited baseline file."""


def validate_baseline(doc, path="<baseline>"):
    if not isinstance(doc, dict):
        raise BaselineError(f"{path}: baseline must be a JSON object")
    if doc.get("schema") != SCHEMA_VERSION:
        raise BaselineError(
            f"{path}: schema {doc.get('schema')!r} != {SCHEMA_VERSION} "
            "(regenerate with tools/torch_perfgate.py --write-baseline)")
    lanes = doc.get("lanes")
    if not isinstance(lanes, dict) or not lanes:
        raise BaselineError(f"{path}: no lanes recorded")
    want = lanes_digest(lanes)
    if doc.get("digest") != want:
        raise BaselineError(
            f"{path}: content digest mismatch (file says "
            f"{str(doc.get('digest'))[:12]}…, lanes hash to {want[:12]}…) "
            "— the baseline was hand-edited; regenerate it with "
            "tools/torch_perfgate.py --write-baseline --reason '...'")
    for name, rec in lanes.items():
        m = rec.get("metrics")
        if not isinstance(m, dict):
            raise BaselineError(f"{path}: lane {name!r} has no metrics block")
        missing = [k for k in METRIC_TOLERANCES if k not in m]
        if missing:
            raise BaselineError(
                f"{path}: lane {name!r} missing metrics {missing}")
    return doc


def load_baseline(path):
    if not os.path.exists(path):
        raise BaselineError(f"{path}: no committed baseline "
                            "(tools/torch_perfgate.py --write-baseline creates it)")
    try:
        with open(path) as f:
            doc = json.load(f)
    except ValueError as e:
        raise BaselineError(f"{path}: not valid JSON ({e})") from e
    return validate_baseline(doc, path=path)


# -- the diff engine ---------------------------------------------------------

def _check_value(metric, base, got, tol):
    """None when within band, else a failure dict."""
    if tol is None:
        if str(base) != str(got):
            return {"metric": metric, "base": base, "got": got,
                    "tol": "exact"}
        return None
    try:
        b, g = float(base), float(got)
    except (TypeError, ValueError):
        return {"metric": metric, "base": base, "got": got,
                "tol": "exact", "error": "non-numeric"}
    if b == g:
        return None
    rel = abs(g - b) / max(abs(b), 1e-9)
    if tol == 0.0 or rel > tol:
        return {"metric": metric, "base": base, "got": got, "tol": tol,
                "rel": round(rel, 6)}
    return None


def _diff_block(prefix, base, got, tols, fails, exact_keys=False):
    keys = set(base) | set(got)
    for k in sorted(keys):
        if k not in base:
            fails.append({"metric": f"{prefix}{k}", "base": None,
                          "got": got[k], "tol": "exact"})
            continue
        if k not in got:
            fails.append({"metric": f"{prefix}{k}", "base": base[k],
                          "got": None, "tol": "exact"})
            continue
        tol = 0.0 if exact_keys else tols.get(k, 0.0)
        f = _check_value(f"{prefix}{k}", base[k], got[k], tol)
        if f:
            fails.append(f)


def diff_lane(base, fresh):
    """One lane's failure list (empty = within every band)."""
    fails: list = []
    if base.get("config") != fresh.get("config"):
        fails.append({"metric": "config", "base": base.get("config"),
                      "got": fresh.get("config"), "tol": "exact"})
    _diff_block("", base.get("metrics") or {}, fresh.get("metrics") or {},
                METRIC_TOLERANCES, fails)
    _diff_block("counters.", base.get("counters") or {},
                fresh.get("counters") or {}, {}, fails, exact_keys=True)
    bsites, fsites = base.get("sites") or {}, fresh.get("sites") or {}
    for site in sorted(set(bsites) | set(fsites)):
        if site not in bsites or site not in fsites:
            fails.append({"metric": f"sites.{site}",
                          "base": "present" if site in bsites else None,
                          "got": "present" if site in fsites else None,
                          "tol": "exact"})
            continue
        _diff_block(f"sites.{site}.", bsites[site], fsites[site],
                    SITE_TOLERANCES, fails)
    return fails


def diff_snapshots(baseline_lanes, fresh_lanes):
    """Full gate verdict: per-lane ok/drift plus loud added/removed."""
    baseline_lanes = canonical_lanes(baseline_lanes)
    fresh_lanes = canonical_lanes(fresh_lanes)
    report = {"ok": True, "lanes": {}, "added": [], "removed": []}
    for name in sorted(set(baseline_lanes) | set(fresh_lanes)):
        if name not in baseline_lanes:
            report["added"].append(name)
            report["lanes"][name] = {
                "verdict": "added", "failures": [
                    {"metric": "lane", "base": None, "got": "present",
                     "tol": "exact"}]}
            report["ok"] = False
            continue
        if name not in fresh_lanes:
            report["removed"].append(name)
            report["lanes"][name] = {
                "verdict": "removed", "failures": [
                    {"metric": "lane", "base": "present", "got": None,
                     "tol": "exact"}]}
            report["ok"] = False
            continue
        fails = diff_lane(baseline_lanes[name], fresh_lanes[name])
        report["lanes"][name] = {"verdict": "drift" if fails else "ok",
                                 "failures": fails}
        if fails:
            report["ok"] = False
    return report


def live_delta(baseline_doc, site_summary, counters=None):
    """Partial diff of a LIVE process against the committed baseline —
    the ``/perfgate.json`` endpoint.

    A live process runs one workload, not the whole lane matrix, so only
    the analytic per-site invariants that overlap are compared (flops /
    bytes / peak-HBM of each site's largest executable); call volumes and
    counters are workload-scaled and reported alongside, not gated."""
    live = {}
    for site, s in (site_summary or {}).items():
        live[site] = {"flops": float(s.get("flops") or 0.0),
                      "bytes_accessed": float(s.get("bytes_accessed") or 0.0),
                      "peak_bytes": int(s.get("peak_bytes") or 0)}
    out = {"ok": True, "baseline_digest": baseline_doc.get("digest"),
           "overlap_sites": 0, "lanes": {}}
    gated = {k: SITE_TOLERANCES[k]
             for k in ("flops", "bytes_accessed", "peak_bytes")}
    for name, rec in sorted((baseline_doc.get("lanes") or {}).items()):
        overlap = sorted(set(rec.get("sites") or {}) & set(live))
        if not overlap:
            out["lanes"][name] = {"verdict": "no-overlap", "failures": []}
            continue
        fails: list = []
        for site in overlap:
            base = {k: rec["sites"][site][k] for k in gated
                    if k in rec["sites"][site]}
            got = {k: live[site][k] for k in gated}
            _diff_block(f"sites.{site}.", base, got, gated, fails)
        out["overlap_sites"] += len(overlap)
        out["lanes"][name] = {"verdict": "drift" if fails else "ok",
                              "failures": fails}
        if fails:
            out["ok"] = False
    if counters:
        out["live_counters"] = {k: counters[k] for k in sorted(counters)}
    return out


def report_lines(report, baseline_path=None):
    """Human rendering of a :func:`diff_snapshots` report."""
    lines = []
    if baseline_path:
        lines.append(f"perfgate — baseline {baseline_path}")
    for name, lane in sorted(report["lanes"].items()):
        mark = {"ok": "OK  ", "drift": "DRIFT", "added": "ADDED",
                "removed": "GONE "}.get(lane["verdict"], "??")
        lines.append(f"  [{mark}] {name}")
        for f in lane["failures"][:12]:
            rel = f" (rel {f['rel']:+.2%})" if "rel" in f else ""
            lines.append(f"      {f['metric']}: baseline={f['base']!r} "
                         f"fresh={f['got']!r} tol={f['tol']}{rel}")
        extra = len(lane["failures"]) - 12
        if extra > 0:
            lines.append(f"      … and {extra} more")
    verdict = "PASS" if report["ok"] else "FAIL"
    n_bad = sum(1 for v in report["lanes"].values()
                if v["verdict"] != "ok")
    lines.append(f"perfgate verdict: {verdict} "
                 f"({len(report['lanes']) - n_bad}/{len(report['lanes'])} "
                 "lanes within tolerance)")
    return lines


# -- snapshot capture (lane runners; torch only in child processes) ----------

def _begin_capture():
    """Arm telemetry + the cost ledger from a clean slate BEFORE the lane
    warms up, so every analysed signature lands in the ledger."""
    from . import costmodel, metrics, tracer
    tracer.enable()
    costmodel.arm()
    from . import clear as _clear
    _clear()
    metrics.REGISTRY.reset()


def _total_armed_calls():
    from . import costmodel
    return sum(costmodel.LEDGER._call_counts().values())


def _metric_value(name):
    """Counter value / histogram observation count for a live metric; 0
    when the metric never registered."""
    from . import metrics
    m = metrics.REGISTRY.get(name)
    if m is None:
        return 0
    v = getattr(m, "value", None)
    if v is None:
        v = getattr(m, "count", 0)
    return v


def _counter_block(names):
    from . import metrics
    out = {}
    for n in names:
        m = metrics.REGISTRY.get(n)
        if m is None:
            out[n] = 0
        elif hasattr(m, "value"):
            v = float(m.value)
            out[n] = int(v) if v.is_integer() else round(v, 6)
        else:                       # histogram: structural count + sum
            out[n + "_count"] = int(m.count)
            s = float(m.sum)
            out[n + "_sum"] = int(s) if s.is_integer() else round(s, 6)
    return out


def _steady_capture(fn, iters, extra_dispatch_counters=()):
    """Run the warmed-up steady-state iteration ``iters`` times, counting
    armed dispatches, builds (retraces), and any lane-specific dispatch
    counters.  No host syncs in the window — the wall reading is
    informational and the caller drains afterwards."""
    import time
    from ..analysis import runtime as _art
    calls0 = _total_armed_calls()
    extra0 = sum(_metric_value(n) for n in extra_dispatch_counters)
    compiles0 = _art.compile_count()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    wall = time.perf_counter() - t0
    dispatches = (_total_armed_calls() - calls0
                  + sum(_metric_value(n) for n in extra_dispatch_counters)
                  - extra0)
    return {"dispatches": dispatches,
            "retraces": _art.compile_count() - compiles0,
            "wall_s": wall, "iters": iters}


def _site_rollup():
    from . import costmodel
    sites = {}
    for site, s in sorted(costmodel.LEDGER.site_summary().items()):
        sites[site] = {
            "executables": int(s["executables"]),
            "calls": int(s["calls"]),
            "flops": int(round(s["flops"])),
            "bytes_accessed": int(round(s["bytes_accessed"])),
            "peak_bytes": int(s["peak_bytes"]),
        }
    return sites


def _finish_record(cfg, primary_site, steady, steps_per_iter=1,
                   counter_names=(), dtype="float32"):
    """Assemble one lane's record from the armed ledger + registry.

    ``analytic_step_s`` / ``analytic_mfu`` are pure functions of the
    analysed program and the device peaks (roofline bound — NOT wall
    time), so the record is byte-deterministic; the wall reading rides
    separately under ``observed`` and never reaches the baseline."""
    from . import costmodel
    ents = costmodel.LEDGER.entries()
    good = [e for e in ents if not e.get("error")]
    prim = [e for e in good if e["site"] == primary_site]
    if prim:
        top = max(prim, key=lambda e: e.get("flops") or 0.0)
        flops = float(top.get("flops") or 0.0)
        byts = float(top.get("bytes_accessed") or 0.0)
    else:
        flops = byts = 0.0
    peak_hbm = max([int(e.get("peak_bytes", 0) or 0) for e in good] or [0])
    pf = costmodel.peak_flops(dtype)
    pb = costmodel.peak_hbm_bytes_per_s()
    rl = costmodel.roofline(flops, byts, dtype=dtype)
    step_s = max(flops / pf, byts / pb)
    per_step_wall = steady["wall_s"] / max(steady["iters"] * steps_per_iter, 1)
    record = {
        "config": dict(cfg, primary_site=primary_site,
                       steps_per_iter=steps_per_iter,
                       steady_iters=steady["iters"]),
        "metrics": {
            "dispatches_per_step": round(
                steady["dispatches"] / max(steady["iters"], 1), 4),
            "executables": len(ents),
            "retraces_steady": int(steady["retraces"]),
            "flops": int(round(flops)),
            "bytes_accessed": int(round(byts)),
            "peak_hbm_bytes": int(peak_hbm),
            "analytic_mfu": rl["roofline_mfu_bound"],
            "analytic_step_s": round(step_s, 9),
            "verdict": rl["verdict"] if flops else "no-entries",
        },
        "sites": _site_rollup(),
        "counters": _counter_block(counter_names),
        "observed": {
            "steady_wall_s": round(steady["wall_s"], 6),
            "wall_s_per_step": round(per_step_wall, 6),
            "measured_mfu": round(flops / max(per_step_wall * pf, 1e-12), 6),
        },
    }
    return record


# -- lane implementations ----------------------------------------------------

# calls before a lane's steady window: a TrainStep signature runs eagerly,
# then is captured, on the card; on the host its first call is its build
WARMUP_CALLS = {"cuda": 2, "cpu": 1}

_TRAIN_COUNTERS = ("mxnet_sharding_step_dispatches_total",
                   "mxnet_sharding_retraces_total")


def _ctx(device):
    import mxnet_tpu_torch as mx
    return mx.cpu() if device == "cpu" else mx.gpu(0)


def _warm(fn, device):
    for _ in range(WARMUP_CALLS[device]):
        fn()


def _lm_loss(out, labels):
    """Mean token cross entropy of logits ``out`` (BERT: its third
    output) in f32."""
    from ..ops import nn as ops_nn
    logits = out[2] if isinstance(out, tuple) else out
    return ops_nn.softmax_cross_entropy(
        logits.reshape(-1, logits.shape[-1]).float(),
        labels.reshape(-1)) / labels.numel()


def _tokens(seed, vocab, shape, dev):
    import numpy as np
    import torch
    r = np.random.RandomState(seed)
    toks = torch.tensor(r.randint(0, vocab, shape).astype(np.int32),
                        device=dev)
    labs = torch.tensor(r.randint(0, vocab, shape).astype(np.int32),
                        device=dev)
    return toks, labs


def _train_lane(step, toks, labs, device, cfg, scan_steps):
    """The steady window of a ``TrainStep.run`` over ``scan_steps``
    stacked batches (one iteration: ``scan_steps`` steps)."""
    _begin_capture()
    _warm(lambda: step.run(toks, labs), device)
    steady = _steady_capture(lambda: step.run(toks, labs), iters=2)
    float(step.run(toks, labs)[-1])                 # drain
    return _finish_record(cfg, "parallel.TrainStep", steady,
                          steps_per_iter=scan_steps,
                          counter_names=_TRAIN_COUNTERS)


def _bert_train_lane(batch, seq_len, scan_steps, device):
    import numpy as np
    import torch
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import parallel
    from mxnet_tpu_torch.gluon.model_zoo import bert

    vocab = 30522
    ctx = _ctx(device)
    dev = torch.device("cpu" if device == "cpu" else "cuda")
    mx.random.seed(0)
    np.random.seed(0)
    model = bert.bert_model("bert_3_128_2", vocab_size=vocab,
                            max_length=seq_len, dropout=0.0, device=ctx,
                            generator=torch.Generator(device=dev)
                            .manual_seed(0))
    step = parallel.TrainStep(model, _lm_loss,
                              mx.optimizer.Adam(learning_rate=1e-4),
                              mesh=parallel.make_mesh(devices=[ctx]))
    toks, labs = _tokens(0, vocab, (scan_steps, batch, seq_len), dev)
    return _train_lane(
        step, toks, labs, device,
        {"model": "bert_3_128_2", "batch": batch, "seq_len": seq_len,
         "scan_steps": scan_steps, "dtype": "float32"}, scan_steps)


def _lane_bert_headline(device):
    return _bert_train_lane(batch=4, seq_len=32, scan_steps=2, device=device)


def _lane_bert_seq512(device):
    return _bert_train_lane(batch=2, seq_len=512, scan_steps=2,
                            device=device)


def _lane_llama_longseq(device):
    """2 layers of 64 units, 4 heads over 2 kv heads (GQA: the flash
    kernels see (1, 4, 2048, 16), causal, f32)."""
    import numpy as np
    import torch
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import parallel
    from mxnet_tpu_torch.gluon.model_zoo.llama import LlamaModel

    vocab, batch, seq_len, scan_steps = 512, 1, 2048, 1
    ctx = _ctx(device)
    dev = torch.device("cpu" if device == "cpu" else "cuda")
    mx.random.seed(0)
    np.random.seed(0)
    model = LlamaModel(vocab_size=vocab, num_layers=2, units=64, hidden=172,
                       heads=4, kv_heads=2, remat=False)
    model.initialize(mx.initializer.Normal(0.02), ctx=ctx)
    step = parallel.TrainStep(model, _lm_loss,
                              mx.optimizer.Adam(learning_rate=1e-4),
                              mesh=parallel.make_mesh(devices=[ctx]))
    toks, labs = _tokens(0, vocab, (scan_steps, batch, seq_len), dev)
    return _train_lane(
        step, toks, labs, device,
        {"model": "llama_tiny_arch", "batch": batch, "seq_len": seq_len,
         "scan_steps": scan_steps, "dtype": "float32"}, scan_steps)


def _lane_multichip(device):
    """The (2, 2, 2) dp x fsdp x tp mesh: eight shards of one device (the
    port's mesh is single-controller; its shards may share a card)."""
    import numpy as np
    import torch
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import parallel, sharding
    from mxnet_tpu_torch.gluon.model_zoo.llama import llama_model

    vocab, seq, batch = 64, 16, 16
    ctx = _ctx(device)
    dev = torch.device("cpu" if device == "cpu" else "cuda")
    mx.random.seed(29)
    np.random.seed(29)
    net = llama_model("llama_tiny", vocab_size=vocab)
    net.initialize(mx.initializer.Normal(0.05), ctx=ctx)
    st = parallel.TrainStep(
        net, _lm_loss, mx.optimizer.Adam(learning_rate=1e-3),
        mesh=parallel.DeviceMesh(shape=(2, 2, 2),
                                 axis_names=("dp", "fsdp", "tp"),
                                 devices=[ctx] * 8),
        donate=True, partition_rules=sharding.llama_fsdp_rules(),
        data_spec=("dp",))
    r = np.random.RandomState(23)
    toks = r.randint(0, vocab, (batch, seq)).astype("int32")
    labs = np.roll(toks, -1, axis=1).astype("int32")
    toks, labs = torch.tensor(toks, device=dev), torch.tensor(labs,
                                                              device=dev)

    def one_step():
        return st(toks, labs)

    _begin_capture()
    _warm(one_step, device)
    steady = _steady_capture(one_step, iters=2)
    float(one_step())                                 # drain
    return _finish_record(
        {"model": "llama_tiny", "batch": batch, "seq_len": seq,
         "mesh": "dp2xfsdp2xtp2", "rules": "llama_fsdp_rules",
         "donate": True, "dtype": "float32"},
        "parallel.TrainStep", steady, counter_names=_TRAIN_COUNTERS)


def _llama_tiny_params(seed):
    """{name: numpy weight} of the zoo llama_tiny (vocab 101, names under
    ``llm_``): Normal(0, 0.05) from ``np.random.RandomState(seed)``, drawn
    in sorted name order (a reference net given these by name holds the
    same model)."""
    import numpy as np
    from mxnet_tpu_torch.gluon.model_zoo import llama
    net = llama.llama_model("llama_tiny", vocab_size=101, prefix="llm_")
    r = np.random.RandomState(seed)
    return {name: r.normal(0.0, 0.05, p.shape).astype(np.float32)
            for name, p in sorted(net.collect_params().items())}


def _build_llama_tiny(seed, device):
    from mxnet_tpu_torch import convert
    return convert.llama_from_gluon(_llama_tiny_params(seed), "llm_",
                                    "llama_tiny", device=_ctx(device))


_SERVING_COUNTERS = (
    "mxnet_serving_prefill_positions_total",
    "mxnet_serving_token_positions_total",
    "mxnet_serving_tokens_total",
    "mxnet_serving_decode_steps_total",
    "mxnet_serving_requests_completed_total",
)


def _lane_serving_continuous(device):
    from mxnet_tpu_torch import serving

    net = _build_llama_tiny(7, device)
    sysp = [40 + i for i in range(8)]         # 2 shared full blocks
    prompts = [sysp + [70], sysp + [71, 72], [5, 9, 11],
               [7, 8, 9, 10, 3, 4], [12] * 9, [90]]
    eng = serving.ServingEngine(net, eos_id=-1, max_batch=4, block_tokens=4,
                                max_seq=64, prefill_tokens=16,
                                prefix_cache=True)
    _begin_capture()
    eng.generate([[1, 2, 3]], max_new_tokens=2)       # warm-up
    steady = _steady_capture(
        lambda: eng.generate(prompts, max_new_tokens=8), iters=1)
    return _finish_record(
        {"model": "llama_tiny", "requests": len(prompts), "max_batch": 4,
         "block_tokens": 4, "max_new_tokens": 8, "prefix_cache": True},
        "serving.llama_decode", steady,
        counter_names=_SERVING_COUNTERS + (
            "mxnet_serving_prefix_hits_total",
            "mxnet_serving_prefix_hit_tokens_total"))


def _lane_serving_spec_decode(device):
    from mxnet_tpu_torch import serving

    net = _build_llama_tiny(7, device)
    draft = _build_llama_tiny(23, device)     # divergent draft, same arch
    prompts = [[5, 9, 11], [7, 8, 9, 10, 3, 4], [40, 41], [12] * 9]
    eng = serving.ServingEngine(net, eos_id=-1, max_batch=4, block_tokens=4,
                                max_seq=64, prefill_tokens=16,
                                draft_model=draft, spec_k=3)
    _begin_capture()
    eng.generate([[1, 2, 3]], max_new_tokens=2)
    steady = _steady_capture(
        lambda: eng.generate(prompts, max_new_tokens=8), iters=1)
    return _finish_record(
        {"model": "llama_tiny", "draft": "llama_tiny", "spec_k": 3,
         "requests": len(prompts), "max_batch": 4, "max_new_tokens": 8},
        "serving.llama_multi", steady,
        counter_names=_SERVING_COUNTERS + (
            "mxnet_serving_draft_steps_total",
            "mxnet_serving_accepted_draft_tokens"))


def _lane_trainer_fused_kvstore(device):
    """The un-fusing red-path lane: a bert-ish gradient set through the
    fused pushpull.  ``MXNET_KVSTORE_BUCKET_MB=0`` degrades it to the
    per-key loop — the dispatch-per-step explosion the gate must catch
    (tests/test_torch_perfgate.py injects exactly that)."""
    import numpy as np
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import nd

    ctx = _ctx(device)
    mx.random.seed(0)
    np.random.seed(0)
    shapes = [(256, 64)]
    for _ in range(2):                    # 2 "layers" of mixed tensors
        shapes += [(64, 64)] * 4 + [(64, 256), (256, 64)] + [(64,)] * 4
    shapes += [(64, 256)]
    kv = mx.kv.create("local")
    keys, grads, outs = [], [], []
    for i, s in enumerate(shapes):
        r = np.random.RandomState(i)
        k = f"w{i}"
        kv.init(k, nd.array(r.randn(*s).astype(np.float32), ctx=ctx))
        keys.append(k)
        # 2 replicas per key: the reduce is real math on both the fused
        # and the degraded per-key path
        grads.append([nd.array(r.randn(*s).astype(np.float32), ctx=ctx),
                      nd.array(r.randn(*s).astype(np.float32), ctx=ctx)])
        outs.append(nd.array(np.zeros(s, np.float32), ctx=ctx))

    _begin_capture()
    kv.pushpull_list(keys, grads, outs)               # warm-up
    outs[0].asnumpy()
    steady = _steady_capture(
        lambda: kv.pushpull_list(keys, grads, outs), iters=2,
        extra_dispatch_counters=("mxnet_kvstore_push_seconds",
                                 "mxnet_kvstore_pull_seconds",
                                 "mxnet_kvstore_fused_buckets_total"))
    outs[0].asnumpy()                                 # drain
    return _finish_record(
        {"tensors": len(shapes), "bucket_mb":
         config.get_float("MXNET_KVSTORE_BUCKET_MB", 25.0),
         "dtype": "float32"},
        "kvstore.fusion.reduce", steady,
        counter_names=("mxnet_kvstore_fused_buckets_total",
                       "mxnet_kvstore_fused_keys_total",
                       "mxnet_kvstore_fused_pushpulls_total",
                       "mxnet_kvstore_push_bytes_total",
                       "mxnet_kvstore_pull_bytes_total"))


# name -> (runner, mesh shards, description): the reference's seven lanes
# and configurations.  The shard count is the reference's virtual device
# count; the port's shards of one lane share its one device.
LANES = {
    "bert_headline": (_lane_bert_headline, 1,
                      "bert_3_128_2 b4 s32 scan2 train step (CI config)"),
    "bert_seq512": (_lane_bert_seq512, 1,
                    "bert_3_128_2 b2 s512 scan2 train step"),
    "llama_longseq": (_lane_llama_longseq, 1,
                      "llama 2L/64u seq-2048 causal-LM train step"),
    "multichip_dp2fsdp2tp2": (_lane_multichip, 8,
                              "llama_tiny dp2xfsdp2xtp2 donated fsdp step"),
    "serving_continuous": (_lane_serving_continuous, 1,
                           "paged-KV continuous batching + prefix cache"),
    "serving_spec_decode": (_lane_serving_spec_decode, 1,
                            "speculative decode, divergent draft, k=3"),
    "trainer_fused_kvstore": (_lane_trainer_fused_kvstore, 1,
                              "fused gradient pushpull (red-path lane)"),
}


def lane_names():
    return list(LANES)


def run_lane(name, device="cuda"):
    """Execute one lane in THIS process on ``device`` ("cuda", the
    default, or "cpu") and return its record.  The CLI runs each lane in a
    fresh child so caches and registries can never leak across lanes."""
    if name not in LANES:
        raise KeyError(f"unknown perfgate lane {name!r}; "
                       f"have {sorted(LANES)}")
    if device not in WARMUP_CALLS:
        raise ValueError(f"perfgate lanes run on 'cuda' or 'cpu', not "
                         f"{device!r}")
    return LANES[name][0](device)
