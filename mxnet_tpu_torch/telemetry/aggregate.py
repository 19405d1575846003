"""Cross-process telemetry aggregation — the port's own copy of
``mxnet_tpu/telemetry/aggregate.py``: one merged view of a whole job.

- **export** — :func:`export_snapshot` serializes this process's state
  (spans + thread names + wall-clock anchor, metric registry, op ledger,
  step-clock summary, cost ledger) as one rank-tagged JSON file into
  ``MXNET_TELEMETRY_DIR``, committed atomically (write-then-rename).  When
  the knob is set, every process exports at exit (and the flight recorder
  exports on crashes), so a job leaves one shard per rank.
- **merge** — :func:`merged_chrome_trace` renders ONE Chrome trace
  (``pid`` = rank, ``process_name``/``thread_name`` metadata, timestamps
  shifted onto a shared wall-clock timeline) and
  :func:`merged_prometheus` ONE Prometheus snapshot (counters and
  histogram buckets summed across ranks, gauges summed as per-rank
  depths).
- **pool-worker shipping** — decode-pool workers attach
  :func:`counter_deltas` (the counters that moved since their last ack)
  to each task ack, and the parent folds them in with
  :func:`absorb_counter_deltas`.

The shard format and the merge are the reference's, so shards cross
between the packages: the port's merge reads the reference's shards and
the reference's merge reads the port's, with the same output for the same
contents.  The rank tag comes from :func:`set_rank` (the serving router
and its replicas call it) and falls back to ``MXNET_DIST_RANK``.
Stdlib-only.
"""

from __future__ import annotations

import atexit
import json
import os
import socket
import threading
import time

from .. import config
from . import costmodel, ledger, metrics, stepclock, tracer

__all__ = [
    "set_rank", "rank", "collection_dir", "snapshot", "export_snapshot",
    "load_snapshots", "merged_chrome_trace", "merged_registry",
    "merged_prometheus", "counter_deltas", "absorb_counter_deltas",
    "install_atexit",
]

SNAPSHOT_VERSION = 1
SNAPSHOT_PREFIX = "telemetry-"

_lock = threading.Lock()
_rank = None
_shipped: dict = {}        # (name, labels) -> counter value last shipped
_atexit_installed = False


def set_rank(r):
    """Tag this process with its job rank (the serving router and its
    replicas call this); also labels the local Chrome trace's
    process_name."""
    global _rank
    with _lock:
        _rank = None if r is None else int(r)
    if r is not None:
        tracer.get_tracer().set_process_label(
            f"mxnet_tpu_torch rank {int(r)}")


def rank():
    """This process's rank: set_rank() value, else MXNET_DIST_RANK, else 0."""
    with _lock:
        if _rank is not None:
            return _rank
    return config.get_int("MXNET_DIST_RANK", 0)


def collection_dir():
    return config.get("MXNET_TELEMETRY_DIR")


# -- export -----------------------------------------------------------------

def snapshot():
    """This process's full telemetry state as one JSON-serializable dict —
    the collection-dir wire format."""
    tr = tracer.get_tracer()
    return {
        "version": SNAPSHOT_VERSION,
        "rank": rank(),
        "pid": os.getpid(),
        "host": socket.gethostname(),
        "time": time.time(),
        "process_label": tr.process_label,
        "wall_anchor_us": tr.wall_anchor_us,
        "events": tr.events(),
        "thread_names": {str(k): v for k, v in tr.thread_names().items()},
        "dropped": tr.dropped,
        "metrics": metrics.REGISTRY.export_state(),
        "ledger": {k: list(v) for k, v in ledger.snapshot().items()},
        "stepclock": stepclock.STEP_CLOCK.summary(),
        "costmodel": costmodel.LEDGER.snapshot(),
    }


def export_snapshot(directory=None, path=None):
    """Atomically write this process's snapshot into the collection dir
    (``telemetry-rank<R>-pid<P>.json``; re-exports from the same process
    replace their own file).  Returns the path, or None when no directory
    is configured."""
    if path is None:
        directory = directory or collection_dir()
        if not directory:
            return None
        os.makedirs(directory, exist_ok=True)
        path = os.path.join(
            directory,
            f"{SNAPSHOT_PREFIX}rank{rank():05d}-pid{os.getpid()}.json")
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(snapshot(), f, default=str)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    return path


def install_atexit():
    """Register the exit-time export exactly once (telemetry.__init__
    calls this when MXNET_TELEMETRY_DIR is set)."""
    global _atexit_installed
    with _lock:
        if _atexit_installed:
            return
        _atexit_installed = True
    atexit.register(_atexit_export)


def _atexit_export():
    try:
        export_snapshot()
    except Exception:  # noqa: BLE001 — never break interpreter shutdown
        pass


# -- merge ------------------------------------------------------------------

def load_snapshots(directory=None, latest_per_rank=True):
    """Parse every ``telemetry-*.json`` shard in the collection dir.
    Corrupt/partial files are skipped (the atomic rename makes them rare:
    only a full pre-rename crash leaves a ``.tmp``, which is ignored).
    ``latest_per_rank`` keeps one shard per rank (newest export) so
    restarted jobs don't double-count dead incarnations."""
    directory = directory or collection_dir()
    out = []
    if not directory or not os.path.isdir(directory):
        return out
    for fn in sorted(os.listdir(directory)):
        if not (fn.startswith(SNAPSHOT_PREFIX) and fn.endswith(".json")):
            continue
        try:
            with open(os.path.join(directory, fn)) as f:
                snap = json.load(f)
        except (OSError, ValueError):
            continue
        if isinstance(snap, dict):
            out.append(snap)
    if latest_per_rank:
        by_rank: dict = {}
        for s in out:
            r = s.get("rank", 0)
            if r not in by_rank \
                    or s.get("time", 0) > by_rank[r].get("time", 0):
                by_rank[r] = s
        out = [by_rank[r] for r in sorted(by_rank)]
    return out


def merged_chrome_trace(snapshots=None, directory=None):
    """One Chrome-trace dict from many rank snapshots: ``pid`` = rank,
    ``process_name``/``process_sort_index``/``thread_name`` metadata per
    rank, and every rank's relative timestamps shifted onto the shared
    wall-clock timeline (earliest tracer origin = ts 0)."""
    if snapshots is None:
        snapshots = load_snapshots(directory)
    events = []
    dropped = 0
    if not snapshots:
        return {"traceEvents": events, "displayTimeUnit": "ms"}
    base = min(s.get("wall_anchor_us", 0.0) for s in snapshots)
    for s in sorted(snapshots, key=lambda s: (s.get("rank") or 0,
                                              s.get("pid") or 0)):
        pid = s.get("rank")
        if pid is None:
            pid = s.get("pid", 0)
        shift = s.get("wall_anchor_us", base) - base
        label = s.get("process_label")
        # the reference's default label is ranked, as the reference's
        # merge does, so that both merges give the same trace
        if not label or label == "mxnet_tpu":
            label = f"mxnet_tpu rank {pid}"
        events.append({"name": "process_name", "ph": "M", "pid": pid,
                       "args": {"name": label}})
        events.append({"name": "process_sort_index", "ph": "M", "pid": pid,
                       "args": {"sort_index": pid}})
        for tid, tname in sorted((s.get("thread_names") or {}).items()):
            events.append({"name": "thread_name", "ph": "M", "pid": pid,
                           "tid": int(tid), "args": {"name": tname}})
        for ev in s.get("events", ()):
            e = dict(ev)
            e["pid"] = pid
            if "ts" in e:
                e["ts"] = e["ts"] + shift
            events.append(e)
        dropped += int(s.get("dropped", 0) or 0)
    trace = {"traceEvents": events, "displayTimeUnit": "ms"}
    if dropped:
        trace["otherData"] = {"droppedEvents": dropped}
    return trace


def merged_registry(snapshots):
    """A fresh MetricsRegistry holding the rank-summed union of every
    snapshot's metrics: counters/gauges sum, histogram buckets sum
    bucket-by-bucket (bounds match across ranks — same code registered
    them; on drift the tail bucket absorbs, keeping count/sum truthful)."""
    reg = metrics.MetricsRegistry()
    for s in snapshots:
        for e in s.get("metrics", ()):
            labels = e.get("labels") or None
            kind = e.get("kind")
            try:
                if kind == "counter":
                    v = e.get("value", 0) or 0
                    c = reg.counter(e["name"], e.get("help", ""),
                                    labels=labels)
                    if v:
                        c.inc(v)
                elif kind == "gauge":
                    reg.gauge(e["name"], e.get("help", ""),
                              labels=labels).inc(e.get("value", 0) or 0)
                elif kind == "histogram":
                    # registering with this rank's bounds would RAISE on
                    # cross-rank bounds drift (config/version skew during
                    # an elastic restart) and silently drop the series —
                    # reuse the registered histogram and let _absorb's
                    # tail-bucket fallback keep count/sum truthful
                    h = reg.get(e["name"], labels=labels)
                    if h is None:
                        h = reg.histogram(e["name"], e.get("help", ""),
                                          buckets=e["bounds"], labels=labels)
                    elif not isinstance(h, metrics.Histogram):
                        continue
                    h._absorb(e["bounds"], e["counts"], e["sum"], e["count"])
            except (KeyError, TypeError, ValueError):
                continue   # one malformed entry must not sink the merge
    return reg


def merged_prometheus(snapshots=None, directory=None):
    """The merged job-wide metric state in Prometheus text format."""
    if snapshots is None:
        snapshots = load_snapshots(directory)
    return merged_registry(snapshots).to_prometheus()


# -- pool-worker counter shipping (the decode-pool ack channel) -------------

def counter_deltas():
    """Counters that moved since the last call, as a small pickleable
    list ``[(name, labels, delta), ...]`` — a decode-pool worker attaches
    this to its task ack so its chaos/resilience/op counters reach the
    parent without a side channel."""
    out = []
    with _lock:
        for m in metrics.REGISTRY.all_metrics():   # no per-ack sort
            if m.kind != "counter":
                continue
            key = (m.name, m.labels)
            v = m.value
            d = v - _shipped.get(key, 0)
            if d:
                _shipped[key] = v
                out.append((m.name, dict(m.labels), d))
    return out


def absorb_counter_deltas(deltas):
    """Fold a worker's shipped counter deltas into this process's
    registry (get-or-create by name+labels, then add)."""
    for name, labels, d in deltas or ():
        if d > 0:
            metrics.REGISTRY.counter(name, labels=labels or None).inc(d)
