"""Per-op aggregate ledger — the port's own copy of
``mxnet_tpu/telemetry/ledger.py`` (the ``aggregate_stats.cc`` analog).

One row per op name: [count, total_s, min_s, max_s], fed by the dispatch
hook (``ops.registry.invoke`` through ``telemetry.record_dispatch``) and by
profiler scopes/tasks/markers.  The profiler facade renders this as its
table / JSON aggregate formats; it lives here so telemetry has no import
edge back into mx.profiler.  A captured ``parallel.TrainStep`` replays its
CUDA graph without dispatching through the registry: the ledger sees the
ops of the eager warm-up and of the capture, never those of a replay.

``set_aggregate_stats(False)`` (profiler.set_config parity) turns
accumulation off without touching span tracing or metrics.
"""

from __future__ import annotations

import threading
from collections import defaultdict

__all__ = ["record_op", "snapshot", "clear", "set_aggregate_stats",
           "aggregate_stats"]

_lock = threading.Lock()
_aggregate: dict = defaultdict(lambda: [0, 0.0, float("inf"), 0.0])
_enabled = True


def set_aggregate_stats(flag):
    global _enabled
    _enabled = bool(flag)


def aggregate_stats():
    return _enabled


def record_op(name, seconds):
    """One dispatch observation (the ExecuteOprBlock hook analog)."""
    if not _enabled:
        return
    with _lock:
        ent = _aggregate[name]
        ent[0] += 1
        ent[1] += seconds
        ent[2] = min(ent[2], seconds)
        ent[3] = max(ent[3], seconds)


def snapshot(reset=False):
    """{name: (count, total_s, min_s, max_s)}, optionally clearing."""
    with _lock:
        snap = {k: tuple(v) for k, v in _aggregate.items()}
        if reset:
            _aggregate.clear()
    return snap


def clear():
    with _lock:
        _aggregate.clear()
