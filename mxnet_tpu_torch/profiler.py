"""mx.profiler — the port of ``mxnet_tpu/profiler.py``: a facade over
``mx.telemetry`` and ``torch.profiler``.

The host-side timeline and per-op table come from ``telemetry`` (the span
tracer and the dispatch ledger fed by ``ops.registry``); the device
timeline comes from ``torch.profiler.profile`` with the CPU and, where
there is a card, CUDA activities (CUPTI), where the reference runs
``jax.profiler``.  At ``stop()`` the device trace is exported with
``export_chrome_trace`` into ``trace_dir`` (``<filename stem>_torch_trace/
device_trace.json``; :func:`device_trace_path` names the file).

API parity: set_config, set_state('run'/'stop'), start/stop, dump, dumps,
scope/Task/Frame/Counter/Marker, pause/resume.  ``dump()`` writes the host
timeline as Chrome-trace JSON with the per-op aggregates under
``otherData.opAggregates``; ``dumps(format="table")`` (default) renders the
aggregates as a text table and ``format="json"`` as JSON.

State discipline, as in the reference: the device trace's lifecycle is
tracked apart from ``running`` — ``pause()`` stops host-side recording but
keeps the device trace open, and a later ``stop()`` still closes it.
``start()`` turns telemetry on only if it was off, and ``stop()`` turns it
off only then.  A device trace that fails to start raises.
"""

from __future__ import annotations

import contextlib
import json
import os
import time

from . import telemetry
from .base import MXNetError

__all__ = ["set_config", "set_state", "start", "stop", "pause", "resume",
           "dump", "dumps", "scope", "Task", "Frame", "Counter", "Marker",
           "device_trace_path"]

_state = {
    "running": False,
    "filename": "profile.json",
    "trace_dir": None,
    "device_trace": False,  # torch.profiler open — independent of running
    "tel_owner": False,     # start() turned telemetry on; stop() turns it off
    "profile": None,        # the open torch.profiler.profile
    "trace_path": None,     # the last exported device trace
}


def set_config(filename="profile.json", profile_all=False,  # noqa: ARG001
               profile_symbolic=False, profile_imperative=False,  # noqa: ARG001
               profile_memory=False, profile_api=False,  # noqa: ARG001
               aggregate_stats=True, continuous_dump=False,  # noqa: ARG001
               **kwargs):  # noqa: ARG001
    _state["filename"] = filename
    _state["trace_dir"] = os.path.splitext(filename)[0] + "_torch_trace"
    telemetry.ledger.set_aggregate_stats(aggregate_stats)


def is_running():
    return _state["running"]


def set_state(state="stop", profile_process="worker"):  # noqa: ARG001
    if state == "run":
        start()
    else:
        stop()


def start(profile_process="worker"):  # noqa: ARG001
    if _state["running"]:
        return
    _state["running"] = True
    # a fresh profiling window: drop buffered spans and ledger rows
    telemetry.clear()
    _state["tel_owner"] = not telemetry.enable()
    if not _state["device_trace"]:
        import torch
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.start()
        _state["profile"] = prof
        _state["device_trace"] = True


def stop(profile_process="worker"):  # noqa: ARG001
    _state["running"] = False
    if _state["tel_owner"]:
        telemetry.disable()
        _state["tel_owner"] = False
    if _state["device_trace"]:
        # closes the device trace even after a pause()
        _state["device_trace"] = False
        prof, _state["profile"] = _state["profile"], None
        prof.stop()
        trace_dir = _state["trace_dir"] or "profile_torch_trace"
        os.makedirs(trace_dir, exist_ok=True)
        path = os.path.join(trace_dir, "device_trace.json")
        prof.export_chrome_trace(path)
        _state["trace_path"] = path


def device_trace_path():
    """The device trace that the last ``stop()`` exported (None before)."""
    return _state["trace_path"]


def pause(profile_process="worker"):  # noqa: ARG001
    """Suspend host-side recording; the device trace stays open so
    ``resume()`` continues into the same device timeline."""
    _state["running"] = False
    if _state["tel_owner"]:
        telemetry.disable()


def resume(profile_process="worker"):  # noqa: ARG001
    _state["running"] = True
    if _state["tel_owner"]:
        telemetry.enable()


def record_op(name, seconds):
    """Feed the per-op aggregate ledger."""
    telemetry.ledger.record_op(name, seconds)


def _ledger_rows(reset=False):
    snap = telemetry.ledger.snapshot(reset=reset)
    return sorted(snap.items(), key=lambda kv: -kv[1][1])


def _aggregate_dict(rows):
    return {
        name: {"calls": cnt, "total_ms": tot * 1e3, "min_ms": mn * 1e3,
               "max_ms": mx * 1e3, "avg_ms": tot / cnt * 1e3}
        for name, (cnt, tot, mn, mx) in rows}


def dumps(reset=False, format="table"):  # noqa: A002
    """Aggregate per-op stats: ``format="table"`` the text table (default),
    ``format="json"`` ``{name: {calls, total_ms, ...}}``."""
    if format == "json":
        return json.dumps(_aggregate_dict(_ledger_rows(reset)),
                          indent=2, sort_keys=True)
    if format != "table":
        raise MXNetError(f"unknown dumps format {format!r}: "
                         "expected 'table' or 'json'")
    lines = [f"{'Name':<40}{'Calls':>8}{'Total(ms)':>12}{'Min(ms)':>10}"
             f"{'Max(ms)':>10}{'Avg(ms)':>10}"]
    lines.append("-" * 90)
    for name, (cnt, tot, mn, mx) in _ledger_rows(reset):
        lines.append(f"{name:<40}{cnt:>8}{tot*1e3:>12.3f}{mn*1e3:>10.3f}"
                     f"{mx*1e3:>10.3f}{tot/cnt*1e3:>10.3f}")
    return "\n".join(lines)


def dump(finished=True, profile_process="worker"):  # noqa: ARG001
    """Write the host timeline as Chrome-trace JSON; the per-op aggregate
    ledger rides under otherData."""
    trace = telemetry.chrome_trace()
    trace.setdefault("otherData", {})["opAggregates"] = \
        _aggregate_dict(_ledger_rows())
    with open(_state["filename"], "w") as f:
        json.dump(trace, f)


@contextlib.contextmanager
def scope(name="<unk>"):
    """Profiling scope: a span, a ledger row and, with the device trace
    open, a ``torch.profiler.record_function`` range.  A no-op when
    neither the profiler nor telemetry is active."""
    if not (_state["running"] or telemetry.enabled()):
        yield
        return
    ann_cm = contextlib.nullcontext()
    if _state["device_trace"]:
        import torch
        ann_cm = torch.profiler.record_function(name)
    t0 = time.perf_counter()
    try:
        with telemetry.span(f"scope:{name}", "scope"), ann_cm:
            yield
    finally:
        if _state["running"]:
            record_op(f"scope:{name}", time.perf_counter() - t0)


class Task:
    def __init__(self, name, domain=None):  # noqa: ARG002
        self.name = name
        self._t0 = None

    def start(self):
        self._t0 = time.perf_counter_ns()

    def stop(self):
        if self._t0 is None:
            return
        t1 = time.perf_counter_ns()
        if telemetry.enabled():
            telemetry.get_tracer().add_event(
                f"task:{self.name}", "task", self._t0, t1)
        if _state["running"]:
            record_op(f"task:{self.name}", (t1 - self._t0) / 1e9)


Frame = Task


class Counter:
    def __init__(self, name, domain=None, value=0):  # noqa: ARG002
        self.name = name
        self.value = value

    def set_value(self, value):
        self.value = value

    def increment(self, delta=1):
        self.value += delta

    def decrement(self, delta=1):
        self.value -= delta

    def __iadd__(self, delta):
        self.increment(delta)
        return self

    def __isub__(self, delta):
        self.decrement(delta)
        return self


class Marker:
    def __init__(self, name, domain=None):  # noqa: ARG002
        self.name = name

    def mark(self, scope="process"):  # noqa: ARG002
        telemetry.instant(f"marker:{self.name}", "marker")
        if _state["running"]:
            record_op(f"marker:{self.name}", 0.0)
