"""Structured span tracer — the host-side timeline half of telemetry.

The port's own copy of ``mxnet_tpu/telemetry/tracer.py``: every ``span()``
records begin/end host timestamps into a bounded ring buffer;
``chrome_trace()`` renders the buffer as Chrome-trace JSON (``traceEvents``
with ``ph:"X"`` complete events) that chrome://tracing / Perfetto load.

Recording is gated on the module-level ``_ENABLED`` flag.  When off,
``span()`` returns a shared stateless no-op context manager.  Stdlib-only.
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque

from .. import config

__all__ = ["Span", "Tracer", "span", "instant", "async_event", "enable",
           "disable", "enabled", "get_tracer", "clear", "chrome_trace"]

# Single flag gating ALL recording.  Rebound by enable()/disable(); hot
# paths read it as a module attribute (one load, no call).
_ENABLED = False


class _NullSpan:
    """Shared stateless no-op returned by span() when telemetry is off."""

    __slots__ = ()
    duration_s = 0.0
    attrs: dict = {}  # read-only by convention; set() never writes it

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs):  # noqa: ARG002
        return self


NULL_SPAN = _NullSpan()


class Span:
    """One timed region.  Context-manager; records on exit."""

    __slots__ = ("_tracer", "name", "category", "attrs", "_t0", "_t1")

    def __init__(self, tracer, name, category, attrs):
        self._tracer = tracer
        self.name = name
        self.category = category
        self.attrs = attrs
        self._t0 = None
        self._t1 = None

    def set(self, **attrs):
        """Attach attributes mid-span (rendered under Chrome-trace args)."""
        self.attrs.update(attrs)
        return self

    @property
    def duration_s(self):
        if self._t0 is None or self._t1 is None:
            return 0.0
        return (self._t1 - self._t0) / 1e9

    def __enter__(self):
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self._t1 = time.perf_counter_ns()
        self._tracer.add_event(self.name, self.category, self._t0, self._t1,
                               self.attrs)
        return False


class Tracer:
    """Thread-safe bounded ring buffer of trace events.

    Events are stored as ready-to-serialize Chrome-trace dicts (``ph:"X"``
    complete events, timestamps in microseconds relative to tracer start)
    so export is a snapshot, not a transform.
    """

    def __init__(self, capacity=None):
        if capacity is None:
            capacity = config.get_int("MXNET_TELEMETRY_BUFFER", 65536)
        self._events = deque(maxlen=max(1, int(capacity)))
        self._lock = threading.Lock()
        self._pid = os.getpid()
        self._t0_ns = time.perf_counter_ns()
        self._dropped = 0
        self._tid_names: dict = {}
        self._process_label = "mxnet_tpu_torch"

    @property
    def capacity(self):
        return self._events.maxlen

    @property
    def wall_anchor_us(self):
        """Wall-clock (unix epoch) microseconds of this tracer's ``ts==0``
        origin — the anchor the cross-process merger uses to place every
        rank's relative timestamps on one shared timeline."""
        return (time.time_ns() - (time.perf_counter_ns() - self._t0_ns)) / 1e3

    @property
    def process_label(self):
        return self._process_label

    def set_process_label(self, label):
        """Name this process carries in Chrome-trace ``process_name``
        metadata (the router sets ``mxnet_tpu_torch router``)."""
        with self._lock:
            self._process_label = str(label)

    def _push(self, ev):
        with self._lock:
            tid = ev["tid"]
            if tid not in self._tid_names:
                self._tid_names[tid] = threading.current_thread().name
            if len(self._events) == self._events.maxlen:
                self._dropped += 1
            self._events.append(ev)

    def add_event(self, name, category, begin_ns, end_ns, attrs=None):
        """Record one complete ('X') event from raw perf_counter_ns stamps."""
        ev = {
            "name": name,
            "cat": category,
            "ph": "X",
            "ts": (begin_ns - self._t0_ns) / 1e3,
            "dur": (end_ns - begin_ns) / 1e3,
            "pid": self._pid,
            "tid": threading.get_ident(),
        }
        if attrs:
            ev["args"] = dict(attrs)
        self._push(ev)

    def add_instant(self, name, category, attrs=None):
        """Record an instant ('i') event at now."""
        ev = {
            "name": name,
            "cat": category,
            "ph": "i",
            "s": "t",
            "ts": (time.perf_counter_ns() - self._t0_ns) / 1e3,
            "pid": self._pid,
            "tid": threading.get_ident(),
        }
        if attrs:
            ev["args"] = dict(attrs)
        self._push(ev)

    def add_async(self, name, category, ph, id_, attrs=None, ts_ns=None):
        """Record one nestable async event (``ph`` in 'b'/'n'/'e') keyed by
        ``id`` — Perfetto renders same-(cat, id) events as one linked span
        tree, which is how serving requests thread queue → prefill →
        decode iterations → finish across scheduler iterations."""
        if ts_ns is None:
            ts_ns = time.perf_counter_ns()
        ev = {
            "name": name,
            "cat": category,
            "ph": ph,
            "id": str(id_),
            "ts": (ts_ns - self._t0_ns) / 1e3,
            "pid": self._pid,
            "tid": threading.get_ident(),
        }
        if attrs:
            ev["args"] = dict(attrs)
        self._push(ev)

    def thread_names(self):
        """{tid: thread name} for every thread that recorded an event."""
        with self._lock:
            return dict(self._tid_names)

    def events(self):
        with self._lock:
            return list(self._events)

    def clear(self):
        with self._lock:
            self._events.clear()
            self._dropped = 0

    @property
    def dropped(self):
        return self._dropped

    def chrome_trace(self, extra_events=None):
        """The buffer as a Chrome-trace JSON object (a plain dict).

        ``extra_events`` lets callers (the profiler facade) merge additional
        event lists into the same timeline.  ``process_name`` and per-tid
        ``thread_name`` metadata (``ph:"M"``) ride along so single- and
        merged multi-rank traces are human-labeled in Perfetto.
        """
        events = [{
            "name": "process_name", "ph": "M", "pid": self._pid,
            "args": {"name": self._process_label},
        }]
        for tid, tname in sorted(self.thread_names().items()):
            events.append({
                "name": "thread_name", "ph": "M", "pid": self._pid,
                "tid": tid, "args": {"name": tname},
            })
        events.extend(self.events())
        if extra_events:
            events.extend(extra_events)
        trace = {"traceEvents": events, "displayTimeUnit": "ms"}
        if self._dropped:
            trace["otherData"] = {"droppedEvents": self._dropped}
        return trace


_TRACER = Tracer()


def get_tracer():
    return _TRACER


def enable():
    """Turn recording on.  Returns the previous state."""
    global _ENABLED
    prev = _ENABLED
    _ENABLED = True
    return prev


def disable():
    """Turn recording off.  Returns the previous state."""
    global _ENABLED
    prev = _ENABLED
    _ENABLED = False
    return prev


def enabled():
    return _ENABLED


def span(name, category="host", **attrs):
    """``with telemetry.span("step", "trainer", batch=32): ...`` — records a
    complete event when telemetry is enabled; a shared no-op otherwise."""
    if not _ENABLED:
        return NULL_SPAN
    return Span(_TRACER, name, category, attrs)


def instant(name, category="host", **attrs):
    """Zero-duration marker event."""
    if _ENABLED:
        _TRACER.add_instant(name, category, attrs)


def async_event(name, category, ph, id_, **attrs):
    """Flag-gated async ('b'/'n'/'e') event — request span trees."""
    if _ENABLED:
        _TRACER.add_async(name, category, ph, id_, attrs or None)


def clear():
    _TRACER.clear()


def chrome_trace(extra_events=None):
    return _TRACER.chrome_trace(extra_events)
