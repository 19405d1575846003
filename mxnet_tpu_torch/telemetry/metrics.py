"""Metrics registry — Counter / Gauge / Histogram with text + JSON export.

The port's own copy of ``mxnet_tpu/telemetry/metrics.py`` (the port imports
nothing of the JAX package).  Metrics are process-global, get-or-create by
(name, labels), thread-safe, and export in two forms:

- ``to_prometheus()`` — the Prometheus text exposition format (``# HELP`` /
  ``# TYPE`` lines, ``_bucket{le="..."}`` cumulative histogram rows);
- ``to_json()`` — a plain dict rendered as JSON for programmatic checks.

A metric may carry a fixed label set; each label combination is its own
series under one exported name, with label values escaped per the
exposition format and rows emitted in a stable (name, labels) order.
``export_state()``/``Histogram._absorb`` are the merge protocol a
cross-process aggregation plane would ride (not ported: ROADMAP A.11).

Stdlib-only; safe to import anywhere.
"""

from __future__ import annotations

import bisect
import json
import math
import threading

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry", "REGISTRY",
           "counter", "gauge", "histogram", "to_prometheus", "to_json",
           "DEFAULT_BUCKETS"]

# Latency-oriented defaults (seconds): 10us .. 10s, the span of one host
# dispatch up to one full checkpoint write.
DEFAULT_BUCKETS = (
    1e-5, 2.5e-5, 5e-5, 1e-4, 2.5e-4, 5e-4, 1e-3, 2.5e-3, 5e-3,
    1e-2, 2.5e-2, 5e-2, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
)


def _labels_key(labels):
    """Canonical hashable form of a label set: sorted (k, v) str pairs."""
    if not labels:
        return ()
    return tuple(sorted((str(k), str(v)) for k, v in dict(labels).items()))


def _escape_label_value(v):
    """Prometheus text-format label-value escaping: backslash, quote,
    newline (in that order — escaping the escape char first)."""
    return (str(v).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _label_str(labels, extra=()):
    """``{k="v",...}`` rendering of a labels tuple (+ trailing pairs like
    ``le``); empty string when there are no labels at all."""
    items = list(labels) + list(extra)
    if not items:
        return ""
    body = ",".join(f'{k}="{_escape_label_value(v)}"' for k, v in items)
    return "{" + body + "}"


def _norm_buckets(buckets):
    """Histogram bound normalization: floats, deduplicated, ascending,
    non-finite bounds dropped (the +Inf bucket is ALWAYS implicit — an
    explicit inf bound would render a duplicate +Inf row)."""
    bounds = tuple(sorted({float(b) for b in buckets
                           if math.isfinite(float(b))}))
    if not bounds:
        raise ValueError("histogram needs at least one finite bucket "
                         "boundary")
    return bounds


class Counter:
    """Monotonically increasing count (ops dispatched, bytes moved)."""

    kind = "counter"
    __slots__ = ("name", "help", "labels", "_value", "_lock")

    def __init__(self, name, help="", labels=None):  # noqa: A002
        self.name = name
        self.help = help
        self.labels = _labels_key(labels)
        self._value = 0
        self._lock = threading.Lock()

    def inc(self, amount=1):
        if amount < 0:
            raise ValueError("counters only go up; use a Gauge")
        with self._lock:
            self._value += amount

    @property
    def value(self):
        return self._value

    def _reset(self):
        with self._lock:
            self._value = 0

    def snapshot(self):
        return {"type": self.kind, "help": self.help,
                "labels": dict(self.labels), "value": self._value}

    def render(self, lines):
        lines.append(f"{self.name}{_label_str(self.labels)} {self._value}")


class Gauge:
    """Point-in-time value (queue depth, loss scale)."""

    kind = "gauge"
    __slots__ = ("name", "help", "labels", "_value", "_lock")

    def __init__(self, name, help="", labels=None):  # noqa: A002
        self.name = name
        self.help = help
        self.labels = _labels_key(labels)
        self._value = 0.0
        self._lock = threading.Lock()

    def set(self, value):
        with self._lock:
            self._value = value

    def inc(self, amount=1):
        with self._lock:
            self._value += amount

    def dec(self, amount=1):
        with self._lock:
            self._value -= amount

    @property
    def value(self):
        return self._value

    def _reset(self):
        with self._lock:
            self._value = 0.0

    def snapshot(self):
        return {"type": self.kind, "help": self.help,
                "labels": dict(self.labels), "value": self._value}

    def render(self, lines):
        lines.append(f"{self.name}{_label_str(self.labels)} {self._value}")


class Histogram:
    """Distribution over fixed bucket boundaries (latency histograms).

    ``buckets`` are upper bounds in ascending order; an implicit +Inf bucket
    catches the tail (always emitted, exactly once — explicit non-finite
    bounds are normalized away).  Export follows Prometheus cumulative-bucket
    semantics.
    """

    kind = "histogram"
    __slots__ = ("name", "help", "labels", "buckets", "_counts", "_sum",
                 "_count", "_lock")

    def __init__(self, name, help="", buckets=DEFAULT_BUCKETS,  # noqa: A002
                 labels=None):
        self.name = name
        self.help = help
        self.labels = _labels_key(labels)
        self.buckets = _norm_buckets(buckets)
        self._counts = [0] * (len(self.buckets) + 1)  # last slot = +Inf
        self._sum = 0.0
        self._count = 0
        self._lock = threading.Lock()

    def observe(self, value):
        idx = bisect.bisect_left(self.buckets, value)
        with self._lock:
            self._counts[idx] += 1
            self._sum += value
            self._count += 1

    @property
    def count(self):
        return self._count

    @property
    def sum(self):
        return self._sum

    def _reset(self):
        with self._lock:
            self._counts = [0] * (len(self.buckets) + 1)
            self._sum = 0.0
            self._count = 0

    def _raw(self):
        """(bounds, per-bucket counts incl. +Inf tail, sum, count) — the
        mergeable form telemetry.aggregate ships across processes."""
        with self._lock:
            return self.buckets, list(self._counts), self._sum, self._count

    def _absorb(self, bounds, counts, sum_, count):
        """Fold another process's raw state in.  Bounds are expected to
        match (same code, same registration); on drift the observations
        land in the +Inf tail so the count/sum stay truthful."""
        with self._lock:
            if tuple(float(b) for b in bounds) == self.buckets \
                    and len(counts) == len(self._counts):
                for i, c in enumerate(counts):
                    self._counts[i] += int(c)
            else:
                self._counts[-1] += int(count)
            self._sum += float(sum_)
            self._count += int(count)

    def snapshot(self):
        with self._lock:
            counts = list(self._counts)
            total, ssum = self._count, self._sum
        cum, buckets = 0, {}
        for bound, c in zip(self.buckets, counts):
            cum += c
            buckets[bound] = cum
        return {"type": self.kind, "help": self.help,
                "labels": dict(self.labels), "buckets": buckets,
                "sum": ssum, "count": total}

    def render(self, lines):
        snap = self.snapshot()
        for bound, cum in snap["buckets"].items():
            lines.append(
                f"{self.name}_bucket"
                f"{_label_str(self.labels, (('le', f'{bound:g}'),))} {cum}")
        lines.append(
            f"{self.name}_bucket"
            f"{_label_str(self.labels, (('le', '+Inf'),))} {snap['count']}")
        lines.append(
            f"{self.name}_sum{_label_str(self.labels)} {snap['sum']}")
        lines.append(
            f"{self.name}_count{_label_str(self.labels)} {snap['count']}")


class MetricsRegistry:
    """Get-or-create home for all metrics; one per process by default.

    Keyed by (name, labels): one metric name may carry several label
    combinations (each its own series) but exactly one kind.
    """

    def __init__(self):
        self._metrics: dict = {}
        self._kinds: dict = {}
        self._lock = threading.Lock()

    def _get_or_create(self, cls, name, help, labels=None, **kwargs):  # noqa: A002
        lk = _labels_key(labels)
        key = (name, lk)
        with self._lock:
            kind = self._kinds.get(name)
            if kind is not None and kind != cls.kind:
                raise TypeError(
                    f"metric {name!r} already registered as {kind}, "
                    f"requested {cls.kind}")
            m = self._metrics.get(key)
            if m is None:
                m = cls(name, help, labels=labels, **kwargs)
                self._metrics[key] = m
                self._kinds[name] = cls.kind
            return m

    def counter(self, name, help="", labels=None):  # noqa: A002
        return self._get_or_create(Counter, name, help, labels=labels)

    def gauge(self, name, help="", labels=None):  # noqa: A002
        return self._get_or_create(Gauge, name, help, labels=labels)

    def histogram(self, name, help="", buckets=DEFAULT_BUCKETS,  # noqa: A002
                  labels=None):
        h = self._get_or_create(Histogram, name, help, labels=labels,
                                buckets=buckets)
        want = _norm_buckets(buckets)
        if h.buckets != want:
            raise ValueError(
                f"histogram {name!r} already registered with buckets "
                f"{h.buckets}, requested {want}")
        return h

    def get(self, name, labels=None):
        return self._metrics.get((name, _labels_key(labels)))

    def collect(self):
        """All metrics in stable (name, labels) order."""
        with self._lock:
            return [self._metrics[k] for k in sorted(self._metrics)]

    def all_metrics(self):
        """All metrics, registration order (no sort) — for per-call scans
        on hot paths (the decode-pool ack channel) where render order is
        irrelevant."""
        with self._lock:
            return list(self._metrics.values())

    def reset(self):
        """Zero every metric in place (handles stay valid — instrumented
        modules hold module-level references)."""
        for m in self.collect():
            m._reset()

    def to_prometheus(self):
        lines = []
        last_name = None
        for m in self.collect():
            if m.name != last_name:   # HELP/TYPE once per name, not per row
                if m.help:
                    lines.append(f"# HELP {m.name} {m.help}")
                lines.append(f"# TYPE {m.name} {m.kind}")
                last_name = m.name
            m.render(lines)
        return "\n".join(lines) + ("\n" if lines else "")

    def to_json(self, indent=None):
        out = {}
        for m in self.collect():
            out[m.name + _label_str(m.labels)] = m.snapshot()
        return json.dumps(out, indent=indent, sort_keys=True)

    def export_state(self):
        """Mergeable dump of every metric — the wire format of the
        cross-process aggregation protocol (telemetry.aggregate)."""
        out = []
        for m in self.collect():
            e = {"name": m.name, "labels": dict(m.labels), "kind": m.kind,
                 "help": m.help}
            if isinstance(m, Histogram):
                bounds, counts, ssum, count = m._raw()
                e.update(bounds=list(bounds), counts=counts, sum=ssum,
                         count=count)
            else:
                e["value"] = m.value
            out.append(e)
        return out


REGISTRY = MetricsRegistry()


def counter(name, help="", labels=None):  # noqa: A002
    return REGISTRY.counter(name, help, labels=labels)


def gauge(name, help="", labels=None):  # noqa: A002
    return REGISTRY.gauge(name, help, labels=labels)


def histogram(name, help="", buckets=DEFAULT_BUCKETS, labels=None):  # noqa: A002
    return REGISTRY.histogram(name, help, buckets=buckets, labels=labels)


def to_prometheus():
    return REGISTRY.to_prometheus()


def to_json(indent=None):
    return REGISTRY.to_json(indent=indent)
