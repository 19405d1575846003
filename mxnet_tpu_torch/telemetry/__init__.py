"""mx.telemetry of the port — span tracer and metrics registry.

The port's own copy of the two per-process pieces of
``mxnet_tpu/telemetry``:

- **spans** (``tracer``) — ``telemetry.span(name, category, **attrs)``
  records begin/end host timestamps into a ring buffer;
  ``chrome_trace()`` exports Chrome-trace JSON (``traceEvents``,
  ``process_name``/``thread_name`` metadata) for chrome://tracing or
  Perfetto; ``async_event`` threads a request's span tree by id.
- **metrics** (``metrics``) — the process-global Counter/Gauge/Histogram
  registry (optionally labeled) with Prometheus-text and JSON exporters.

Recording of spans is gated on one flag: ``MXNET_TELEMETRY=1`` in the
environment or ``telemetry.enable()`` at runtime; metrics always count.
Not ported yet (ROADMAP A.11): the step clock, the cost model, the
cross-process aggregation plane, the flight recorder, the HTTP scrape
endpoint, the perf gate, the per-op ledger and the op-dispatch hook.
"""

from __future__ import annotations

from .. import config
from . import metrics, tracer
from .metrics import (  # noqa: F401
    DEFAULT_BUCKETS, REGISTRY, Counter, Gauge, Histogram, MetricsRegistry,
    counter, gauge, histogram, to_json, to_prometheus,
)
from .tracer import (  # noqa: F401
    NULL_SPAN, Span, Tracer, async_event, chrome_trace, disable, enable,
    enabled, get_tracer, instant, span,
)

__all__ = [
    "span", "instant", "async_event", "enable", "disable", "enabled",
    "get_tracer", "chrome_trace", "clear",
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "REGISTRY",
    "counter", "gauge", "histogram", "to_prometheus", "to_json",
    "DEFAULT_BUCKETS", "metrics", "tracer", "env_enabled",
]


def clear():
    """Drop buffered trace events (metrics keep counting — use
    ``REGISTRY.reset()`` to zero them)."""
    tracer.clear()


_ENV_ENABLED = bool(config.get_int("MXNET_TELEMETRY", 0))
if _ENV_ENABLED:
    enable()


def env_enabled():
    """True when MXNET_TELEMETRY turned telemetry on at import."""
    return _ENV_ENABLED
