"""mx.telemetry of the port — the port's own copy of
``mxnet_tpu/telemetry``.

Per-process pieces:

- **spans** (``tracer``) — ``telemetry.span(name, category, **attrs)``
  records begin/end host timestamps into a ring buffer;
  ``chrome_trace()`` exports Chrome-trace JSON (``traceEvents``,
  ``process_name``/``thread_name`` metadata) for chrome://tracing or
  Perfetto; ``async_event`` threads a request's span tree by id.
- **metrics** (``metrics``) — the process-global Counter/Gauge/Histogram
  registry (optionally labeled) with Prometheus-text and JSON exporters.
- **ledger** (``ledger``) — the per-op aggregate table ``mx.profiler``
  renders, fed by :func:`record_dispatch` from ``ops.registry.invoke``.
- **stepclock** — per-step data_wait/h2d/compute/comms/optimizer
  attribution from ``gluon.Trainer``, the ``DataLoader`` and
  ``parallel.TrainStep``, the ``mxnet_step_phase_seconds{phase=}``
  histograms and the rolling input-/comms-/compute-bound verdict that
  :func:`report` renders.
- **costmodel** — the cost ledger: FLOPs (torch's ``FlopCounterMode``,
  the flash kernels by formula), bytes accessed and peak device bytes of
  each captured step signature, op, fused optimizer update and serving
  entry; analytic MFU and roofline verdicts against the card's peaks
  (``report(cost=True)``).

The job-wide plane on top:

- **aggregate** — the collection-directory protocol
  (``MXNET_TELEMETRY_DIR``): a rank-tagged snapshot per process at exit,
  merged into one Chrome trace (pid = rank) and one Prometheus snapshot;
  decode-pool workers ship their counters on their task acks.
- **flightrec** — the crash black box: bounded postmortem dumps on
  unhandled exceptions, deadlines, chaos exits, SIGTERM and SIGUSR2
  (``MXNET_FLIGHTREC*``).
- **httpd** — the live scrape plane (``MXNET_TELEMETRY_PORT``):
  ``/metrics``, ``/statusz``, ``/ledger.json``, ``/healthz``,
  ``/perfgate.json``.
- **perfgate** — the perf-regression gate: seven lanes' structural
  records (dispatches a step, builds at steady state, FLOPs, bytes, peak
  memory, counters) held to a committed baseline a device tier
  (``tools/torch_perfgate.py``).

Instrumentation is wired into the port's chokepoints: op dispatch
(``ops.registry``), the kvstore's push/pull, ``gluon.Trainer``'s step
phases, the ``DataLoader``'s batch fetch, the decode pool, ``TrainStep``,
the fused optimizer, checkpoint save/restore and serving.  Span recording
is gated on one flag: ``MXNET_TELEMETRY=1`` in the environment,
``telemetry.enable()`` at runtime, or ``mx.profiler.start()``; metrics
always count.  With the flag off, op dispatch pays one module-attribute
read.
"""

from __future__ import annotations

from .. import config
from . import ledger, metrics, tracer
from . import stepclock          # noqa: E402 - needs metrics loaded
from . import costmodel          # noqa: E402 - needs metrics loaded
from . import aggregate          # noqa: E402 - needs tracer/metrics/stepclock
from . import flightrec          # noqa: E402 - needs aggregate
from . import httpd              # noqa: E402 - needs metrics/costmodel
from . import perfgate           # noqa: E402 - needs config/costmodel
from .ledger import record_op
from .metrics import (  # noqa: F401
    DEFAULT_BUCKETS, REGISTRY, Counter, Gauge, Histogram, MetricsRegistry,
    counter, gauge, histogram, to_json, to_prometheus,
)
from .stepclock import STEP_CLOCK, StepClock  # noqa: F401
from .tracer import (  # noqa: F401
    NULL_SPAN, Span, Tracer, async_event, chrome_trace, disable, enable,
    enabled, get_tracer, instant, span,
)

__all__ = [
    "span", "instant", "async_event", "enable", "disable", "enabled",
    "get_tracer", "chrome_trace", "clear",
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "REGISTRY",
    "counter", "gauge", "histogram", "to_prometheus", "to_json",
    "DEFAULT_BUCKETS",
    "record_op", "record_dispatch", "payload_bytes", "ledger", "metrics",
    "tracer", "env_enabled",
    "aggregate", "flightrec", "stepclock", "StepClock", "STEP_CLOCK",
    "report", "costmodel", "httpd", "perfgate",
]


def report(clock=None, registry=None, cost=False):
    """The human-readable observability report: step-time attribution,
    bottleneck verdict and headline counters (``stepclock.report``), and
    with ``cost=True`` the cost ledger's per-site table."""
    out = stepclock.report(clock=clock, registry=registry)
    if cost:
        out += "\n" + costmodel.report_text()
    return out


# -- dispatch instrumentation (fed by ops.registry.invoke) -------------------

_OP_COUNT = counter(
    "mxnet_op_dispatch_total", "Imperative op dispatches through ops.registry.")
_OP_SECONDS = histogram(
    "mxnet_op_dispatch_seconds", "Host-side dispatch latency per op.")
_HOOK_SECONDS = histogram(
    "mxnet_monitor_hook_seconds", "Monitor-hook overhead per dispatch.")


def record_dispatch(name, begin_ns, end_ns, hook_ns=0):
    """One imperative dispatch: counter, latency histogram, trace event
    and ledger row.  Callers gate on ``tracer._ENABLED``."""
    dt_s = (end_ns - begin_ns) / 1e9
    _OP_COUNT.inc()
    _OP_SECONDS.observe(dt_s)
    if hook_ns:
        _HOOK_SECONDS.observe(hook_ns / 1e9)
    tracer.get_tracer().add_event(name, "dispatch", begin_ns, end_ns)
    ledger.record_op(name, dt_s)


def clear():
    """Drop buffered trace events, ledger rows (op aggregate and cost) and
    the step-clock window (metrics keep counting — use
    ``REGISTRY.reset()`` to zero them)."""
    tracer.clear()
    ledger.clear()
    stepclock.STEP_CLOCK.reset()
    costmodel.LEDGER.clear()


def payload_bytes(value):
    """Byte size of an NDArray, a tensor or a (nested) list of them, for
    the kvstore's bytes-moved counters."""
    if isinstance(value, (list, tuple)):
        return sum(payload_bytes(v) for v in value)
    data = getattr(value, "_data", value)
    n = getattr(data, "nbytes", None)
    if n is not None:
        return int(n)
    return 0


# -- env switches --------------------------------------------------------------

_ENV_ENABLED = bool(config.get_int("MXNET_TELEMETRY", 0))
if _ENV_ENABLED:
    enable()

# the flight recorder arms at import and, with a collection directory,
# every process exports its rank-tagged shard at exit; the cost ledger
# arms from its knob and the scrape plane serves when a port is named
if config.get_int("MXNET_FLIGHTREC", 1):
    flightrec.install()
if config.get("MXNET_TELEMETRY_DIR"):
    aggregate.install_atexit()
costmodel.arm_from_env()
httpd.start_from_env()


def env_enabled():
    """True when MXNET_TELEMETRY turned telemetry on at import; the
    profiler facade then never turns it off on stop()."""
    return _ENV_ENABLED
