"""mx.resilience of the port — fault injection, retry/deadline policies
and the liveness heartbeat.

The port's own copy of the parts of ``mxnet_tpu/resilience`` that the
serving tier needs:

- ``policies`` — composable ``Retry`` (exponential backoff + jitter) and
  ``Deadline`` (per-call timeout → ``KVStoreTimeoutError``);
- ``chaos`` — deterministic fault injection (delays, transient errors,
  process death) at named sites, env- and API-driven;
- ``heartbeat`` — the worker-side liveness file protocol;
- ``controller`` — the pid guards a supervisor re-adopting workers uses.

Recovery events count in the telemetry registry:
``mxnet_resilience_{retries,faults_injected,deadline_exceeded,resumes,
fallbacks}_total`` and ``mxnet_resilience_retry_backoff_seconds``.
Not ported yet: ``ElasticController`` (ROADMAP A.9); the wiring of
``record_resume`` into ``checkpoint.auto_resume`` and of the checkpoint
and decode-pool chaos sites (ROADMAP A.11).
"""

from __future__ import annotations

from .. import telemetry as _tel
from . import chaos, policies  # noqa: F401
from .policies import (  # noqa: F401
    Deadline, KVStoreTimeoutError, ResilienceError, Retry,
    RetryExhaustedError, TransientError, is_transient, protect,
)
from .chaos import (  # noqa: F401
    ChaosError, ChaosTransientError, ChaosWorkerDeath,
)
from . import heartbeat  # noqa: F401
from . import controller  # noqa: F401

__all__ = [
    "Retry", "Deadline", "protect", "is_transient",
    "ResilienceError", "TransientError", "RetryExhaustedError",
    "KVStoreTimeoutError",
    "ChaosError", "ChaosTransientError", "ChaosWorkerDeath",
    "chaos", "policies", "record_fallback", "record_resume",
    "heartbeat", "controller",
]

# shared recovery counters (the per-policy ones live in policies.py)
_M_RESUMES = _tel.counter(
    "mxnet_resilience_resumes_total",
    "Elastic resumes: auto_resume restoring state from a checkpoint "
    "(at entry and after an in-run fault).")
_M_FALLBACKS = _tel.counter(
    "mxnet_resilience_fallbacks_total",
    "Graceful degradation EVENTS (one per occurrence): a dataloader batch "
    "refetched in-process, or a fused kvstore bucket replayed per-key.")


def record_fallback(n=1):
    _M_FALLBACKS.inc(n)


def record_resume(n=1):
    _M_RESUMES.inc(n)
