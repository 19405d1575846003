"""Retry / Deadline policies — the composable half of mx.resilience.

The port's own copy of ``mxnet_tpu/resilience/policies.py``:

- ``Retry`` — exponential backoff with jitter around *transient* failures
  (chaos-injected faults, connection resets).  Permanent errors and
  deadline expirations propagate immediately.
- ``Deadline`` — runs a callable on a daemon worker thread and joins with
  a timeout, so a call that never returns surfaces as
  ``KVStoreTimeoutError`` instead of blocking the caller forever.  The
  wedged thread is abandoned (daemon: never blocks interpreter exit).

Both read their defaults from config (``MXNET_RESILIENCE_MAX_RETRIES``,
``MXNET_RESILIENCE_BACKOFF_S``, ``MXNET_RESILIENCE_BACKOFF_MAX_S``,
``MXNET_KVSTORE_TIMEOUT_S``) and compose: ``Retry.call(Deadline.call, fn)``
or the ``protect()`` helper.  ``Deadline``'s lock goes through the
lock-order checker (``analysis.runtime.tracked``, ``MXNET_LOCKCHECK``).
"""

from __future__ import annotations

import queue as _queue
import random
import threading
import time
import weakref

from ..base import MXNetError
from .. import config
from .. import telemetry as _tel
from ..analysis.runtime import tracked as _tracked

__all__ = [
    "TransientError", "ResilienceError", "RetryExhaustedError",
    "KVStoreTimeoutError", "Retry", "Deadline", "protect", "is_transient",
]

_M_RETRIES = _tel.counter(
    "mxnet_resilience_retries_total",
    "Transient failures absorbed by a Retry policy (one per re-attempt).")
_M_DEADLINE = _tel.counter(
    "mxnet_resilience_deadline_exceeded_total",
    "Calls that exceeded their Deadline and raised KVStoreTimeoutError.")
_M_BACKOFF_SECONDS = _tel.histogram(
    "mxnet_resilience_retry_backoff_seconds",
    "Backoff slept before each retry attempt.")


class ResilienceError(MXNetError):
    """Base for errors raised by the resilience layer itself."""


class TransientError(Exception):
    """Marker mix-in: failures safe to retry (the operation did not
    partially commit).  Chaos transient faults and wrappable I/O errors
    carry it; ``Retry`` only re-attempts exceptions that are transient."""


class RetryExhaustedError(ResilienceError):
    """A Retry policy ran out of attempts; ``__cause__`` is the last
    underlying failure."""


class KVStoreTimeoutError(ResilienceError):
    """A deadline-bounded blocking call (dist bring-up, allreduce,
    barrier) did not complete in time — the failure mode of a dead or
    wedged peer, which would otherwise hang forever."""


def is_transient(exc):
    """True when ``exc`` is safe to retry: marked TransientError, flagged
    ``transient=True``, or a connection-level OS error."""
    if isinstance(exc, TransientError) or getattr(exc, "transient", False):
        return True
    return isinstance(exc, (ConnectionError, BrokenPipeError))


class Retry:
    """Exponential backoff + full jitter around transient failures.

    ``max_retries`` re-attempts AFTER the first try (0 = fail fast);
    attempt ``k`` sleeps ``backoff_s * 2**k`` capped at ``backoff_max_s``,
    scaled by a uniform jitter in ``[1 - jitter, 1 + jitter]`` so a fleet
    of workers retrying the same stalled endpoint doesn't stampede in
    lockstep.
    """

    def __init__(self, max_retries=None, backoff_s=None, backoff_max_s=None,
                 jitter=0.25, retry_on=None, site=""):
        self.max_retries = max_retries if max_retries is not None \
            else config.get_int("MXNET_RESILIENCE_MAX_RETRIES", 3)
        self.backoff_s = backoff_s if backoff_s is not None \
            else config.get_float("MXNET_RESILIENCE_BACKOFF_S", 0.05)
        self.backoff_max_s = backoff_max_s if backoff_max_s is not None \
            else config.get_float("MXNET_RESILIENCE_BACKOFF_MAX_S", 2.0)
        self.jitter = float(jitter)
        self.retry_on = retry_on  # extra exception types to treat transient
        self.site = site

    def _retryable(self, exc):
        if self.retry_on is not None and isinstance(exc, self.retry_on):
            return True
        return is_transient(exc)

    def backoff_delay(self, attempt):
        """Jittered delay (seconds) before re-attempt ``attempt`` (0 =
        first retry) — the policy's schedule exposed for callers that
        escalate OUTSIDE call() (the elastic controller sleeps this
        between whole-job restarts).  Negative attempts cost nothing."""
        if attempt < 0:
            return 0.0
        delay = min(self.backoff_s * (2 ** attempt), self.backoff_max_s)
        if self.jitter:
            delay *= 1 + self.jitter * (2 * random.random() - 1)
        return max(0.0, delay)

    def call(self, fn, *args, **kwargs):
        attempt = 0
        while True:
            try:
                return fn(*args, **kwargs)
            except Exception as exc:  # noqa: BLE001 — filtered just below
                if not self._retryable(exc):
                    raise
                if attempt >= self.max_retries:
                    raise RetryExhaustedError(
                        f"{self.site or 'call'} failed after "
                        f"{attempt + 1} attempts: {exc}") from exc
                delay = self.backoff_delay(attempt)
                _M_RETRIES.inc()
                _M_BACKOFF_SECONDS.observe(delay)
                if delay > 0:
                    time.sleep(delay)
                attempt += 1

    def wrap(self, fn):
        def wrapped(*args, **kwargs):
            return self.call(fn, *args, **kwargs)
        return wrapped


def _deadline_worker(ref, q):
    """Daemon loop serving one Deadline's calls.  Exits on the ``None``
    sentinel, when its owner is gone, or when the owner abandoned this
    queue after a timeout (a fresh worker owns the replacement)."""
    while True:
        task = q.get()
        if task is None:
            return
        fn, args, kwargs, done, box = task
        try:
            box["value"] = fn(*args, **kwargs)
        except BaseException as exc:  # noqa: BLE001 — re-raised by call()
            box["error"] = exc
        done.set()
        # drop the call's refs (args/result can be multi-MB arrays) so an
        # idle worker blocked in q.get() doesn't pin them
        task = fn = args = kwargs = done = box = None
        owner = ref()
        if owner is None or owner._task_queue is not q:
            return


class Deadline:
    """Per-call timeout for blocking operations that cannot be cancelled.

    ``timeout_s <= 0`` disables the bound (direct call, zero overhead).
    Calls run on ONE persistent daemon worker thread (created lazily, no
    per-call spawn cost); on expiry the worker — wedged inside a call
    there is no handle to cancel — is abandoned (daemon: never blocks
    interpreter exit) and a fresh one serves subsequent calls.  Calls on
    one Deadline serialize; use one instance per call-site, not a shared
    global.
    """

    def __init__(self, timeout_s=None, site=""):
        self.timeout_s = timeout_s if timeout_s is not None \
            else config.get_float("MXNET_KVSTORE_TIMEOUT_S", 300.0)
        self.site = site
        self._lock = _tracked(threading.Lock(), "Deadline._lock")
        self._task_queue = None
        self._worker = None

    def _submit(self, task):
        with self._lock:
            if self._task_queue is None or self._worker is None \
                    or not self._worker.is_alive():
                self._task_queue = _queue.SimpleQueue()
                self._worker = threading.Thread(
                    target=_deadline_worker,
                    args=(weakref.ref(self), self._task_queue),
                    daemon=True,
                    name=f"mx-deadline-{self.site or 'call'}")
                self._worker.start()
            self._task_queue.put(task)

    def _abandon(self):
        """Forget the wedged worker; the daemon thread dies with its call
        (or notices the queue swap and exits if the call ever returns)."""
        with self._lock:
            self._task_queue = None
            self._worker = None

    def call(self, fn, *args, **kwargs):
        t = self.timeout_s
        if not t or t <= 0:
            return fn(*args, **kwargs)
        box = {}
        done = threading.Event()
        self._submit((fn, args, kwargs, done, box))
        if not done.wait(t):
            self._abandon()
            _M_DEADLINE.inc()
            # postmortem while the stuck call is still blocked
            _tel.flightrec.dump(f"deadline.{self.site or 'call'}")
            raise KVStoreTimeoutError(
                f"{self.site or 'call'} exceeded its {t:g}s deadline "
                "(MXNET_KVSTORE_TIMEOUT_S); the blocked call was "
                "abandoned")
        if "error" in box:
            raise box["error"]
        return box["value"]

    def close(self):
        """Stop the idle worker (optional; daemon threads never block
        exit, this just tidies long-lived processes)."""
        with self._lock:
            q = self._task_queue
            self._task_queue = None
            self._worker = None
        if q is not None:
            q.put(None)

    def __del__(self):
        try:
            self.close()
        except Exception:  # noqa: BLE001 — interpreter teardown
            pass

    def wrap(self, fn):
        def wrapped(*args, **kwargs):
            return self.call(fn, *args, **kwargs)
        return wrapped


def protect(fn, retry=None, deadline=None, site=""):
    """Compose retry-around-deadline: each attempt is deadline-bounded,
    transient failures back off and re-attempt, timeouts propagate (a
    wedged collective must not be blindly re-entered)."""
    retry = retry if retry is not None else Retry(site=site)
    deadline = deadline if deadline is not None else Deadline(site=site)

    def protected(*args, **kwargs):
        return retry.call(deadline.call, fn, *args, **kwargs)

    return protected
