"""Crash flight recorder — the port's own copy of
``mxnet_tpu/telemetry/flightrec.py``, the always-on black box.

Every death of a process leaves a readable postmortem per rank: a bounded
JSON dump containing

- the last ``MXNET_FLIGHTREC_SPANS`` trace events (whatever the tracer
  holds: the full timeline when telemetry is on, empty when off),
- the complete metric registry state,
- the breadcrumb ring (:func:`note`: small always-on markers from
  non-hot chokepoints, independent of the telemetry flag),
- armed chaos sites and faults fired, the step-clock summary, the
  resolved env-knob values, and the exception with its traceback when
  there is one.

Dump triggers (installed once at import when ``MXNET_FLIGHTREC=1``, the
default):

- **unhandled exceptions** — a chained ``sys.excepthook``;
- **deadline expiry** — ``resilience.Deadline`` dumps right before
  raising ``KVStoreTimeoutError``;
- **chaos 'exit' faults** — ``resilience.chaos`` dumps before
  ``os._exit``;
- **SIGTERM** — dump, then chain to the previous handler (or re-deliver
  the default), composing with ``checkpoint.auto_resume``'s preemption
  hook, which installs itself over this one while it runs; the port's
  pool workers take the default disposition instead
  (:func:`default_sigterm`);
- **SIGUSR2** — dump on demand and keep running (``kill -USR2 <pid>``).
  As in the reference, this handler replaces the previous one instead of
  chaining: in a process that imports both packages, the one imported
  last answers.

Both packages may be imported in one process (the CPU tests do): each
installs once and chains its excepthook and SIGTERM handler to whatever
was installed before it.  Dumps are atomic (write-then-rename), bounded
in count (``MXNET_FLIGHTREC_MAX_DUMPS`` per process) and land in
``MXNET_FLIGHTREC_DIR`` (default: ``MXNET_TELEMETRY_DIR``, else
``~/.cache/mxnet_tpu_torch/flightrec``, never the working tree).  When a
telemetry collection directory is configured, a dump also exports this
rank's telemetry snapshot.  :func:`dump` never raises.  Stdlib-only.
"""

from __future__ import annotations

import json
import os
import signal
import sys
import threading
import time
import traceback
from collections import deque

from .. import config
from . import aggregate, ledger, metrics, stepclock, tracer

__all__ = ["note", "dump", "install", "enabled", "dump_dir",
           "default_sigterm"]

_lock = threading.Lock()
_breadcrumbs: deque = deque(maxlen=64)
_installed = False
_prev_excepthook = None
_prev_sigterm = None
_prev_sigusr2 = None
_dumps = 0


def enabled():
    return bool(config.get_int("MXNET_FLIGHTREC", 1))


def dump_dir():
    d = config.get("MXNET_FLIGHTREC_DIR") or config.get("MXNET_TELEMETRY_DIR")
    if d:
        return d
    # outside the working tree; spawned workers inherit
    # MXNET_FLIGHTREC_DIR, so one process-wide redirect covers a job
    return os.path.join(os.path.expanduser("~"), ".cache",
                        "mxnet_tpu_torch", "flightrec")


def note(event, **attrs):
    """Always-on breadcrumb (bounded ring, independent of the telemetry
    flag) — call from non-hot chokepoints so the black box carries a
    trail even in telemetry-off runs."""
    crumb = {"t": time.time(), "event": str(event)}
    if attrs:
        crumb.update(attrs)
    with _lock:
        _breadcrumbs.append(crumb)


def _record(reason, exc=None):
    n_spans = max(1, config.get_int("MXNET_FLIGHTREC_SPANS", 256))
    tr = tracer.get_tracer()
    events = tr.events()
    with _lock:
        crumbs = list(_breadcrumbs)
    rec = {
        "reason": reason,
        "time": time.time(),
        "time_iso": time.strftime("%Y-%m-%dT%H:%M:%S%z"),
        "rank": aggregate.rank(),
        "pid": os.getpid(),
        "argv": list(sys.argv),
        "python": sys.version.split()[0],
        "telemetry_enabled": tracer.enabled(),
        "spans": events[-n_spans:],
        "spans_dropped": tr.dropped + max(0, len(events) - n_spans),
        "thread_names": {str(k): v for k, v in tr.thread_names().items()},
        "breadcrumbs": crumbs,
        "metrics": metrics.REGISTRY.export_state(),
        "stepclock": stepclock.STEP_CLOCK.summary(),
        "ledger_top": sorted(
            ((k, list(v)) for k, v in ledger.snapshot().items()),
            key=lambda kv: -kv[1][1])[:20],
        "config": {name: cur for name, cur, _default, _doc
                   in config.describe() if cur is not None},
    }
    try:
        # lazy: resilience imports telemetry, never the other way round
        from ..resilience import chaos as _chaos
        rec["chaos"] = {"armed_sites": _chaos.sites(),
                        "faults_fired": _chaos.fault_count()}
    except Exception:  # noqa: BLE001 — resilience may not be importable yet
        pass
    if exc is not None:
        rec["exception"] = {
            "type": type(exc).__name__,
            "message": str(exc)[:2000],
            "traceback": traceback.format_exception(
                type(exc), exc, getattr(exc, "__traceback__", None))[-50:],
        }
    return rec


def _slug(reason):
    return "".join(c if (c.isalnum() or c in ".-") else "-"
                   for c in str(reason))[:80] or "dump"


def dump(reason, exc=None, directory=None):
    """Write one postmortem atomically; returns its path.  NEVER raises
    and never dumps more than MXNET_FLIGHTREC_MAX_DUMPS times per process
    (a retry loop hitting deadlines must not flood the disk).  Returns
    None when disabled, capped, or the write failed."""
    global _dumps
    if not enabled():
        return None
    try:
        with _lock:
            if _dumps >= config.get_int("MXNET_FLIGHTREC_MAX_DUMPS", 16):
                return None
            _dumps += 1
            seq = _dumps
        d = directory or dump_dir()
        os.makedirs(d, exist_ok=True)
        path = os.path.join(
            d, f"flightrec-rank{aggregate.rank():05d}-pid{os.getpid()}"
               f"-{seq:02d}-{_slug(reason)}.json")
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(_record(reason, exc), f, indent=1, default=str)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        try:
            # the black box doubles as this rank's telemetry export: a
            # crashed rank still contributes to the merged trace
            aggregate.export_snapshot()
        except Exception:  # noqa: BLE001
            pass
        return path
    except Exception:  # noqa: BLE001 — a failing dump must not mask the crash
        return None


def _reset_dump_cap_for_test():
    """Testing hook: clear the per-process dump budget."""
    global _dumps
    with _lock:
        _dumps = 0


# -- triggers ---------------------------------------------------------------

def _excepthook(etype, value, tb):
    dump(f"exception.{etype.__name__}", exc=value)
    prev = _prev_excepthook or sys.__excepthook__
    prev(etype, value, tb)


def _dump_from_handler(reason, join_s):
    """Dump from INSIDE a signal handler without deadlocking: the handler
    runs on the interrupted main thread, which may hold any of the
    non-reentrant locks dump() needs (a metric's lock mid-observe, the
    breadcrumb lock).  A daemon thread takes them safely; the bounded
    join keeps SIGTERM death prompt — if the thread is blocked on a lock
    the interrupted frame holds, the join times out, the handler returns
    (or re-delivers death), and the thread finishes the dump once the
    frame resumes and releases the lock (when the process lives on)."""
    t = threading.Thread(target=dump, args=(reason,), daemon=True,
                         name="mx-flightrec-dump")
    t.start()
    if join_s:
        t.join(join_s)


def _on_sigterm(signum, frame):
    _dump_from_handler("sigterm", join_s=5.0)
    prev = _prev_sigterm
    if callable(prev):
        prev(signum, frame)
    elif prev is None or prev == signal.SIG_DFL:
        # re-deliver the default disposition (die) instead of swallowing.
        # prev None means the prior handler lived at the C level
        # (embedded interpreter / launcher preload) — unknowable from
        # here, and for SIGTERM "terminate" is the only safe reading
        signal.signal(signal.SIGTERM, signal.SIG_DFL)
        os.kill(os.getpid(), signal.SIGTERM)
    # SIG_IGN: stay ignored


def _on_sigusr2(signum, frame):  # noqa: ARG001 — signal handler shape
    _dump_from_handler("sigusr2", join_s=0)   # live process: no need to wait


def install():
    """Arm the triggers once: excepthook always; SIGTERM/SIGUSR2 only
    from the main thread (signal.signal's contract).  Idempotent;
    telemetry.__init__ calls this at import when MXNET_FLIGHTREC=1."""
    global _installed, _prev_excepthook, _prev_sigterm, _prev_sigusr2
    with _lock:
        if _installed:
            return
        _installed = True
        _prev_excepthook = sys.excepthook
        sys.excepthook = _excepthook
        if threading.current_thread() is not threading.main_thread():
            return
        try:
            _prev_sigterm = signal.signal(signal.SIGTERM, _on_sigterm)
        except (ValueError, OSError):   # no signal support here
            pass
        try:
            if hasattr(signal, "SIGUSR2"):
                _prev_sigusr2 = signal.signal(signal.SIGUSR2, _on_sigusr2)
        except (ValueError, OSError):
            pass


def default_sigterm():
    """Give SIGTERM its default disposition in a pool worker (the port's
    DataLoader and decode-pool initializers call this).  A Python-level
    handler runs only when the main thread next returns to the
    interpreter: a worker that the signal reaches just before it blocks
    on its pool's task lock never runs it and never exits, and the
    pool's ``terminate()`` then waits on it forever.  The default
    disposition ends the worker at once; a worker leaves no dump."""
    if threading.current_thread() is threading.main_thread():
        signal.signal(signal.SIGTERM, signal.SIG_DFL)
