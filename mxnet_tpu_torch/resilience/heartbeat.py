"""Worker-side liveness heartbeat — the file protocol a supervisor
(the serving router) watches.

The port's own copy of ``mxnet_tpu/resilience/heartbeat.py``.  When
``MXNET_ELASTIC_HEARTBEAT_DIR`` is set (the router injects it per
replica), a daemon thread atomically rewrites one small JSON file

    <dir>/hb-rank<RANK>.json

every ``MXNET_ELASTIC_HEARTBEAT_S`` seconds::

    {"rank": 2, "pid": 4711, "time": <unix>, "phase": "running",
     "step": 17, "incarnation": 1, "world": 3,
     "stepclock": {...}, "error": null}

- ``phase`` walks ``spawned → bringup → running → done | failed``;
- staleness (``time`` older than the supervisor's hang bound) is the
  hang signal; writes are write-then-rename so a reader never sees a torn
  file.

Each record embeds the step clock's rolling summary under ``stepclock``
(``telemetry.STEP_CLOCK.summary()``: the per-phase medians and the
input-/comms-/compute-bound verdict; ``idle`` in a process that recorded
no training step, such as a serving replica).

One departure from the reference (ROADMAP C.7): ``start()`` of a new
beater begins again at phase ``spawned`` with no step and no error, where
the reference keeps the module's phase from before (a ``failed`` left by
``mark_failed`` survives ``stop()``/``start()``).

Unset dir = fully inert (no thread, no files).
"""

from __future__ import annotations

import json
import os
import threading
import time

from .. import config
from .. import telemetry as _tel

__all__ = [
    "enabled", "heartbeat_dir", "start", "stop", "beat", "set_phase",
    "set_step", "mark_failed", "mark_done", "read_all", "path_for",
    "status",
]

PREFIX = "hb-rank"

_lock = threading.Lock()
_thread = None
_stop = None           # threading.Event of the running beater
_phase = "spawned"
_step = None
_error = None
_last_beat = None      # monotonic time of the last successful beat


def enabled():
    """True when a heartbeat directory is configured for this process."""
    return bool(config.get("MXNET_ELASTIC_HEARTBEAT_DIR"))


def heartbeat_dir():
    return config.get("MXNET_ELASTIC_HEARTBEAT_DIR")


def _rank():
    return config.get_int("MXNET_DIST_RANK", 0)


def path_for(rank, directory=None):
    directory = directory or heartbeat_dir()
    return os.path.join(directory, f"{PREFIX}{int(rank):05d}.json")


def _record():
    with _lock:
        phase, step, error = _phase, _step, _error
    rec = {
        "rank": _rank(),
        "pid": os.getpid(),
        "time": time.time(),
        "phase": phase,
        "step": step,
        "incarnation": config.get_int("MXNET_ELASTIC_INCARNATION", 0),
        "world": config.get_int("MXNET_DIST_NUM_WORKERS", 1),
        "stepclock": _tel.stepclock.STEP_CLOCK.summary(),
        "error": error,
    }
    return rec


def beat(directory=None):
    """Write one heartbeat now (atomic write-then-rename).  Returns the
    path, or None when no directory is configured.  Never raises — a
    full disk must not kill the training step."""
    global _last_beat
    directory = directory or heartbeat_dir()
    if not directory:
        return None
    try:
        os.makedirs(directory, exist_ok=True)
        path = path_for(_rank(), directory)
        tmp = f"{path}.tmp.{os.getpid()}"
        # rename-atomic but deliberately NOT fsynced (unlike the
        # checkpoint manifest): beats are periodic and disposable — the
        # next one supersedes a lost write, and fsync at beat frequency
        # would thrash the disk for nothing
        with open(tmp, "w") as f:
            json.dump(_record(), f)
        os.replace(tmp, path)
        with _lock:
            _last_beat = time.monotonic()
        return path
    except OSError:
        return None


def status():
    """In-process liveness view for the /healthz probe: the current
    phase, whether a beater thread is armed, and the age (seconds) of
    the last successful beat (None until one lands)."""
    with _lock:
        armed = _thread is not None and _thread.is_alive()
        age = None if _last_beat is None \
            else max(0.0, time.monotonic() - _last_beat)
        return {"phase": _phase, "armed": armed,
                "heartbeat_age_s": age}


def set_phase(phase):
    """Advance the lifecycle phase and beat immediately (phase changes
    are exactly the moments the supervisor must not miss)."""
    global _phase
    with _lock:
        _phase = str(phase)
    beat()


def set_step(step):
    """Record the step the worker is about to run (cheap: the periodic
    beater ships it; no file write here — this sits on the step path)."""
    global _step
    with _lock:
        _step = int(step)


def mark_failed(error):
    """Terminal failure beat (bring-up timeout, unrecoverable fault):
    the supervisor reads ``phase=failed`` + ``error`` to classify the
    death — a failure before ``running`` is a bring-up problem and the
    world size is NOT shrunk for it."""
    global _phase, _error
    with _lock:
        _phase = "failed"
        _error = str(error)[:500]
    beat()


def mark_done():
    """Clean-completion beat: an adopted worker (the restarted
    supervisor holds no Popen handle, so no exit code) is judged by
    this."""
    global _phase
    with _lock:
        _phase = "done"
    beat()


def _beater(stop_ev, interval_s):
    while not stop_ev.wait(interval_s):
        with _lock:
            mine = _stop is stop_ev
        if not mine:       # a newer start() owns the file now
            return
        beat()


def start(interval_s=None):
    """Start the periodic beater (idempotent; inert when no directory is
    configured).  A new beater begins at phase ``spawned`` with no step
    and no error (ROADMAP C.7)."""
    global _thread, _stop, _phase, _step, _error
    if not enabled():
        return False
    if interval_s is None:
        interval_s = config.get_float("MXNET_ELASTIC_HEARTBEAT_S", 2.0)
    with _lock:
        if _thread is not None and _thread.is_alive():
            return True
        _phase, _step, _error = "spawned", None, None
        _stop = threading.Event()
        _thread = threading.Thread(
            target=_beater, args=(_stop, max(0.05, float(interval_s))),
            daemon=True, name="mx-heartbeat")
        _thread.start()
    beat()
    return True


def stop():
    """Stop the beater (the final phase beat, if any, stays on disk)."""
    global _thread, _stop
    with _lock:
        ev, _stop = _stop, None
        _thread = None
    if ev is not None:
        ev.set()


def read_all(directory):
    """Controller side: parse every heartbeat file in ``directory`` →
    {rank: record}.  Torn/corrupt files are skipped (atomic renames make
    them rare)."""
    out = {}
    if not directory or not os.path.isdir(directory):
        return out
    for fn in sorted(os.listdir(directory)):
        if not (fn.startswith(PREFIX) and fn.endswith(".json")):
            continue
        try:
            with open(os.path.join(directory, fn)) as f:
                rec = json.load(f)
        except (OSError, ValueError):
            continue
        if isinstance(rec, dict) and "rank" in rec:
            out[int(rec["rank"])] = rec
    return out
