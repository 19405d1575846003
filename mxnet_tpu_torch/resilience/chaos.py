"""Deterministic fault injection — the testable half of mx.resilience.

The port's own copy of ``mxnet_tpu/resilience/chaos.py``.  Named *chaos
sites* sit at the runtime chokepoints that the port wires so far

    ``router.dispatch``      — the serving router, between journaling a
                               request and sending it to a replica
    ``router.replica_spawn`` — the router, before each replica spawn
    ``serving.reply``        — a replica worker, after a request's tokens
                               are computed and before its ack is written

and tests (API) or the environment (``MXNET_CHAOS=1`` +
``MXNET_CHAOS_SITES``) arm faults at them:

    chaos.inject("router.replica_spawn", kind="transient", times=1)
    chaos.inject("router.dispatch", kind="exit", after=3)

    MXNET_CHAOS=1 MXNET_CHAOS_SITES="serving.reply:exit:1"

Faults fire on deterministic hit counts (``after`` skips the first K hits,
``times`` bounds how many fire; ``times=0`` = unbounded), so a chaos test
reproduces exactly.  Instrumented code guards with
``if chaos._ACTIVE: chaos.hit(site)`` — one module-attribute check when no
fault is armed.  The port also wires the reference's ``trainer.step``
(``gluon.Trainer.step``), ``dataloader.fetch`` (each DataLoader batch),
``io.decode`` (each decode-pool task, in the worker) and
``checkpoint.save`` (between a step's data and its manifest commit)
sites; the kvstore and controller sites wait for the distributed stores
(ROADMAP A.9).  An ``exit`` fault dumps the flight recorder
(``chaos.exit.<site>``) before ``os._exit``.
"""

from __future__ import annotations

import threading
import time

from .. import config
from .. import telemetry as _tel
from .policies import ResilienceError, TransientError

__all__ = [
    "ChaosError", "ChaosTransientError", "ChaosWorkerDeath",
    "inject", "clear", "hit", "active", "sites", "fault_count", "SITES",
    "arm_from_spec",
]

# the reference's documented site names (informational; hit() accepts any
# string)
SITES = ("kvstore.allreduce", "dist.barrier", "dataloader.fetch",
         "checkpoint.save", "trainer.step", "io.decode",
         "controller.spawn", "controller.resize",
         "router.dispatch", "router.replica_spawn", "serving.reply")

_M_FAULTS = _tel.counter(
    "mxnet_resilience_faults_injected_total",
    "Chaos faults fired (delays, transient errors, and worker deaths).")


class ChaosError(ResilienceError):
    """Base for injected faults."""


class ChaosTransientError(ChaosError, TransientError):
    """Injected transient failure — Retry policies absorb it."""


class ChaosWorkerDeath(ChaosError):
    """Injected permanent failure (simulated worker death) — NOT
    transient; recovery means fallback or checkpoint resume, not retry."""


class _Fault:
    __slots__ = ("kind", "times", "after", "delay_s", "message",
                 "hits", "fired")

    def __init__(self, kind, times, after, delay_s, message):
        if kind not in ("delay", "transient", "fatal", "exit"):
            raise ValueError(f"unknown chaos kind {kind!r}")
        self.kind = kind
        self.times = int(times)      # 0 = unbounded
        self.after = int(after)      # skip the first `after` hits
        self.delay_s = float(delay_s)
        self.message = message
        self.hits = 0
        self.fired = 0


_lock = threading.Lock()
_faults: dict = {}   # site -> list[_Fault]
_counts: dict = {}   # site -> total faults fired (survives clear())

# single flag hot paths read as a module attribute (telemetry pattern)
_ACTIVE = False


def active():
    """True when at least one fault is armed."""
    return _ACTIVE


def sites():
    """Site names with armed faults."""
    with _lock:
        return sorted(_faults)


def fault_count(site=None):
    """Faults fired at ``site`` (or everywhere) since process start."""
    with _lock:
        if site is not None:
            return _counts.get(site, 0)
        return sum(_counts.values())


def inject(site, kind="transient", times=1, after=0, delay_s=0.0,
           message=None):
    """Arm a fault at ``site``.

    kind:
      - ``delay``: sleep ``delay_s`` (latency injection)
      - ``transient``: raise ChaosTransientError (retryable)
      - ``fatal``: raise ChaosWorkerDeath (permanent — simulated death)
      - ``exit``: ``os._exit(1)`` — REAL process death, for subprocess /
        dataloader-worker tests only
    """
    global _ACTIVE
    f = _Fault(kind, times, after, delay_s,
               message or f"chaos[{kind}]@{site}")
    with _lock:
        _faults.setdefault(site, []).append(f)
        _ACTIVE = True
    return f


def clear(site=None):
    """Disarm faults at ``site`` (or everywhere).  Fired counts persist."""
    global _ACTIVE
    with _lock:
        if site is None:
            _faults.clear()
        else:
            _faults.pop(site, None)
        _ACTIVE = bool(_faults)


def hit(site, **ctx):
    """Evaluate armed faults at ``site``; called from instrumented code
    behind an ``if chaos._ACTIVE`` guard.  Raises per the armed kind."""
    with _lock:
        flist = _faults.get(site)
        if not flist:
            return
        todo = []
        for f in flist:
            f.hits += 1
            if f.hits <= f.after:
                continue
            if f.times and f.fired >= f.times:
                continue
            f.fired += 1
            _counts[site] = _counts.get(site, 0) + 1
            todo.append(f)
    for f in todo:
        _M_FAULTS.inc()
        _tel.instant(f"chaos.{f.kind}", "resilience", site=site, **ctx)
        if f.kind == "delay":
            time.sleep(f.delay_s)
        elif f.kind == "transient":
            raise ChaosTransientError(f.message)
        elif f.kind == "fatal":
            raise ChaosWorkerDeath(f.message)
        elif f.kind == "exit":
            import os
            # os._exit skips every hook: the black box dumps here
            _tel.flightrec.dump(f"chaos.exit.{site}")
            os._exit(1)


def arm_from_spec(spec):
    """Arm faults from a "site:kind[:times[:delay_s[:after]]],..." spec
    string — the MXNET_CHAOS_SITES grammar, callable directly so
    decode-pool workers can re-arm from the spec their PARENT resolved (a
    forkserver child may inherit a stale environment).  The optional 5th
    field maps to ``inject(after=)``: skip the first N hits before
    firing (arming a mid-stream death from the environment)."""
    for part in (spec or "").split(","):
        part = part.strip()
        if not part:
            continue
        try:
            fields = part.split(":")
            site = fields[0]
            kind = fields[1] if len(fields) > 1 else "transient"
            times = int(fields[2]) if len(fields) > 2 else 1
            delay_s = float(fields[3]) if len(fields) > 3 else 0.0
            after = int(fields[4]) if len(fields) > 4 else 0
            inject(site, kind=kind, times=times, delay_s=delay_s,
                   after=after)
        except ValueError as exc:
            # a spec typo must not break `import mxnet_tpu_torch` (this runs at
            # import, deep under every module that wires chaos sites)
            import warnings
            warnings.warn(
                f"ignoring malformed MXNET_CHAOS_SITES entry {part!r}: "
                f"{exc}", stacklevel=2)


def _arm_from_env():
    """MXNET_CHAOS=1 + MXNET_CHAOS_SITES arms faults at import, so chaos
    lanes need no code changes."""
    if not config.get_bool("MXNET_CHAOS"):
        return
    arm_from_spec(config.get("MXNET_CHAOS_SITES", "") or "")


_arm_from_env()
