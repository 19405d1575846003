"""Step-time attribution — the port's own copy of
``mxnet_tpu/telemetry/stepclock.py``: where did this training step's wall
time go?  Instrumented chokepoints split every optimizer step into

- ``data_wait``  — blocking on the input pipeline (DataLoader batch fetch,
  noted between steps and folded into the step they fed);
- ``h2d``        — host-to-device transfer of the batch
  (``parallel.TrainStep``'s copy of data and label into the captured
  graph's static inputs);
- ``compute``    — forward/backward/dispatch; also absorbs all
  *unattributed* step time (user code between steps), so the five phases
  always sum to the step's wall time;
- ``comms``      — gradient reduction (``Trainer``'s kvstore pushpull);
- ``optimizer``  — the weight update.

``gluon.Trainer.step`` and ``parallel.TrainStep`` drive the process-global
``STEP_CLOCK`` whenever telemetry is enabled (callers gate on the tracer
flag; this module reads no flags itself).  Every finished step observes
into the ``mxnet_step_phase_seconds`` labeled histograms and a bounded
rolling window (``MXNET_STEPCLOCK_WINDOW``) from which
:func:`StepClock.summary` computes per-phase medians and the rolling
**verdict**: ``input-bound`` (data_wait + h2d dominate), ``comms-bound``,
or ``compute-bound`` (compute + optimizer).  ``telemetry.report()``
renders the table.

The clock reads the host's clock only and adds no device
synchronisation: on the card a step's "compute" is the host time of its
launches (or of one graph replay), and device work that runs behind the
host shows up in whichever later phase waits for it.  A ``TrainStep``
"step" is one replay; ``run(...)`` takes one step per entry.

Stdlib-only.
"""

from __future__ import annotations

import threading
import time
from collections import deque

from .. import config
from . import metrics as _metrics

__all__ = ["PHASES", "StepClock", "STEP_CLOCK", "report"]

PHASES = ("data_wait", "h2d", "compute", "comms", "optimizer")

# verdict label -> the phases whose medians it aggregates
VERDICT_GROUPS = {
    "input-bound": ("data_wait", "h2d"),
    "comms-bound": ("comms",),
    "compute-bound": ("compute", "optimizer"),
}

_PHASE_HIST = {
    p: _metrics.histogram(
        "mxnet_step_phase_seconds",
        "Per-step wall seconds attributed to each phase of the training "
        "step (data_wait/h2d/compute/comms/optimizer).",
        labels={"phase": p})
    for p in PHASES
}


def _pct(sorted_vals, q):
    """Nearest-rank percentile of an ascending list."""
    if not sorted_vals:
        return 0.0
    idx = min(len(sorted_vals) - 1, max(0, int(q * len(sorted_vals))))
    return sorted_vals[idx]


class _PhaseTimer:
    """``with clock.phase("h2d"): ...`` convenience for user code."""

    __slots__ = ("_clock", "_name", "_t0")

    def __init__(self, clock, name):
        self._clock = clock
        self._name = name
        self._t0 = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._clock.note(self._name, time.perf_counter() - self._t0)
        return False


class StepClock:
    """Rolling per-step phase accumulator (module docstring has the full
    story).  Thread-safe: phase notes may arrive from the consumer thread
    (Trainer), the DataLoader iterator, or a pipeline assembler."""

    def __init__(self, window=None):
        if window is None:
            window = config.get_int("MXNET_STEPCLOCK_WINDOW", 64)
        self._lock = threading.Lock()
        self._window = deque(maxlen=max(2, int(window)))
        self._pending: dict = {}   # notes landing between steps (data_wait)
        self._cur = None           # open step's phase accumulation
        self._t_begin = None
        self._last_end = None      # end of the previous step (gap origin)
        self._gap = 0.0

    # -- feeding -----------------------------------------------------------

    def begin_step(self):
        """Open a step: fold pending between-step notes in and anchor the
        gap since the previous step's end (forward/backward/user code —
        attributed to compute unless noted otherwise)."""
        now = time.perf_counter()
        with self._lock:
            self._gap = (now - self._last_end) \
                if self._last_end is not None else 0.0
            self._cur = dict(self._pending)
            self._pending.clear()
            self._t_begin = now

    def note(self, phase, seconds):
        """Attribute ``seconds`` to ``phase`` — into the open step, or the
        pending pool if none is open (a DataLoader fetch between steps)."""
        if phase not in PHASES:
            raise ValueError(f"unknown step phase {phase!r}; "
                             f"phases are {PHASES}")
        with self._lock:
            tgt = self._cur if self._cur is not None else self._pending
            tgt[phase] = tgt.get(phase, 0.0) + float(seconds)

    def phase(self, name):
        """Context manager noting its body's duration under ``name``."""
        if name not in PHASES:
            raise ValueError(f"unknown step phase {name!r}; "
                             f"phases are {PHASES}")
        return _PhaseTimer(self, name)

    def end_step(self):
        """Close the open step: unattributed time goes to compute, the
        record joins the rolling window, and each phase observes into its
        ``mxnet_step_phase_seconds`` histogram."""
        now = time.perf_counter()
        with self._lock:
            if self._t_begin is None:
                return          # begin_step never ran (or step abandoned)
            cur, self._cur = self._cur or {}, None
            total = (now - self._t_begin) + self._gap
            noted = sum(cur.values())
            cur["compute"] = cur.get("compute", 0.0) \
                + max(0.0, total - noted)
            rec = {p: cur.get(p, 0.0) for p in PHASES}
            # noted phases can exceed the measured wall span (a fetch
            # timed on another thread overlapping the step): total always
            # covers the phases so shares stay <= 100%
            rec["total"] = max(total, sum(rec[p] for p in PHASES))
            self._window.append(rec)
            self._last_end = now
            self._t_begin = None
            self._gap = 0.0
        for p in PHASES:
            _PHASE_HIST[p].observe(rec[p])

    # -- reading -----------------------------------------------------------

    @property
    def steps(self):
        with self._lock:
            return len(self._window)

    def summary(self):
        """{steps, phases: {name: {median, p90, mean}}, groups, verdict}
        over the rolling window; verdict 'idle' when no steps recorded."""
        with self._lock:
            recs = list(self._window)
        if not recs:
            return {"steps": 0, "phases": {}, "groups": {},
                    "verdict": "idle"}
        phases = {}
        for p in PHASES + ("total",):
            vals = sorted(r[p] for r in recs)
            phases[p] = {"median": _pct(vals, 0.5), "p90": _pct(vals, 0.9),
                         "mean": sum(vals) / len(vals)}
        groups = {label: sum(phases[p]["median"] for p in members)
                  for label, members in VERDICT_GROUPS.items()}
        verdict = max(groups, key=groups.get) \
            if any(groups.values()) else "compute-bound"
        return {"steps": len(recs), "phases": phases, "groups": groups,
                "verdict": verdict}

    def verdict(self):
        """The rolling bottleneck verdict: 'input-bound' / 'comms-bound' /
        'compute-bound' ('idle' with no recorded steps)."""
        return self.summary()["verdict"]

    def reset(self):
        with self._lock:
            self._window.clear()
            self._pending.clear()
            self._cur = None
            self._t_begin = None
            self._last_end = None
            self._gap = 0.0


STEP_CLOCK = StepClock()


def report(clock=None, registry=None):
    """Human-readable attribution report: the per-phase table over the
    rolling window, the bottleneck verdict, and the headline run counters.
    This is what ``mx.telemetry.report()`` prints."""
    clock = clock if clock is not None else STEP_CLOCK
    registry = registry if registry is not None else _metrics.REGISTRY
    s = clock.summary()
    lines = [f"step-time attribution (last {s['steps']} step(s)):"]
    if not s["steps"]:
        lines.append("  (no steps recorded — enable telemetry "
                     "[MXNET_TELEMETRY=1] and run training steps)")
        return "\n".join(lines)
    total_med = s["phases"]["total"]["median"] or 1e-12
    lines.append(f"  {'phase':<10} {'median_ms':>10} {'p90_ms':>10} "
                 f"{'mean_ms':>10} {'share':>7}")
    for p in PHASES + ("total",):
        ph = s["phases"][p]
        share = ph["median"] / total_med
        lines.append(
            f"  {p:<10} {ph['median'] * 1e3:>10.3f} {ph['p90'] * 1e3:>10.3f}"
            f" {ph['mean'] * 1e3:>10.3f} {share:>6.0%}")
    shares = {k: v / total_med for k, v in s["groups"].items()}
    lines.append(
        f"verdict: {s['verdict']} "
        f"(input {shares['input-bound']:.0%} / "
        f"comms {shares['comms-bound']:.0%} / "
        f"compute {shares['compute-bound']:.0%})")
    counters = []
    for name in ("mxnet_trainer_steps_total",
                 "mxnet_sharding_step_dispatches_total",
                 "mxnet_sharding_retraces_total",
                 "mxnet_op_dispatch_total",
                 "mxnet_dataloader_batches_total",
                 "mxnet_resilience_deadline_exceeded_total"):
        m = registry.get(name)
        if m is not None and m.value:
            counters.append(f"  {name} = {m.value}")
    if counters:
        lines.append("counters:")
        lines.extend(counters)
    return "\n".join(lines)
