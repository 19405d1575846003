"""mxnet_tpu_torch.analysis — the port's static analysis (graftcheck) and
its runtime twins, the counterpart of ``mxnet_tpu/analysis``.

CLI: ``python tools/torch_graftcheck.py [paths ...]`` (stdlib-only — it
runs without torch).  Library surface::

    from mxnet_tpu_torch import analysis
    findings, suppressed, modules = analysis.analyze_paths(
        ["mxnet_tpu_torch"])
    with analysis.runtime.no_retrace():
        step(batch)        # dynamic twin of rule GC02
    self._lock = analysis.tracked(threading.Lock(), "Thing._lock")
                           # dynamic twin of rule GC06 (MXNET_LOCKCHECK=1)

Rules (see the ``passes/`` package and the README "Static analysis"
paragraph of the port's section): GC01 host-sync on the hot path, GC02
re-capture hazards, GC03 env-knob hygiene, GC04 lock discipline, GC05
telemetry-flag discipline, GC06 lock-order cycles against the committed
baseline, GC07 use-after-donate, GC08 atomic-protocol writes, GC09
registry drift, GC10 thread lifecycle.
Suppress with ``# graftcheck: ignore[GC01] — why it is safe`` (the
justification is mandatory; a bare ignore is itself a finding).
"""

from __future__ import annotations

from . import passes  # noqa: F401 — importing registers GC01–GC10
from . import runtime  # noqa: F401
from .core import (  # noqa: F401
    PASSES, Context, Finding, ModuleInfo, Pass, ProjectIndex, analyze_paths,
    check_source, check_sources, main, register_pass, to_sarif,
)
from .runtime import (  # noqa: F401
    LockOrderError, RetraceError, arm_lockcheck, lockcheck_armed,
    lockcheck_edges, lockcheck_reset, no_retrace, tracked,
)

__all__ = [
    "Finding", "ModuleInfo", "Context", "Pass", "PASSES", "ProjectIndex",
    "register_pass", "analyze_paths", "check_source", "check_sources",
    "main", "to_sarif", "runtime", "no_retrace", "RetraceError",
    "LockOrderError", "tracked", "arm_lockcheck", "lockcheck_armed",
    "lockcheck_edges", "lockcheck_reset",
]
