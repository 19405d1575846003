"""graftcheck passes — the ten committed rules, grouped by concern.

- :mod:`._scopes`   — the designated-scope tables the rules key on
                      (HOT_PATHS, FLAG_DISCIPLINE_MODULES,
                      THREADED_MODULES), keyed to the port's modules
- :mod:`.purity`    — GC01 host-sync, GC02 re-capture hazard, GC03 knob
                      hygiene, GC04 lock discipline, GC05 telemetry
                      flags (the intraprocedural five)
- :mod:`.concurrency` — GC06 lock-order cycles, GC07 use-after-donate,
                      GC10 thread lifecycle (interprocedural, built on
                      :class:`..core.ProjectIndex`)
- :mod:`.protocol`  — GC08 atomic-protocol writes, GC09 registry drift

Importing this package registers every pass with ``core.PASSES``;
``tools/torch_graftcheck.py`` and :func:`..core.analyze_paths` rely on
that side effect.  Keep the registry sorted by rule id so
``--list-rules`` and the stats table read in order regardless of import
sequence.
"""

from __future__ import annotations

from .. import core as _core
from . import concurrency, protocol, purity  # noqa: F401  (registration)
from ._scopes import (FLAG_DISCIPLINE_MODULES, HOT_PATHS,  # noqa: F401
                      THREADED_MODULES)
from .concurrency import LOCK_BASELINE_FILE  # noqa: F401
from .protocol import PROTOCOL_TOKENS  # noqa: F401

_core.PASSES.sort(key=lambda p: p.rule)

__all__ = [
    "HOT_PATHS",
    "FLAG_DISCIPLINE_MODULES",
    "THREADED_MODULES",
    "LOCK_BASELINE_FILE",
    "PROTOCOL_TOKENS",
]
