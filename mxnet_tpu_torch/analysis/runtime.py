"""Runtime twins of the static rules — assertions for tests; the port's
copy of ``mxnet_tpu/analysis/runtime.py``.

``no_retrace()`` is the dynamic half of GC02: the static pass proves a
captured or cached body *can't* silently close over mutable state; this
context manager proves a steady-state region *didn't* build anything.
The reference counts XLA backend compiles (one per ``jax.jit`` cache
miss).  The port has no compiler, so :func:`compile_count` counts every
cache miss of a per-signature build the port caches — its "one cache miss
= one compile" — at these sites (:func:`note_build`):

- ``parallel.TrainStep``: on the card, each CUDA-graph capture of a
  (data, label) signature (``TrainStep._capture``: a signature's first
  call runs eagerly, its second is captured, and a capture after the
  graphs were dropped counts again); on the CPU, where nothing is
  captured, the first call of each new signature;
- ``kvstore.fusion``: each bucket plan ``GradBucketer.plan`` builds for a
  new gradient signature;
- ``pipeline.PipelinedBlock``: its stacked stages, built at the first
  call (``PipelinedBlock._build``);
- ``optimizer_fusion``: each new parameter signature of the fused update
  (``optimizer_fusion._note``, what ``exec_builds()`` counts);
- ``kernels``: each CUDA library built or loaded from the build directory
  at its first use in a process (``kernels/_build.py``).

A region that counts a build raises ``RetraceError``::

    step(batch); step(batch)        # warm-up: eager call, then capture
    with no_retrace():
        step(batch)                 # steady state: replays only

Zero overhead beyond one locked increment per build; safe to nest.

``tracked()`` is the dynamic half of GC06: the static pass proves the
*visible* nested acquisitions form a DAG, but it cannot see orders that
only materialize at runtime (callbacks, duck-typed callees).  With
``MXNET_LOCKCHECK=1`` (or :func:`arm_lockcheck`), every lock the
threaded modules create through ``tracked(threading.Lock(), "name")``
records, per acquisition, an edge from every lock the acquiring thread
already holds — and raises :class:`LockOrderError`, with both witness
paths, the moment an edge closes a cycle.  Either thread of a would-be
deadlock trips the check on its own, so single-threaded tests catch
inversions that would need a precise two-thread interleaving to actually
deadlock.  Disarmed (the default), ``tracked()`` returns the raw lock —
production pays nothing, not even an isinstance check.
"""

from __future__ import annotations

import contextlib
import threading

__all__ = ["RetraceError", "no_retrace", "compile_count", "note_build",
           "build_counts", "LockOrderError", "tracked", "arm_lockcheck",
           "lockcheck_armed", "lockcheck_reset", "lockcheck_edges"]


class RetraceError(AssertionError):
    """A region guarded by ``no_retrace()`` built a new executable (a
    CUDA graph, a plan, a kernel library)."""


_lock = threading.Lock()
_compiles = 0
_by_site = {}


def note_build(site):
    """Count one per-signature build at ``site`` (a capture, a plan, a
    kernel library): the port's counterpart of one XLA compile."""
    global _compiles
    with _lock:
        _compiles += 1
        _by_site[site] = _by_site.get(site, 0) + 1


def compile_count():
    """Total builds counted in this process (monotonic)."""
    return _compiles


def build_counts():
    """{site: builds} counted in this process."""
    with _lock:
        return dict(_by_site)


@contextlib.contextmanager
def no_retrace(allow=0):
    """Assert the wrapped block builds nothing.

    ``allow`` tolerates that many builds (e.g. a first-call span that
    legitimately captures one graph).  Raises RetraceError naming the
    overshoot — the runtime analog of a GC02 finding.
    """
    before = compile_count()
    sites = build_counts()
    yield
    grew = compile_count() - before
    if grew > allow:
        now = build_counts()
        where = ", ".join(f"{k} +{v - sites.get(k, 0)}"
                          for k, v in sorted(now.items())
                          if v != sites.get(k, 0))
        raise RetraceError(
            f"no_retrace: {grew} build(s) inside a steady-state region "
            f"(allowed {allow}; {where}) — a cache key is unstable "
            "(shape/dtype churn), a capture was dropped and redone, or a "
            "body closed over state that changed; see graftcheck rule GC02")


# --------------------------------------------------------------------------
# GC06 twin — runtime lock-order validation (MXNET_LOCKCHECK=1)
# --------------------------------------------------------------------------

class LockOrderError(AssertionError):
    """A tracked acquisition closed a lock-order cycle (potential
    deadlock): some thread has taken these locks in the opposite
    order."""


_lc_lock = threading.Lock()          # guards the edge graph below
_lc_edges = {}                       # (held, acquired) -> witness str
_lc_armed = None                     # tri-state: None = read the knob
_lc_tls = threading.local()          # .held: [name, ...] per thread


def _knob_armed():
    # routed through config so the knob is typed/defaulted/documented
    # (graftcheck GC03); lazy so the analysis package stays importable
    # standalone (tools/torch_graftcheck.py loads it without the port)
    try:
        from ..config import get_bool
    except ImportError:
        return False
    return get_bool("MXNET_LOCKCHECK")


def lockcheck_armed():
    """Whether ``tracked()`` wraps (MXNET_LOCKCHECK, unless overridden
    by :func:`arm_lockcheck`)."""
    return _lc_armed if _lc_armed is not None else _knob_armed()


def arm_lockcheck(on=True):
    """Force the validator on/off for this process (tests); pass
    ``None`` to defer to the MXNET_LOCKCHECK knob again.  Only locks
    created through ``tracked()`` *while armed* are validated."""
    global _lc_armed
    _lc_armed = on


def lockcheck_reset():
    """Drop every recorded acquisition edge (test isolation)."""
    with _lc_lock:
        _lc_edges.clear()


def lockcheck_edges():
    """Snapshot of the recorded edge set: {(held, acquired): witness}."""
    with _lc_lock:
        return dict(_lc_edges)


def _path(frm, to):
    """Edge list of one path frm -> ... -> to in the recorded graph, or
    None.  Called under _lc_lock."""
    succ = {}
    for a, b in _lc_edges:
        succ.setdefault(a, []).append(b)
    stack, seen = [(frm, [])], {frm}
    while stack:
        node, path = stack.pop()
        for nxt in sorted(succ.get(node, ())):
            edge = (node, nxt)
            if nxt == to:
                return path + [edge]
            if nxt not in seen:
                seen.add(nxt)
                stack.append((nxt, path + [edge]))
    return None


class _TrackedLock:
    """Order-recording proxy over a lock.  Delegates acquire/release so
    it also works as the underlying lock of a ``threading.Condition``
    (wait()'s release/re-acquire flows through and stays balanced)."""

    def __init__(self, lock, name):
        self._lock = lock
        self._name = name

    def acquire(self, blocking=True, timeout=-1):
        got = self._lock.acquire(blocking, timeout)
        if got:
            self._record()
        return got

    def release(self):
        held = getattr(_lc_tls, "held", None)
        if held is not None and self._name in held:
            # remove the most recent entry (locks can unwind out of
            # order under Condition.wait)
            del held[len(held) - 1 - held[::-1].index(self._name)]
        self._lock.release()

    __enter__ = acquire

    def __exit__(self, *exc):
        self.release()

    def locked(self):
        return self._lock.locked()

    def _record(self):
        held = getattr(_lc_tls, "held", None)
        if held is None:
            held = _lc_tls.held = []
        me = self._name
        with _lc_lock:
            for h in held:
                if h == me:
                    continue   # re-entrant/Condition re-acquire
                edge = (h, me)
                if edge in _lc_edges:
                    continue
                back = _path(me, h)
                if back is not None:
                    wits = "; ".join(
                        f"[{a} -> {b}: {_lc_edges[(a, b)]}]"
                        for a, b in back)
                    raise LockOrderError(
                        f"lock-order cycle: this thread acquired {me!r} "
                        f"while holding {h!r}, but the opposite order "
                        f"{me!r} -> ... -> {h!r} was already recorded: "
                        f"{wits} — two threads taking these corners "
                        "concurrently deadlock; see graftcheck rule GC06")
                _lc_edges[edge] = (
                    f"{threading.current_thread().name} acquired {me} "
                    f"while holding {h}")
        held.append(me)


def tracked(lock, name):
    """Wrap ``lock`` for lock-order validation when the checker is
    armed; return it untouched (zero overhead) otherwise."""
    if lockcheck_armed():
        return _TrackedLock(lock, name)
    return lock
