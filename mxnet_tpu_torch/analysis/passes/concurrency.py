"""graftcheck rules GC06/GC07/GC10 — interprocedural concurrency rules;
the port's copy of ``mxnet_tpu/analysis/passes/concurrency.py``.

All three are thin rules over :class:`~..core.ProjectIndex` summaries:

- **GC06 lock-order**: every nested ``with lock:`` acquisition in the
  threaded modules — directly or through resolvable calls — contributes
  an edge to a project-wide lock-order graph.  A cycle is a potential
  deadlock (two threads entering it from different corners block each
  other forever) and is reported with a witness path per edge.  The
  acyclic edge set itself is *codified*: the committed
  ``graftcheck-torch-lockorder.json`` at the repo root is the documented
  ordering of the port's locks (the reference's own
  ``graftcheck-lockorder.json`` is not read), and any edge not in it (or
  stale in it) is a finding, so a change that introduces a new ordering
  must update the baseline in the same diff — loudly, reviewably.
- **GC07 use-after-donate**: a buffer passed at a donated position of a
  ``donate_argnums`` jit is freed the moment dispatch begins; any later
  read of the same binding is a silent use-after-free (XLA may have
  already reused the pages).  The port donates nothing (``TrainStep``
  accepts ``donate=`` and drops it: its updates are in place), so on the
  port's tree the rule reports nothing; it recognises the reference's
  donating spellings as text.  The pass indexes every donating callable —
  direct ``jax.jit(f, donate_argnums=...)`` results, wrapper-transparent
  (``wrap_jit(jax.jit(...))``), builder-returned, bound to locals,
  module globals, or ``self`` attributes — and flags reads of donated
  bindings after the dispatch, including re-reads on the next iteration
  of an enclosing loop when the binding is never rebound.
- **GC10 thread-lifecycle**: a non-daemon thread that is never joined
  outlives shutdown and deadlocks interpreter exit; a ``while True``
  loop reachable from a thread target that neither reads a
  stop/shutdown-ish flag nor returns can never be told to exit.
"""

from __future__ import annotations

import ast
import json
import os
import re

from ..core import (Finding, Pass, call_leaf, dotted_chain, iter_own_nodes,
                    register_pass)
from ._scopes import _is_threaded

# --------------------------------------------------------------------------
# GC06 — lock-order cycles + committed edge baseline
# --------------------------------------------------------------------------

LOCK_BASELINE_FILE = "graftcheck-torch-lockorder.json"


def _sccs(graph):
    """Tarjan strongly-connected components of {node: {succ}}."""
    index_of, low, on_stack = {}, {}, set()
    stack, out, counter = [], [], [0]

    def strong(v):
        index_of[v] = low[v] = counter[0]
        counter[0] += 1
        stack.append(v)
        on_stack.add(v)
        for w in sorted(graph.get(v, ())):
            if w not in index_of:
                strong(w)
                low[v] = min(low[v], low[w])
            elif w in on_stack:
                low[v] = min(low[v], index_of[w])
        if low[v] == index_of[v]:
            comp = []
            while True:
                w = stack.pop()
                on_stack.discard(w)
                comp.append(w)
                if w == v:
                    break
            out.append(comp)

    for v in sorted(graph):
        if v not in index_of:
            strong(v)
    return out


def _cycle_in(scc, graph):
    """One concrete cycle (node list, last wraps to first) inside a
    non-trivial SCC, found by DFS from its smallest node."""
    start = min(scc)
    members = set(scc)
    path, seen = [start], {start}

    def dfs(v):
        for w in sorted(graph.get(v, ())):
            if w == start:
                return True
            if w in members and w not in seen:
                seen.add(w)
                path.append(w)
                if dfs(w):
                    return True
                path.pop()
        return False

    dfs(start)
    return path


@register_pass
class LockOrderPass(Pass):
    rule = "GC06"
    summary = ("lock-order: nested lock acquisitions (through calls) in "
               "the threaded modules must form a DAG matching the "
               "committed graftcheck-torch-lockorder.json; cycles are "
               "potential "
               "deadlocks, unlisted/stale edges are drift")

    def edges(self, ctx):
        """{(from_id, to_id): {'module', 'line', 'witness'}} — the
        observed lock-order edge set with one witness each."""
        idx = ctx.index
        out = {}
        for m in ctx.modules:
            if not _is_threaded(m.rel):
                continue
            for fi in sorted(idx.functions_in(m), key=lambda f: f.qual):
                s = idx.summary(fi)
                for held, inner, hline, iline in s.pairs:
                    out.setdefault((held, inner), {
                        "module": m, "line": iline,
                        "witness": (f"{m.rel}::{fi.qual} holds {held} "
                                    f"(line {hline}) and acquires {inner} "
                                    f"(line {iline})")})
                for held, hline, call in s.region_calls:
                    g = idx.resolve_call(m, fi, call)
                    if g is None:
                        continue
                    for lid, (chain, site) in sorted(
                            idx.may_acquire(g).items()):
                        if lid == held or (held, lid) in out:
                            continue
                        hops = " -> ".join(
                            (f"{g.module.rel}::{g.qual}",) + chain)
                        out[(held, lid)] = {
                            "module": m, "line": call.lineno,
                            "witness": (f"{m.rel}::{fi.qual} holds {held} "
                                        f"(line {hline}) and calls {hops}, "
                                        f"which acquires {lid} at {site}")}
        return out

    def write_lock_baseline(self, path, ctx):
        edges = self.edges(ctx)
        data = {
            "comment": "graftcheck GC06 lock-order baseline — the "
                       "documented acquisition ordering; regenerate with "
                       "tools/torch_graftcheck.py --write-lock-baseline after "
                       "reviewing any new edge for cycles",
            "edges": [{"from": a, "to": b, "witness": w["witness"]}
                      for (a, b), w in sorted(edges.items())],
        }
        with open(path, "w", encoding="utf-8") as f:
            json.dump(data, f, indent=2, sort_keys=True)
            f.write("\n")
        return len(edges)

    def check_project(self, ctx):
        edges = self.edges(ctx)
        out = []
        graph = {}
        for a, b in edges:
            graph.setdefault(a, set()).add(b)
            graph.setdefault(b, set())
        for scc in _sccs(graph):
            if len(scc) < 2:
                continue
            cyc = _cycle_in(scc, graph)
            wits = []
            for a, b in zip(cyc, cyc[1:] + cyc[:1]):
                wits.append(f"[{a} -> {b}: {edges[(a, b)]['witness']}]")
            anchor = edges[(cyc[0], cyc[1] if len(cyc) > 1 else cyc[0])]
            out.append(anchor["module"].finding(
                self.rule, anchor["line"],
                "lock-order cycle (potential deadlock): "
                + " ".join(f"{n} ->" for n in cyc) + f" {cyc[0]} — "
                + "; ".join(wits)
                + " — pick ONE order, document it, and take the locks in "
                  "that order everywhere (or split the critical section)"))
        base_path = (os.path.join(ctx.repo_root, LOCK_BASELINE_FILE)
                     if ctx.repo_root else None)
        if base_path and os.path.exists(base_path):
            try:
                with open(base_path, encoding="utf-8") as f:
                    base = {(e["from"], e["to"])
                            for e in json.load(f).get("edges", [])}
            except (OSError, ValueError, KeyError):
                base = None
            if base is None:
                out.append(Finding(
                    self.rule, LOCK_BASELINE_FILE, 1,
                    "unreadable lock-order baseline — regenerate with "
                    "--write-lock-baseline"))
            else:
                for key, w in sorted(edges.items()):
                    if key not in base:
                        out.append(w["module"].finding(
                            self.rule, w["line"],
                            f"new lock-order edge {key[0]} -> {key[1]} is "
                            f"not in the committed {LOCK_BASELINE_FILE} "
                            f"({w['witness']}) — review it for cycles "
                            "against the documented order, then "
                            "regenerate the baseline in this diff"))
                for a, b in sorted(base - set(edges)):
                    out.append(Finding(
                        self.rule, LOCK_BASELINE_FILE, 1,
                        f"stale baseline edge {a} -> {b} is no longer "
                        "observed — regenerate with --write-lock-baseline "
                        "so the documented order stays the real one"))
        return out


# --------------------------------------------------------------------------
# GC07 — use-after-donate
# --------------------------------------------------------------------------

_JIT_NAMES = ("jax.jit", "jit", "pjit", "jax.pjit")


def _donated_indices(fi, idx, expr):
    """Statically-resolvable donated positions from a donate_argnums
    value: int, tuple of ints, a local name bound to one, or a
    conditional between two (union).  None = unresolvable (the pass then
    skips rather than guesses)."""
    if isinstance(expr, ast.Constant) and isinstance(expr.value, int):
        return {expr.value}
    if isinstance(expr, (ast.Tuple, ast.List)):
        out = set()
        for e in expr.elts:
            if isinstance(e, ast.Constant) and isinstance(e.value, int):
                out.add(e.value)
            else:
                return None
        return out
    if isinstance(expr, ast.IfExp):
        a = _donated_indices(fi, idx, expr.body)
        b = _donated_indices(fi, idx, expr.orelse)
        if a is None and b is None:
            return None
        return (a or set()) | (b or set())
    if isinstance(expr, ast.Name) and fi is not None:
        local = idx.summary(fi).assigns.get(expr.id)
        if local is not None and local is not expr:
            return _donated_indices(fi, idx, local)
    return None


def _find_jit_call(expr):
    """The ``jax.jit(..., donate_argnums=...)`` call inside ``expr``
    (wrapper-transparent: ``wrap_jit(jax.jit(...))`` resolves through),
    or None."""
    for n in ast.walk(expr):
        if isinstance(n, ast.Call) and dotted_chain(n.func) in _JIT_NAMES:
            if any(kw.arg in ("donate_argnums", "donate_argnames")
                   for kw in n.keywords):
                return n
    return None


def _bind_lines(fnnode, chain):
    """Line numbers where ``chain`` (a dotted binding like 'pools' or
    'self._pools') is rebound inside the function."""
    lines = []

    def tgt_chains(t):
        if isinstance(t, (ast.Tuple, ast.List)):
            for e in t.elts:
                yield from tgt_chains(e)
        elif isinstance(t, ast.Starred):
            yield from tgt_chains(t.value)
        else:
            c = dotted_chain(t)
            if c:
                yield c

    for n in iter_own_nodes(fnnode):
        tgts = []
        if isinstance(n, ast.Assign):
            tgts = n.targets
        elif isinstance(n, (ast.AugAssign, ast.AnnAssign, ast.NamedExpr)):
            tgts = [n.target]
        elif isinstance(n, (ast.For, ast.AsyncFor)):
            tgts = [n.target]
        for t in tgts:
            if chain in tgt_chains(t):
                lines.append(n.lineno)
    return lines


def _loads_of(fnnode, chain):
    """(line, col, node) of every Load of ``chain`` in the function."""
    out = []
    for n in iter_own_nodes(fnnode):
        if "." in chain:
            if (isinstance(n, ast.Attribute)
                    and isinstance(n.ctx, ast.Load)
                    and dotted_chain(n) == chain):
                out.append((n.lineno, n.col_offset, n))
        else:
            if (isinstance(n, ast.Name) and n.id == chain
                    and isinstance(n.ctx, ast.Load)):
                out.append((n.lineno, n.col_offset, n))
    return sorted(out, key=lambda t: (t[0], t[1]))


def _within(node, call):
    end_line = getattr(call, "end_lineno", call.lineno)
    end_col = getattr(call, "end_col_offset", 1 << 30)
    if node.lineno < call.lineno or node.lineno > end_line:
        return False
    if node.lineno == call.lineno and node.col_offset < call.col_offset:
        return False
    if node.lineno == end_line and node.col_offset >= end_col:
        return False
    return True


@register_pass
class UseAfterDonatePass(Pass):
    rule = "GC07"
    summary = ("use-after-donate: a buffer passed at a donate_argnums "
               "position is freed by dispatch — reading the same binding "
               "afterwards (or on the next loop iteration without "
               "rebinding) is a use-after-free")

    def check_project(self, ctx):
        idx = ctx.index
        donating = self._donating_bindings(ctx, idx)
        out = []
        if not donating:
            return out
        by_attr, by_name = {}, {}
        for (rel, kind, name), idxs in donating.items():
            if kind == "attr":
                by_attr.setdefault(name, set()).update(idxs)
            else:
                by_name.setdefault((rel, name), set()).update(idxs)
        for m in ctx.modules:
            for fi in sorted(idx.functions_in(m), key=lambda f: f.qual):
                out.extend(self._check_function(
                    idx, m, fi, by_attr, by_name))
        return out

    def _donating_bindings(self, ctx, idx):
        """{(rel, 'attr'|'name', binding): donated_index_set} plus the
        same through one builder level (a function whose return value is
        a donating jit marks every binding assigned from a call to
        it)."""
        donating = {}
        builder_rets = {}   # FunctionInfo.key -> indices
        for m in ctx.modules:
            for fi in idx.functions_in(m):
                s = idx.summary(fi)
                for expr in s.ret_exprs:
                    jc = _find_jit_call(expr)
                    if jc is not None:
                        idxs = self._indices_of(fi, idx, jc)
                        if idxs:
                            builder_rets[fi.key] = idxs
        for m in ctx.modules:
            for fi in list(idx.functions_in(m)) + [None]:
                body = (fi.node.body if fi is not None else m.tree.body)
                nodes = []
                for stmt in body:
                    if fi is None and isinstance(
                            stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                                   ast.ClassDef)):
                        continue
                    nodes.extend(
                        n for n in ([stmt] + list(iter_own_nodes(stmt)))
                        if isinstance(n, ast.Assign))
                for n in nodes:
                    if len(n.targets) != 1:
                        continue
                    chain = dotted_chain(n.targets[0])
                    if not chain:
                        continue
                    idxs = None
                    jc = _find_jit_call(n.value)
                    if jc is not None:
                        idxs = self._indices_of(fi, idx, jc)
                    elif isinstance(n.value, ast.Call) and fi is not None:
                        g = idx.resolve_call(m, fi, n.value)
                        if g is not None and g.key in builder_rets:
                            idxs = builder_rets[g.key]
                    if not idxs:
                        continue
                    if chain.startswith("self."):
                        key = (m.rel, "attr", chain.split(".", 1)[1])
                    elif "." not in chain:
                        key = (m.rel, "name", chain)
                    else:
                        continue
                    donating.setdefault(key, set()).update(idxs)
        return donating

    @staticmethod
    def _indices_of(fi, idx, jit_call):
        for kw in jit_call.keywords:
            if kw.arg == "donate_argnums":
                return _donated_indices(fi, idx, kw.value)
        return None   # donate_argnames: positions unresolvable statically

    def _check_function(self, idx, m, fi, by_attr, by_name):
        out = []
        s = idx.summary(fi)
        loops = [n for n in iter_own_nodes(fi.node)
                 if isinstance(n, (ast.For, ast.While, ast.AsyncFor))]
        for call in s.calls:
            f = call.func
            idxs = None
            callee = dotted_chain(f)
            if callee is None:
                continue
            if "." in callee:
                attr = callee.rsplit(".", 1)[1]
                idxs = by_attr.get(attr)
            else:
                idxs = by_name.get((m.rel, callee))
            if not idxs:
                continue
            for i in sorted(idxs):
                if i >= len(call.args):
                    continue
                chain = dotted_chain(call.args[i])
                if not chain or chain == "self":
                    continue
                out.extend(self._check_binding(m, fi, call, chain, loops,
                                               callee, i))
        return out

    def _check_binding(self, m, fi, call, chain, loops, callee, pos):
        out = []
        end_line = getattr(call, "end_lineno", call.lineno)
        binds = _bind_lines(fi.node, chain)
        loads = _loads_of(fi.node, chain)
        # straight-line: reads after the dispatch, before any rebinding
        kill = min((b for b in binds if b >= call.lineno),
                   default=None)
        for line, _col, node in loads:
            if line <= end_line or _within(node, call):
                continue
            if kill is not None and line > kill:
                break
            out.append(m.finding(
                self.rule, node,
                f"use-after-donate: {chain!r} was donated to "
                f"{callee}() (donate_argnums position {pos}, line "
                f"{call.lineno}) — its buffer is freed by dispatch; "
                "rebind the result over it or pass a copy"))
            break   # one finding per donated binding per callsite
        # loop-carried: dispatch inside a loop, binding never rebound in
        # the loop — the next iteration reads a freed buffer
        for loop in loops:
            lend = getattr(loop, "end_lineno", loop.lineno)
            if not (loop.lineno <= call.lineno <= lend):
                continue
            if any(loop.lineno <= b <= lend for b in binds):
                continue
            reads = [n for line, _c, n in loads
                     if loop.lineno <= line <= lend
                     and not _within(n, call)]
            # even with no extra reads, the NEXT iteration's dispatch
            # itself re-reads the freed buffer
            node = reads[0] if reads else call
            out.append(m.finding(
                self.rule, node,
                f"use-after-donate (loop-carried): {chain!r} is "
                f"donated to {callee}() inside this loop but never "
                "rebound — the second iteration dispatches a freed "
                "buffer; rebind the jit's result over it each "
                "iteration"))
            break
        return out


# --------------------------------------------------------------------------
# GC10 — thread lifecycle
# --------------------------------------------------------------------------

_STOPISH = re.compile(
    r"stop|shutdown|clos|running|alive|done|exit|finish|drain|quit|cancel",
    re.IGNORECASE)


@register_pass
class ThreadLifecyclePass(Pass):
    rule = "GC10"
    summary = ("thread lifecycle: every thread must be daemon or provably "
               "joined, and every `while True` loop reachable from a "
               "thread target must read a stop/shutdown flag or return")

    def check_project(self, ctx):
        idx = ctx.index
        out = []
        entries = []
        for m in ctx.modules:
            joins = set()
            starts = []
            for fi in sorted(idx.functions_in(m), key=lambda f: f.qual):
                s = idx.summary(fi)
                joins |= s.joins
                starts.extend((fi, call, bind, line)
                              for call, bind, line in s.threads)
            for fi, call, bind, line in starts:
                target = next(
                    (kw.value for kw in call.keywords
                     if kw.arg == "target"), None)
                daemon = next(
                    (kw.value for kw in call.keywords
                     if kw.arg == "daemon"), None)
                if not (isinstance(daemon, ast.Constant)
                        and daemon.value is True):
                    if bind is None or bind not in joins:
                        out.append(m.finding(
                            self.rule, line,
                            "thread is neither daemon=True nor provably "
                            "joined (no `.join()` on its binding in this "
                            "module) — it outlives shutdown and can hang "
                            "interpreter exit"))
                if target is not None:
                    g = self._resolve_target(idx, m, fi, target)
                    if g is not None:
                        entries.append(g)
        reachable = self._reachable(idx, entries)
        seen_loops = set()
        for fi in sorted(reachable, key=lambda f: (f.module.rel, f.qual)):
            s = idx.summary(fi)
            for loop in s.while_trues:
                key = (fi.module.rel, loop.lineno)
                if key in seen_loops:
                    continue
                seen_loops.add(key)
                if self._loop_can_stop(loop):
                    continue
                out.append(fi.module.finding(
                    self.rule, loop,
                    f"`while True` in thread-reachable {fi.qual!r} never "
                    "reads a stop/shutdown flag and cannot return — the "
                    "thread is unstoppable; check a stop flag (or exit on "
                    "a queue sentinel) each iteration"))
        return out

    @staticmethod
    def _resolve_target(idx, m, fi, target):
        chain = dotted_chain(target)
        if chain is None:
            return None
        parts = chain.split(".")
        if parts[0] in ("self", "cls") and fi.cls is not None:
            return fi.cls.methods.get(parts[-1])
        if len(parts) == 1:
            cur = fi
            while cur is not None:
                hit = cur.nested.get(parts[0])
                if hit is not None:
                    return hit
                cur = cur.parent
            return idx.module_funcs.get(m.rel, {}).get(parts[0])
        mrel = idx.mod_imports.get(m.rel, {}).get(
            "modules", {}).get(parts[0])
        if mrel:
            return idx.module_funcs.get(mrel, {}).get(parts[-1])
        cands = idx.methods_by_name.get(parts[-1], [])
        return cands[0] if len(cands) == 1 else None

    @staticmethod
    def _reachable(idx, entries):
        seen = set()
        work = list(entries)
        reach = []
        while work:
            fi = work.pop()
            if fi.key in seen:
                continue
            seen.add(fi.key)
            reach.append(fi)
            for call in idx.summary(fi).calls:
                g = idx.resolve_call(fi.module, fi, call)
                if g is not None and g.key not in seen:
                    work.append(g)
        return reach

    @staticmethod
    def _loop_can_stop(loop):
        for n in iter_own_nodes(loop):
            if isinstance(n, ast.Return):
                return True
            if isinstance(n, ast.Attribute) and isinstance(n.ctx, ast.Load) \
                    and _STOPISH.search(n.attr):
                return True
            if isinstance(n, ast.Name) and isinstance(n.ctx, ast.Load) \
                    and _STOPISH.search(n.id):
                return True
        return False
