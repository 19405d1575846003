"""graftcheck core — the port's copy of ``mxnet_tpu/analysis/core.py``.

The correctness-tooling analog of MXNet's cpplint/sanitizer gates
(SURVEY §4): the invariants the port's runtime relies on — hot-path
purity, no re-capture hazards, lock discipline in threaded modules,
env-knob hygiene — are tribal knowledge unless a machine checks them on
every push.  This module is the framework: a pluggable pass registry,
per-line suppressions with mandatory justifications, JSON + SARIF + human
output, a committed-baseline diff mode, and an exit-code contract for CI.
The passes themselves live in the ``passes/`` package (rules GC01–GC10).
It is the reference's module name for name; only the package it reads
(``mxnet_tpu_torch``) and its baselines (``graftcheck-torch-*.json``)
differ.

The framework also carries an **interprocedural layer**
(:class:`ProjectIndex`): a project-wide symbol table (functions, classes,
lock attributes, import aliases, string constants), per-function
summaries (locks acquired, ``with``-held regions and the calls made
inside them, files opened/renamed, threads started, ``while True``
loops, returned path literals) and a call graph with a transitive
may-acquire closure.  The concurrency/protocol passes (GC06–GC10) are
thin rules over these summaries.

Design constraints:

- **stdlib only** — the CI graftcheck lane runs before any pip install,
  so nothing here (or in ``passes/``) may import torch, numpy, or the
  mxnet_tpu_torch runtime.  Config knowledge (``config.KNOWN_VARS``) is read by
  *parsing* config.py, never importing it.
- **suppressions carry justifications** — ``# graftcheck: ignore[GC01] — why``
  on (or immediately above) the flagged line.  A bare ``ignore[...]``
  with no justification is itself a finding (GC00), so the suppression
  ledger stays reviewable.
- **exit codes**: 0 = clean (no unsuppressed findings), 1 = findings,
  2 = usage/internal error.
"""

from __future__ import annotations

import ast
import hashlib
import json
import os
import posixpath
import re
import sys
import time

__all__ = [
    "Finding", "ModuleInfo", "Context", "Pass", "PASSES", "register_pass",
    "parse_suppressions", "analyze_paths", "check_source", "check_sources",
    "ProjectIndex", "FunctionInfo", "ClassInfo", "iter_own_nodes",
    "dotted_chain", "call_leaf", "to_sarif", "main", "readme_section",
]

# the package the analyzer reads: import resolution, rel paths, the CLI's
# default path
PACKAGE = "mxnet_tpu_torch"

# --------------------------------------------------------------------------
# findings
# --------------------------------------------------------------------------


class Finding:
    """One rule violation at a source location."""

    __slots__ = ("rule", "path", "line", "message", "source_line")

    def __init__(self, rule, path, line, message, source_line=""):
        self.rule = rule
        self.path = path          # repo-relative posix path
        self.line = int(line)
        self.message = message
        self.source_line = source_line

    @property
    def fingerprint(self):
        """Content-addressed identity for baseline diffing: stable across
        unrelated edits that only shift line numbers."""
        text = self.source_line.strip() or f"line{self.line}"
        h = hashlib.sha1(
            f"{self.rule}|{self.path}|{text}".encode()).hexdigest()
        return h[:16]

    def to_dict(self):
        return {"rule": self.rule, "path": self.path, "line": self.line,
                "message": self.message, "fingerprint": self.fingerprint}

    def render(self):
        return f"{self.path}:{self.line}: {self.rule} {self.message}"

    def __repr__(self):
        return f"<Finding {self.render()}>"


# --------------------------------------------------------------------------
# suppressions
# --------------------------------------------------------------------------

_SUPPRESS_RE = re.compile(
    r"#\s*graftcheck:\s*ignore\[([A-Za-z0-9_,\s]+)\]\s*(?:[-—–:]+\s*(\S.*))?")
_COMMENT_ONLY_RE = re.compile(r"^\s*(#|$)")


def parse_suppressions(lines):
    """Map line number (1-based) -> (rules, justification, comment_line).

    A suppression on a code line applies to that line; on a comment-only
    line it applies to the next code line (stacked comment lines chain).
    A trailing suppression with no code line to govern is kept under the
    line past EOF so the hygiene checks still see it.
    """
    out = {}
    pending = []  # suppressions waiting for the next code line
    for i, text in enumerate(lines, start=1):
        m = _SUPPRESS_RE.search(text)
        entry = None
        if m:
            rules = frozenset(
                r.strip().upper() for r in m.group(1).split(",") if r.strip())
            entry = (rules, (m.group(2) or "").strip(), i)
        if _COMMENT_ONLY_RE.match(text):
            if entry:
                pending.append(entry)
            continue
        # a code line: attach its own inline suppression plus any pending
        here = list(pending)
        pending = []
        if entry:
            here.append(entry)
        if here:
            rules = frozenset().union(*(e[0] for e in here))
            just = "; ".join(e[1] for e in here if e[1])
            out[i] = (rules, just, here[0][2])
    if pending:
        # dangling at EOF: governs nothing, but must not vanish silently
        rules = frozenset().union(*(e[0] for e in pending))
        just = "; ".join(e[1] for e in pending if e[1])
        out[len(lines) + 1] = (rules, just, pending[0][2])
    return out


# --------------------------------------------------------------------------
# module / project context
# --------------------------------------------------------------------------


class ModuleInfo:
    """One parsed source file plus its suppression map."""

    def __init__(self, path, rel, text):
        self.path = path          # display path (repo-relative when known)
        self.rel = rel            # path relative to the package root, posix
        self.text = text
        self.lines = text.splitlines()
        self.tree = ast.parse(text, filename=path)
        self.suppressions = parse_suppressions(self.lines)

    def line_text(self, lineno):
        if 1 <= lineno <= len(self.lines):
            return self.lines[lineno - 1]
        return ""

    def finding(self, rule, node_or_line, message):
        line = getattr(node_or_line, "lineno", node_or_line)
        return Finding(rule, self.path, line, message, self.line_text(line))


class Context:
    """Project-wide state shared by passes: every module, plus the repo /
    package roots so cross-file rules (knob catalog vs README) can see
    both sides."""

    def __init__(self, modules, package_root=None, repo_root=None):
        self.modules = modules
        self.package_root = package_root
        self.repo_root = repo_root
        self._index = None

    @property
    def index(self):
        """Lazy project-wide :class:`ProjectIndex` (built on first use so
        module-local passes pay nothing for it)."""
        if self._index is None:
            self._index = ProjectIndex(self)
        return self._index

    def module(self, rel):
        for m in self.modules:
            if m.rel == rel:
                return m
        return None

    def read_repo_file(self, name):
        if not self.repo_root:
            return None
        p = os.path.join(self.repo_root, name)
        try:
            with open(p, encoding="utf-8") as f:
                return f.read()
        except OSError:
            return None


# the port's part of the repo README: the knob table (GC03) and the metric
# catalog (GC09) are read from this section only, so the reference's own
# tables elsewhere in the file document nothing of the port
README_SECTION = "## PyTorch/CUDA port (`mxnet_tpu_torch`)"


def readme_section(ctx):
    """The port's section of the repo's README.md (from its heading to the
    next level-2 heading), the whole file when it has no such heading, or
    None without a README."""
    text = ctx.read_repo_file("README.md")
    if text is None:
        return None
    at = text.find(README_SECTION + "\n")
    if at < 0:
        return text
    body = text[at + len(README_SECTION):]
    fence, out = False, []
    for line in body.splitlines(keepends=True):
        if line.startswith("```"):
            fence = not fence
        elif not fence and line.startswith("## "):
            break
        out.append(line)
    return README_SECTION + "".join(out)


# --------------------------------------------------------------------------
# interprocedural layer: symbol index + per-function summaries + call graph
# --------------------------------------------------------------------------

_LOCK_CTORS = {"Lock", "RLock", "Condition", "Semaphore", "BoundedSemaphore"}


def dotted_chain(node):
    """``'a.b.c'`` for a Name/Attribute chain, else None."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def call_leaf(call):
    """Leaf name of a call's func (``'replace'`` for ``os.replace(...)``)."""
    f = call.func
    if isinstance(f, ast.Attribute):
        return f.attr
    if isinstance(f, ast.Name):
        return f.id
    return None


def iter_own_nodes(node):
    """Every AST node lexically inside ``node``'s body, NOT descending
    into nested function/class/lambda definitions (their bodies run at a
    different time, under different locks)."""
    stack = list(ast.iter_child_nodes(node))
    while stack:
        n = stack.pop()
        yield n
        if not isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.ClassDef, ast.Lambda)):
            stack.extend(ast.iter_child_nodes(n))


def _lockish(name):
    low = name.lower()
    return "lock" in low or "mutex" in low


def _lock_ctor_of(expr):
    """``'Lock'``/``'RLock'``/... when ``expr`` constructs a threading
    primitive (``threading.Lock()``, bare ``Lock()``), else None.
    Wrapper-transparent: ``tracked(threading.Lock(), "name")`` — the
    MXNET_LOCKCHECK runtime validator — is still a Lock."""
    if not isinstance(expr, ast.Call):
        return None
    leaf = call_leaf(expr)
    if leaf in _LOCK_CTORS:
        return leaf
    for arg in expr.args:
        inner = _lock_ctor_of(arg)
        if inner is not None:
            return inner
    return None


class FunctionInfo:
    """One function/method (nested defs included) in the project index."""

    __slots__ = ("module", "qual", "cls", "name", "node", "parent", "nested")

    def __init__(self, module, qual, cls, name, node, parent=None):
        self.module = module      # ModuleInfo
        self.qual = qual          # 'Router._dispatch_loop', 'f.<locals>.g'
        self.cls = cls            # owning ClassInfo or None
        self.name = name
        self.node = node
        self.parent = parent      # enclosing FunctionInfo for nested defs
        self.nested = {}          # name -> FunctionInfo

    @property
    def key(self):
        return (self.module.rel, self.qual)

    def __repr__(self):
        return f"<FunctionInfo {self.module.rel}::{self.qual}>"


class ClassInfo:
    """One class: its methods plus the lock attributes its methods assign
    (``self.X = threading.Lock()``) and Condition->lock aliases
    (``self.C = threading.Condition(self.X)`` acquires X's lock)."""

    __slots__ = ("module", "name", "node", "methods", "lock_attrs",
                 "lock_aliases")

    def __init__(self, module, node):
        self.module = module
        self.name = node.name
        self.node = node
        self.methods = {}         # name -> FunctionInfo
        self.lock_attrs = {}      # attr -> ctor name ('Lock', 'RLock', ...)
        self.lock_aliases = {}    # attr -> underlying lock attr


class FnSummary:
    """Per-function facts the concurrency/protocol passes consume.

    ``acquires``      [(lock_id, line)] — every ``with <lock>:`` entered.
    ``pairs``         [(held_id, inner_id, held_line, inner_line)] — a
                      lock acquired while another is lexically held.
    ``region_calls``  [(held_id, held_line, Call)] — calls made while a
                      lock is held (the interprocedural edge source).
    ``calls``         [Call] — every call in the body.
    ``opens``         [(mode, Call, line)] — every builtin ``open``.
    ``replaces``      [(Call, line)] — ``os.replace`` / ``os.rename``.
    ``ret_exprs``     [expr] — returned expressions (path-literal carrier).
    ``threads``       [(Call, bind_chain, line)] — threading.Thread(...).
    ``joins``         {dotted chain} — receivers of ``.join()`` calls.
    ``while_trues``   [While] — literal ``while True:`` loops.
    ``assigns``       {name: expr} — first simple local assignment.
    """

    __slots__ = ("acquires", "pairs", "region_calls", "calls", "opens",
                 "replaces", "ret_exprs", "threads", "joins",
                 "while_trues", "assigns")

    def __init__(self):
        self.acquires = []
        self.pairs = []
        self.region_calls = []
        self.calls = []
        self.opens = []
        self.replaces = []
        self.ret_exprs = []
        self.threads = []
        self.joins = set()
        self.while_trues = []
        self.assigns = {}


class ProjectIndex:
    """Project-wide symbol table + summaries + call graph.

    Built once per Context (lazily via ``ctx.index``), stdlib-only, no
    imports of analyzed code.  Resolution is deliberately conservative:
    an unresolvable call or lock receiver yields *no* edge rather than a
    guessed one, so passes built on top under-approximate instead of
    spraying false positives.
    """

    def __init__(self, ctx):
        self.ctx = ctx
        self.rels = {m.rel for m in ctx.modules}
        self.functions = {}          # (rel, qual) -> FunctionInfo
        self.classes = {}            # (rel, name) -> ClassInfo
        self.module_funcs = {}       # rel -> {name: FunctionInfo}
        self.methods_by_name = {}    # method name -> [FunctionInfo]
        self.classes_by_lock_attr = {}   # attr -> [ClassInfo]
        self.module_lock_globals = {}    # rel -> {name: ctor}
        self.module_consts = {}      # rel -> {NAME: str}
        self.mod_imports = {}        # rel -> {'modules': {...}, 'symbols': {...}}
        self._summaries = {}
        self._may_acquire = {}
        self._ret_tokens = {}
        for m in ctx.modules:
            self._index_module(m)

    # -- construction -------------------------------------------------------

    def _module_file(self, prefix):
        """Map a package-relative dotted/posix prefix to a known module
        rel (``serving/replica`` -> ``serving/replica.py``)."""
        if prefix is None:
            return None
        for cand in ((prefix + ".py") if prefix else "__init__.py",
                     posixpath.join(prefix, "__init__.py") if prefix
                     else "__init__.py"):
            if cand in self.rels:
                return cand
        return None

    def _resolve_from(self, rel, module, level):
        """Package-relative dir prefix an ImportFrom targets, or None when
        it escapes the package / is third-party."""
        if level == 0:
            if module and (module == PACKAGE
                           or module.startswith(PACKAGE + ".")):
                return module[len(PACKAGE):].lstrip(".").replace(".", "/")
            return None
        base = posixpath.dirname(rel)
        for _ in range(level - 1):
            if not base:
                return None    # relative import escapes the package
            base = posixpath.dirname(base)
        sub = (module or "").replace(".", "/")
        return posixpath.join(base, sub) if sub else base

    def _index_module(self, m):
        rel = m.rel
        self.module_funcs[rel] = {}
        self.module_lock_globals[rel] = {}
        consts = self.module_consts[rel] = {}
        imports = self.mod_imports[rel] = {"modules": {}, "symbols": {}}
        for node in ast.walk(m.tree):
            if isinstance(node, ast.ImportFrom):
                base = self._resolve_from(rel, node.module, node.level)
                if base is None:
                    continue
                for al in node.names:
                    asname = al.asname or al.name
                    sub = (posixpath.join(base, al.name) if base
                           else al.name)
                    mrel = self._module_file(sub)
                    if mrel:
                        imports["modules"][asname] = mrel
                    else:
                        owner = self._module_file(base)
                        if owner:
                            imports["symbols"][asname] = (owner, al.name)
            elif isinstance(node, ast.Import):
                for al in node.names:
                    if al.asname and (al.name == PACKAGE or
                                      al.name.startswith(PACKAGE + ".")):
                        sub = al.name[len(PACKAGE):].lstrip(".")
                        mrel = self._module_file(sub.replace(".", "/"))
                        if mrel:
                            imports["modules"][al.asname] = mrel
        for node in m.tree.body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self._add_function(m, node, None, None, node.name)
            elif isinstance(node, ast.ClassDef):
                ci = ClassInfo(m, node)
                self.classes[(rel, ci.name)] = ci
                for sub in node.body:
                    if isinstance(sub, (ast.FunctionDef,
                                        ast.AsyncFunctionDef)):
                        fi = self._add_function(
                            m, sub, ci, None, f"{ci.name}.{sub.name}")
                        ci.methods[sub.name] = fi
                self._scan_lock_attrs(ci)
            elif (isinstance(node, ast.Assign) and len(node.targets) == 1
                    and isinstance(node.targets[0], ast.Name)):
                tname = node.targets[0].id
                if (isinstance(node.value, ast.Constant)
                        and isinstance(node.value.value, str)):
                    consts[tname] = node.value.value
                else:
                    ctor = _lock_ctor_of(node.value)
                    if ctor:
                        self.module_lock_globals[rel][tname] = ctor

    def _add_function(self, m, node, cls, parent, qual):
        fi = FunctionInfo(m, qual, cls, node.name, node, parent)
        self.functions[fi.key] = fi
        if cls is None and parent is None:
            self.module_funcs[m.rel].setdefault(node.name, fi)
        if cls is not None and parent is None:
            self.methods_by_name.setdefault(node.name, []).append(fi)
        for sub in iter_own_nodes(node):
            if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef)):
                child = self._add_function(
                    m, sub, cls, fi, f"{qual}.<locals>.{sub.name}")
                fi.nested[sub.name] = child
        return fi

    def _scan_lock_attrs(self, ci):
        for meth in ci.methods.values():
            for node in iter_own_nodes(meth.node):
                if not (isinstance(node, ast.Assign)
                        and len(node.targets) == 1):
                    continue
                tgt = node.targets[0]
                if not (isinstance(tgt, ast.Attribute)
                        and isinstance(tgt.value, ast.Name)
                        and tgt.value.id == "self"):
                    continue
                ctor = _lock_ctor_of(node.value)
                if ctor is None:
                    continue
                if ctor == "Condition" and node.value.args:
                    base = dotted_chain(node.value.args[0])
                    if base and base.startswith("self."):
                        ci.lock_aliases[tgt.attr] = base.split(".", 1)[1]
                        continue
                ci.lock_attrs[tgt.attr] = ctor
                self.classes_by_lock_attr.setdefault(tgt.attr, []).append(ci)

    # -- lock identity --------------------------------------------------------

    def lock_id(self, fi, expr):
        """Canonical identity of a lock acquisition expression, or None
        when ``expr`` is not recognisably a lock.

        Identities are ``rel::Class.attr`` for instance locks (Condition
        aliases resolved to the underlying lock), ``rel::name`` for
        module globals, ``rel::*.attr`` for lockish attrs on receivers no
        class claims.  Scoping by class keeps two ``_lock``\\ s in one
        module distinct; matching by attribute NAME (not instance) is the
        standard lock-*class* abstraction for order analysis.
        """
        chain = dotted_chain(expr)
        if chain is None:
            return None
        parts = chain.split(".")
        leaf = parts[-1]
        rel = fi.module.rel if fi is not None else None
        cls = fi.cls if fi is not None else None
        if len(parts) >= 2 and parts[0] in ("self", "cls") and cls:
            attr = cls.lock_aliases.get(leaf, leaf)
            if attr in cls.lock_attrs or _lockish(attr):
                return f"{rel}::{cls.name}.{attr}"
            return None
        if len(parts) == 1:
            if leaf in self.module_lock_globals.get(rel, ()):
                return f"{rel}::{leaf}"
            return f"{rel}::{leaf}" if _lockish(leaf) else None
        cands = self.classes_by_lock_attr.get(leaf, [])
        same = [c for c in cands if c.module.rel == rel]
        pick = (same[0] if len(same) == 1
                else cands[0] if len(cands) == 1 else None)
        if pick is not None:
            attr = pick.lock_aliases.get(leaf, leaf)
            return f"{pick.module.rel}::{pick.name}.{attr}"
        return f"{rel}::*.{leaf}" if _lockish(leaf) else None

    def lock_ctor(self, lock_id):
        """Constructor name behind an identity ('Lock', 'RLock', ...) or
        None when unknown."""
        rel, _, tail = lock_id.partition("::")
        if "." in tail:
            clsname, attr = tail.split(".", 1)
            ci = self.classes.get((rel, clsname))
            if ci:
                return ci.lock_attrs.get(attr)
            return None
        return self.module_lock_globals.get(rel, {}).get(tail)

    # -- summaries ------------------------------------------------------------

    def summary(self, fi):
        s = self._summaries.get(fi.key)
        if s is not None:
            return s
        s = FnSummary()
        self._summaries[fi.key] = s
        held = []           # [(lock_id, line)] lexically-held stack
        thread_binds = {}   # id(call) -> bound chain

        def walk(n):
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.ClassDef, ast.Lambda)):
                return
            if isinstance(n, (ast.With, ast.AsyncWith)):
                pushed = 0
                for item in n.items:
                    walk(item.context_expr)
                    lid = self.lock_id(fi, item.context_expr)
                    if lid is not None:
                        ln = item.context_expr.lineno
                        s.acquires.append((lid, ln))
                        for h, hl in held:
                            if h != lid:
                                s.pairs.append((h, lid, hl, ln))
                        held.append((lid, ln))
                        pushed += 1
                for b in n.body:
                    walk(b)
                if pushed:
                    del held[-pushed:]
                return
            if isinstance(n, ast.Assign) and len(n.targets) == 1:
                tgt = n.targets[0]
                if isinstance(tgt, ast.Name):
                    s.assigns.setdefault(tgt.id, n.value)
                if isinstance(n.value, ast.Call):
                    chain = dotted_chain(tgt)
                    if chain and call_leaf(n.value) == "Thread":
                        thread_binds[id(n.value)] = chain
            elif isinstance(n, ast.Call):
                s.calls.append(n)
                for h, hl in held:
                    s.region_calls.append((h, hl, n))
                leaf = call_leaf(n)
                fchain = dotted_chain(n.func)
                if leaf == "open" and fchain == "open" and n.args:
                    mode = "r"
                    if len(n.args) >= 2 and isinstance(n.args[1],
                                                       ast.Constant):
                        mode = str(n.args[1].value)
                    for kw in n.keywords:
                        if kw.arg == "mode" and isinstance(kw.value,
                                                           ast.Constant):
                            mode = str(kw.value.value)
                    s.opens.append((mode, n, n.lineno))
                elif leaf in ("replace", "rename") and fchain in (
                        "os.replace", "os.rename"):
                    s.replaces.append((n, n.lineno))
                elif leaf == "Thread" and fchain in ("threading.Thread",
                                                     "Thread"):
                    s.threads.append((n, thread_binds.get(id(n)), n.lineno))
                elif leaf == "join" and isinstance(n.func, ast.Attribute):
                    chain = dotted_chain(n.func.value)
                    if chain:
                        s.joins.add(chain)
            elif isinstance(n, ast.While):
                if (isinstance(n.test, ast.Constant)
                        and n.test.value is True):
                    s.while_trues.append(n)
            elif isinstance(n, ast.Return) and n.value is not None:
                s.ret_exprs.append(n.value)
            for c in ast.iter_child_nodes(n):
                walk(c)

        for stmt in fi.node.body:
            walk(stmt)
        return s

    # -- call resolution --------------------------------------------------------

    def resolve_call(self, module, fi, call):
        """FunctionInfo a call dispatches to, or None.  Conservative:
        self-methods, module functions, nested defs, imported project
        symbols, ``alias.func`` through a project-module alias, and
        method names defined by exactly one class (module-local first,
        then project-wide)."""
        f = call.func
        if isinstance(f, ast.Name):
            cur = fi
            while cur is not None:
                hit = cur.nested.get(f.id)
                if hit is not None:
                    return hit
                cur = cur.parent
            hit = self.module_funcs.get(module.rel, {}).get(f.id)
            if hit is not None:
                return hit
            sym = self.mod_imports.get(module.rel, {}).get(
                "symbols", {}).get(f.id)
            if sym:
                owner, name = sym
                return self.module_funcs.get(owner, {}).get(name)
            return None
        if not isinstance(f, ast.Attribute):
            return None
        leaf = f.attr
        recv = f.value
        if isinstance(recv, ast.Name):
            if recv.id in ("self", "cls") and fi is not None and fi.cls:
                hit = fi.cls.methods.get(leaf)
                if hit is not None:
                    return hit
            mrel = self.mod_imports.get(module.rel, {}).get(
                "modules", {}).get(recv.id)
            if mrel:
                return self.module_funcs.get(mrel, {}).get(leaf)
        cands = self.methods_by_name.get(leaf, [])
        same = [c for c in cands if c.module.rel == module.rel]
        if len(same) == 1:
            return same[0]
        if len(cands) == 1:
            return cands[0]
        return None

    # -- transitive lock closure --------------------------------------------------

    def may_acquire(self, fi, _stack=None):
        """{lock_id: (call_chain, site)} — every lock ``fi`` may take,
        directly or through resolvable calls.  ``call_chain`` is the
        tuple of ``rel::qual`` hops from ``fi`` to the acquiring
        function (empty = direct), ``site`` the acquisition ``rel:line``.
        Recursion through call-graph cycles is cut (first visit wins)."""
        if fi.key in self._may_acquire:
            return self._may_acquire[fi.key]
        if _stack is None:
            _stack = set()
        if fi.key in _stack:
            return {}
        _stack.add(fi.key)
        out = {}
        s = self.summary(fi)
        for lid, ln in s.acquires:
            out.setdefault(lid, ((), f"{fi.module.rel}:{ln}"))
        for call in s.calls:
            g = self.resolve_call(fi.module, fi, call)
            if g is None:
                continue
            for lid, (chain, site) in self.may_acquire(g, _stack).items():
                out.setdefault(
                    lid, ((f"{g.module.rel}::{g.qual}",) + chain, site))
        _stack.discard(fi.key)
        self._may_acquire[fi.key] = out
        return out

    # -- string/path token resolution ----------------------------------------------

    def expr_tokens(self, fi, expr, _depth=0, _seen=None):
        """Every string literal an expression can carry: constants,
        f-string fragments, module-level string constants, simple local
        assignments, and (one call deep per level, 3 levels max) the
        returned literals of resolvable project helpers — so
        ``open(self._state_path() + '.tmp')`` resolves through
        ``_state_path`` to ``{'router.json', '.tmp'}``."""
        if _seen is None:
            _seen = set()
        toks = set()
        if _depth > 3:
            return toks
        for n in ast.walk(expr):
            if isinstance(n, ast.Constant) and isinstance(n.value, str):
                if n.value:
                    toks.add(n.value)
            elif isinstance(n, ast.Name):
                key = (fi.key if fi else None, n.id)
                if key in _seen:
                    continue
                _seen.add(key)
                rel = fi.module.rel if fi else None
                const = self.module_consts.get(rel, {}).get(n.id)
                if const:
                    toks.add(const)
                elif fi is not None:
                    local = self.summary(fi).assigns.get(n.id)
                    if local is not None and local is not expr:
                        toks |= self.expr_tokens(fi, local, _depth + 1,
                                                 _seen)
            elif isinstance(n, ast.Call):
                g = self.resolve_call(fi.module, fi, n) if fi else None
                if g is not None:
                    toks |= self.ret_tokens(g, _depth + 1)
        return toks

    def ret_tokens(self, fi, _depth=0):
        """String literals a function's return expressions can carry."""
        if fi.key in self._ret_tokens:
            return self._ret_tokens[fi.key]
        self._ret_tokens[fi.key] = set()   # cycle cut
        toks = set()
        if _depth <= 3:
            for expr in self.summary(fi).ret_exprs:
                toks |= self.expr_tokens(fi, expr, _depth)
        self._ret_tokens[fi.key] = toks
        return toks

    # -- convenience ----------------------------------------------------------------

    def functions_in(self, module):
        return [fi for fi in self.functions.values()
                if fi.module is module]


# --------------------------------------------------------------------------
# pass registry
# --------------------------------------------------------------------------


class Pass:
    """Base class for one rule.  Subclasses set ``rule`` + ``summary`` and
    implement ``check_module`` (per file) and/or ``check_project``
    (cross-file, runs once with the full Context)."""

    rule = "GC00"
    summary = ""

    def check_module(self, module, ctx):  # noqa: ARG002
        return []

    def check_project(self, ctx):  # noqa: ARG002
        return []


PASSES: list = []


def register_pass(cls):
    """Decorator adding a Pass subclass to the registry (pluggable: any
    module imported before the run may register more)."""
    PASSES.append(cls())
    return cls


# --------------------------------------------------------------------------
# runner
# --------------------------------------------------------------------------


def _iter_py_files(paths):
    for p in paths:
        if os.path.isfile(p):
            if p.endswith(".py"):
                yield p
        else:
            for dirpath, dirnames, filenames in os.walk(p):
                dirnames[:] = sorted(
                    d for d in dirnames
                    if d not in ("__pycache__", ".git", ".claude"))
                for fn in sorted(filenames):
                    if fn.endswith(".py"):
                        yield os.path.join(dirpath, fn)


def _package_rel(path):
    """Path of a module relative to its enclosing ``mxnet_tpu_torch``
    package (what HOT_PATHS / THREADED_MODULES key on); falls back to
    basename."""
    parts = os.path.abspath(path).replace(os.sep, "/").split("/")
    if PACKAGE in parts:
        idx = len(parts) - 1 - parts[::-1].index(PACKAGE)
        return "/".join(parts[idx + 1:])
    return parts[-1]


def load_module(path, repo_root=None):
    with open(path, encoding="utf-8") as f:
        text = f.read()
    display = path
    if repo_root:
        try:
            display = os.path.relpath(path, repo_root).replace(os.sep, "/")
        except ValueError:
            pass
    return ModuleInfo(display, _package_rel(path), text)


def _apply_suppressions(module, findings):
    """Split raw findings into (kept, suppressed) per the module's
    suppression map.  An unjustified suppression never suppresses (its
    GC00 comes from _check_suppression_rules, which sees every ignore
    whether or not a finding matched)."""
    kept, suppressed = [], []
    for f in findings:
        sup = module.suppressions.get(f.line)
        if sup and f.rule in sup[0] and sup[1]:
            suppressed.append(f)
        else:
            kept.append(f)
    return kept, suppressed


def _check_suppression_rules(module, known_rules):
    """Hygiene over EVERY ignore[...] comment, matched or not: unknown
    rule ids are typos that disable nothing, and a missing justification
    is itself a finding — both keep the suppression ledger reviewable."""
    out = []
    seen = set()
    for line, (rules, just, at) in sorted(module.suppressions.items()):
        if at in seen:
            continue
        seen.add(at)
        for r in sorted(rules):
            if r not in known_rules:
                out.append(module.finding(
                    "GC00", at, f"unknown rule {r!r} in suppression "
                    f"(known: {', '.join(sorted(known_rules))})"))
        if not just:
            out.append(module.finding(
                "GC00", at,
                "suppression has no justification — write "
                f"'# graftcheck: ignore[{', '.join(sorted(rules))}] — "
                "why this is safe'"))
    return out


def build_context(paths, repo_root=None):
    """Load every .py under ``paths`` into a Context.  Returns
    (ctx, errors) where errors are GC00 syntax-error findings."""
    modules, errors = [], []
    for path in _iter_py_files(paths):
        try:
            modules.append(load_module(path, repo_root=repo_root))
        except SyntaxError as e:
            errors.append(Finding("GC00", path, e.lineno or 0,
                                  f"syntax error: {e.msg}"))
    package_root = None
    for m in modules:
        if m.rel == "config.py":
            package_root = os.path.dirname(os.path.abspath(
                os.path.join(repo_root or ".", m.path)))
    ctx = Context(modules, package_root=package_root, repo_root=repo_root)
    return ctx, errors


def _selected_passes(select=None, ignore=None):
    passes = list(PASSES)
    if select is not None:
        want = {r.upper() for r in select}
        passes = [p for p in passes if p.rule in want]
    if ignore:
        skip = {r.upper() for r in ignore}
        passes = [p for p in passes if p.rule not in skip]
    return passes


def analyze_context(ctx, errors=(), select=None, ignore=None, stats=None):
    """Run the (selected) registered passes over a prebuilt Context.

    Returns (findings, suppressed, modules); ``stats`` (optional dict) is
    filled with ``rule -> {'seconds': s, 'findings': n}``.
    """
    modules = ctx.modules
    passes = _selected_passes(select, ignore)
    known_rules = {p.rule for p in PASSES} | {"GC00"}
    all_kept, all_suppressed = list(errors), []
    by_module = {id(m): [] for m in modules}
    for p in passes:
        t0 = time.perf_counter()
        raw = []
        for m in modules:
            raw.extend(p.check_module(m, ctx))
        raw.extend(p.check_project(ctx))
        if stats is not None:
            stats[p.rule] = {"seconds": time.perf_counter() - t0,
                             "findings": len(raw)}
        for f in raw:
            m = next((mm for mm in modules if mm.path == f.path), None)
            if m is not None:
                by_module[id(m)].append(f)
            else:
                all_kept.append(f)
    hygiene = select is None or "GC00" in {r.upper() for r in select}
    if ignore and "GC00" in {r.upper() for r in ignore}:
        hygiene = False
    for m in modules:
        kept, suppressed = _apply_suppressions(m, by_module[id(m)])
        if hygiene:
            kept.extend(_check_suppression_rules(m, known_rules))
        all_kept.extend(kept)
        all_suppressed.extend(suppressed)
    all_kept.sort(key=lambda f: (f.path, f.line, f.rule))
    return all_kept, all_suppressed, modules


def analyze_paths(paths, repo_root=None, select=None, ignore=None,
                  stats=None):
    """Run every registered pass over ``paths``.

    Returns (findings, suppressed, modules) — findings are unsuppressed.
    """
    ctx, errors = build_context(paths, repo_root=repo_root)
    return analyze_context(ctx, errors, select=select, ignore=ignore,
                           stats=stats)


def check_source(source, rel="module.py", path=None):
    """Test helper: run all passes over one in-memory source snippet as if
    it lived at ``rel`` inside the mxnet_tpu_torch package.  Returns
    (findings, suppressed)."""
    return check_sources({rel: source}, path=path)


def check_sources(sources, path=None, repo_root=None):
    """Test helper: run all passes over several in-memory modules at once
    (``{rel: source}``) so cross-file rules (lock order through calls,
    chaos-registry drift) are exercisable without touching disk.  Returns
    (findings, suppressed) over all modules."""
    modules = [ModuleInfo(path or rel, rel, src)
               for rel, src in sorted(sources.items())]
    ctx = Context(modules, repo_root=repo_root)
    findings, suppressed, _ = analyze_context(ctx)
    return findings, suppressed


# --------------------------------------------------------------------------
# baseline
# --------------------------------------------------------------------------


def load_baseline(path):
    """Baseline as a MULTISET {(rule, path, fingerprint): count} —
    identical-text findings share a fingerprint, so each baseline entry
    must excuse exactly one occurrence or a copy-pasted new violation
    would hide behind an old one."""
    with open(path, encoding="utf-8") as f:
        data = json.load(f)
    counts: dict = {}
    for e in data.get("findings", []):
        k = (e["rule"], e["path"], e["fingerprint"])
        counts[k] = counts.get(k, 0) + 1
    return counts


def write_baseline(path, findings):
    data = {
        "comment": "graftcheck baseline — known findings new code is "
                   "diffed against; regenerate with --write-baseline",
        "findings": [
            {"rule": f.rule, "path": f.path, "fingerprint": f.fingerprint,
             "message": f.message}
            for f in findings
        ],
    }
    with open(path, "w", encoding="utf-8") as f:
        json.dump(data, f, indent=2, sort_keys=True)
        f.write("\n")


# --------------------------------------------------------------------------
# SARIF (GitHub code-scanning annotations)
# --------------------------------------------------------------------------


def to_sarif(findings, passes=None):
    """Findings as a SARIF 2.1.0 document (one run, one result per
    finding, fingerprints carried for alert dedup)."""
    rules = [{"id": p.rule,
              "shortDescription": {"text": p.summary or p.rule}}
             for p in (passes if passes is not None else PASSES)]
    if not any(r["id"] == "GC00" for r in rules):
        rules.insert(0, {"id": "GC00", "shortDescription": {
            "text": "suppression hygiene / parse errors"}})
    return {
        "version": "2.1.0",
        "$schema": ("https://raw.githubusercontent.com/oasis-tcs/"
                    "sarif-spec/master/Schemata/sarif-schema-2.1.0.json"),
        "runs": [{
            "tool": {"driver": {
                "name": "graftcheck",
                "informationUri":
                    "https://github.com/apache/incubator-mxnet",
                "rules": rules,
            }},
            "results": [{
                "ruleId": f.rule,
                "level": "error",
                "message": {"text": f.message},
                "partialFingerprints": {"graftcheck/v1": f.fingerprint},
                "locations": [{"physicalLocation": {
                    "artifactLocation": {"uri": f.path,
                                         "uriBaseId": "SRCROOT"},
                    "region": {"startLine": max(1, f.line)},
                }}],
            } for f in findings],
        }],
    }


# --------------------------------------------------------------------------
# CLI
# --------------------------------------------------------------------------

_USAGE = """\
usage: torch_graftcheck.py [paths ...] [options]

Repo-native static analysis: hot-path purity (GC01), retrace hazards
(GC02), env-knob hygiene (GC03), lock discipline (GC04), telemetry-flag
discipline (GC05), lock-order cycles (GC06), use-after-donate (GC07),
atomic-protocol writes (GC08), registry drift (GC09), thread lifecycle
(GC10).  Default path: the mxnet_tpu_torch package next to tools/.

options:
  --json                 machine-readable findings on stdout
  --sarif FILE           also write findings as SARIF 2.1.0 ('-' = stdout)
  --list-rules           print the rule table and exit
  --select RULES         run only these comma-separated rules
  --ignore RULES         skip these comma-separated rules
  --stats                per-rule timing/findings table on stderr
  --baseline FILE        ignore findings recorded in FILE (diff mode)
  --write-baseline FILE  write current findings to FILE and exit 0
  --write-lock-baseline FILE
                         write the GC06 lock-order edge set to FILE
                         (the committed graftcheck-torch-lockorder.json)
  -q, --quiet            suppress the summary line
"""


def main(argv=None, repo_root=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    as_json = quiet = want_stats = False
    baseline_path = write_baseline_path = None
    sarif_path = lock_baseline_path = None
    select = ignore = None
    paths = []
    i = 0

    def _arg(flag):
        nonlocal i
        i += 1
        if i >= len(argv):
            print(f"{flag} needs an argument", file=sys.stderr)
            return None
        return argv[i]

    while i < len(argv):
        a = argv[i]
        if a in ("-h", "--help"):
            print(_USAGE)
            return 0
        if a == "--json":
            as_json = True
        elif a in ("-q", "--quiet"):
            quiet = True
        elif a == "--stats":
            want_stats = True
        elif a == "--list-rules":
            for p in PASSES:
                print(f"{p.rule}  {p.summary}")
            return 0
        elif a == "--baseline":
            baseline_path = _arg(a)
            if baseline_path is None:
                return 2
        elif a == "--write-baseline":
            write_baseline_path = _arg(a)
            if write_baseline_path is None:
                return 2
        elif a == "--write-lock-baseline":
            lock_baseline_path = _arg(a)
            if lock_baseline_path is None:
                return 2
        elif a == "--sarif":
            sarif_path = _arg(a)
            if sarif_path is None:
                return 2
        elif a == "--select":
            v = _arg(a)
            if v is None:
                return 2
            select = [r.strip() for r in v.split(",") if r.strip()]
        elif a == "--ignore":
            v = _arg(a)
            if v is None:
                return 2
            ignore = [r.strip() for r in v.split(",") if r.strip()]
        elif a.startswith("-"):
            print(f"unknown option {a!r}\n{_USAGE}", file=sys.stderr)
            return 2
        else:
            paths.append(a)
        i += 1

    if repo_root is None:
        repo_root = os.getcwd()
    if not paths:
        default = os.path.join(repo_root, PACKAGE)
        if not os.path.isdir(default):
            print(f"no paths given and no ./{PACKAGE} found",
                  file=sys.stderr)
            return 2
        paths = [default]
    for p in paths:
        if not os.path.exists(p):
            print(f"no such path: {p}", file=sys.stderr)
            return 2

    stats = {} if want_stats else None
    try:
        ctx, errors = build_context(paths, repo_root=repo_root)
        if lock_baseline_path:
            gc06 = next((p for p in PASSES if p.rule == "GC06"), None)
            if gc06 is None or not hasattr(gc06, "write_lock_baseline"):
                print("GC06 lock-order pass is not registered",
                      file=sys.stderr)
                return 2
            n = gc06.write_lock_baseline(lock_baseline_path, ctx)
            if not quiet:
                print(f"wrote {n} lock-order edge(s) to "
                      f"{lock_baseline_path}")
            return 0
        findings, suppressed, modules = analyze_context(
            ctx, errors, select=select, ignore=ignore, stats=stats)
    except Exception as e:  # noqa: BLE001 — CLI boundary
        print(f"graftcheck internal error: {type(e).__name__}: {e}",
              file=sys.stderr)
        return 2

    if want_stats:
        total = sum(s["seconds"] for s in stats.values())
        print(f"{'rule':<6} {'seconds':>8} {'findings':>9}",
              file=sys.stderr)
        for rule in sorted(stats):
            s = stats[rule]
            print(f"{rule:<6} {s['seconds']:>8.3f} {s['findings']:>9}",
                  file=sys.stderr)
        print(f"{'total':<6} {total:>8.3f}", file=sys.stderr)

    if write_baseline_path:
        write_baseline(write_baseline_path, findings)
        if not quiet:
            print(f"wrote {len(findings)} finding(s) to "
                  f"{write_baseline_path}")
        return 0

    if baseline_path:
        try:
            base = load_baseline(baseline_path)
        except (OSError, ValueError, KeyError) as e:
            print(f"cannot read baseline {baseline_path}: {e}",
                  file=sys.stderr)
            return 2
        remaining, kept = dict(base), []
        for f in findings:
            k = (f.rule, f.path, f.fingerprint)
            if remaining.get(k):
                remaining[k] -= 1  # each entry excuses ONE occurrence
            else:
                kept.append(f)
        findings = kept

    if sarif_path:
        passes = _selected_passes(select, ignore)
        doc = to_sarif(findings, passes)
        if sarif_path == "-":
            print(json.dumps(doc, indent=2, sort_keys=True))
        else:
            with open(sarif_path, "w", encoding="utf-8") as f:
                json.dump(doc, f, indent=2, sort_keys=True)
                f.write("\n")

    if as_json:
        print(json.dumps({
            "findings": [f.to_dict() for f in findings],
            "suppressed": len(suppressed),
            "files": len(modules),
        }, indent=2, sort_keys=True))
    else:
        for f in findings:
            print(f.render())
        if not quiet:
            print(f"graftcheck: {len(findings)} finding(s), "
                  f"{len(suppressed)} suppressed, {len(modules)} file(s)"
                  + (" [vs baseline]" if baseline_path else ""))
    return 1 if findings else 0
