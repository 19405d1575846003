"""graftcheck rules GC08/GC09 — cross-process protocol discipline; the
port's copy of ``mxnet_tpu/analysis/passes/protocol.py``.

- **GC08 atomic-protocol writes**: the modules hand-roll the same
  write-temp-then-``os.replace`` idiom because another *process* reads
  the file while it is being written (the controller reads heartbeats
  mid-beat, routers read port files mid-publish, the perf gate reads
  telemetry shards mid-export).  A direct ``open(path, 'w')`` against
  one of these protocol files can be observed torn — half a JSON object —
  and every reader's "torn = absent" recovery story silently degrades
  into "torn = crash".  The registry of protocol file tokens is
  committed here (:data:`PROTOCOL_TOKENS`); any write-mode open whose
  resolved path carries one must have an ``os.replace`` reachable from
  the same function (directly or through its callees).
- **GC09 registry drift**: string registries rot without a checker.
  Every ``chaos.hit(site)`` literal must exist in the committed
  ``chaos.SITES`` tuple *and* be armed by at least one of the port's
  tests (``tests/test_torch_*.py``; an injection site no test fires is
  dead coverage).  Every metric name handed to the telemetry factories
  must follow the ``mxnet_*_{total,seconds,bytes,tokens}`` convention and
  appear in the metric catalog of the port's README section, so
  dashboards never chase a renamed series.
"""

from __future__ import annotations

import ast
import os
import re

from ..core import (Pass, call_leaf, dotted_chain, readme_section,
                    register_pass)

# --------------------------------------------------------------------------
# GC08 — atomic-protocol write discipline
# --------------------------------------------------------------------------

# The committed registry of the port's cross-process protocol file tokens
# (``controller.json`` stays listed for ElasticController, ROADMAP A.9): a
# write-open whose path expression resolves to a string literal
# *containing* a token is a protocol write.  Containment is one-directional on purpose —
# matching literal-inside-token too would let a one-character f-string
# fragment like "-" claim every entry here.
PROTOCOL_TOKENS = {
    "router.json": "serving router journal (Router._save_state, read by "
                   "_recover and operators mid-run)",
    "controller.json": "elastic controller state (Controller._save_state, "
                       "read by auto_resume and status tooling mid-run)",
    "manifest.json": "checkpoint manifest (checkpoint.save, read by the "
                     "controller's regrow watcher mid-save)",
    "hb-rank": "heartbeat records (heartbeat.beat, read by the "
               "controller's hang detector several times a second)",
    "replica-": "replica port files (replica.bind, read by the router's "
                "connect/respawn path)",
    "telemetry-": "telemetry snapshot shards (aggregate.export_snapshot, "
                  "read by the controller roll-up and perf gate)",
}

_WRITE_MODE_RE = re.compile(r"[wx]")


def _is_protocol_token(tok):
    return any(p in tok for p in PROTOCOL_TOKENS)


@register_pass
class AtomicProtocolPass(Pass):
    rule = "GC08"
    summary = ("atomic-protocol discipline: writes to cross-process "
               "protocol files (router.json, controller.json, "
               "manifest.json, heartbeats, port files, telemetry shards) "
               "must flow through write-temp-then-os.replace; a direct "
               "open(path, 'w') can be read torn")

    def check_project(self, ctx):
        idx = ctx.index
        out = []
        for m in ctx.modules:
            for fi in sorted(idx.functions_in(m), key=lambda f: f.qual):
                s = idx.summary(fi)
                protocol_writes = []
                for mode, call, line in s.opens:
                    if not _WRITE_MODE_RE.search(mode):
                        continue   # reads and append-only logs are fine
                    toks = idx.expr_tokens(fi, call.args[0])
                    hits = sorted(t for t in toks if _is_protocol_token(t))
                    if hits:
                        protocol_writes.append((call, line, hits))
                if not protocol_writes:
                    continue
                if self._replace_reachable(idx, fi):
                    continue   # the function implements the atomic idiom
                for call, line, hits in protocol_writes:
                    tok = next(p for p in PROTOCOL_TOKENS
                               if any(p in t for t in hits))
                    out.append(m.finding(
                        self.rule, line,
                        f"direct write to protocol file ({hits[0]!r}: "
                        f"{PROTOCOL_TOKENS[tok]}) with no os.replace "
                        "reachable from this function — a concurrent "
                        "reader can observe a torn file; write to a tmp "
                        "path and os.replace() it into place"))
        return out

    @staticmethod
    def _replace_reachable(idx, fi, _depth=0, _seen=None):
        """True when an ``os.replace``/``os.rename`` is reachable from
        ``fi`` through resolvable calls (3 hops)."""
        if _seen is None:
            _seen = set()
        if fi.key in _seen or _depth > 3:
            return False
        _seen.add(fi.key)
        s = idx.summary(fi)
        if s.replaces:
            return True
        for call in s.calls:
            g = idx.resolve_call(fi.module, fi, call)
            if g is not None and AtomicProtocolPass._replace_reachable(
                    idx, g, _depth + 1, _seen):
                return True
        return False


# --------------------------------------------------------------------------
# GC09 — registry drift (chaos sites, metric names)
# --------------------------------------------------------------------------

_CHAOS_MODULE = "resilience/chaos.py"
# the port's tests: a chaos site counts as armed when one of these names it
TESTS_PREFIX = "test_torch_"
_METRIC_FACTORIES = {"counter": "_total",
                     "gauge": None,
                     "histogram": ("_seconds", "_bytes", "_tokens")}
_METRIC_NAME_RE = re.compile(r"^mxnet_[a-z0-9_]+$")


def _sites_registry(chaos_module):
    """{site: lineno} parsed from the module-level SITES tuple."""
    for node in chaos_module.tree.body:
        if (isinstance(node, ast.Assign) and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)
                and node.targets[0].id == "SITES"
                and isinstance(node.value, (ast.Tuple, ast.List))):
            return {e.value: e.lineno for e in node.value.elts
                    if isinstance(e, ast.Constant)
                    and isinstance(e.value, str)}
    return None


@register_pass
class RegistryDriftPass(Pass):
    rule = "GC09"
    summary = ("registry drift: chaos.hit sites must exist in chaos.SITES "
               "and be armed by a test; metric names must match "
               "mxnet_*_{total,seconds,bytes,tokens} and appear in the "
               "README exposition docs")

    def check_project(self, ctx):
        out = []
        out.extend(self._check_chaos(ctx))
        out.extend(self._check_metrics(ctx))
        return out

    # -- chaos sites ----------------------------------------------------------

    def _check_chaos(self, ctx):
        chaos = ctx.module(_CHAOS_MODULE)
        if chaos is None:
            return []
        sites = _sites_registry(chaos)
        if sites is None:
            if not ctx.repo_root:
                return []   # synthetic check_source module, not the tree
            return [chaos.finding(
                self.rule, 1,
                "chaos module has no parseable module-level SITES tuple — "
                "the injection-site registry must stay statically "
                "checkable")]
        idx = ctx.index
        out = []
        for m in ctx.modules:
            imports = idx.mod_imports.get(m.rel, {})
            for node in ast.walk(m.tree):
                if not (isinstance(node, ast.Call)
                        and call_leaf(node) == "hit" and node.args):
                    continue
                recv = (dotted_chain(node.func.value)
                        if isinstance(node.func, ast.Attribute) else None)
                is_chaos = (
                    m.rel == _CHAOS_MODULE
                    or (recv is not None and imports.get("modules", {})
                        .get(recv) == _CHAOS_MODULE)
                    or (recv is None and imports.get("symbols", {})
                        .get("hit", (None,))[0] == _CHAOS_MODULE))
                if not is_chaos:
                    continue
                arg = node.args[0]
                if not (isinstance(arg, ast.Constant)
                        and isinstance(arg.value, str)):
                    out.append(m.finding(
                        self.rule, node,
                        "chaos.hit() with a non-literal site — sites must "
                        "be string literals so the registry stays "
                        "statically checkable"))
                    continue
                if arg.value not in sites:
                    out.append(m.finding(
                        self.rule, node,
                        f"chaos.hit site {arg.value!r} is not in the "
                        "committed chaos.SITES registry — register it "
                        "(and arm it in a test) or fix the typo"))
        # every registered site must be armed by at least one test
        tests_dir = (os.path.join(ctx.repo_root, "tests")
                     if ctx.repo_root else None)
        if tests_dir and os.path.isdir(tests_dir):
            blob = []
            for fn in sorted(os.listdir(tests_dir)):
                if fn.startswith(TESTS_PREFIX) and fn.endswith(".py"):
                    try:
                        with open(os.path.join(tests_dir, fn),
                                  encoding="utf-8") as f:
                            blob.append(f.read())
                    except OSError:
                        pass
            blob = "\n".join(blob)
            for site, lineno in sorted(sites.items()):
                if site not in blob:
                    out.append(chaos.finding(
                        self.rule, lineno,
                        f"chaos site {site!r} is registered but no test "
                        "references it — dead injection coverage; arm it "
                        "in a test or retire the site"))
        return out

    # -- metric names -----------------------------------------------------------

    def _check_metrics(self, ctx):
        out = []
        readme = readme_section(ctx) if ctx.repo_root else None
        for m in ctx.modules:
            if m.rel.startswith("analysis/"):
                continue
            for node in ast.walk(m.tree):
                if not (isinstance(node, ast.Call) and node.args
                        and isinstance(node.args[0], ast.Constant)
                        and isinstance(node.args[0].value, str)):
                    continue
                kind = call_leaf(node)
                if kind not in _METRIC_FACTORIES:
                    continue
                name = node.args[0].value
                if not name.startswith("mxnet_"):
                    continue   # not a telemetry metric registration
                if not _METRIC_NAME_RE.match(name):
                    out.append(m.finding(
                        self.rule, node,
                        f"metric name {name!r} breaks the "
                        "mxnet_[a-z0-9_]+ convention"))
                    continue
                suffix = _METRIC_FACTORIES[kind]
                if kind == "counter" and not name.endswith("_total"):
                    out.append(m.finding(
                        self.rule, node,
                        f"counter {name!r} must end in '_total' "
                        "(prometheus counter convention)"))
                elif kind == "histogram" and not name.endswith(suffix):
                    out.append(m.finding(
                        self.rule, node,
                        f"histogram {name!r} must end in one of "
                        f"{'/'.join(suffix)} (unit-suffix convention)"))
                elif kind == "gauge" and name.endswith("_total"):
                    # _seconds is a fine gauge unit suffix (ages, budgets
                    # — cf. prometheus' own process_start_time_seconds);
                    # _total is a counter contract and nothing else.
                    out.append(m.finding(
                        self.rule, node,
                        f"gauge {name!r} ends in '_total' — that suffix "
                        "promises a monotone counter; rename or use a "
                        "counter"))
                elif readme is not None and name not in readme:
                    out.append(m.finding(
                        self.rule, node,
                        f"metric {name!r} is exported but undocumented — "
                        "add it to the README metrics exposition table"))
        return out
