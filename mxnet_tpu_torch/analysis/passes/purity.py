"""graftcheck rules GC01–GC05 — purity, re-capture, knob, lock, flag.

The port's copy of ``mxnet_tpu/analysis/passes/purity.py``.  Each pass
encodes an invariant the runtime subsystems (telemetry, gradient fusion,
resilience, the captured step) depend on but nothing else enforces:

- **GC01 host-sync**: the dispatch/fusion hot path must not silently sync
  device → host.  Flags the reference's spellings (``.item()`` /
  ``.asnumpy()`` / ``.block_until_ready()`` / ``waitall()`` /
  ``jax.device_get``) and torch's (``.tolist()``, ``.cpu()``,
  ``.numpy()``, ``.asscalar()``, ``torch.cuda.synchronize()`` and
  ``.synchronize()`` on a stream or event) anywhere in a designated
  hot-path function, and ``float()/int()/bool()/len()`` /
  ``np.asarray`` applied to a device value (tracked by a small local
  dataflow over ``._data`` / ``._tensor`` / ``jnp.*`` / ``torch.*`` /
  ``F.*`` producers).
- **GC02 re-capture hazard**: a body that is cached per signature — a
  function handed to ``jax.jit``, ``torch.cuda.make_graphed_callables``,
  ``torch.compile`` or ``torch.jit``, or called inside a
  ``torch.cuda.graph`` capture — must not close over mutable state
  (``self``, rebindable module globals, reassigned enclosing locals):
  the value at capture time is baked into every replay.  A graph built
  and replayed inside one call (or a wrapper built and invoked in one
  expression) is rebuilt per call.  Mutable-literal defaults and untyped
  ``**kwargs`` reaching a trace are the quiet version of the same bug.
- **GC03 knob-hygiene**: every ``MXNET_*`` env read outside ``config.py``
  is ungoverned (no default, no type, no docs); every knob registered in
  ``config.KNOWN_VARS`` must appear in the knob table of the port's
  README section.
- **GC04 lock-discipline**: in the threaded modules, an attribute or
  module global written under ``with <lock>`` in one function and
  written lock-free in another is a data race waiting for a scheduler.
- **GC05 telemetry-flag discipline**: hot-path functions read the
  telemetry-enabled flag at most once (snapshot it; re-reads both waste
  cycles and can observe a mid-call flip, tearing paired begin/end
  instrumentation).
"""

from __future__ import annotations

import ast
import symtable

from ..core import Pass, readme_section, register_pass
from ._scopes import (FLAG_DISCIPLINE_MODULES, HOT_PATHS,  # noqa: F401
                      _dotted, _hot_functions, _is_threaded, _walk_shallow)

# --------------------------------------------------------------------------
# GC01 — host-sync on the hot path
# --------------------------------------------------------------------------

_SYNC_METHODS = {"item", "asnumpy", "block_until_ready",
                 # torch's: a copy to the host, or a wait on the card
                 "tolist", "cpu", "numpy", "asscalar", "synchronize"}
_SYNC_CALLS = {"jax.device_get", "jax.block_until_ready",
               "torch.cuda.synchronize"}
_NUMPY_ROOTS = {"np", "_np", "numpy", "onp"}
_JAX_PRODUCER_ROOTS = {"jnp", "lax"}
_TORCH_PRODUCER_ROOTS = {"torch", "F"}
# torch namespaces whose calls answer on the host (no device tensor)
_TORCH_HOST_PREFIXES = ("torch.cuda.", "torch.backends.",
                        "torch.distributed.", "torch.finfo", "torch.iinfo",
                        "torch.Size", "torch.device", "torch.is_tensor",
                        "torch.is_grad_enabled", "torch.get_default_dtype")
# tensor methods that read metadata the host already holds
_HOST_METHODS = {"size", "dim", "numel", "element_size", "data_ptr",
                 "stride", "is_contiguous", "get_device", "nelement"}
_CAST_BUILTINS = {"float", "int", "bool", "len"}


def _expr_arrayish(expr, names):
    """Syntactic 'holds a device (jax/traced or torch) array' judgment."""
    if isinstance(expr, ast.Name):
        return expr.id in names
    if isinstance(expr, ast.Attribute):
        if expr.attr in ("_data", "_grad", "_tensor"):
            return True
        return False
    if isinstance(expr, ast.Subscript):
        return _expr_arrayish(expr.value, names)
    if isinstance(expr, ast.BinOp):
        return (_expr_arrayish(expr.left, names)
                or _expr_arrayish(expr.right, names))
    if isinstance(expr, ast.UnaryOp):
        return _expr_arrayish(expr.operand, names)
    if isinstance(expr, ast.Call):
        d = _dotted(expr.func)
        if d:
            root = d.split(".")[0]
            if root in _JAX_PRODUCER_ROOTS:
                return True
            if root == "jax" and d not in ("jax.jit",):
                return True
            if root in _TORCH_PRODUCER_ROOTS and "." in d \
                    and not d.startswith(_TORCH_HOST_PREFIXES):
                return True
            if d == "tree_sum" or d.endswith(".tree_sum"):
                return True
        # method on an arrayish object returns arrayish (e.g. x.reshape),
        # but torch's metadata methods answer from the host
        if isinstance(expr.func, ast.Attribute):
            if expr.func.attr in _HOST_METHODS:
                return False
            return _expr_arrayish(expr.func.value, names)
    return False


@register_pass
class HostSyncPass(Pass):
    rule = "GC01"
    summary = ("host-sync on the hot path: .item()/.asnumpy()/waitall()/"
               "device_get, .tolist()/.cpu()/.numpy()/.synchronize(), or "
               "float/int/bool/len/np.asarray on a traced or device value, "
               "inside a designated hot-path function")

    def check_module(self, module, ctx):
        out = []
        for qual, fn in _hot_functions(module):
            out.extend(self._check_function(module, qual, fn))
        return out

    def _check_function(self, module, qual, fn):
        out = []
        nodes = list(_walk_shallow(fn))
        # dataflow to fixpoint: x = <arrayish expr> tags x (iterated so
        # traversal order doesn't matter)
        arrayish = set()
        changed = True
        while changed:
            changed = False
            for node in nodes:
                if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                        and isinstance(node.targets[0], ast.Name) \
                        and node.targets[0].id not in arrayish \
                        and _expr_arrayish(node.value, arrayish):
                    arrayish.add(node.targets[0].id)
                    changed = True
        for node in nodes:
            if not isinstance(node, ast.Call):
                continue
            d = _dotted(node.func)
            if isinstance(node.func, ast.Attribute) \
                    and node.func.attr in _SYNC_METHODS and not node.args \
                    and d not in _SYNC_CALLS:
                out.append(module.finding(
                    self.rule, node,
                    f"host-sync: .{node.func.attr}() in hot path "
                    f"{qual!r} blocks dispatch until the device flushes"))
                continue
            if d in _SYNC_CALLS or (d and d.split(".")[-1] == "waitall"):
                out.append(module.finding(
                    self.rule, node,
                    f"host-sync: {d}() in hot path {qual!r} drains the "
                    "async dispatch queue"))
                continue
            if d and "." in d and d.split(".")[0] in _NUMPY_ROOTS \
                    and d.split(".")[-1] in ("asarray", "array") \
                    and node.args \
                    and _expr_arrayish(node.args[0], arrayish):
                out.append(module.finding(
                    self.rule, node,
                    f"host-sync: {d}() on a traced/jax value in hot path "
                    f"{qual!r} copies device memory to host"))
                continue
            if d in _CAST_BUILTINS and len(node.args) == 1 \
                    and _expr_arrayish(node.args[0], arrayish):
                out.append(module.finding(
                    self.rule, node,
                    f"host-sync: {d}() on a traced/jax value in hot path "
                    f"{qual!r} forces a device->host transfer (and fails "
                    "under trace)"))
        return out


# --------------------------------------------------------------------------
# GC02 — retrace hazards
# --------------------------------------------------------------------------


class _Scope:
    __slots__ = ("node", "parent", "defs", "bindings", "mutated",
                 "globals_declared")

    def __init__(self, node, parent):
        self.node = node
        self.parent = parent
        self.defs = {}          # name -> FunctionDef/Lambda node
        self.bindings = {}      # name -> count of binding sites
        self.mutated = set()    # names target of AugAssign
        self.globals_declared = set()

    def bind(self, name, n=1):
        self.bindings[name] = self.bindings.get(name, 0) + n


def _collect_scopes(tree):
    """Scope table: id(function node) -> _Scope, plus the module scope
    under key None.  Bindings are counted per scope (params, assignments,
    defs, imports); AugAssign marks a name mutated."""
    scopes = {}

    def bind_target(scope, tgt):
        if isinstance(tgt, ast.Name):
            scope.bind(tgt.id)
        elif isinstance(tgt, (ast.Tuple, ast.List)):
            for e in tgt.elts:
                bind_target(scope, e)
        elif isinstance(tgt, ast.Starred):
            bind_target(scope, tgt.value)

    def visit_body(scope, body):
        for node in body:
            visit(scope, node)

    def visit(scope, node):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            scope.defs[node.name] = node
            scope.bind(node.name)
            sub = _Scope(node, scope)
            scopes[id(node)] = sub
            a = node.args
            for p in (a.posonlyargs + a.args + a.kwonlyargs):
                sub.bind(p.arg)
            for p in (a.vararg, a.kwarg):
                if p is not None:
                    sub.bind(p.arg)
            # defaults/decorators evaluate in the parent scope
            for d in list(a.defaults) + [x for x in a.kw_defaults if x] \
                    + list(node.decorator_list):
                visit(scope, d)
            visit_body(sub, node.body)
            return
        if isinstance(node, ast.Lambda):
            sub = _Scope(node, scope)
            scopes[id(node)] = sub
            a = node.args
            for p in (a.posonlyargs + a.args + a.kwonlyargs):
                sub.bind(p.arg)
            for p in (a.vararg, a.kwarg):
                if p is not None:
                    sub.bind(p.arg)
            visit(sub, node.body)
            return
        if isinstance(node, ast.ClassDef):
            scope.bind(node.name)
            # class body binds in its own namespace; methods' enclosing
            # *function* scope chain skips it, so hang methods off the
            # current scope for resolution purposes
            visit_body(scope, node.body)
            return
        if isinstance(node, ast.Assign):
            for t in node.targets:
                bind_target(scope, t)
        elif isinstance(node, ast.AnnAssign) and node.target is not None:
            bind_target(scope, node.target)
        elif isinstance(node, ast.AugAssign):
            if isinstance(node.target, ast.Name):
                scope.bind(node.target.id)
                scope.mutated.add(node.target.id)
        elif isinstance(node, ast.NamedExpr):
            bind_target(scope, node.target)
        elif isinstance(node, (ast.For, ast.AsyncFor)):
            bind_target(scope, node.target)
        elif isinstance(node, (ast.Import, ast.ImportFrom)):
            for alias in node.names:
                scope.bind((alias.asname or alias.name).split(".")[0])
        elif isinstance(node, ast.Global):
            scope.globals_declared.update(node.names)
        elif isinstance(node, ast.ExceptHandler) and node.name:
            scope.bind(node.name)
        elif isinstance(node, (ast.With, ast.AsyncWith)):
            for item in node.items:
                if item.optional_vars is not None:
                    bind_target(scope, item.optional_vars)
        for child in ast.iter_child_nodes(node):
            visit(scope, child)

    mod = _Scope(None, None)
    scopes[None] = mod
    visit_body(mod, tree.body)
    return scopes


def _mutable_globals(scopes):
    """Module-level names that are rebound after their first binding:
    assigned ≥2 times at module scope, augmented, or assigned inside any
    function that declares them ``global``."""
    mod = scopes[None]
    out = {n for n, c in mod.bindings.items() if c >= 2}
    out |= mod.mutated
    for s in scopes.values():
        if s is mod or s is None:
            continue
        for n in s.globals_declared:
            if s.bindings.get(n):
                out.add(n)
    return out


def _symtable_index(text, path):
    """(name, lineno) -> symtable entry for every function scope; None on
    any symtable failure (the pass then skips free/global analysis)."""
    try:
        top = symtable.symtable(text, path, "exec")
    except (SyntaxError, ValueError):
        return None
    index = {}

    def walk(tb):
        for child in tb.get_children():
            if child.get_type() == "function":
                index.setdefault((child.get_name(), child.get_lineno()),
                                 child)
            walk(child)

    walk(top)
    return index


_JIT_SAFE_KWARGS = {
    "static_argnums", "static_argnames", "donate_argnums", "donate_argnames",
    "in_shardings", "out_shardings", "device", "backend", "keep_unused",
    "inline", "abstracted_axes",
}

# wrappers that trace a function once and reuse what they built: jax's
# jit, and torch's CUDA-graph capture and compilers
_JAX_JITS = ("jax.jit", "jit", "pjit", "jax.pjit")
_TORCH_CAPTURES = ("torch.cuda.make_graphed_callables",
                   "make_graphed_callables", "torch.compile",
                   "torch.jit.script", "torch.jit.trace")
_GRAPH_CONTEXTS = ("torch.cuda.graph",)
_GRAPH_CTORS = ("torch.cuda.CUDAGraph", "CUDAGraph")
# what a graph may do without leaving the call that built it
_GRAPH_LOCAL_METHODS = {"replay", "capture_begin", "capture_end", "reset",
                        "pool", "enable_debug_mode", "debug_dump"}

# the findings' wording: jax's executables are traced and jitted, torch's
# graphs captured and replayed
_MSG = {
    "jax": {
        "per_call": "jax.jit(...) built and invoked in one expression — the "
                    "executable is rebuilt (and retraced) on every call; "
                    "cache it keyed on shape/dtype/static attrs",
        "default": "jitted function has a mutable-literal default — its "
                   "contents are baked into the first trace and never "
                   "revalidated; freeze it into the jit cache key instead",
        "kwargs": "jitted function takes **kwargs with no "
                  "static_argnames/static_argnums — non-array kwargs bypass "
                  "_freeze and either retrace per value or fail to hash",
        "self": "jitted closure captures {name!r} — instance state read at "
                "trace time is baked into the cached executable and goes "
                "stale silently",
        "local": "jitted closure captures {name!r}, which is reassigned in "
                 "the enclosing scope — the trace keeps the value from "
                 "trace time, not call time; pass it as an argument or bind "
                 "it as a default",
        "global": "jitted closure reads module global {name!r}, which is "
                  "rebound elsewhere — the cached trace freezes one value "
                  "forever; thread it through arguments or the cache key",
    },
    "torch": {
        "per_call": "{what}(...) built and invoked in one expression — the "
                    "graph is captured again on every call; cache it keyed "
                    "on the signature",
        "default": "captured function has a mutable-literal default — its "
                   "contents are baked into the capture and never "
                   "revalidated; key the cache on it instead",
        "kwargs": "captured function takes **kwargs — non-tensor kwargs are "
                  "frozen into the capture or captured again per value; "
                  "pass tensors or key the cache on them",
        "self": "captured closure captures {name!r} — instance state read "
                "at capture time is baked into every replay and goes stale "
                "silently",
        "local": "captured closure captures {name!r}, which is reassigned "
                 "in the enclosing scope — every replay keeps the value "
                 "from capture time, not call time; pass it as an argument "
                 "or bind it as a default",
        "global": "captured closure reads module global {name!r}, which is "
                  "rebound elsewhere — the capture freezes one value "
                  "forever; thread it through arguments or the cache key",
        "graph": "CUDA graph {name!r} is built and replayed inside one call "
                 "— it is captured again on every call; cache it keyed on "
                 "the signature",
    },
}


@register_pass
class RetraceHazardPass(Pass):
    rule = "GC02"
    summary = ("re-capture hazard: a jitted or captured closure captures "
               "mutable state (self / rebindable global / reassigned "
               "local), a jit or CUDA graph built per call, mutable-literal "
               "defaults, or **kwargs reaching a trace without "
               "static_argnames/_freeze")

    def check_module(self, module, ctx):
        scopes = _collect_scopes(module.tree)
        mutable_globals = _mutable_globals(scopes)
        st_index = _symtable_index(module.text, module.path)
        out = []

        def resolve(name, scope):
            s = scope
            while s is not None:
                if name in s.defs:
                    return s.defs[name], s
                s = s.parent
            return None, None

        def walk(node, scope, captured):
            for child in ast.iter_child_nodes(node):
                sub = scopes.get(id(child))
                inner = captured
                if isinstance(child, (ast.With, ast.AsyncWith)) and any(
                        isinstance(it.context_expr, ast.Call)
                        and _dotted(it.context_expr.func) in _GRAPH_CONTEXTS
                        for it in child.items):
                    inner = True
                elif sub is not None:
                    inner = False       # a nested def runs when called
                if isinstance(child, ast.Call):
                    self._check_call(module, child, scope, scopes,
                                     mutable_globals, st_index, resolve,
                                     out, captured)
                walk(child, sub if sub is not None else scope, inner)

        walk(module.tree, scopes[None], False)
        self._check_graphs(module, out)
        return out

    @staticmethod
    def _kind(func):
        """'jax' or 'torch' when ``func`` names a tracing wrapper."""
        d = _dotted(func)
        if d in _JAX_JITS:
            return "jax"
        if d in _TORCH_CAPTURES:
            return "torch"
        return None

    @classmethod
    def _is_jit(cls, func):
        return cls._kind(func) is not None

    def _check_call(self, module, call, scope, scopes, mutable_globals,
                    st_index, resolve, out, captured=False):
        # jax.jit(f)(...) — a fresh compile every execution
        if isinstance(call.func, ast.Call) and self._is_jit(call.func.func):
            kind = self._kind(call.func.func)
            out.append(module.finding(
                self.rule, call, _MSG[kind]["per_call"].format(
                    what=_dotted(call.func.func.func
                                 if isinstance(call.func.func, ast.Call)
                                 else call.func.func))))
            return
        kind = self._kind(call.func)
        target = call.args[0] if call.args else None
        if kind is None:
            # a function called inside a torch.cuda.graph capture is the
            # captured body
            if not captured or not isinstance(call.func, ast.Name):
                return
            kind, target = "torch", call.func
        fnode = None
        if isinstance(target, ast.Lambda):
            fnode = target
        elif isinstance(target, ast.Name):
            fnode, _def_scope = resolve(target.id, scope)
        if fnode is None:
            return  # call-expression target: not statically resolvable
        msg = _MSG[kind]

        # (c) mutable-literal defaults are baked into the trace object
        # identity — they bypass any _freeze()-style cache key
        if not isinstance(fnode, ast.Lambda) or fnode.args.defaults:
            a = fnode.args
            for dflt in list(a.defaults) + [x for x in a.kw_defaults if x]:
                if isinstance(dflt, (ast.Dict, ast.List, ast.Set,
                                     ast.DictComp, ast.ListComp,
                                     ast.SetComp)):
                    out.append(module.finding(self.rule, call,
                                              msg["default"]))
                    break

        # (d) **kwargs reaching the trace untyped
        if getattr(fnode.args, "kwarg", None) is not None:
            kw_names = {k.arg for k in call.keywords}
            if kind == "torch" or not (
                    kw_names & {"static_argnames", "static_argnums"}):
                out.append(module.finding(self.rule, call, msg["kwargs"]))

        # (a)/(b) closure captures
        fscope = scopes.get(id(fnode))
        st = None
        if st_index is not None and not isinstance(fnode, ast.Lambda):
            st = st_index.get((fnode.name, fnode.lineno))
        if st is not None:
            frees = set(st.get_frees())
            globs = set(st.get_globals())
        else:
            frees, globs = self._approx_names(fnode, fscope)
        for name in sorted(frees):
            if name in ("self", "cls"):
                out.append(module.finding(
                    self.rule, call, msg["self"].format(name=name)))
                continue
            bscope = fscope.parent if fscope else None
            while bscope is not None and not bscope.bindings.get(name):
                bscope = bscope.parent
            if bscope is not None and (
                    bscope.bindings.get(name, 0) >= 2
                    or name in bscope.mutated):
                out.append(module.finding(
                    self.rule, call, msg["local"].format(name=name)))
        for name in sorted(globs):
            if name in mutable_globals:
                out.append(module.finding(
                    self.rule, call, msg["global"].format(name=name)))

    def _check_graphs(self, module, out):
        """A ``torch.cuda.CUDAGraph()`` bound to a local that is replayed
        in the same function and never leaves it (not returned, stored,
        or handed to another call) is captured again on every call."""
        for fn in ast.walk(module.tree):
            if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            own = list(_walk_shallow(fn))
            graphs = {}
            for n in own:
                if isinstance(n, ast.Assign) and len(n.targets) == 1 \
                        and isinstance(n.targets[0], ast.Name) \
                        and isinstance(n.value, ast.Call) \
                        and _dotted(n.value.func) in _GRAPH_CTORS:
                    graphs.setdefault(n.targets[0].id, n)
            for name, node in graphs.items():
                local_use = set()
                replayed = False
                for n in own:
                    if isinstance(n, ast.Attribute) \
                            and isinstance(n.value, ast.Name) \
                            and n.value.id == name \
                            and n.attr in _GRAPH_LOCAL_METHODS:
                        local_use.add(id(n.value))
                        replayed = replayed or n.attr == "replay"
                    elif isinstance(n, ast.Call) \
                            and _dotted(n.func) in _GRAPH_CONTEXTS \
                            and n.args and isinstance(n.args[0], ast.Name) \
                            and n.args[0].id == name:
                        local_use.add(id(n.args[0]))
                escapes = any(
                    isinstance(n, ast.Name) and n.id == name
                    and isinstance(n.ctx, ast.Load)
                    and id(n) not in local_use for n in own)
                if replayed and not escapes:
                    out.append(module.finding(
                        self.rule, node,
                        _MSG["torch"]["graph"].format(name=name)))

    @staticmethod
    def _approx_names(fnode, fscope):
        """Fallback free/global split when symtable indexing failed: every
        Load of a name not bound locally, attributed to 'free' if an
        enclosing function scope binds it, else 'global'."""
        loads = {n.id for n in ast.walk(fnode)
                 if isinstance(n, ast.Name) and isinstance(n.ctx, ast.Load)}
        local = set(fscope.bindings) if fscope else set()
        frees, globs = set(), set()
        for name in loads - local:
            s = fscope.parent if fscope else None
            hit = False
            while s is not None and s.node is not None:
                if s.bindings.get(name):
                    hit = True
                    break
                s = s.parent
            (frees if hit else globs).add(name)
        return frees, globs


# --------------------------------------------------------------------------
# GC03 — env-knob hygiene
# --------------------------------------------------------------------------


@register_pass
class KnobHygienePass(Pass):
    rule = "GC03"
    summary = ("knob hygiene: MXNET_* env reads outside config.py; knobs "
               "registered in config.KNOWN_VARS but missing from the "
               "README knob table")

    def check_module(self, module, ctx):
        if module.rel == "config.py":
            return []
        out = []
        for node in ast.walk(module.tree):
            knob, how = self._env_read(node)
            if knob and knob.startswith("MXNET_"):
                out.append(module.finding(
                    self.rule, node,
                    f"ungoverned env read {how}({knob!r}) — route it "
                    "through mxnet_tpu_torch.config (register the knob in "
                    "KNOWN_VARS so it is typed, defaulted, and "
                    "documented)"))
        return out

    @staticmethod
    def _env_read(node):
        """(knob, 'os.environ.get'|...) when node reads a string-literal
        env var, else (None, None)."""
        def lit(e):
            if isinstance(e, ast.Constant) and isinstance(e.value, str):
                return e.value
            # computed names ("MXNET_X" if cond else "MXNET_Y",
            # "MXNET_" + suffix, f-strings): any embedded MXNET_* literal
            # marks the read as knob-shaped
            for sub in ast.walk(e):
                if isinstance(sub, ast.Constant) \
                        and isinstance(sub.value, str) \
                        and sub.value.startswith("MXNET_"):
                    return sub.value
            return None

        if isinstance(node, ast.Subscript):
            d = _dotted(node.value)
            if d and d.split(".")[-1] == "environ":
                return lit(node.slice), d + "[...]"
        if isinstance(node, ast.Call):
            d = _dotted(node.func)
            if not d:
                return None, None
            leaf = d.split(".")[-1]
            if leaf == "getenv" and node.args:
                return lit(node.args[0]), d
            if leaf in ("get", "setdefault", "pop") \
                    and isinstance(node.func, ast.Attribute):
                base = _dotted(node.func.value)
                if base and base.split(".")[-1] == "environ" and node.args:
                    return lit(node.args[0]), d
        return None, None

    def check_project(self, ctx):
        cfg = ctx.module("config.py")
        if cfg is None:
            return []
        readme = readme_section(ctx)
        if readme is None:
            return []
        out = []
        for name, lineno in self._known_vars(cfg.tree):
            if name not in readme:
                out.append(cfg.finding(
                    self.rule, lineno,
                    f"knob {name} is registered in config.KNOWN_VARS but "
                    "undocumented — add it to the README env-knob table"))
        return out

    @staticmethod
    def _known_vars(tree):
        for node in tree.body:
            if isinstance(node, ast.Assign) \
                    and any(isinstance(t, ast.Name) and t.id == "KNOWN_VARS"
                            for t in node.targets) \
                    and isinstance(node.value, ast.Dict):
                for k in node.value.keys:
                    if isinstance(k, ast.Constant) \
                            and isinstance(k.value, str):
                        yield k.value, k.lineno
                return


# --------------------------------------------------------------------------
# GC04 — lock discipline
# --------------------------------------------------------------------------


def _looks_like_lock(expr):
    d = _dotted(expr)
    if not d:
        return False
    leaf = d.split(".")[-1].lower()
    return "lock" in leaf or "mutex" in leaf


@register_pass
class LockDisciplinePass(Pass):
    rule = "GC04"
    summary = ("lock discipline: attribute/global written under a lock in "
               "one function of a threaded module but written lock-free "
               "in another")

    # functions whose writes construct the object / tear it down before or
    # after any concurrent access exists
    _EXEMPT = {"__init__", "__new__", "__init_subclass__"}

    def check_module(self, module, ctx):
        if not _is_threaded(module.rel):
            return []
        module_globals = self._module_level_names(module.tree)
        # key -> list of (funcname, locked, lineno); key is
        # ("self", class, attr) or ("global", name)
        writes = {}

        def record(key, func, locked, lineno):
            writes.setdefault(key, []).append((func, locked, lineno))

        def scan_function(fn, cls, qual):
            declared_global = {
                n for node in ast.walk(fn) if isinstance(node, ast.Global)
                for n in node.names}

            def key_for(target):
                base = target
                while isinstance(base, ast.Subscript):
                    base = base.value
                if isinstance(base, ast.Attribute) \
                        and isinstance(base.value, ast.Name) \
                        and base.value.id == "self":
                    return ("self", cls, base.attr)
                if isinstance(base, ast.Name):
                    if base.id in declared_global \
                            or (isinstance(target, ast.Subscript)
                                and base.id in module_globals):
                        return ("global", base.id)
                if isinstance(base, ast.Attribute) \
                        and isinstance(base.value, ast.Name) \
                        and base.value.id in module_globals \
                        and not isinstance(target, ast.Attribute):
                    # mutation through a module-global container attr
                    return ("global", base.value.id)
                return None

            def visit(node, locked):
                if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                     ast.Lambda)) and node is not fn:
                    return  # nested defs execute later, in their own calls
                if isinstance(node, (ast.With, ast.AsyncWith)):
                    now = locked or any(
                        _looks_like_lock(item.context_expr.func
                                         if isinstance(item.context_expr,
                                                       ast.Call)
                                         else item.context_expr)
                        for item in node.items)
                    for item in node.items:
                        visit(item.context_expr, locked)
                    for st in node.body:
                        visit(st, now)
                    return
                targets = []
                if isinstance(node, ast.Assign):
                    targets = node.targets
                elif isinstance(node, ast.AugAssign):
                    targets = [node.target]
                elif isinstance(node, ast.AnnAssign) \
                        and node.value is not None:
                    targets = [node.target]
                for t in targets:
                    k = key_for(t)
                    if k is not None:
                        record(k, qual, locked, node.lineno)
                for child in ast.iter_child_nodes(node):
                    visit(child, locked)

            visit(fn, False)

        for node in module.tree.body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                if node.name not in self._EXEMPT:
                    scan_function(node, None, node.name)
            elif isinstance(node, ast.ClassDef):
                for sub in node.body:
                    if isinstance(sub, (ast.FunctionDef,
                                        ast.AsyncFunctionDef)) \
                            and sub.name not in self._EXEMPT:
                        scan_function(sub, node.name,
                                      f"{node.name}.{sub.name}")

        out = []
        for key, events in sorted(writes.items(), key=str):
            locked_funcs = {f for f, locked, _ in events if locked}
            if not locked_funcs:
                continue
            what = (f"self.{key[2]} (class {key[1]})" if key[0] == "self"
                    else f"module global {key[1]!r}")
            for func, locked, lineno in events:
                if not locked and func not in locked_funcs:
                    out.append(_mk_gc04(self.rule, key, what, func,
                                        locked_funcs, lineno, module))
        return out

    @staticmethod
    def _module_level_names(tree):
        names = set()
        for node in tree.body:
            if isinstance(node, ast.Assign):
                for t in node.targets:
                    if isinstance(t, ast.Name):
                        names.add(t.id)
            elif isinstance(node, ast.AnnAssign) \
                    and isinstance(node.target, ast.Name):
                names.add(node.target.id)
            elif isinstance(node, (ast.Import, ast.ImportFrom)):
                for alias in node.names:
                    names.add((alias.asname or alias.name).split(".")[0])
        return names


def _mk_gc04(rule, key, what, func, locked_funcs, lineno, module):
    holders = ", ".join(sorted(locked_funcs))
    return module.finding(
        rule, lineno,
        f"lock-free write to {what} in {func!r}, but {holders} write(s) "
        "it under a lock — take the same lock here or document why the "
        "race is benign")


# --------------------------------------------------------------------------
# GC05 — telemetry-flag discipline
# --------------------------------------------------------------------------


@register_pass
class TelemetryFlagPass(Pass):
    rule = "GC05"
    summary = ("telemetry-flag discipline: a hot-path function reads the "
               "telemetry-enabled flag more than once (snapshot it once; "
               "re-reads can observe a mid-call flip and tear paired "
               "instrumentation)")

    def check_module(self, module, ctx):
        if module.rel not in FLAG_DISCIPLINE_MODULES:
            return []
        out = []
        for qual, fn in self._functions(module):
            reads = []
            for node in _walk_shallow(fn):
                if isinstance(node, ast.Attribute) \
                        and node.attr == "_ENABLED" \
                        and isinstance(node.ctx, ast.Load):
                    reads.append(node)
                elif isinstance(node, ast.Name) and node.id == "_ENABLED" \
                        and isinstance(node.ctx, ast.Load):
                    reads.append(node)
                elif isinstance(node, ast.Call):
                    d = _dotted(node.func)
                    if d and d.split(".")[-1] == "enabled":
                        reads.append(node)
            reads.sort(key=lambda n: (n.lineno, n.col_offset))
            if len(reads) >= 2:
                out.append(module.finding(
                    self.rule, reads[1],
                    f"{qual!r} reads the telemetry-enabled flag "
                    f"{len(reads)} times — snapshot it once at entry "
                    "(enabled = tracer._ENABLED) and branch on the local"))
        return out

    @staticmethod
    def _functions(module):
        def walk(node, prefix):
            for child in ast.iter_child_nodes(node):
                if isinstance(child, (ast.FunctionDef,
                                      ast.AsyncFunctionDef)):
                    yield f"{prefix}{child.name}", child
                    # nested defs audited independently
                    yield from walk(child, f"{prefix}{child.name}.")
                elif isinstance(child, ast.ClassDef):
                    yield from walk(child, f"{prefix}{child.name}.")

        yield from walk(module.tree, "")
