"""graftcheck of the port (``mxnet_tpu_torch/analysis``) held to the
reference's (``mxnet_tpu/analysis``).

- Parity: every source fixture of ``tests/test_graftcheck.py`` and
  ``tests/test_graftcheck_v2.py`` (read from those files, not copied) goes
  through both analyzers, which must report the same findings: rule, line,
  path and message (once the package name is normalised), and the same
  number of suppressions.
- The torch spelling of each GC01/GC02 fixture gives the finding its jax
  spelling gives.
- The port's tree is clean under its own analyzer, its lock-order baseline
  is current and every hot-path name exists.
- The CLI: exit codes, baselines, ``--select``/``--ignore``, SARIF,
  ``--stats``, the lock baseline, and the launcher's torch-free import.
- GC09's chaos registry: every site is armed by a test here.
"""

import ast
import json
import os
import subprocess
import sys
import textwrap

import pytest

from mxnet_tpu import analysis as janalysis
from mxnet_tpu_torch import analysis as tanalysis
from mxnet_tpu_torch.analysis import core as tcore
from mxnet_tpu_torch.analysis.passes import _scopes

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "mxnet_tpu_torch")
REF_TEST_FILES = ("test_graftcheck.py", "test_graftcheck_v2.py")


# -- the reference's fixtures, read from its test files --------------------------

def _literal(node, consts):
    """The string an AST expression of a fixture spells: a literal, a
    module constant, ``textwrap.dedent(...)`` of one, or a sum of them."""
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    if isinstance(node, ast.Name) and node.id in consts:
        return consts[node.id]
    if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute) \
            and node.func.attr == "dedent" and len(node.args) == 1:
        inner = _literal(node.args[0], consts)
        return None if inner is None else textwrap.dedent(inner)
    if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Add):
        a, b = _literal(node.left, consts), _literal(node.right, consts)
        return None if a is None or b is None else a + b
    return None


def _reference_fixtures():
    """[(id, {rel: source})]: each ``_check(src, rel=...)`` and
    ``check_sources({...})`` call with literal sources in the reference's
    graftcheck tests."""
    out = []
    for fn in REF_TEST_FILES:
        tree = ast.parse(open(os.path.join(REPO, "tests", fn)).read())
        consts = {}
        for node in tree.body:
            if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Name):
                val = _literal(node.value, consts)
                if val is not None:
                    consts[node.targets[0].id] = val
        for test in tree.body:
            if not (isinstance(test, ast.FunctionDef)
                    and test.name.startswith("test_")):
                continue
            k = 0
            for call in ast.walk(test):
                if not isinstance(call, ast.Call) \
                        or not isinstance(call.func, ast.Name):
                    continue
                sources = None
                if call.func.id in ("_check", "check_source") and call.args:
                    src = _literal(call.args[0], consts)
                    kw = {k_.arg: k_.value for k_ in call.keywords}
                    rel_node = kw.get("rel", call.args[1]
                                      if len(call.args) > 1 else None)
                    rel = _literal(rel_node, consts) if rel_node else None
                    if src is not None and rel is not None:
                        if call.func.id == "_check":
                            src = textwrap.dedent(src)
                        sources = {rel: src}
                elif call.func.id == "check_sources" and call.args \
                        and isinstance(call.args[0], ast.Dict):
                    d = call.args[0]
                    rels = [_literal(x, consts) for x in d.keys]
                    srcs = [_literal(x, consts) for x in d.values]
                    if None not in rels and None not in srcs:
                        sources = dict(zip(rels, srcs))
                if sources is not None:
                    out.append((f"{fn[:-3]}::{test.name}#{k}", sources))
                    k += 1
    return out


FIXTURES = _reference_fixtures()


def _normalised(findings):
    return sorted((f.rule, f.path, f.line,
                   f.message.replace("mxnet_tpu_torch", "mxnet_tpu"))
                  for f in findings)


def test_every_reference_fixture_is_read():
    """The reader sees each test of the reference's two files that checks
    a source snippet (a test that builds a package on disk or drives the
    runtime has no snippet)."""
    tests = {i.split("#")[0] for i, _ in FIXTURES}
    assert len(tests) >= 40, sorted(tests)
    assert len(FIXTURES) >= 50


@pytest.mark.parametrize("fid,sources", FIXTURES, ids=[i for i, _ in FIXTURES])
def test_reference_fixture_same_findings(fid, sources):  # noqa: ARG001
    jf, js = janalysis.check_sources(sources)
    tf, ts = tanalysis.check_sources(sources)
    assert _normalised(tf) == _normalised(jf)
    assert len(ts) == len(js)


# -- torch spellings -------------------------------------------------------------

TORCH_SPELLINGS = {
    "gc01_casts_and_item": ("kvstore/fusion.py", """
        import jax.numpy as jnp

        def reduce_bucket(nds):
            x = jnp.stack(nds)
            total = float(x)
            n = len(x)
            v = x.item()
            return total, n, v
        """, """
        import torch

        def reduce_bucket(nds):
            x = torch.stack(nds)
            total = float(x)
            n = len(x)
            v = x.item()
            return total, n, v
        """),
    "gc01_copies_to_host": ("kvstore/fusion.py", """
        import numpy as np

        def push(value):
            a = value._data
            h = np.asarray(a)
            value.asnumpy()
            jax.device_get(a)
            a.block_until_ready()
            return h
        """, """
        import numpy as np

        def push(value):
            a = value._tensor
            h = np.asarray(a)
            value.tolist()
            a.cpu()
            a.numpy()
            return h
        """),
    "gc01_waits": ("parallel.py", """
        def _step(self, data):
            out = self._graph(data)
            out.block_until_ready()
            nd.waitall()
            return out
        """, """
        def _step(self, data):
            out = self._graph(data)
            torch.cuda.synchronize()
            self._event.synchronize()
            return out
        """),
    "gc01_scalars": ("serving/models.py", """
        def decode(self, x):
            y = jnp.argmax(x)
            return int(y), bool(y > 0), y.asscalar()
        """, """
        def decode(self, x):
            y = F.argmax(x)
            return int(y), bool(y > 0), y.asscalar()
        """),
    "gc02_self_capture": ("anything.py", """
        import jax

        class Runner:
            def build(self, x):
                def raw(a):
                    return a * self.scale
                return jax.jit(raw)
        """, """
        import torch

        class Runner:
            def build(self, x):
                def raw(a):
                    return a * self.scale
                return torch.cuda.make_graphed_callables(raw, (x,))
        """),
    "gc02_global_and_local": ("anything.py", """
        import jax

        _mode = "fast"

        def set_mode(m):
            global _mode
            _mode = m

        def build():
            scale = 1.0
            scale = 2.0

            def raw(x):
                if _mode == "fast":
                    return x * scale
                return x
            return jax.jit(raw)
        """, """
        import torch

        _mode = "fast"

        def set_mode(m):
            global _mode
            _mode = m

        def build():
            scale = 1.0
            scale = 2.0

            def raw(x):
                if _mode == "fast":
                    return x * scale
                return x
            return torch.compile(raw)
        """),
    "gc02_per_call_and_default": ("anything.py", """
        import jax

        def run(x):
            return jax.jit(lambda a: a + 1)(x)

        def build():
            def raw(x, opts={"mode": 1}):
                return x
            return jax.jit(raw)
        """, """
        import torch

        def run(x):
            return torch.compile(lambda a: a + 1)(x)

        def build():
            def raw(x, opts={"mode": 1}):
                return x
            return torch.compile(raw)
        """),
    "gc02_kwargs": ("anything.py", """
        import jax

        def build():
            def raw(x, **attrs):
                return x
            return jax.jit(raw)
        """, """
        import torch

        def build():
            def raw(x, **attrs):
                return x
            return torch.jit.script(raw)
        """),
    "gc02_graph_capture_closure": ("parallel.py", """
        import jax

        class Step:
            def _capture(self, x):
                def body(a):
                    return a * self.lr
                return jax.jit(body)
        """, """
        import torch

        class Step:
            def _capture(self, x):
                def body(a):
                    return a * self.lr
                g = torch.cuda.CUDAGraph()
                with torch.cuda.graph(g):
                    y = body(x)
                return g, y
        """),
}


def _rules_lines(findings):
    return sorted((f.rule, f.line) for f in findings if f.rule != "GC00")


@pytest.mark.parametrize("name", sorted(TORCH_SPELLINGS))
def test_torch_spelling_gives_the_jax_finding(name):
    rel, jax_src, torch_src = TORCH_SPELLINGS[name]
    want, _ = tanalysis.check_source(textwrap.dedent(jax_src), rel=rel)
    got, _ = tanalysis.check_source(textwrap.dedent(torch_src), rel=rel)
    assert _rules_lines(want), name
    if name == "gc02_graph_capture_closure":
        # the captured call sits inside the with-block, not on the jit line
        assert [r for r, _ in _rules_lines(got)] == ["GC02"]
        assert "captured closure captures 'self'" in got[0].message
    else:
        assert _rules_lines(got) == _rules_lines(want)
    # the reference's analyzer sees none of torch's spellings
    ref, _ = janalysis.check_source(textwrap.dedent(torch_src), rel=rel)
    assert len([f for f in ref if f.rule in ("GC01", "GC02")]) \
        < len([f for f in got if f.rule in ("GC01", "GC02")])


def test_gc02_graph_built_and_replayed_per_call():
    per_call, _ = tanalysis.check_source(textwrap.dedent("""
        import torch

        def step(fn, x):
            g = torch.cuda.CUDAGraph()
            with torch.cuda.graph(g):
                y = fn(x)
            g.replay()
            return y
        """), rel="anything.py")
    assert [(f.rule, f.line) for f in per_call] == [("GC02", 5)]
    assert "captured again on every call" in per_call[0].message
    # a graph that leaves the call (returned, stored) is a cache
    kept, _ = tanalysis.check_source(textwrap.dedent("""
        import torch

        class Step:
            def capture(self, fn, x):
                g = torch.cuda.CUDAGraph()
                with torch.cuda.graph(g):
                    y = fn(x)
                self._graphs[x.shape] = g
                g.replay()
                return y

            def build(self, fn, x):
                graph = torch.cuda.CUDAGraph()
                with torch.cuda.graph(graph):
                    y = fn(x)
                return graph, y
        """), rel="anything.py")
    assert kept == []


def test_gc01_host_metadata_and_host_torch_calls_pass():
    findings, _ = tanalysis.check_source(textwrap.dedent("""
        import torch

        def reduce_bucket(nds):
            x = torch.stack(nds)
            n = int(x.size(0)) + x.dim() + x.numel()
            k = int(torch.cuda.device_count())
            return n, k
        """), rel="kvstore/fusion.py")
    assert findings == []


# -- the port's tree -------------------------------------------------------------------

@pytest.fixture(scope="module")
def tree():
    return tanalysis.analyze_paths([PKG], repo_root=REPO)


def test_port_tree_is_clean(tree):
    findings, suppressed, modules = tree
    assert len(modules) > 150
    assert findings == [], "\n".join(f.render() for f in findings)
    # the three engine helpers, the router journal, SparsePS, the
    # TrainStep scalars copy and the serving read-backs
    assert len(suppressed) >= 10
    sites = {(f.path, f.rule) for f in suppressed}
    assert ("mxnet_tpu_torch/serving/engine.py", "GC04") in sites


def test_port_lock_baseline_is_current(tree):
    """graftcheck-torch-lockorder.json matches the tree (GC06 compares
    the two whenever a repo root is given), and it is acyclic."""
    findings, _, _ = tree
    assert [f for f in findings if f.rule == "GC06"] == []
    with open(os.path.join(REPO, "graftcheck-torch-lockorder.json")) as f:
        edges = [(e["from"], e["to"]) for e in json.load(f)["edges"]]
    assert edges and len(edges) == len(set(edges))
    assert not {(b, a) for a, b in edges} & set(edges)


def test_committed_findings_baseline_is_empty():
    with open(os.path.join(REPO, "graftcheck-torch-baseline.json")) as f:
        assert json.load(f)["findings"] == []


def test_hot_paths_name_functions_that_exist():
    for rel, names in _scopes.HOT_PATHS.items():
        path = os.path.join(PKG, rel)
        assert os.path.exists(path), rel
        tree = ast.parse(open(path).read())
        defs = {n.name for n in ast.walk(tree)
                if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))}
        missing = sorted(set(names or ()) - defs)
        assert not missing, (rel, missing)
    for t in _scopes.THREADED_MODULES:
        assert os.path.exists(os.path.join(PKG, t)), t


def test_knob_table_and_metric_catalog_cover_the_port():
    from mxnet_tpu_torch import config
    section = tcore.readme_section(tcore.Context([], repo_root=REPO))
    assert section.startswith(tcore.README_SECTION)
    assert "## Observability" not in section
    for name in config.KNOWN_VARS:
        assert f"`{name}`" in section, name


# -- the CLI ----------------------------------------------------------------------------

_DIRTY = "import os\nv = os.environ.get('MXNET_ROGUE')\n"


def _mk_pkg(tmp_path, files):
    pkg = tmp_path / "mxnet_tpu_torch"
    for rel, src in files.items():
        p = pkg / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(textwrap.dedent(src))
    return str(pkg)


def test_cli_exit_codes_and_baseline_multiset(tmp_path):
    pkg = _mk_pkg(tmp_path, {"bad.py": _DIRTY})
    root = str(tmp_path)
    assert tcore.main([pkg, "-q"], repo_root=root) == 1
    base = tmp_path / "baseline.json"
    assert tcore.main([pkg, "--write-baseline", str(base), "-q"],
                      repo_root=root) == 0
    assert tcore.main([pkg, "--baseline", str(base), "-q"],
                      repo_root=root) == 0
    # the same line twice: one entry excuses one occurrence
    (tmp_path / "mxnet_tpu_torch" / "bad.py").write_text(
        _DIRTY + "v = os.environ.get('MXNET_ROGUE')\n")
    assert tcore.main([pkg, "--baseline", str(base), "-q"],
                      repo_root=root) == 1
    assert tcore.main(["--no-such-flag"], repo_root=root) == 2
    assert tcore.main([str(tmp_path / "nowhere"), "-q"],
                      repo_root=root) == 2
    # the default path is the mxnet_tpu_torch package under the root
    assert tcore.main(["-q"], repo_root=root) == 1


def test_cli_select_ignore_sarif_stats(tmp_path, capsys):
    pkg = _mk_pkg(tmp_path, {"bad.py": _DIRTY})
    root = str(tmp_path)
    assert tcore.main([pkg, "-q", "--select", "GC06,GC07"],
                      repo_root=root) == 0
    assert tcore.main([pkg, "-q", "--ignore", "GC03"], repo_root=root) == 0
    assert tcore.main([pkg, "-q", "--select", "GC03"], repo_root=root) == 1
    out = tmp_path / "out.sarif"
    assert tcore.main([pkg, "-q", "--sarif", str(out), "--stats"],
                      repo_root=root) == 1
    doc = json.loads(out.read_text())
    run = doc["runs"][0]
    (tool,) = run["tool"].values()          # SARIF's one tool component
    assert {"GC00", "GC01", "GC06", "GC10"} <= {
        r["id"] for r in tool["rules"]}
    assert run["results"][0]["ruleId"] == "GC03"
    err = capsys.readouterr().err
    for rule in ("GC01", "GC06", "GC10", "total"):
        assert rule in err


def test_cli_lock_baseline_diff(tmp_path):
    nested = """
        import threading

        _alpha_lock = threading.Lock()
        _beta_lock = threading.Lock()

        def forward():
            with _alpha_lock:
                with _beta_lock:
                    pass
        """
    pkg = _mk_pkg(tmp_path, {"serving/engine.py": nested})
    root = str(tmp_path)
    base = tmp_path / "graftcheck-torch-lockorder.json"
    assert tcore.main([pkg, "-q", "--write-lock-baseline", str(base)],
                      repo_root=root) == 0
    assert [(e["from"], e["to"]) for e in
            json.loads(base.read_text())["edges"]] == [
        ("serving/engine.py::_alpha_lock", "serving/engine.py::_beta_lock")]
    assert tcore.main([pkg, "-q"], repo_root=root) == 0
    # a stale edge is red; the reference's baseline file is never read
    _mk_pkg(tmp_path, {"serving/engine.py": "X = 1\n"})
    (tmp_path / "graftcheck-lockorder.json").write_text('{"edges": []}')
    assert tcore.main([pkg, "-q"], repo_root=root) == 1


def test_gc03_reads_the_port_readme_section(tmp_path):
    pkg = tmp_path / "mxnet_tpu_torch"
    pkg.mkdir()
    (pkg / "config.py").write_text(textwrap.dedent("""
        KNOWN_VARS = {
            "MXNET_DOCUMENTED": ("1", "doc'd"),
            "MXNET_ELSEWHERE": ("0", "only in another section"),
        }
        """))
    (tmp_path / "README.md").write_text(
        "## Reference\n\n`MXNET_ELSEWHERE`\n\n"
        f"{tcore.README_SECTION}\n\n```\n## not a heading\n```\n"
        "`MXNET_DOCUMENTED`\n\n## Observability\n\n`MXNET_ELSEWHERE`\n")
    findings, _, _ = tanalysis.analyze_paths([str(pkg)],
                                             repo_root=str(tmp_path))
    msgs = [f.message for f in findings if f.rule == "GC03"]
    assert len(msgs) == 1 and "MXNET_ELSEWHERE" in msgs[0]


def test_launcher_runs_without_torch():
    code = ("import runpy, sys; sys.argv = ['torch_graftcheck.py', "
            "'--list-rules']\n"
            "try:\n    runpy.run_path('tools/torch_graftcheck.py', "
            "run_name='__main__')\nexcept SystemExit as e:\n"
            "    assert e.code == 0, e.code\n"
            "assert 'torch' not in sys.modules\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=60)
    assert res.returncode == 0, res.stderr
    rules = [ln.split()[0] for ln in res.stdout.splitlines()]
    assert rules == [f"GC{i:02d}" for i in range(1, 11)]


# -- GC09's chaos registry: every site armed here ---------------------------------

# written out so GC09's scan of tests/test_torch_*.py finds each site
CHAOS_SITES = ("kvstore.allreduce", "dist.barrier", "dataloader.fetch",
               "checkpoint.save", "trainer.step", "io.decode",
               "controller.spawn", "controller.resize", "router.dispatch",
               "router.replica_spawn", "serving.reply")


def test_chaos_registry_is_the_armed_set():
    from mxnet_tpu_torch.resilience import chaos
    assert set(CHAOS_SITES) == set(chaos.SITES)


@pytest.mark.parametrize("site", CHAOS_SITES)
def test_every_chaos_site_fires_when_armed(site):
    from mxnet_tpu_torch.resilience import chaos
    before = chaos.fault_count(site)
    chaos.inject(site, kind="transient", times=1)
    try:
        with pytest.raises(chaos.ChaosTransientError):
            chaos.hit(site)
        chaos.hit(site)                 # times=1: the second passes
    finally:
        chaos.clear(site)
    assert chaos.fault_count(site) == before + 1
