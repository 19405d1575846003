"""The port's ``mx.np`` / ``mx.npx`` / ``mx.util`` surface, its namespaces
and import rule, and the repairs of ROADMAP C.16 and the A.10 surface
tail, held against the JAX package on the CPU.

- Every public name of the reference's ``mx.np``, ``np.fft``,
  ``np.linalg``, ``np.random``, ``mx.npx`` and ``mx.util`` exists in the
  port, and every one is exercised by a test (``EXERCISED``).
- ``mx.np`` grows no ``mx.nd.np`` or ``mx.sym.np``: in either package when
  ``mx.sym`` loads first, and in the port whichever loads first (the
  reference's lazy ``mx.sym`` takes the ``np.*`` ops in when ``mx.np``
  loads before it; ROADMAP C.7).
- The port imports neither ``jax`` nor ``mxnet_tpu`` (the import rule), by
  its source and by a process where ``import jax`` fails.
- C.16: the reference's lazily loaded modules that the port has resolve as
  ``mx.<name>`` without ``import mxnet_tpu_torch`` loading the serving
  engine; ``Parameter.var()`` writes the reference's symbol json.
"""

import ast
import os
import subprocess
import sys
import types

import numpy as onp
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from mxnet_tpu_torch.numpy import _sweep

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "mxnet_tpu_torch")


def _public(mod):
    return {n for n in dir(mod) if not n.startswith("_")}


def _run(code):
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120, env=env, cwd=REPO)


@pytest.mark.parametrize("path", ["np", "np.fft", "np.linalg", "np.random",
                                  "npx", "util"])
def test_public_names_contain_the_reference(path):
    ref, port = jmx, mx
    for part in path.split("."):
        ref, port = getattr(ref, part), getattr(port, part)
    missing = _public(ref) - _public(port)
    assert not missing, sorted(missing)
    if path == "np":
        assert len(_public(ref)) == 355
    if path == "npx":
        assert len(_public(ref)) == 46


# names a test exercises outside the sweep table: the constants and types,
# the array makers, the host helpers, the writers, np.random and npx
EXERCISED = {
    "np": {"MXNetError", "NDArray", "annotations", "current_context",
           "ndarray", "float16", "float32", "float64", "int8", "int32",
           "int64", "uint8", "bool_", "pi", "inf", "nan", "newaxis",
           "array", "asarray", "ascontiguousarray", "array_repr",
           "array_str", "einsum_path", "iterable", "issubdtype",
           "vectorize", "fromiter", "mask_indices", "put", "place",
           "fill_diagonal", "fft", "linalg", "random"},
    "np.random": {"uniform", "normal", "randint", "rand", "randn", "choice",
                  "shuffle", "seed", "annotations"},
    "npx": {"set_np", "reset_np", "is_np_array", "is_np_shape", "cpu", "gpu",
            "tpu", "num_gpus", "current_context", "waitall", "save", "load",
            "annotations"},
}


def test_every_public_name_is_exercised():
    cases = set(_sweep.CASES)
    for path, mod in (("np", mx.np), ("np.fft", mx.np.fft),
                      ("np.linalg", mx.np.linalg)):
        prefix = "" if path == "np" else path[3:] + "."
        ref = {n for n in _public({"np": jmx.np, "np.fft": jmx.np.fft,
                                   "np.linalg": jmx.np.linalg}[path])
               if not isinstance(getattr(mod, n), types.ModuleType)
               or n in EXERCISED.get(path, ())}
        left = {n for n in ref if prefix + n not in cases} \
            - EXERCISED.get(path, set())
        assert not left, (path, sorted(left))
    assert _public(jmx.np.random) <= EXERCISED["np.random"]
    npx_ops = set(mx.npx._NPX_OPS)
    assert _public(jmx.npx) <= EXERCISED["npx"] | npx_ops


def test_constants_types_and_array_makers():
    np = mx.np
    for n in ("float16", "float32", "float64", "int8", "int32", "int64",
              "uint8", "bool_", "pi", "inf", "nan"):
        assert getattr(np, n) is getattr(onp, n) or \
            getattr(np, n) == getattr(onp, n)
    assert np.newaxis is None and np.ndarray is np.NDArray
    assert issubclass(np.MXNetError, RuntimeError)
    assert np.current_context() == mx.current_context()
    with mx.cpu():
        a = np.asarray([[1.0, 2.0]])
        assert a.dtype == onp.float32
        b = np.ascontiguousarray(np.array([1, 2]))
        assert b.dtype == onp.int64
        assert np.array(a, dtype="float16").dtype == onp.float16


@pytest.mark.parametrize("name", sorted(mx.npx._NPX_OPS))
def test_npx_op_matches_the_nd_op(name):
    """Each npx name is its registry op (the reference's table), on
    NDArrays and on the bare tensors of a hybridized block."""
    from mxnet_tpu_torch.ops import registry
    op = registry.get(mx.npx._NPX_OPS[name])
    assert op is not None
    with mx.cpu():
        x = mx.np.array(onp.linspace(-1, 1, 12, dtype=onp.float32)
                        .reshape(3, 4))
        if name in ("softmax", "log_softmax", "relu", "sigmoid", "sign",
                    "erf", "erfinv", "gamma"):
            got = getattr(mx.npx, name)(x)
            want = mx.nd.__dict__[mx.npx._NPX_OPS[name]](x)
            onp.testing.assert_allclose(got.asnumpy(), want.asnumpy())
            bare = getattr(mx.npx, name)(x._data)
            onp.testing.assert_allclose(bare.numpy(), want.asnumpy())


def test_npx_set_np_save_load_and_contexts(tmp_path):
    npx = mx.npx
    npx.set_np()
    try:
        assert npx.is_np_array() and npx.is_np_shape()
        with mx.cpu():
            a = mx.np.arange(6).reshape(2, 3)
            f = str(tmp_path / "a.npz")
            npx.save(f, {"a": a})
            back = npx.load(f)["a"]
        assert onp.array_equal(back.asnumpy(), a.asnumpy())
        assert back.dtype == onp.int64
        npx.waitall()
    finally:
        npx.reset_np()
    assert not npx.is_np_array()
    assert npx.cpu() == mx.cpu() and npx.gpu(1) == mx.gpu(1)
    assert npx.num_gpus() == mx.num_gpus()
    assert npx.current_context() == mx.current_context()
    with pytest.raises(mx.MXNetError):
        npx.tpu()


def test_util_flags_scopes_and_env():
    u = mx.util
    assert not u.is_np_array()
    with u.np_array(True):
        assert u.is_np_array() and not u.is_np_shape()
        with u.np_shape(True):
            assert u.is_np_shape()
        assert not u.is_np_shape()
    assert not u.is_np_array()
    assert u.set_np_shape(True) is False and u.is_np_shape()
    u.reset_np()

    @u.use_np
    def inside():
        return u.is_np_array(), u.is_np_shape()
    assert inside() == (True, True) and not u.is_np_array()
    u.setenv("MXNET_TEST_UTIL_ENV", "7")
    assert u.getenv("MXNET_TEST_UTIL_ENV") == "7"
    del os.environ["MXNET_TEST_UTIL_ENV"]


def test_no_np_namespace_under_nd_or_sym():
    from mxnet_tpu_torch.ndarray import register as ndreg
    from mxnet_tpu_torch.symbol import register as symreg
    mx.np  # noqa: B018
    assert not hasattr(mx.nd, "np") and not hasattr(mx.sym, "np")
    # a library load populates both again: still no np
    ndreg.populate(mx.nd)
    symreg.populate(mx.sym)
    assert not hasattr(mx.nd, "np") and not hasattr(mx.sym, "np")
    assert not hasattr(jmx.nd, "np")


@pytest.mark.parametrize("pkg,order", [
    ("mxnet_tpu", "mx.sym; mx.np"), ("mxnet_tpu_torch", "mx.sym; mx.np"),
    ("mxnet_tpu_torch", "mx.np; mx.sym")])
def test_no_np_namespace_in_a_fresh_process(pkg, order):
    r = _run(f"import {pkg} as mx; {order}; mx.npx; "
             "assert not hasattr(mx.nd, 'np'), 'nd'; "
             "assert not hasattr(mx.sym, 'np'), 'sym'; print('ok')")
    assert r.returncode == 0 and "ok" in r.stdout, r.stderr[-2000:]


def test_reference_sym_takes_np_ops_when_np_loads_first():
    """The reference's fault that the port does not copy (C.7)."""
    r = _run("import mxnet_tpu as mx; mx.np; print(hasattr(mx.sym, 'np'))")
    assert r.returncode == 0 and r.stdout.strip().endswith("True")


# -- the import rule -----------------------------------------------------------------

def _sources():
    for root, _, files in os.walk(PORT):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(root, f)
    yield os.path.join(REPO, "chip_smoke.py")


def _banned(name):
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "mxnet_tpu")


def test_port_source_imports_no_jax_or_reference():
    bad = []
    for path in _sources():
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                bad += [(path, a.name) for a in node.names if _banned(a.name)]
            elif isinstance(node, ast.ImportFrom) and node.level == 0 \
                    and node.module and _banned(node.module):
                bad.append((path, node.module))
            elif isinstance(node, ast.Call) and getattr(
                    node.func, "attr", getattr(node.func, "id", "")) in (
                    "import_module", "__import__") and node.args and \
                    isinstance(node.args[0], ast.Constant) and \
                    isinstance(node.args[0].value, str) and \
                    _banned(node.args[0].value):
                bad.append((path, node.args[0].value))
    assert not bad, bad


def test_port_runs_where_jax_cannot_import():
    r = _run("import sys; sys.modules['jax'] = None; "
             "sys.modules['jaxlib'] = None; "
             "sys.modules['mxnet_tpu'] = None; "
             "import mxnet_tpu_torch as mx; mx.np; mx.npx; mx.util; "
             "mx.np.fft; mx.np.linalg; mx.np.random; "
             "import mxnet_tpu_torch.numpy._sweep; "
             "a = mx.np.arange(6, ctx=mx.cpu()); "
             "print(float(mx.np.sum(a).asnumpy()))")
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.strip().endswith("15.0")


# -- ROADMAP C.16 and the A.10 surface tail --------------------------------------------

# the reference's lazily loaded modules (mxnet_tpu/__init__.py) that the
# port has, and the short names of them
LAZY = ("gluon", "optimizer", "metric", "initializer", "lr_scheduler", "io",
        "image", "kvstore", "profiler", "runtime", "symbol", "parallel",
        "test_utils", "recordio", "callback", "model", "util", "numpy",
        "numpy_extension", "contrib", "amp", "module", "monitor",
        "checkpoint", "dmlc_params", "operator", "name", "attribute", "rtc",
        "native", "visualization", "library", "telemetry", "resilience",
        "serving", "sym", "mod", "np", "npx", "kv", "viz", "init")


def test_reference_lazy_names_resolve():
    for name in LAZY:
        assert isinstance(getattr(mx, name), types.ModuleType), name
        assert isinstance(getattr(jmx, name), types.ModuleType), name
    assert mx.np is mx.numpy and mx.npx is mx.numpy_extension
    with pytest.raises(AttributeError):
        mx.no_such_module  # noqa: B018


def test_import_does_not_load_the_serving_engine():
    r = _run("import sys, mxnet_tpu_torch as mx; "
             "assert not [m for m in sys.modules if "
             "m.startswith(('mxnet_tpu_torch.serving', "
             "'mxnet_tpu_torch.numpy', 'mxnet_tpu_torch.native'))]; "
             "mx.serving.ServingEngine; mx.native; "
             "assert 'mxnet_tpu_torch.serving' in sys.modules; print('ok')")
    assert r.returncode == 0 and "ok" in r.stdout, r.stderr[-2000:]


@pytest.mark.parametrize("dtype", ["float32", "float16", "int32"])
def test_parameter_var_is_the_reference_symbol(dtype):
    jp = jmx.gluon.Parameter("w", shape=(3, 4), dtype=dtype)
    tp = mx.gluon.Parameter("w", shape=(3, 4), dtype=dtype)
    assert tp.var().tojson() == jp.var().tojson()
    assert (tp.var() * 2).tojson() == (jp.var() * 2).tojson()
    assert tp.var().infer_shape()[1] == [(3, 4)]


def test_operator_doc_has_no_sym_custom():
    assert "sym.Custom" not in mx.operator.__doc__
    assert not hasattr(jmx.sym, "Custom") and not hasattr(mx.sym, "Custom")


def test_surface_tail():
    for name in ("cpu_pinned", "cpu_shared"):
        c, j = getattr(mx, name)(), getattr(jmx.context, name)()
        assert c.device_type == j.device_type == name
        assert mx.Context.devtype2num[name] == jmx.Context.devtype2num[name]
        a = mx.nd.array([1.0, 2.0], ctx=c)
        assert a.context == c and a._data.device.type == "cpu"
    assert mx.ops.list_ops() == mx.ops.registry.list_ops()
    assert mx.ops.get("dot") is mx.ops.registry.get("dot")
    with mx.cpu():
        out = mx.ops.invoke("dot", [mx.nd.ones((2, 2)), mx.nd.ones((2, 2))])
    assert out.asnumpy().tolist() == [[2, 2], [2, 2]]

    @mx.ops.register("test_surface_tail_double")
    def _double(x):
        return x * 2
    try:
        with mx.cpu():
            got = mx.ops.invoke("test_surface_tail_double", [mx.nd.ones(2)])
        assert got.asnumpy().tolist() == [2, 2]
    finally:
        mx.ops.registry._REGISTRY.pop("test_surface_tail_double")
    assert mx.base.numeric_types == jmx.base.numeric_types
    assert mx.base.integer_types == jmx.base.integer_types
    assert mx.base.string_types == jmx.base.string_types
    e = mx.base.NotSupportedForSparseNDArray(mx.nd.dot, "dot", 1)
    assert isinstance(e, mx.MXNetError)
    assert str(e) == str(jmx.base.NotSupportedForSparseNDArray(
        jmx.nd.dot, "dot", 1))
    assert mx.kv.num_data_devices() == max(mx.num_gpus(), 1)
    img = onp.random.RandomState(0).randint(0, 256, (6, 8, 3)) \
        .astype(onp.uint8)
    with mx.cpu():
        got = mx.nd.imresize(mx.nd.array(img, dtype="uint8"), 4, 3)
    want = jmx.nd.imresize(jmx.nd.array(img, dtype="uint8"), 4, 3)
    assert got.shape == want.shape == (3, 4, 3)
    assert onp.abs(got.asnumpy().astype(int)
                   - want.asnumpy().astype(int)).max() <= 1
    for cls in ("CudaModule", "CudaKernel"):
        with pytest.raises(mx.MXNetError):
            getattr(mx.rtc, cls)("source")
        with pytest.raises(jmx.MXNetError):
            getattr(jmx.rtc, cls)("source")
