"""The port's ``mx.np`` held against the JAX package's over the case
tables of ``tests/test_numpy_broad.py`` (``UNARY``, ``BINARY``,
``REDUCTIONS``, ``SHAPE_FNS``, ``LINALG``, ``_PROMO_PAIRS``, ``_AXIS_FNS``,
``_SCALAR_CASES``) and the cases of ``tests/test_numpy.py``, imported from
those files, on the CPU.

Each case runs through both packages and numpy on the same seeded inputs:
the port agrees with numpy at the reference test's own tolerance, with the
reference's values at the same tolerance, and has the reference's dtype,
except the ROADMAP C.7 departures (a float the reference takes from its
x64 default float is float32 in the port), which
``test_torch_np_semantics.py`` pins.  The extended tables (``EXT_FNS`` ...
``EXT_FNS8``) are in ``test_torch_np_ext.py``.
"""

import numpy as onp
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from test_numpy_broad import (BINARY, LINALG, REDUCTIONS, SHAPE_FNS, UNARY,
                              _AXIS_FNS, _PROMO_FNS, _PROMO_PAIRS,
                              _SCALAR_CASES, _r)

tnp, jnp_ = mx.np, jmx.np


@pytest.fixture(autouse=True)
def _on_cpu():
    with mx.cpu():
        yield


def _val(r):
    return r.asnumpy() if hasattr(r, "asnumpy") else onp.asarray(r)


def _both(fn):
    """(port result, reference result) of ``fn(module)`` as numpy."""
    return _val(fn(tnp)), _val(fn(jnp_))


def _agree(got, ref, want, rtol, atol, dtype=True):
    assert got.shape == want.shape
    onp.testing.assert_allclose(onp.asarray(got, want.dtype), want,
                                rtol=rtol, atol=atol)
    onp.testing.assert_allclose(onp.asarray(got, ref.dtype), ref, rtol=rtol,
                                atol=atol)
    if dtype:
        assert got.dtype == ref.dtype, (got.dtype, ref.dtype)


@pytest.mark.parametrize("name,opts", UNARY, ids=[u[0] for u in UNARY])
def test_unary(name, opts):
    x = _r((3, 5), positive=opts.get("positive", False),
           small=opts.get("small", False))
    got, ref = _both(lambda m: getattr(m, name)(m.array(x)))
    _agree(got, ref, getattr(onp, name)(x), 2e-5, 2e-6)


@pytest.mark.parametrize("name", BINARY)
def test_binary(name):
    a = onp.abs(_r((4, 3), 1)) + 0.5
    b = onp.abs(_r((4, 3), 2)) + 0.5
    got, ref = _both(lambda m: getattr(m, name)(m.array(a), m.array(b)))
    _agree(got, ref, getattr(onp, name)(a, b), 2e-5, 2e-6)


@pytest.mark.parametrize("name", REDUCTIONS)
@pytest.mark.parametrize("axis", [None, 0, 1])
def test_reductions(name, axis):
    x = onp.abs(_r((3, 4), 3)) * 0.5 + 0.5
    got, ref = _both(lambda m: getattr(m, name)(m.array(x), axis=axis))
    _agree(got, ref, onp.asarray(getattr(onp, name)(x, axis=axis)), 2e-5,
           1e-5)


@pytest.mark.parametrize("case", SHAPE_FNS, ids=[c[0] for c in SHAPE_FNS])
def test_shape_and_products(case):
    _, fn, onp_fn = case
    x = _r((4, 3), 7)
    got, ref = _both(lambda m: fn(m, x))
    _agree(got, ref, onp.asarray(onp_fn(x)), 2e-5, 2e-6)


@pytest.mark.parametrize("case", LINALG, ids=[c[0] for c in LINALG])
def test_linalg(case):
    """``solve``'s right side is ``m.ones``, float64 in the reference
    (C.7), so its result's dtype follows."""
    name, fn, onp_fn = case
    r = onp.random.RandomState(11)
    a = r.randn(3, 3).astype(onp.float32)
    spd = (a @ a.T + 3 * onp.eye(3)).astype(onp.float32)
    got, ref = _both(lambda m: fn(m, m.array(spd)))
    _agree(got, ref, onp.asarray(onp_fn(spd)), 5e-4, 5e-5,
           dtype=name != "solve")
    if name == "solve":
        assert got.dtype == onp.float32 and ref.dtype == onp.float64


@pytest.mark.parametrize("da,db", _PROMO_PAIRS,
                         ids=[f"{a}+{b}" for a, b in _PROMO_PAIRS])
@pytest.mark.parametrize("name", _PROMO_FNS)
def test_dtype_promotion(name, da, db):
    av = onp.array([1, 0, 3]).astype(da)
    bv = onp.array([2, 5, 1]).astype(db)
    got, ref = _both(lambda m: getattr(m, name)(m.array(av), m.array(bv)))
    want = getattr(onp, name)(av, bv)
    assert got.dtype == want.dtype == ref.dtype
    onp.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("axis", [(0, 2), (1,), -1, -2, None],
                         ids=["tuple02", "tuple1", "neg1", "neg2", "none"])
@pytest.mark.parametrize("keepdims", [False, True])
@pytest.mark.parametrize("name", _AXIS_FNS)
def test_reduction_axis_kwargs(name, axis, keepdims):
    x = onp.abs(_r((2, 3, 4), 21)) + 0.5
    got, ref = _both(lambda m: getattr(m, name)(m.array(x), axis=axis,
                                                keepdims=keepdims))
    _agree(got, ref, onp.asarray(getattr(onp, name)(
        x, axis=axis, keepdims=keepdims)), 2e-5, 1e-5)


@pytest.mark.parametrize("name", ["argmax", "argmin", "cumsum"])
@pytest.mark.parametrize("axis", [-1, 0])
def test_index_and_scan_negative_axis(name, axis):
    x = _r((3, 4), 22)
    got, ref = _both(lambda m: getattr(m, name)(m.array(x), axis=axis))
    _agree(got, ref, getattr(onp, name)(x, axis=axis), 2e-6, 2e-6)


@pytest.mark.parametrize("case", _SCALAR_CASES,
                         ids=[c[0] for c in _SCALAR_CASES])
def test_python_scalar_operand(case):
    _, fn = case
    x = onp.abs(_r((3, 4), 23)) + 1.0
    got, ref = _both(lambda m: fn(m, m.array(x)))
    _agree(got, ref, onp.asarray(fn(onp, x)), 2e-5, 2e-6)


def test_division_of_integers_is_float32():
    """int32 / int32: a float, float32 in both packages."""
    a, b = onp.array([7, 8, 9], onp.int32), onp.array([2, 4, 3], onp.int32)
    got, ref = _both(lambda m: m.divide(m.array(a), m.array(b)))
    assert got.dtype == ref.dtype == onp.float32
    onp.testing.assert_allclose(got, a / b, rtol=1e-6)


def test_zero_d_arrays():
    for m in (tnp, jnp_):
        z = m.array(3.5)
        assert z.shape == ()
        assert float(m.add(z, 1.5).asnumpy()) == 5.0
        assert float(m.exp(m.array(0.0)).asnumpy()) == 1.0
        assert float(m.sum(z).asnumpy()) == 3.5 and m.sum(z).shape == ()
        s = m.sum(m.array(onp.ones(4, onp.float32)))
        assert s.shape == () and float(s.asnumpy()) == 4.0
        got = m.multiply(m.array(onp.array([1.0, 2.0], onp.float32)), z)
        onp.testing.assert_allclose(got.asnumpy(), [3.5, 7.0])


# -- tests/test_numpy.py's cases -------------------------------------------------

@pytest.mark.parametrize("name,args", [
    ("zeros", ((2, 3),)), ("ones", ((4,),)), ("eye", (3,)),
    ("arange", (5,)), ("linspace", (0.0, 1.0, 5)),
])
def test_creation_matches_numpy(name, args):
    got, ref = _both(lambda m: getattr(m, name)(*args))
    want = getattr(onp, name)(*args)
    onp.testing.assert_allclose(got, want, rtol=1e-6)
    onp.testing.assert_allclose(got, ref, rtol=1e-6)


@pytest.mark.parametrize("name", ["exp", "log1p", "sqrt", "tanh", "floor",
                                  "sign", "square"])
def test_unary_from_test_numpy(name):
    x = onp.abs(onp.random.RandomState(0).randn(3, 4)).astype(onp.float32)
    got, ref = _both(lambda m: getattr(m, name)(m.array(x)))
    _agree(got, ref, getattr(onp, name)(x), 1e-5, 0)


def test_array_roundtrip_and_promotion():
    for m in (tnp, jnp_):
        a = m.array(3.5)
        assert a.shape == () and float(a.asnumpy()) == 3.5
        b = m.array([[1, 2], [3, 4]], dtype=m.float32)
        onp.testing.assert_array_equal(b.asnumpy(), [[1, 2], [3, 4]])
        out = m.add(m.array(onp.ones((3, 1), onp.float32)),
                    m.array(onp.arange(4, dtype=onp.float32)))
        assert out.shape == (3, 4)
        c = m.array(onp.array([1, 2], onp.int32))
        d = m.array(onp.array([0.5, 0.5], onp.float32))
        assert onp.dtype(m.add(c, d).dtype) == onp.float32


def test_reductions_einsum_indexing():
    r = onp.random.RandomState(1)
    x = r.randn(2, 3, 4).astype(onp.float32)
    A, B = r.randn(3, 4).astype(onp.float32), r.randn(4, 5).astype(onp.float32)
    for m in (tnp, jnp_):
        a = m.array(x)
        onp.testing.assert_allclose(m.sum(a, axis=(0, 2)).asnumpy(),
                                    x.sum(axis=(0, 2)), rtol=1e-5)
        assert m.argmax(a).asnumpy() == x.argmax()
        onp.testing.assert_allclose(
            m.einsum("ij,jk->ik", m.array(A), m.array(B)).asnumpy(), A @ B,
            rtol=1e-5)
        y = onp.arange(24, dtype=onp.float32).reshape(2, 3, 4)
        b = m.array(y)
        onp.testing.assert_array_equal(
            m.transpose(b, (2, 0, 1)).asnumpy(), y.transpose(2, 0, 1))
        onp.testing.assert_array_equal(
            m.where(b > 10, b, 0 * b).asnumpy(), onp.where(y > 10, y, 0))
        onp.testing.assert_array_equal(
            m.take(b.reshape(-1), m.array([0, 5, 7])).asnumpy(),
            y.reshape(-1)[[0, 5, 7]])


def test_linalg_namespace_from_test_numpy():
    r = onp.random.RandomState(3)
    M = r.randn(4, 4).astype(onp.float32)
    M = M @ M.T + 4 * onp.eye(4, dtype=onp.float32)
    a = tnp.array(M)
    onp.testing.assert_allclose(tnp.linalg.det(a).asnumpy(),
                                onp.linalg.det(M), rtol=1e-3)
    onp.testing.assert_allclose(tnp.linalg.inv(a).asnumpy() @ M,
                                onp.eye(4), atol=1e-4)
    L = tnp.linalg.cholesky(a).asnumpy()
    onp.testing.assert_allclose(L @ L.T, M, rtol=1e-4, atol=1e-4)
    q, rr = tnp.linalg.qr(a)
    onp.testing.assert_allclose(q.asnumpy() @ rr.asnumpy(), M, rtol=1e-4,
                                atol=1e-4)


def test_autograd_through_np_ops():
    """The reference's two autograd cases, in both packages."""
    x0 = _r((3, 3), 13)
    for pkg in (jmx, mx):
        x = pkg.np.array(onp.array([1.0, 2.0, 3.0], onp.float32))
        x.attach_grad()
        with pkg.autograd.record():
            y = pkg.np.sum(pkg.np.square(x) * 2.0)
        y.backward()
        onp.testing.assert_allclose(x.grad.asnumpy(), [4.0, 8.0, 12.0])
        x = pkg.np.array(x0)
        x.attach_grad()
        with pkg.autograd.record():
            y = pkg.np.sum(pkg.np.tanh(x) * pkg.np.exp(x * 0.1))
        y.backward()
        want = (1 - onp.tanh(x0) ** 2) * onp.exp(x0 * 0.1) \
            + onp.tanh(x0) * 0.1 * onp.exp(x0 * 0.1)
        onp.testing.assert_allclose(x.grad.asnumpy(), want, rtol=1e-4,
                                    atol=1e-5)


def test_npx_set_np_roundtrip():
    assert not mx.util.is_np_array()
    mx.npx.set_np()
    try:
        assert mx.util.is_np_array() and mx.util.is_np_shape()
    finally:
        mx.npx.reset_np()
    assert not mx.util.is_np_array()
