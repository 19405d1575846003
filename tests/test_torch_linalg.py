"""``mx.nd.linalg`` of the port held against the JAX package's, on the CPU:
every attribute combination of the BLAS-like ops, batched operands, the
triangle and diagonal packers at several offsets, and gradients, on the
same float32 numpy inputs made from a seed.

Tolerances: 1e-4 of max |ref| (LAPACK and XLA sum in another order; the
operands are well conditioned); the decompositions, whose signs and orders
are free, by their invariants (reconstruction and orthogonality to 1e-4 of
|A|, singular and eigen values and |diag R| 1e-4); the packers exactly.
"""

import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from mxnet_tpu_torch.ops import sweep

TOL = 1e-4


@pytest.fixture(autouse=True)
def _on_cpu():
    with mx.cpu():
        yield


def _rand(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _spd(seed, *batch, n=4):
    a = _rand(seed, *batch, n, n)
    return (a @ a.swapaxes(-1, -2) + n * np.eye(n)).astype(np.float32)


def _tri(seed, *batch, n=4, lower=True):
    a = _rand(seed, *batch, n, n) + 4 * np.eye(n, dtype=np.float32)
    return np.tril(a) if lower else np.triu(a)


def _compare(name, arrays, attrs, exact=False):
    got, got_g = sweep.run(mx, name, arrays, attrs, mx.cpu())
    want, want_g = sweep.run(jmx, name, arrays, attrs, jmx.cpu())
    if exact:
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    err, tol = sweep.close(name, got, want, arrays, tol=TOL)
    assert err <= tol, f"{name} {attrs}: {err:.3g}"
    for g, w in zip(got_g, want_g):
        assert sweep.rel_err(g, w) <= TOL, f"{name} {attrs}: gradients"
    return got


@pytest.mark.parametrize("ta", [False, True])
@pytest.mark.parametrize("tb", [False, True])
def test_gemm_gemm2(ta, tb):
    a = _rand(1, 2, 3, 4) if not ta else _rand(1, 2, 4, 3)
    b = _rand(2, 2, 4, 5) if not tb else _rand(2, 2, 5, 4)
    c = _rand(3, 2, 3, 5)
    _compare("linalg.gemm", [a, b, c], {"transpose_a": ta, "transpose_b": tb,
                                        "alpha": 1.5, "beta": -0.5})
    _compare("linalg.gemm2", [a, b], {"transpose_a": ta, "transpose_b": tb,
                                      "alpha": 0.5})


@pytest.mark.parametrize("transpose", [False, True])
def test_syrk(transpose):
    _compare("linalg.syrk", [_rand(4, 2, 3, 5)], {"transpose": transpose,
                                                  "alpha": 2.0})


@pytest.mark.parametrize("name", ["linalg.trsm", "linalg.trmm"])
@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("rightside", [False, True])
@pytest.mark.parametrize("lower", [False, True])
def test_triangular(name, transpose, rightside, lower):
    a = _tri(5, 2, lower=lower)
    b = _rand(6, 2, 3, 4) if rightside else _rand(6, 2, 4, 3)
    _compare(name, [a, b], {"transpose": transpose, "rightside": rightside,
                            "lower": lower, "alpha": 0.5})


def test_cholesky_family():
    a = _spd(7, 3)
    lo = _compare("linalg.potrf", [a], {})[0]
    np.testing.assert_allclose(lo @ lo.swapaxes(-1, -2), a, rtol=0,
                               atol=TOL * np.abs(a).max())
    inv = _compare("linalg.potri", [lo], {})[0]
    np.testing.assert_allclose(inv, np.linalg.inv(a), rtol=0,
                               atol=TOL * np.abs(inv).max())
    _compare("linalg.sumlogdiag", [lo], {})


@pytest.mark.parametrize("name", ["linalg.inverse", "linalg.det",
                                  "linalg.slogdet"])
def test_inverse_and_determinants(name):
    _compare(name, [_spd(8, 2, 3)], {})


def test_solve_and_tensorinv():
    _compare("linalg.solve", [_spd(9, 2), _rand(10, 2, 4, 3)], {})
    a = (np.eye(12) + 0.1 * _rand(11, 12, 12)).reshape(3, 4, 6, 2)
    _compare("linalg.tensorinv", [a.astype(np.float32)], {"ind": 2})


@pytest.mark.parametrize("offset", [-2, 0, 1])
def test_diag_and_triangle_packers(offset):
    a = _rand(12, 2, 5, 5)
    _compare("linalg.extractdiag", [a], {"offset": offset}, exact=True)
    _compare("linalg.makediag", [_rand(13, 2, 3)], {"offset": offset},
             exact=True)
    for lower in (True, False):
        packed = _compare("linalg.extracttrian", [a],
                          {"offset": offset, "lower": lower}, exact=True)[0]
        if (offset <= 0) == lower:     # a square triangle: it unpacks
            back = _compare("linalg.maketrian", [packed],
                            {"offset": offset, "lower": lower},
                            exact=True)[0]
            tri = np.tril(a, offset) if lower else np.triu(a, offset)
            np.testing.assert_array_equal(back, tri)


@pytest.mark.parametrize("name,shape", [
    ("linalg.svd", (2, 3, 5)), ("linalg.svd", (4, 3)),
    ("linalg.eigh", None), ("linalg.qr", (2, 5, 3)),
    ("linalg.gelqf", (2, 3, 5))])
def test_decompositions_by_invariants(name, shape):
    a = _spd(14, 2) if shape is None else _rand(14, *shape)
    _compare(name, [a], {})


@pytest.mark.parametrize("attrs", [
    {}, {"ord": 1, "axis": 1}, {"ord": "fro", "axis": (1, 2)},
    {"ord": 2, "axis": 2, "keepdims": True}, {"ord": "nuc", "axis": (1, 2)}])
def test_norm(attrs):
    _compare("linalg.norm", [_rand(15, 2, 3, 4)], attrs)


def test_rank_and_pinv():
    low = (_rand(16, 5, 2) @ _rand(17, 2, 4)).astype(np.float32)
    for tol in (None, 1e-3):
        got = _compare("linalg.matrix_rank", [low], {"tol": tol},
                       exact=True)[0]
        assert got == 2
    _compare("linalg.pinv", [_rand(18, 2, 5, 3)], {})


@pytest.mark.parametrize("subscripts,shapes", [
    ("ij,jk->ik", [(3, 4), (4, 5)]), ("bij,bjk->bik", [(2, 3, 4), (2, 4, 5)]),
    ("ii->i", [(4, 4)]), ("ij->", [(3, 4)])])
def test_einsum(subscripts, shapes):
    _compare("einsum", [_rand(19 + i, *s) for i, s in enumerate(shapes)],
             {"subscripts": subscripts})
