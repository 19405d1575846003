"""Inputs for a sweep of ``mx.np``: one case for every ``np.*`` registry
name (the reference's 370: the main namespace, ``np.fft`` and
``np.linalg``), so each function can run on two devices, or in two
packages, on the same values.

A case is ``(arrays, call, kind)``: ``arrays(r)`` makes numpy inputs from a
``RandomState``; ``call(m, *xs)`` calls the function through the module
``m`` (this package's ``mx.np`` or any module with its API, the
reference's included) on those inputs made arrays by ``m.array``; ``kind``
is ``"e"`` (elementwise: ``TOL["elementwise"]`` of max |want|), ``"r"``
(it sums, sorts or factors: ``TOL["reduction"]``) or ``"x"`` (equal).
Integer and bool outputs are compared for equality whatever the kind.
The decompositions return their invariants (singular values, the
reconstruction, sorted eigenvalues), since signs and orders are free.

:func:`run` gives a case's outputs as numpy arrays (:func:`leaves` and
:func:`to_numpy` for a caller that calls the case itself); :func:`close`
compares two runs.  :data:`HOST_SYNC` lists the functions whose output shape
depends on the values, which must read a count from the device.
"""

from __future__ import annotations

import numpy as np

__all__ = ["CASES", "TOL", "HOST_SYNC", "names", "inputs", "call", "run",
           "leaves", "to_numpy", "close"]

TOL = {"e": 1e-5, "r": 1e-4, "x": 0.0}

# the output's size depends on the values: a count crosses to the host
HOST_SYNC = frozenset([
    "unique", "unique_all", "unique_counts", "unique_inverse",
    "unique_values", "nonzero", "argwhere", "extract", "trim_zeros",
    "flatnonzero", "compress", "union1d", "intersect1d", "setdiff1d",
    "setxor1d", "roots", "ix_", "bincount", "linalg.lstsq"])

f32 = np.float32


def _f(r, *shape):
    return r.randn(*shape).astype(f32)


def _pos(r, *shape):
    return (np.abs(r.randn(*shape)) + 0.5).astype(f32)


def _unit(r, *shape):
    return (np.tanh(r.randn(*shape)) * 0.9).astype(f32)


def _ge1(r, *shape):
    return (np.abs(r.randn(*shape)) + 1.1).astype(f32)


def _i(r, *shape, lo=0, hi=10):
    return r.randint(lo, hi, shape).astype(np.int32)


def _nan(r, *shape):
    x = _f(r, *shape)
    x.reshape(-1)[1] = np.nan
    return x


def _spd(r, n=4):
    a = r.randn(n, n)
    return (a @ a.T + n * np.eye(n)).astype(f32)


CASES = {}


def _case(name, arrays, call, kind="e"):
    CASES[name] = (arrays, call, kind)


def _one(fn):
    return lambda m, a, fn=fn: getattr(m, fn)(a)


def _two(fn):
    return lambda m, a, b, fn=fn: getattr(m, fn)(a, b)


for _n in ("exp", "expm1", "sin", "cos", "arctan", "atan", "sinh", "cosh",
           "tanh", "arcsinh", "asinh", "degrees", "rad2deg", "radians",
           "deg2rad", "cbrt", "sinc", "i0", "fabs", "sign", "negative",
           "positive", "abs", "absolute", "square", "floor", "ceil", "trunc",
           "fix", "rint", "around", "round", "exp2", "real", "imag", "conj",
           "conjugate", "angle", "signbit", "isfinite", "isnan", "isinf",
           "isposinf", "isneginf", "iscomplex", "isreal", "copy",
           "logical_not", "spacing"):
    _case(_n, lambda r: [_f(r, 3, 4)], _one(_n),
          "x" if _n in ("spacing",) else "e")
for _n in ("log", "log2", "log10", "log1p", "sqrt", "reciprocal"):
    _case(_n, lambda r: [_pos(r, 3, 4)], _one(_n))
for _n in ("arcsin", "asin", "arccos", "acos", "arctanh", "atanh", "tan"):
    _case(_n, lambda r: [_unit(r, 3, 4)], _one(_n))
for _n in ("arccosh", "acosh"):
    _case(_n, lambda r: [_ge1(r, 3, 4)], _one(_n))
for _n in ("invert", "bitwise_not", "bitwise_invert", "bitwise_count"):
    _case(_n, lambda r: [_i(r, 3, 4, lo=-50, hi=50)], _one(_n))
for _n in ("frexp", "modf"):
    _case(_n, lambda r: [_f(r, 3, 4) * 8], _one(_n))
_case("nan_to_num", lambda r: [np.array([np.nan, np.inf, -np.inf, 1.5], f32)],
      _one("nan_to_num"))

for _n in ("add", "subtract", "multiply", "divide", "true_divide", "power",
           "pow", "float_power", "maximum", "minimum", "fmax", "fmin",
           "hypot", "arctan2", "atan2", "copysign", "logaddexp",
           "logaddexp2", "mod", "remainder", "fmod", "floor_divide",
           "heaviside", "greater", "greater_equal", "less", "less_equal",
           "equal", "not_equal", "logical_and", "logical_or", "logical_xor",
           "isclose", "allclose", "array_equal", "array_equiv", "divmod",
           "nextafter"):
    _case(_n, lambda r: [_pos(r, 4, 3), _pos(r, 4, 3)], _two(_n),
          "x" if _n == "nextafter" else "e")
# a Python number beside an array (a host scalar on the card)
for _n, _v in (("power", 2), ("maximum", 1.0), ("fmin", 1.0),
               ("hypot", 2.0), ("arctan2", 2.0), ("copysign", -1.0),
               ("remainder", 0.75), ("logaddexp", 1.0), ("greater", 1.0),
               ("isclose", 1.0), ("heaviside", 0.5),
               ("floor_divide", 0.5)):
    _case(_n, lambda r: [_pos(r, 4, 3)],
          lambda m, a, n=_n, v=_v: getattr(m, n)(a, v))
for _n in ("gcd", "lcm", "bitwise_and", "bitwise_or", "bitwise_xor"):
    _case(_n, lambda r: [_i(r, 4, 3, lo=1, hi=40), _i(r, 4, 3, lo=1, hi=40)],
          _two(_n))
for _n in ("left_shift", "right_shift", "bitwise_left_shift",
           "bitwise_right_shift"):
    _case(_n, lambda r: [_i(r, 4, 3, lo=1, hi=40), _i(r, 4, 3, hi=4)],
          _two(_n))
_case("ldexp", lambda r: [_f(r, 3, 4), _i(r, 3, 4, lo=-3, hi=4)],
      _two("ldexp"))

for _n in ("sum", "prod", "mean", "std", "var", "median", "average",
           "min", "max", "amin", "amax", "ptp", "argmin", "argmax",
           "cumsum", "cumprod", "cumulative_sum", "cumulative_prod",
           "count_nonzero", "all", "any"):
    _case(_n, lambda r: [_pos(r, 3, 4, 5)],
          lambda m, a, n=_n: getattr(m, n)(a, axis=1), "r")
for _n in ("nansum", "nanprod", "nanmean", "nanstd", "nanvar", "nanmin",
           "nanmax", "nanargmin", "nanargmax", "nanmedian", "nancumsum",
           "nancumprod"):
    _case(_n, lambda r: [_nan(r, 3, 5)],
          lambda m, a, n=_n: getattr(m, n)(a, axis=1), "r")
for _n, _q in (("percentile", 30.0), ("quantile", 0.7),
               ("nanpercentile", 40.0), ("nanquantile", 0.4)):
    _case(_n, lambda r, n=_n: [_nan(r, 4, 6) if n.startswith("nan")
                               else _f(r, 4, 6)],
          lambda m, a, n=_n, q=_q: getattr(m, n)(a, q, axis=0), "r")

_case("zeros", lambda r: [], lambda m: m.zeros((2, 3)))
_case("ones", lambda r: [], lambda m: m.ones((2, 3), dtype="int32"))
_case("empty", lambda r: [], lambda m: m.empty((2, 3)).shape, "x")
_case("full", lambda r: [], lambda m: m.full((2, 3), 2.5))
_case("arange", lambda r: [], lambda m: m.arange(2.0, 8.0, 1.5))
_case("linspace", lambda r: [], lambda m: m.linspace(-2.0, 2.0, 9))
_case("logspace", lambda r: [], lambda m: m.logspace(0.0, 2.0, 5))
_case("geomspace", lambda r: [], lambda m: m.geomspace(1.0, 64.0, 7))
_case("eye", lambda r: [], lambda m: m.eye(4, 5, 1))
_case("identity", lambda r: [], lambda m: m.identity(3))
_case("tri", lambda r: [], lambda m: m.tri(4, 4, -1))
_case("indices", lambda r: [], lambda m: m.indices((3, 4)))
for _n in ("bartlett", "blackman", "hamming", "hanning"):
    _case(_n, lambda r: [], lambda m, n=_n: getattr(m, n)(7))
_case("kaiser", lambda r: [], lambda m: m.kaiser(7, 8.6))
_case("fromfunction", lambda r: [],
      lambda m: m.fromfunction(lambda i, j: i + 2 * j, (3, 3)))
_case("frombuffer", lambda r: [],
      lambda m: m.frombuffer(np.arange(6, dtype=f32).tobytes(),
                             dtype="float32"))
_case("from_dlpack", lambda r: [_f(r, 3)], lambda m, a: m.from_dlpack(a))
for _n in ("zeros_like", "ones_like"):
    _case(_n, lambda r: [_f(r, 2, 3)], _one(_n))
_case("empty_like", lambda r: [_i(r, 2, 3)],
      lambda m, a: (m.empty_like(a).shape, str(m.empty_like(a).dtype)), "x")
_case("full_like", lambda r: [_i(r, 2, 3)], lambda m, a: m.full_like(a, 2))
_case("meshgrid", lambda r: [_f(r, 3), _f(r, 4)], _two("meshgrid"))
_case("tril", lambda r: [_f(r, 4, 4)], _one("tril"))
_case("triu", lambda r: [_f(r, 4, 4)], lambda m, a: m.triu(a, 1))
_case("diag", lambda r: [_f(r, 4)], _one("diag"))
_case("diagflat", lambda r: [_f(r, 2, 2)], _one("diagflat"))
_case("diagonal", lambda r: [_f(r, 3, 4, 5)],
      lambda m, a: m.diagonal(a, 1, 1, 2))
_case("vander", lambda r: [_f(r, 4)], lambda m, a: m.vander(a, 3))

_case("reshape", lambda r: [_f(r, 3, 4)], lambda m, a: m.reshape(a, (2, 6)))
_case("ravel", lambda r: [_f(r, 3, 4)], _one("ravel"))
_case("transpose", lambda r: [_f(r, 2, 3, 4)],
      lambda m, a: m.transpose(a, (2, 0, 1)))
_case("permute_dims", lambda r: [_f(r, 2, 3, 4)],
      lambda m, a: m.permute_dims(a, (1, 2, 0)))
_case("matrix_transpose", lambda r: [_f(r, 2, 3, 4)],
      _one("matrix_transpose"))
_case("swapaxes", lambda r: [_f(r, 2, 3, 4)],
      lambda m, a: m.swapaxes(a, 0, 2))
_case("moveaxis", lambda r: [_f(r, 2, 3, 4)],
      lambda m, a: m.moveaxis(a, 0, -1))
_case("rollaxis", lambda r: [_f(r, 2, 3, 4)],
      lambda m, a: m.rollaxis(a, 2, 0))
_case("expand_dims", lambda r: [_f(r, 3, 4)],
      lambda m, a: m.expand_dims(a, (0, 2)))
_case("squeeze", lambda r: [_f(r, 3, 1, 4)], _one("squeeze"))
_case("broadcast_to", lambda r: [_f(r, 4)],
      lambda m, a: m.broadcast_to(a, (3, 4)))
_case("broadcast_arrays", lambda r: [_f(r, 1, 4), _f(r, 3, 1)],
      _two("broadcast_arrays"))
_case("concatenate", lambda r: [_f(r, 2, 3), _f(r, 4, 3)],
      lambda m, a, b: m.concatenate([a, b], axis=0))
_case("concat", lambda r: [_f(r, 2, 3), _f(r, 2, 3)],
      lambda m, a, b: m.concat([a, b], axis=1))
_case("stack", lambda r: [_f(r, 2, 3), _f(r, 2, 3)],
      lambda m, a, b: m.stack([a, b], axis=1))
for _n in ("vstack", "hstack", "dstack", "column_stack"):
    _case(_n, lambda r: [_f(r, 3, 2), _f(r, 3, 2)],
          lambda m, a, b, n=_n: getattr(m, n)((a, b)))
for _n in ("atleast_1d", "atleast_2d", "atleast_3d"):
    _case(_n, lambda r: [_f(r, 3)], _one(_n))
_case("split", lambda r: [_f(r, 6, 2)], lambda m, a: m.split(a, 3))
_case("array_split", lambda r: [_f(r, 7, 2)],
      lambda m, a: m.array_split(a, 3))
_case("hsplit", lambda r: [_f(r, 2, 4)], lambda m, a: m.hsplit(a, 2))
_case("vsplit", lambda r: [_f(r, 4, 2)], lambda m, a: m.vsplit(a, [1, 3]))
_case("dsplit", lambda r: [_f(r, 2, 2, 4)], lambda m, a: m.dsplit(a, 2))
_case("unstack", lambda r: [_f(r, 3, 2)], _one("unstack"))
_case("tile", lambda r: [_f(r, 2, 3)], lambda m, a: m.tile(a, (2, 1, 2)))
_case("repeat", lambda r: [_f(r, 2, 3)], lambda m, a: m.repeat(a, 2, axis=1))
_case("flip", lambda r: [_f(r, 2, 3)], lambda m, a: m.flip(a, axis=1))
_case("fliplr", lambda r: [_f(r, 2, 3)], _one("fliplr"))
_case("flipud", lambda r: [_f(r, 2, 3)], _one("flipud"))
_case("roll", lambda r: [_f(r, 3, 4)], lambda m, a: m.roll(a, 2, axis=1))
_case("rot90", lambda r: [_f(r, 3, 4)], lambda m, a: m.rot90(a, 3))
_case("pad", lambda r: [_f(r, 3, 4)],
      lambda m, a: m.pad(a, ((1, 2), (3, 1)), mode="symmetric"))
_case("append", lambda r: [_f(r, 3, 2), _f(r, 1, 2)],
      lambda m, a, b: m.append(a, b, axis=0))
_case("insert", lambda r: [_f(r, 3, 4)],
      lambda m, a: m.insert(a, np.array([1, 3]), 7.0, axis=1))
_case("delete", lambda r: [_f(r, 3, 4)],
      lambda m, a: m.delete(a, np.array([0, 2]), axis=1))
_case("resize", lambda r: [_f(r, 2, 3)], lambda m, a: m.resize(a, (4, 5)))
_case("trim_zeros", lambda r: [np.array([0, 0, 1, 2, 0, 3, 0], f32)],
      _one("trim_zeros"))

_case("sort", lambda r: [_f(r, 3, 5)], lambda m, a: m.sort(a, axis=1))
_case("argsort", lambda r: [np.array([3, 1, 2, 1, 3, 0], f32)],
      _one("argsort"))
_case("sort_complex", lambda r: [_f(r, 5)], _one("sort_complex"))
_case("lexsort", lambda r: [_i(r, 6, hi=3), _i(r, 6, hi=3)],
      lambda m, a, b: m.lexsort((a, b)))
_case("partition", lambda r: [_f(r, 7)],
      lambda m, a: m.sort(m.partition(a, 3)[:3]))
_case("argpartition", lambda r: [_f(r, 7)],
      lambda m, a: m.sort(m.argpartition(a, 2)[:3]))
_case("unique", lambda r: [_i(r, 3, 4, hi=5)],
      lambda m, a: m.unique(a, return_index=True, return_inverse=True,
                            return_counts=True))
for _n in ("unique_all", "unique_counts", "unique_inverse", "unique_values"):
    _case(_n, lambda r: [_i(r, 3, 4, hi=5)], _one(_n))
_case("isin", lambda r: [_i(r, 3, 4), np.array([1, 2, 7], np.int32)],
      _two("isin"))
for _n in ("union1d", "intersect1d", "setdiff1d", "setxor1d"):
    _case(_n, lambda r: [_i(r, 8), _i(r, 5)], _two(_n))
_case("where", lambda r: [_f(r, 3, 4)],
      lambda m, a: m.where(a > 0, a, 0.0))
_case("nonzero", lambda r: [_f(r, 3, 4)], lambda m, a: m.nonzero(a > 0))
_case("flatnonzero", lambda r: [_f(r, 3, 4)],
      lambda m, a: m.flatnonzero(a > 0))
_case("argwhere", lambda r: [_f(r, 3, 4)], lambda m, a: m.argwhere(a > 0))
_case("extract", lambda r: [_f(r, 3, 4)], lambda m, a: m.extract(a > 0, a))
_case("compress", lambda r: [_f(r, 4, 3)],
      lambda m, a: m.compress(np.array([0, 1, 1, 0]), a, axis=0))
_case("searchsorted", lambda r: [np.sort(_f(r, 8)), _f(r, 5)],
      _two("searchsorted"))
_case("digitize", lambda r: [_f(r, 3, 4), np.array([-1, 0, 1], f32)],
      _two("digitize"))
_case("bincount", lambda r: [_i(r, 12, hi=6)], _one("bincount"))
_case("histogram", lambda r: [_f(r, 20)],
      lambda m, a: m.histogram(a, bins=5, range=(-3.0, 3.0)))
_case("histogram_bin_edges", lambda r: [_f(r, 20)],
      lambda m, a: m.histogram_bin_edges(a, bins=5))
_case("histogram2d", lambda r: [_f(r, 20), _f(r, 20)],
      lambda m, a, b: m.histogram2d(a, b, bins=4,
                                    range=((-3.0, 3.0), (-3.0, 3.0))))
_case("histogramdd", lambda r: [_f(r, 20, 2)],
      lambda m, a: m.histogramdd(a, bins=3)[0])
_case("interp", lambda r: [_f(r, 8), np.array([-2, 0, 2], f32),
                           np.array([0, 1, 4], f32)],
      lambda m, x, xp, fp: m.interp(x, xp, fp))
_case("clip", lambda r: [_f(r, 3, 4)], lambda m, a: m.clip(a, -0.5, None))
_case("astype", lambda r: [_f(r, 3, 4) * 10],
      lambda m, a: m.astype(a, "int32"))

_case("dot", lambda r: [_f(r, 3, 4), _f(r, 4, 5)], _two("dot"), "r")
_case("vdot", lambda r: [_f(r, 3, 4), _f(r, 3, 4)], _two("vdot"), "r")
_case("inner", lambda r: [_f(r, 3, 4), _f(r, 2, 4)], _two("inner"), "r")
_case("outer", lambda r: [_f(r, 3), _f(r, 4)], _two("outer"))
_case("matmul", lambda r: [_f(r, 2, 3, 4), _f(r, 4, 5)], _two("matmul"),
      "r")
_case("tensordot", lambda r: [_f(r, 3, 4, 5), _f(r, 4, 5, 2)],
      lambda m, a, b: m.tensordot(a, b, axes=([1, 2], [0, 1])), "r")
_case("einsum", lambda r: [_f(r, 3, 4), _f(r, 5, 4)],
      lambda m, a, b: m.einsum("ij,kj->ik", a, b), "r")
_case("kron", lambda r: [_f(r, 2, 2), _f(r, 2, 3)], _two("kron"))
_case("trace", lambda r: [_f(r, 4, 4)], _one("trace"), "r")
_case("vecdot", lambda r: [_f(r, 3, 4), _f(r, 3, 4)], _two("vecdot"), "r")
_case("cross", lambda r: [_f(r, 4, 3), _f(r, 4, 3)], _two("cross"))
_case("diff", lambda r: [_f(r, 3, 5)], lambda m, a: m.diff(a, 2, axis=1))
_case("ediff1d", lambda r: [_f(r, 6)],
      lambda m, a: m.ediff1d(a, to_begin=np.zeros(1, f32)))
_case("gradient", lambda r: [_f(r, 4, 5)],
      lambda m, a: m.gradient(a, 0.5))
_case("trapezoid", lambda r: [_f(r, 3, 5)],
      lambda m, a: m.trapezoid(a, dx=0.5, axis=1), "r")
_case("convolve", lambda r: [_f(r, 7), _f(r, 3)],
      lambda m, a, b: m.convolve(a, b, mode="same"), "r")
_case("correlate", lambda r: [_f(r, 4), _f(r, 6)],
      lambda m, a, b: m.correlate(a, b, mode="full"), "r")
_case("unwrap", lambda r: [_f(r, 8) * 3], _one("unwrap"), "r")
_case("cov", lambda r: [_f(r, 3, 6)], _one("cov"), "r")
_case("corrcoef", lambda r: [_f(r, 3, 6)], _one("corrcoef"), "r")

_case("take", lambda r: [_f(r, 3, 5), np.array([3, 0, 2], np.int32)],
      lambda m, a, i: m.take(a, i, axis=1))
_case("take_along_axis", lambda r: [_f(r, 3, 5)],
      lambda m, a: m.take_along_axis(a, m.argsort(a, axis=1), 1))
_case("put_along_axis", lambda r: [_f(r, 3, 5),
                                   np.array([[0], [2], [4]], np.int64)],
      lambda m, a, i: m.put_along_axis(a, i, 9.0, 1, inplace=False))
_case("choose", lambda r: [np.array([0, 1, 1, 0, 1], np.int32), _f(r, 5),
                           _f(r, 5)],
      lambda m, i, a, b: m.choose(i, [a, b]))
_case("select", lambda r: [_f(r, 3, 4)],
      lambda m, a: m.select([a > 1, a < -1], [a, -a], 0.0))
_case("piecewise", lambda r: [_f(r, 3, 4)],
      lambda m, a: m.piecewise(a, [a < 0, a >= 0],
                               [lambda v: -v, lambda v: v * 2]))
_case("unravel_index", lambda r: [np.array([5, 11, 19], np.int32)],
      lambda m, i: m.unravel_index(i, (4, 5)))
_case("ravel_multi_index", lambda r: [np.array([0, 1, 2], np.int32),
                                      np.array([3, 0, 4], np.int32)],
      lambda m, i, j: m.ravel_multi_index((i, j), (4, 5)))
_case("triu_indices", lambda r: [], lambda m: m.triu_indices(4, 1, 5))
_case("tril_indices", lambda r: [], lambda m: m.tril_indices(4, 0, 5))
_case("diag_indices", lambda r: [], lambda m: m.diag_indices(4))
for _n in ("triu_indices_from", "tril_indices_from", "diag_indices_from"):
    _case(_n, lambda r: [_f(r, 4, 4)], _one(_n))
_case("ix_", lambda r: [np.array([0, 2], np.int64),
                        np.array([1, 3], np.int64)], _two("ix_"))

for _n in ("shape", "ndim", "size", "iscomplexobj", "isrealobj"):
    _case(_n, lambda r: [_f(r, 3, 4)], _one(_n), "x")
_case("isscalar", lambda r: [], lambda m: m.isscalar(3.0), "x")
_case("broadcast_shapes", lambda r: [],
      lambda m: m.broadcast_shapes((3, 1), (1, 4)), "x")
_case("result_type", lambda r: [],
      lambda m: str(np.dtype(m.result_type("int32", "int8"))), "x")
_case("promote_types", lambda r: [],
      lambda m: str(np.dtype(m.promote_types("float32", "float64"))), "x")
_case("can_cast", lambda r: [], lambda m: m.can_cast("int32", "int64"), "x")
_case("isdtype", lambda r: [],
      lambda m: m.isdtype(np.dtype("float32"), "real floating"), "x")

_case("polyval", lambda r: [_f(r, 3), _f(r, 5)], _two("polyval"))
_case("polyadd", lambda r: [_f(r, 3), _f(r, 2)], _two("polyadd"))
_case("polysub", lambda r: [_f(r, 3), _f(r, 2)], _two("polysub"))
_case("polymul", lambda r: [_f(r, 3), _f(r, 2)], _two("polymul"), "r")
_case("polyder", lambda r: [_f(r, 4)], _one("polyder"))
_case("polyint", lambda r: [_f(r, 4)], _one("polyint"))
_case("polydiv", lambda r: [np.array([1, 3, 2], f32), np.array([1, 1], f32)],
      _two("polydiv"), "r")
_case("poly", lambda r: [np.array([1, 2, 3], f32)], _one("poly"), "r")
_case("roots", lambda r: [np.array([1, -6, 11, -6], f32)],
      lambda m, p: m.sort(m.real(m.roots(p))), "r")
_case("polyfit", lambda r: [np.arange(6, dtype=f32), _f(r, 6)],
      lambda m, x, y: m.polyfit(x, y, 2), "r")
_case("packbits", lambda r: [_i(r, 3, 10, hi=2).astype(np.uint8)],
      lambda m, a: m.packbits(a, axis=1))
_case("unpackbits", lambda r: [np.array([7, 200, 33], np.uint8)],
      _one("unpackbits"))
_case("apply_along_axis", lambda r: [_f(r, 3, 4)],
      lambda m, a: m.apply_along_axis(lambda v: v * 2 + 1, 1, a))
_case("apply_over_axes", lambda r: [_f(r, 3, 4)],
      lambda m, a: m.apply_over_axes(lambda v, ax: v.sum(ax, keepdims=True),
                                     a, [0]), "r")
_case("block", lambda r: [_f(r, 2, 2), _f(r, 2, 3)],
      lambda m, a, b: m.block([[a, b], [a, b]]))

for _n in ("fft", "ifft", "rfft", "ihfft"):
    _case("fft." + _n, lambda r: [_f(r, 4, 8)],
          lambda m, a, n=_n: getattr(m.fft, n)(a, axis=1), "r")
for _n in ("irfft", "hfft"):
    _case("fft." + _n, lambda r: [_f(r, 4, 5)],
          lambda m, a, n=_n: getattr(m.fft, n)(a, axis=1), "r")
for _n in ("fft2", "ifft2", "fftn", "ifftn", "rfft2", "irfft2", "rfftn",
           "irfftn"):
    _case("fft." + _n, lambda r: [_f(r, 4, 6)],
          lambda m, a, n=_n: getattr(m.fft, n)(a), "r")
_case("fft.fftfreq", lambda r: [], lambda m: m.fft.fftfreq(8, d=0.5))
_case("fft.rfftfreq", lambda r: [], lambda m: m.fft.rfftfreq(8, d=0.5))
_case("fft.fftshift", lambda r: [_f(r, 4, 5)],
      lambda m, a: m.fft.fftshift(a, axes=1))
_case("fft.ifftshift", lambda r: [_f(r, 4, 5)],
      lambda m, a: m.fft.ifftshift(a, axes=1))

for _n in ("inv", "det", "slogdet", "cholesky", "eigvalsh", "matrix_rank",
           "pinv", "cond", "svdvals", "matrix_norm", "norm", "vector_norm",
           "trace", "diagonal", "matrix_transpose"):
    _case("linalg." + _n, lambda r: [_spd(r)],
          lambda m, a, n=_n: getattr(m.linalg, n)(a), "r")
_case("linalg.solve", lambda r: [_spd(r), _f(r, 4, 2)],
      lambda m, a, b: m.linalg.solve(a, b), "r")
_case("linalg.lstsq", lambda r: [_f(r, 6, 3), _f(r, 6)],
      lambda m, a, b: m.linalg.lstsq(a, b), "r")
_case("linalg.matrix_power", lambda r: [_spd(r) / 8],
      lambda m, a: m.linalg.matrix_power(a, 3), "r")
_case("linalg.qr", lambda r: [_f(r, 5, 3)],
      lambda m, a: (lambda q, rr: (m.matmul(q, rr), m.abs(rr)))(
          *m.linalg.qr(a)), "r")
_case("linalg.svd", lambda r: [_f(r, 4, 3)],
      lambda m, a: (lambda u, s, vh: (s, m.matmul(u * s, vh)))(
          *m.linalg.svd(a, full_matrices=False)), "r")
_case("linalg.eigh", lambda r: [_spd(r)],
      lambda m, a: (lambda w, v: (w, m.matmul(v * w, m.transpose(v))))(
          *m.linalg.eigh(a)), "r")
_case("linalg.eig", lambda r: [_spd(r)],
      lambda m, a: m.sort(m.real(m.linalg.eig(a)[0])), "r")
_case("linalg.eigvals", lambda r: [_spd(r)],
      lambda m, a: m.sort(m.real(m.linalg.eigvals(a))), "r")
_case("linalg.tensorinv", lambda r: [_spd(r).reshape(4, 2, 2)],
      lambda m, a: m.linalg.tensorinv(a, ind=1), "r")
_case("linalg.tensorsolve", lambda r: [_spd(r).reshape(2, 2, 4), _f(r, 2, 2)],
      lambda m, a, b: m.linalg.tensorsolve(a, b), "r")
_case("linalg.multi_dot", lambda r: [_f(r, 3, 4), _f(r, 4, 5), _f(r, 5, 2)],
      lambda m, a, b, c: m.linalg.multi_dot([a, b, c]), "r")
_case("linalg.cross", lambda r: [_f(r, 4, 3), _f(r, 4, 3)],
      lambda m, a, b: m.linalg.cross(a, b))
_case("linalg.outer", lambda r: [_f(r, 3), _f(r, 4)],
      lambda m, a, b: m.linalg.outer(a, b))
_case("linalg.matmul", lambda r: [_f(r, 3, 4), _f(r, 4, 2)],
      lambda m, a, b: m.linalg.matmul(a, b), "r")
_case("linalg.tensordot", lambda r: [_f(r, 3, 4), _f(r, 4, 2)],
      lambda m, a, b: m.linalg.tensordot(a, b, axes=1), "r")
_case("linalg.vecdot", lambda r: [_f(r, 3, 4), _f(r, 3, 4)],
      lambda m, a, b: m.linalg.vecdot(a, b), "r")
del _n


def names():
    """Every case's name, sorted."""
    return sorted(CASES)


def leaves(v, out=None):
    """The arrays and host values of a result, nested lists and tuples
    flattened."""
    out = [] if out is None else out
    if isinstance(v, (list, tuple)):
        for u in v:
            leaves(u, out)
    else:
        out.append(v)
    return out


def to_numpy(vals):
    return [v.asnumpy() if hasattr(v, "asnumpy") else np.asarray(v)
            for v in vals]


def inputs(name, seed=0):
    """The numpy inputs of case ``name`` (seeded by the name)."""
    arrays = CASES[name][0]
    return arrays(np.random.RandomState(seed + sum(map(ord, name))))


def call(m, name, xs):
    """Case ``name`` through the module ``m`` on inputs already made
    arrays (``m.array``)."""
    return CASES[name][1](m, *xs)


def run(m, name, ctx=None, seed=0):
    """Case ``name`` through ``m`` (under ``with ctx:`` when given): its
    outputs as numpy arrays."""
    import contextlib
    with ctx if ctx is not None else contextlib.nullcontext():
        xs = [m.array(a) for a in inputs(name, seed)]
        return to_numpy(leaves(call(m, name, xs)))


def close(name, got, want):
    """(worst error over max |want| of each output, bound, dtypes equal)."""
    kind = CASES[name][2]
    if len(got) != len(want):
        return float("inf"), TOL[kind], False
    worst = 0.0
    for g, w in zip(got, want):
        g, w = np.asarray(g), np.asarray(w)
        if g.shape != w.shape:
            return float("inf"), TOL[kind], False
        if w.dtype.kind in "biuUSO" or kind == "x":
            if not np.array_equal(g, w, equal_nan=w.dtype.kind in "fc"):
                worst = float("inf")
            continue
        if not w.size:
            continue
        scale = max(float(np.nanmax(np.abs(w))), 1e-30)
        d = np.abs(g.astype(np.complex128) - w.astype(np.complex128))
        nan_ok = np.isnan(g) == np.isnan(w)
        if not nan_ok.all():
            worst = float("inf")
            continue
        worst = max(worst, float(np.nanmax(d, initial=0.0)) / scale)
    same = [np.asarray(g).dtype for g in got] == \
        [np.asarray(w).dtype for w in want]
    return worst, TOL[kind], same
