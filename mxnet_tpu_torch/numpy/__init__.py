"""mx.np — the NumPy-compatible array API over torch (the port of
``mxnet_tpu/numpy/__init__.py``).

The reference delegates each function to ``jax.numpy``; the port writes it
on torch (``_impl.py``, ``_linalg_impl.py``, ``_fft_impl.py``) and binds it
as the registry op ``np.<name>`` (``_dispatch.py``), so autograd,
hybridized blocks, amp's cast hook, the monitors, telemetry and the
profiler see ``mx.np`` calls as they see ``mx.nd`` ops.  The registry
holds the reference's 370 ``np.*`` names; ``mx.nd`` and ``mx.sym`` get no
``np`` namespace from them.  ``mx.np.ndarray`` is ``NDArray``: nd and np
share one array type, as in the reference.

Arrays are made on the current context (the card unless ``with
mx.cpu():``) or on ``ctx=`` / ``device=``; a function of arrays runs on
their device.  dtypes follow ``jnp`` as the reference runs it, except that
a float result the reference takes from its x64 default float is float32
here (``_impl.py``; ROADMAP C.7).  ``np.random`` draws from the device's
``torch.Generator`` (``mx.random``).  ``put``, ``place``,
``fill_diagonal`` and ``put_along_axis`` return the updated copy and leave
their input as it was, which is the reference's contract (``jnp`` arrays
are immutable).  ``vectorize`` maps its function over the broadcast
elements with ``torch.vmap``, as ``jnp.vectorize`` maps with ``vmap``.
"""

from __future__ import annotations

import builtins as _builtins  # this module shadows any/all/min/max/sum
import sys as _sys

import numpy as _onp
import torch as _torch

from ..base import MXNetError, torch_dtype as _torch_dtype
from ..context import current_context
from ..ndarray.ndarray import NDArray, array as _nd_array
from . import _impl
from ._dispatch import dispatch as _dispatch, host as _host, \
    tensor_of as _tensor_of

ndarray = NDArray  # mx.np.ndarray is the same array type

float32 = _onp.float32
float64 = _onp.float64
float16 = _onp.float16
int8 = _onp.int8
int32 = _onp.int32
int64 = _onp.int64
uint8 = _onp.uint8
bool_ = _onp.bool_
pi = _onp.pi
inf = _onp.inf
nan = _onp.nan
newaxis = None


def array(object, dtype=None, ctx=None, device=None):  # noqa: A002
    """An array holding a copy of ``object``: Python ints stay int64,
    Python floats become float32, and a source with its own dtype (numpy,
    NDArray) keeps it."""
    if dtype is None and not isinstance(object, NDArray) \
            and not hasattr(object, "dtype"):
        inferred = _onp.asarray(object).dtype
        dtype = _onp.float32 if inferred.kind == "f" else inferred
    return _nd_array(object, ctx=ctx if ctx is not None else device,
                     dtype=dtype)


def asarray(object, dtype=None, ctx=None, device=None):  # noqa: A002
    """:func:`array`'s rule (Python floats float32)."""
    return array(object, dtype=dtype, ctx=ctx, device=device)


ascontiguousarray = asarray

# integer- and bool-valued functions: never recorded
_NONDIFF = {
    "all", "any", "allclose", "argmax", "argmin", "argpartition", "argsort",
    "argwhere", "array_equal", "array_equiv", "bincount", "bitwise_and",
    "bitwise_count", "bitwise_invert", "bitwise_left_shift", "bitwise_not",
    "bitwise_or", "bitwise_right_shift", "bitwise_xor", "count_nonzero",
    "diag_indices", "diag_indices_from", "digitize", "equal", "flatnonzero",
    "gcd", "greater", "greater_equal", "histogram", "histogram2d",
    "histogramdd", "indices", "invert", "isclose", "iscomplex", "isfinite",
    "isin", "isinf", "isnan", "isneginf", "isposinf", "isreal", "ix_",
    "lcm", "left_shift", "less", "less_equal", "lexsort", "logical_and",
    "logical_not", "logical_or", "logical_xor", "nanargmax", "nanargmin",
    "nonzero", "not_equal", "packbits", "ravel_multi_index", "right_shift",
    "searchsorted", "signbit", "tril_indices", "tril_indices_from",
    "triu_indices", "triu_indices_from", "unique_counts", "unique_inverse",
    "unpackbits", "unravel_index",
}

# the reference's registered np.* names of the main namespace (its
# _NP_FUNCS that jnp has); each is bound from _impl below
_FUNCS = (
    "abs absolute acos acosh add all allclose amax amin angle any append "
    "apply_along_axis apply_over_axes arange arccos arccosh arcsin arcsinh "
    "arctan arctan2 arctanh argmax argmin argpartition argsort argwhere "
    "around array_equal array_equiv array_split asin asinh astype atan atan2 "
    "atanh atleast_1d atleast_2d atleast_3d average bartlett bincount "
    "bitwise_and bitwise_count bitwise_invert bitwise_left_shift bitwise_not "
    "bitwise_or bitwise_right_shift bitwise_xor blackman block "
    "broadcast_arrays broadcast_to cbrt ceil choose clip column_stack "
    "compress concat concatenate conj conjugate convolve copy copysign "
    "corrcoef correlate cos cosh count_nonzero cov cross cumprod cumsum "
    "cumulative_prod cumulative_sum deg2rad degrees delete diag diag_indices "
    "diag_indices_from diagflat diagonal diff digitize divide divmod dot "
    "dsplit dstack ediff1d einsum empty empty_like equal exp exp2 "
    "expand_dims expm1 extract eye fabs fix flatnonzero flip fliplr flipud "
    "float_power floor floor_divide fmax fmin fmod frexp from_dlpack "
    "frombuffer fromfunction full full_like gcd geomspace gradient greater "
    "greater_equal hamming hanning heaviside histogram histogram2d "
    "histogram_bin_edges histogramdd hsplit hstack hypot i0 identity imag "
    "indices inner insert interp intersect1d invert isclose iscomplex "
    "isfinite isin isinf isnan isneginf isposinf isreal ix_ kaiser kron "
    "lcm ldexp left_shift less less_equal lexsort linspace log log10 log1p "
    "log2 logaddexp logaddexp2 logical_and logical_not logical_or "
    "logical_xor logspace matmul matrix_transpose max maximum mean median "
    "meshgrid min minimum mod modf moveaxis multiply nan_to_num nanargmax "
    "nanargmin nancumprod nancumsum nanmax nanmean nanmedian nanmin "
    "nanpercentile nanprod nanquantile nanstd nansum nanvar negative "
    "nextafter nonzero not_equal ones ones_like outer packbits pad "
    "partition percentile permute_dims piecewise poly polyadd polyder "
    "polydiv polyfit polyint polymul polysub polyval positive pow power "
    "prod ptp put_along_axis quantile rad2deg radians ravel "
    "ravel_multi_index real reciprocal remainder repeat reshape resize "
    "right_shift rint roll rollaxis roots rot90 round searchsorted select "
    "setdiff1d setxor1d sign signbit sin sinc sinh sort sort_complex "
    "spacing split sqrt square squeeze stack std subtract sum swapaxes take "
    "take_along_axis tan tanh tensordot tile trace transpose trapezoid tri "
    "tril tril_indices tril_indices_from trim_zeros triu triu_indices "
    "triu_indices_from true_divide trunc union1d unique unique_all "
    "unique_counts unique_inverse unique_values unpackbits unravel_index "
    "unstack unwrap vander var vdot vecdot vsplit vstack where zeros "
    "zeros_like").split()

_self = _sys.modules[__name__]
for _name in _FUNCS:
    setattr(_self, _name, _dispatch(_name, getattr(_impl, _name),
                                    _name not in _NONDIFF))
del _name


# -- functions whose answer is a host value ---------------------------------------

def _dt(x):
    """A numpy dtype (or bfloat16's torch dtype) of an array, a dtype or a
    Python scalar."""
    x = _tensor_of(x)
    if isinstance(x, _torch.Tensor):
        from ..base import numpy_dtype
        return numpy_dtype(x.dtype)
    if isinstance(x, _torch.dtype):
        from ..base import numpy_dtype
        return numpy_dtype(x)
    return _onp.dtype(x)


def _shape_of(a):
    a = _tensor_of(a)
    return tuple(a.shape) if hasattr(a, "shape") else _onp.shape(a)


shape = _host("shape", _shape_of)
ndim = _host("ndim", lambda a: len(_shape_of(a)))
size = _host("size", lambda a, axis=None: int(_onp.prod(_shape_of(a)))
             if axis is None else _shape_of(a)[axis])
broadcast_shapes = _host(
    "broadcast_shapes",
    lambda *shapes: tuple(_torch.broadcast_shapes(*shapes)))


def _isscalar(element):
    return _onp.isscalar(element)


isscalar = _host("isscalar", _isscalar)


def _iscomplexobj(x):
    x = _tensor_of(x)
    if isinstance(x, _torch.Tensor):
        return x.is_complex()
    return _onp.iscomplexobj(x)


iscomplexobj = _host("iscomplexobj", _iscomplexobj)
isrealobj = _host("isrealobj", lambda x: not _iscomplexobj(x))


def _torch_of(d):
    return d if isinstance(d, _torch.dtype) else _torch_dtype(d)


def _result_type(*arrays_and_dtypes):
    """The promoted dtype (``jnp``'s lattice, which ``torch.promote_types``
    matches for the pairs the parity tests hold); Python scalars are weak."""
    strong, weak = [], []
    for v in arrays_and_dtypes:
        v = _tensor_of(v)
        if isinstance(v, (bool, int, float, complex)):
            weak.append(v)
        else:
            strong.append(_torch_of(v.dtype) if isinstance(
                v, _torch.Tensor) else _torch_of(_dt(v)))
    if not strong:
        strong = [_torch.tensor(weak[0]).dtype if not isinstance(
            weak[0], float) else _torch.float32]
        weak = weak[1:]
    dt = strong[0]
    for d in strong[1:]:
        dt = _torch.promote_types(dt, d)
    for w in weak:
        dt = _torch.result_type(_torch.empty(0, dtype=dt), w)
    return _dt(dt)


result_type = _host("result_type", _result_type)
promote_types = _host("promote_types", lambda type1, type2: _result_type(
    _dt(type1), _dt(type2)))


def _can_cast(from_, to, casting="safe"):
    src = _tensor_of(from_)
    src = _dt(src.dtype) if isinstance(src, _torch.Tensor) else _dt(src)
    return bool(_onp.can_cast(src, _dt(to), casting))


can_cast = _host("can_cast", _can_cast)

_KINDS = {"bool": "b", "signed integer": "i", "unsigned integer": "u",
          "integral": "iu", "real floating": "f", "complex floating": "c",
          "numeric": "iufc"}


def _isdtype(dtype, kind):
    d = _dt(dtype)
    if isinstance(kind, tuple):
        return _builtins.any(_isdtype(d, k) for k in kind)
    if isinstance(kind, str):
        if kind not in _KINDS:
            raise MXNetError(f"isdtype: unknown kind {kind!r}")
        return d.kind in _KINDS[kind]
    return d == _dt(kind)


isdtype = _host("isdtype", _isdtype)


def issubdtype(arg1, arg2):
    return _onp.issubdtype(arg1, arg2)


def iterable(y):
    try:
        iter(y)
    except TypeError:
        return False
    return True


def array_repr(arr, *args, **kwargs):
    a = arr.asnumpy() if isinstance(arr, NDArray) else _onp.asarray(
        _tensor_of(arr).detach().cpu() if isinstance(
            arr, _torch.Tensor) else arr)
    return _onp.array_repr(a, *args, **kwargs)


def array_str(a, *args, **kwargs):
    v = a.asnumpy() if isinstance(a, NDArray) else _onp.asarray(
        _tensor_of(a).detach().cpu() if isinstance(a, _torch.Tensor) else a)
    return _onp.array_str(v, *args, **kwargs)


def einsum_path(subscripts, *operands, optimize="greedy", **kwargs):
    """numpy's contraction order (a plan on shapes: the operands are read
    to the host)."""
    ops = [o.asnumpy() if isinstance(o, NDArray) else _onp.asarray(o)
           for o in operands]
    return _onp.einsum_path(subscripts, *ops, optimize=optimize, **kwargs)


def fromiter(iterable, dtype, count=-1, ctx=None):
    """An array of the values an iterator yields (consumed on the host)."""
    return array(_onp.fromiter(iterable, dtype=dtype, count=count),
                 ctx=ctx)


def mask_indices(n, mask_func, k=0, ctx=None):
    """The indices where ``mask_func(ones((n, n)), k)`` is non-zero."""
    m = ones((n, n), ctx=ctx)
    out = mask_func(m, k)
    return nonzero(out if isinstance(out, NDArray) else array(out, ctx=ctx))


# -- numpy's in-place writers, as the reference binds them: the updated copy --

def _put(a, ind, v, mode="clip"):
    x = _impl._a(a)
    flat = x.reshape(-1).clone()
    idx = _impl._a(ind).reshape(-1).to(_torch.int64)
    n = flat.shape[0]
    if mode == "wrap":
        idx = _torch.remainder(idx, n)
    else:
        idx = _torch.where(idx < 0, idx + n, idx).clamp(0, n - 1)
    vals = _impl._a(v).reshape(-1).to(x.dtype)
    vals = vals.repeat(-(-idx.shape[0] // vals.shape[0]))[:idx.shape[0]]
    return flat.index_put((idx,), vals).reshape(x.shape)


def _place(arr, mask, vals):
    x = _impl._a(arr)
    m = _impl._a(mask).reshape(-1) != 0
    pos = m.nonzero().reshape(-1)
    v = _impl._a(vals).reshape(-1).to(x.dtype)
    v = v.repeat(-(-pos.shape[0] // _builtins.max(v.shape[0], 1)))[
        :pos.shape[0]]
    return x.reshape(-1).clone().index_put((pos,), v).reshape(x.shape)


def _fill_diagonal(a, val, wrap=False):
    x = _impl._a(a)
    if x.ndim == 2:
        step = x.shape[1] + 1
        end = None if wrap else x.shape[1] * x.shape[1]
    else:
        step = 1 + int(_onp.cumprod(x.shape[:-1]).sum())
        end = None
    flat = x.reshape(-1).clone()
    pos = _torch.arange(0, flat.shape[0] if end is None else _builtins.min(
        end, flat.shape[0]), step, device=x.device)
    v = _impl._a(val).reshape(-1).to(x.dtype)
    v = v.repeat(-(-pos.shape[0] // v.shape[0]))[:pos.shape[0]]
    return flat.index_put((pos,), v).reshape(x.shape)


put = _dispatch("put", _put, register=False)
place = _dispatch("place", _place, register=False)
fill_diagonal = _dispatch("fill_diagonal", _fill_diagonal, register=False)


def vectorize(pyfunc, otypes=None, doc=None, excluded=None, cache=False,  # noqa: ARG001
              signature=None):
    """``pyfunc`` mapped over the broadcast elements of its array arguments
    with ``torch.vmap`` (``jnp.vectorize`` maps with ``vmap``): it sees 0-d
    tensors.  ``excluded`` arguments pass through whole; a gufunc
    ``signature`` is not supported."""
    if signature is not None:
        raise MXNetError("vectorize: signature= is not supported")
    excluded = set(excluded or ())

    def impl(*args, **kwargs):
        pos = [i for i, a in enumerate(args)
               if i not in excluded and isinstance(a, _torch.Tensor)]
        ts = _torch.broadcast_tensors(*[args[i] for i in pos])
        shape = ts[0].shape if ts else ()
        flat = [t.reshape(-1) for t in ts]

        def one(*elems):
            full = list(args)
            for i, e in zip(pos, elems):
                full[i] = e
            return pyfunc(*full, **kwargs)
        out = _torch.vmap(one)(*flat)
        if isinstance(out, tuple):
            return tuple(o.reshape(shape) for o in out)
        return out.reshape(shape)

    fn = _dispatch("vectorize", impl, register=False)
    fn.__doc__ = getattr(pyfunc, "__doc__", None)
    return fn


from . import fft, linalg, random  # noqa: E402,F401
