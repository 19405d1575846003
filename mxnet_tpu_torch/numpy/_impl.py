"""The functions of ``mx.np`` over torch, each on ``torch.Tensor`` inputs.

``numpy/__init__.py`` binds every function here as the registry op
``np.<name>``: it replaces the caller's arrays by their tensors, calls the
function through ``registry.invoke`` (or, for the bare tensors of a
hybridized block, ``registry.invoke_arrays``) and wraps what comes back.
The device of a call (the first array's, else the current context's) is
:func:`_dev`; arguments that are not tensors (Python numbers, lists, numpy
arrays) become tensors there as ``mx.np.array`` makes them.

dtypes follow ``jnp`` as the reference runs it, with one rule of the port
(ROADMAP C.7): where the reference's dtype comes only from its x64 default
float, the result is float32, as MXNet's ``mx.np`` gives.  So a creation
function without a dtype, true division of integers, the mean, std and
var of integers, a float function of int64 input, and the float outputs
of ``linspace``, ``histogram``'s edges and ``interp`` are float32.  A
Python number beside an array is weakly typed, as in ``jnp``
(``torch.result_type``).

Functions whose result's shape depends on the values (``unique``,
``nonzero``, ``argwhere``, ``extract``, ``trim_zeros``, ``flatnonzero``,
``compress`` and what is built on them) read a count from the device, as
any such function must.
"""

from __future__ import annotations

import builtins
import itertools
import math
import threading

import numpy as _onp
import torch
import torch.nn.functional as F

from ..base import MXNetError, torch_dtype
from ..context import current_context, resolve_device

_call = threading.local()
_F32 = torch.float32
# this module shadows max, min and sum with numpy's
_pymax, _pymin, _pysum = builtins.max, builtins.min, builtins.sum


def _dev():
    """The device of the call under way (outside a dispatched call, the
    current context's)."""
    dev = getattr(_call, "device", None)
    return dev if dev is not None else resolve_device(current_context())


def _is_t(x):
    return isinstance(x, torch.Tensor)


def _tdt(dtype):
    return None if dtype is None else torch_dtype(dtype)


def _a(x, dtype=None):
    """``x`` as a tensor on the call's device: a tensor as it is; anything
    else as ``mx.np.array`` makes it (Python floats float32, Python ints
    int64, a numpy array in its own dtype)."""
    if not _is_t(x):
        if isinstance(x, (list, tuple)) and x and _is_t(x[0]):
            x = torch.stack([_a(v) for v in x])
        else:
            arr = _onp.asarray(x)
            if arr.dtype.kind == "f" and not isinstance(
                    x, (_onp.ndarray, _onp.generic)):
                arr = arr.astype(_onp.float32)
            if arr.dtype.kind not in "biufc":
                raise MXNetError(f"mx.np: cannot make an array of {x!r}")
            x = torch.as_tensor(_onp.array(arr), device=_dev())
    if dtype is not None:
        x = x.to(_tdt(dtype))
    return x


def _is_int(t):
    return not (t.is_floating_point() or t.is_complex())


def _float(t):
    """``t`` in a float dtype: an integer or bool tensor as float32."""
    return t if not _is_int(t) else t.to(_F32)


def _lit(s, t):
    """A literal ``s`` beside the tensor ``t``: a Python number weakly
    typed (``torch.result_type``), as a 0-d tensor on ``t``'s device
    written by a fill (no copy from the host, so no wait for one);
    anything else an array on that device."""
    if isinstance(s, (bool, int, float, complex)) and not _is_t(s):
        return torch.full((), s, dtype=torch.result_type(t, s),
                          device=t.device)
    return _a(s).to(t.device)


def _filled(v, shape, t):
    """``v`` (a Python number or a tensor) broadcast to ``shape`` in
    ``t``'s dtype on its device; a number is written by a fill, not
    copied."""
    if _is_t(v):
        return torch.broadcast_to(v.to(t.device, t.dtype), shape)
    return torch.full(shape, v, dtype=t.dtype, device=t.device)


def _pair(a, b):
    if _is_t(a) and _is_t(b):
        return a, b
    if _is_t(a):
        return a, _lit(b, a)
    if _is_t(b):
        return _lit(a, b), b
    return _a(a), _a(b)


def _common(*ts):
    """``ts`` in their promoted dtype (``torch.promote_types``)."""
    dt = ts[0].dtype
    for t in ts[1:]:
        dt = torch.promote_types(dt, t.dtype)
    return [t.to(dt) for t in ts]


def _dims(axis, ndim):
    if axis is None:
        return tuple(range(ndim))
    axes = axis if isinstance(axis, (tuple, list)) else (axis,)
    return tuple(sorted(int(a) % ndim if ndim else 0 for a in axes))


def _over(x, axis, keepdims, f):
    """``f`` over the last axis of ``x`` with the ``axis`` dims moved last
    and flattened into one: reduces any set of axes with a reducer of one
    axis."""
    nd = x.ndim
    dims = _dims(axis, nd) if nd else ()
    keep = [d for d in range(nd) if d not in dims]
    t = x.permute(*keep, *dims).reshape(
        [x.shape[d] for d in keep] + [-1]) if nd else x.reshape(1)
    out = f(t)
    if keepdims:
        out = out.reshape([1 if d in dims else x.shape[d] for d in range(nd)])
    return out


def _flat_axis(x, axis):
    """(x, axis): a None axis flattens ``x`` and means its only axis."""
    if axis is None:
        return x.reshape(-1), 0
    return x, int(axis) % _pymax(x.ndim, 1)


def _mm(a, b):
    """matmul; integer operands on the card go through float64 (cuBLAS has
    no integer GEMM), exact while the sums stay below 2**53."""
    a, b = _common(a, b)
    if _is_int(a) and a.is_cuda:
        return torch.matmul(a.double(), b.double()).round().to(a.dtype)
    return torch.matmul(a, b)


def _tensordot(a, b, axes=2):
    a, b = _common(a, b)
    if _is_int(a) and a.is_cuda:
        return torch.tensordot(a.double(), b.double(), dims=axes).round() \
            .to(a.dtype)
    if isinstance(axes, (list, tuple)):
        axes = [list(ax) if isinstance(ax, (list, tuple)) else [ax]
                for ax in axes]
    return torch.tensordot(a, b, dims=axes)


# -- creation ------------------------------------------------------------------

def _shape(shape):
    if _is_t(shape):
        shape = shape.tolist()
    return (int(shape),) if isinstance(shape, (int, _onp.integer)) \
        else tuple(int(s) for s in shape)


def _fill_dtype(v):
    if _is_t(v):
        return v.dtype
    if isinstance(v, bool):
        return torch.bool
    if isinstance(v, int):
        return torch.int64
    if isinstance(v, complex):
        return torch.complex64
    if isinstance(v, (_onp.ndarray, _onp.generic)):
        return _a(v).dtype
    return _F32


def zeros(shape, dtype=None, order="C"):  # noqa: ARG001
    return torch.zeros(_shape(shape), dtype=_tdt(dtype) or _F32,
                       device=_dev())


def ones(shape, dtype=None, order="C"):  # noqa: ARG001
    return torch.ones(_shape(shape), dtype=_tdt(dtype) or _F32,
                      device=_dev())


empty = zeros


def full(shape, fill_value, dtype=None, order="C"):  # noqa: ARG001
    dt = _tdt(dtype) or _fill_dtype(fill_value)
    if _is_t(fill_value):
        return torch.broadcast_to(fill_value.to(dt), _shape(shape)).clone()
    return torch.full(_shape(shape), fill_value, dtype=dt, device=_dev())


def zeros_like(a, dtype=None, shape=None):
    a = _a(a)
    return torch.zeros(_shape(shape) if shape is not None else a.shape,
                       dtype=_tdt(dtype) or a.dtype, device=a.device)


def ones_like(a, dtype=None, shape=None):
    a = _a(a)
    return torch.ones(_shape(shape) if shape is not None else a.shape,
                      dtype=_tdt(dtype) or a.dtype, device=a.device)


empty_like = zeros_like


def full_like(a, fill_value, dtype=None, shape=None):
    a = _a(a)
    out = torch.empty(_shape(shape) if shape is not None else a.shape,
                      dtype=_tdt(dtype) or a.dtype, device=a.device)
    if _is_t(fill_value):
        return out.copy_(fill_value)
    return out.fill_(fill_value)


def copy(a, order="K"):  # noqa: ARG001
    return _a(a).clone()


def arange(start, stop=None, step=None, dtype=None):
    if stop is None:
        start, stop = 0, start
    step = 1 if step is None else step
    vals = [v.item() if _is_t(v) else v for v in (start, stop, step)]
    isint = builtins.all(isinstance(v, (int, _onp.integer)) for v in vals)
    dt = _tdt(dtype) or (torch.int64 if isint else _F32)
    if isint:
        return torch.arange(*vals, dtype=torch.int64, device=_dev()).to(dt)
    n = _pymax(int(math.ceil((vals[1] - vals[0]) / vals[2])), 0)
    return (vals[0] + vals[2] * torch.arange(
        n, dtype=torch.float64, device=_dev())).to(dt)


def _lin(start, stop, num, endpoint, axis):
    """numpy's linspace in float64, start and stop scalars or arrays."""
    if isinstance(start, (int, float)) and isinstance(stop, (int, float)):
        # scalar ends: computed on the device from Python numbers
        div = (num - 1) if endpoint else num
        step = (stop - start) / div if div > 0 else float("nan")
        i = torch.arange(num, dtype=torch.float64, device=_dev())
        y = start + i * step if div > 0 else start + i * (stop - start)
        if endpoint and num > 1:
            y[-1:].fill_(float(stop))       # a fill: no copy from the host
        return y, torch.full((), step, dtype=torch.float64, device=_dev())
    s = _a(start).double()
    e = _a(stop).double()
    s, e = torch.broadcast_tensors(s, e)
    div = (num - 1) if endpoint else num
    step = (e - s) / div if div > 0 else torch.full_like(s, float("nan"))
    i = torch.arange(num, dtype=torch.float64, device=s.device).reshape(
        (-1,) + (1,) * s.ndim)
    y = s + i * step if div > 0 else s + i * (e - s)
    if endpoint and num > 1:
        y[-1] = e
    return torch.movedim(y, 0, axis) if s.ndim else y, step


def linspace(start, stop, num=50, endpoint=True, retstep=False, dtype=None,
             axis=0):
    y, step = _lin(start, stop, int(num), endpoint, axis)
    dt = _tdt(dtype) or _F32
    if retstep:
        return y.to(dt), step.to(dt)
    return y.to(dt)


def logspace(start, stop, num=50, endpoint=True, base=10.0, dtype=None,
             axis=0):
    y, _ = _lin(start, stop, int(num), endpoint, axis)
    return torch.pow(float(base), y).to(_tdt(dtype) or _F32)


def geomspace(start, stop, num=50, endpoint=True, dtype=None, axis=0):
    s, e = float(start), float(stop)
    sign = -1.0 if (s < 0 and e < 0) else 1.0
    y, _ = _lin(math.log10(sign * s), math.log10(sign * e), int(num),
                endpoint, axis)
    y = sign * torch.pow(10.0, y)
    if num > 0:
        y[:1].fill_(s)
        if endpoint and num > 1:
            y[-1:].fill_(e)
    return y.to(_tdt(dtype) or _F32)


def eye(N, M=None, k=0, dtype=None, order="C"):  # noqa: ARG001,N803
    M = N if M is None else M
    r = torch.arange(N, device=_dev())[:, None]
    c = torch.arange(M, device=_dev())[None, :]
    return (r + k == c).to(_tdt(dtype) or _F32)


def identity(n, dtype=None):
    return eye(n, dtype=dtype)


def tri(N, M=None, k=0, dtype=None):  # noqa: N803
    M = N if M is None else M
    r = torch.arange(N, device=_dev())[:, None]
    c = torch.arange(M, device=_dev())[None, :]
    return (r + k >= c).to(_tdt(dtype) or _F32)


def tril(m, k=0):
    return torch.tril(_a(m), int(k))


def triu(m, k=0):
    return torch.triu(_a(m), int(k))


def diag(v, k=0):
    return torch.diag(_a(v), int(k))


def diagflat(v, k=0):
    return torch.diag(_a(v).reshape(-1), int(k))


def diagonal(a, offset=0, axis1=0, axis2=1):
    return torch.diagonal(_a(a), int(offset), int(axis1), int(axis2))


def meshgrid(*xi, copy=True, sparse=False, indexing="xy"):  # noqa: ARG001
    xs = [_a(x).reshape(-1) for x in xi]
    if sparse:
        n = len(xs)
        out = []
        for i, x in enumerate(xs):
            shape = [1] * n
            shape[i] = -1
            out.append(x.reshape(shape))
        if indexing == "xy" and n > 1:
            out[0], out[1] = out[0].reshape(1, -1, *([1] * (n - 2))), \
                out[1].reshape(-1, 1, *([1] * (n - 2)))
        return list(out)
    return list(torch.meshgrid(*xs, indexing=indexing))


def vander(x, N=None, increasing=False):  # noqa: N803
    x = _a(x).reshape(-1)
    if _is_int(x):
        x = x.to(torch.int64)
    n = x.shape[0] if N is None else int(N)
    if n == 0:
        return x.new_zeros((x.shape[0], 0))
    # powers as running products: their gradient is finite at x = 0
    cols = torch.cat([torch.ones_like(x)[:, None],
                      x[:, None].expand(x.shape[0], n - 1)], 1)
    v = torch.cumprod(cols, 1)
    return v if increasing else v.flip(1)


def indices(dimensions, dtype=int, sparse=False):
    dims = _shape(dimensions)
    dt = _tdt(dtype)
    grids = [torch.arange(d, device=_dev(), dtype=dt) for d in dims]
    if sparse:
        out = []
        for i, g in enumerate(grids):
            shape = [1] * len(dims)
            shape[i] = -1
            out.append(g.reshape(shape))
        return tuple(out)
    if not dims:
        return torch.zeros((0,), dtype=dt, device=_dev())
    return torch.stack(torch.meshgrid(*grids, indexing="ij"))


def fromfunction(function, shape, dtype=float, **kwargs):
    dt = _F32 if dtype is float else _tdt(dtype)
    return function(*indices(shape, dtype=dt), **kwargs)


def frombuffer(buffer, dtype=float, count=-1, offset=0):
    arr = _onp.frombuffer(buffer, dtype=dtype, count=count, offset=offset)
    return torch.as_tensor(arr.copy(), device=_dev())


def from_dlpack(x, device=None, copy=None):  # noqa: ARG001
    return x if _is_t(x) else torch.from_dlpack(x)


def _window(fn, M, **kw):
    M = int(M)
    if M < 1:
        return torch.zeros((0,), dtype=_F32, device=_dev())
    if M == 1:
        return torch.ones((1,), dtype=_F32, device=_dev())
    return fn(M, periodic=False, dtype=torch.float64, device=_dev(),
              **kw).to(_F32)


def bartlett(M):  # noqa: N803
    return _window(torch.bartlett_window, M)


def blackman(M):  # noqa: N803
    return _window(torch.blackman_window, M)


def hamming(M):  # noqa: N803
    return _window(torch.hamming_window, M)


def hanning(M):  # noqa: N803
    return _window(torch.hann_window, M)


def kaiser(M, beta):  # noqa: N803
    return _window(torch.kaiser_window, M, beta=float(beta))


# -- elementwise -----------------------------------------------------------------

def _unary(fn, to_float=True, name=None):
    def impl(x):
        x = _a(x)
        return fn(_float(x) if to_float else x)
    impl.__name__ = name or getattr(fn, "__name__", "unary")
    return impl


def _binary(fn, to_float=False):
    def impl(x1, x2):
        a, b = _pair(x1, x2)
        if to_float and _is_int(a) and _is_int(b):
            a, b = a.to(_F32), b.to(_F32)
        return fn(a, b)
    impl.__name__ = getattr(fn, "__name__", "binary")
    return impl


def _float_pair(x1, x2):
    """Both operands in one float dtype (their promoted one; integers
    float32)."""
    a, b = _pair(x1, x2)
    dt = torch.promote_types(a.dtype, b.dtype)
    if not (dt.is_floating_point or dt.is_complex):
        dt = _F32
    return a.to(dt), b.to(dt)


def _cbrt(x):
    return torch.sign(x) * torch.abs(x).pow(1.0 / 3.0)


sqrt = _unary(torch.sqrt)
cbrt = _unary(_cbrt, name="cbrt")
exp = _unary(torch.exp)
expm1 = _unary(torch.expm1)
exp2 = _unary(torch.exp2)
log = _unary(torch.log)
log2 = _unary(torch.log2)
log10 = _unary(torch.log10)
log1p = _unary(torch.log1p)
sin = _unary(torch.sin)
cos = _unary(torch.cos)
tan = _unary(torch.tan)
arcsin = asin = _unary(torch.asin)
arccos = acos = _unary(torch.acos)
arctan = atan = _unary(torch.atan)
sinh = _unary(torch.sinh)
cosh = _unary(torch.cosh)
tanh = _unary(torch.tanh)
arcsinh = asinh = _unary(torch.asinh)
arccosh = acosh = _unary(torch.acosh)
arctanh = atanh = _unary(torch.atanh)
degrees = rad2deg = _unary(torch.rad2deg)
radians = deg2rad = _unary(torch.deg2rad)
reciprocal = _unary(torch.reciprocal)
sinc = _unary(torch.sinc)
i0 = _unary(torch.special.i0)
fabs = _unary(torch.abs)
sign = _unary(torch.sign, to_float=False)
negative = _unary(torch.negative, to_float=False)
invert = bitwise_not = bitwise_invert = _unary(torch.bitwise_not,
                                                to_float=False)


def square(x):
    x = _a(x)
    return torch.square(x.to(torch.int32) if x.dtype == torch.bool else x)


def absolute(x):
    x = _a(x)
    return x.clone() if x.dtype == torch.bool else torch.abs(x)


abs = absolute  # noqa: A001


def positive(x):
    return _a(x).clone()


def _int_or(fn):
    def impl(x):
        x = _a(x)
        return x.clone() if _is_int(x) else fn(x)
    impl.__name__ = fn.__name__
    return impl


floor = _int_or(torch.floor)
ceil = _int_or(torch.ceil)
trunc = fix = _int_or(torch.trunc)
rint = _int_or(torch.round)


def around(a, decimals=0):
    x = _a(a)
    d = int(decimals)
    if _is_int(x):
        if d >= 0:
            return x.clone()
        f = 10 ** (-d)
        return (torch.round(x.double() / f) * f).to(x.dtype)
    return torch.round(x, decimals=d)


round = around  # noqa: A001


def spacing(x):
    x = _float(_a(x))
    inf = torch.full_like(x, float("inf"))
    return torch.where(x < 0, torch.nextafter(x, -inf) - x,
                       torch.nextafter(x, inf) - x)


def add(x1, x2):
    return torch.add(*_pair(x1, x2))


def subtract(x1, x2):
    a, b = _pair(x1, x2)
    if a.dtype == torch.bool or b.dtype == torch.bool:
        a, b = _common(a, b)
        if a.dtype == torch.bool:
            raise MXNetError("subtract: numpy boolean subtract is not "
                             "supported; use logical_xor")
    return torch.subtract(a, b)


def multiply(x1, x2):
    return torch.multiply(*_pair(x1, x2))


def divide(x1, x2):
    return torch.true_divide(*_float_pair(x1, x2))


true_divide = divide


def floor_divide(x1, x2):
    a, b = _pair(x1, x2)
    if a.dtype == torch.bool:
        a = a.to(torch.int64)
    # rounding division: its gradient is 0, as jnp's
    return torch.div(a, b, rounding_mode="floor")


def remainder(x1, x2):
    return torch.remainder(*_pair(x1, x2))


mod = remainder


def fmod(x1, x2):
    return torch.fmod(*_pair(x1, x2))


def divmod(x1, x2):  # noqa: A001
    return floor_divide(x1, x2), remainder(x1, x2)


def power(x1, x2):
    return torch.pow(*_pair(x1, x2))


pow = power  # noqa: A001


def float_power(x1, x2):
    return torch.pow(*_float_pair(x1, x2))


def maximum(x1, x2):
    return torch.maximum(*_common(*_pair(x1, x2)))


def minimum(x1, x2):
    return torch.minimum(*_common(*_pair(x1, x2)))


def fmax(x1, x2):
    return torch.fmax(*_common(*_pair(x1, x2)))


def fmin(x1, x2):
    return torch.fmin(*_common(*_pair(x1, x2)))


arctan2 = atan2 = _binary(lambda a, b: torch.atan2(*_common(a, b)),
                          to_float=True)
hypot = _binary(lambda a, b: torch.hypot(*_common(a, b)), to_float=True)
logaddexp = _binary(lambda a, b: torch.logaddexp(*_common(a, b)),
                    to_float=True)
logaddexp2 = _binary(lambda a, b: torch.logaddexp2(*_common(a, b)),
                     to_float=True)
copysign = _binary(lambda a, b: torch.copysign(*_common(a, b)),
                   to_float=True)
nextafter = _binary(lambda a, b: torch.nextafter(*_common(a, b)),
                    to_float=True)


def heaviside(x1, x2):
    a, b = _float_pair(x1, x2)
    return torch.where(a < 0, a.new_zeros(()),
                       torch.where(a > 0, a.new_ones(()), b))


def ldexp(x1, x2):
    a, b = _pair(x1, x2)
    a = _float(a)
    return a * torch.exp2(b.to(a.dtype))


def frexp(x):
    return torch.frexp(_float(_a(x)))


def modf(x):
    x = _float(_a(x))
    ip = torch.trunc(x)
    frac = torch.where(torch.isinf(x), torch.zeros_like(x), x - ip)
    return torch.copysign(frac, x), ip


def gcd(x1, x2):
    return torch.gcd(*_common(*_pair(x1, x2)))


def lcm(x1, x2):
    return torch.lcm(*_common(*_pair(x1, x2)))


def bitwise_and(x1, x2):
    return torch.bitwise_and(*_pair(x1, x2))


def bitwise_or(x1, x2):
    return torch.bitwise_or(*_pair(x1, x2))


def bitwise_xor(x1, x2):
    return torch.bitwise_xor(*_pair(x1, x2))


def left_shift(x1, x2):
    return torch.bitwise_left_shift(*_pair(x1, x2))


def right_shift(x1, x2):
    return torch.bitwise_right_shift(*_pair(x1, x2))


bitwise_left_shift = left_shift
bitwise_right_shift = right_shift


def bitwise_count(x):
    x = _a(x)
    v = torch.abs(x.to(torch.int64)) if x.dtype != torch.bool \
        else x.to(torch.int64)
    bits = 8 * x.element_size()
    n = _pysum((v >> i) & 1 for i in range(bits))
    return n.to(torch.uint8)


def _cmp(fn):
    def impl(x1, x2):
        return fn(*_pair(x1, x2))
    impl.__name__ = fn.__name__
    return impl


greater = _cmp(torch.gt)
greater_equal = _cmp(torch.ge)
less = _cmp(torch.lt)
less_equal = _cmp(torch.le)
equal = _cmp(torch.eq)
not_equal = _cmp(torch.ne)
logical_and = _cmp(torch.logical_and)
logical_or = _cmp(torch.logical_or)
logical_xor = _cmp(torch.logical_xor)


def logical_not(x):
    return torch.logical_not(_a(x))


def isclose(a, b, rtol=1e-05, atol=1e-08, equal_nan=False):
    a, b = _float_pair(a, b)
    return torch.isclose(a, b, rtol=rtol, atol=atol, equal_nan=equal_nan)


def allclose(a, b, rtol=1e-05, atol=1e-08, equal_nan=False):
    return isclose(a, b, rtol, atol, equal_nan).all()


def array_equal(a1, a2, equal_nan=False):
    a, b = _pair(a1, a2)
    if a.shape != b.shape:
        return torch.tensor(False, device=a.device)
    eq = a == b
    if equal_nan and not _is_int(a):
        eq = eq | (torch.isnan(a) & torch.isnan(b))
    return eq.all()


def array_equiv(a1, a2):
    a, b = _pair(a1, a2)
    try:
        a, b = torch.broadcast_tensors(a, b)
    except RuntimeError:
        return torch.tensor(False, device=a.device)
    return (a == b).all()


def isnan(x):
    return torch.isnan(_a(x))


def isinf(x):
    return torch.isinf(_a(x))


def isfinite(x):
    return torch.isfinite(_a(x))


def isposinf(x):
    return torch.isposinf(_a(x))


def isneginf(x):
    return torch.isneginf(_a(x))


def signbit(x):
    return torch.signbit(_a(x))


def iscomplex(x):
    x = _a(x)
    return x.imag != 0 if x.is_complex() else torch.zeros_like(
        x, dtype=torch.bool)


def isreal(x):
    x = _a(x)
    return x.imag == 0 if x.is_complex() else torch.ones_like(
        x, dtype=torch.bool)


def real(val):
    x = _a(val)
    return x.real if x.is_complex() else x


def imag(val):
    x = _a(val)
    return x.imag if x.is_complex() else torch.zeros_like(x)


def conj(x):
    x = _a(x)
    return torch.conj_physical(x) if x.is_complex() else x


conjugate = conj


def angle(z, deg=False):
    z = _a(z)
    out = torch.angle(_float(z))
    return torch.rad2deg(out) if deg else out


def clip(a, a_min=None, a_max=None, **kw):
    x = _a(a)
    lo = kw.get("min", a_min)
    hi = kw.get("max", a_max)
    if lo is None and hi is None:
        raise MXNetError("clip: one of a_min and a_max must be given")
    if not _is_t(lo) and not _is_t(hi) and builtins.all(
            isinstance(v, (int, float)) or v is None for v in (lo, hi)):
        # Python bounds: the scalar overload, in the promoted dtype
        dt = x.dtype
        for v in (lo, hi):
            if v is not None:
                dt = torch.result_type(torch.empty(0, dtype=dt), v)
        return torch.clamp(x.to(dt), lo, hi)
    lo = None if lo is None else _lit(lo, x)
    hi = None if hi is None else _lit(hi, x)
    dt = x.dtype
    for t in (lo, hi):
        if t is not None:
            dt = torch.promote_types(dt, t.dtype)
    x = x.to(dt)
    return torch.clamp(x, None if lo is None else lo.to(x.device, dt),
                       None if hi is None else hi.to(x.device, dt))


def nan_to_num(x, copy=True, nan=0.0, posinf=None, neginf=None):  # noqa: ARG001
    x = _a(x)
    if _is_int(x):
        return x.clone()
    return torch.nan_to_num(x, nan=nan, posinf=posinf, neginf=neginf)


def astype(x, dtype, copy=True):  # noqa: ARG001
    return _a(x).to(_tdt(dtype))


# -- reductions ----------------------------------------------------------------

def _acc_dtype(x, dtype):
    if dtype is not None:
        return _tdt(dtype)
    if _is_int(x):
        return torch.int64
    return None


def sum(a, axis=None, dtype=None, out=None, keepdims=False,  # noqa: A001,ARG001
        initial=None, where=None):
    x = _a(a)
    if where is not None:
        x = torch.where(_a(where), x, torch.zeros_like(x))
    dt = _acc_dtype(x, dtype)
    if axis is None:
        r = torch.sum(x, dtype=dt)
        if keepdims:
            r = r.reshape((1,) * x.ndim)
    else:
        r = torch.sum(x, dim=_dims(axis, x.ndim), keepdim=keepdims, dtype=dt)
    return r if initial is None else r + initial


def prod(a, axis=None, dtype=None, out=None, keepdims=False,  # noqa: ARG001
         initial=None, where=None):
    x = _a(a)
    if where is not None:
        x = torch.where(_a(where), x, torch.ones_like(x))
    dt = _acc_dtype(x, dtype)
    r = _over(x, axis, keepdims, lambda t: torch.prod(t, -1, dtype=dt))
    return r if initial is None else r * initial


def mean(a, axis=None, dtype=None, out=None, keepdims=False,  # noqa: ARG001
         where=None):
    x = _a(a)
    x = x.to(_tdt(dtype)) if dtype is not None else _float(x)
    if where is not None:
        w = _a(where).to(x.dtype)
        return sum(x * w, axis, keepdims=keepdims) / \
            sum(torch.broadcast_to(w, x.shape), axis, keepdims=keepdims)
    if axis is None:
        r = torch.mean(x)
        return r.reshape((1,) * x.ndim) if keepdims else r
    return torch.mean(x, dim=_dims(axis, x.ndim), keepdim=keepdims)


def _moment(fn):
    def impl(a, axis=None, dtype=None, out=None, ddof=0,  # noqa: ARG001
             keepdims=False, where=None, mean=None, correction=None):  # noqa: ARG001
        x = _a(a)
        x = x.to(_tdt(dtype)) if dtype is not None else _float(x)
        c = ddof if correction is None else correction
        if axis is None:
            r = fn(x, correction=c)
            return r.reshape((1,) * x.ndim) if keepdims else r
        return fn(x, dim=_dims(axis, x.ndim), correction=c, keepdim=keepdims)
    impl.__name__ = fn.__name__
    return impl


std = _moment(torch.std)
var = _moment(torch.var)


def _minmax(fn):
    def impl(a, axis=None, out=None, keepdims=False, initial=None,  # noqa: ARG001
             where=None):  # noqa: ARG001
        x = _a(a)
        if x.dtype == torch.bool:
            r = _over(x, axis, keepdims,
                      lambda t: (t.any(-1) if fn is torch.amax
                                 else t.all(-1)))
        elif axis is None:
            r = fn(x)
            if keepdims:
                r = r.reshape((1,) * x.ndim)
        else:
            r = fn(x, dim=_dims(axis, x.ndim), keepdim=keepdims)
        if initial is not None:
            r = (torch.maximum if fn is torch.amax else torch.minimum)(
                r, _lit(initial, r))
        return r
    impl.__name__ = fn.__name__
    return impl


max = amax = _minmax(torch.amax)  # noqa: A001
min = amin = _minmax(torch.amin)  # noqa: A001


def ptp(a, axis=None, out=None, keepdims=False):  # noqa: ARG001
    return amax(a, axis, keepdims=keepdims) - amin(a, axis, keepdims=keepdims)


def _arg(fn):
    def impl(a, axis=None, out=None, keepdims=False):  # noqa: ARG001
        x = _a(a)
        if axis is None:
            r = fn(x.reshape(-1), 0)
            return r.reshape((1,) * x.ndim) if keepdims else r
        return fn(x, int(axis), keepdim=keepdims)
    impl.__name__ = fn.__name__
    return impl


argmax = _arg(torch.argmax)
argmin = _arg(torch.argmin)


def _scan(fn, fill=None):
    def impl(a, axis=None, dtype=None, out=None):  # noqa: ARG001
        x = _a(a)
        x, ax = _flat_axis(x, axis)
        if fill is not None and not _is_int(x):
            x = torch.where(torch.isnan(x), torch.full_like(x, fill), x)
        dt = _tdt(dtype) if dtype is not None else (
            torch.int64 if x.dtype == torch.bool else x.dtype)
        if x.ndim == 0:
            x = x.reshape(1)
        return fn(x, ax, dtype=dt)
    impl.__name__ = fn.__name__
    return impl


cumsum = _scan(torch.cumsum)
cumprod = _scan(torch.cumprod)
nancumsum = _scan(torch.cumsum, 0.0)
nancumprod = _scan(torch.cumprod, 1.0)


def _cumulative(fn):
    def impl(x, axis=None, dtype=None, include_initial=False):
        x = _a(x)
        if axis is None:
            if x.ndim > 1:
                raise MXNetError("cumulative_*: axis is required for an "
                                 "array of more than one dimension")
            axis = 0
        r = fn(x, axis=axis, dtype=dtype)
        if include_initial:
            init = torch.zeros_like(r.narrow(int(axis), 0, 1)) \
                if fn is cumsum else torch.ones_like(r.narrow(int(axis), 0, 1))
            r = torch.cat([init, r], int(axis))
        return r
    return impl


cumulative_sum = _cumulative(cumsum)
cumulative_prod = _cumulative(cumprod)


def all(a, axis=None, out=None, keepdims=False, where=None):  # noqa: A001,ARG001
    x = _a(a) != 0
    return _over(x, axis, keepdims, lambda t: t.all(-1))


def any(a, axis=None, out=None, keepdims=False, where=None):  # noqa: A001,ARG001
    x = _a(a) != 0
    return _over(x, axis, keepdims, lambda t: t.any(-1))


def count_nonzero(a, axis=None, keepdims=False):
    x = _a(a) != 0
    return _over(x, axis, keepdims, lambda t: t.sum(-1, dtype=torch.int64))


def _nan_fill(x, v):
    return x if _is_int(x) else torch.where(torch.isnan(x),
                                            torch.full_like(x, v), x)


def nansum(a, axis=None, dtype=None, out=None, keepdims=False,  # noqa: ARG001
           initial=None, where=None):
    return sum(_nan_fill(_a(a), 0), axis, dtype, keepdims=keepdims,
               initial=initial, where=where)


def nanprod(a, axis=None, dtype=None, out=None, keepdims=False,  # noqa: ARG001
            initial=None, where=None):
    return prod(_nan_fill(_a(a), 1), axis, dtype, keepdims=keepdims,
                initial=initial, where=where)


def _valid(x):
    return torch.ones_like(x, dtype=torch.bool) if _is_int(x) \
        else ~torch.isnan(x)


def nanmean(a, axis=None, dtype=None, out=None, keepdims=False,  # noqa: ARG001
            where=None):  # noqa: ARG001
    x = _a(a)
    x = x.to(_tdt(dtype)) if dtype is not None else _float(x)
    n = sum(_valid(x), axis, keepdims=keepdims).to(x.dtype)
    return sum(_nan_fill(x, 0), axis, keepdims=keepdims) / n


def _nanmoment(root):
    def impl(a, axis=None, dtype=None, out=None, ddof=0,  # noqa: ARG001
             keepdims=False, where=None, mean=None, correction=None):  # noqa: ARG001
        x = _a(a)
        x = x.to(_tdt(dtype)) if dtype is not None else _float(x)
        c = ddof if correction is None else correction
        ok = _valid(x)
        n = sum(ok, axis, keepdims=True).to(x.dtype)
        m = sum(_nan_fill(x, 0), axis, keepdims=True) / n
        d = torch.where(ok, x - m, torch.zeros_like(x))
        v = sum(d * d.conj() if d.is_complex() else d * d, axis,
                keepdims=keepdims) / (
            (n if keepdims else n.reshape(
                sum(ok, axis, keepdims=False).shape)) - c)
        return torch.sqrt(v) if root else v
    return impl


nanvar = _nanmoment(False)
nanstd = _nanmoment(True)


def _nanext(fn, fill):
    def impl(a, axis=None, out=None, keepdims=False, initial=None,  # noqa: ARG001
             where=None):  # noqa: ARG001
        x = _a(a)
        if _is_int(x):
            return fn(x, axis, keepdims=keepdims)
        r = fn(_nan_fill(x, fill), axis, keepdims=keepdims)
        allnan = all(torch.isnan(x), axis, keepdims=keepdims)
        return torch.where(allnan, torch.full_like(r, float("nan")), r)
    return impl


nanmax = _nanext(amax, float("-inf"))
nanmin = _nanext(amin, float("inf"))


def nanargmax(a, axis=None, out=None, keepdims=False):  # noqa: ARG001
    return argmax(_nan_fill(_a(a), float("-inf")), axis, keepdims=keepdims)


def nanargmin(a, axis=None, out=None, keepdims=False):  # noqa: ARG001
    return argmin(_nan_fill(_a(a), float("inf")), axis, keepdims=keepdims)


def _lerp(a, b, t):
    """numpy's ``_lerp``: exact at both ends."""
    d = b - a
    return torch.where(t >= 0.5, b - d * (1 - t), a + d * t)


def _quantile(a, q, axis, method, keepdims, nan_aware):
    x = _float(_a(a))
    if not _is_t(q) and ((_onp.asarray(q) < 0).any()
                         or (_onp.asarray(q) > 1).any()):
        raise MXNetError("quantiles must be in the range [0, 1]")
    qt = torch.full((), float(q), dtype=x.dtype, device=x.device) \
        if isinstance(q, (int, float)) else (
            _a(q).to(x.dtype) if not _is_t(q) else q.to(x.dtype))
    nd = x.ndim
    dims = _dims(axis, nd) if nd else ()
    keep = [d for d in range(nd) if d not in dims]
    t = x.permute(*keep, *dims).reshape(
        [x.shape[d] for d in keep] + [-1]) if nd else x.reshape(1)
    s = torch.sort(t, -1).values            # NaN sorts last
    n = t.shape[-1]
    if nan_aware:
        cnt = (~torch.isnan(t)).sum(-1)
    else:
        cnt = torch.full(t.shape[:-1], n, device=t.device)
    qv = qt.reshape(qt.shape + (1,) * (t.ndim - 1))
    pos = qv * (cnt - 1).to(x.dtype)
    if method == "linear":
        lo = torch.floor(pos)
    elif method in ("lower", "higher", "nearest", "midpoint"):
        lo = torch.floor(pos)
    else:
        raise MXNetError(f"quantile: method {method!r} is not supported")
    hi = torch.ceil(pos)
    if method == "nearest":
        lo = hi = torch.round(pos)
    elif method == "lower":
        hi = lo
    elif method == "higher":
        lo = hi
    ilo = lo.long().clamp(0, n - 1)
    ihi = hi.long().clamp(0, n - 1)
    sb = s.expand(qt.shape + s.shape)
    vlo = torch.gather(sb, -1, ilo.unsqueeze(-1)).squeeze(-1)
    vhi = torch.gather(sb, -1, ihi.unsqueeze(-1)).squeeze(-1)
    if method == "midpoint":
        out = (vlo + vhi) / 2
    elif method == "linear":
        out = _lerp(vlo, vhi, pos - lo)
    else:
        out = vlo
    if not nan_aware:
        out = torch.where(torch.isnan(t).any(-1), torch.full_like(
            out, float("nan")), out)
    else:
        out = torch.where(cnt == 0, torch.full_like(out, float("nan")), out)
    if keepdims:
        out = out.reshape(qt.shape + tuple(1 if d in dims else x.shape[d]
                                           for d in range(nd)))
    return out


def quantile(a, q, axis=None, out=None, overwrite_input=False,  # noqa: ARG001
             method="linear", keepdims=False, interpolation=None):
    return _quantile(a, q, axis, interpolation or method, keepdims, False)


def percentile(a, q, axis=None, out=None, overwrite_input=False,  # noqa: ARG001
               method="linear", keepdims=False, interpolation=None):
    return _quantile(a, _a(q).double() / 100 if not isinstance(
        q, (int, float)) else q / 100, axis, interpolation or method,
        keepdims, False)


def nanquantile(a, q, axis=None, out=None, overwrite_input=False,  # noqa: ARG001
                method="linear", keepdims=False, interpolation=None):
    return _quantile(a, q, axis, interpolation or method, keepdims, True)


def nanpercentile(a, q, axis=None, out=None,  # noqa: ARG001
                  overwrite_input=False, method="linear",  # noqa: ARG001
                  keepdims=False, interpolation=None):
    return _quantile(a, _a(q).double() / 100 if not isinstance(
        q, (int, float)) else q / 100, axis, interpolation or method,
        keepdims, True)


def median(a, axis=None, out=None, overwrite_input=False,  # noqa: ARG001
           keepdims=False):
    return _quantile(a, 0.5, axis, "linear", keepdims, False)


def nanmedian(a, axis=None, out=None, overwrite_input=False,  # noqa: ARG001
              keepdims=False):
    return _quantile(a, 0.5, axis, "linear", keepdims, True)


def average(a, axis=None, weights=None, returned=False, keepdims=False):
    x = _float(_a(a))
    if weights is None:
        avg = mean(x, axis, keepdims=keepdims)
        if returned:
            return avg, torch.full_like(avg, x.numel() / _pymax(avg.numel(), 1))
        return avg
    w = _a(weights)
    if w.shape != x.shape:
        if axis is None:
            raise MXNetError("average: weights of another shape need an axis")
        shape = [1] * x.ndim
        shape[int(axis) % x.ndim] = -1
        w = w.reshape(shape)
    x, w = _common(x, _float(w))
    w = torch.broadcast_to(w, x.shape)
    scl = sum(w, axis, keepdims=keepdims)
    avg = sum(x * w, axis, keepdims=keepdims) / scl
    return (avg, scl) if returned else avg


def cov(m, y=None, rowvar=True, bias=False, ddof=None, fweights=None,
        aweights=None, dtype=None):
    x = _a(m)
    x = x.to(_tdt(dtype)) if dtype is not None else _float(x)
    if x.ndim == 1:
        x = x[None]
    if not rowvar and x.shape[0] != 1:
        x = x.T
    if y is not None:
        yy = _float(_a(y))
        if yy.ndim == 1:
            yy = yy[None]
        if not rowvar and yy.shape[0] != 1:
            yy = yy.T
        x = torch.cat(_common(x, yy), 0)
    c = (0 if bias else 1) if ddof is None else int(ddof)
    if fweights is None and aweights is None:
        # torch.cov reads its degrees of freedom to the host; this does not
        d = x - x.mean(1, keepdim=True)
        out = d @ d.mT.conj() / (x.shape[1] - c)
        return out.squeeze() if out.shape == (1, 1) else out
    return torch.cov(x, correction=c,
                     fweights=None if fweights is None else _a(fweights),
                     aweights=None if aweights is None else _float(
                         _a(aweights)).to(x.dtype))


def corrcoef(x, y=None, rowvar=True, dtype=None):
    c = cov(x, y, rowvar, dtype=dtype)
    if c.ndim == 0:
        return c / c
    d = torch.sqrt(torch.diagonal(c))
    c = c / d[:, None] / d[None, :]
    return torch.clamp(c, -1, 1) if not c.is_complex() else c


# -- histograms, counting --------------------------------------------------------

def _edges(x, bins, rng):
    """Bin edges, computed on the device (no read of min and max)."""
    dt = x.dtype if not _is_int(x) else _F32
    if _is_t(bins) or isinstance(bins, (list, tuple, _onp.ndarray)):
        return _float(_a(bins)).to(dt)
    n = int(bins)
    if rng is None:
        if x.numel():
            lo, hi = x.min().double(), x.max().double()
        else:
            lo = torch.zeros((), dtype=torch.float64, device=x.device)
            hi = lo + 1
        same = lo == hi
        lo, hi = torch.where(same, lo - 0.5, lo), torch.where(same, hi + 0.5,
                                                               hi)
    else:
        lo, hi = float(rng[0]), float(rng[1])
        if lo == hi:
            lo, hi = lo - 0.5, hi + 0.5
    i = torch.arange(n + 1, dtype=torch.float64, device=x.device)
    e = lo + (hi - lo) * i / n
    if _is_t(hi):
        e[-1] = hi
    else:
        e[-1:].fill_(hi)
    return e.to(dt)


def _bin_index(x, e):
    """The bin of each value of ``x`` over edges ``e`` (-1 outside; the last
    bin closed on the right, as numpy's)."""
    nb = e.shape[0] - 1
    idx = torch.bucketize(x.to(e.dtype).contiguous(), e, right=True) - 1
    idx = torch.where(x.to(e.dtype) == e[-1], torch.full_like(idx, nb - 1),
                      idx)
    inside = (x.to(e.dtype) >= e[0]) & (x.to(e.dtype) <= e[-1])
    return torch.where(inside, idx, torch.full_like(idx, -1))


def _count(idx, n, weights):
    """Counts (or weight sums) of the bins 0..n-1; -1 is dropped.  A
    scatter into n + 1 slots, so the output's size needs no read of the
    data."""
    slot = torch.where(idx >= 0, idx, torch.full_like(idx, n))
    if weights is None:
        src = torch.ones_like(slot)
        out = torch.zeros(n + 1, dtype=torch.int64, device=idx.device)
    else:
        src = weights.reshape(-1)
        out = torch.zeros(n + 1, dtype=src.dtype, device=idx.device)
    return out.scatter_add_(0, slot, src)[:n]


def histogram_bin_edges(a, bins=10, range=None, weights=None):  # noqa: A002,ARG001
    x = _a(a).reshape(-1)
    return _edges(x, bins, range)


def histogram(a, bins=10, range=None, weights=None, density=None):  # noqa: A002
    x = _a(a).reshape(-1)
    e = _edges(x, bins, range)
    w = None if weights is None else _a(weights)
    counts = _count(_bin_index(x, e).reshape(-1), e.shape[0] - 1, w)
    if density:
        counts = counts.to(e.dtype)
        counts = counts / (counts.sum() * torch.diff(e))
    return counts, e


def histogramdd(sample, bins=10, range=None, weights=None,  # noqa: A002
                density=None):
    s = _a(sample)
    if s.ndim == 1:
        s = s[:, None]
    D = s.shape[1]
    bins_l = bins if isinstance(bins, (list, tuple)) else [bins] * D
    rng = range if range is not None else [None] * D
    edges = [_edges(s[:, d], bins_l[d], rng[d]) for d in builtins.range(D)]
    nb = [e.shape[0] - 1 for e in edges]
    flat = torch.zeros(s.shape[0], dtype=torch.int64, device=s.device)
    ok = torch.ones(s.shape[0], dtype=torch.bool, device=s.device)
    for d in builtins.range(D):
        i = _bin_index(s[:, d], edges[d])
        ok &= i >= 0
        flat = flat * nb[d] + i.clamp(min=0)
    flat = torch.where(ok, flat, torch.full_like(flat, -1))
    w = None if weights is None else _a(weights)
    n = 1
    for b in nb:
        n *= b
    H = _count(flat, n, w).reshape(nb)
    if density:
        H = H.to(edges[0].dtype) / H.sum()
        for d in builtins.range(D):
            shape = [1] * D
            shape[d] = -1
            H = H / torch.diff(edges[d]).reshape(shape)
    return H, edges


def histogram2d(x, y, bins=10, range=None, weights=None, density=None):  # noqa: A002
    H, e = histogramdd(torch.stack(_common(_a(x).reshape(-1),
                                           _a(y).reshape(-1)), 1),
                       bins, range, weights, density)
    return H, e[0], e[1]


def bincount(x, weights=None, minlength=0, length=None):
    x = _a(x).reshape(-1).to(torch.int64)
    w = None if weights is None else _a(weights).reshape(-1)
    out = torch.bincount(x, weights=w, minlength=int(minlength or 0))
    if length is not None:
        out = out[:int(length)]
    return out if w is None else out.to(w.dtype if not _is_int(w) else _F32)


def digitize(x, bins, right=False):
    x, b = _a(x), _a(bins)
    xx = x.to(b.dtype).contiguous()
    up = torch.searchsorted(b, xx, right=not right, out_int32=True)
    if b.numel() < 2:
        return up
    n = b.shape[0]
    down = (n - torch.searchsorted(b.flip(0), xx, right=not right,
                                   out_int32=True)).to(torch.int32)
    return torch.where(b[0] > b[-1], down, up)


def searchsorted(a, v, side="left", sorter=None):
    a = _a(a)
    v = _lit(v, a).to(a.device) if not _is_t(v) else v
    a, v = _common(a, v)
    return torch.searchsorted(a, v.contiguous(), right=(side == "right"),
                              sorter=None if sorter is None else _a(sorter),
                              out_int32=True)


def interp(x, xp, fp, left=None, right=None, period=None):
    x, xp, fp = _a(x), _a(xp), _a(fp)
    dt = torch.promote_types(torch.promote_types(x.dtype, xp.dtype), fp.dtype)
    if not (dt.is_floating_point or dt.is_complex):
        dt = _F32
    x, xp, fp = x.to(dt), xp.to(dt), fp.to(dt)
    if period is not None:
        p = float(period)
        x = torch.remainder(x, p)
        xp = torch.remainder(xp, p)
        order = torch.argsort(xp, stable=True)
        xp, fp = xp[order], fp[order]
        xp = torch.cat([xp[-1:] - p, xp, xp[:1] + p])
        fp = torch.cat([fp[-1:], fp, fp[:1]])
    n = xp.shape[0]
    i = torch.searchsorted(xp, x.contiguous(), right=True).clamp(1, n - 1)
    x0, x1, y0, y1 = xp[i - 1], xp[i], fp[i - 1], fp[i]
    dx = x1 - x0
    slope = torch.where(dx != 0, (y1 - y0) / torch.where(dx != 0, dx,
                                                         torch.ones_like(dx)),
                        torch.zeros_like(dx))
    out = y0 + slope * (x - x0)
    out = torch.where(x == x1, y1, out)
    if period is None:
        lv = fp[0] if left is None else _lit(left, fp)
        rv = fp[-1] if right is None else _lit(right, fp)
        out = torch.where(x < xp[0], lv, out)
        out = torch.where(x > xp[-1], rv, out)
    return out


# -- shape and order ---------------------------------------------------------------

def reshape(a, newshape=None, order="C", shape=None):
    x = _a(a)
    s = _shape(shape if shape is not None else newshape)
    if order == "F":
        return x.permute(*reversed(range(x.ndim))).reshape(
            tuple(reversed(s))).permute(*reversed(range(len(s))))
    return x.reshape(s)


def ravel(a, order="C"):
    return reshape(a, (-1,), order)


def transpose(a, axes=None):
    x = _a(a)
    if axes is None:
        return x.permute(*reversed(range(x.ndim)))
    return x.permute(*[int(i) for i in axes])


def permute_dims(a, axes):
    return transpose(a, axes)


def matrix_transpose(x):
    return torch.transpose(_a(x), -1, -2)


def swapaxes(a, axis1, axis2):
    return torch.swapaxes(_a(a), int(axis1), int(axis2))


def moveaxis(a, source, destination):
    return torch.movedim(_a(a), source, destination)


def rollaxis(a, axis, start=0):
    x = _a(a)
    n = x.ndim
    axis = int(axis) % n
    start = int(start)
    if start < 0:
        start += n
    if axis < start:
        start -= 1
    if axis == start:
        return x
    order = [i for i in range(n) if i != axis]
    order.insert(start, axis)
    return x.permute(*order)


def expand_dims(a, axis):
    x = _a(a)
    axes = axis if isinstance(axis, (tuple, list)) else (axis,)
    n = x.ndim + len(axes)
    axes = sorted(int(ax) % n for ax in axes)
    shape = list(x.shape)
    for ax in axes:
        shape.insert(ax, 1)
    return x.reshape(shape)


def squeeze(a, axis=None):
    x = _a(a)
    if axis is None:
        return x.squeeze()
    axes = _dims(axis, x.ndim)
    for ax in axes:
        if x.shape[ax] != 1:
            raise MXNetError("cannot select an axis to squeeze out which has "
                             "size not equal to one")
    return x.squeeze(axes) if axes else x


def broadcast_to(array, shape):
    return torch.broadcast_to(_a(array), _shape(shape))


def broadcast_arrays(*args):
    return list(torch.broadcast_tensors(*_common(*[_a(a) for a in args])))


def _arrays(seq):
    return [_a(v) for v in seq]


def concatenate(arrays, axis=0, out=None, dtype=None, casting=None):  # noqa: ARG001
    xs = _common(*_arrays(arrays))
    if dtype is not None:
        xs = [x.to(_tdt(dtype)) for x in xs]
    if axis is None:
        return torch.cat([x.reshape(-1) for x in xs])
    return torch.cat(xs, int(axis))


def concat(arrays, /, *, axis=0):
    return concatenate(arrays, axis)


def stack(arrays, axis=0, out=None, dtype=None):  # noqa: ARG001
    xs = _common(*_arrays(arrays))
    if dtype is not None:
        xs = [x.to(_tdt(dtype)) for x in xs]
    return torch.stack(xs, int(axis))


def atleast_1d(*arys):
    out = [_a(a) if _a(a).ndim >= 1 else _a(a).reshape(1) for a in arys]
    return out[0] if len(out) == 1 else out


def atleast_2d(*arys):
    out = []
    for a in arys:
        x = _a(a)
        out.append(x.reshape(1, 1) if x.ndim == 0 else
                   (x[None] if x.ndim == 1 else x))
    return out[0] if len(out) == 1 else out


def atleast_3d(*arys):
    out = []
    for a in arys:
        x = _a(a)
        if x.ndim == 0:
            x = x.reshape(1, 1, 1)
        elif x.ndim == 1:
            x = x[None, :, None]
        elif x.ndim == 2:
            x = x[:, :, None]
        out.append(x)
    return out[0] if len(out) == 1 else out


def vstack(tup, dtype=None):
    return concatenate([atleast_2d(a) for a in tup], 0, dtype=dtype)


def hstack(tup, dtype=None):
    xs = [atleast_1d(a) for a in tup]
    return concatenate(xs, 0 if xs[0].ndim == 1 else 1, dtype=dtype)


def dstack(tup):
    return concatenate([atleast_3d(a) for a in tup], 2)


def column_stack(tup):
    xs = [_a(a) for a in tup]
    return concatenate([x[:, None] if x.ndim < 2 else x for x in xs], 1)


def _split(x, ios, axis, strict):
    axis = int(axis)
    if isinstance(ios, (int, _onp.integer)):
        n = x.shape[axis]
        if strict and n % int(ios):
            raise MXNetError("array split does not result in an equal "
                             "division")
        return list(torch.tensor_split(x, int(ios), axis))
    idx = ios.tolist() if _is_t(ios) else [int(i) for i in ios]
    return list(torch.tensor_split(x, idx, axis))


def split(ary, indices_or_sections, axis=0):
    return _split(_a(ary), indices_or_sections, axis, True)


def array_split(ary, indices_or_sections, axis=0):
    return _split(_a(ary), indices_or_sections, axis, False)


def hsplit(ary, indices_or_sections):
    x = _a(ary)
    return _split(x, indices_or_sections, 1 if x.ndim > 1 else 0, True)


def vsplit(ary, indices_or_sections):
    return _split(_a(ary), indices_or_sections, 0, True)


def dsplit(ary, indices_or_sections):
    return _split(_a(ary), indices_or_sections, 2, True)


def unstack(x, /, *, axis=0):
    return tuple(torch.unbind(_a(x), int(axis)))


def tile(A, reps):  # noqa: N803
    reps = (int(reps),) if isinstance(reps, (int, _onp.integer)) \
        else tuple(int(r) for r in reps)
    return torch.tile(_a(A), reps)


def repeat(a, repeats, axis=None):
    x = _a(a)
    if axis is None:
        x, axis = x.reshape(-1), 0
    r = repeats if isinstance(repeats, (int, _onp.integer)) \
        else _a(repeats).to(x.device)
    return torch.repeat_interleave(x, r, int(axis))


def flip(m, axis=None):
    x = _a(m)
    return torch.flip(x, _dims(axis, x.ndim))


def fliplr(m):
    return torch.flip(_a(m), (1,))


def flipud(m):
    return torch.flip(_a(m), (0,))


def roll(a, shift, axis=None):
    x = _a(a)
    if axis is None:
        return torch.roll(x.reshape(-1), shift).reshape(x.shape)
    return torch.roll(x, shift, axis)


def rot90(m, k=1, axes=(0, 1)):
    return torch.rot90(_a(m), int(k), [int(a) for a in axes])


def _pad_widths(pw, nd):
    pw = _onp.asarray(pw.tolist() if _is_t(pw) else pw, dtype=_onp.int64)
    return _onp.broadcast_to(pw.reshape(-1, 2) if pw.size > 1 or pw.ndim
                             else pw.reshape(1, 1).repeat(2, 1),
                             (nd, 2)) if pw.size != 2 * nd or pw.ndim == 1 \
        else pw.reshape(nd, 2)


def _pad_index(n, before, after, mode, device):
    i = torch.arange(-before, n + after, device=device)
    if mode == "edge":
        return i.clamp(0, n - 1)
    if mode == "wrap":
        return torch.remainder(i, n)
    if mode == "symmetric":
        j = torch.remainder(i, 2 * n)
        return torch.where(j < n, j, 2 * n - 1 - j)
    if mode == "reflect":
        if n == 1:
            return torch.zeros_like(i)
        j = torch.remainder(i, 2 * n - 2)
        return torch.where(j < n, j, 2 * n - 2 - j)
    raise MXNetError(f"pad: mode {mode!r} is not supported")


def pad(array, pad_width, mode="constant", **kwargs):
    x = _a(array)
    nd = x.ndim
    pw = _pad_widths(pad_width, nd)
    if mode in ("constant", "empty"):
        cv = kwargs.get("constant_values", 0) if mode == "constant" else 0
        cv = _onp.broadcast_to(_onp.asarray(cv.tolist() if _is_t(cv) else cv),
                               (nd, 2))
        out = x
        for ax in range(nd):
            b, e = int(pw[ax][0]), int(pw[ax][1])
            if b == 0 and e == 0:
                continue
            shp = list(out.shape)
            parts = []
            if b:
                shp[ax] = b
                parts.append(torch.full(shp, cv[ax][0].item(), dtype=x.dtype,
                                        device=x.device))
            parts.append(out)
            if e:
                shp[ax] = e
                parts.append(torch.full(shp, cv[ax][1].item(), dtype=x.dtype,
                                        device=x.device))
            out = torch.cat(parts, ax)
        return out
    if mode in ("edge", "wrap", "symmetric", "reflect"):
        out = x
        for ax in range(nd):
            b, e = int(pw[ax][0]), int(pw[ax][1])
            if b or e:
                out = torch.index_select(out, ax, _pad_index(
                    x.shape[ax], b, e, mode, x.device))
        return out
    if mode in ("maximum", "minimum", "mean", "median"):
        fn = {"maximum": amax, "minimum": amin, "mean": mean,
              "median": median}[mode]
        out = x
        for ax in range(nd):
            b, e = int(pw[ax][0]), int(pw[ax][1])
            if not (b or e):
                continue
            st = fn(out, ax, keepdims=True).to(x.dtype)
            parts = [st.expand(*[b if d == ax else s
                                 for d, s in enumerate(out.shape)])] if b \
                else []
            parts.append(out)
            if e:
                parts.append(st.expand(*[e if d == ax else s
                                         for d, s in enumerate(out.shape)]))
            out = torch.cat(parts, ax)
        return out
    if mode == "linear_ramp":
        ev = _onp.broadcast_to(_onp.asarray(kwargs.get("end_values", 0)),
                               (nd, 2))
        out = x
        for ax in range(nd):
            b, e = int(pw[ax][0]), int(pw[ax][1])
            parts = []
            if b:
                edge = out.narrow(ax, 0, 1)
                r = torch.linspace(0, 1, b + 1, dtype=torch.float64,
                                   device=x.device)[:-1]
                shape = [1] * nd
                shape[ax] = b
                r = r.reshape(shape)
                parts.append((ev[ax][0] + (edge.double() - ev[ax][0]) * r)
                             .to(x.dtype))
            parts.append(out)
            if e:
                edge = out.narrow(ax, out.shape[ax] - 1, 1)
                r = torch.linspace(1, 0, e + 1, dtype=torch.float64,
                                   device=x.device)[1:]
                shape = [1] * nd
                shape[ax] = e
                r = r.reshape(shape)
                parts.append((ev[ax][1] + (edge.double() - ev[ax][1]) * r)
                             .to(x.dtype))
            out = torch.cat(parts, ax)
        return out
    raise MXNetError(f"pad: mode {mode!r} is not supported")


def delete(arr, obj, axis=None):
    x = _a(arr)
    if axis is None:
        x, axis = x.reshape(-1), 0
    axis = int(axis) % x.ndim
    n = x.shape[axis]
    if not _is_t(obj):
        # positions given on the host: the kept index is built there
        keep = _onp.ones(n, bool)
        keep[_onp.arange(n)[obj] if isinstance(obj, slice) else obj] = False
        return torch.index_select(x, axis, torch.as_tensor(
            _onp.nonzero(keep)[0], device=x.device))
    keep = torch.ones(n, dtype=torch.bool, device=x.device)
    t = obj.to(x.device)
    keep[t if t.dtype == torch.bool else torch.remainder(
        t.reshape(-1).to(torch.int64), n)] = False
    return torch.index_select(x, axis, keep.nonzero().reshape(-1))


def insert(arr, obj, values, axis=None):
    x = _a(arr)
    if axis is None:
        x, axis = x.reshape(-1), 0
    axis = int(axis) % x.ndim
    n = x.shape[axis]
    v = _filled(values, (), x) if isinstance(values, (int, float, bool)) \
        else _a(values).to(x.device, x.dtype)
    if isinstance(obj, (int, _onp.integer)) or (_is_t(obj) and obj.ndim == 0):
        pos = int(obj)
        pos = pos + n if pos < 0 else pos
        v = v.reshape((1,) * (x.ndim - v.ndim) + tuple(v.shape))
        v = torch.movedim(v, 0, axis)
        shape = list(x.shape)
        shape[axis] = v.shape[axis]
        v = torch.broadcast_to(v, shape)
        return torch.cat([x.narrow(axis, 0, pos), v,
                          x.narrow(axis, pos, n - pos)], axis)
    idx = _a(obj).to(x.device).reshape(-1).to(torch.int64)
    idx = torch.where(idx < 0, idx + n, idx)
    k = idx.shape[0]
    order = torch.argsort(idx, stable=True)
    new_pos = idx[order] + torch.arange(k, device=x.device)
    total = n + k
    shape = list(x.shape)
    shape[axis] = k
    v = torch.broadcast_to(v if v.ndim == x.ndim else torch.movedim(
        v.reshape((1,) * (x.ndim - v.ndim) + tuple(v.shape)), -1, axis)
        if v.ndim else v, shape)
    # old element j lands at j + (the new slots before it): no read of
    # the positions to the host
    j = torch.arange(n, device=x.device)
    old_pos = j + torch.searchsorted(idx[order], j, right=True)
    out_shape = list(x.shape)
    out_shape[axis] = total
    out = torch.empty(out_shape, dtype=x.dtype, device=x.device)
    out.index_copy_(axis, new_pos, torch.index_select(v, axis, order))
    out.index_copy_(axis, old_pos, x)
    return out


def append(arr, values, axis=None):
    x, v = _common(_a(arr), _a(values))
    if axis is None:
        return torch.cat([x.reshape(-1), v.reshape(-1)])
    return torch.cat([x, v], int(axis))


def resize(a, new_shape):
    x = _a(a).reshape(-1)
    shape = _shape(new_shape)
    n = 1
    for s in shape:
        n *= s
    if x.numel() == 0:
        return torch.zeros(shape, dtype=x.dtype, device=x.device)
    reps = -(-n // x.numel())
    return x.repeat(reps)[:n].reshape(shape)


def trim_zeros(filt, trim="fb"):
    x = _a(filt)
    nz = (x != 0).nonzero().reshape(-1)
    if nz.numel() == 0:
        return x[:0]
    first = int(nz[0]) if "f" in trim.lower() else 0
    last = int(nz[-1]) + 1 if "b" in trim.lower() else x.shape[0]
    return x[first:last]


# -- searching, sorting, sets ------------------------------------------------------

def sort(a, axis=-1, kind=None, order=None, stable=None):  # noqa: ARG001
    x = _a(a)
    x, axis = _flat_axis(x, axis)
    if x.is_complex():
        return sort_complex(x) if x.ndim == 1 else x.gather(
            axis, _lex_complex(x, axis))
    return torch.sort(x, dim=axis, stable=True).values


def argsort(a, axis=-1, kind=None, order=None, stable=None):  # noqa: ARG001
    x = _a(a)
    x, axis = _flat_axis(x, axis)
    return torch.argsort(x, dim=axis, stable=True)


def _lex_complex(x, axis):
    return lexsort([x.imag, x.real], axis)


def sort_complex(a):
    x = _a(a)
    if not x.is_complex():
        x = x.to(torch.complex128 if x.dtype == torch.float64
                 else torch.complex64)
    return x.gather(-1, _lex_complex(x, -1))


def lexsort(keys, axis=-1):
    ks = [_a(k) for k in keys] if not _is_t(keys) else list(keys.unbind(0))
    idx = None
    for k in ks:
        if idx is None:
            idx = torch.argsort(k, dim=axis, stable=True)
        else:
            kk = torch.gather(k, axis, idx)
            idx = torch.gather(idx, axis, torch.argsort(kk, dim=axis,
                                                        stable=True))
    return idx


def partition(a, kth, axis=-1, kind=None, order=None):  # noqa: ARG001
    """A full sort: one of the orders numpy's partition may return."""
    return sort(a, axis)


def argpartition(a, kth, axis=-1, kind=None, order=None):  # noqa: ARG001
    return argsort(a, axis).to(torch.int32)


def _unique_1d(x, equal_nan=True):
    """(values, first index, inverse, counts) of a flat tensor."""
    perm = torch.argsort(x, stable=True)
    s = x[perm]
    n = s.shape[0]
    if n == 0:
        e = torch.zeros(0, dtype=torch.int64, device=x.device)
        return s, e, e, e
    diff = s[1:] != s[:-1]
    if equal_nan and not _is_int(s):
        diff = diff & ~(torch.isnan(s[1:]) & torch.isnan(s[:-1]))
    flags = torch.cat([torch.ones(1, dtype=torch.bool, device=x.device), diff])
    gid = torch.cumsum(flags.to(torch.int64), 0) - 1
    starts = flags.nonzero().reshape(-1)
    vals = s[starts]
    first = perm[starts]
    inv = torch.empty_like(gid)
    inv[perm] = gid
    ends = torch.cat([starts[1:], torch.tensor([n], device=x.device)])
    return vals, first, inv, ends - starts


def unique(ar, return_index=False, return_inverse=False, return_counts=False,
           axis=None, equal_nan=True, sorted=True):  # noqa: A002,ARG001
    x = _a(ar)
    if axis is not None:
        vals, inv, cnt = torch.unique(x, sorted=True, return_inverse=True,
                                      return_counts=True, dim=int(axis))
        first = None
        if return_index:
            n = x.shape[int(axis)]
            pos = torch.arange(n, device=x.device)
            first = torch.full((vals.shape[int(axis)],), n, dtype=torch.int64,
                               device=x.device).scatter_reduce(
                0, inv, pos, reduce="amin")
        out = [vals]
        if return_index:
            out.append(first)
        if return_inverse:
            out.append(inv)
        if return_counts:
            out.append(cnt)
        return out[0] if len(out) == 1 else tuple(out)
    vals, first, inv, cnt = _unique_1d(x.reshape(-1), equal_nan)
    out = [vals]
    if return_index:
        out.append(first)
    if return_inverse:
        out.append(inv.reshape(x.shape))
    if return_counts:
        out.append(cnt)
    return out[0] if len(out) == 1 else tuple(out)


def unique_all(x):
    x = _a(x)
    vals, first, inv, cnt = _unique_1d(x.reshape(-1))
    return vals, first, inv.reshape(x.shape), cnt


def unique_counts(x):
    vals, _, _, cnt = _unique_1d(_a(x).reshape(-1))
    return vals, cnt


def unique_inverse(x):
    x = _a(x)
    vals, _, inv, _ = _unique_1d(x.reshape(-1))
    return vals, inv.reshape(x.shape)


def unique_values(x):
    return _unique_1d(_a(x).reshape(-1))[0]


def isin(element, test_elements, assume_unique=False, invert=False,  # noqa: ARG001
         kind=None):  # noqa: ARG001
    e = _a(element)
    t = _a(test_elements).to(e.device)
    e2, t2 = _common(e, t)
    out = torch.isin(e2, t2)
    return ~out if invert else out


def union1d(ar1, ar2):
    a, b = _common(_a(ar1).reshape(-1), _a(ar2).reshape(-1))
    return unique_values(torch.cat([a, b]))


def intersect1d(ar1, ar2, assume_unique=False, return_indices=False):  # noqa: ARG001
    a, b = _common(_a(ar1).reshape(-1), _a(ar2).reshape(-1))
    ua, ia, _, _ = _unique_1d(a)
    ub, ib, _, _ = _unique_1d(b)
    keep = torch.isin(ua, ub)
    vals = ua[keep]
    if not return_indices:
        return vals
    pos_b = torch.searchsorted(ub, vals)
    return vals, ia[keep], ib[pos_b]


def setdiff1d(ar1, ar2, assume_unique=False):  # noqa: ARG001
    a = _a(ar1).reshape(-1)
    ua = unique_values(a)
    b = _a(ar2).reshape(-1).to(a.device)
    ua2, b2 = _common(ua, b)
    return ua[~torch.isin(ua2, b2)]


def setxor1d(ar1, ar2, assume_unique=False):  # noqa: ARG001
    a, b = _common(_a(ar1).reshape(-1), _a(ar2).reshape(-1))
    c = torch.cat([unique_values(a), unique_values(b)])
    vals, _, _, cnt = _unique_1d(c)
    return vals[cnt == 1]


def where(condition, x=None, y=None):
    c = _a(condition)
    if x is None and y is None:
        return nonzero(c)
    if x is None or y is None:
        raise MXNetError("where: give both x and y, or neither")
    if _is_t(x) or _is_t(y):
        xx, yy = _pair(x, y)
    else:
        xx, yy = _a(x), _a(y)
    xx, yy = _common(xx, yy)
    return torch.where(c.to(torch.bool) if c.dtype != torch.bool else c,
                       xx, yy)


def nonzero(a):
    x = _a(a)
    return tuple(torch.nonzero(x if x.ndim else x.reshape(1),
                               as_tuple=True))


def flatnonzero(a):
    return torch.nonzero(_a(a).reshape(-1)).reshape(-1)


def argwhere(a):
    x = _a(a)
    return torch.argwhere(x) if x.ndim else torch.argwhere(x).reshape(
        -1, 0)


def extract(condition, arr):
    return _a(arr).reshape(-1)[_a(condition).reshape(-1) != 0]


def compress(condition, a, axis=None):
    x = _a(a)
    if axis is None:
        x, axis = x.reshape(-1), 0
    axis = int(axis)
    if not _is_t(condition):
        c = _onp.asarray(condition).reshape(-1)[:x.shape[axis]] != 0
        return torch.index_select(x, axis, torch.as_tensor(
            _onp.nonzero(c)[0], device=x.device))
    c = (condition.reshape(-1) != 0)[:x.shape[axis]]
    return torch.index_select(x, axis, c.nonzero().reshape(-1))


def choose(a, choices, out=None, mode="raise"):  # noqa: ARG001
    idx = _a(a).to(torch.int64)
    cs = choices if _is_t(choices) else torch.stack(
        torch.broadcast_tensors(*_common(*_arrays(choices))))
    n = cs.shape[0]
    if mode == "clip":
        idx = idx.clamp(0, n - 1)
    elif mode == "wrap":
        idx = torch.remainder(idx, n)
    cs, idx = torch.broadcast_tensors(cs, idx.unsqueeze(0).expand(
        (n,) + torch.broadcast_shapes(idx.shape, cs.shape[1:])))
    return torch.gather(cs, 0, idx[:1]).squeeze(0)


def select(condlist, choicelist, default=0):
    conds = [_a(c) for c in condlist]
    choices = [_a(c) for c in choicelist]
    choices = _common(*choices)
    out = _filled(default, torch.broadcast_shapes(
        *[c.shape for c in choices], *[c.shape for c in conds]), choices[0])
    for c, v in reversed(list(zip(conds, choices))):
        out = torch.where(c.to(torch.bool), v, out)
    return out


def piecewise(x, condlist, funclist, *args, **kw):
    """Each function on the whole of ``x``, selected by its condition (as
    ``jnp.piecewise``, with no read of the conditions to the host)."""
    x = _a(x)
    conds = [_a(c).to(torch.bool) for c in (
        condlist if isinstance(condlist, (list, tuple)) else [condlist])]
    if len(funclist) == len(conds) + 1:
        rest = ~torch.stack([c.expand(x.shape) for c in conds]).any(0)
        conds = conds + [rest]
    out = torch.zeros_like(x)
    for c, f in zip(conds, funclist):
        v = f(x, *args, **kw) if callable(f) else f
        v = _lit(v, x).to(x.dtype) if not _is_t(v) else v.to(x.dtype)
        out = torch.where(c, v, out)
    return out


def take(a, indices, axis=None, out=None, mode=None):  # noqa: ARG001
    x = _a(a)
    if axis is None:
        x, axis = x.reshape(-1), 0
    axis = int(axis) % x.ndim
    idx = _a(indices).to(x.device).to(torch.int64)
    n = x.shape[axis]
    if mode == "wrap":
        idx = torch.remainder(idx, n)
    elif mode == "clip":
        idx = idx.clamp(0, n - 1)
    else:
        idx = torch.where(idx < 0, idx + n, idx)
    out = torch.index_select(x, axis, idx.reshape(-1))
    return out.reshape(x.shape[:axis] + idx.shape + x.shape[axis + 1:])


def take_along_axis(arr, indices, axis, mode=None, fill_value=None):  # noqa: ARG001
    x = _a(arr)
    idx = _a(indices).to(torch.int64)
    if axis is None:
        return torch.take_along_dim(x.reshape(-1), idx.reshape(-1))
    return torch.take_along_dim(x, idx, int(axis))


def put_along_axis(arr, indices, values, axis, inplace=None, mode=None):  # noqa: ARG001
    """The updated copy (as the reference's ``jnp`` call gives it)."""
    x = _a(arr)
    idx = _a(indices).to(torch.int64)
    if axis is None:
        flat = x.reshape(-1).clone()
        v = _filled(values, idx.reshape(-1).shape, x)
        return flat.scatter(0, idx.reshape(-1), v).reshape(x.shape)
    axis = int(axis) % x.ndim
    shape = torch.broadcast_shapes(
        tuple(s if d != axis else idx.shape[d]
              for d, s in enumerate(x.shape)), idx.shape)
    idx = torch.broadcast_to(idx, shape)
    return x.clone().scatter(axis, idx, _filled(values, shape, x))


def unravel_index(indices, shape, order="C"):  # noqa: ARG001
    idx = _a(indices)
    out = []
    for d in reversed(_shape(shape)):
        out.append(torch.remainder(idx, d))
        idx = torch.div(idx, d, rounding_mode="floor")
    return tuple(reversed(out))


def ravel_multi_index(multi_index, dims, mode="raise", order="C"):  # noqa: ARG001
    dims = _shape(dims)
    out = None
    for i, d in zip(multi_index, dims):
        i = _a(i)
        if mode == "wrap":
            i = torch.remainder(i, d)
        elif mode == "clip":
            i = i.clamp(0, d - 1)
        out = i if out is None else out * d + i
    return out


def _tri_idx(fn, n, k, m):
    m = n if m is None else m
    t = fn(int(n), int(m), offset=int(k), device=_dev())
    return t[0], t[1]


def triu_indices(n, k=0, m=None):
    return _tri_idx(torch.triu_indices, n, k, m)


def tril_indices(n, k=0, m=None):
    return _tri_idx(torch.tril_indices, n, k, m)


def triu_indices_from(arr, k=0):
    x = _a(arr)
    return triu_indices(x.shape[-2], k, x.shape[-1])


def tril_indices_from(arr, k=0):
    x = _a(arr)
    return tril_indices(x.shape[-2], k, x.shape[-1])


def diag_indices(n, ndim=2):
    i = torch.arange(int(n), device=_dev())
    return tuple(i for _ in range(int(ndim)))


def diag_indices_from(arr):
    x = _a(arr)
    return diag_indices(x.shape[0], x.ndim)


def ix_(*args):
    out = []
    n = len(args)
    for k, a in enumerate(args):
        x = _a(a)
        if x.dtype == torch.bool:
            x = x.nonzero().reshape(-1)
        shape = [1] * n
        shape[k] = -1
        out.append(x.reshape(shape))
    return tuple(out)


# -- products and calculus --------------------------------------------------------

def dot(a, b, out=None):  # noqa: ARG001
    x, y = _pair(a, b)
    if x.ndim == 0 or y.ndim == 0:
        return torch.multiply(x, y)
    if y.ndim == 1 or x.ndim == 1 and y.ndim <= 2:
        return _mm(x, y)
    if x.ndim <= 2 and y.ndim == 2:
        return _mm(x, y)
    return _tensordot(x, y, ([x.ndim - 1], [y.ndim - 2]))


def vdot(a, b):
    x, y = _pair(a, b)
    x = x.reshape(-1)
    if x.is_complex():
        x = x.conj()
    return torch.sum(torch.multiply(*_common(x, y.reshape(-1))))


def inner(a, b):
    x, y = _pair(a, b)
    if x.ndim == 0 or y.ndim == 0:
        return torch.multiply(x, y)
    return _tensordot(x, y, ([x.ndim - 1], [y.ndim - 1]))


def outer(a, b, out=None):  # noqa: ARG001
    x, y = _common(_a(a).reshape(-1), _a(b).reshape(-1))
    return x[:, None] * y[None, :]


def matmul(x1, x2, out=None):  # noqa: ARG001
    return _mm(_a(x1), _a(x2))


def tensordot(a, b, axes=2):
    return _tensordot(_a(a), _a(b), axes)


def einsum(subscripts, *operands, out=None, optimize=None,  # noqa: ARG001
           precision=None):  # noqa: ARG001
    ops = _common(*[_a(o) for o in operands])
    if _is_int(ops[0]) and ops[0].is_cuda:
        return torch.einsum(subscripts, *[o.double() for o in ops]) \
            .round().to(ops[0].dtype)
    return torch.einsum(subscripts, *ops)


def kron(a, b):
    return torch.kron(*_common(_a(a), _a(b)))


def trace(a, offset=0, axis1=0, axis2=1, dtype=None, out=None):  # noqa: ARG001
    x = _a(a)
    d = torch.diagonal(x, int(offset), int(axis1), int(axis2))
    return torch.sum(d, -1, dtype=_acc_dtype(d, dtype))


def vecdot(x1, x2, /, *, axis=-1):
    a, b = _common(_a(x1), _a(x2))
    if a.is_complex():
        a = a.conj()
    return torch.sum(a * b, int(axis))


def cross(a, b, axisa=-1, axisb=-1, axisc=-1, axis=None):
    x, y = _common(_a(a), _a(b))
    if axis is not None:
        axisa = axisb = axisc = axis
    x = torch.movedim(x, int(axisa), -1)
    y = torch.movedim(y, int(axisb), -1)
    if x.shape[-1] == 2 and y.shape[-1] == 2:
        return x[..., 0] * y[..., 1] - x[..., 1] * y[..., 0]
    if x.shape[-1] == 2:
        x = torch.cat([x, torch.zeros_like(x[..., :1])], -1)
    if y.shape[-1] == 2:
        y = torch.cat([y, torch.zeros_like(y[..., :1])], -1)
    x, y = torch.broadcast_tensors(x, y)
    c0 = x[..., 1] * y[..., 2] - x[..., 2] * y[..., 1]
    c1 = x[..., 2] * y[..., 0] - x[..., 0] * y[..., 2]
    c2 = x[..., 0] * y[..., 1] - x[..., 1] * y[..., 0]
    return torch.movedim(torch.stack([c0, c1, c2], -1), -1, int(axisc))


def diff(a, n=1, axis=-1, prepend=None, append=None):
    x = _a(a)
    axis = int(axis) % x.ndim

    def edge(v):
        if v is None:
            return None
        if not _is_t(v) and _onp.ndim(v) == 0:
            shape = list(x.shape)
            shape[axis] = 1
            return _filled(v, shape, x)
        t = v if _is_t(v) else _a(v)
        if t.ndim == 0:
            shape = list(x.shape)
            shape[axis] = 1
            t = torch.broadcast_to(t, shape)
        return t.to(x.device, x.dtype)
    return torch.diff(x, int(n), axis, edge(prepend), edge(append))


def ediff1d(ary, to_end=None, to_begin=None):
    x = _a(ary).reshape(-1)
    parts = []
    if to_begin is not None:
        parts.append(_a(to_begin).reshape(-1).to(x.device, x.dtype))
    parts.append(x[1:] - x[:-1])
    if to_end is not None:
        parts.append(_a(to_end).reshape(-1).to(x.device, x.dtype))
    return torch.cat(parts)


def _grad_axis(f, h, axis, edge_order):
    n = f.shape[axis]
    if n < edge_order + 1:
        raise MXNetError("gradient: each axis needs at least edge_order + 1 "
                         "points")

    def sl(a, b):
        return f.narrow(axis, a, b - a)

    def vec(t):
        shape = [1] * f.ndim
        shape[axis] = -1
        return t.reshape(shape)
    if not _is_t(h):
        mid = (sl(2, n) - sl(0, n - 2)) / (2.0 * h)
        if edge_order == 1:
            first = (sl(1, 2) - sl(0, 1)) / h
            last = (sl(n - 1, n) - sl(n - 2, n - 1)) / h
        else:
            first = (-1.5 * sl(0, 1) + 2 * sl(1, 2) - 0.5 * sl(2, 3)) / h
            last = (0.5 * sl(n - 3, n - 2) - 2 * sl(n - 2, n - 1)
                    + 1.5 * sl(n - 1, n)) / h
        return torch.cat([first, mid, last], axis)
    dx = torch.diff(h.to(f.dtype))
    d1, d2 = dx[:-1], dx[1:]
    a = -d2 / (d1 * (d1 + d2))
    b = (d2 - d1) / (d1 * d2)
    c = d1 / (d2 * (d1 + d2))
    mid = vec(a) * sl(0, n - 2) + vec(b) * sl(1, n - 1) + vec(c) * sl(2, n)
    if edge_order == 1:
        first = (sl(1, 2) - sl(0, 1)) / dx[0]
        last = (sl(n - 1, n) - sl(n - 2, n - 1)) / dx[-1]
    else:
        p, q = dx[0], dx[1]
        first = (-(2 * p + q) / (p * (p + q)) * sl(0, 1)
                 + (p + q) / (p * q) * sl(1, 2) - p / (q * (p + q)) * sl(2, 3))
        p, q = dx[-2], dx[-1]
        last = (q / (p * (p + q)) * sl(n - 3, n - 2)
                - (q + p) / (p * q) * sl(n - 2, n - 1)
                + (2 * q + p) / (q * (p + q)) * sl(n - 1, n))
    return torch.cat([first, mid, last], axis)


def gradient(f, *varargs, axis=None, edge_order=1):
    x = _float(_a(f))
    axes = list(range(x.ndim)) if axis is None else list(_dims(axis, x.ndim))
    if not varargs:
        hs = [1.0] * len(axes)
    elif len(varargs) == 1 and not _is_t(varargs[0]) and _onp.ndim(
            varargs[0]) == 0:
        hs = [float(varargs[0])] * len(axes)
    else:
        hs = [v if _is_t(v) else (float(v) if _onp.ndim(v) == 0 else _a(v))
              for v in varargs]
        hs = [h if not _is_t(h) or h.ndim else float(h) for h in hs]
    out = [_grad_axis(x, h, ax, int(edge_order)) for ax, h in zip(axes, hs)]
    return out[0] if len(out) == 1 else out


def trapezoid(y, x=None, dx=1.0, axis=-1):
    yy = _float(_a(y))
    if x is None:
        return torch.trapezoid(yy, dx=float(dx), dim=int(axis))
    xx = _a(x).to(yy.dtype)
    return torch.trapezoid(yy, xx, dim=int(axis))


def _corr_full(a, v):
    """sum_n a[n + k] v[n] for every lag k, -(len(v) - 1) .. len(a) - 1."""
    a, v = _common(a.reshape(-1), v.reshape(-1))
    dt = a.dtype
    if _is_int(a):
        a, v = a.double(), v.double()
    out = F.conv1d(a.reshape(1, 1, -1), v.reshape(1, 1, -1),
                   padding=v.shape[0] - 1).reshape(-1)
    return out.round().to(dt) if _is_int(torch.empty(0, dtype=dt)) else out


def convolve(a, v, mode="full"):
    x, y = _a(a), _a(v)
    n, m = x.shape[0], y.shape[0]
    full = _corr_full(x, y.flip(0))
    lo, hi = _pymin(n, m), _pymax(n, m)
    if mode == "full":
        return full
    if mode == "same":
        s = (lo - 1) // 2
        return full[s:s + hi]
    if mode == "valid":
        return full[lo - 1:hi]
    raise MXNetError(f"convolve: unknown mode {mode!r}")


def correlate(a, v, mode="valid"):
    x, y = _a(a), _a(v)
    if y.is_complex():
        y = y.conj()
    n, m = x.shape[0], y.shape[0]
    full = _corr_full(x, y)
    L = full.shape[0]
    lo, hi = _pymin(n, m), _pymax(n, m)
    if mode == "full":
        return full
    if mode == "valid":
        return full[lo - 1:hi]
    if mode == "same":
        if n >= m:
            s = (m - 1) // 2
            return full[s:s + n]
        s = (n - 1) // 2
        return full[L - (s + m):L - s]
    raise MXNetError(f"correlate: unknown mode {mode!r}")


def unwrap(p, discont=None, axis=-1, period=2 * math.pi):
    x = _float(_a(p))
    axis = int(axis) % x.ndim
    dd = torch.diff(x, dim=axis)
    discont = period / 2 if discont is None else discont
    hi = period / 2
    lo = -hi
    ddmod = torch.remainder(dd - lo, period) + lo
    ddmod = torch.where((ddmod == lo) & (dd > 0), torch.full_like(ddmod, hi),
                        ddmod)
    corr = ddmod - dd
    corr = torch.where(torch.abs(dd) < discont, torch.zeros_like(corr), corr)
    shape = list(x.shape)
    shape[axis] = 1
    csum = torch.cat([torch.zeros(shape, dtype=x.dtype, device=x.device),
                      torch.cumsum(corr, axis)], axis)
    return x + csum


# -- polynomials ------------------------------------------------------------------

def _p(p):
    return atleast_1d(_a(p))


def polyval(p, x):
    c = _p(p)
    xx = _a(x) if not isinstance(x, (int, float)) else _filled(
        x, (), c if not _is_int(c) or isinstance(x, int) else _float(c))
    c, xx = _common(c, xx)
    y = torch.zeros_like(xx)
    for i in range(c.shape[0]):
        y = y * xx + c[i]
    return y


def _pad_front(a, n):
    return torch.cat([torch.zeros(n - a.shape[0], dtype=a.dtype,
                                  device=a.device), a]) if a.shape[0] < n \
        else a


def polyadd(a1, a2):
    a, b = _common(_p(a1), _p(a2))
    n = _pymax(a.shape[0], b.shape[0])
    return _pad_front(a, n) + _pad_front(b, n)


def polysub(a1, a2):
    a, b = _common(_p(a1), _p(a2))
    n = _pymax(a.shape[0], b.shape[0])
    return _pad_front(a, n) - _pad_front(b, n)


def polymul(a1, a2):
    return convolve(_p(a1), _p(a2))


def polyder(p, m=1):
    c = _p(p)
    for _ in range(int(m)):
        n = c.shape[0] - 1
        if n <= 0:
            return torch.zeros(1, dtype=c.dtype, device=c.device)
        c = c[:-1] * torch.arange(n, 0, -1, device=c.device).to(c.dtype)
    return c


def polyint(p, m=1, k=None):
    c = _float(_p(p))
    m = int(m)
    ks = [0.0] * m if k is None else (list(k.tolist() if _is_t(k) else k)
                                      if _onp.ndim(k) else [float(k)] * m)
    for i in range(m):
        n = c.shape[0]
        c = torch.cat([c / torch.arange(n, 0, -1, device=c.device).to(c.dtype),
                       torch.full((1,), float(ks[i]), dtype=c.dtype,
                                  device=c.device)])
    return c


def polydiv(u, v, trim_leading_zeros=False):
    a, b = _common(_float(_p(u)), _float(_p(v)))
    m, n = a.shape[0] - 1, b.shape[0] - 1
    scale = 1.0 / b[0]
    qs = []
    r = a
    for k in range(0, m - n + 1):
        d = scale * r[k]
        qs.append(d)
        r = r - d * torch.cat([r.new_zeros(k), b,
                               r.new_zeros(m - n - k)])
    q = torch.stack(qs) if qs else a.new_zeros(1)
    if trim_leading_zeros:
        nz = (r.abs() > 1e-14 * r.abs().max()).nonzero().reshape(-1)
        r = r[int(nz[0]):] if nz.numel() else r[-1:]
    return q, r


def poly(seq_of_zeros):
    z = _a(seq_of_zeros)
    if z.ndim == 2 and z.shape[0] == z.shape[1] and z.shape[0] > 0:
        z = torch.linalg.eigvals(_float(z))
    z = _float(z.reshape(-1))
    a = torch.ones(1, dtype=z.dtype, device=z.device)
    for i in range(z.shape[0]):
        a = torch.cat([a, torch.zeros(1, dtype=a.dtype, device=a.device)]) \
            - torch.cat([torch.zeros(1, dtype=a.dtype, device=a.device),
                         a * z[i]])
    if a.is_complex():
        pos = z[z.imag > 0]
        neg = z[z.imag < 0]
        if pos.numel() == neg.numel() and bool(torch.all(
                torch.sort(pos.conj().real).values
                == torch.sort(neg.real).values)):
            a = a.real.clone()
    return a


def roots(p):
    c = _float(_p(p))
    nz = (c != 0).nonzero().reshape(-1)
    if nz.numel() == 0:
        return torch.zeros(0, dtype=c.dtype, device=c.device)
    first, last = int(nz[0]), int(nz[-1])
    trailing = c.shape[0] - 1 - last
    c = c[first:last + 1]
    cdt = torch.complex128 if c.dtype == torch.float64 else torch.complex64
    n = c.shape[0] - 1
    if n >= 1:
        A = torch.diag(torch.ones(n - 1, dtype=c.dtype, device=c.device), -1)
        A[0, :] = -c[1:] / c[0]
        r = torch.linalg.eigvals(A)
    else:
        r = torch.zeros(0, dtype=cdt, device=c.device)
    return torch.cat([r.to(cdt), torch.zeros(trailing, dtype=cdt,
                                             device=c.device)])


def polyfit(x, y, deg, rcond=None, full=False, w=None, cov=False):  # noqa: ARG001
    from ._linalg_impl import _lstsq
    xx = _float(_a(x))
    yy = _a(y).to(xx.dtype)
    order = int(deg) + 1
    lhs = vander(xx, order)
    rhs = yy
    if w is not None:
        ww = _a(w).to(xx.dtype)
        lhs = lhs * ww[:, None]
        rhs = rhs * (ww if rhs.ndim == 1 else ww[:, None])
    rc = xx.shape[0] * torch.finfo(xx.dtype).eps if rcond is None else rcond
    scale = torch.sqrt((lhs * lhs).sum(0))
    c, resids, rank, s = _lstsq(lhs / scale, rhs, rc, residuals=full)
    c = (c.mT / scale).mT if c.ndim > 1 else c / scale
    if full:
        return c, resids, rank, s, torch.tensor(rc, dtype=xx.dtype,
                                                device=xx.device)
    return c


# -- bits -------------------------------------------------------------------------

def packbits(a, axis=None, bitorder="big"):
    x = _a(a)
    if axis is None:
        x, axis = x.reshape(-1), 0
    x = torch.movedim((x != 0).to(torch.uint8), int(axis), -1)
    n = x.shape[-1]
    pad_n = (-n) % 8
    if pad_n:
        x = torch.cat([x, torch.zeros(x.shape[:-1] + (pad_n,),
                                      dtype=x.dtype, device=x.device)], -1)
    x = x.reshape(x.shape[:-1] + (-1, 8)).to(torch.int32)
    w = 2 ** torch.arange(7, -1, -1, dtype=torch.int32, device=x.device)
    if bitorder == "little":
        w = w.flip(0)
    out = (x * w).sum(-1).to(torch.uint8)
    return torch.movedim(out, -1, int(axis))


def unpackbits(a, axis=None, count=None, bitorder="big"):
    x = _a(a).to(torch.uint8)
    if axis is None:
        x, axis = x.reshape(-1), 0
    x = torch.movedim(x, int(axis), -1).to(torch.int32)
    sh = torch.arange(7, -1, -1, device=x.device, dtype=torch.int32)
    if bitorder == "little":
        sh = sh.flip(0)
    bits = ((x.unsqueeze(-1) >> sh) & 1).to(torch.uint8)
    bits = bits.reshape(x.shape[:-1] + (-1,))
    if count is not None:
        bits = bits[..., :int(count)]
    return torch.movedim(bits, -1, int(axis))


# -- functional ----------------------------------------------------------------

def apply_along_axis(func1d, axis, arr, *args, **kwargs):
    """``func1d`` on each 1-D slice along ``axis``, its results stacked
    where the axis was (a loop over the other indices)."""
    x = _a(arr)
    axis = int(axis) % x.ndim
    moved = torch.movedim(x, axis, -1)
    outer = moved.shape[:-1]
    res = [func1d(moved[idx], *args, **kwargs)
           for idx in itertools.product(*[range(s) for s in outer])]
    res = [r if _is_t(r) else torch.as_tensor(r, device=x.device)
           for r in res]
    k = res[0].ndim
    out = torch.stack(res).reshape(tuple(outer) + tuple(res[0].shape))
    if k:
        out = torch.movedim(out, list(range(len(outer), out.ndim)),
                            list(range(axis, axis + k)))
    return out


def apply_over_axes(func, a, axes):
    x = _a(a)
    for ax in (axes if isinstance(axes, (list, tuple)) else [axes]):
        r = func(x, int(ax))
        x = r if r.ndim == x.ndim else r.unsqueeze(int(ax))
    return x


def block(arrays):
    """``numpy.block`` over nested lists of arrays."""
    def depth(v):
        return 1 + depth(v[0]) if isinstance(v, (list, tuple)) else 0

    d = depth(arrays)

    def leaves(v):
        if isinstance(v, (list, tuple)):
            return [t for u in v for t in leaves(u)]
        return [_a(v)]
    nd = _pymax(d, _pymax(t.ndim for t in leaves(arrays)))

    def asm(v, level):
        if not isinstance(v, (list, tuple)):
            t = _a(v)
            return t.reshape((1,) * (nd - t.ndim) + tuple(t.shape))
        parts = _common(*[asm(u, level + 1) for u in v])
        return torch.cat(parts, nd - d + level)
    return asm(arrays, 0)
