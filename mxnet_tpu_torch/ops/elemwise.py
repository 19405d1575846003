"""Elementwise unary, broadcast binary and scalar operators — the port of
``mxnet_tpu/ops/elemwise.py`` under the reference's registry names
(``broadcast_add``, ``_plus_scalar``, ``relu``, ``gelu``, the trig and
special-function families, ``smooth_l1``, the amp casts ...), as plain
torch math (``torch.special`` for the special functions).  Comparisons and
logical ops return 0/1 in the left operand's dtype, as the reference's do;
``isnan``/``isinf``/``isfinite`` return booleans.  ``stop_gradient``
(``BlockGrad``) is an autograd Function whose gradient is zero.
"""

from __future__ import annotations

import operator

import torch
import torch.nn.functional as F

from .. import config
from .registry import alias, register

__all__ = ["gelu"]


def _unary(name, f, differentiable=True):
    register(name, differentiable=differentiable)(f)


_unary("abs", torch.abs)
_unary("sign", torch.sign)
_unary("negative", torch.neg)
_unary("reciprocal", torch.reciprocal)
_unary("square", torch.square)
_unary("sqrt", torch.sqrt)
_unary("rsqrt", torch.rsqrt)
_unary("exp", torch.exp)
_unary("expm1", torch.expm1)
_unary("log", torch.log)
_unary("log1p", torch.log1p)
_unary("sin", torch.sin)
_unary("cos", torch.cos)
_unary("tanh", torch.tanh)
_unary("erf", torch.erf)
_unary("sigmoid", torch.sigmoid)
_unary("relu", torch.relu)
_unary("softsign", F.softsign)
_unary("tan", torch.tan)
_unary("arcsin", torch.asin)
_unary("arccos", torch.acos)
_unary("arctan", torch.atan)
_unary("sinh", torch.sinh)
_unary("cosh", torch.cosh)
_unary("arcsinh", torch.asinh)
_unary("arccosh", torch.acosh)
_unary("arctanh", torch.atanh)
_unary("log2", torch.log2)
_unary("log10", torch.log10)
_unary("degrees", torch.rad2deg)
_unary("radians", torch.deg2rad)
_unary("gammaln", torch.lgamma)
_unary("digamma", torch.digamma)
_unary("erfinv", torch.erfinv)
_unary("silu", F.silu)
_unary("log_sigmoid", F.logsigmoid)
_unary("mish", lambda x: x * torch.tanh(F.softplus(x)))
_unary("make_loss", lambda x: x)
_unary("floor", torch.floor, differentiable=False)
_unary("rint", torch.round, differentiable=False)     # half to even
_unary("trunc", torch.trunc, differentiable=False)
_unary("fix", torch.trunc, differentiable=False)
_unary("isnan", torch.isnan, differentiable=False)
_unary("isinf", torch.isinf, differentiable=False)
_unary("isfinite", torch.isfinite, differentiable=False)
_unary("logical_not", lambda x: (x == 0).to(x.dtype), differentiable=False)
_unary("ceil", torch.ceil, differentiable=False)
_unary("round", torch.round, differentiable=False)
_unary("zeros_like", torch.zeros_like, differentiable=False)
_unary("ones_like", torch.ones_like, differentiable=False)
_unary("identity", lambda x: x)


def _cbrt(x):
    return torch.sign(x) * x.abs().pow(1.0 / 3.0)


_unary("cbrt", _cbrt)
_unary("rcbrt", lambda x: 1.0 / _cbrt(x))


@register("gamma")
def _gamma(x):
    """exp(gammaln(x)) signed as the reference signs it: +1 for x > 0,
    else the sign of cos(pi x)."""
    sign = torch.sign(torch.where(x > 0, torch.ones_like(x),
                                  torch.cos(torch.pi * x)))
    return torch.exp(torch.lgamma(x)) * sign


class _BlockGrad(torch.autograd.Function):
    """Identity forward, zero gradient (MXNet's ``BlockGrad``)."""

    @staticmethod
    def forward(ctx, x):  # noqa: ARG004
        return x.clone()

    @staticmethod
    def backward(ctx, g):  # noqa: ARG004
        return torch.zeros_like(g)


@register("stop_gradient")
def _stop_gradient(x):
    return _BlockGrad.apply(x) if torch.is_grad_enabled() \
        and x.requires_grad else x.detach()


@register("cast")
def _cast(x, dtype=None):
    from ..base import torch_dtype
    return x.to(torch_dtype(dtype))


register("amp_cast")(_cast)


@register("amp_multicast", num_outputs=-1)
def _amp_multicast(*data, num_outputs=0, cast_narrow=False):  # noqa: ARG001
    """Cast every input to one dtype: the widest float present (the
    narrowest with ``cast_narrow``); without a float input, unchanged."""
    floats = [d.dtype for d in data if d.is_floating_point()]
    if not floats:
        return list(data)
    order = sorted(floats, key=lambda t: torch.finfo(t).bits)
    common = order[0] if cast_narrow else order[-1]
    return [d.to(common) for d in data]


@register("hard_sigmoid")
def _hard_sigmoid(x, alpha=0.2, beta=0.5):
    return torch.clamp(alpha * x + beta, 0.0, 1.0)


@register("smooth_l1")
def _smooth_l1(x, scalar=1.0):
    s2 = scalar * scalar
    return torch.where(x.abs() < 1.0 / s2, 0.5 * s2 * x * x,
                       x.abs() - 0.5 / s2)


@register("shape_array", differentiable=False)
def _shape_array(x):
    return torch.tensor(x.shape, dtype=torch.int64, device=x.device)


@register("size_array", differentiable=False)
def _size_array(x):
    return torch.tensor([x.numel()], dtype=torch.int64, device=x.device)


@register("softrelu")
def _softrelu(x):
    return F.softplus(x)


@register("gelu")
def gelu(x, approximate=None):
    """GELU: the exact erf form 0.5 x (1 + erf(x / sqrt 2)) by default;
    ``approximate=True`` (or ``MXNET_GELU_TANH=1`` when ``approximate`` is
    None) selects 0.5 x (1 + tanh(sqrt(2/pi) (x + 0.044715 x^3)))."""
    if approximate is None:
        approximate = bool(config.get_int("MXNET_GELU_TANH", 0))
    return F.gelu(x, approximate="tanh" if approximate else "none")


def _cmp(f):
    return lambda a, b: f(a, b).to(a.dtype)


_BINARY = {"add": torch.add, "sub": torch.sub, "mul": torch.mul,
           "div": torch.div, "mod": torch.remainder, "power": torch.pow,
           "maximum": torch.maximum, "minimum": torch.minimum}
_COMPARE = {"equal": torch.eq, "not_equal": torch.ne, "greater": torch.gt,
            "greater_equal": torch.ge, "lesser": torch.lt,
            "lesser_equal": torch.le}
_LOGICAL = {"logical_and": torch.logical_and, "logical_or": torch.logical_or,
            "logical_xor": torch.logical_xor}

for _name, _f in _BINARY.items():
    register(f"broadcast_{_name}")(_f)
for _name, _f in _COMPARE.items():
    register(f"broadcast_{_name}", differentiable=False)(_cmp(_f))
for _name, _f in _LOGICAL.items():
    register(f"broadcast_{_name}", differentiable=False)(
        lambda a, b, _f=_f: _f(a != 0, b != 0).to(a.dtype))
register("broadcast_hypot")(torch.hypot)
register("broadcast_floor_div", differentiable=False)(torch.floor_divide)
for _name in ("add", "sub", "mul", "div"):
    alias(f"elemwise_{_name}", f"broadcast_{_name}")
alias("maximum", "broadcast_maximum")
alias("minimum", "broadcast_minimum")


def _scalar(name, f, differentiable=True):
    """``x op scalar`` (``scalar op x`` with ``reverse``); the scalar takes
    x's dtype first, as the reference's ``jnp.asarray(scalar, x.dtype)``."""
    def impl(x, scalar=0.0, reverse=False):
        s = scalar if x.is_floating_point() else int(scalar)
        return f(s, x) if reverse else f(x, s)
    register(name, differentiable=differentiable)(impl)


for _name, _f in (("plus", operator.add), ("minus", operator.sub),
                  ("mul", operator.mul), ("div", operator.truediv),
                  ("mod", operator.mod), ("power", operator.pow)):
    _scalar(f"_{_name}_scalar", _f)
_scalar("_maximum_scalar", lambda a, b: torch.clamp(
    *((a, b, None) if isinstance(a, torch.Tensor) else (b, a, None))))
_scalar("_minimum_scalar", lambda a, b: torch.clamp(
    *((a, None, b) if isinstance(a, torch.Tensor) else (b, None, a))))
_scalar("_floor_div_scalar", operator.floordiv, differentiable=False)


@register("_hypot_scalar")
def _hypot_scalar(x, scalar=0.0, reverse=False):  # noqa: ARG001 (symmetric)
    return torch.hypot(x, torch.full_like(x, scalar))


for _name, _f in (("equal", operator.eq), ("not_equal", operator.ne),
                  ("greater", operator.gt), ("greater_equal", operator.ge),
                  ("lesser", operator.lt), ("lesser_equal", operator.le)):
    _scalar(f"_{_name}_scalar",
            lambda a, b, _f=_f: _f(a, b).to(
                (a if isinstance(a, torch.Tensor) else b).dtype),
            differentiable=False)


@register("clip")
def _clip(x, a_min=None, a_max=None):
    return torch.clamp(x, a_min, a_max)


@register("add_n")
def _add_n(*args):
    out = args[0]
    for a in args[1:]:
        out = out + a
    return out
