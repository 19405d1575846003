"""Elementwise unary, broadcast binary and scalar operators — the port of
``mxnet_tpu/ops/elemwise.py`` under the reference's registry names
(``broadcast_add``, ``_plus_scalar``, ``relu``, ``gelu`` ...), as plain
torch math.  Comparisons return 0/1 in the left operand's dtype, as the
reference's do.
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
_unary("floor", torch.floor, differentiable=False)
_unary("ceil", torch.ceil, differentiable=False)
_unary("round", torch.round, differentiable=False)
_unary("zeros_like", torch.zeros_like, differentiable=False)
_unary("ones_like", torch.ones_like, differentiable=False)
_unary("identity", lambda x: x)
_unary("stop_gradient", torch.Tensor.detach)


@register("cast")
def _cast(x, dtype=None):
    from ..base import torch_dtype
    return x.to(torch_dtype(dtype))


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

for _name, _f in _BINARY.items():
    register(f"broadcast_{_name}")(_f)
for _name, _f in _COMPARE.items():
    register(f"broadcast_{_name}", differentiable=False)(_cmp(_f))
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
