"""Weight initializers — the port of ``mxnet_tpu/initializer.py``: the
registry and name lookup (``init="xavier"``), ``InitDesc`` and the
reference's dispatch on the parameter's name, and ``Zero``, ``One``,
``Constant``, ``Uniform``, ``Normal`` and ``Xavier``.

``Initializer.__call__(name, arr)`` fills the NDArray ``arr`` in place:
names ending in ``bias``, ``beta`` or ``running_mean`` get zeros,
``gamma`` or ``running_var`` ones, and everything else (weights, BERT's
``position_weight``) the initializer's own draw, from the device's
generator (``mx.random``).  Parity with the
reference's draws is distribution-level.

:func:`init_weights` applies the same policy with Normal(0, std) to every
parameter of a ``torch.nn`` module, drawing from a caller's generator.
"""

from __future__ import annotations

import math

import torch

from .base import MXNetError

__all__ = ["Initializer", "InitDesc", "Zero", "One", "Constant", "Uniform",
           "Normal", "Xavier", "register", "get", "init_weights"]

_REGISTRY = {}


def register(klass):
    _REGISTRY[klass.__name__.lower()] = klass
    return klass


def get(name, **kwargs):
    """An initializer by registered name (``"xavier"``, ``"zeros"`` ...)."""
    if isinstance(name, Initializer):
        return name
    key = name.lower()
    if key not in _REGISTRY:
        raise MXNetError(f"unknown initializer {name!r}; known: "
                         f"{sorted(_REGISTRY)}")
    return _REGISTRY[key](**kwargs)


class InitDesc(str):
    """A parameter's name, carrying init attributes."""

    def __new__(cls, name, attrs=None, global_init=None):
        s = super().__new__(cls, name)
        s.attrs = attrs or {}
        s.global_init = global_init
        return s


class Initializer:
    def __init__(self, **kwargs):
        self._kwargs = kwargs

    def __call__(self, desc, arr):
        if not isinstance(desc, InitDesc):
            desc = InitDesc(desc)
        init_attr = desc.attrs.get("__init__", "")
        if init_attr:
            get(init_attr)._init_weight(desc, arr)
            return
        name = desc.lower()
        if name.endswith(("bias", "beta", "running_mean", "moving_mean")):
            self._init_zero(desc, arr)
        elif name.endswith(("gamma", "running_var", "moving_var")):
            self._init_one(desc, arr)
        else:
            self._init_weight(desc, arr)

    def _init_zero(self, desc, arr):  # noqa: ARG002
        arr[:] = 0.0

    def _init_one(self, desc, arr):  # noqa: ARG002
        arr[:] = 1.0

    def _init_weight(self, desc, arr):
        raise NotImplementedError

    def _rand(self, arr, uniform=None, sigma=None):
        """Fill ``arr`` with U(-uniform, uniform) or N(0, sigma^2) from its
        device's generator."""
        from . import random
        t = arr._data
        gen = random.generator(t.device)
        with torch.no_grad():
            if uniform is not None:
                t.uniform_(-uniform, uniform, generator=gen)
            else:
                t.normal_(0.0, sigma, generator=gen)

    def __repr__(self):
        return f"{type(self).__name__}({self._kwargs})"


@register
class Zero(Initializer):
    def _init_weight(self, desc, arr):
        arr[:] = 0.0


@register
class One(Initializer):
    def _init_weight(self, desc, arr):
        arr[:] = 1.0


@register
class Constant(Initializer):
    def __init__(self, value=0.0):
        super().__init__(value=value)
        self.value = value

    def _init_weight(self, desc, arr):
        arr[:] = self.value


@register
class Uniform(Initializer):
    def __init__(self, scale=0.07):
        super().__init__(scale=scale)
        self.scale = scale

    def _init_weight(self, desc, arr):
        self._rand(arr, uniform=self.scale)


@register
class Normal(Initializer):
    def __init__(self, sigma=0.01):
        super().__init__(sigma=sigma)
        self.sigma = sigma

    def _init_weight(self, desc, arr):
        self._rand(arr, sigma=self.sigma)


def _fan(shape, factor_type):
    hw = math.prod(shape[2:]) if len(shape) > 2 else 1
    fan_in = (shape[1] if len(shape) > 1 else shape[0]) * hw
    fan_out = shape[0] * hw
    if factor_type == "avg":
        return (fan_in + fan_out) / 2.0
    return fan_in if factor_type == "in" else fan_out


@register
class Xavier(Initializer):
    def __init__(self, rnd_type="uniform", factor_type="avg", magnitude=3):
        super().__init__(rnd_type=rnd_type, factor_type=factor_type,
                         magnitude=magnitude)
        self.rnd_type = rnd_type
        self.factor_type = factor_type
        self.magnitude = float(magnitude)

    def _init_weight(self, desc, arr):
        scale = math.sqrt(self.magnitude
                          / max(_fan(arr.shape, self.factor_type), 1.0))
        if self.rnd_type == "uniform":
            self._rand(arr, uniform=scale)
        else:
            self._rand(arr, sigma=scale)


# string aliases the reference accepts
_REGISTRY["zeros"] = Zero
_REGISTRY["ones"] = One
_REGISTRY["gaussian"] = Normal

# name endings that are ones / zeros whatever the initializer draws
_ONES = ("gamma", "norm.weight")
_ZEROS = ("bias", "beta")


@torch.no_grad()
def init_weights(module, generator=None, std=0.02):
    """Fill every parameter of ``module`` in place by the policy above,
    with Normal(0, std) from ``generator`` (which must live on the
    parameters' device)."""
    for name, p in module.named_parameters():
        if name.endswith(_ONES):
            p.fill_(1.0)
        elif name.endswith(_ZEROS):
            p.zero_()
        else:
            p.normal_(0.0, std, generator=generator)
    return module
