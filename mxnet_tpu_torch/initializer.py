"""Weight initializers — the port of ``mxnet_tpu/initializer.py``: the
registry and name lookup (``init="xavier"``), ``InitDesc`` and the
reference's dispatch on the parameter's name, and ``Zero``, ``One``,
``Constant``, ``Uniform``, ``Normal`` and ``Xavier``.

``Initializer.__call__(name, arr)`` fills the NDArray ``arr`` in place:
names ending in ``bias``, ``beta`` or ``running_mean`` get zeros,
``gamma`` or ``running_var`` ones, and everything else (weights, BERT's
``position_weight``) the initializer's own draw, from the device's
generator (``mx.random``).  Parity with the
reference's draws is distribution-level; ``Orthogonal``, ``MSRAPrelu``,
``Bilinear``, ``LSTMBias`` and ``Mixed`` are the reference's too, the
deterministic ones value for value.  One difference: the reference's
``LSTMBias`` sets the forget gate only through ``_init_weight``, so on a
parameter named ``*bias`` (where its dispatch takes ``_init_bias``) it
gives zeros; the port's sets the forget gate there too.

:func:`init_weights` applies the same policy with Normal(0, std) to every
parameter of a ``torch.nn`` module, drawing from a caller's generator.
"""

from __future__ import annotations

import math
import re

import numpy as np
import torch

from .base import MXNetError

__all__ = ["Initializer", "InitDesc", "Zero", "One", "Constant", "Uniform",
           "Normal", "Orthogonal", "Xavier", "MSRAPrelu", "Bilinear",
           "LSTMBias", "Mixed", "register", "get", "init_weights"]

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
        if name.endswith("bias"):
            self._init_bias(desc, arr)
        elif name.endswith(("beta", "running_mean", "moving_mean")):
            self._init_zero(desc, arr)
        elif name.endswith(("gamma", "running_var", "moving_var")):
            self._init_one(desc, arr)
        else:
            self._init_weight(desc, arr)

    def _init_bias(self, desc, arr):
        self._init_zero(desc, arr)

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


@register
class Orthogonal(Initializer):
    """``scale`` times the orthonormal factor of the SVD of a
    U(-1, 1) (``rand_type="uniform"``) or N(0, 1) draw of shape
    (shape[0], prod(shape[1:])): its rows or its columns, whichever side is
    shorter, are orthonormal."""

    def __init__(self, scale=1.414, rand_type="uniform"):
        super().__init__(scale=scale, rand_type=rand_type)
        self.scale = scale
        self.rand_type = rand_type

    def _init_weight(self, desc, arr):
        from . import random
        nout = arr.shape[0]
        nin = math.prod(arr.shape[1:])
        dev = arr._data.device
        gen = random.generator(dev)
        tmp = torch.empty((nout, nin), dtype=torch.float32, device=dev)
        if self.rand_type == "uniform":
            tmp.uniform_(-1.0, 1.0, generator=gen)
        else:
            tmp.normal_(0.0, 1.0, generator=gen)
        u, _, v = torch.linalg.svd(tmp, full_matrices=False)
        q = u if tuple(u.shape) == (nout, nin) else v
        arr[:] = (self.scale * q).reshape(arr.shape).to(arr._data.dtype)


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


@register
class MSRAPrelu(Xavier):
    """He et al.'s initialization for PReLU nets: N(0, 2 / ((1 + slope^2)
    fan))."""

    def __init__(self, factor_type="avg", slope=0.25):
        super().__init__("gaussian", factor_type, 2.0 / (1 + slope ** 2))
        self._kwargs = {"factor_type": factor_type, "slope": slope}


@register
class Bilinear(Initializer):
    """The bilinear upsampling kernel over the last two axes of a
    (C_out, C_in, k, k) deconvolution weight."""

    def _init_weight(self, desc, arr):
        shape = arr.shape
        f = np.ceil(shape[3] / 2.0)
        c = (2 * f - 1 - f % 2) / (2.0 * f)
        i = np.arange(math.prod(shape))
        x = i % shape[3]
        y = (i // shape[3]) % shape[2]
        weight = ((1 - np.abs(x / f - c)) * (1 - np.abs(y / f - c))) \
            .astype(np.float32)
        arr[:] = torch.from_numpy(weight.reshape(shape)).to(arr._data.device,
                                                        arr._data.dtype)


@register
class LSTMBias(Initializer):
    """Zeros, with ``forget_bias`` on the forget gate's slice [n, 2n) of
    an LSTM bias of 4n entries (gates i, f, g, o)."""

    def __init__(self, forget_bias=1.0):
        super().__init__(forget_bias=forget_bias)
        self.forget_bias = forget_bias

    def _init_weight(self, desc, arr):
        v = torch.zeros(arr.shape, dtype=torch.float32)
        n = arr.shape[0] // 4
        v[n:2 * n] = self.forget_bias
        arr[:] = v.to(arr._data.device, arr._data.dtype)

    _init_bias = _init_weight


@register
class Mixed(Initializer):
    """The initializer of the first regex of ``patterns`` that matches the
    parameter's name; a name that none matches raises."""

    def __init__(self, patterns, initializers):
        super().__init__()
        self.map = [(re.compile(p), i) for p, i in zip(patterns, initializers)]

    def __call__(self, desc, arr):
        for pat, init in self.map:
            if pat.match(desc):
                init(desc, arr)
                return
        raise MXNetError(f"no initializer pattern matched {desc!r}; "
                         "add a '.*' catch-all")


# string aliases the reference accepts
_REGISTRY["zeros"] = Zero
_REGISTRY["ones"] = One
_REGISTRY["msra_prelu"] = MSRAPrelu
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
