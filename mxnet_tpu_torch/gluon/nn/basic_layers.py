"""gluon.nn basic layers — the port of
``mxnet_tpu/gluon/nn/basic_layers.py``: Sequential, HybridSequential,
Dense, Dropout, BatchNorm, InstanceNorm, LayerNorm, GroupNorm, Embedding,
Flatten, Lambda, HybridLambda and Activation.
"""

from __future__ import annotations

import math

import numpy as np

from ...base import torch_dtype
from ..block import Block, HybridBlock

__all__ = ["Sequential", "HybridSequential", "Dense", "Dropout", "BatchNorm",
           "InstanceNorm", "LayerNorm", "GroupNorm", "Embedding", "Flatten",
           "Lambda", "HybridLambda", "Activation"]


class _Stack:
    """What Sequential and HybridSequential share: children in order."""

    def add(self, *blocks):
        for block in blocks:
            self.register_child(block)

    def __len__(self):
        return len(self._children)

    def __getitem__(self, key):
        layers = list(self._children.values())
        if isinstance(key, slice):
            net = type(self)(prefix=self._prefix)
            with net.name_scope():
                net.add(*layers[key])
            return net
        return layers[key]

    def __iter__(self):
        return iter(self._children.values())


class Sequential(_Stack, Block):
    def forward(self, x, *args):
        for block in self._children.values():
            x = block(x, *args)
            args = ()
        return x


class HybridSequential(_Stack, HybridBlock):
    def hybrid_forward(self, F, x, *args):  # noqa: ARG002
        for block in self._children.values():
            x = block(x, *args)
            args = ()
        return x


class Dense(HybridBlock):
    """``activation(x W^T + b)`` through the ``FullyConnected`` op; W is
    (units, in_units), deferred while ``in_units`` is 0."""

    def __init__(self, units, activation=None, use_bias=True, flatten=True,
                 dtype=np.float32, weight_initializer=None,
                 bias_initializer="zeros", in_units=0, prefix=None,
                 params=None):
        super().__init__(prefix=prefix, params=params)
        with self.name_scope():
            self._units = units
            self._flatten = flatten
            self.weight = self.params.get(
                "weight", shape=(units, in_units), dtype=dtype,
                init=weight_initializer, allow_deferred_init=True)
            if use_bias:
                self.bias = self.params.get(
                    "bias", shape=(units,), dtype=dtype,
                    init=bias_initializer, allow_deferred_init=True)
            else:
                self.bias = None
            self.act = Activation(activation, prefix=activation + "_") \
                if activation is not None else None

    def infer_param_shapes(self, args):
        x = args[0]
        in_units = math.prod(x.shape[1:]) if self._flatten else x.shape[-1]
        self.weight.shape_mismatch_update((self._units, in_units))

    def hybrid_forward(self, F, x, weight, bias=None):
        out = F.FullyConnected(x, weight, bias, num_hidden=self._units,
                               flatten=self._flatten, no_bias=bias is None)
        return out if self.act is None else self.act(out)

    def __repr__(self):
        shape = self.weight.shape
        return (f"Dense({shape[1] if shape and len(shape) > 1 else None} -> "
                f"{self._units}, "
                f"{'linear' if self.act is None else self.act._act_type})")


class Dropout(HybridBlock):
    def __init__(self, rate, axes=(), **kwargs):
        super().__init__(**kwargs)
        self._rate = rate
        self._axes = axes

    def hybrid_forward(self, F, x):
        if self._rate <= 0:
            return x
        return F.Dropout(x, p=self._rate, axes=self._axes)

    def __repr__(self):
        return f"Dropout(p = {self._rate}, axes={self._axes})"


class BatchNorm(HybridBlock):
    """The ``BatchNorm`` op over ``axis`` with learned gamma, beta and
    moving statistics (``grad_req="null"``), which the op writes back while
    training.  The layer's defaults are not the op's: eps 1e-5, and gamma
    fixed at 1 only when ``scale`` is False."""

    def __init__(self, axis=1, momentum=0.9, epsilon=1e-5, center=True,
                 scale=True, use_global_stats=False, beta_initializer="zeros",
                 gamma_initializer="ones",
                 running_mean_initializer="zeros",
                 running_variance_initializer="ones", in_channels=0,
                 **kwargs):
        super().__init__(**kwargs)
        self._axis = axis
        self._momentum = momentum
        self._epsilon = epsilon
        self._center = center
        self._scale = scale
        self._use_global_stats = use_global_stats
        self.gamma = self.params.get(
            "gamma", grad_req="write" if scale else "null",
            shape=(in_channels,), init=gamma_initializer,
            allow_deferred_init=True, differentiable=scale)
        self.beta = self.params.get(
            "beta", grad_req="write" if center else "null",
            shape=(in_channels,), init=beta_initializer,
            allow_deferred_init=True, differentiable=center)
        self.running_mean = self.params.get(
            "running_mean", grad_req="null", shape=(in_channels,),
            init=running_mean_initializer, allow_deferred_init=True,
            differentiable=False)
        self.running_var = self.params.get(
            "running_var", grad_req="null", shape=(in_channels,),
            init=running_variance_initializer, allow_deferred_init=True,
            differentiable=False)

    def infer_param_shapes(self, args):
        c = args[0].shape[self._axis]
        for p in (self.gamma, self.beta, self.running_mean, self.running_var):
            p.shape_mismatch_update((c,))

    def cast(self, dtype):
        """Gamma, beta and the statistics stay float32 under a dtype
        narrower than 4 bytes (the op normalizes such data in float32)."""
        if torch_dtype(dtype).itemsize < 4:
            dtype = np.float32
        super().cast(dtype)

    def hybrid_forward(self, F, x, gamma, beta, running_mean, running_var):
        return F.BatchNorm(x, gamma, beta, running_mean, running_var,
                           eps=self._epsilon, momentum=self._momentum,
                           fix_gamma=not self._scale,
                           use_global_stats=self._use_global_stats,
                           axis=self._axis)


class InstanceNorm(HybridBlock):
    def __init__(self, axis=1, epsilon=1e-5, center=True, scale=False,
                 beta_initializer="zeros", gamma_initializer="ones",
                 in_channels=0, **kwargs):
        super().__init__(**kwargs)
        self._axis = axis
        self._epsilon = epsilon
        self.gamma = self.params.get(
            "gamma", grad_req="write" if scale else "null",
            shape=(in_channels,), init=gamma_initializer,
            allow_deferred_init=True)
        self.beta = self.params.get(
            "beta", grad_req="write" if center else "null",
            shape=(in_channels,), init=beta_initializer,
            allow_deferred_init=True)

    def infer_param_shapes(self, args):
        c = args[0].shape[self._axis]
        self.gamma.shape_mismatch_update((c,))
        self.beta.shape_mismatch_update((c,))

    def hybrid_forward(self, F, x, gamma, beta):
        if self._axis == 1:
            return F.InstanceNorm(x, gamma, beta, eps=self._epsilon)
        x = x.swapaxes(1, self._axis)
        return F.InstanceNorm(x, gamma, beta,
                              eps=self._epsilon).swapaxes(1, self._axis)


class LayerNorm(HybridBlock):
    def __init__(self, axis=-1, epsilon=1e-5, center=True, scale=True,
                 beta_initializer="zeros", gamma_initializer="ones",
                 in_channels=0, **kwargs):
        super().__init__(**kwargs)
        self._axis = axis
        self._epsilon = epsilon
        self.gamma = self.params.get(
            "gamma", grad_req="write" if scale else "null",
            shape=(in_channels,), init=gamma_initializer,
            allow_deferred_init=True)
        self.beta = self.params.get(
            "beta", grad_req="write" if center else "null",
            shape=(in_channels,), init=beta_initializer,
            allow_deferred_init=True)

    def infer_param_shapes(self, args):
        c = args[0].shape[self._axis]
        self.gamma.shape_mismatch_update((c,))
        self.beta.shape_mismatch_update((c,))

    def hybrid_forward(self, F, x, gamma, beta):
        return F.LayerNorm(x, gamma, beta, axis=self._axis,
                           eps=self._epsilon)


class GroupNorm(HybridBlock):
    def __init__(self, num_groups=1, epsilon=1e-5, center=True, scale=True,
                 beta_initializer="zeros", gamma_initializer="ones",
                 in_channels=0, **kwargs):
        super().__init__(**kwargs)
        self._num_groups = num_groups
        self._epsilon = epsilon
        self.gamma = self.params.get(
            "gamma", grad_req="write" if scale else "null",
            shape=(in_channels,), init=gamma_initializer,
            allow_deferred_init=True)
        self.beta = self.params.get(
            "beta", grad_req="write" if center else "null",
            shape=(in_channels,), init=beta_initializer,
            allow_deferred_init=True)

    def infer_param_shapes(self, args):
        c = args[0].shape[1]
        self.gamma.shape_mismatch_update((c,))
        self.beta.shape_mismatch_update((c,))

    def hybrid_forward(self, F, x, gamma, beta):
        return F.GroupNorm(x, gamma, beta, num_groups=self._num_groups,
                           eps=self._epsilon)


class Embedding(HybridBlock):
    def __init__(self, input_dim, output_dim, dtype=np.float32,
                 weight_initializer=None, sparse_grad=False, **kwargs):
        super().__init__(**kwargs)
        self._input_dim = input_dim
        self._output_dim = output_dim
        self._sparse_grad = sparse_grad
        self.weight = self.params.get(
            "weight", shape=(input_dim, output_dim), dtype=dtype,
            init=weight_initializer)

    def hybrid_forward(self, F, x, weight):
        return F.Embedding(x, weight, input_dim=self._input_dim,
                           output_dim=self._output_dim,
                           sparse_grad=self._sparse_grad)

    def __repr__(self):
        return f"Embedding({self._input_dim} -> {self._output_dim})"


class Flatten(HybridBlock):
    def hybrid_forward(self, F, x):
        return F.flatten(x)

    def __repr__(self):
        return "Flatten"


def _op_by_name(function):
    if isinstance(function, str):
        from ... import ndarray
        return getattr(ndarray, function)
    return function


class Lambda(Block):
    def __init__(self, function, prefix=None):
        super().__init__(prefix=prefix)
        self._func = _op_by_name(function)

    def forward(self, *args):
        return self._func(*args)


class HybridLambda(HybridBlock):
    """``function(*args)``; a string names an op, taken from ``F``."""

    def __init__(self, function, prefix=None):
        super().__init__(prefix=prefix)
        self._func = function

    def hybrid_forward(self, F, *args):
        if isinstance(self._func, str):
            return getattr(F, self._func)(*args)
        return self._func(*args)


class Activation(HybridBlock):
    def __init__(self, activation, **kwargs):
        self._act_type = activation
        super().__init__(**kwargs)

    def _alias(self):
        return self._act_type or "activation"

    def hybrid_forward(self, F, x):
        return F.Activation(x, act_type=self._act_type)

    def __repr__(self):
        return f"Activation({self._act_type})"
