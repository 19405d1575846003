"""Optimizers — the port of ``mxnet_tpu/optimizer.py`` (``Optimizer``,
``SGD``, ``Adam``, ``create``) with the update math of
``mxnet_tpu/ops/optimizer_ops.py::{sgd,sgd_mom,adam}_update``.

MXNet's Adam is not ``torch.optim.Adam``: the bias correction folds into
the learning rate, lr_t = lr * sqrt(1 - beta2^t) / (1 - beta1^t), and
epsilon is added to sqrt(v) of the uncorrected second moment:

    g = clip(rescale_grad * grad, +-clip_gradient) + wd * w
    m = beta1 m + (1 - beta1) g;  v = beta2 v + (1 - beta2) g^2
    w = w - lr_t m / (sqrt(v) + epsilon)

MXNet's SGD, with momentum m (state) when ``momentum`` > 0:

    g = clip(rescale_grad * grad, +-clip_gradient) + wd * w
    m = momentum m - lr g;  w = w + m        (w = w - lr g without momentum)

With ``multi_precision`` a bf16/fp16 weight keeps an f32 master copy and
f32 m, v; the gradient is cast to f32 and after the update the weight is
the master rounded to the weight's dtype.  The reference fuses the update
of many parameters into one XLA program (``optimizer_fusion.py``); the
port's :meth:`Optimizer.update_multi` runs it as ``torch._foreach_*``
library math over all parameters at once.  Updates are in place.
"""

from __future__ import annotations

import math

import torch

from .base import MXNetError

__all__ = ["Optimizer", "SGD", "Adam", "create", "register"]

_REGISTRY = {}


def register(klass):
    _REGISTRY[klass.__name__.lower()] = klass
    return klass


def create(name, **kwargs):
    """An optimizer by registered name (``create("adam", ...)``)."""
    if isinstance(name, Optimizer):
        return name
    key = name.lower()
    if key not in _REGISTRY:
        raise MXNetError(f"unknown optimizer {name!r}; known "
                         f"{sorted(_REGISTRY)}")
    return _REGISTRY[key](**kwargs)


class Optimizer:
    """Base optimizer: learning rate and weight decay with per-parameter
    multipliers (by index), gradient rescaling and clipping, update counts
    and multi-precision state."""

    def __init__(self, rescale_grad=1.0, wd=0.0, clip_gradient=None,
                 learning_rate=0.01, multi_precision=False):
        self.rescale_grad = rescale_grad
        self.lr = learning_rate
        self.wd = wd
        self.clip_gradient = -1.0 if clip_gradient is None \
            else clip_gradient
        self.num_update = 0
        self._index_update_count = {}
        self.multi_precision = multi_precision
        self.lr_mult = {}
        self.wd_mult = {}

    @property
    def learning_rate(self):
        return self.lr

    def set_learning_rate(self, lr):
        self.lr = lr

    def set_lr_mult(self, args_lr_mult):
        self.lr_mult = dict(args_lr_mult)

    def set_wd_mult(self, args_wd_mult):
        self.wd_mult = dict(args_wd_mult)

    def _update_count(self, index):
        count = self._index_update_count.get(index, 0) + 1
        self._index_update_count[index] = count
        self.num_update = max(self.num_update, count)

    def _get_lr(self, index):
        return self.lr * self.lr_mult.get(index, 1.0)

    def _get_wd(self, index):
        return self.wd * self.wd_mult.get(index, 1.0)

    def _prep(self, indices, weights, grads):
        """clip(rescale_grad * grad) + wd * w, as new tensors."""
        g = torch._foreach_mul(grads, self.rescale_grad)
        if self.clip_gradient >= 0:
            torch._foreach_clamp_min_(g, -self.clip_gradient)
            torch._foreach_clamp_max_(g, self.clip_gradient)
        wds = [self._get_wd(i) for i in indices]
        if any(wds):
            torch._foreach_add_(g, torch._foreach_mul(weights, wds))
        return g

    @staticmethod
    def _is_half(dtype):
        return dtype in (torch.float16, torch.bfloat16)

    def _uses_master(self, weight):
        return self.multi_precision and self._is_half(weight.dtype)

    def create_state(self, index, weight):
        raise NotImplementedError

    @torch.no_grad()
    def create_state_multi_precision(self, index, weight):
        """``(f32 master, state of the master)`` for a half weight under
        ``multi_precision``, else the plain state."""
        if self._uses_master(weight):
            master = weight.detach().float()
            return (master, self.create_state(index, master))
        return self.create_state(index, weight)

    def _step(self, indices, weights, grads, states):
        """Update ``weights`` in place (float32 or all one dtype) with
        ``grads`` of the same dtype; counts already advanced."""
        raise NotImplementedError

    @torch.no_grad()
    def update_multi_precision(self, index, weight, grad, state):
        self.update_multi([index], [weight], [grad], [state])

    @torch.no_grad()
    def update_multi(self, indices, weights, grads, states):
        """One update of every parameter in ``weights`` (in place), with the
        multi-precision rule applied per weight.  A ``None`` gradient counts
        as zero, as the reference zero-fills the gradients of parameters
        the loss does not reach."""
        for i in indices:
            self._update_count(i)
        grads = [torch.zeros_like(w) if g is None else g
                 for w, g in zip(weights, grads)]
        groups = {}
        for pos, w in enumerate(weights):
            groups.setdefault((self._uses_master(w), w.dtype), []).append(pos)
        for (master, _), pos in groups.items():
            idx = [indices[p] for p in pos]
            if master:
                self._step(idx, [states[p][0] for p in pos],
                           [grads[p].float() for p in pos],
                           [states[p][1] for p in pos])
                torch._foreach_copy_([weights[p] for p in pos],
                                     [states[p][0] for p in pos])
            else:
                self._step(idx, [weights[p] for p in pos],
                           [grads[p] for p in pos],
                           [states[p] for p in pos])

    def __repr__(self):
        return f"{type(self).__name__}(lr={self.lr})"


@register
class SGD(Optimizer):
    def __init__(self, momentum=0.0, lazy_update=False,  # noqa: ARG002
                 **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum

    def create_state(self, index, weight):
        return torch.zeros_like(weight) if self.momentum else None

    def _step(self, indices, weights, grads, states):
        g = self._prep(indices, weights, grads)
        torch._foreach_mul_(g, [-self._get_lr(i) for i in indices])
        if self.momentum:
            torch._foreach_mul_(states, self.momentum)
            torch._foreach_add_(states, g)
            torch._foreach_add_(weights, states)
        else:
            torch._foreach_add_(weights, g)


@register
class Adam(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon

    def create_state(self, index, weight):
        return (torch.zeros_like(weight), torch.zeros_like(weight))

    def _step(self, indices, weights, grads, states):
        b1, b2 = self.beta1, self.beta2
        lrs = []
        for i in indices:
            t = self._index_update_count[i]
            lrs.append(-self._get_lr(i) * math.sqrt(1.0 - b2 ** t)
                       / (1.0 - b1 ** t))
        ms = [s[0] for s in states]
        vs = [s[1] for s in states]
        g = self._prep(indices, weights, grads)
        torch._foreach_mul_(ms, b1)
        torch._foreach_add_(ms, g, alpha=1.0 - b1)
        torch._foreach_mul_(vs, b2)
        torch._foreach_addcmul_(vs, g, g, value=1.0 - b2)
        del g
        denom = torch._foreach_sqrt(vs)
        torch._foreach_add_(denom, self.epsilon)
        torch._foreach_addcdiv_(weights, ms, denom, lrs)
