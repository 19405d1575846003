"""Optimizers — the port of ``mxnet_tpu/optimizer.py``: the ``Optimizer``
base with its registry (``create``), the eleven optimizers of the
reference (SGD, NAG, Adam, AdamW, LARS, RMSProp, Ftrl, Signum/SignSGD,
LAMB, AdaGrad, AdaDelta), ``Updater`` and ``get_updater``.

Each optimizer's arithmetic lives once, in ``ops/optimizer_ops.py``, as an
in-place ``torch._foreach_*`` update of lists of tensors; the registry ops
``mx.nd.*_update`` call the same functions.  :meth:`Optimizer.update_multi`
runs one such pass over every parameter of a dtype at once (the reference
fuses them into one XLA program, ``optimizer_fusion.py``).

MXNet's Adam is not ``torch.optim.Adam``: the bias correction folds into
the learning rate, lr_t = lr * sqrt(1 - beta2^t) / (1 - beta1^t), and
epsilon is added to sqrt(v) of the uncorrected second moment.  The
learning rate of a parameter is the schedule's value at ``num_update``
(the largest per-index update count; ``lr_scheduler``) or ``lr``, times
its ``lr_mult`` (read from the Parameter in ``param_dict``, else from
``set_lr_mult`` by index and by name); weight decay likewise with
``wd_mult``.

With ``multi_precision`` a bf16/fp16 weight keeps an f32 master copy: its
state is ``(master, state of the master)``, the gradient is cast to f32,
and after the update the weight is the master rounded to its dtype.
Weights, gradients and states are ``torch.Tensor``s (an NDArray is taken
by its tensor); updates are in place.  The per-step scalars (the rates,
the update count ``t``, ``rescale_grad``) may be 0-d device tensors
instead of Python numbers: ``parallel.TrainStep`` swaps ``_get_lr``,
``_index_update_count`` and ``rescale_grad`` for such tensors while it
runs an update, as the reference swaps traced values in, and keeps the
host's bookkeeping (counts, schedules) itself.
"""

from __future__ import annotations

import math
import pickle

import numpy as np
import torch

from .base import MXNetError
from .ops import optimizer_ops as F

__all__ = ["Optimizer", "SGD", "Adam", "AdamW", "NAG", "LARS", "RMSProp",
           "Ftrl", "Signum", "SignSGD", "LAMB", "AdaGrad", "AdaDelta",
           "create", "register", "Updater", "get_updater"]

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


def _tensor(x):
    """The tensor of an NDArray, or the tensor itself."""
    return getattr(x, "_data", x)


class Optimizer:
    """Base optimizer: learning rate (scheduled or fixed) and weight decay
    with per-parameter multipliers, gradient rescaling and clipping, update
    counts and multi-precision state."""

    def __init__(self, rescale_grad=1.0, param_idx2name=None, wd=0.0,
                 clip_gradient=None, learning_rate=0.01, lr_scheduler=None,
                 sym=None, begin_num_update=0,  # noqa: ARG002
                 multi_precision=False, param_dict=None, aggregate_num=0):
        self.aggregate_num = int(aggregate_num)
        self.rescale_grad = rescale_grad
        self.lr = learning_rate
        self.lr_scheduler = lr_scheduler
        if lr_scheduler is not None:
            self.lr_scheduler.base_lr = learning_rate
        self.wd = wd
        self.clip_gradient = -1.0 if clip_gradient is None \
            else clip_gradient
        self.begin_num_update = begin_num_update
        self.num_update = begin_num_update
        self._index_update_count = {}
        self.multi_precision = multi_precision
        self.idx2name = dict(param_idx2name or {})
        self.param_dict = dict(param_dict or {})
        self.lr_mult = {}
        self.wd_mult = {}

    # -- learning rate and weight decay --------------------------------------
    @property
    def learning_rate(self):
        if self.lr_scheduler is not None:
            return self.lr_scheduler(self.num_update)
        return self.lr

    def set_learning_rate(self, lr):
        if self.lr_scheduler is not None:
            raise MXNetError("cannot set lr directly when lr_scheduler is "
                             "set")
        self.lr = lr

    def set_lr_mult(self, args_lr_mult):
        self.lr_mult = dict(args_lr_mult)

    def set_wd_mult(self, args_wd_mult):
        self.wd_mult = dict(args_wd_mult)

    def _update_count(self, index):
        if index not in self._index_update_count:
            self._index_update_count[index] = self.begin_num_update
        self._index_update_count[index] += 1
        self.num_update = max(self.num_update,
                              self._index_update_count[index])

    def _mult(self, index, mults, attr):
        param = self.param_dict.get(index)
        if param is not None:
            return getattr(param, attr)
        return mults.get(index, 1.0) * mults.get(
            self.idx2name.get(index, ""), 1.0)

    def _get_lr(self, index):
        lr = self.lr_scheduler(self.num_update) if self.lr_scheduler \
            else self.lr
        return lr * self._mult(index, self.lr_mult, "lr_mult")

    def _get_wd(self, index):
        return self.wd * self._mult(index, self.wd_mult, "wd_mult")

    def _hyper(self, indices):
        """The per-parameter lists the formulas take: lr, wd, and the
        common gradient arguments."""
        return ([self._get_lr(i) for i in indices],
                [self._get_wd(i) for i in indices],
                {"rescale_grad": self.rescale_grad,
                 "clip_gradient": self.clip_gradient})

    # -- state ---------------------------------------------------------------
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
        weight = _tensor(weight)
        if self._uses_master(weight):
            master = weight.detach().float()
            return (master, self.create_state(index, master))
        return self.create_state(index, weight.detach())

    # -- updates -------------------------------------------------------------
    def _step(self, indices, weights, grads, states):
        """Update ``weights`` in place (all of one dtype) with ``grads`` of
        that dtype; counts already advanced."""
        raise NotImplementedError

    @torch.no_grad()
    def update(self, index, weight, grad, state):
        """One update of one weight, without the multi-precision rule."""
        self._update_count(index)
        self._step([index], [_tensor(weight)], [_tensor(grad)], [state])

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
        weights = [_tensor(w) for w in weights]
        grads = [torch.zeros_like(w) if g is None else _tensor(g)
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
        return f"{type(self).__name__}(lr={self.learning_rate})"


def _part(states, k):
    return [s[k] for s in states]


@register
class SGD(Optimizer):
    def __init__(self, momentum=0.0, lazy_update=False,  # noqa: ARG002
                 **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum

    def create_state(self, index, weight):
        return torch.zeros_like(weight) if self.momentum else None

    def _step(self, indices, weights, grads, states):
        lrs, wds, kw = self._hyper(indices)
        F.sgd(weights, grads, states if self.momentum else None, lrs, wds,
              self.momentum, **kw)


@register
class LARS(Optimizer):
    """Layer-wise Adaptive Rate Scaling: each weight's lr scales by its
    trust ratio, except for ``bias``, ``gamma`` and ``beta`` parameters
    (by name, from ``param_idx2name`` or the Parameter), which take plain
    momentum SGD."""

    def __init__(self, momentum=0.9, eta=0.001, epsilon=1e-8, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum
        self.eta = eta
        self.epsilon = epsilon

    def create_state(self, index, weight):
        return torch.zeros_like(weight)

    def _skip_trust(self, index):
        name = self.idx2name.get(index, "")
        if not name:
            name = getattr(self.param_dict.get(index), "name", "") or ""
        return name.endswith(("bias", "gamma", "beta"))

    def _step(self, indices, weights, grads, states):
        skip = [self._skip_trust(i) for i in indices]
        for flag, formula, extra in (
                (True, F.sgd, {}),
                (False, F.lars, {"eta": self.eta, "epsilon": self.epsilon})):
            pos = [p for p, s in enumerate(skip) if s is flag]
            if not pos:
                continue
            idx = [indices[p] for p in pos]
            lrs, wds, kw = self._hyper(idx)
            formula([weights[p] for p in pos], [grads[p] for p in pos],
                    [states[p] for p in pos], lrs, wds,
                    momentum=self.momentum, **extra, **kw)


@register
class NAG(Optimizer):
    def __init__(self, momentum=0.0, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum

    def create_state(self, index, weight):
        return torch.zeros_like(weight) if self.momentum else None

    def _step(self, indices, weights, grads, states):
        lrs, wds, kw = self._hyper(indices)
        if self.momentum:
            F.nag(weights, grads, states, lrs, wds, self.momentum, **kw)
        else:
            F.sgd(weights, grads, None, lrs, wds, **kw)


@register
class Adam(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, lazy_update=False,  # noqa: ARG002
                 **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon

    def create_state(self, index, weight):
        return (torch.zeros_like(weight), torch.zeros_like(weight))

    def _step(self, indices, weights, grads, states):
        b1, b2 = self.beta1, self.beta2
        lrs, wds, kw = self._hyper(indices)
        ts = [self._index_update_count[i] for i in indices]
        if isinstance(ts[0], torch.Tensor):  # one device count: one factor
            corr = torch.sqrt(1.0 - b2 ** ts[0]) / (1.0 - b1 ** ts[0])
            lrs = F._per_scalar(lambda lr: lr * corr, lrs)
        else:                                # bias correction folded in
            lrs = [lr * (math.sqrt(1.0 - b2 ** t) / (1.0 - b1 ** t))
                   for lr, t in zip(lrs, ts)]
        F.adam(weights, grads, _part(states, 0), _part(states, 1), lrs, wds,
               b1, b2, self.epsilon, **kw)


@register
class AdamW(Optimizer):
    """Adam with decoupled weight decay, no bias correction (the
    reference's ``adamw_update``)."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, eta=1.0, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2, self.epsilon, self.eta = \
            beta1, beta2, epsilon, eta

    def create_state(self, index, weight):
        return (torch.zeros_like(weight), torch.zeros_like(weight))

    def _step(self, indices, weights, grads, states):
        lrs, wds, kw = self._hyper(indices)
        F.adamw(weights, grads, _part(states, 0), _part(states, 1), lrs, wds,
                self.beta1, self.beta2, self.epsilon, self.eta, **kw)


@register
class RMSProp(Optimizer):
    def __init__(self, learning_rate=0.001, gamma1=0.9, gamma2=0.9,
                 epsilon=1e-8, centered=False, clip_weights=None, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.gamma1, self.gamma2 = gamma1, gamma2
        self.epsilon = epsilon
        self.centered = centered
        self.clip_weights = clip_weights if clip_weights is not None \
            else -1.0

    def create_state(self, index, weight):
        return tuple(torch.zeros_like(weight)
                     for _ in range(3 if self.centered else 1))

    def _step(self, indices, weights, grads, states):
        lrs, wds, kw = self._hyper(indices)
        if self.centered:
            F.rmspropalex(weights, grads, _part(states, 0),
                          _part(states, 1), _part(states, 2), lrs, wds,
                          self.gamma1, self.gamma2, self.epsilon,
                          clip_weights=self.clip_weights, **kw)
        else:
            F.rmsprop(weights, grads, _part(states, 0), lrs, wds,
                      self.gamma1, self.epsilon,
                      clip_weights=self.clip_weights, **kw)


@register
class Ftrl(Optimizer):
    def __init__(self, lamda1=0.01, learning_rate=0.1, beta=1.0, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.lamda1 = lamda1
        self.beta = beta

    def create_state(self, index, weight):
        return (torch.zeros_like(weight), torch.zeros_like(weight))

    def _step(self, indices, weights, grads, states):
        lrs, wds, kw = self._hyper(indices)
        F.ftrl(weights, grads, _part(states, 0), _part(states, 1), lrs, wds,
               self.lamda1, self.beta, **kw)


@register
class Signum(Optimizer):
    """Signum (momentum of the sign), signSGD when ``momentum`` is 0."""

    def __init__(self, learning_rate=0.01, momentum=0.9, wd_lh=0.0,
                 **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.momentum = momentum
        self.wd_lh = wd_lh

    def create_state(self, index, weight):
        return torch.zeros_like(weight) if self.momentum else None

    def _step(self, indices, weights, grads, states):
        lrs, wds, kw = self._hyper(indices)
        F.signum(weights, grads, states if self.momentum else None, lrs, wds,
                 self.momentum, self.wd_lh, **kw)


SignSGD = Signum


@register
class LAMB(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-6, lower_bound=None, upper_bound=None,
                 bias_correction=True, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon
        self.lower_bound = lower_bound if lower_bound is not None else -1.0
        self.upper_bound = upper_bound if upper_bound is not None else -1.0
        self.bias_correction = bias_correction

    def create_state(self, index, weight):
        return (torch.zeros_like(weight), torch.zeros_like(weight))

    def _step(self, indices, weights, grads, states):
        lrs, wds, kw = self._hyper(indices)
        F.lamb(weights, grads, _part(states, 0), _part(states, 1), lrs, wds,
               [self._index_update_count[i] for i in indices], self.beta1,
               self.beta2, self.epsilon, self.bias_correction,
               self.lower_bound, self.upper_bound, **kw)


@register
class AdaGrad(Optimizer):
    def __init__(self, eps=1e-7, learning_rate=0.01, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.float_stable_eps = eps

    def create_state(self, index, weight):
        return torch.zeros_like(weight)

    def _step(self, indices, weights, grads, states):
        lrs, wds, kw = self._hyper(indices)
        F.adagrad(weights, grads, states, lrs, wds, self.float_stable_eps,
                  **kw)


@register
class AdaDelta(Optimizer):
    """AdaDelta: no learning rate, as in the reference."""

    def __init__(self, rho=0.90, epsilon=1e-5, **kwargs):
        super().__init__(**kwargs)
        self.rho = rho
        self.epsilon = epsilon

    def create_state(self, index, weight):
        return (torch.zeros_like(weight), torch.zeros_like(weight))

    def _step(self, indices, weights, grads, states):
        _, wds, kw = self._hyper(indices)
        F.adadelta(weights, grads, _part(states, 0), _part(states, 1), wds,
                   self.rho, self.epsilon, **kw)


# -- Updater: the state-owning closure (kvstore, Trainer) -------------------

class Updater:
    """Holds the optimizer state by index and applies updates: the object
    the reference hands its kvstore (``update_on_kvstore``) and keeps one
    of per replica in the Trainer.  ``get_states``/``set_states`` write and
    read the reference's pickled layout (numpy arrays, update counts), so
    a states file crosses between the two packages."""

    def __init__(self, optimizer):
        self.optimizer = optimizer
        self.states = {}
        self.states_synced = {}

    def __call__(self, index, grad, weight):
        self.call_multi([index], [grad], [weight])

    def _ensure_state(self, index, weight):
        if index not in self.states:
            self.states[index] = \
                self.optimizer.create_state_multi_precision(index, weight)
            self.states_synced[index] = True
        elif not self.states_synced.get(index, True):
            # loaded states are host f32/f16 arrays: put them where the
            # weight is, in its dtype (a master and its state stay f32)
            keep = self.optimizer._uses_master(weight)
            self.states[index] = _state_to(
                self.states[index], weight.device,
                None if keep else weight.dtype)
            self.states_synced[index] = True
        return self.states[index]

    def call_multi(self, indices, grads, weights):
        """One ``update_multi`` over all of ``indices``."""
        weights = [_tensor(w) for w in weights]
        states = [self._ensure_state(i, w) for i, w in zip(indices, weights)]
        self.optimizer.update_multi(indices, weights, grads, states)

    def get_states(self, dump_optimizer=False):  # noqa: ARG002
        o = self.optimizer
        return pickle.dumps({
            "states": {k: _state_to_numpy(s) for k, s in self.states.items()},
            "index_update_count": dict(o._index_update_count),
            "num_update": o.num_update})

    def set_states(self, states):
        flat = pickle.loads(states)
        if isinstance(flat, dict) and "states" in flat \
                and "num_update" in flat:
            self.optimizer._index_update_count = dict(
                flat["index_update_count"])
            self.optimizer.num_update = flat["num_update"]
            flat = flat["states"]
        self.states = {k: _state_from_numpy(v) for k, v in flat.items()}
        self.states_synced = dict.fromkeys(self.states, False)


def _state_map(st, fn):
    if st is None:
        return None
    if isinstance(st, (list, tuple)):
        return type(st)(_state_map(s, fn) for s in st)
    return fn(st)


def _state_to_numpy(st):
    # numpy has no bfloat16: such a state travels as f32 (exact) and is
    # cast back to the weight's dtype when it is next used
    return _state_map(st, lambda t: t.detach().float().cpu().numpy()
                      if t.dtype == torch.bfloat16
                      else t.detach().cpu().numpy())


def _from_numpy(a):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":      # the reference's ml_dtypes arrays
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _state_from_numpy(st):
    return _state_map(st, _from_numpy)


def _state_to(st, device, dtype):
    return _state_map(st, lambda t: t.to(device, dtype or t.dtype))


def get_updater(optimizer):
    return Updater(optimizer)
