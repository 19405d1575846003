"""gluon.Trainer for one device — the port of
``mxnet_tpu/gluon/trainer.py``.

``Trainer(params, optimizer, optimizer_params)`` then, after
``loss.backward()``, ``step(batch_size)``: the gradients are rescaled by
1/batch_size, reduced (nothing to reduce on one device), and every
parameter with ``grad_req != "null"`` is updated by one
``Optimizer.update_multi`` call over all of them (``torch._foreach_*``).
With ``multi_precision`` a bf16 parameter keeps an f32 master copy in the
optimizer state (``optimizer.py``).

``kvstore`` may be None, ``"device"`` or ``"local"``; distributed stores,
``update_on_kvstore`` and parameters on more than one context are not
ported yet and raise.
"""

from __future__ import annotations

import torch

from .. import optimizer as opt
from ..base import MXNetError
from .parameter import Parameter, ParameterDict

__all__ = ["Trainer"]


class Trainer:
    def __init__(self, params, optimizer, optimizer_params=None,
                 kvstore="device", compression_params=None,
                 update_on_kvstore=None):
        if isinstance(params, (dict, ParameterDict)):
            params = list(params.values())
        if not isinstance(params, (list, tuple)):
            raise MXNetError("first argument must be a list or dict of "
                             "Parameters")
        for p in params:
            if not isinstance(p, Parameter):
                raise MXNetError(f"invalid parameter {p}")
        if kvstore not in (None, False, "device", "local"):
            raise MXNetError(f"kvstore {kvstore!r} is not yet ported to "
                             f"mxnet_tpu_torch (one device: None, 'device' "
                             f"or 'local')")
        if update_on_kvstore or compression_params:
            raise MXNetError("update_on_kvstore and gradient compression "
                             "are not yet ported to mxnet_tpu_torch")
        self._params = list(params)
        optimizer_params = dict(optimizer_params or {})
        self._scale = float(optimizer_params.get("rescale_grad", 1.0))
        if isinstance(optimizer, opt.Optimizer):
            if set(optimizer_params) - {"rescale_grad"}:
                raise MXNetError("optimizer_params must be None when "
                                 "optimizer is an Optimizer instance")
            self._optimizer = optimizer
        else:
            self._optimizer = opt.create(optimizer, **optimizer_params)
        self._optimizer.set_lr_mult({i: p.lr_mult
                                     for i, p in enumerate(self._params)})
        self._optimizer.set_wd_mult({i: p.wd_mult
                                     for i, p in enumerate(self._params)})
        self._states = {}

    @property
    def learning_rate(self):
        return self._optimizer.learning_rate

    @property
    def optimizer(self):
        return self._optimizer

    def set_learning_rate(self, lr):
        self._optimizer.set_learning_rate(lr)

    def step(self, batch_size, ignore_stale_grad=False):
        """Rescale the gradients by 1/batch_size, reduce them, update."""
        self._optimizer.rescale_grad = self._scale / batch_size
        self.allreduce_grads()
        self._update(ignore_stale_grad)

    def allreduce_grads(self):
        """Sum each gradient over its contexts: one context, nothing to
        do."""

    def update(self, batch_size, ignore_stale_grad=False):
        """The update of ``step`` without the reduction."""
        self._optimizer.rescale_grad = self._scale / batch_size
        self._update(ignore_stale_grad)

    def _update(self, ignore_stale_grad=False):  # noqa: ARG002
        idx = [i for i, p in enumerate(self._params)
               if p.grad_req != "null" and p._data is not None]
        for i in idx:
            if i not in self._states:
                self._states[i] = self._optimizer \
                    .create_state_multi_precision(i, self._params[i]._data
                                                  ._data.detach())
        self._optimizer.update_multi(
            idx, [self._params[i]._data._data for i in idx],
            [self._params[i]._data._grad._data for i in idx],
            [self._states[i] for i in idx])

    def save_states(self, fname):
        """Write the optimizer state and update counts to ``fname``."""
        o = self._optimizer
        torch.save({"states": self._states,
                    "index_update_count": o._index_update_count,
                    "num_update": o.num_update}, fname)

    def load_states(self, fname):
        blob = torch.load(fname, weights_only=True)
        self._states = blob["states"]
        self._optimizer._index_update_count = blob["index_update_count"]
        self._optimizer.num_update = blob["num_update"]
