"""SVRG — the port of ``mxnet_tpu/contrib/svrg.py`` (MXNet's
``python/mxnet/contrib/svrg_optimization/``: SVRGModule and
SVRGOptimizer).

Stochastic variance-reduced gradient (Johnson and Zhang, 2013): every
``update_freq`` epochs take a snapshot w~ of the weights and the full
gradient g_full(w~) over the data; each minibatch step then follows
g_i(w) - g_i(w~) + g_full(w~).  As in the reference it is a small trainer
over Gluon and autograd: the snapshot's gradients come from the same net
with the snapshot weights written in and the live ones written back.
"""

from __future__ import annotations

import numpy as np

from ..base import MXNetError

__all__ = ["SVRGTrainer"]


class SVRGTrainer:
    """SVRG over a Gluon net.

    net : an initialized Block; loss_fn(out, label) -> an NDArray (a
        non-scalar loss is averaged).
    learning_rate : the SGD step on the variance-reduced direction.
    update_freq : epochs between refreshes of the snapshot and its full
        gradient (SVRGModule's update_freq).
    """

    def __init__(self, net, loss_fn, learning_rate=0.01, update_freq=1):
        if update_freq < 1:
            raise MXNetError("update_freq must be >= 1")
        self.net = net
        self.loss_fn = loss_fn
        self.lr = learning_rate
        self.update_freq = update_freq
        self._params = [p for p in net.collect_params().values()
                        if p.grad_req != "null"]
        self._snapshot = None      # w~, numpy
        self._full_grads = None    # g_full(w~), numpy
        self._epoch = 0

    def _grads_at(self, weights, x, y):
        """The minibatch loss's gradients (numpy) and loss at ``weights``
        (None: the live weights, which are restored after)."""
        from .. import autograd
        saved = [p.data().copy() for p in self._params] \
            if weights is not None else None
        try:
            if weights is not None:
                for p, w in zip(self._params, weights):
                    p.set_data(w)
            with autograd.record():
                loss = self.loss_fn(self.net(x), y)
                if loss.shape:
                    loss = loss.mean()
            loss.backward()
            return [np.array(p.grad(stype="default").asnumpy())
                    for p in self._params], float(loss.asnumpy())
        finally:
            if weights is not None:
                for p, w in zip(self._params, saved):
                    p.set_data(w)

    def update_full_grads(self, data_iter):
        """Take the snapshot w~ := w and average the gradient over
        ``data_iter`` at it (SVRGModule.update_full_grads)."""
        self._snapshot = [np.array(p.data().asnumpy())
                          for p in self._params]
        acc, n = None, 0
        for x, y in data_iter:
            grads, _ = self._grads_at(None, x, y)
            if acc is None:
                acc = [g.copy() for g in grads]
            else:
                for a, g in zip(acc, grads):
                    a += g
            n += 1
        if n == 0:
            raise MXNetError("update_full_grads: empty data iterator")
        self._full_grads = [a / n for a in acc]

    def maybe_refresh(self, data_iter):
        """Refresh the snapshot every ``update_freq`` epochs; call once an
        epoch with an iterator over the whole data."""
        if self._epoch % self.update_freq == 0:
            self.update_full_grads(data_iter)
        self._epoch += 1

    def step(self, x, y):
        """One variance-reduced step, w -= lr * (g(w) - g(w~) + g_full);
        returns the minibatch loss at w."""
        from .. import nd
        if self._snapshot is None:
            raise MXNetError("call update_full_grads(...) (or "
                             "maybe_refresh) before step()")
        cur_grads, loss = self._grads_at(None, x, y)
        snap_grads, _ = self._grads_at(self._snapshot, x, y)
        for p, g, gs, gf in zip(self._params, cur_grads, snap_grads,
                                self._full_grads):
            w = p.data()
            p.set_data(w - nd.array(self.lr * (g - gs + gf), ctx=w.ctx))
        return loss
