"""gluon.Trainer — the port of ``mxnet_tpu/gluon/trainer.py``.

``Trainer(params, optimizer, optimizer_params, kvstore, update_on_kvstore)``
then, after ``loss.backward()``, ``step(batch_size)``: the gradients are
rescaled by 1/batch_size, each parameter's gradients of every context are
summed through the kvstore and written back into every replica, and every
replica is updated by its own ``Updater``, so the replicas stay
identical; each logical step advances the update counts (Adam's t, the
schedule) once.  Every optimizer runs one ``update_multi`` over all
parameters (``torch._foreach_*``; ``optimizer_fusion.fused_update`` for
exact Adam and SGD); with ``MXNET_OPTIMIZER_FUSED=0`` Adam and SGD update
key by key instead, with the same bits.
With ``update_on_kvstore`` the store runs the optimizer on the summed
gradient and ``pull`` hands every replica the updated weight.

The store is skipped, as in the reference (``:99-140``), for a ``local``,
``device`` or ``nccl`` name with one replica and the update on the
trainer: the reduction is then the identity.  ``update_on_kvstore=None``
means False, as in the reference (its documented divergence from MXNet
1.x, which defaults it to True for local stores).  ``allreduce_grads()``
and ``update()`` raise when the store owns the update; ``save_states``/
``load_states`` go through the store then.  States files are the
reference's pickled layout (``optimizer.Updater``), so a file written by
either package's Trainer loads in the other.

``compression_params`` set 2-bit gradient compression on the store
(``kvstore/compression.py``) when there is one; a string store with one
replica is skipped, so then nothing is compressed, as in the reference.

Not ported: the distributed stores raise.
"""

from __future__ import annotations

from .. import kvstore as kvs
from .. import optimizer as opt
from .. import optimizer_fusion
from ..base import MXNetError
from .parameter import Parameter, ParameterDict

__all__ = ["Trainer"]

_SKIPPABLE = ("local", "device", "nccl")


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
        if isinstance(kvstore, str) and kvstore.lower() not in _SKIPPABLE:
            kvstore = kvs.create(kvstore)     # raises for dist_* names
        self._params = list(params)
        optimizer_params = dict(optimizer_params or {})
        self._scale = float(optimizer_params.get("rescale_grad", 1.0))
        self._init_optimizer(optimizer, optimizer_params)
        self._kvstore_type = kvstore
        self._compression_params = compression_params
        self._kvstore = None
        self._kv_initialized = False
        self._update_on_kvstore = bool(update_on_kvstore)

    def _init_optimizer(self, optimizer, optimizer_params):
        param_dict = dict(enumerate(self._params))
        if isinstance(optimizer, opt.Optimizer):
            if set(optimizer_params) - {"rescale_grad"}:
                raise MXNetError("optimizer_params must be None when "
                                 "optimizer is an Optimizer instance")
            self._optimizer = optimizer
            self._optimizer.param_dict = param_dict
        else:
            self._optimizer = opt.create(optimizer, param_dict=param_dict,
                                         **optimizer_params)
        self._updaters = [opt.get_updater(self._optimizer)]

    def _n_ctx(self):
        return max((len(p.list_ctx()) or 1 for p in self._params), default=1)

    def _init_kvstore(self):
        if self._kv_initialized:
            return
        n_ctx = self._n_ctx()     # replicas may appear at the first forward
        while len(self._updaters) < n_ctx:
            self._updaters.append(opt.get_updater(self._optimizer))
        kvt = self._kvstore_type
        if kvt is None or kvt is False:
            if self._update_on_kvstore:
                raise MXNetError("update_on_kvstore=True needs a kvstore")
            self._kvstore = None
        elif isinstance(kvt, str):
            self._kvstore = None if n_ctx <= 1 and not \
                self._update_on_kvstore else kvs.create(kvt)
        else:
            self._kvstore = kvt
        if self._kvstore is not None:
            if self._compression_params:
                self._kvstore.set_gradient_compression(
                    self._compression_params)
            for i, p in enumerate(self._params):
                if p.grad_req != "null":
                    self._kvstore.init(i, p.data())
            if self._update_on_kvstore:
                self._kvstore.set_optimizer(self._optimizer)
        else:
            self._update_on_kvstore = False
        self._kv_initialized = True

    @property
    def learning_rate(self):
        return self._optimizer.learning_rate

    @property
    def optimizer(self):
        return self._optimizer

    @property
    def _states(self):
        """The optimizer state of the first replica, by index."""
        return self._updaters[0].states

    def set_learning_rate(self, lr):
        self._optimizer.set_learning_rate(lr)

    def step(self, batch_size, ignore_stale_grad=False):
        """Rescale the gradients by 1/batch_size, reduce them, update.

        With ``amp.init_trainer`` attached, the rescale also divides by the
        loss scale (unless ``amp.unscale`` did already), and a step whose
        gradients hold a non-finite value updates nothing while the
        dynamic scaler backs off (the reference's amp hand-off)."""
        self._init_kvstore()
        scaler = getattr(self, "_amp_loss_scaler", None)
        if scaler is None:
            self._optimizer.rescale_grad = self._scale / batch_size
        else:
            base = self._amp_original_scale
            scale = base / batch_size
            if not getattr(self, "_amp_grads_unscaled", False):
                scale /= scaler.loss_scale
            self._amp_grads_unscaled = False
            # checked before any update: with update_on_kvstore the store
            # updates inside the reduction
            grads = [g for p in self._params if p.grad_req != "null"
                     and p._data is not None for g in p.list_grad()]
            overflow = scaler.has_overflow(grads)
            self._scale = base
            if overflow:
                return
            self._optimizer.rescale_grad = scale
        self._allreduce_grads()
        if not self._update_on_kvstore:
            self._update(ignore_stale_grad)

    def allreduce_grads(self):
        """Sum each gradient over its contexts, into every replica."""
        self._init_kvstore()
        if self._update_on_kvstore:
            raise MXNetError("allreduce_grads() is invalid with "
                             "update_on_kvstore=True")
        self._allreduce_grads()

    def _trained(self):
        return [(i, p) for i, p in enumerate(self._params)
                if p.grad_req != "null" and p._data is not None]

    def _allreduce_grads(self):
        if self._kvstore is None:
            return
        trained = self._trained()
        if self._update_on_kvstore:
            # the store updates on push; pull hands out the new weights
            for i, p in trained:
                grads, datas = p.list_grad(), p.list_data()
                self._kvstore.push(i, grads if len(grads) > 1 else grads[0])
                self._kvstore.pull(i, datas if len(datas) > 1 else datas[0])
            return
        keys = [i for i, _ in trained]
        vals = [g if len(g) > 1 else g[0]
                for g in (p.list_grad() for _, p in trained)]
        self._kvstore.pushpull_list(keys, vals, vals)

    def update(self, batch_size, ignore_stale_grad=False):
        """The update of ``step`` without the reduction."""
        self._init_kvstore()
        if self._update_on_kvstore:
            raise MXNetError("update() is invalid with "
                             "update_on_kvstore=True")
        self._optimizer.rescale_grad = self._scale / batch_size
        self._update(ignore_stale_grad)

    def _fused_kind(self):
        """``"adam"``/``"sgd"`` when this step's update is
        ``optimizer_fusion.fused_update``, else None: the knob off, another
        optimizer, or the store owns the update."""
        if self._update_on_kvstore or \
                not optimizer_fusion.fusion_active(self._optimizer):
            return None
        return optimizer_fusion.supported_kind(self._optimizer)

    def _update(self, ignore_stale_grad=False):  # noqa: ARG002
        o = self._optimizer
        trained = self._trained()
        if self._fused_kind() is not None:
            run = self._update_fused
        elif optimizer_fusion.supported_kind(o) is not None:
            run = self._update_per_param
        else:
            run = opt.Updater.call_multi
        counts, num = dict(o._index_update_count), o.num_update
        for j, upd in enumerate(self._updaters):
            if j:       # every replica sees the same step count
                o._index_update_count.clear()
                o._index_update_count.update(counts)
                o.num_update = num
            idx = [i for i, p in trained if j < len(p._data_list)]
            if idx:
                run(upd, idx,
                    [self._params[i]._data_list[j]._grad for i in idx],
                    [self._params[i]._data_list[j] for i in idx])

    @staticmethod
    def _update_fused(upd, idx, grads, weights):
        """One ``optimizer_fusion.fused_update`` over all of ``idx``."""
        states = [upd._ensure_state(i, w._data) for i, w in zip(idx, weights)]
        optimizer_fusion.fused_update(upd.optimizer, idx, weights, grads,
                                      states)

    @staticmethod
    def _update_per_param(upd, idx, grads, weights):
        """One update a key, the reference's path with fusion off."""
        for i, g, w in zip(idx, grads, weights):
            upd.call_multi([i], [g], [w])

    def save_states(self, fname):
        """Write the optimizer state and update counts to ``fname``."""
        self._init_kvstore()
        if self._update_on_kvstore:
            self._kvstore.save_optimizer_states(fname)
            return
        with open(fname, "wb") as f:
            f.write(self._updaters[0].get_states())

    def load_states(self, fname):
        self._init_kvstore()
        if self._update_on_kvstore:
            self._kvstore.load_optimizer_states(fname)
            return
        with open(fname, "rb") as f:
            data = f.read()
        for u in self._updaters:
            u.set_states(data)
