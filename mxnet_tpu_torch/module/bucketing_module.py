"""BucketingModule — the port of ``mxnet_tpu/module/bucketing_module.py``
(MXNet's ``python/mxnet/module/bucketing_module.py``): variable-length
training with one ``Module`` per bucket key.  Every bucket binds over the
default bucket's parameter, gradient and auxiliary arrays
(``bind(shared_module=)``, as MXNet does), so a switch copies nothing; the
reference gives each bucket arrays of its own and copies the parameters
over at each switch.

The buckets share one optimizer and its state, as MXNet's
``borrow_optimizer`` does; the reference gives each bucket an optimizer
of its own, whose Adam moments see only that bucket's steps (ROADMAP
C.7).
"""

from __future__ import annotations

import logging

from ..base import MXNetError
from .module import BaseModule, Module


class BucketingModule(BaseModule):
    def __init__(self, sym_gen, default_bucket_key=None, logger=logging,
                 context=None, **kwargs):
        super().__init__(logger)
        if default_bucket_key is None:
            raise MXNetError("default_bucket_key required")
        self._sym_gen = sym_gen
        self._default_key = default_bucket_key
        self._context = context
        self._kwargs = kwargs
        self._buckets = {}
        self._curr_module = None
        self._curr_key = None

    @property
    def symbol(self):
        return self._curr_module.symbol

    def _module_for(self, key):
        if key not in self._buckets:
            sym, data_names, label_names = self._sym_gen(key)
            self._buckets[key] = Module(sym, data_names, label_names,
                                        self.logger, self._context,
                                        **self._kwargs)
        return self._buckets[key]

    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, **kwargs):  # noqa: ARG002
        self._curr_module = self._module_for(self._default_key)
        self._curr_key = self._default_key
        self._curr_module.bind(data_shapes, label_shapes, for_training,
                               force_rebind=force_rebind)
        self.binded = True
        self.for_training = for_training

    def switch_bucket(self, bucket_key, data_shapes, label_shapes=None):
        mod = self._module_for(bucket_key)
        if not mod.binded:
            mod.bind(data_shapes, label_shapes, self.for_training,
                     shared_module=self._buckets[self._default_key])
        mod.params_initialized = self.params_initialized
        if self.optimizer_initialized and not mod.optimizer_initialized:
            # one optimizer and one state per parameter for all buckets
            mod._optimizer = self._curr_module._optimizer
            mod._updater = self._curr_module._updater
            mod.optimizer_initialized = True
        self._curr_module = mod
        self._curr_key = bucket_key

    def init_params(self, **kwargs):
        self._curr_module.init_params(**kwargs)
        self.params_initialized = True

    def get_params(self):
        return self._curr_module.get_params()

    def set_params(self, arg_params, aux_params, **kwargs):
        self._curr_module.set_params(arg_params, aux_params, **kwargs)
        self.params_initialized = True

    def init_optimizer(self, **kwargs):
        self._curr_module.init_optimizer(**kwargs)
        self.optimizer_initialized = True

    def forward(self, data_batch, is_train=None):
        key = getattr(data_batch, "bucket_key", None)
        if key is None:
            key = self._default_key
        if key != self._curr_key:
            self.switch_bucket(key, data_batch.provide_data,
                               data_batch.provide_label)
        self._curr_module.forward(data_batch, is_train)

    def backward(self, out_grads=None):
        self._curr_module.backward(out_grads)

    def update(self):
        self._curr_module.update()

    def get_outputs(self, merge_multi_context=True):
        return self._curr_module.get_outputs(merge_multi_context)

    def update_metric(self, eval_metric, labels, pre_sliced=False):
        self._curr_module.update_metric(eval_metric, labels, pre_sliced)
