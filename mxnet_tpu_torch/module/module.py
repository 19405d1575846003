"""Module — the legacy symbolic training loop, the port of
``mxnet_tpu/module/module.py`` (MXNet's ``python/mxnet/module/{base_module,
module,executor_group}.py``).

``bind`` makes one ``Executor`` per context, each on an even slice of
the batch (MXNet's DataParallelExecutorGroup); ``update`` sums the
gradients of every executor onto the first, updates its parameters once
through the optimizer's ``Updater`` (one ``update_multi`` over all
parameters), averages the auxiliary states (BatchNorm's moving
statistics) over the executors and copies both back to the others.
Batches from an iterator land on each executor's device.

Departures from the reference, each MXNet 1.x's behaviour (ROADMAP
C.7): ``init_optimizer`` sets ``rescale_grad = 1 / batch_size`` when an
optimizer named by a string gets no ``rescale_grad`` (the reference
passes the parameters as given); ``predict`` drops the rows an iterator
padded its last batch with; a ``Module.load`` module's ``bind`` sets the
checkpoint's parameters and its ``init_optimizer`` reads the ``.states``
file (the reference keeps both unused).
"""

from __future__ import annotations

import logging

import torch

from ..base import MXNetError
from ..context import current_context
from .. import initializer as _init
from .. import metric as _metric
from .. import ndarray as nd
from .. import optimizer as _opt
from ..model import BatchEndParam, save_checkpoint
from ..ndarray.ndarray import NDArray

__all__ = ["BaseModule", "Module"]


def _concat_batch(parts):
    """Per-context output slices joined on the batch axis (scalars
    stacked)."""
    if parts[0].ndim == 0:
        return nd.stack(*parts, axis=0)
    return nd.concat(*parts, dim=0)


def _as_list(x):
    return x if isinstance(x, (list, tuple)) else [x]


class BaseModule:
    def __init__(self, logger=logging):
        self.logger = logger
        self.binded = False
        self.for_training = False
        self.params_initialized = False
        self.optimizer_initialized = False

    # -- the loops -------------------------------------------------------------
    def fit(self, train_data, eval_data=None, eval_metric="acc",
            epoch_end_callback=None, batch_end_callback=None, kvstore="local",
            optimizer="sgd", optimizer_params=(("learning_rate", 0.01),),
            eval_end_callback=None, eval_batch_end_callback=None,
            initializer=None, arg_params=None, aux_params=None,
            allow_missing=False, force_rebind=False, force_init=False,
            begin_epoch=0, num_epoch=None, validation_metric=None,
            monitor=None, sparse_row_id_fn=None):  # noqa: ARG002
        if num_epoch is None:
            raise MXNetError("num_epoch must be specified for fit")
        self.bind(data_shapes=train_data.provide_data,
                  label_shapes=train_data.provide_label,
                  for_training=True, force_rebind=force_rebind)
        self.init_params(initializer=initializer or _init.Uniform(0.01),
                         arg_params=arg_params, aux_params=aux_params,
                         allow_missing=allow_missing, force_init=force_init)
        self.init_optimizer(kvstore=kvstore, optimizer=optimizer,
                            optimizer_params=optimizer_params,
                            force_init=force_init)
        if not isinstance(eval_metric, _metric.EvalMetric):
            eval_metric = _metric.create(eval_metric)
        validation_metric = validation_metric or eval_metric
        if monitor is not None:
            monitor.install()

        for epoch in range(begin_epoch, num_epoch):
            eval_metric.reset()
            train_data.reset()
            for nbatch, data_batch in enumerate(train_data):
                if monitor is not None:
                    monitor.tic()
                self.forward_backward(data_batch)
                self.update()
                if monitor is not None:
                    monitor.toc_print()
                self.update_metric(eval_metric, data_batch.label)
                if batch_end_callback is not None:
                    param = BatchEndParam(epoch=epoch, nbatch=nbatch,
                                          eval_metric=eval_metric,
                                          locals=locals())
                    for cb in _as_list(batch_end_callback):
                        cb(param)
            for name, val in eval_metric.get_name_value():
                self.logger.info("Epoch[%d] Train-%s=%f", epoch, name, val)
            if epoch_end_callback is not None:
                arg, aux = self.get_params()
                for cb in _as_list(epoch_end_callback):
                    cb(epoch, self.symbol, arg, aux)
            if eval_data is not None:
                res = self.score(eval_data, validation_metric)
                for name, val in res:
                    self.logger.info("Epoch[%d] Validation-%s=%f",
                                     epoch, name, val)

    def score(self, eval_data, eval_metric, num_batch=None, reset=True,
              epoch=0, **kwargs):  # noqa: ARG002
        if not isinstance(eval_metric, _metric.EvalMetric):
            eval_metric = _metric.create(eval_metric)
        eval_metric.reset()
        if reset:
            eval_data.reset()
        for nbatch, batch in enumerate(eval_data):
            if num_batch is not None and nbatch == num_batch:
                break
            self.forward(batch, is_train=False)
            self.update_metric(eval_metric, batch.label)
        return eval_metric.get_name_value()

    def predict(self, eval_data, num_batch=None, reset=True):
        """Every output over the iterator's batches, joined on the batch
        axis, without the rows of a padded last batch."""
        if reset:
            eval_data.reset()
        outputs = []
        for nbatch, batch in enumerate(eval_data):
            if num_batch is not None and nbatch == num_batch:
                break
            self.forward(batch, is_train=False)
            keep = None if not batch.pad else -batch.pad
            outputs.append([o[:keep].copy() if keep else o.copy()
                            for o in self.get_outputs()])
        if not outputs:
            return []
        return [NDArray(torch.cat([b[i]._data for b in outputs], dim=0),
                        outputs[0][i]._ctx)
                for i in range(len(outputs[0]))]

    def forward_backward(self, data_batch):
        self.forward(data_batch, is_train=True)
        self.backward()

    # what a module implements
    def bind(self, *a, **k):
        raise NotImplementedError

    def forward(self, *a, **k):
        raise NotImplementedError

    def backward(self, *a, **k):
        raise NotImplementedError

    def update(self):
        raise NotImplementedError


class Module(BaseModule):
    def __init__(self, symbol, data_names=("data",),
                 label_names=("softmax_label",), logger=logging,
                 context=None, work_load_list=None, fixed_param_names=None,
                 state_names=None, group2ctxs=None,
                 compression_params=None):  # noqa: ARG002
        super().__init__(logger)
        self._symbol = symbol
        self._data_names = list(data_names)
        self._label_names = list(label_names or [])
        ctxs = context if context is not None else current_context()
        self._contexts = list(ctxs) if isinstance(ctxs, (list, tuple)) \
            else [ctxs]
        self._context = self._contexts[0]
        self._fixed_param_names = set(fixed_param_names or [])
        self._param_names = [n for n in symbol.list_arguments()
                             if n not in self._data_names
                             and n not in self._label_names]
        self._aux_names = symbol.list_auxiliary_states()
        # a parameter's key in the optimizer's state
        self._param_index = {n: i for i, n in enumerate(self._param_names)}
        self._exec = None
        self._execs = []
        self._optimizer = None
        self._updater = None
        self._data_shapes = self._label_shapes = None

    @property
    def symbol(self):
        return self._symbol

    @property
    def data_names(self):
        return self._data_names

    @property
    def output_names(self):
        return self._symbol.list_outputs()

    @property
    def label_shapes(self):
        return self._label_shapes

    @property
    def data_shapes(self):
        return self._data_shapes

    @property
    def output_shapes(self):
        return [(n, o.shape) for n, o in
                zip(self.output_names, self._exec.outputs)]

    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="write"):  # noqa: ARG002
        if self.binded and not force_rebind:
            return
        self._data_shapes = data_shapes
        self._label_shapes = label_shapes
        shapes = {desc[0]: tuple(desc[1])
                  for desc in list(data_shapes) + list(label_shapes or [])}
        n_ctx = len(self._contexts)
        for name, shape in shapes.items():
            if shape[0] % n_ctx:
                raise MXNetError(
                    f"batch dim of {name!r} ({shape[0]}) must divide "
                    f"evenly over {n_ctx} contexts (reference splits by "
                    "workload; even split here)")
        sliced = {n: (s[0] // n_ctx,) + s[1:] for n, s in shapes.items()}
        req = grad_req if for_training else "null"
        shared = [None] * n_ctx if shared_module is None \
            else shared_module._execs
        self._execs = [self._symbol.simple_bind(
            ctx=c, grad_req=req, shared_arg_names=self._param_names,
            shared_exec=sh, **sliced)
            for c, sh in zip(self._contexts, shared)]
        self._exec = self._execs[0]
        self.binded = True
        self.for_training = for_training
        if shared_module is not None:
            # the parameters are the shared module's arrays, and so are
            # their keys in a borrowed optimizer's state
            self.params_initialized = shared_module.params_initialized
            index = dict(shared_module._param_index)
            for n in self._param_names:
                index.setdefault(n, len(index))
            self._param_index = index
        preloaded = getattr(self, "_preloaded_params", None)
        if preloaded is not None:
            self.init_params(arg_params=preloaded[0],
                             aux_params=preloaded[1])

    def init_params(self, initializer=None, arg_params=None, aux_params=None,
                    allow_missing=False, force_init=False,
                    allow_extra=False):  # noqa: ARG002
        if self.params_initialized and not force_init:
            return
        initializer = initializer or _init.Uniform(0.01)
        for names, bound, given in (
                (self._param_names, self._exec.arg_dict, arg_params),
                (self._aux_names, self._exec.aux_dict, aux_params)):
            for name in names:
                arr = bound[name]
                if given and name in given:
                    arr._set_data(given[name]._data)
                else:
                    initializer(_init.InitDesc(name), arr)
        self._broadcast_params()
        self.params_initialized = True

    def _broadcast_params(self):
        """The first executor's parameters and auxiliary states copied to
        every other executor."""
        for e in self._execs[1:]:
            for name in self._param_names:
                e.arg_dict[name]._set_data(self._exec.arg_dict[name]._data)
            for name in self._aux_names:
                e.aux_dict[name]._set_data(self._exec.aux_dict[name]._data)

    def get_params(self):
        arg = {n: self._exec.arg_dict[n].copy() for n in self._param_names}
        aux = {n: self._exec.aux_dict[n].copy() for n in self._aux_names}
        return arg, aux

    def set_params(self, arg_params, aux_params, allow_missing=False,
                   force_init=True, allow_extra=False):
        self.init_params(arg_params=arg_params, aux_params=aux_params,
                         allow_missing=allow_missing, force_init=force_init,
                         allow_extra=allow_extra)

    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):  # noqa: ARG002
        if self.optimizer_initialized and not force_init:
            return
        if isinstance(optimizer, str):
            params = dict(optimizer_params)
            if "rescale_grad" not in params and self._data_shapes:
                # MXNet 1.x: the gradient of a summed loss head over the
                # whole batch, averaged
                params["rescale_grad"] = \
                    1.0 / tuple(self._data_shapes[0][1])[0]
            optimizer = _opt.create(optimizer, **params)
        self._optimizer = optimizer
        self._updater = _opt.get_updater(optimizer)
        preload = getattr(self, "_preload_opt_states", None)
        if preload:
            with open(preload, "rb") as f:
                self._updater.set_states(f.read())
        self.optimizer_initialized = True

    def _slice_for(self, arr, k):
        """The k-th even batch slice of ``arr``, on the k-th context (an
        iterator's batch may lie on another device than the executor)."""
        n = len(self._execs)
        if n == 1:
            return arr.as_in_context(self._contexts[0])
        per = arr.shape[0] // n
        return arr[k * per:(k + 1) * per].as_in_context(self._contexts[k])

    def forward(self, data_batch, is_train=None):
        if is_train is None:
            is_train = self.for_training
        for k, e in enumerate(self._execs):
            feed = {name: self._slice_for(arr, k)
                    for name, arr in zip(self._data_names, data_batch.data)}
            if data_batch.label is not None:
                for name, arr in zip(self._label_names, data_batch.label):
                    if name in e.arg_dict:
                        feed[name] = self._slice_for(arr, k)
            e.forward(is_train=is_train, **feed)

    def backward(self, out_grads=None):
        """One backward a step: each executor frees its recorded graph as
        it goes."""
        for k, e in enumerate(self._execs):
            grads = None if out_grads is None else \
                [self._slice_for(g, k) for g in _as_list(out_grads)]
            e.backward(grads, retain_graph=False)

    def update(self):
        """One optimizer step over every parameter not fixed, from the
        gradients summed over the executors."""
        idx, grads, weights = [], [], []
        for name in self._param_names:
            if name in self._fixed_param_names:
                continue
            g = self._exec.grad_dict.get(name)
            if g is None:
                continue
            if len(self._execs) > 1:
                g = NDArray(sum((e.grad_dict[name]._data.to(g._data.device)
                                 for e in self._execs[1:]), g._data),
                            g._ctx)
            idx.append(self._param_index[name])
            grads.append(g)
            weights.append(self._exec.arg_dict[name])
        if idx:
            self._updater.call_multi(idx, grads, weights)
        if len(self._execs) > 1:
            # each executor updated the statistics from its own slice:
            # their mean goes to all
            with torch.no_grad():
                for name in self._aux_names:
                    acc = self._exec.aux_dict[name]._data
                    total = sum((e.aux_dict[name]._data.to(acc.device)
                                 for e in self._execs[1:]), acc)
                    acc.copy_(total / len(self._execs))
            self._broadcast_params()

    def get_outputs(self, merge_multi_context=True):
        if len(self._execs) == 1:
            return self._exec.outputs
        if not merge_multi_context:
            # grouped per output, one entry per context
            return [[e.outputs[i] for e in self._execs]
                    for i in range(len(self._exec.outputs))]
        return [_concat_batch([e.outputs[i].as_in_context(self._context)
                               for e in self._execs])
                for i in range(len(self._exec.outputs))]

    def get_input_grads(self, merge_multi_context=True):
        if len(self._execs) == 1:
            return [self._exec.grad_dict.get(n) for n in self._data_names]
        if not merge_multi_context:
            return [[e.grad_dict.get(n) for e in self._execs]
                    for n in self._data_names]
        merged = []
        for n in self._data_names:
            parts = [e.grad_dict.get(n) for e in self._execs]
            merged.append(None if any(p is None for p in parts) else
                          _concat_batch([p.as_in_context(self._context)
                                         for p in parts]))
        return merged

    def update_metric(self, eval_metric, labels, pre_sliced=False):  # noqa: ARG002
        eval_metric.update(labels, self.get_outputs())

    def save_checkpoint(self, prefix, epoch, save_optimizer_states=False):
        arg, aux = self.get_params()
        save_checkpoint(prefix, epoch, self._symbol, arg, aux)
        if save_optimizer_states and self._updater is not None:
            with open(f"{prefix}-{epoch:04d}.states", "wb") as f:
                f.write(self._updater.get_states())

    @staticmethod
    def load(prefix, epoch, load_optimizer_states=False, **kwargs):
        """A Module over ``prefix-symbol.json`` whose ``bind`` sets the
        parameters of ``prefix-%04d.params`` (and whose
        ``init_optimizer`` reads ``.states`` when asked)."""
        from ..model import load_checkpoint
        sym, arg, aux = load_checkpoint(prefix, epoch)
        mod = Module(sym, **kwargs)
        mod._preloaded_params = (arg, aux)
        mod._preload_opt_states = f"{prefix}-{epoch:04d}.states" \
            if load_optimizer_states else None
        return mod
