"""Executor — a bound symbolic graph, the port of
``mxnet_tpu/symbol/executor.py`` (MXNet's ``python/mxnet/executor.py``
over ``src/executor/graph_executor.cc``).

``forward`` evaluates the graph node by node on the bound arrays'
tensors, each op through the registry's dispatch (the cast hook, type
promotion, the device's generator for Dropout); in training mode with a
gradient request the arguments enter as fresh autograd leaves and torch
records the graph, and ``backward`` runs ``torch.autograd.grad`` from
the outputs to those leaves and writes (``grad_req="write"``) or adds
(``"add"``) the result into ``grad_dict``.  Every node's output stays
alive for autograd until the next ``forward``, as the reference's vjp
closure keeps its residuals, so that ``backward`` may run again;
``backward(retain_graph=False)`` frees them as it goes (``Module`` runs
one backward a step).  In training mode the new values of the
variables an op writes (BatchNorm's moving statistics) are copied into
``aux_dict`` after the forward.

API: ``forward(is_train, **kwargs)``, ``backward(out_grads)``,
``outputs``, ``arg_dict``, ``grad_dict``, ``aux_dict``,
``copy_params_from``, ``reshape``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..base import MXNetError
from ..context import resolve_device
from .. import ndarray as nd
from ..ndarray.ndarray import NDArray


def _tensor_of(v):
    return v._data if isinstance(v, NDArray) else torch.as_tensor(
        np.asarray(v))


def _feed(arr, v):
    """Write ``v`` into the bound array ``arr``: in place at the same shape
    (cast to its dtype, moved to its device), else as its new value."""
    t = _tensor_of(v)
    if tuple(t.shape) == arr.shape:
        arr._set_data(t)
    else:
        arr._data = t.detach().to(arr._data.device, arr._data.dtype)


class Executor:
    def __init__(self, symbol, ctx, args, args_grad, grad_req, aux_states):
        self._symbol = symbol
        self._ctx = ctx
        self._device = resolve_device(ctx)
        arg_names = symbol.list_arguments()
        aux_names = symbol.list_auxiliary_states()
        if isinstance(args, (list, tuple)):
            args = dict(zip(arg_names, args))
        if isinstance(args_grad, (list, tuple)):
            args_grad = dict(zip(arg_names, args_grad))
        if isinstance(aux_states, (list, tuple)):
            aux_states = dict(zip(aux_names, aux_states))
        self.arg_dict = dict(args or {})
        self.grad_dict = dict(args_grad or {})
        self.aux_dict = dict(aux_states or {})
        self.grad_req = grad_req
        missing = [a for a in arg_names if a not in self.arg_dict]
        if missing:
            raise MXNetError(f"bind missing arguments: {missing}")
        # one build per train mode; amp needs no rebuild (the reference
        # drops its jitted builds when the dispatch epoch moves): each op
        # meets the cast hook at its own dispatch
        self._builds = {}
        self.outputs = []
        self._recorded = None   # (output tensors, [(name, leaf tensor)])

    def _get_build(self, is_train):
        entry = self._builds.get(is_train)
        if entry is None:
            entry = self._symbol._graph_fn(train_mode=is_train,
                                           collect_mutations=is_train)
            self._builds[is_train] = entry
        return entry

    def _bound(self, name):
        for d in (self.arg_dict, self.aux_dict):
            if name in d:
                return d[name]
        raise MXNetError(f"no value bound for input {name!r}")

    def forward(self, is_train=False, **kwargs):
        from .. import autograd
        run, leaves, mut_specs = self._get_build(is_train)
        self._recorded = None           # the last step's graph goes now
        for k, v in kwargs.items():
            if k in self.arg_dict:
                _feed(self.arg_dict[k], v)
        tensors, grad_leaves = [], []
        for s in leaves:
            t = self._bound(s._name)._data
            if is_train and self.grad_req != "null" \
                    and s._name in self.grad_dict and t.is_floating_point():
                t = t.detach().requires_grad_()
                grad_leaves.append((s._name, t))
            tensors.append(t)
        with torch.set_grad_enabled(bool(grad_leaves)), \
                autograd._scope(training=is_train):
            out, muts = run(tensors, self._device)
        outs = out if isinstance(out, tuple) else (out,)
        with torch.no_grad():
            # BatchNorm's moving statistics land in aux_dict
            for (name, _, _), val in zip(mut_specs, muts):
                dst = self.aux_dict.get(name, self.arg_dict.get(name))
                if dst is not None and val is not dst._data:
                    dst._data.copy_(val)
        if grad_leaves:
            self._recorded = (outs, grad_leaves)
        self.outputs = [NDArray(o.detach(), self._ctx) for o in outs]
        return self.outputs

    def backward(self, out_grads=None, is_train=True,  # noqa: ARG002
                 retain_graph=True):
        if self._recorded is None:
            raise MXNetError("backward requires forward(is_train=True) first")
        outs, grad_leaves = self._recorded
        if out_grads is None:
            seeds = [torch.ones_like(o) for o in outs]
        else:
            if isinstance(out_grads, NDArray):
                out_grads = [out_grads]
            seeds = [_tensor_of(g).to(o.device, o.dtype)
                     for g, o in zip(out_grads, outs)]
        live = [(o, g) for o, g in zip(outs, seeds) if o.requires_grad]
        grads = [None] * len(grad_leaves)
        if live:
            grads = torch.autograd.grad(
                [o for o, _ in live], [t for _, t in grad_leaves],
                [g for _, g in live], retain_graph=retain_graph,
                allow_unused=True)
        if not retain_graph:
            self._recorded = None
        with torch.no_grad():
            for (name, t), g in zip(grad_leaves, grads):
                dst = self.grad_dict[name]
                if g is None:
                    g = torch.zeros_like(t)
                if self.grad_req == "add":
                    dst._data.add_(g)
                else:
                    dst._data.copy_(g)

    @property
    def arg_arrays(self):
        return [self.arg_dict[a] for a in self._symbol.list_arguments()]

    @property
    def grad_arrays(self):
        return [self.grad_dict.get(a)
                for a in self._symbol.list_arguments()]

    @property
    def aux_arrays(self):
        return [self.aux_dict[a]
                for a in self._symbol.list_auxiliary_states()]

    def copy_params_from(self, arg_params, aux_params=None,
                         allow_extra_params=False):
        for k, v in arg_params.items():
            if k in self.arg_dict:
                _feed(self.arg_dict[k], v)
            elif not allow_extra_params:
                raise MXNetError(f"extra param {k}")
        for k, v in (aux_params or {}).items():
            if k in self.aux_dict:
                _feed(self.aux_dict[k], v)
            elif not allow_extra_params:
                raise MXNetError(f"extra aux {k}")

    def reshape(self, partial_shaping=False, allow_up_sizing=False,
                **kwargs):  # noqa: ARG002
        """A new executor with the named arguments at new shapes (zeros);
        the other arguments and the auxiliary states are shared."""
        new_args = dict(self.arg_dict)
        new_args.update({k: nd.zeros(v, ctx=self._ctx)
                         for k, v in kwargs.items() if k in self.arg_dict})
        grads = {k: nd.zeros(v.shape, ctx=self._ctx)
                 for k, v in new_args.items()} \
            if self.grad_req != "null" else None
        return Executor(self._symbol, self._ctx, new_args, grads,
                        self.grad_req, dict(self.aux_dict))
