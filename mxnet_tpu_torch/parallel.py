"""One training step on one device — the port of
``mxnet_tpu/parallel.py::TrainStep`` for a single card (its ``n_micro == 1``
body).

``TrainStep(net, loss_fn, optimizer)`` runs

    loss = loss_fn(net(data), label)        # averaged if it has a shape
    loss.backward(); optimizer.update(every trainable parameter)

under ``autograd.train_mode()`` (MXNet's training flag, which Dropout
reads).  ``net`` is a Gluon Block, whose trainable parameters are those of
``collect_params()`` with ``grad_req != "null"``, as in the reference, and
which runs on tensors (its hybridized path); or a plain ``torch.nn.Module``
(the zoo llama), whose trainable parameters are those that require grad.
The reference traces the step into one XLA program; the port runs it
eagerly, with the optimizer's update as ``torch._foreach_*`` math over all
parameters at once.  ``optimizer`` is any optimizer of ``optimizer.py``,
by name or as an object, multi-precision where it has it.  As in the reference, every trainable parameter is
updated each step, and one the loss does not reach gets a zero gradient.
A Gluon net's parameters with ``grad_req="null"`` (BatchNorm's running
statistics) are carried by the step: the forward writes them in place
and the optimizer never touches them.  Deferred shapes (convolutions
with ``in_channels=0``) are resolved before the first step by one
forward under ``autograd.pause()`` (predict mode: the statistics stay).
``run(stacked_data, stacked_label)`` takes the steps along the leading
axis, ``run(data, label, steps=K)`` takes K steps on one batch; both
return the losses as one tensor without synchronising each step (the
reference scans the steps in one program; the port loops).

Meshes, sharding rules, data layouts, microbatching, rematerialisation and
autoshard plans are not ported: asking for one raises ``MXNetError``.
"""

from __future__ import annotations

import numpy as np
import torch

from . import autograd, optimizer as opt
from .base import MXNetError
from .context import resolve_device
from .gluon.block import Block
from .ndarray.ndarray import NDArray

__all__ = ["TrainStep"]


def _mesh_size(mesh):
    """Devices in ``mesh``: a device, a sequence of devices, or an object
    with ``devices`` (a device mesh)."""
    if isinstance(mesh, (torch.device, str)):
        return 1
    return int(np.asarray(getattr(mesh, "devices", mesh), dtype=object).size)


def _net_device(net):
    """The device of ``net``'s parameters: where the first one with a value
    lies (``net.to()`` moves them), else the context a deferred one was
    initialized on."""
    if not isinstance(net, Block):
        return next(net.parameters()).device
    params = list(net.collect_params().values())
    for p in params:
        if p._data is not None:
            return p._data._data.device
    return resolve_device(next(p._ctx for p in params if p._ctx is not None))


class TrainStep:
    """One fused training step of ``net`` under ``loss_fn`` and
    ``optimizer`` (an :class:`~mxnet_tpu_torch.optimizer.Optimizer` or a
    registered name with ``optimizer_params``)."""

    def __init__(self, net, loss_fn, optimizer, optimizer_params=None,
                 mesh=None, partition_rules=None, data_spec=None,
                 n_micro=None, remat=None, plan=None):
        if mesh is not None and _mesh_size(mesh) > 1:
            raise MXNetError("TrainStep: meshes of more than one device are "
                             "not ported to mxnet_tpu_torch")
        for name, value in (("partition_rules", partition_rules),
                            ("data_spec", data_spec), ("remat", remat),
                            ("plan", plan)):
            if value:
                raise MXNetError(f"TrainStep: {name} is not ported to "
                                 f"mxnet_tpu_torch")
        if n_micro is not None and int(n_micro) != 1:
            raise MXNetError("TrainStep: n_micro > 1 (microbatching) is not "
                             "ported to mxnet_tpu_torch")
        self.net = net
        self.loss_fn = loss_fn
        self.optimizer = opt.create(optimizer, **(optimizer_params or {})) \
            if isinstance(optimizer, str) else optimizer
        self._params = None
        self._states = None

    def _trainable(self):
        """The trainable tensors; the optimizer learns their Parameters
        (Gluon) or names (a torch module) by index, as the Trainer tells
        it (LARS reads the names, lr_mult/wd_mult the Parameters)."""
        if isinstance(self.net, Block):
            params = [p for p in self.net.collect_params().values()
                      if p.grad_req != "null"]
            self.optimizer.param_dict = dict(enumerate(params))
            return [p.data()._data for p in params]
        named = [(n, p) for n, p in self.net.named_parameters()
                 if p.requires_grad]
        self.optimizer.idx2name = {i: n for i, (n, _) in enumerate(named)}
        return [p for _, p in named]

    @property
    def device(self):
        return self._params[0].device if self._params \
            else _net_device(self.net)

    def _as_tensor(self, x):
        if isinstance(x, NDArray):
            x = x._data
        return torch.as_tensor(x, device=self.device)

    def _resolve(self, data):
        if isinstance(self.net, Block) and any(
                p._data is None for p in self.net.collect_params().values()):
            with autograd.pause(), torch.no_grad():
                self.net(data)
        self._params = self._trainable()
        self._states = [self.optimizer.create_state_multi_precision(i, p)
                        for i, p in enumerate(self._params)]

    def __call__(self, data, label):
        """Run one step; returns the scalar loss (a tensor on the device,
        not synchronised)."""
        data, label = self._as_tensor(data), self._as_tensor(label)
        if self._params is None:
            self._resolve(data)
        for p in self._params:
            p.grad = None
        with autograd.train_mode():
            loss = self.loss_fn(self.net(data), label)
        if loss.dim():
            loss = loss.mean()
        loss.backward()
        self.optimizer.update_multi(
            list(range(len(self._params))), self._params,
            [p.grad for p in self._params], self._states)
        return loss.detach()

    def run(self, data, label, steps=None):
        """Run one step per entry of the leading axis of ``data``/``label``,
        or ``steps`` steps on the one batch ``data``/``label``; return the
        (steps,) losses."""
        data, label = self._as_tensor(data), self._as_tensor(label)
        if steps is not None:
            return torch.stack([self(data, label) for _ in range(steps)])
        return torch.stack([self(d, l) for d, l in zip(data, label)])
