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
parameters at once.  As in the reference, every trainable parameter is
updated each step, and one the loss does not reach gets a zero gradient.
``run(stacked_data, stacked_label)`` takes the steps along the leading
axis and returns their losses as one tensor without synchronising each
step (the reference scans the steps in one program; the port loops).

Meshes, sharding rules, data layouts, microbatching, rematerialisation and
autoshard plans are not ported: asking for one raises ``MXNetError``.
"""

from __future__ import annotations

import numpy as np
import torch

from . import autograd, optimizer as opt
from .base import MXNetError
from .gluon.block import Block

__all__ = ["TrainStep"]


def _mesh_size(mesh):
    """Devices in ``mesh``: a device, a sequence of devices, or an object
    with ``devices`` (a device mesh)."""
    if isinstance(mesh, (torch.device, str)):
        return 1
    return int(np.asarray(getattr(mesh, "devices", mesh), dtype=object).size)


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
        if isinstance(self.net, Block):
            return [p.data()._data for p in self.net.collect_params().values()
                    if p.grad_req != "null"]
        return [p for p in self.net.parameters() if p.requires_grad]

    @property
    def device(self):
        return self._trainable()[0].device

    def _resolve(self):
        self._params = self._trainable()
        self._states = [self.optimizer.create_state_multi_precision(i, p)
                        for i, p in enumerate(self._params)]

    def _as_tensor(self, x):
        return torch.as_tensor(x, device=self.device)

    def __call__(self, data, label):
        """Run one step; returns the scalar loss (a tensor on the device,
        not synchronised)."""
        if self._params is None:
            self._resolve()
        data, label = self._as_tensor(data), self._as_tensor(label)
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

    def run(self, data, label):
        """Run one step per entry of the leading axis of ``data``/``label``
        and return the (steps,) losses."""
        data, label = self._as_tensor(data), self._as_tensor(label)
        return torch.stack([self(d, l) for d, l in zip(data, label)])
