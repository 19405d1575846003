"""One training step on one device — the port of
``mxnet_tpu/parallel.py::TrainStep`` for a single card.

``TrainStep(net, loss_fn, optimizer)`` runs

    loss = loss_fn(net(data), label)        # averaged if it has a shape
    loss.backward(); optimizer.update(every trainable parameter)

under ``autograd.train_mode()`` (MXNet's training flag, which Dropout
reads).  ``net`` is a Gluon Block, whose trainable parameters are those of
``collect_params()`` with ``grad_req != "null"``, as in the reference, and
which runs on tensors (its hybridized path); or a plain ``torch.nn.Module``,
whose trainable parameters are those that require grad.  ``optimizer`` is
any optimizer of ``optimizer.py``, by name or as an object,
multi-precision where it has it, its update ``torch._foreach_*`` math over
all parameters at once.  As in the reference, every trainable parameter
is updated each step, and one the loss does not reach gets a zero
gradient.  A Gluon net's parameters with ``grad_req="null"`` (BatchNorm's
running statistics) are carried by the step: the forward writes them in
place and the optimizer never touches them.  Deferred shapes
(convolutions with ``in_channels=0``) are resolved before the first step
by one forward under ``autograd.pause()`` (predict mode: the statistics
stay).

``n_micro`` (default ``MXNET_MICROBATCH``) splits the batch into
``n_micro`` slices along its first axis: their gradients accumulate in
slice order (slice 0 first), the sum is multiplied by ``1/n_micro`` in the
gradient's dtype, and one optimizer update follows; the loss is
``sum(slice losses) * (1/n_micro)``.  ``n_micro=1`` is the single-pass
step.  ``remat`` (default ``MXNET_REMAT``) runs the net's forward under
``gluon.utils.remat_call``.  ``donate`` is accepted for the reference's
signature and changes nothing: the port updates parameters and state in
place already.

On the card the step is one CUDA graph per (data shape, dtype, label
shape, dtype), the counterpart of the reference's one ``jax.jit`` program
per signature.  The first call of a signature runs eagerly on a side
stream (building kernel libraries and library handles); the second
captures the step into a graph and replays it; later calls replay.  The
batch is copied into the graph's static input buffers, and the per-step
scalars (each parameter's learning rate from the schedule and
multipliers, the update count ``t`` of bias corrections, ``rescale_grad``)
are written into device tensors that the update reads, so a schedule
moves the captured step as the reference's traced arguments do; the
host keeps the counts and schedules.  The graphs of one step share one
memory pool; the device's generator is registered with each, so every
replay draws new dropout masks.  The loss returned is a copy.  On the CPU
the same body runs eagerly on every call.

A replay runs no Python: whatever the forward reads from Python attributes
(a length set on the net, a flag) is frozen at capture, as the reference's
trace freezes it.  Pass what changes between steps as data.  A forward
that reads a device value back to the host (``.item()``, ``nonzero``,
NMS) cannot be captured: the capture raises ``MXNetError`` and nothing
runs eagerly in its place.  Neither can a step whose parameters an eager
graph still references (a loss kept from an earlier ``autograd.record``
forward): their gradient accumulators belong to the default stream, which
a capture may not wait on.  Drop such references first.  The graphs are dropped, and the next call of a
signature warms up again, when ``amp`` is turned on or off (the dispatch
epoch), when a parameter or state tensor of the net was replaced
(``cast``, a new context; ``load_parameters`` and ``set_data`` write in
place) or when the device's generator was (``mx.random.seed``).  The
flash kernels' launch counters count in Python, so each replay adds the
counts its capture saw.

``run(stacked_data, stacked_label)`` takes the steps along the leading
axis, ``run(data, label, steps=K)`` takes K steps on one batch; both
return the losses as one tensor, step by step, without synchronising (the
reference scans the steps in one program).  Meshes of more than one
device, sharding rules, data layouts and autoshard plans are not ported:
asking for one raises ``MXNetError``.
"""

from __future__ import annotations

import numpy as np
import torch

from . import autograd, config, optimizer as opt, random
from .base import MXNetError
from .context import resolve_device
from .gluon.block import Block
from .gluon.utils import _block_tensors, remat_call
from .kernels import flash_attention as _fa
from .ndarray.ndarray import NDArray
from .ops import registry

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


def _flat(state, out):
    """The tensors of an optimizer state (None, a tensor or nested
    tuples), appended to ``out``."""
    if isinstance(state, torch.Tensor):
        out.append(state)
    elif isinstance(state, (list, tuple)):
        for s in state:
            _flat(s, out)
    return out


def _launch_counts():
    return [getattr(_fa, name) for name in _fa.COUNTERS]


def _set_launch_counts(values):
    for name, v in zip(_fa.COUNTERS, values):
        setattr(_fa, name, v)


class _StepCount(dict):
    """The optimizer's ``_index_update_count`` while an update runs: the
    step's count ``t``, a device tensor, for every index."""

    def __init__(self, t):
        super().__init__()
        self._t = t

    def __getitem__(self, index):
        return self._t

    def get(self, index, default=None):  # noqa: ARG002
        return self._t


class _Graph:
    """One captured step: its graph, static inputs, loss and the launch
    counts its capture saw."""

    def __init__(self, graph, data, label, loss, counts):
        self.graph, self.data, self.label = graph, data, label
        self.loss, self.counts = loss, counts


class TrainStep:
    """One fused training step of ``net`` under ``loss_fn`` and
    ``optimizer`` (an :class:`~mxnet_tpu_torch.optimizer.Optimizer` or a
    registered name with ``optimizer_params``)."""

    def __init__(self, net, loss_fn, optimizer, optimizer_params=None,
                 mesh=None, donate=True, partition_rules=None,
                 data_spec=None, n_micro=None, remat=None, plan=None):
        if mesh is not None and _mesh_size(mesh) > 1:
            raise MXNetError("TrainStep: meshes of more than one device are "
                             "not ported to mxnet_tpu_torch")
        for name, value in (("partition_rules", partition_rules),
                            ("data_spec", data_spec), ("plan", plan)):
            if value:
                raise MXNetError(f"TrainStep: {name} is not ported to "
                                 f"mxnet_tpu_torch")
        if n_micro is None:
            n_micro = max(1, config.get_int("MXNET_MICROBATCH", 1))
        n_micro = int(n_micro)
        if n_micro < 1:
            raise MXNetError(f"n_micro must be >= 1, got {n_micro}")
        self._n_micro = n_micro
        self._remat = bool(config.get_int("MXNET_REMAT", 0)) \
            if remat is None else bool(remat)
        del donate              # the updates are in place already
        self.net = net
        self.loss_fn = loss_fn
        self.optimizer = opt.create(optimizer, **(optimizer_params or {})) \
            if isinstance(optimizer, str) else optimizer
        self._params = None
        self._states = None
        self._step_count = 0
        self._graphs = {}       # signature -> _Graph, or None once warmed
        self._pool = None       # the graphs' shared memory pool
        self._fingerprint = None
        self._group_of = self._leaders = None   # rate group of each param
        self._scalars = None    # device f64: rate per group, t, rescale
        self._host = None       # its pinned host twin, and the copy's event
        self._copied = None

    # -- parameters and state -------------------------------------------------
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
        self._collect()

    def _collect(self):
        """(Re)read the trainable tensors; keep each optimizer state that
        still fits its weight, make the others anew."""
        old = self._states
        self._params = self._trainable()
        self._states = []
        for i, p in enumerate(self._params):
            st = old[i] if old is not None and i < len(old) else None
            if st is None or not self._fits(st, p):
                st = self.optimizer.create_state_multi_precision(i, p)
            self._states.append(st)

    def _group(self, mults):
        """One device rate per distinct lr multiplier (each parameter's
        rate is the schedule's times its multiplier, so those sharing one
        share the rate, and the update scales them in one call), then t
        and rescale_grad: the scalars' device buffer and its pinned host
        twin."""
        distinct = list(dict.fromkeys(mults))
        self._group_of = [distinct.index(m) for m in mults]
        self._leaders = [self._group_of.index(g) for g in range(len(distinct))]
        n = len(distinct) + 2
        self._scalars = torch.zeros(n, dtype=torch.float64,
                                    device=self.device)
        self._host = torch.zeros(n, dtype=torch.float64,
                                 pin_memory=self.device.type == "cuda")
        self._copied = None

    def _fits(self, state, weight):
        """Whether ``state`` belongs to ``weight`` as it is now: a master
        copy where the multi-precision rule wants one, every tensor of the
        weight's shape and device and, without a master, its dtype."""
        master = self.optimizer._uses_master(weight)
        if master != (isinstance(state, tuple) and len(state) == 2
                      and isinstance(state[0], torch.Tensor)
                      and state[0].dtype == torch.float32
                      and weight.dtype != torch.float32):
            return False
        return all(t.shape == weight.shape and t.device == weight.device
                   and (master or t.dtype == weight.dtype)
                   for t in _flat(state, []))

    def _evict_stale(self):
        """Drop the graphs when they would read stale memory, casts or
        rates: amp toggled, a tensor of the net or of the optimizer state
        replaced (then re-read the parameters), the generator replaced, an
        lr multiplier changed (the rates' grouping)."""
        tensors = tuple((id(t), t.data_ptr(), t.dtype)
                        for t in _block_tensors(self.net))
        if self._fingerprint is not None and tensors != self._fingerprint[2]:
            self._collect()
        o = self.optimizer
        mults = tuple(o._mult(i, o.lr_mult, "lr_mult")
                      for i in range(len(self._params)))
        key = (registry.dispatch_epoch(), id(random.generator(self.device)),
               tensors, tuple(t.data_ptr() for s in self._states
                              for t in _flat(s, [])), mults)
        if key != self._fingerprint:
            self._graphs.clear()
            self._group(mults)
            self._fingerprint = key

    # -- the per-step scalars -------------------------------------------------
    def _advance(self):
        """The host's bookkeeping of one step (update counts, schedule,
        multipliers), written into the device scalars the update reads."""
        o, g = self.optimizer, len(self._leaders)
        self._step_count += 1
        for i in range(len(self._params)):
            o._update_count(i)
        if self._copied is not None:
            self._copied.synchronize()      # the last copy left the buffer
        self._host[:g] = torch.tensor([o._get_lr(i) for i in self._leaders],
                                      dtype=torch.float64)
        self._host[g] = float(o._index_update_count.get(0, self._step_count))
        self._host[g + 1] = float(o.rescale_grad)
        if self.device.type == "cuda":
            self._scalars.copy_(self._host, non_blocking=True)
            self._copied = torch.cuda.Event()
            self._copied.record()
        else:
            self._scalars.copy_(self._host)

    def _update(self, grads):
        """The optimizer's update with the device scalars swapped in for
        the host's, as the reference swaps traced values in."""
        o, g = self.optimizer, len(self._leaders)
        rates = self._scalars[:g].unbind()
        lrs = [rates[k] for k in self._group_of]
        saved = (o._update_count, o._index_update_count, o._get_lr,
                 o.rescale_grad)
        try:
            o._update_count = lambda index: None
            o._index_update_count = _StepCount(self._scalars[g])
            o._get_lr = lambda index: lrs[index]
            o.rescale_grad = self._scalars[g + 1]
            o.update_multi(list(range(len(self._params))), self._params,
                           grads, self._states)
        finally:
            (o._update_count, o._index_update_count, o._get_lr,
             o.rescale_grad) = saved

    # -- the step -------------------------------------------------------------
    def _loss(self, data, label):
        with autograd.train_mode():
            out = remat_call(self.net, data) if self._remat \
                else self.net(data)
            loss = self.loss_fn(out, label)
        return loss.mean() if loss.dim() else loss

    def _body(self, data, label):
        """Forward, backward and update of one step; returns the loss."""
        if self._n_micro == 1:
            for p in self._params:
                p.grad = None
            loss = self._loss(data, label)
            loss.backward()
            self._update([p.grad for p in self._params])
            return loss.detach()
        acc, losses = None, []
        for d, l in zip(data.chunk(self._n_micro), label.chunk(self._n_micro)):
            loss = self._loss(d, l)
            grads = torch.autograd.grad(loss, self._params,
                                        allow_unused=True)
            grads = [torch.zeros_like(p) if g is None else g
                     for p, g in zip(self._params, grads)]
            if acc is None:
                acc = grads
            else:
                torch._foreach_add_(acc, grads)
            losses.append(loss.detach())
        for dt in {g.dtype for g in acc}:
            # 1/n_micro rounded to the gradient's dtype, as the reference
            # multiplies by jnp.asarray(1 / n_micro, dtype)
            torch._foreach_mul_([g for g in acc if g.dtype == dt], float(
                torch.tensor(1.0 / self._n_micro, dtype=dt)))
        self._update(acc)
        losses = torch.stack(losses)
        return losses.sum() * float(torch.tensor(1.0 / self._n_micro,
                                                 dtype=losses.dtype))

    def _capture(self, data, label):
        """Capture the step for this signature and return it (not run)."""
        graph = torch.cuda.CUDAGraph()
        random.register_with_graph(graph, self.device)
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        static_d, static_l = data.clone(), label.clone()
        before = _launch_counts()
        stream = torch.cuda.current_stream(self.device)
        try:
            with torch.cuda.graph(graph, pool=self._pool,
                                  stream=torch.cuda.Stream(self.device)):
                loss = self._body(static_d, static_l)
        except RuntimeError as e:
            self._abandon_capture(stream)
            cause = e.__context__
            raise MXNetError(
                f"TrainStep: the step cannot be captured as one CUDA graph "
                f"({type(e).__name__}: {e}"
                + (f"; first {type(cause).__name__}: {cause}" if cause
                   else "") + "); a forward that reads a device value back "
                "to the host (.item(), nonzero, NMS) cannot run in a "
                "captured step, nor one whose parameters an eager graph "
                "still references") from e
        finally:
            counts = [a - b for a, b in zip(_launch_counts(), before)]
            _set_launch_counts(before)
        return _Graph(graph, static_d, static_l, loss, counts)

    def _abandon_capture(self, stream):
        """After a failed capture: work goes back to ``stream`` (torch
        leaves the capture stream current when ending the capture raises)
        and the allocator stops routing that stream's allocations into the
        graphs' pool (the step ending the capture would have done it); the
        pool is not shared again."""
        torch.cuda.set_stream(stream)
        index = self.device.index if self.device.index is not None \
            else torch.cuda.current_device()
        try:
            torch._C._cuda_endAllocateToPool(index, self._pool)
        except RuntimeError:
            pass                # torch had ended it before failing
        self._pool = None

    def __call__(self, data, label):
        """Run one step; returns the scalar loss (a tensor on the device,
        not synchronised)."""
        data, label = self._as_tensor(data), self._as_tensor(label)
        if data.shape[0] % self._n_micro:
            raise MXNetError(f"batch {data.shape[0]} is not divisible by "
                             f"n_micro={self._n_micro}")
        if self._params is None:
            self._resolve(data)
        self._evict_stale()
        self._advance()
        if self.device.type != "cuda":
            return self._body(data, label)
        sig = ((tuple(data.shape), data.dtype),
               (tuple(label.shape), label.dtype))
        if sig not in self._graphs:
            # warm-up: eager, on a side stream (torch's capture recipe)
            side = torch.cuda.Stream(self.device)
            side.wait_stream(torch.cuda.current_stream(self.device))
            with torch.cuda.stream(side):
                loss = self._body(data, label)
            torch.cuda.current_stream(self.device).wait_stream(side)
            self._graphs[sig] = None
            return loss
        entry = self._graphs[sig]
        if entry is None:
            entry = self._graphs[sig] = self._capture(data, label)
        else:
            entry.data.copy_(data)
            entry.label.copy_(label)
        entry.graph.replay()
        _set_launch_counts([a + b for a, b in zip(_launch_counts(),
                                                  entry.counts)])
        return entry.loss.clone()

    def run(self, data, label, steps=None):
        """Run one step per entry of the leading axis of ``data``/``label``,
        or ``steps`` steps on the one batch ``data``/``label``; return the
        (steps,) losses."""
        data, label = self._as_tensor(data), self._as_tensor(label)
        if steps is not None:
            return torch.stack([self(data, label) for _ in range(steps)])
        return torch.stack([self(d, l) for d, l in zip(data, label)])
