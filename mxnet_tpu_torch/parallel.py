"""Device meshes, eager collectives and the training step — the port of
``mxnet_tpu/parallel.py``.

A :class:`DeviceMesh` is a named-axis grid of shards in one process, each
shard a Context (``DeviceMesh((2, 4), ("dp", "sp"), devices=[gpu(0)] *
8)``): the reference's mesh is single-controller too (one process over
``jax.devices()``), and so is MXNet's own multi-GPU (``ctx=[gpu(0),
gpu(1)]``).  Shards may name the same card.  ``spec``/``sharded``/
``replicated`` return a :class:`Placement` (the mesh and one axis entry a
dimension), the port's record of the reference's ``NamedSharding``.
:func:`allreduce` and :func:`allgather` reduce or concatenate a value per
shard in one process: the sum runs on the first value's device in its
dtype, and each shard gets the result on its own device (a copy between
distinct cards; the same tensor where shards share one).  ``attention``,
``ring_attention`` and ``ulysses_attention`` resolve lazily to the
sequence-parallel kernels (``kernels/ring_attention.py``,
``kernels/ulysses.py``).

``TrainStep`` is one training step over one device's shards.

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
reference scans the steps in one program).

``mesh`` (default: the current mesh) may hold several shards that all lie
on the net's card; the step then realises the reference's placements
itself, in one autograd graph (one CUDA graph on the card) whose
collectives are differentiable torch ops (``cat``, sums, ``.to``):

- each parameter's placement is resolved on the mesh
  (``sharding.resolve_spec``): from ``partition_rules`` (authoritative:
  unmatched parameters replicate) or, without rules, from the
  parameter's own ``sharding`` hint.  A parameter it splits is stored as
  one tensor per distinct slice on its shard's device (``_Sliced``),
  and its optimizer state is made per slice, so it is split alike;
- the batch splits over the axes of ``data_spec``'s first entry
  (default: the mesh's first axis; ``()`` keeps it whole), each data
  shard runs the forward on its rows, and the loss is the shards' mean
  weighted by their rows; ``n_micro`` and ``remat`` apply per shard.  An
  axis named for a later dimension (``("dp", "sp")``) splits nothing
  here: it must be an axis the net's attention runs over (the llama's
  ``attn_impl="ring"|"ulysses"``), else the call raises;
- a data shard's forward reads a split parameter gathered on its device
  (ZeRO-3's gather at use: autograd sums the gradient back into each
  slice), except where a block computes per tensor-parallel shard (the
  zoo llama under ``sharding.llama_rules``: ``_ShardView.tp_part``).

``plan`` (an ``autoshard.Plan``) supplies the mesh (over the net's card
repeated), the rules, ``data_spec``, ``n_micro`` and ``remat``; the
arguments given win.  A mesh over distinct devices raises
``MXNetError``: one CUDA graph cannot span cards (ROADMAP A.9).

Telemetry, as the reference's: with telemetry on, each call is one step
of the step clock (``telemetry.STEP_CLOCK``), whose ``h2d`` phase is the
copy of data and label into the graph's static inputs and whose
``compute`` is the rest (the replay's launch; the clock reads the host's
clock and adds no synchronisation), and ``mxnet_sharding_step_dispatches
_total`` (and ``mxnet_trainstep_microbatches_total`` with ``n_micro`` > 1)
count the calls; each new signature adds one to
``mxnet_sharding_retraces_total``.  While the cost ledger is armed
(``telemetry.costmodel``), the warm-up call of each signature is analysed
into a ``parallel.TrainStep`` entry (FLOPs, bytes, peak bytes) whose
``compile_s`` is the seconds of the capture that follows it; every armed
call counts in ``calls``.  A signature first seen while the ledger was
disarmed is analysed at its first armed call, which then runs eagerly in
place of a replay.
"""

from __future__ import annotations

import functools
import itertools
import time as _time
from typing import NamedTuple

import numpy as np
import torch

from . import autograd, config, optimizer as opt, random
from . import telemetry as _tel
from .base import MXNetError
from .telemetry import costmodel as _costmodel
from .telemetry import stepclock as _sclock
from .telemetry import tracer as _ttrace
from .context import Context, context_of, cpu, gpu, resolve_device
from .gluon.block import Block
from .gluon.parameter import _entered
from .gluon.utils import _block_tensors, remat_call
from .kernels import flash_attention as _fa
from .ndarray.ndarray import NDArray
from .ops import registry

__all__ = ["DeviceMesh", "Placement", "make_mesh", "data_parallel_ctxs",
           "TrainStep", "allreduce", "allgather", "current_mesh",
           "set_mesh", "attention", "ring_attention", "ulysses_attention"]


def __getattr__(name):
    # the sequence-parallel entry points, resolved at first use as the
    # reference resolves them
    if name in ("attention", "ring_attention"):
        from .kernels.ring_attention import (ring_attention,
                                             sequence_parallel_attention)
        val = sequence_parallel_attention if name == "attention" \
            else ring_attention
    elif name == "ulysses_attention":
        from .kernels.ulysses import ulysses_attention as val
    else:
        raise AttributeError(
            f"module 'mxnet_tpu_torch.parallel' has no attribute {name!r}")
    globals()[name] = val
    return val

_M_STEP_DISPATCHES = _tel.counter(
    "mxnet_sharding_step_dispatches_total",
    "Sharded TrainStep dispatches (one per __call__/run invocation).")
_M_RETRACES = _tel.counter(
    "mxnet_sharding_retraces_total",
    "TrainStep executable builds (trace+compile); growth at steady state "
    "is a retrace bug — see graftcheck GC02.")
_M_MICROBATCHES = _tel.counter(
    "mxnet_trainstep_microbatches_total",
    "Microbatches executed by gradient-accumulation TrainSteps "
    "(n_micro per dispatch; n_micro=1 steps do not count).")


# -- the mesh ----------------------------------------------------------------

_current_mesh = None


def current_mesh():
    """The mesh :func:`set_mesh` or :func:`make_mesh` made current, or
    None."""
    return _current_mesh


def set_mesh(mesh):
    """Make ``mesh`` (a :class:`DeviceMesh` or None) current; returns
    it."""
    global _current_mesh
    _current_mesh = mesh
    return mesh


def _as_ctx(device):
    """A Context for a Context, ``torch.device`` or device string."""
    if isinstance(device, Context):
        return device
    if isinstance(device, (torch.device, str)):
        return context_of(torch.device(device))
    raise MXNetError(f"a mesh shard is a Context or a torch.device, got "
                     f"{device!r}")


def _visible_ctxs():
    """Every CUDA card this process sees, one Context each; the host
    where there is none."""
    return [gpu(i) for i in range(torch.cuda.device_count())] or [cpu(0)]


class Placement(NamedTuple):
    """Where an array lies on ``mesh``: ``spec[d]`` is the mesh axis (or
    tuple of axes) that dimension ``d`` is split over, None or absent for
    a whole dimension; an empty ``spec`` is replication."""
    mesh: "DeviceMesh"
    spec: tuple


class DeviceMesh:
    """A named-axis grid of shards in one process (axes e.g. ``('dp',)``,
    ``('dp', 'sp')``), outermost axis first.  ``devices`` (default: every
    visible card, one shard each) are Contexts or ``torch.device``s, laid
    out row-major over ``shape``; several may name the same card."""

    def __init__(self, shape=None, axis_names=("dp",), devices=None):
        ctxs = [_as_ctx(d) for d in (_visible_ctxs() if devices is None
                                     else devices)]
        if shape is None:
            shape = (len(ctxs),)
        total = 1
        for n in shape:
            total *= n
        if total != len(ctxs):
            raise MXNetError(
                f"mesh shape {tuple(shape)} needs {total} devices, got "
                f"{len(ctxs)}")
        if len(shape) != len(axis_names):
            raise MXNetError("mesh shape and axis_names rank mismatch")
        self.axis_names = tuple(axis_names)
        self.shape = tuple(int(n) for n in shape)
        self._ctxs = ctxs
        self.devices = [c.torch_device() for c in ctxs]

    # -- placements ------------------------------------------------------------
    def replicated(self):
        return Placement(self, ())

    def sharded(self, *spec):
        """The placement splitting dimension d over ``spec[d]``: an axis
        name, a tuple of axis names, or None."""
        return self.spec(*spec)

    def spec(self, *spec):
        """:meth:`sharded`; an entry naming an axis this mesh lacks
        raises."""
        for entry in spec:
            for a in entry if isinstance(entry, (tuple, list)) else (entry,):
                if a is not None and a not in self.axis_names:
                    raise MXNetError(
                        f"mesh {self!r} has no axis {a!r}; axes are "
                        f"{self.axis_names}")
        return Placement(self, tuple(spec))

    @property
    def size(self):
        return len(self._ctxs)

    def axis_size(self, name):
        return self.shape[self.axis_names.index(name)]

    def ctxs(self):
        """One Context per shard, row-major."""
        return list(self._ctxs)

    def axis_devices(self, name):
        """The devices of the shards along axis ``name`` at index 0 of
        every other axis, in axis order."""
        if name not in self.axis_names:
            raise MXNetError(f"mesh {self!r} has no axis {name!r}; axes are "
                             f"{self.axis_names}")
        grid = np.empty(len(self.devices), dtype=object)
        grid[:] = self.devices
        grid = grid.reshape(self.shape)
        k = self.axis_names.index(name)
        index = tuple(slice(None) if i == k else 0
                      for i in range(len(self.shape)))
        return list(grid[index])

    def __repr__(self):
        dims = ", ".join(f"{n}={s}" for n, s in zip(self.axis_names,
                                                    self.shape))
        return f"DeviceMesh({dims})"


def make_mesh(shape=None, axis_names=("dp",), devices=None):
    """A new :class:`DeviceMesh`, made current."""
    return set_mesh(DeviceMesh(shape=shape, axis_names=axis_names,
                               devices=devices))


def data_parallel_ctxs(n=None):
    """The Context list of MXNet's multi-device loop (``[mx.gpu(i) for i
    in range(n)]``): the visible cards, the first ``n`` of them."""
    ctxs = _visible_ctxs()
    return ctxs if n is None else ctxs[:n]


# -- eager collectives -------------------------------------------------------

def _values(values):
    """(tensors, Contexts) of a list of NDArrays or tensors."""
    tensors = [v._data if isinstance(v, NDArray) else v for v in values]
    ctxs = [v._ctx if isinstance(v, NDArray) else context_of(t.device)
            for v, t in zip(values, tensors)]
    return tensors, ctxs


def _spread(total, tensors, ctxs):
    """``total`` on each value's device, as NDArrays of the values'
    Contexts: a copy between distinct cards, the same tensor on one."""
    return [NDArray(total.to(t.device, non_blocking=True), c)
            for t, c in zip(tensors, ctxs)]


def allreduce(values, mesh=None, op="sum"):  # noqa: ARG001
    """The sum (``op="sum"``) or mean (``"mean"``) of one value per shard,
    given back on each value's device: MXNet's CommDevice reduction, the
    reference's psum.  Exactly the values given are reduced, whatever the
    mesh's size."""
    if op not in ("sum", "mean"):
        raise MXNetError(f"allreduce op must be 'sum' or 'mean', got {op!r}")
    if len(values) == 1:
        return list(values)
    tensors, ctxs = _values(values)
    dev = tensors[0].device
    total = tensors[0].clone()
    for t in tensors[1:]:
        total += t.to(dev, non_blocking=True)
    if op == "mean":
        total /= len(tensors)
    return _spread(total, tensors, ctxs)


def allgather(values, mesh=None):  # noqa: ARG001
    """The values concatenated along axis 0, given back on each value's
    device (the reference's all_gather over the mesh axis)."""
    if len(values) == 1:
        return list(values)
    tensors, ctxs = _values(values)
    dev = tensors[0].device
    total = torch.cat([t.to(dev, non_blocking=True).reshape(
        (-1,) + tuple(t.shape[1:])) for t in tensors])
    return _spread(total, tensors, ctxs)


# -- placements realised: sliced storage and the data shards' view ----------

def _entry_axes(entry):
    """The mesh axes of one placement entry (an axis, a tuple, None)."""
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, (tuple, list)) else (entry,)


def _grid(mesh):
    """The mesh's devices as an object array of its shape."""
    grid = np.empty(len(mesh.devices), dtype=object)
    grid[:] = mesh.devices
    return grid.reshape(mesh.shape)


def _row_major(coords, sizes):
    index = 0
    for c, n in zip(coords, sizes):
        index = index * n + c
    return index


class _Sliced:
    """A parameter's value under a splitting Placement: one tensor per
    distinct slice, each on the device of the first shard (row-major)
    that holds it.  ``split`` lists (dimension, axes, number of chunks)
    of the split dimensions; a slice's key is its chunk index along each
    of them, a chunk's position along a dimension the row-major index of
    the shard's coordinates on that dimension's axes."""

    def __init__(self, placement, value, requires_grad):
        mesh, spec = placement
        self.placement = placement
        self.shape = tuple(value.shape)
        self.split = []
        for d, entry in enumerate(spec):
            axes = _entry_axes(entry)
            if axes:
                n = 1
                for a in axes:
                    n *= mesh.axis_size(a)
                self.split.append((d, axes, n))
        grid, homes = _grid(mesh), {}
        for coords in itertools.product(*(range(n) for n in mesh.shape)):
            homes.setdefault(self.key_of(mesh, coords), grid[coords])
        self._tensors = {}
        with torch.no_grad():
            for key, dev in homes.items():
                self._tensors[key] = torch.nn.Parameter(
                    value[self._index(key)].to(dev, copy=True),
                    requires_grad=requires_grad)

    def key_of(self, mesh, coords):
        """The key of the slice the shard at grid ``coords`` holds."""
        where = dict(zip(mesh.axis_names, coords))
        return tuple(_row_major([where[a] for a in axes],
                                [mesh.axis_size(a) for a in axes])
                     for _, axes, _ in self.split)

    def _index(self, key):
        index = [slice(None)] * len(self.shape)
        for (d, _, n), i in zip(self.split, key):
            size = self.shape[d] // n
            index[d] = slice(i * size, (i + 1) * size)
        return tuple(index)

    @property
    def device(self):
        return next(iter(self._tensors.values())).device

    def tensors(self):
        """The slices, in key order."""
        return [self._tensors[k] for k in sorted(self._tensors)]

    def _assemble(self, device, ranges):
        """The slices whose chunk index along each split dimension lies
        in ``ranges`` (one range a split dimension), concatenated on
        ``device`` (a differentiable gather)."""
        def level(i, prefix):
            if i == len(self.split):
                t = self._tensors[prefix]
                return t if t.device == device else t.to(device)
            parts = [level(i + 1, prefix + (c,)) for c in ranges[i]]
            return parts[0] if len(parts) == 1 else \
                torch.cat(parts, dim=self.split[i][0])
        return level(0, ())

    def gather(self, device=None):
        """The whole value on ``device`` (default: the first slice's)."""
        return self._assemble(device or self.device,
                              [range(n) for _, _, n in self.split])

    def part(self, dim, k, ways, device):
        """Chunk ``k`` of ``ways`` equal chunks along ``dim`` (whole along
        the other dimensions) on ``device``: the slices that make it up
        where the split along ``dim`` nests in ``ways``, else a narrow of
        the whole value."""
        ranges = [range(n) for _, _, n in self.split]
        for i, (d, _, n) in enumerate(self.split):
            if d == dim and n % ways == 0:
                m = n // ways
                ranges[i] = range(k * m, (k + 1) * m)
                return self._assemble(device, ranges)
        size = self.shape[dim] // ways
        return self.gather(device).narrow(dim, k * size, size)

    def scatter(self, src):
        """Write the whole value ``src`` into the slices."""
        with torch.no_grad():
            for key, t in self._tensors.items():
                t.copy_(src[self._index(key)])

    def requires_grad_(self, flag):
        for t in self._tensors.values():
            t.requires_grad_(flag)

    def cast(self, dtype):
        for t in self._tensors.values():
            t.data = t.data.to(dtype)

    def held_by(self, coords):
        """The slice the shard at grid ``coords`` holds."""
        return self._tensors[self.key_of(self.placement.mesh, coords)]


class _Layout:
    """How a sharded step runs on its mesh: the data axes the batch
    splits over (row-major, ``n_data`` shards) and the placement of each
    parameter."""

    def __init__(self, mesh, data_axes, placements):
        self.mesh = mesh
        self.data_axes = tuple(data_axes)
        self.placements = placements        # id(Parameter) -> Placement
        self.n_data = 1
        for a in self.data_axes:
            self.n_data *= mesh.axis_size(a)
        self._grid = _grid(mesh)

    def device(self, j, k=0, axis=None):
        """The device of data shard ``j``'s shard ``k`` along the model
        axis ``axis`` (the other axes at index 0)."""
        names = self.mesh.axis_names
        coords = [0] * len(names)
        sizes = [self.mesh.axis_size(a) for a in self.data_axes]
        for a, c in zip(self.data_axes, np.unravel_index(j, sizes)):
            coords[names.index(a)] = c
        if axis is not None:
            coords[names.index(axis)] = k
        return self._grid[tuple(coords)]


class _ShardView:
    """What the forward of data shard ``j`` reads: each split parameter
    gathered on the shard's device once (ZeRO-3's gather at use; autograd
    sums the gradient back into every slice), or, where a block computes
    per shard of a model axis (the zoo llama's tensor parallelism), the
    chunks of each shard."""

    def __init__(self, layout, j):
        self.layout = layout
        self.j = j
        self._cache = {}

    @property
    def device(self):
        return self.layout.device(self.j)

    def size(self, axis):
        return self.layout.mesh.axis_size(axis)

    def tp_device(self, k, axis):
        return self.layout.device(self.j, k, axis)

    def lookup(self, param):
        """A split parameter gathered on the shard's device (once a
        view); None for a whole one (its own tensor)."""
        if param._slices is None:
            return None
        v = self._cache.get(id(param))
        if v is None:
            v = self._cache[id(param)] = param._slices.gather(self.device)
        return v

    def model_axes(self, param, dim):
        """The model axes (not data axes, more than one shard) that
        split dimension ``dim`` of ``param``: a tuple, empty for none."""
        pl = self.layout.placements.get(id(param))
        if pl is None or dim >= len(pl.spec):
            return ()
        return tuple(a for a in _entry_axes(pl.spec[dim])
                     if a not in self.layout.data_axes and self.size(a) > 1)

    def tp_part(self, param, dim, k, axis):
        """Chunk ``k`` of the ways of ``axis`` along ``dim`` of ``param``
        on that shard's device."""
        dev, ways = self.tp_device(k, axis), self.size(axis)
        if param._slices is not None:
            return param._slices.part(dim, k, ways, dev)
        whole = param._tensor(None)
        size = whole.shape[dim] // ways
        return whole.narrow(dim, k * size, size).to(dev)


def _sp_axes(net):
    """The mesh axes the net's attention runs over (blocks built with
    ``attn_impl="ring"`` or ``"ulysses"``: the zoo llama)."""
    if not isinstance(net, Block):
        return set()
    out, todo = set(), [net]
    while todo:
        b = todo.pop()
        if getattr(b, "_attn_impl", "fused") in ("ring", "ulysses"):
            out.add(getattr(b, "_sp_axis", "sp"))
        todo.extend(b._children.values())
    return out


# -- the training step --------------------------------------------------------

def _mesh_devices(mesh):
    """The devices of ``mesh``: a DeviceMesh, a Context or device, or a
    (nested) sequence of them."""
    if isinstance(mesh, DeviceMesh):
        return mesh.devices
    if isinstance(mesh, (Context, torch.device, str)):
        return [_as_ctx(mesh).torch_device()]
    return [_as_ctx(d).torch_device()
            for d in np.asarray(mesh, dtype=object).reshape(-1)]


def _net_device(net):
    """The device of ``net``'s parameters: where the first one with a value
    lies (``net.to()`` moves them), else the context a deferred one was
    initialized on."""
    if not isinstance(net, Block):
        return next(net.parameters()).device
    params = list(net.collect_params().values())
    for p in params:
        if p._data is not None:
            return p._device()
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
        if plan is not None:
            from .autoshard import Plan
            if not isinstance(plan, Plan):
                raise MXNetError(f"TrainStep: plan must be an autoshard.Plan, "
                                 f"got {type(plan).__name__}")
            # the plan's values are defaults: arguments given win
            if mesh is None:
                n = int(np.prod(plan.mesh_sizes))
                mesh = plan.build_mesh(devices=[_net_device(net)] * n)
            if partition_rules is None:
                partition_rules = plan.rules()
            if data_spec is None:
                data_spec = plan.data_spec
            if n_micro is None:
                n_micro = plan.n_micro
            if remat is None:
                remat = plan.remat
        if partition_rules is not None and not isinstance(net, Block):
            raise MXNetError(
                "TrainStep: partition_rules match Gluon parameter names; "
                f"{type(net).__name__} is not a Gluon Block")
        if mesh is None:
            mesh = current_mesh()
        self._mesh_device = None
        if mesh is not None:
            devices = set(_mesh_devices(mesh))
            if len(devices) > 1:
                raise MXNetError(
                    f"TrainStep: a mesh over more than one device "
                    f"({sorted(map(str, devices))}): the sharding slice "
                    f"realises placements on shards that share the net's "
                    f"card; a step over distinct cards (one CUDA graph "
                    f"cannot span them) waits for ROADMAP A.9")
            self._mesh_device = devices.pop()
        self.mesh = mesh if isinstance(mesh, DeviceMesh) else None
        if data_spec is not None:
            axes_of = self.mesh.axis_names if self.mesh is not None \
                else ("dp",)
            for entry in tuple(data_spec):
                for a in entry if isinstance(entry, (tuple, list)) \
                        else (entry,):
                    if a is not None and a not in axes_of:
                        raise MXNetError(
                            f"data_spec {tuple(data_spec)} names axis {a!r} "
                            f"the mesh {self.mesh or DeviceMesh()!r} does "
                            f"not carry")
        self._rules = partition_rules
        self._data_spec = None if data_spec is None else tuple(data_spec)
        self._layout = None
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
        self._signatures = set()    # seen, for the retrace counter
        self._cost = _costmodel.Site("parallel.TrainStep")
        self._cost_entry = {}   # signature -> entry awaiting its capture

    # -- parameters and state -------------------------------------------------
    def _trainable(self):
        """The trainable tensors; the optimizer learns their Parameters
        (Gluon) or names (a torch module) by index, as the Trainer tells
        it (LARS reads the names, lr_mult/wd_mult the Parameters)."""
        if isinstance(self.net, Block):
            tensors, owners = [], []
            for p in self.net.collect_params().values():
                if p.grad_req == "null":
                    continue
                ts = p._slices.tensors() if p._slices is not None \
                    else [p.data()._data]
                tensors += ts
                owners += [p] * len(ts)
            if len(tensors) > len(set(map(id, owners))) and isinstance(
                    self.optimizer, (opt.LARS, opt.LAMB)):
                raise MXNetError(
                    f"TrainStep: {type(self.optimizer).__name__}'s update "
                    f"reads each weight's whole norm; it cannot update a "
                    f"parameter stored in slices")
            self.optimizer.param_dict = dict(enumerate(owners))
            return tensors
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
        self._layout = self._place()
        self._collect()
        home = self._mesh_device
        if home is not None and (home.type, home.index or 0) != (
                self.device.type, self.device.index or 0):
            raise MXNetError(
                f"TrainStep: the mesh's shards lie on {self._mesh_device}, "
                f"the net on {self.device}; a mesh beyond the net's card "
                f"waits for ROADMAP A.9's sharding slice")

    def _place(self):
        """Resolve each parameter's placement on the mesh and store the
        split ones in slices (the others whole); the data axes from
        ``data_spec``.  Returns the step's layout, or None where the step
        is the one-device step (no mesh, or nothing split and one data
        shard)."""
        from . import sharding
        params = list(self.net.collect_params().values()) \
            if isinstance(self.net, Block) else []
        mesh = self.mesh
        if mesh is None or mesh.size == 1:
            for p in params:
                p._unslice()
            return None
        spec = self._data_spec if self._data_spec is not None \
            else (mesh.axis_names[0],)
        sp = _sp_axes(self.net)
        for d, entry in enumerate(spec[1:], 1):
            for a in _entry_axes(entry):
                if a not in sp:
                    raise MXNetError(
                        f"TrainStep: data_spec {spec} splits dimension {d} "
                        f"over axis {a!r}, which no attention of the net "
                        f"runs over (a token split needs blocks built with "
                        f"attn_impl='ring' or 'ulysses' over {a!r})")
        specs = None if self._rules is None else \
            sharding.match_partition_rules(
                self._rules, {p.name: p for p in params})
        placements = {}
        for p in params:
            # under rules the rules decide, else the parameter's own hint
            logical = p.sharding if specs is None else specs.get(p.name, ())
            split = False
            if logical:
                pl, split = sharding.resolve_spec(logical, mesh,
                                                  shape=p.shape)
            elif specs is not None and _ttrace._ENABLED:
                sharding._M_FALLBACK.inc()
            if not split:
                p._unslice()
                continue
            placements[id(p)] = pl
            if p._slices is None or p._slices.placement != pl:
                p._unslice()
                p._store_slices(_Sliced(pl, p.data()._data,
                                        p.grad_req != "null"))
        layout = _Layout(mesh, _entry_axes(spec[0]) if spec else (),
                         placements)
        return layout if placements or layout.n_data > 1 else None

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
        """The loss of ``data``: the net's, or over a sharded layout the
        mean of the data shards' losses weighted by their rows, each
        shard's forward reading the parameters as its view gives them."""
        lay = self._layout
        if lay is None:
            return self._shard_loss(self.net, data, label)
        n = lay.n_data
        if data.shape[0] % n:
            raise MXNetError(
                f"TrainStep: a batch of {data.shape[0]} does not split over "
                f"the data axes {lay.data_axes} ({n} shards)")
        total = None
        for j, (d, l) in enumerate(zip(data.chunk(n), label.chunk(n))):
            view = _ShardView(lay, j)
            loss = self._shard_loss(functools.partial(self._forward_in, view),
                                    d.to(view.device), l.to(view.device))
            term = loss.to(data.device) * (d.shape[0] / data.shape[0])
            total = term if total is None else total + term
        return total

    def _forward_in(self, view, data):
        with _entered(view):
            return self.net(data)

    def _shard_loss(self, forward, data, label):
        with autograd.train_mode():
            out = remat_call(forward, data) if self._remat else forward(data)
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
        sig = ((tuple(data.shape), data.dtype),
               (tuple(label.shape), label.dtype))
        # one flag read a step: the step clock's step is this call
        enabled = _ttrace._ENABLED
        if enabled:
            _sclock.STEP_CLOCK.begin_step()
            _M_STEP_DISPATCHES.inc()
            if self._n_micro > 1:
                _M_MICROBATCHES.inc(self._n_micro)
            if sig not in self._signatures:
                _M_RETRACES.inc()
        self._signatures.add(sig)
        loss = self._step(data, label, sig, enabled)
        if enabled:
            _sclock.STEP_CLOCK.end_step()
        return loss

    def _eager(self, data, label, sig, analyze):
        """The step's body run eagerly, analysed into a ledger entry when
        ``analyze``."""
        if not analyze:
            return self._body(data, label)
        loss, entry = _costmodel.LEDGER.analyze(
            self._cost.site, self._body, (data, label))
        if self.device.type == "cuda" and sig not in self._graphs:
            self._cost_entry[sig] = entry   # compile_s: its capture's
        return loss

    def _step(self, data, label, sig, enabled):
        # armed, every call counts and a signature's first is analysed
        analyze = _costmodel._ARMED and self._cost.admit(sig)
        if self.device.type != "cuda":
            return self._eager(data, label, sig, analyze)
        if sig not in self._graphs or analyze:
            # warm-up (or the ledger's analysis of a signature already
            # captured while it was disarmed): eager, on a side stream
            # (torch's capture recipe)
            side = torch.cuda.Stream(self.device)
            side.wait_stream(torch.cuda.current_stream(self.device))
            with torch.cuda.stream(side):
                loss = self._eager(data, label, sig, analyze)
            torch.cuda.current_stream(self.device).wait_stream(side)
            self._graphs.setdefault(sig, None)
            return loss
        entry = self._graphs[sig]
        if entry is None:
            t0 = _time.perf_counter()
            entry = self._graphs[sig] = self._capture(data, label)
            cost = self._cost_entry.pop(sig, None)
            if cost is not None:
                _costmodel.LEDGER.set_compile_seconds(
                    cost, _time.perf_counter() - t0)
        else:
            t0 = _time.perf_counter() if enabled else 0.0
            entry.data.copy_(data)
            entry.label.copy_(label)
            if enabled:
                _sclock.STEP_CLOCK.note("h2d", _time.perf_counter() - t0)
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
