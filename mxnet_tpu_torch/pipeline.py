"""Pipeline parallelism (GPipe) over a mesh axis — the port of
``mxnet_tpu/pipeline.py``.

The model's homogeneous trunk (e.g. its decoder blocks) is split into
``n_stages`` stages whose parameters are stacked along a leading stage
dimension, stage s's slice on the shard s of a ``'pp'`` mesh axis, and
microbatches flow through the stages on the reference's schedule: with S
stages and M microbatches, tick t ∈ [0, S+M-1) runs stage s on
microbatch t-s where 0 <= t-s < M.  The reference computes every stage at
every tick (stage calls on zeros in the bubble, on one SPMD program); the
port runs only the S x M valid (stage, microbatch) calls, in tick order
and stage order within a tick, one process over the mesh's shards.  An
activation moves from stage s-1 to stage s with ``.to(device)`` (no copy
where the shards share a card); the output is concatenated on the
caller's device.  Autograd runs the backward through the same calls, so
the gradients of the stacked parameters and of the input are the
sequential trunk's.  A ``data_axis`` splits the batch over that axis's
shards, each of which runs its own pipeline over its stages.

Embedding/head layers (whose activation shapes differ from the trunk's)
stay outside the pipelined region, as in the reference.
"""

from __future__ import annotations

import torch

from .analysis import runtime as _art
from .base import MXNetError
from .gluon.parameter import _entered
from .ndarray.ndarray import NDArray
from .parallel import _grid

__all__ = ["gpipe", "pipeline_apply", "stack_blocks", "PipelinedBlock"]


def _stage_value(value, s, device):
    """Stage ``s``'s slice of a stacked parameter (a tensor with a
    leading stage dimension, or a sequence of per-stage tensors) on
    ``device``."""
    v = value[s]
    return v if v.device == device else v.to(device)


def _n_stages(stacked):
    value = next(iter(stacked.values()))
    return len(value) if isinstance(value, (list, tuple)) \
        else value.shape[0]


def gpipe(stage_fn, n_stages, n_microbatches, mesh, axis="pp",
          data_axis=None):
    """The GPipe schedule of a homogeneous stage function.

    ``stage_fn(stage_params, activation) -> activation`` runs one stage
    (it must keep the activation's shape); ``n_stages`` must equal the
    mesh's ``axis`` size; the batch (per data shard) must divide by
    ``n_microbatches``.  Returns ``fn(stacked_params, x) -> y`` where
    ``stacked_params`` maps names to tensors with a leading dimension of
    ``n_stages`` (or to sequences of ``n_stages`` tensors, stage s's on
    the pp shard s) and ``x`` is the trunk input ``(batch, ...)``;
    differentiable."""
    if mesh.axis_size(axis) != n_stages:
        raise MXNetError(
            f"gpipe: mesh axis {axis!r} has size {mesh.axis_size(axis)}, "
            f"need n_stages={n_stages}")
    S, M = int(n_stages), int(n_microbatches)
    dp = mesh.axis_size(data_axis) if data_axis else 1
    grid = _stage_devices(mesh, axis, data_axis)

    def fn(stacked_params, x):
        bglobal = x.shape[0]
        if bglobal % dp != 0 or (bglobal // dp) % M != 0:
            raise MXNetError(
                f"gpipe: batch {bglobal} (/{dp} data-parallel shards -> "
                f"{bglobal // dp if bglobal % dp == 0 else bglobal}/shard) "
                f"must be divisible by n_microbatches={M}")
        outs = []
        for j, xj in enumerate(x.chunk(dp) if dp > 1 else [x]):
            devs = grid[j]
            params = [{k: _stage_value(v, s, devs[s])
                       for k, v in stacked_params.items()}
                      for s in range(S)]
            micro = list(xj.chunk(M))
            acts = [[None] * M for _ in range(S)]
            for t in range(S + M - 1):
                for s in range(S):
                    m = t - s
                    if not 0 <= m < M:
                        continue        # the bubble: nothing to run
                    inp = micro[m] if s == 0 else acts[s - 1][m]
                    acts[s][m] = stage_fn(params[s], inp.to(devs[s]))
            outs += [a.to(x.device) for a in acts[S - 1]]
        return torch.cat(outs)

    return fn


def _stage_devices(mesh, axis, data_axis):
    """devices[j][s]: the device of data shard j's stage s (the other
    axes at index 0)."""
    grid = _grid(mesh)

    def at(**coords):
        return grid[tuple(coords.get(a, 0) for a in mesh.axis_names)]
    return [[at(**{axis: s, **({data_axis: j} if data_axis else {})})
             for s in range(mesh.axis_size(axis))]
            for j in range(mesh.axis_size(data_axis) if data_axis else 1)]


def pipeline_apply(stage_fn, stacked_params, x, mesh, n_microbatches=None,
                   axis="pp", data_axis=None):
    """One-shot convenience wrapper over :func:`gpipe` (builds + calls)."""
    n_stages = _n_stages(stacked_params)
    if n_microbatches is None:
        n_microbatches = max(2 * n_stages, 1)
    fn = gpipe(stage_fn, n_stages, n_microbatches, mesh, axis=axis,
               data_axis=data_axis)
    return fn(stacked_params, x)


# -- Gluon bridge: stack identically-structured blocks -----------------------

class _StageView:
    """A pipeline stage's view: the template block's parameters read the
    stage's tensors."""

    def __init__(self, values):
        self._values = values

    def lookup(self, param):
        return self._values.get(id(param))

    def model_axes(self, param, dim):  # noqa: ARG002
        return ()


def stack_blocks(blocks, probe):
    """Stack N identically-structured Gluon blocks into (stage_fn, params).

    ``blocks`` — HybridBlocks with identical parameter structure (e.g. N
    decoder blocks).  ``probe`` — an example activation (NDArray or
    tensor) that finishes deferred shape inference (a block without
    deferred parameters does not run it).

    Returns ``(stage_fn, stacked)``: ``stacked`` maps the first block's
    parameter names to tensors with leading dim N (copies);
    ``stage_fn(params, x)`` runs ONE stage on the tensor ``x`` with the
    first block, its parameters reading ``params``' tensors."""
    from . import autograd
    template = blocks[0]
    with autograd.pause(), torch.no_grad():
        for blk in blocks:
            if any(p._data is None for p in blk.collect_params().values()):
                blk(probe)      # deferred init
    names = list(template.collect_params().keys())
    per_block = []
    for blk in blocks:
        ps = blk.collect_params()
        if len(ps) != len(names):
            raise MXNetError("stack_blocks: blocks differ in structure")
        per_block.append([p.data()._data.detach() for p in ps.values()])
    stacked = {name: torch.stack([vals[i] for vals in per_block])
               for i, name in enumerate(names)}
    t_params = [template.collect_params()[k] for k in names]

    def stage_fn(params, x):
        view = _StageView({id(p): params[name]
                           for p, name in zip(t_params, names)})
        with _entered(view):
            return template(x)

    return stage_fn, stacked


class PipelinedBlock:
    """Pipeline-parallel wrapper for a homogeneous stack of Gluon blocks.

    ``PipelinedBlock(blocks, mesh, n_microbatches)`` stacks the blocks'
    parameters, stage s's slice on the pp shard s (``stacked[name]`` is
    the list of the ``n_stages`` slices, leaves that require grad), and
    is a callable ``(x) -> y`` running the GPipe schedule (an NDArray;
    its tensor carries the autograd graph to the slices and to ``x``).
    Used for the trunk of a deep model; compose embedding/head around
    it."""

    def __init__(self, blocks, mesh, n_microbatches=None, axis="pp",
                 data_axis=None):
        self.blocks = list(blocks)
        self.mesh = mesh
        self.axis = axis
        self.data_axis = data_axis
        self.n_stages = len(self.blocks)
        self.n_microbatches = n_microbatches or 2 * self.n_stages
        self._fn = None
        self._stage_fn = None
        self.stacked = None

    def _build(self, probe):
        self._stage_fn, stacked = stack_blocks(self.blocks, probe)
        devs = _stage_devices(self.mesh, self.axis, None)[0]
        self.stacked = {k: [torch.nn.Parameter(v[s].to(devs[s], copy=True))
                            for s in range(self.n_stages)]
                        for k, v in stacked.items()}
        self._fn = gpipe(self._stage_fn, self.n_stages, self.n_microbatches,
                         self.mesh, axis=self.axis, data_axis=self.data_axis)
        _art.note_build("pipeline.PipelinedBlock")

    def __call__(self, x):
        if isinstance(x, NDArray):
            ctx, x = x.ctx, x._data
        else:
            ctx = None
        if self._fn is None:
            self._build(x[:max(1, x.shape[0] // self.n_microbatches)])
        return NDArray(self._fn(self.stacked, x), ctx)
