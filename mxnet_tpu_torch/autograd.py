"""Autograd: MXNet's recording scopes and backward over torch autograd.

Counterpart of ``mxnet_tpu/autograd.py`` (``record``, ``pause``,
``train_mode``, ``predict_mode``, ``is_recording``, ``is_training``,
``set_recording``, ``set_training``, ``backward``, ``grad``,
``mark_variables``, ``Function``).  The reference keeps its own tape of
vjp closures; here torch autograd is the tape:

- an op is taped only inside ``record()``: the dispatcher runs it with
  torch's grad mode on exactly then (``ops/registry.py``);
- the arrays with a gradient buffer (``attach_grad``, Gluon parameters)
  that recorded ops read are this record session's variables;
  ``backward`` differentiates the heads with respect to them and writes
  each gradient into its buffer: overwritten for ``grad_req="write"``,
  added for ``"add"`` (torch alone would always add);
- torch's errors at backward (a freed graph, an unreached variable) come
  back as ``MXNetError``;
- ``Function`` maps onto ``torch.autograd.Function``.

The training flag (``is_training``) is MXNet's, not ``nn.Module.training``:
Dropout reads it.
"""

from __future__ import annotations

import contextlib
import threading

import torch

from .base import MXNetError

__all__ = ["record", "pause", "train_mode", "predict_mode", "is_recording",
           "is_training", "set_recording", "set_training", "backward", "grad",
           "Function", "mark_variables"]

_tls = threading.local()


def _st():
    if not hasattr(_tls, "recording"):
        _tls.recording = False
        _tls.training = False
        _tls.depth = 0          # nesting depth of record() scopes
        _tls.variables = {}     # id -> NDArray read by recorded ops
    return _tls


def is_recording():
    return _st().recording


def is_training():
    return _st().training


def set_recording(flag):
    s = _st()
    prev, s.recording = s.recording, bool(flag)
    return prev


def set_training(flag):
    s = _st()
    prev, s.training = s.training, bool(flag)
    return prev


@contextlib.contextmanager
def _scope(recording=None, training=None):
    s = _st()
    prev_r, prev_t = s.recording, s.training
    session = bool(recording)
    if session:
        if s.depth == 0:        # an outermost record() starts a new tape
            s.variables = {}
        s.depth += 1
    if recording is not None:
        s.recording = recording
    if training is not None:
        s.training = training
    try:
        yield
    finally:
        s.recording, s.training = prev_r, prev_t
        if session:
            s.depth -= 1


def record(train_mode=True):
    """``with autograd.record():`` — tape ops (and train mode)."""
    return _scope(recording=True, training=train_mode)


def pause(train_mode=False):
    return _scope(recording=False, training=train_mode)


def train_mode():
    return _scope(training=True)


def predict_mode():
    return _scope(training=False)


def _note_inputs(arrays):
    """Called for the inputs of every recorded op: those with a gradient
    buffer become variables of this record session."""
    variables = _st().variables
    for a in arrays:
        if getattr(a, "_grad", None) is not None:
            variables[id(a)] = a


def _heads(heads, head_grads):
    from .ndarray.ndarray import NDArray
    if isinstance(heads, NDArray):
        heads = [heads]
    heads = list(heads)
    if head_grads is None:
        head_grads = [None] * len(heads)
    elif isinstance(head_grads, NDArray):
        head_grads = [head_grads]
    if len(head_grads) != len(heads):
        raise MXNetError("heads and head_grads length mismatch")
    return heads, list(head_grads)


def _autograd_grad(outs, seeds, inputs, retain_graph, create_graph):
    try:
        return torch.autograd.grad(outs, inputs, seeds,
                                   retain_graph=retain_graph,
                                   create_graph=create_graph,
                                   allow_unused=True)
    except RuntimeError as e:
        raise MXNetError(
            f"backward failed: {e} (a graph is freed by backward() unless "
            "retain_graph=True)") from e


def backward(heads, head_grads=None, retain_graph=False, train_mode=True,
             create_graph=False):  # noqa: ARG001 (train_mode: no re-run)
    """Differentiate ``heads`` (seeded by ``head_grads``, ones when None)
    with respect to this session's variables, into their ``.grad``."""
    heads, head_grads = _heads(heads, head_grads)
    outs, seeds = [], []
    for h, hg in zip(heads, head_grads):
        seed = torch.ones_like(h._data) if hg is None else hg._data
        if h._data.grad_fn is None:
            if h._data.requires_grad:   # backward on a variable itself
                h._accumulate_grad(seed)
            continue
        outs.append(h._data)
        seeds.append(seed)
    variables = [v for v in _st().variables.values()
                 if v._data.requires_grad]
    if not outs or not variables:
        return
    grads = _autograd_grad(outs, seeds, [v._data for v in variables],
                           retain_graph or create_graph, create_graph)
    for v, g in zip(variables, grads):
        if g is not None:
            v._accumulate_grad(g)


def grad(heads, variables, head_grads=None, retain_graph=None,
         create_graph=False, train_mode=True):  # noqa: ARG001
    """The gradients of ``heads`` with respect to ``variables``, returned
    (not written into ``.grad``).  Raises if the graph misses one."""
    from .ndarray.ndarray import NDArray
    single = isinstance(variables, NDArray)
    if single:
        variables = [variables]
    if retain_graph is None:
        retain_graph = create_graph
    heads, head_grads = _heads(heads, head_grads)
    seeds = [torch.ones_like(h._data) if hg is None else hg._data
             for h, hg in zip(heads, head_grads)]
    grads = _autograd_grad([h._data for h in heads], seeds,
                           [v._data for v in variables], retain_graph,
                           create_graph)
    if any(g is None for g in grads):
        raise MXNetError("cannot differentiate with respect to a variable "
                         "that the recorded graph does not reach")
    out = [NDArray(g) for g in grads]
    return out[0] if single else out


def mark_variables(variables, gradients, grad_reqs="write"):
    """Make ``variables`` differentiable with ``gradients`` as their
    buffers."""
    from .ndarray.ndarray import NDArray
    if isinstance(variables, NDArray):
        variables, gradients = [variables], [gradients]
    if isinstance(grad_reqs, str):
        grad_reqs = [grad_reqs] * len(variables)
    for v, g, r in zip(variables, gradients, grad_reqs):
        v.attach_grad(r)
        v._grad = g


class _Bridge(torch.autograd.Function):
    """Runs a user :class:`Function`'s forward and backward on NDArrays."""

    @staticmethod
    def forward(ctx, func, *tensors):
        from .ndarray.ndarray import NDArray
        with pause():
            outs = func.forward(*[NDArray(t) for t in tensors])
        ctx.func = func
        if isinstance(outs, NDArray):
            return outs._data
        return tuple(o._data for o in outs)

    @staticmethod
    def backward(ctx, *cts):
        from .ndarray.ndarray import NDArray
        with pause():
            igs = ctx.func.backward(*[NDArray(c) for c in cts])
        if isinstance(igs, NDArray):
            igs = [igs]
        return (None,) + tuple(None if g is None else g._data for g in igs)


class Function:
    """A user-defined differentiable function: subclass and implement
    ``forward(self, *inputs)`` and ``backward(self, *output_grads)`` on
    NDArrays; recorded as one node whose gradient is ``backward``."""

    def __init__(self):
        self._saved = ()

    def save_for_backward(self, *arrays):
        self._saved = arrays

    @property
    def saved_tensors(self):
        return self._saved

    def forward(self, *inputs):
        raise NotImplementedError

    def backward(self, *output_grads):
        raise NotImplementedError

    def __call__(self, *inputs):
        from .ndarray.ndarray import NDArray
        if not is_recording():
            with pause():
                return self.forward(*inputs)
        with torch.enable_grad():
            outs = _Bridge.apply(self, *[x._data for x in inputs])
        _note_inputs(inputs)
        if isinstance(outs, torch.Tensor):
            return NDArray(outs)
        return tuple(NDArray(o) for o in outs)
