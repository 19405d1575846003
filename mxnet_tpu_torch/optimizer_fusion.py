"""Multi-tensor optimizer updates — the port of
``mxnet_tpu/optimizer_fusion.py``.

The reference plans same-dtype buckets and compiles one donated XLA
program per bucket.  Here the fused update is the optimizer's
``update_multi`` over all parameters at once: one chain of in-place
``torch._foreach_*`` passes per (master, dtype) group, with the formulas
of ``ops/optimizer_ops.py``.  torch's multi-tensor kernels already read
each weight and state once and write it in place, and split long tensor
lists into launches themselves, so there is nothing to bucket or compile;
:func:`exec_builds` counts the distinct parameter signatures updated (it
stays flat after a training loop's first step).

Only exact ``Adam`` and ``SGD`` are fused (:func:`supported_kind`), as in
the reference.  The update is elementwise, so the fused update and the
per-key path (``MXNET_OPTIMIZER_FUSED=0``) give the same bits, on the card
and on the CPU.  ``MXNET_OPTIMIZER_BUCKET_MB`` <= 0 turns fusion off as in
the reference; a positive bound is accepted and bounds nothing.
``update_on_kvstore``, a step skipped for a loss-scale overflow and every
other optimizer keep their own paths (``gluon.Trainer``).

``fused_update_flat`` takes the reduced gradients as a single flat buffer,
as a cross-process store would hand them over; the local store of one
process hands over none (``KVStoreLocal.pushpull_flat`` is None), so only
a direct call reaches it.  ``plan_trainstep`` and ``traced_update`` are
the reference's ``TrainStep`` entries; ``parallel.TrainStep`` already runs
one ``update_multi`` over its trainable tensors, which is what
``traced_update`` runs.  Not ported: the reference's telemetry counters
(ROADMAP A.11).
"""

from __future__ import annotations

import torch

from . import config

__all__ = ["fusion_enabled", "fusion_active", "supported_kind",
           "bucket_bytes_from_env", "fused_update", "fused_update_flat",
           "traced_update", "plan_trainstep", "reset", "exec_builds",
           "DEFAULT_OPT_BUCKET_MB"]

DEFAULT_OPT_BUCKET_MB = 25.0


def fusion_enabled():
    """``MXNET_OPTIMIZER_FUSED`` (default 1); 0 updates key by key
    everywhere (the same bits)."""
    return config.get_int("MXNET_OPTIMIZER_FUSED", 1) != 0


def bucket_bytes_from_env():
    """``MXNET_OPTIMIZER_BUCKET_MB`` in bytes; <= 0 turns fusion off."""
    return int(config.get_float("MXNET_OPTIMIZER_BUCKET_MB",
                                DEFAULT_OPT_BUCKET_MB) * (1 << 20))


def supported_kind(optimizer):
    """``"adam"`` or ``"sgd"`` for exactly those two classes (a subclass may
    change the math), else None."""
    from . import optimizer as _opt
    t = type(optimizer)
    if t is _opt.Adam:
        return "adam"
    if t is _opt.SGD:
        return "sgd"
    return None


def fusion_active(optimizer):
    """The one gate of every entry point: the knob on, a positive bucket
    bound and a supported optimizer."""
    return (fusion_enabled() and bucket_bytes_from_env() > 0
            and supported_kind(optimizer) is not None)


_signatures = set()
_builds = 0


def reset():
    """Forget the signatures seen (the build count stays)."""
    _signatures.clear()


def exec_builds():
    """Distinct parameter signatures updated so far: a training loop adds
    one at its first step and none after."""
    return _builds


def _note(tensors):
    global _builds
    signature = tuple((tuple(t.shape), t.dtype) for t in tensors)
    if signature not in _signatures:
        _signatures.add(signature)
        _builds += 1


def _kind_or_raise(optzr):
    kind = supported_kind(optzr)
    if kind is None:
        raise RuntimeError(f"optimizer_fusion does not support "
                           f"{type(optzr).__name__}")
    return kind


def _tensor(x):
    return getattr(x, "_data", x)


def fused_update(optzr, indices, weights, grads, states, traced=False):  # noqa: ARG001
    """Update ``weights`` (NDArrays or tensors, in place) with one
    ``update_multi`` from per-parameter ``grads``; ``states`` align with
    ``indices`` (``Updater._ensure_state``'s).  ``traced`` is the
    reference's flag for an update inside a trace and changes nothing
    here."""
    _kind_or_raise(optzr)
    weights = [_tensor(w) for w in weights]
    grads = [None if g is None else _tensor(g) for g in grads]
    _note(weights)
    optzr.update_multi(list(indices), weights, grads, list(states))


def fused_update_flat(optzr, indices, weights, states, shapes, sizes,
                      flat_grad, traced=False):  # noqa: ARG001
    """The update whose reduced gradients arrive as one flat buffer: each
    parameter's gradient is a view of its segment."""
    _kind_or_raise(optzr)
    weights = [_tensor(w) for w in weights]
    flat = _tensor(flat_grad)
    if flat.device != weights[0].device:
        flat = flat.to(weights[0].device)
    grads, off = [], 0
    for shape, size in zip(shapes, sizes):
        grads.append(flat[off:off + size].view(tuple(shape)))
        off += size
    _note(weights)
    optzr.update_multi(list(indices), weights, grads, list(states))


# -- the reference's TrainStep entries ---------------------------------------

def plan_trainstep(optzr, trainable):
    """``(kind, positions)`` for a ``TrainStep``'s trainable tensors (all of
    them, one update); None when fusion is off or the optimizer is not
    supported."""
    if not trainable or not fusion_active(optzr):
        return None
    _note(trainable)
    return supported_kind(optzr), list(range(len(trainable)))


def traced_update(optzr, kind, plan, trainable, states, grads=None):  # noqa: ARG001
    """One ``update_multi`` over ``plan``'s positions of ``trainable``
    (``grads`` default to the tensors' ``.grad``)."""
    if grads is None:
        grads = [t.grad for t in trainable]
    with torch.no_grad():
        optzr.update_multi(list(plan), [trainable[p] for p in plan],
                           [grads[p] for p in plan],
                           [states[p] for p in plan])
