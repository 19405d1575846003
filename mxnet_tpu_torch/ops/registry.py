"""Operator registry and imperative dispatch — the port of
``mxnet_tpu/ops/registry.py`` (``Op``, ``register``, ``get``, ``alias``,
``list_ops``, ``invoke_arrays``, ``invoke``).

An op is a Python callable ``fn(*tensors, **attrs)`` on ``torch.Tensor``s;
``mx.nd.*`` is generated from this registry (``ndarray/register.py``) and
a hybridized Gluon block calls the same callables through
:data:`tensor_ops`, without NDArray wrapping.  Gradients come from torch
autograd: :func:`invoke` runs an op with torch's grad mode on exactly when
MXNet records it (``autograd.is_recording()`` and the op is
differentiable), so nothing is taped outside ``autograd.record()``.

An op that declares ``mutate_inputs`` (BatchNorm's moving statistics)
returns the new values as extra outputs; dispatch writes each into its
input's own tensor, in place and outside autograd, and only when the op
returned a new tensor (an unchanged input comes back as itself), so a
tensor that autograd saved is never written.  ``visible_outputs`` hides
the extra outputs from the caller, in :func:`invoke` and in
:data:`tensor_ops` alike.

Not ported: the reference's per-op jit cache (eager torch has nothing to
compile), its amp cast, monitor and cost-model hooks.
"""

from __future__ import annotations

import torch

from ..base import MXNetError

__all__ = ["Op", "register", "get", "alias", "list_ops", "invoke",
           "invoke_arrays", "tensor_ops"]

_REGISTRY: dict = {}


class Op:
    """One registered operator.

    name : registry name; a dot makes a sub-namespace (``contrib.x`` ->
        ``mx.nd.contrib.x``).
    fn : the implementation, ``fn(*tensors, **attrs)``.
    num_outputs : static output count, or -1 (a variable-length tuple).
    differentiable : False for integer-valued ops: never recorded.
    mutate_inputs : ``(out_idx, in_idx)`` pairs: output ``out_idx`` is
        written back into input ``in_idx``.
    visible_outputs : how many leading outputs the caller sees (None: all).
    wrap_key : if set, dispatch passes the device's ``torch.Generator``
        under this keyword (the reference passes a fresh PRNG key).
    wrap_train : if set, dispatch passes ``autograd.is_training()`` under
        this keyword unless the caller did.
    wrap_device : if set, dispatch passes the ``torch.device`` the op runs
        on under this keyword: an op without tensor inputs (``_zeros``,
        ``eye``) creates its output there (the reference places it on the
        current context).
    """

    __slots__ = ("name", "fn", "num_outputs", "differentiable",
                 "mutate_inputs", "visible_outputs", "wrap_key", "wrap_train",
                 "wrap_device", "doc")

    def __init__(self, name, fn, num_outputs=1, differentiable=True,
                 mutate_inputs=(), visible_outputs=None, wrap_key=None,
                 wrap_train=None, wrap_device=None, doc=None):
        self.name = name
        self.fn = fn
        self.num_outputs = num_outputs
        self.differentiable = differentiable
        self.mutate_inputs = tuple(mutate_inputs)
        self.visible_outputs = visible_outputs
        self.wrap_key = wrap_key
        self.wrap_train = wrap_train
        self.wrap_device = wrap_device
        self.doc = doc if doc is not None else fn.__doc__

    def __repr__(self):
        return f"<Op {self.name}>"


def register(name, **kwargs):
    """Decorator: ``@register("dot")`` registers ``fn`` under ``name`` and
    returns it unchanged."""
    def deco(fn):
        if name in _REGISTRY:
            raise MXNetError(f"op {name!r} already registered")
        _REGISTRY[name] = Op(name, fn, **kwargs)
        return fn
    return deco


def get(name):
    try:
        return _REGISTRY[name]
    except KeyError:
        raise MXNetError(f"no such operator: {name!r}") from None


def alias(new_name, existing_name):
    """Expose an op under a second name."""
    if existing_name not in _REGISTRY:
        raise MXNetError(f"alias target {existing_name!r} not registered")
    if new_name in _REGISTRY:
        raise MXNetError(f"op {new_name!r} already registered")
    _REGISTRY[new_name] = _REGISTRY[existing_name]


def list_ops():
    return sorted(_REGISTRY)


def _with_implicit(op, attrs, device):
    """``attrs`` plus what dispatch supplies: the device's generator under
    ``wrap_key``, the training flag under ``wrap_train`` and the device
    under ``wrap_device``."""
    if op.wrap_key is None and op.wrap_train is None \
            and op.wrap_device is None:
        return attrs
    from .. import autograd, random
    from ..context import resolve_device
    attrs = dict(attrs)
    if op.wrap_device is not None:
        attrs[op.wrap_device] = resolve_device(device)
    if op.wrap_key is not None:
        attrs[op.wrap_key] = random.generator(device)
    if op.wrap_train is not None and op.wrap_train not in attrs:
        attrs[op.wrap_train] = autograd.is_training()
    return attrs


def invoke_arrays(op, tensors, attrs, device=None):
    """Run ``op`` on raw tensors: no NDArray wrapping and no change of
    torch's grad mode."""
    if isinstance(op, str):
        op = get(op)
    if device is None:
        device = next((t.device for t in tensors
                       if isinstance(t, torch.Tensor)), None)
    return op.fn(*tensors, **_with_implicit(op, attrs or {}, device))


def _write_back(op, tensors, outs):
    """Copy each ``mutate_inputs`` output into its input tensor (in place,
    outside autograd) where the op returned a new value."""
    with torch.no_grad():
        for out_idx, in_idx in op.mutate_inputs:
            if outs[out_idx] is not tensors[in_idx]:
                tensors[in_idx].copy_(outs[out_idx])


def _invoke_tensors(op, tensors, attrs):
    """``F.<op>`` of a hybridized block: the op on tensors, its write-backs
    done and only its visible outputs returned."""
    outs = invoke_arrays(op, tensors, attrs)
    _write_back(op, tensors, outs)
    if op.visible_outputs is None:
        return outs
    return outs[0] if op.visible_outputs == 1 else \
        outs[:op.visible_outputs]


def invoke(op, inputs, attrs=None, out=None, ctx=None):
    """The ``Imperative::Invoke`` analog: run ``op`` on NDArray ``inputs``
    (recorded under ``autograd.record()``) and return NDArray output(s),
    written into ``out`` when given."""
    from .. import autograd
    from ..context import resolve_device
    from ..ndarray.ndarray import NDArray
    if isinstance(op, str):
        op = get(op)
    tensors = [a._data if isinstance(a, NDArray) else a for a in inputs]
    device = next((t.device for t in tensors if isinstance(t, torch.Tensor)),
                  None)
    if device is None:
        device = resolve_device(ctx)
    recording = autograd.is_recording() and op.differentiable
    with torch.set_grad_enabled(recording):
        raw = invoke_arrays(op, tensors, attrs, device)
    outs = list(raw) if isinstance(raw, (tuple, list)) else [raw]
    if op.mutate_inputs:
        _write_back(op, tensors, outs)
    if recording:
        autograd._note_inputs(inputs)
    if op.visible_outputs is not None and out is None:
        outs = outs[:op.visible_outputs]
    if out is None:
        # a host replica's context label (cpu(1)) carries to the outputs
        ctx = next((a._ctx for a in inputs
                    if isinstance(a, NDArray) and a._ctx is not None), None)
        results = [NDArray(t, ctx) for t in outs]
    else:
        results = list(out) if isinstance(out, (list, tuple)) else [out]
        if len(results) != len(outs):
            raise MXNetError(f"op {op.name}: {len(outs)} outputs but "
                             f"{len(results)} out= arrays")
        for dst, t in zip(results, outs):
            dst._assign(t)
    if len(results) == 1 and (op.num_outputs in (1, -1)
                              or op.visible_outputs == 1):
        return results[0]
    return results


class _TensorNamespace:
    """``F`` of a hybridized block: each registered op's callable on
    tensors (``F.FullyConnected(x, w, b, num_hidden=...)``), with the
    generator and training flag supplied as :func:`invoke` supplies them,
    and dotted names as sub-namespaces (``F.contrib.masked_selfatt``)."""

    def __init__(self, prefix=""):
        self._prefix = prefix

    def __getattr__(self, name):
        full = self._prefix + name
        op = _REGISTRY.get(full)
        if op is not None:
            if op.mutate_inputs or op.visible_outputs is not None:
                def fn(*tensors, _op=op, **attrs):
                    return _invoke_tensors(_op, tensors, attrs)
            elif op.wrap_key is None and op.wrap_train is None \
                    and op.wrap_device is None:
                fn = op.fn
            else:
                def fn(*tensors, _op=op, **attrs):
                    return invoke_arrays(_op, tensors, attrs)
        elif any(k.startswith(full + ".") for k in _REGISTRY):
            fn = _TensorNamespace(full + ".")
        else:
            raise AttributeError(f"no operator {full!r}")
        setattr(self, name, fn)
        return fn


tensor_ops = _TensorNamespace()
