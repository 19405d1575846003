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

A cast hook (``amp.init`` installs one) sees every op's tensor inputs at
this one chokepoint, in :func:`invoke_arrays` and in :data:`tensor_ops`
alike, and returns them cast (``set_dispatch_cast_hook``); each change of
the hook bumps :func:`dispatch_epoch`, by which a captured training step
knows its graphs baked the old casts.

After the cast hook, an op registered with ``promote`` gets its float
inputs in one dtype, as ``jnp``'s promotion gives the reference's ops
(torch's matmuls, index writes and fused norms want equal dtypes), and an
op registered with ``host_f32`` computes 16-bit float inputs in float32
on the CPU, whose kernels lack bfloat16 there, and casts its float
outputs back.

Monitor hooks (``mx.monitor``) see each op's outputs after
:func:`invoke`, and ``engine.on_dispatch`` runs there (NaiveEngine's
synchronisation).  With telemetry on, :func:`invoke` reports each
dispatch to ``telemetry.record_dispatch`` (counter, latency histogram,
trace event, per-op ledger row), the monitor hooks' time included; with
it off it pays one module-attribute read.  While the cost ledger is armed
(``telemetry.costmodel``), each new (op, shapes, dtypes, attributes) that
:func:`invoke` dispatches is analysed into an ``op:<name>`` entry.  Not
ported: the reference's per-op jit cache (eager torch has nothing to
compile).  A captured ``parallel.TrainStep`` replays without dispatching
through here, so neither hook sees its replays.
"""

from __future__ import annotations

import time as _time

import torch

from .. import telemetry as _telemetry
from ..base import MXNetError
from ..telemetry import costmodel as _costmodel
from ..telemetry import tracer as _ttrace

__all__ = ["Op", "register", "get", "alias", "list_ops", "invoke",
           "invoke_arrays", "tensor_ops", "set_dispatch_cast_hook",
           "dispatch_epoch", "add_monitor_hook", "remove_monitor_hook"]

_REGISTRY: dict = {}
# fn(op_name, tensors) -> tensors, applied before every op (amp); the epoch
# counts its changes
_cast_hook = None
_dispatch_epoch = 0


def set_dispatch_cast_hook(fn):
    """Install ``fn(op_name, tensors) -> tensors`` (None: none) before
    every op, and bump the dispatch epoch."""
    global _cast_hook, _dispatch_epoch
    _cast_hook = fn
    _dispatch_epoch += 1
    tensor_ops._forget()


def dispatch_epoch():
    return _dispatch_epoch


# fn(op_name, output tensors), called after each op that :func:`invoke`
# runs (mx.monitor); several monitors may be installed at once
_monitor_hooks: list = []


def add_monitor_hook(fn):
    if fn not in _monitor_hooks:
        _monitor_hooks.append(fn)


def remove_monitor_hook(fn):
    try:
        _monitor_hooks.remove(fn)
    except ValueError:
        pass


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
    promote : ``"common"``: dispatch casts the float inputs to their
        promoted dtype (``torch.promote_types``: bfloat16 and float32 give
        float32, as in ``jnp``); ``"first"``: to the first input's dtype
        (an indexed write keeps its destination's, as ``.at[]`` does);
        None: as given.
    host_f32 : 16-bit float inputs on the CPU are computed in float32 and
        the float outputs cast back to their dtype (torch's CPU kernel
        lacks bfloat16; the card's path is unchanged).

    The symbolic API (``mx.sym``) reads four more, set after registration
    (``ops/nn.py``): ``input_names``, the declared inputs (nnvm's
    FListInputNames), for which composition creates ``<name>_<input>``
    variables when they are not passed; ``aux_names``, those of them that
    are auxiliary states (BatchNorm's moving statistics);
    ``omit_inputs(attrs)``, the inputs absent under ``attrs`` (``bias``
    with ``no_bias``); and ``infer_args(shapes, attrs)``, which fills the
    unknown input shapes (None) from the known ones, as nnvm's InferShape
    pass does for the parameters.
    """

    __slots__ = ("name", "fn", "num_outputs", "differentiable",
                 "mutate_inputs", "visible_outputs", "wrap_key", "wrap_train",
                 "wrap_device", "promote", "host_f32", "doc", "input_names",
                 "aux_names", "omit_inputs", "infer_args")

    def __init__(self, name, fn, num_outputs=1, differentiable=True,
                 mutate_inputs=(), visible_outputs=None, wrap_key=None,
                 wrap_train=None, wrap_device=None, promote=None,
                 host_f32=False, doc=None):
        if promote not in (None, "common", "first"):
            raise MXNetError(f"op {name!r}: promote must be None, 'common' "
                             f"or 'first', got {promote!r}")
        self.name = name
        self.fn = fn
        self.num_outputs = num_outputs
        self.differentiable = differentiable
        self.mutate_inputs = tuple(mutate_inputs)
        self.visible_outputs = visible_outputs
        self.wrap_key = wrap_key
        self.wrap_train = wrap_train
        self.wrap_device = wrap_device
        self.promote = promote
        self.host_f32 = host_f32
        self.doc = doc if doc is not None else fn.__doc__
        self.input_names = None
        self.aux_names = frozenset()
        self.omit_inputs = None
        self.infer_args = None

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
    ``wrap_key`` (none on ``meta``, where shape inference draws nothing),
    the training flag under ``wrap_train`` and the device under
    ``wrap_device``."""
    if op.wrap_key is None and op.wrap_train is None \
            and op.wrap_device is None:
        return attrs
    from .. import autograd, random
    from ..context import resolve_device
    attrs = dict(attrs)
    if op.wrap_device is not None:
        attrs[op.wrap_device] = resolve_device(device)
    if op.wrap_key is not None and not (
            isinstance(device, torch.device) and device.type == "meta"):
        attrs[op.wrap_key] = random.generator(device)
    if op.wrap_train is not None and op.wrap_train not in attrs:
        attrs[op.wrap_train] = autograd.is_training()
    return attrs


def _is_float(t):
    return isinstance(t, torch.Tensor) and t.is_floating_point()


def _promote(mode, tensors):
    """``tensors`` with every float one in the dtype ``mode`` names."""
    floats = [t.dtype for t in tensors if _is_float(t)]
    if len(set(floats)) < 2:
        return tensors
    if mode == "first":
        dt = floats[0]
    else:
        dt = floats[0]
        for d in floats[1:]:
            dt = torch.promote_types(dt, d)
    return [t.to(dt) if _is_float(t) else t for t in tensors]


def _run_host_f32(op, tensors, attrs):
    """``op`` on the CPU with its 16-bit float inputs in float32, the
    float outputs cast back to the narrowest input dtype."""
    narrow = next((t.dtype for t in tensors
                   if _is_float(t) and t.itemsize < 4), None)
    if narrow is None or not any(_is_float(t) and t.device.type == "cpu"
                                 for t in tensors):
        return op.fn(*tensors, **attrs)
    raw = op.fn(*[t.float() if _is_float(t) and t.itemsize < 4 else t
                  for t in tensors], **attrs)
    back = [t.to(narrow) if _is_float(t) and t.dtype == torch.float32
            else t
            for t in (raw if isinstance(raw, (tuple, list)) else [raw])]
    if isinstance(raw, (tuple, list)):
        return type(raw)(back)
    return back[0]


def invoke_arrays(op, tensors, attrs, device=None):
    """Run ``op`` on raw tensors: no NDArray wrapping and no change of
    torch's grad mode."""
    if isinstance(op, str):
        op = get(op)
    if device is None:
        device = next((t.device for t in tensors
                       if isinstance(t, torch.Tensor)), None)
    if _cast_hook is not None:
        tensors = _cast_hook(op.name, list(tensors))
    if op.promote is not None:
        tensors = _promote(op.promote, tensors)
    attrs = _with_implicit(op, attrs or {}, device)
    if op.host_f32:
        return _run_host_f32(op, tensors, attrs)
    return op.fn(*tensors, **attrs)


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


_op_sites: dict = {}


def _invoke_costed(op, tensors, attrs, device):
    """:func:`invoke_arrays` as the ``op:<name>`` site of the cost ledger,
    keyed by the tensors' signature and the attributes."""
    site = _op_sites.get(op.name)
    if site is None:
        site = _op_sites[op.name] = _costmodel.Site(f"op:{op.name}")
    try:
        key = (_costmodel.signature(list(tensors)),
               repr(sorted((attrs or {}).items())))
    except TypeError:       # attributes that do not sort
        key = None
    return site.call(invoke_arrays, (op, tensors, attrs, device), key=key)


def _costmodel_rearm():
    """Armed, :func:`invoke` runs ops through :func:`_invoke_costed`;
    disarmed, straight through :func:`invoke_arrays`."""
    global _run
    _run = _invoke_costed if _costmodel.armed() else invoke_arrays


_run = invoke_arrays
_costmodel.add_rearm_hook(_costmodel_rearm)
_costmodel_rearm()


def invoke(op, inputs, attrs=None, out=None, ctx=None):
    """The ``Imperative::Invoke`` analog: run ``op`` on NDArray ``inputs``
    (recorded under ``autograd.record()``) and return NDArray output(s),
    written into ``out`` when given."""
    from .. import autograd, engine
    from ..context import resolve_device
    from ..ndarray.ndarray import NDArray
    if isinstance(op, str):
        op = get(op)
    # telemetry gate: one module-attribute read on the disabled path
    t0 = _time.perf_counter_ns() if _ttrace._ENABLED else None
    tensors = [a._data if isinstance(a, NDArray) else a for a in inputs]
    device = next((t.device for t in tensors if isinstance(t, torch.Tensor)),
                  None)
    if device is None:
        device = resolve_device(ctx)
    recording = autograd.is_recording() and op.differentiable
    with torch.set_grad_enabled(recording):
        raw = _run(op, tensors, attrs, device)
    outs = list(raw) if isinstance(raw, (tuple, list)) else [raw]
    engine.on_dispatch(outs)
    hook_ns = 0
    if _monitor_hooks and not engine.capturing():
        h0 = _time.perf_counter_ns() if t0 is not None else 0
        for hook in list(_monitor_hooks):
            hook(op.name, outs)
        if t0 is not None:
            hook_ns = _time.perf_counter_ns() - h0
    if t0 is not None:
        # host dispatch time; the device's is in the profiler's trace
        _telemetry.record_dispatch(op.name, t0, _time.perf_counter_ns(),
                                   hook_ns)
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

    def _forget(self):
        """Drop the callables looked up so far (a new cast hook)."""
        for name in [k for k in vars(self) if k != "_prefix"]:
            delattr(self, name)

    def __getattr__(self, name):
        full = self._prefix + name
        op = _REGISTRY.get(full)
        if op is not None:
            if op.mutate_inputs or op.visible_outputs is not None:
                def fn(*tensors, _op=op, **attrs):
                    return _invoke_tensors(_op, tensors, attrs)
            elif op.wrap_key is None and op.wrap_train is None \
                    and op.wrap_device is None and op.promote is None \
                    and not op.host_f32:
                fn = op.fn
                if _cast_hook is not None:
                    def fn(*tensors, _op=op, _hook=_cast_hook, **attrs):
                        return _op.fn(*_hook(_op.name, list(tensors)),
                                      **attrs)
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
