"""How a function of ``mx.np`` reaches the op registry (the port of the
reference's ``_wrap_jnp``, ``mxnet_tpu/numpy/__init__.py``).

:func:`dispatch` makes one op, ``np.<name>``, around ``impl`` and puts it
in the registry; ``mx.np``'s function and a direct ``mx.ops.invoke`` both
run that op.  The op gets its device from dispatch (``wrap_device``: the
first input's, else the current context's) and returns its tensors flat.
A call of ``mx.np``'s function replaces each array it was given (an
``NDArray`` or a ``torch.Tensor``, bare or inside nested lists and tuples,
positional or keyword) by a slot, passes the arguments so marked to the op
and rebuilds the structure ``impl`` returned (a tuple stays a tuple):

- with an ``NDArray`` among the arrays, through ``registry.invoke``, so
  autograd, amp's cast hook, the monitors, telemetry's per-op ledger and
  the profiler see an nd op, and the outputs come back as NDArrays;
- with bare tensors only (the ``F`` path of a hybridized block), through
  ``registry.invoke_arrays`` (the cast hook included), returning tensors;
- with no array at all (``zeros``, ``arange``), through
  ``registry.invoke`` on ``ctx=`` / ``device=`` or the current context,
  returning NDArrays.

:func:`host` binds a function whose answer is a Python value (a shape, a
dtype, a bool): it runs directly and returns that value.  Its registry op
carries the name (the registry holds the reference's 370 ``np.*`` names)
and refuses to run.
"""

from __future__ import annotations

import torch

from ..base import MXNetError
from ..context import Context, current_context
from ..ndarray.ndarray import NDArray, _placed
from ..ops import registry as _reg
from . import _impl


class _Slot:
    __slots__ = ()

    def __repr__(self):
        return "_"


_SLOT = _Slot()


class _Seq:
    __slots__ = ("kind", "items")

    def __init__(self, kind, items):
        self.kind, self.items = kind, items

    def __repr__(self):
        return f"{self.kind.__name__}({self.items!r})"


def _has_array(v):
    if isinstance(v, (NDArray, torch.Tensor)):
        return True
    if isinstance(v, (list, tuple)):
        return any(_has_array(u) for u in v)
    return False


def _collect(v, inputs):
    if isinstance(v, (NDArray, torch.Tensor)):
        inputs.append(v)
        return _SLOT
    if isinstance(v, (list, tuple)) and _has_array(v):
        return _Seq(type(v), [_collect(u, inputs) for u in v])
    return v


def _fill(spec, it):
    if spec is _SLOT:
        return next(it)
    if isinstance(spec, _Seq):
        items = [_fill(u, it) for u in spec.items]
        return items if spec.kind is list else tuple(items)
    return spec


def _flatten(out, leaves):
    """``out`` with its tensors replaced by slots (appended to ``leaves``)."""
    if isinstance(out, torch.Tensor):
        leaves.append(out)
        return _SLOT
    if isinstance(out, (list, tuple)):
        return _Seq(list if isinstance(out, list) else tuple,
                    [_flatten(u, leaves) for u in out])
    return out


def _call(impl, device, args, kwargs):
    prev = getattr(_impl._call, "device", None)
    _impl._call.device = device
    try:
        return impl(*args, **kwargs)
    finally:
        _impl._call.device = prev


def _place(ctx):
    return ctx if isinstance(ctx, Context) else None


class _Tree(list):
    """Where the op puts the structure of its outputs for ``mx.np``; one
    repr, so the cost ledger keys a call by its arguments alone."""

    __slots__ = ()

    def __repr__(self):
        return "_Tree"


class _NpFn:
    """The callable of the op ``np.<name>``: ``impl`` run on the device
    that dispatch passes, its tensors returned flat (one tensor as it is,
    else a tuple).

    A direct caller (``mx.ops.invoke("np.add", [a, b])``) gives the arrays
    as the inputs and the rest as attributes.  ``mx.np`` gives ``_spec``,
    its call's arguments with a slot for each array, and ``_tree``, into
    which the op puts the structure of what ``impl`` returned."""

    __slots__ = ("impl",)

    def __init__(self, impl):
        self.impl = impl

    def __call__(self, *tensors, _device=None, _spec=None, _tree=None,
                 **kwargs):
        args = tensors
        if _spec is not None:
            it = iter(tensors)
            args = [_fill(s, it) for s in _spec[0]]
            kwargs = {k: _fill(s, it) for k, s in _spec[1].items()}
        leaves = []
        tree = _flatten(_call(self.impl, _device, args, kwargs), leaves)
        if _tree is not None:
            _tree.append(tree)
        return leaves[0] if tree is _SLOT else tuple(leaves)


def dispatch(name, impl, differentiable=True, register=True):
    """The user-facing function of ``impl``, run through the op
    ``np.<name>`` (registered unless ``register`` is False)."""
    op = _reg.Op("np." + name, _NpFn(impl), num_outputs=-1,
                 differentiable=differentiable, wrap_device="_device",
                 doc=impl.__doc__)
    if register:
        op = _reg._REGISTRY.setdefault(op.name, op)

    def fn(*args, **kwargs):
        ctx = kwargs.pop("ctx", None)
        dev = kwargs.pop("device", None)
        ctx = ctx if ctx is not None else dev
        inputs = []
        spec = ([_collect(a, inputs) for a in args],
                {k: _collect(v, inputs) for k, v in kwargs.items()})
        tree = _Tree()
        attrs = {"_spec": spec, "_tree": tree}
        if inputs and not any(isinstance(a, NDArray) for a in inputs):
            raw = _reg.invoke_arrays(op, inputs, attrs)
            return _fill(tree[0], iter(raw if isinstance(raw, tuple)
                                       else (raw,)))
        if inputs:
            res = _reg.invoke(op, [a if isinstance(a, NDArray) else NDArray(a)
                                   for a in inputs], attrs)
        else:
            ctx = ctx if ctx is not None else current_context()
            res = _reg.invoke(op, [], attrs, ctx=ctx)
        res = res if isinstance(res, list) else [res]
        if not inputs:
            res = [_placed(r._data, _place(ctx)) for r in res]
        return _fill(tree[0], iter(res))

    fn.__name__ = name.rsplit(".", 1)[-1]
    fn.__qualname__ = fn.__name__
    fn.__doc__ = impl.__doc__
    return fn


def host(name, fn, register=True):
    """``fn`` as it is: its answer is a host value.  The op ``np.<name>``
    (registered unless ``register`` is False) carries the name and refuses
    to run, since what it answers is not arrays."""
    if register:
        def refuse(*_args, **_kwargs):
            raise MXNetError(f"np.{name} answers a host value, not arrays: "
                             f"call mx.np.{name}")
        _reg._REGISTRY.setdefault("np." + name, _reg.Op(
            "np." + name, refuse, num_outputs=-1, differentiable=False,
            doc=fn.__doc__))
    return fn


def tensor_of(v):
    """The tensor of an NDArray (anything else as it is)."""
    return v._data if isinstance(v, NDArray) else v
