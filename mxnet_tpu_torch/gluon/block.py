"""gluon.Block / HybridBlock over ``torch.nn.Module`` — the port of
``mxnet_tpu/gluon/block.py``.

A Block is a ``torch.nn.Module``: a child Block assigned as an attribute
or passed to ``register_child`` is also a torch submodule, and a
Parameter assigned as an attribute has its ``nn.Parameter`` registered
under that attribute's name once it has a value (``gluon/parameter.py``),
so ``net.parameters()`` and ``.to()`` are torch's.  Forward hooks are
MXNet's, not torch's: ``register_forward_pre_hook(hook)`` and
``register_forward_hook(hook)`` call ``hook(block, args)`` and
``hook(block, args, out)`` around ``forward`` and ignore what the hook
returns, as the reference does (a torch hook's return value would replace
the inputs or the output); each returns a handle whose ``remove()`` takes
the hook off.  ``apply(fn)`` visits the children, then the block, and
returns the block.  ``summary(*inputs)`` prints the reference's table.
Names follow the reference letter for letter: the thread-local
prefix counters and ``name_scope`` of ``_BlockScope`` give
``collect_params()`` the reference's keys, by which weights are carried
across (``convert.py``).

``HybridBlock.forward`` takes one of three paths:

- NDArrays, not hybridized: ``hybrid_forward(mx.nd, ...)``, every op an
  NDArray op through the registry, taped under ``autograd.record()``;
- NDArrays, hybridized: the inputs are unwrapped once and the whole
  subtree runs ``hybrid_forward`` on tensors with ``F`` the registered
  ops' tensor callables (``ops.registry.tensor_ops``), with torch's grad
  mode on exactly when MXNet records; the outputs are wrapped once.  This
  is the role of the reference's CachedOp (one ``jax.jit``) without a
  capture: no per-op NDArray wrapping, registry lookup or tape check;
- tensors (``parallel.TrainStep``, or a hybridized parent): the tensor
  path, under torch's current grad mode.

A Parameter with replicas on several contexts gives each forward the
replica on its input's context: the outermost block called with NDArrays
names the context for the tensors its subtree runs on.

``save_parameters``/``load_parameters`` write and read the reference's
``.params`` files (``nd.save``) under the same structural names, so a net
trained in either package loads in the other.  ``export`` and
``SymbolBlock`` need ``symbol/`` and are not ported yet.
"""

from __future__ import annotations

import re
import threading
from collections import OrderedDict

import numpy as np
import torch
from torch.utils.hooks import RemovableHandle

from .. import autograd
from .. import ndarray as nd
from ..base import MXNetError
from ..ndarray.ndarray import NDArray
from ..ops.registry import tensor_ops
from .parameter import (DeferredInitializationError, Parameter,
                        ParameterDict)

__all__ = ["Block", "HybridBlock", "SymbolBlock"]

_naming = threading.local()
_forward_ctx = threading.local()    # .value: the context a subtree runs on


def _prefix_counter(hint):
    if not hasattr(_naming, "counts"):
        _naming.counts = {}
    n = _naming.counts.get(hint, 0)
    _naming.counts[hint] = n + 1
    return f"{hint}{n}_"


class _BlockScope:
    """Name scope machinery (the reference's ``_BlockScope``)."""

    _current = threading.local()

    def __init__(self, block):
        self._block = block
        self._counter = {}
        self._old = None

    @staticmethod
    def create(prefix, params, hint):
        current = getattr(_BlockScope._current, "value", None)
        if current is None:
            if prefix is None:
                prefix = _prefix_counter(hint)
            params = ParameterDict(prefix) if params is None \
                else ParameterDict(params.prefix, params)
            return prefix, params
        if prefix is None:
            count = current._counter.get(hint, 0)
            current._counter[hint] = count + 1
            prefix = f"{hint}{count}_"
        if params is None:
            parent = current._block.params
            params = ParameterDict(parent.prefix + prefix, parent._shared)
        else:
            params = ParameterDict(params.prefix, params)
        return current._block.prefix + prefix, params

    def __enter__(self):
        if self._block._empty_prefix:
            return self
        self._old = getattr(_BlockScope._current, "value", None)
        _BlockScope._current.value = self
        return self

    def __exit__(self, *exc):
        if not self._block._empty_prefix:
            _BlockScope._current.value = self._old
        return False


class Block(torch.nn.Module):
    def __init__(self, prefix=None, params=None):
        super().__init__()
        self._empty_prefix = prefix == ""
        self._prefix, self._params = _BlockScope.create(prefix, params,
                                                        self._alias())
        self._name = self._prefix[:-1] if self._prefix.endswith("_") \
            else self._prefix
        self._scope = _BlockScope(self)
        self._children = {}
        self._reg_params = {}
        # MXNet's hook lists, apart from torch's _forward_hooks dicts
        self._mx_forward_hooks = OrderedDict()
        self._mx_forward_pre_hooks = OrderedDict()

    def _alias(self):
        return self.__class__.__name__.lower()

    @property
    def prefix(self):
        return self._prefix

    @property
    def name(self):
        return self._name

    def name_scope(self):
        return self._scope

    @property
    def params(self):
        return self._params

    def collect_params(self, select=None):
        """This block's and its children's parameters by full name, those
        matching the regex ``select`` when given."""
        ret = ParameterDict(self._params.prefix)
        if select is None:
            ret.update(self.params)
        else:
            pat = re.compile(select)
            ret.update({k: v for k, v in self.params.items()
                        if pat.match(k)})
        for child in self._children.values():
            ret.update(child.collect_params(select=select))
        return ret

    def __setattr__(self, name, value):
        if isinstance(value, Block):
            children = self.__dict__.get("_children")
            if children is not None:
                children[name] = value
        elif isinstance(value, Parameter):
            reg = self.__dict__.get("_reg_params")
            if reg is not None:
                reg[name] = value
                value._add_owner(self, name)
        super().__setattr__(name, value)

    def register_child(self, block, name=None):
        if name is None:
            name = str(len(self._children))
        self._children[name] = block
        self._modules[name] = block

    def register_forward_pre_hook(self, hook):
        """Call ``hook(block, args)`` before each forward; what it returns
        is ignored."""
        handle = RemovableHandle(self._mx_forward_pre_hooks)
        self._mx_forward_pre_hooks[handle.id] = hook
        return handle

    def register_forward_hook(self, hook):
        """Call ``hook(block, args, out)`` after each forward; what it
        returns is ignored."""
        handle = RemovableHandle(self._mx_forward_hooks)
        self._mx_forward_hooks[handle.id] = hook
        return handle

    def apply(self, fn):
        """``fn(block)`` on every child's subtree, then on this block."""
        for child in self._children.values():
            child.apply(fn)
        fn(self)
        return self

    def __call__(self, *args, **kwargs):
        for hook in tuple(self._mx_forward_pre_hooks.values()):
            hook(self, args)
        out = super().__call__(*args, **kwargs)
        for hook in tuple(self._mx_forward_hooks.values()):
            hook(self, args, out)
        return out

    def initialize(self, init=None, ctx=None, verbose=False,
                   force_reinit=False):
        self.collect_params().initialize(init=init, ctx=ctx, verbose=verbose,
                                         force_reinit=force_reinit)

    def hybridize(self, active=True, **kwargs):
        for child in self._children.values():
            child.hybridize(active, **kwargs)

    def cast(self, dtype):
        for child in self._children.values():
            child.cast(dtype)
        for p in self.params.values():
            p.cast(dtype)

    def save_parameters(self, filename, deduplicate=False):
        """Write every parameter of this block and its children to
        ``filename`` (``nd.save``) under its structural name
        (``features.1.running_var``), as the reference does.  A Parameter
        that several blocks share (tied weights) is written under each of
        its names, or with ``deduplicate`` once, under its last (MXNet
        1.6's rule; the reference ignores ``deduplicate``)."""
        params = self._collect_params_with_prefix()
        if deduplicate:
            last = {id(v): k for k, v in params.items()}
            params = {k: v for k, v in params.items() if last[id(v)] == k}
        nd.save(filename, {k: v.data() for k, v in params.items()})

    def _collect_params_with_prefix(self, prefix=""):
        if prefix:
            prefix += "."
        ret = {prefix + k: v for k, v in self._reg_params.items()}
        for name, child in self._children.items():
            ret.update(child._collect_params_with_prefix(prefix + name))
        return ret

    def load_parameters(self, filename, ctx=None, allow_missing=False,
                        ignore_extra=False, cast_dtype=False,
                        dtype_source="current"):  # noqa: ARG002
        """Set every parameter from ``filename``, by structural name or by
        full name (``p.name``), each cast to the parameter's dtype; an
        uninitialized one takes the file's shape, on ``ctx`` (else the
        current context).  A name missing from the file, or one in the
        file that no parameter has, raises unless ``allow_missing`` /
        ``ignore_extra``; a shared Parameter needs one of its names."""
        loaded = nd.load(filename, ctx=ctx)
        params = self._collect_params_with_prefix()
        names = {}
        for name, p in params.items():
            names.setdefault(id(p), []).append(name)
        for name, p in params.items():
            value = loaded.get(name, loaded.get(p.name))
            if value is not None:
                p.set_data(value)
            elif not allow_missing and not any(
                    k in loaded for k in names[id(p)]):
                raise MXNetError(f"Parameter {name} missing in {filename}")
        if not ignore_extra:
            known = set(params) | {p.name for p in params.values()} \
                | set(self.collect_params().keys())
            extra = [k for k in loaded if k not in known]
            if extra:
                raise MXNetError(f"{filename} has extra parameters {extra}")

    save_params = save_parameters
    load_params = load_parameters

    def forward(self, *args, **kwargs):
        raise NotImplementedError

    def summary(self, *inputs):
        """Run ``inputs`` through the block and print one row per block
        reached (its structural name, class, output shape and the size of
        its own parameters), then the total, as the reference does."""
        rows = []

        def shape_of(out):
            if isinstance(out, (NDArray, torch.Tensor)):
                return tuple(out.shape)
            return [tuple(o.shape) for o in out
                    if isinstance(o, (NDArray, torch.Tensor))]

        def hook_factory(bname):
            def hook(b, inp, out):  # noqa: ARG001
                n_params = sum(int(np.prod(p.shape))
                               for p in b._reg_params.values()
                               if p.shape is not None)
                rows.append((bname, type(b).__name__, shape_of(out),
                             n_params))
            return hook

        handles = []

        def attach(b, bname):
            handles.append(b.register_forward_hook(hook_factory(bname)))
            for n, c in b._children.items():
                attach(c, f"{bname}.{n}" if bname else n)

        attach(self, "")
        try:
            self(*inputs)
        finally:
            for h in handles:
                h.remove()
        print(f"{'Layer':<40}{'Output Shape':<24}{'Params':<12}")
        print("-" * 76)
        total = 0
        for bname, cls, shape, n in rows:
            print(f"{bname + ' (' + cls + ')':<40}{str(shape):<24}{n:<12}")
            total += n
        print("-" * 76)
        print(f"Total params (incl. shared): {total}")

    def __repr__(self):
        lines = []
        for name, child in self._children.items():
            child_repr = repr(child).replace("\n", "\n  ")
            lines.append(f"  ({name}): {child_repr}")
        body = "\n".join(lines)
        return f"{type(self).__name__}(\n{body}\n)" if body \
            else f"{type(self).__name__}()"


def _unwrap(x):
    return x._data if isinstance(x, NDArray) else x


def _wrap(out, ctx=None):
    if isinstance(out, torch.Tensor):
        return NDArray(out, ctx)
    if isinstance(out, (tuple, list)):
        return type(out)(_wrap(o, ctx) for o in out)
    return out


class HybridBlock(Block):
    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._active = False
        self._all_params = None

    def hybridize(self, active=True, static_alloc=False, static_shape=False,
                  **kwargs):
        """Run this block's subtree on tensors (see the module docstring);
        ``static_alloc``/``static_shape`` are accepted and have no effect
        (nothing is captured)."""
        self._active = active
        self._all_params = None
        super().hybridize(active, static_alloc=static_alloc,
                          static_shape=static_shape, **kwargs)

    def infer_shape(self, *args):
        """Resolve every deferred parameter shape of the subtree from the
        NDArray inputs ``args`` by running the forward once, imperatively
        (the reference's InferShape role)."""
        ctx = next(a.ctx for a in args if isinstance(a, NDArray))
        self.hybrid_forward(nd, *args, **self._params_for(args, ctx))

    def infer_param_shapes(self, args):
        """Layer-specific deferred-shape rule; layers with deferred
        parameters override it (Dense, LayerNorm)."""
        pending = [p.name for p in self._reg_params.values()
                   if p._data is None and p._deferred_init is not None]
        if pending:
            raise DeferredInitializationError(
                f"{type(self).__name__} cannot infer shapes for deferred "
                f"parameters {pending}; initialize them explicitly")

    def _params_for(self, args, ctx=None):
        """The registered parameters' values (NDArrays) on ``ctx``,
        finishing any deferred initialization from the inputs' shapes
        first."""
        pending = [p for p in self._reg_params.values()
                   if p._data is None and p._deferred_init is not None]
        if pending:
            self.infer_param_shapes(args)
            for p in pending:
                p._finish_deferred_init()
        return {name: p.data(ctx) for name, p in self._reg_params.items()}

    def _forward_tensors(self, args, kwargs):
        ctx = getattr(_forward_ctx, "value", None)
        params = {}
        for name, p in self._reg_params.items():
            if p._data is None:     # deferred, or an error to raise
                params = {k: v._data
                          for k, v in self._params_for(args, ctx).items()}
                break
            params[name] = p._value(ctx)._data
        return self.hybrid_forward(tensor_ops, *args, **params, **kwargs)

    def forward(self, *args, **kwargs):
        for a in args:
            if isinstance(a, NDArray):
                break
        else:
            return self._forward_tensors(args, kwargs)
        ctx = a.ctx
        if not self._active:
            return self.hybrid_forward(nd, *args,
                                       **self._params_for(args, ctx),
                                       **kwargs)
        recording = autograd.is_recording()
        prev = getattr(_forward_ctx, "value", None)
        _forward_ctx.value = ctx
        try:
            with torch.set_grad_enabled(recording):
                out = self._forward_tensors(
                    [_unwrap(a) for a in args],
                    {k: _unwrap(v) for k, v in kwargs.items()})
        finally:
            _forward_ctx.value = prev
        if recording:
            if self._all_params is None:
                self._all_params = list(self.collect_params().values())
            # the inputs too: one with a gradient buffer (a hybridized loss's
            # prediction) takes its gradient through the block
            autograd._note_inputs(
                [a for a in (*args, *kwargs.values())
                 if isinstance(a, NDArray)]
                + [p._value(ctx) for p in self._all_params
                   if p._data is not None])
        return _wrap(out, a._ctx)

    def hybrid_forward(self, F, x, *args, **kwargs):
        raise NotImplementedError

    def export(self, path, epoch=0):  # noqa: ARG002
        raise MXNetError("HybridBlock.export needs symbol/, which is not "
                         "yet ported to mxnet_tpu_torch")


class SymbolBlock(HybridBlock):
    def __init__(self, *args, **kwargs):  # noqa: ARG002
        raise MXNetError("SymbolBlock needs symbol/, which is not yet "
                         "ported to mxnet_tpu_torch")

    @classmethod
    def imports(cls, *args, **kwargs):  # noqa: ARG003
        raise MXNetError("SymbolBlock.imports needs symbol/, which is not "
                         "yet ported to mxnet_tpu_torch")
