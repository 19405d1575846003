"""gluon.Parameter, Constant and ParameterDict — the port of
``mxnet_tpu/gluon/parameter.py``.

A Parameter's value is one NDArray whose tensor is a ``torch.nn.Parameter``
(a leaf that requires grad unless ``grad_req="null"``), registered with
every Block that holds the Parameter as an attribute, so
``block.parameters()``, ``.to()`` and ``parallel.TrainStep`` see it.  Its
gradient buffer is a separate NDArray that ``autograd.backward`` fills
(``grad_req`` ``write`` or ``add``).  Shapes with a 0 are deferred: the
tensor is made, and registered with its blocks, at the first forward.

``initialize(ctx=[c0, c1, ...])`` makes one replica per context, each its
own ``nn.Parameter`` with its own gradient buffer, all from the same
initial values (data parallelism: ``gluon.utils.split_and_load`` gives each
replica a slice of the batch and the Trainer reduces the gradients through
a kvstore).  The replica on the first context is the one registered with
the blocks; a Block's forward reads the replica of its input's context.
"""

from __future__ import annotations

import re
import weakref

import numpy as np
import torch

from ..base import MXNetError, numpy_dtype, torch_dtype
from ..context import Context, context_of, current_context, resolve_device
from ..ndarray.ndarray import (NDArray, _placed, load as nd_load,
                               save as nd_save)

__all__ = ["Parameter", "Constant", "ParameterDict",
           "DeferredInitializationError"]


class DeferredInitializationError(MXNetError):
    pass


def _contexts(ctx):
    """A list of Contexts from None (the current context), one context or
    a list of them."""
    if ctx is None:
        return [current_context()]
    if not isinstance(ctx, (list, tuple)):
        ctx = [ctx]
    if not ctx:
        raise MXNetError("an empty context list")
    return [Context(c) if isinstance(c, Context)
            else context_of(resolve_device(c)) for c in ctx]


class Parameter:
    def __init__(self, name, grad_req="write", shape=None, dtype=np.float32,
                 lr_mult=1.0, wd_mult=1.0, init=None,
                 allow_deferred_init=False, differentiable=True,
                 stype="default", grad_stype="default", sharding=None):
        self.name = name
        self._grad_req = grad_req if differentiable else "null"
        if isinstance(shape, int):
            shape = (shape,)
        self.shape = tuple(shape) if shape is not None else None
        self.dtype = dtype
        self.lr_mult = lr_mult
        self.wd_mult = wd_mult
        self.init = init
        self.allow_deferred_init = allow_deferred_init
        self.stype = stype
        self.grad_stype = grad_stype
        # a layout hint (a mesh axis per dim, as gluon.contrib.SparseMoE
        # sets); recorded, read by nothing until multi-GPU parallelism
        self.sharding = sharding
        self._data = None           # NDArray over a torch.nn.Parameter
        self._data_list = None      # one such NDArray per context
        self._ctx_list = None
        self._deferred_init = None
        self._owners = []           # (weakref to Block, attribute name)

    # -- registration with the blocks that hold it ---------------------------
    def _add_owner(self, block, attr):
        self._owners.append((weakref.ref(block), attr))
        if self._data is not None:
            block._parameters[attr] = self._data._data

    def _register(self):
        for ref, attr in self._owners:
            block = ref()
            if block is not None:
                block._parameters[attr] = self._data._data

    # -- state ---------------------------------------------------------------
    @property
    def _ctx(self):
        """The first context: where the registered replica lives."""
        return self._ctx_list[0] if self._ctx_list else None

    @property
    def grad_req(self):
        return self._grad_req

    @grad_req.setter
    def grad_req(self, req):
        if req not in ("null", "write", "add"):
            raise MXNetError(f"grad_req must be null, write or add, not "
                             f"{req!r}")
        self._grad_req = req
        if self._data is not None:
            self._init_grad()

    def _shape_complete(self):
        return (self.shape is not None and len(self.shape) > 0
                and all(s > 0 for s in self.shape))

    # -- initialization ------------------------------------------------------
    def initialize(self, init=None, ctx=None, default_init=None,
                   force_reinit=False):
        """Allocate and fill the value on ``ctx`` (the current context when
        None) with ``init``, else this parameter's own ``init``, else
        ``default_init`` (Uniform); deferred while the shape has a 0."""
        from .. import initializer
        if self._data is not None and not force_reinit:
            return
        self._ctx_list = _contexts(ctx)
        init = init if init is not None else self.init
        if default_init is None:
            default_init = initializer.Uniform()
        if not self._shape_complete():
            if not self.allow_deferred_init:
                raise MXNetError(
                    f"Cannot initialize Parameter {self.name!r}: shape "
                    f"{self.shape} is incomplete and deferred init is off")
            self._deferred_init = (init, default_init)
            return
        self._finish_init(init, default_init)

    def _make(self, tensor):
        """Take ``tensor`` (a fresh value on the first context) as the
        parameter's data, and a copy of it on every other context."""
        req = self._grad_req != "null"
        self._data_list = [
            _placed(torch.nn.Parameter(
                tensor if j == 0 else
                tensor.detach().to(resolve_device(c), copy=True),
                requires_grad=req), c)
            for j, c in enumerate(self._ctx_list)]
        self._data = self._data_list[0]
        self._deferred_init = None
        self._init_grad()
        self._register()

    def _finish_init(self, init, default_init):
        from .. import initializer
        data = NDArray(torch.zeros(self.shape, dtype=torch_dtype(self.dtype),
                                   device=resolve_device(self._ctx)))
        fill = init if init is not None else default_init
        if isinstance(fill, str):
            fill = initializer.get(fill)
        fill(initializer.InitDesc(self.name), data)
        self._make(data._data)

    def _init_grad(self):
        for d in self._data_list:
            d._data.requires_grad_(self._grad_req != "null")
            d.grad_req = self._grad_req
            d._grad = None if self._grad_req == "null" else \
                NDArray(torch.zeros_like(d._data, requires_grad=False),
                        d._ctx)

    def _finish_deferred_init(self, in_shape=None):
        """Called by layers at the first forward once the input shape is
        known."""
        if self._deferred_init is None:
            return
        if in_shape is not None:
            self.shape = tuple(in_shape)
        if not self._shape_complete():
            raise DeferredInitializationError(
                f"Parameter {self.name!r} deferred init could not infer a "
                f"complete shape (got {self.shape})")
        self._finish_init(*self._deferred_init)

    def shape_mismatch_update(self, new_shape):
        """Merge inferred dims into a partially known shape."""
        if self.shape is None:
            self.shape = tuple(new_shape)
            return
        merged = []
        for old, new in zip(self.shape, new_shape):
            if old in (0, -1, None):
                merged.append(new)
            elif new in (0, -1, None) or old == new:
                merged.append(old)
            else:
                raise MXNetError(
                    f"Parameter {self.name!r}: inferred shape {new_shape} "
                    f"incompatible with declared {self.shape}")
        self.shape = tuple(merged)

    # -- access --------------------------------------------------------------
    def _check_initialized(self):
        if self._data is not None:
            return
        if self._deferred_init is not None:
            raise DeferredInitializationError(
                f"Parameter {self.name!r} has deferred initialization "
                "pending — run a forward pass first or set the input shape")
        raise MXNetError(f"Parameter {self.name!r} has not been initialized. "
                         "Call .initialize() first")

    def _value(self, ctx):
        """The replica on ``ctx`` (None: the first), unchecked."""
        if ctx is None or len(self._data_list) == 1:
            return self._data
        return self._replica(ctx)

    def _replica(self, ctx):
        for c, d in zip(self._ctx_list, self._data_list):
            if c == ctx:
                return d
        raise MXNetError(f"Parameter {self.name!r} was not initialized on "
                         f"context {ctx}; it lives on {self._ctx_list}")

    def data(self, ctx=None):
        """The value on ``ctx``; None, or a Parameter on one context: the
        first replica."""
        self._check_initialized()
        return self._value(ctx)

    def list_data(self):
        self._check_initialized()
        return list(self._data_list)

    def grad(self, ctx=None):
        d = self.data(ctx)
        if d._grad is None:
            raise MXNetError(f"Parameter {self.name!r} has grad_req='null'")
        return d._grad

    def list_grad(self):
        self._check_initialized()
        if self._data._grad is None:
            raise MXNetError(f"Parameter {self.name!r} has grad_req='null'")
        return [d._grad for d in self._data_list]

    def list_ctx(self):
        return list(self._ctx_list or [])

    def reset_ctx(self, ctx):
        """Move the value to the context(s) ``ctx``: one replica each."""
        self._ctx_list = _contexts(ctx)
        if self._data is not None:
            self._make(self._data._data.detach().to(
                resolve_device(self._ctx_list[0]), copy=True))

    def set_data(self, data):
        """Overwrite the value (cast to this parameter's dtype); an
        uninitialized parameter takes its shape and tensor from ``data``,
        on the context it was initialized for, else on ``data``'s device
        (numpy: the current context)."""
        if isinstance(data, NDArray):
            src = data._data
        elif isinstance(data, torch.Tensor):
            src = data
        else:
            src = torch.tensor(np.asarray(data))
            if self._ctx_list is None:
                self._ctx_list = [current_context()]
        if self._data is None:
            self.shape = tuple(src.shape)
            self._ctx_list = self._ctx_list or [context_of(src.device)]
            self._make(src.detach().to(resolve_device(self._ctx_list[0]),
                                       torch_dtype(self.dtype), copy=True))
            return
        for d in self._data_list:
            d._set_data(src.detach())

    def zero_grad(self):
        if self._data is None:
            return
        with torch.no_grad():
            for d in self._data_list:
                if d._grad is not None:
                    d._grad._data.zero_()

    def cast(self, dtype):
        """Cast the value to ``dtype`` in place (the same ``nn.Parameter``);
        the gradient buffer restarts at zero in the new dtype."""
        self.dtype = numpy_dtype(torch_dtype(dtype))
        if self._data is not None:
            for d in self._data_list:
                d._data.data = d._data.data.to(torch_dtype(dtype))
            self._init_grad()

    def __repr__(self):
        return (f"Parameter {self.name} (shape={self.shape}, "
                f"dtype={self.dtype})")


class Constant(Parameter):
    """A parameter holding a fixed value, never differentiated."""

    def __init__(self, name, value):
        if not isinstance(value, NDArray):
            value = torch.as_tensor(np.asarray(value, np.float32))
        else:
            value = value._data.detach()
        self.value = value
        super().__init__(name, grad_req="null", shape=tuple(value.shape),
                         dtype=numpy_dtype(value.dtype), init="zeros")

    def _finish_init(self, init, default_init):  # noqa: ARG002
        self._make(self.value.to(resolve_device(self._ctx), copy=True))


class ParameterDict:
    def __init__(self, prefix="", shared=None):
        self._prefix = prefix
        self._params = {}
        self._shared = shared

    @property
    def prefix(self):
        return self._prefix

    def __iter__(self):
        return iter(self._params.values())

    def __len__(self):
        return len(self._params)

    def items(self):
        return self._params.items()

    def keys(self):
        return self._params.keys()

    def values(self):
        return self._params.values()

    def __contains__(self, name):
        return name in self._params

    def __getitem__(self, name):
        return self._params[name]

    def get(self, name, **kwargs):
        """Create or retrieve ``prefix + name`` (from the shared dict when
        it holds it)."""
        full = self._prefix + name
        if full in self._params:
            p = self._params[full]
            for k, v in kwargs.items():
                if v is not None and getattr(p, k, None) in (None, 0, ()):
                    setattr(p, k, v)
            return p
        if self._shared is not None and full in self._shared:
            self._params[full] = self._shared[full]
            return self._params[full]
        p = Parameter(full, **kwargs)
        self._params[full] = p
        return p

    def get_constant(self, name, value=None):
        full = self._prefix + name
        if full not in self._params:
            self._params[full] = Constant(full, value)
        return self._params[full]

    def update(self, other):
        for k, v in other.items():
            if k in self._params and self._params[k] is not v:
                raise MXNetError(f"duplicate parameter name {k}")
            self._params[k] = v

    def initialize(self, init=None, ctx=None, verbose=False,
                   force_reinit=False):  # noqa: ARG002
        for p in self.values():
            p.initialize(init=init, ctx=ctx, force_reinit=force_reinit)

    def zero_grad(self):
        for p in self.values():
            p.zero_grad()

    def setattr(self, name, value):
        """Set attribute ``name`` of every parameter (``grad_req``,
        ``lr_mult``, ...)."""
        for p in self.values():
            setattr(p, name, value)

    def select(self, pattern):
        """The parameters whose names match the regex ``pattern``."""
        pat = re.compile(pattern)
        out = ParameterDict(self._prefix)
        out._params = {k: v for k, v in self.items() if pat.match(k)}
        return out

    def save(self, filename, strip_prefix=""):
        """Write every parameter to ``filename`` (``nd.save``) under its
        name, less ``strip_prefix`` where it starts with it."""
        arg = {}
        for k, p in self.items():
            key = k[len(strip_prefix):] if k.startswith(strip_prefix) else k
            arg[key] = p.data()
        nd_save(filename, arg)

    def load(self, filename, ctx=None, allow_missing=False,
             ignore_extra=False, restore_prefix=""):
        """Set every parameter from ``filename``, whose names gain
        ``restore_prefix``; missing and extra names raise unless
        ``allow_missing`` / ``ignore_extra``."""
        loaded = nd_load(filename, ctx=ctx)
        if restore_prefix:
            loaded = {restore_prefix + k: v for k, v in loaded.items()}
        for k, p in self.items():
            if k in loaded:
                p.set_data(loaded[k])
            elif not allow_missing:
                raise MXNetError(f"Parameter {k} missing in file {filename}")
        if not ignore_extra:
            extra = set(loaded) - set(self.keys())
            if extra:
                raise MXNetError(f"File {filename} contains extra "
                                 f"parameters: {sorted(extra)}")

    def __repr__(self):
        lines = "\n".join(f"  {v}" for v in self.values())
        return f"ParameterDict (\n{lines}\n)"
