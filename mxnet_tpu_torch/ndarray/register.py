"""Generate the ``mx.nd.*`` namespaces from the operator registry — the
port of ``mxnet_tpu/ndarray/register.py``.  Dotted op names become
sub-namespaces (``contrib.masked_selfatt`` -> ``mx.nd.contrib.
masked_selfatt``) and flattened aliases (``contrib_masked_selfatt``), as in
the reference.
"""

from __future__ import annotations

import sys
import types

import numpy as np

from ..ops import registry as _reg
from .ndarray import NDArray, array as _array


def _make_op_func(op):
    def fn(*args, out=None, name=None, ctx=None, **attrs):  # noqa: ARG001
        inputs = []
        for a in args:
            if isinstance(a, NDArray):
                inputs.append(a)
            elif isinstance(a, np.ndarray):
                inputs.append(_array(a, ctx=ctx))
            elif a is not None:
                raise TypeError(
                    f"operator {op.name}: positional arguments must be "
                    f"NDArray (got {type(a).__name__}); pass scalars as "
                    "keyword attributes")
        return _reg.invoke(op, inputs, attrs, out=out, ctx=ctx)

    fn.__name__ = op.name.split(".")[-1]
    fn.__doc__ = op.doc or f"generated wrapper of operator {op.name!r}"
    return fn


def populate(target_module):
    """Install a function for every registered op into ``target_module``;
    attributes already there (hand-written helpers) win.  Returns the
    names installed."""
    installed = []
    for name in _reg.list_ops():
        fn = _make_op_func(_reg.get(name))
        if "." in name:
            ns, leaf = name.split(".", 1)
            sub = getattr(target_module, ns, None)
            if sub is None:
                modname = f"{target_module.__name__}.{ns}"
                sub = types.ModuleType(modname,
                                       f"generated operator namespace {ns!r}")
                sys.modules[modname] = sub
                setattr(target_module, ns, sub)
            if not hasattr(sub, leaf):
                setattr(sub, leaf, fn)
                installed.append(name)
            name = name.replace(".", "_")
        if not hasattr(target_module, name):
            setattr(target_module, name, fn)
            installed.append(name)
    return installed
