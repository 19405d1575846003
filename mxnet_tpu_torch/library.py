"""``mx.library`` — operator libraries, the port of
``mxnet_tpu/library.py`` (MXNet's ``python/mxnet/library.py``).

MXNet's ``mx.library.load("libmyops.so")`` opens a C++ library that
registers operators through the C ABI.  Here, as in the reference, a
library is a Python file that registers operators through the same
public seams: ``mx.operator.register`` (``nd.Custom`` ops) or
``ops.registry.register`` (ops on tensors, run like the built-in ones).
``load(path)`` imports it and returns the names it added, which then
appear on ``mx.nd`` and ``mx.sym``; loading a file again returns the
same names, and a library that raises leaves no registration behind.
"""

from __future__ import annotations

import importlib.util
import os

from .base import MXNetError

__all__ = ["load", "loaded_libraries"]

_LOADED: dict = {}


def loaded_libraries():
    """path -> the op names it registered."""
    return dict(_LOADED)


def load(path, verbose=True):
    """Load an operator library (a ``.py`` file); returns the names of
    the operators it added.  A compiled ``.so`` raises."""
    path = os.path.abspath(path)
    if path in _LOADED:
        return list(_LOADED[path])
    if not os.path.exists(path):
        raise MXNetError(f"library not found: {path}")
    if not path.endswith(".py"):
        raise MXNetError(
            "mx.library.load on this stack loads PYTHON op libraries "
            "(the C ABI is a sanctioned drop — SURVEY N18/N30); wrap the "
            f"kernel in a .py module instead of {os.path.basename(path)!r}")
    from .ops import registry as _reg
    from . import operator as _custom
    before_ops = set(_reg.list_ops())
    before_custom = set(_custom.get_all_registered())

    name = "mxnet_tpu_torch_lib_" + \
        os.path.splitext(os.path.basename(path))[0]
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    try:
        spec.loader.exec_module(mod)
    except Exception:
        # roll both registries back, so a fixed library loads again
        for op in set(_reg.list_ops()) - before_ops:
            _reg._REGISTRY.pop(op, None)
        for op in set(_custom.get_all_registered()) - before_custom:
            _custom._REGISTRY.pop(op, None)
        raise
    new_ops = sorted(set(_reg.list_ops()) - before_ops)
    new_ops += sorted(set(_custom.get_all_registered()) - before_custom)
    if not new_ops:
        raise MXNetError(
            f"{path} registered no operators (libraries must call "
            "mxnet_tpu.operator.register or ops.registry.register)")
    from . import ndarray as _nd_mod
    from . import symbol as _sym_mod
    from .ndarray import register as _nd_reg
    from .symbol import register as _sym_reg
    _nd_reg.populate(_nd_mod)
    _sym_reg.populate(_sym_mod)
    _LOADED[path] = new_ops
    if verbose:
        print(f"mx.library: loaded {len(new_ops)} operator(s) from {path}")
    return new_ops
