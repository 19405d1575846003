"""Generate the ``mx.sym.<op>`` namespaces from the operator registry —
the port of ``mxnet_tpu/symbol/register.py`` (MXNet's
``python/mxnet/symbol/register.py``): ``ndarray/register.py``'s twin
that makes Symbols.

Composition follows nnvm's: symbols fill an op's declared inputs
(``Op.input_names``) by keyword or position, and each input not passed
becomes a variable ``<name>_<input>`` (``fc1_weight``), flagged as an
auxiliary state when the op declares it one (``Op.aux_names``).
"""

from __future__ import annotations

import sys
import types

from ..base import MXNetError
from ..ops import registry as _reg
from .symbol import Symbol, _name_hint, var


def _auto_name(opname, name=None):
    from ..name import NameManager
    return NameManager.current().get(name, _name_hint(opname))


def _make_sym_func(op):
    def fn(*args, name=None, attr=None, **attrs):
        from ..attribute import AttrScope
        inputs = [a for a in args if isinstance(a, Symbol)]
        sym_name = _auto_name(op.name, name)
        if op.input_names is not None:
            omit = op.omit_inputs(attrs) if op.omit_inputs else set()
            wanted = [n for n in op.input_names if n not in omit]
            by_name = {n: attrs.pop(n) for n in wanted
                       if isinstance(attrs.get(n), Symbol)}
            pos = list(inputs)
            full = []
            for n in wanted:
                if n in by_name:
                    v = by_name[n]
                elif pos:
                    v = pos.pop(0)
                else:
                    v = var(f"{sym_name}_{n}")
                # aux-ness follows the op's declared slot, however the
                # input was supplied
                if n in op.aux_names and v._op is None:
                    v._attrs["__aux__"] = True
                full.append(v)
            if pos:
                raise MXNetError(
                    f"operator {op.name!r} takes inputs {wanted} "
                    f"(attrs {sorted(omit)} omitted); {len(pos)} extra "
                    f"positional symbol(s) could not be placed")
            inputs = full
        leftover = [k for k, v in attrs.items() if isinstance(v, Symbol)]
        if leftover:
            raise MXNetError(
                f"operator {op.name!r}: symbol(s) passed for "
                f"non-input keyword(s) {leftover} (reference nnvm "
                f"composition rejects unplaceable inputs)")
        s = Symbol(op, inputs, attrs, name=sym_name,
                   num_outputs=op.num_outputs if op.num_outputs > 0 else 1)
        if attr:
            bad = [k for k in attr
                   if not (k.startswith("__") and k.endswith("__"))]
            if bad:
                raise MXNetError(
                    f"attr keys must be __dunder__ strings, got {bad} "
                    "(non-dunder keys would collide with operator kwargs)")
        scope_attr = AttrScope.current().get(attr)
        if scope_attr:
            s._attrs.update(scope_attr)
        return s

    fn.__name__ = op.name.split(".")[-1]
    fn.__doc__ = op.doc or f"symbolic wrapper of operator {op.name!r}"
    return fn


def populate(target_module):
    """Install a Symbol-making function for every registered op into
    ``target_module`` (dotted names into sub-namespaces, and flattened:
    ``contrib_masked_selfatt``); names already there win.  Returns the
    names installed.  The ``np.*`` ops of ``mx.np`` get no namespace
    here (the reference has no ``mx.sym.np``)."""
    installed = []
    for name in _reg.list_ops():
        if name.startswith("np."):
            continue
        fn = _make_sym_func(_reg.get(name))
        if "." in name:
            ns, leaf = name.split(".", 1)
            if "." in leaf:
                continue
            sub = getattr(target_module, ns, None)
            if sub is None:
                modname = f"{target_module.__name__}.{ns}"
                sub = sys.modules.get(modname)
                if sub is None:
                    sub = types.ModuleType(
                        modname, f"generated operator namespace {ns!r}")
                    sys.modules[modname] = sub
                setattr(target_module, ns, sub)
            if not hasattr(sub, leaf):
                setattr(sub, leaf, fn)
                installed.append(f"{ns}.{leaf}")
            flat = name.replace(".", "_")
            if not hasattr(target_module, flat):
                setattr(target_module, flat, fn)
        elif not hasattr(target_module, name):
            setattr(target_module, name, fn)
            installed.append(name)
    return installed
