"""``mx.attribute`` — ``AttrScope``, the port of ``mxnet_tpu/attribute.py``
(MXNet's ``python/mxnet/attribute.py``).

``with mx.AttrScope(__ctx_group__="dev1"):`` attaches string attributes
to every symbol made inside the scope (variables included: upstream's
``lr_mult``/``wd_mult``/``ctx_group`` annotations).  They ride in the
symbol's attributes, keys ``__dunder__``, and are never passed to an op.
"""

from __future__ import annotations

import threading

__all__ = ["AttrScope"]

_tls = threading.local()


def _stack():
    if not hasattr(_tls, "stack"):
        _tls.stack = [AttrScope()]
    return _tls.stack


class AttrScope:
    def __init__(self, **attrs):
        for k in attrs:
            if not (k.startswith("__") and k.endswith("__")):
                raise ValueError(
                    f"AttrScope keys must be __dunder__ strings, got {k!r} "
                    "(reference convention: user attrs are namespaced)")
        self._attrs = {k: str(v) for k, v in attrs.items()}

    @staticmethod
    def current():
        return _stack()[-1]

    def get(self, attrs=None):
        """The scope's attributes under the ones passed explicitly."""
        if not self._attrs:
            return dict(attrs or {})
        out = dict(self._attrs)
        out.update(attrs or {})
        return out

    def __enter__(self):
        # nested scopes accumulate; the object bound by ``as`` is the
        # merged scope, the one AttrScope.current() returns
        merged = AttrScope()
        merged._attrs = {**AttrScope.current()._attrs, **self._attrs}
        _stack().append(merged)
        return merged

    def __exit__(self, *exc):
        _stack().pop()
