"""``mx.name`` — symbol auto-naming, the port of ``mxnet_tpu/name.py``
(MXNet's ``python/mxnet/name.py``).

``NameManager`` gives each anonymous symbol a unique name (``dot0``,
``fullyconnected1``, ...) from one counter per hint; ``Prefix`` puts a
fixed prefix before it.  A thread-local stack with the context-manager
protocol, as upstream.  The counters count as the reference's do, so a
graph built alike in either package names its nodes alike and its json
loads in the other.
"""

from __future__ import annotations

import threading

__all__ = ["NameManager", "Prefix"]

_tls = threading.local()


def _stack():
    if not hasattr(_tls, "stack"):
        _tls.stack = [NameManager()]
    return _tls.stack


class NameManager:
    """One counter per hint: ``get(None, "dot")`` -> ``dot0``, ``dot1``..."""

    def __init__(self):
        self._counter = {}

    @staticmethod
    def current():
        return _stack()[-1]

    def get(self, name, hint):
        if name is not None:
            return name
        n = self._counter.get(hint, 0)
        self._counter[hint] = n + 1
        return f"{hint}{n}"

    def __enter__(self):
        _stack().append(self)
        return self

    def __exit__(self, *exc):
        _stack().pop()


class Prefix(NameManager):
    """Auto-names carry a fixed prefix."""

    def __init__(self, prefix):
        super().__init__()
        self._prefix = prefix

    def get(self, name, hint):
        if name is not None:
            return name
        return self._prefix + super().get(None, hint)
