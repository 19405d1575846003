"""KVStoreBase — the port of ``mxnet_tpu/kvstore/base.py``: the backend
interface and its registry of plug-in stores (``KVStoreBase.register``)."""

from __future__ import annotations

import warnings

__all__ = ["KVStoreBase"]

_BACKENDS = {}


class KVStoreBase:
    @staticmethod
    def register(klass):
        """Class decorator: make ``klass`` creatable by
        ``mx.kv.create(klass.__name__)`` (case-insensitive); registering a
        name again replaces the class, with a warning."""
        name = klass.__name__.lower()
        prev = _BACKENDS.get(name)
        if prev is not None and prev is not klass:
            warnings.warn(f"KVStore backend {name!r} already registered "
                          f"({prev.__name__}); overwriting with "
                          f"{klass.__name__}", stacklevel=2)
        _BACKENDS[name] = klass
        return klass

    @staticmethod
    def registered(name):
        """The registered backend class of a type string, or None."""
        return _BACKENDS.get(name.lower())

    @staticmethod
    def list_backends():
        return sorted(_BACKENDS)

    OPTIMIZER = "optimizer"

    def is_capable(self, capability):
        return capability == self.OPTIMIZER

    @property
    def type(self):
        raise NotImplementedError

    @property
    def rank(self):
        return 0

    @property
    def num_workers(self):
        return 1

    def connect(self):
        """Join the store's workers (a distributed store forms its process
        group here, and a failed rendezvous raises); nothing for a store
        of one process."""

    def broadcast(self, key, value, out):
        raise NotImplementedError

    def barrier(self):
        """Wait for all workers: the backend's ``_barrier`` where it has
        one, else nothing (one worker)."""
        inner = getattr(self, "_barrier", None)
        if inner is not None:
            inner()

    def pushpull(self, key, value, out=None, priority=0):
        raise NotImplementedError

    def pushpull_list(self, keys, values, outs, priority=0):
        """Several keys' pushpull in one call; here the per-key loop."""
        for k, v, o in zip(keys, values, outs):
            self.pushpull(k, v, out=o, priority=priority)
