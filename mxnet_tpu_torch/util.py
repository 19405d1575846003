"""mx.util — the NumPy-semantics switches and small helpers (the port of
``mxnet_tpu/util.py``).

``set_np`` / ``reset_np`` and the ``np_array`` / ``np_shape`` scopes set
two flags of the calling thread.  nd and np share one array type in the
port, as in the reference, so the flags change no array: Gluon code and
user code read them (``is_np_array()``) to choose a namespace.
"""

from __future__ import annotations

import functools
import os
import threading

__all__ = ["is_np_array", "is_np_shape", "set_np", "reset_np", "set_np_shape",
           "use_np", "np_array", "np_shape", "getenv", "setenv"]

_tls = threading.local()


def _st():
    if not hasattr(_tls, "np_array"):
        _tls.np_array = False
        _tls.np_shape = False
    return _tls


def is_np_array():
    return _st().np_array


def is_np_shape():
    return _st().np_shape


def set_np(shape=True, array=True, dtype=False):  # noqa: ARG001
    """Turn NumPy semantics on (``npx.set_np()``) for this thread."""
    s = _st()
    s.np_array = array
    s.np_shape = shape


def reset_np():
    set_np(shape=False, array=False)


def set_np_shape(active):
    """Set the np-shape flag; returns its previous value."""
    prev = _st().np_shape
    _st().np_shape = active
    return prev


class _NpScope:
    def __init__(self, shape=True, array=True):
        self._shape = shape
        self._array = array

    def __enter__(self):
        s = _st()
        self._old = (s.np_shape, s.np_array)
        s.np_shape, s.np_array = self._shape, self._array
        return self

    def __exit__(self, *exc):
        s = _st()
        s.np_shape, s.np_array = self._old
        return False


def np_array(active=True):
    """A scope with the np-array flag set to ``active``."""
    return _NpScope(shape=_st().np_shape, array=active)


def np_shape(active=True):
    """A scope with the np-shape flag set to ``active``."""
    return _NpScope(shape=active, array=_st().np_array)


def use_np(func):
    """Run ``func`` under NumPy semantics (a decorator)."""
    @functools.wraps(func)
    def wrapper(*args, **kwargs):
        with _NpScope(True, True):
            return func(*args, **kwargs)
    return wrapper


def getenv(name):
    return os.environ.get(name)


def setenv(name, value):
    os.environ[name] = value
