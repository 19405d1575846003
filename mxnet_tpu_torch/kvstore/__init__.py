"""mx.kv — the port of ``mxnet_tpu/kvstore/``: ``create`` and the store of
one process (``KVStoreLocal``), with plug-in backends through
``KVStoreBase.register``.

``local``, ``device``, ``nccl``, ``local_update_cpu``,
``local_allreduce_cpu`` and ``local_allreduce_device`` are all the one
in-process store, as the reference maps them.  The distributed stores
(``dist_*``) and ``horovod`` are not yet ported and raise; the host
store of row-sparse tables that they route such keys to is
``kvstore.sparse_ps.SparsePS``, used directly until then.
"""

from __future__ import annotations

from ..base import MXNetError
from .base import KVStoreBase
from . import fusion  # noqa: F401
from .local import KVStoreLocal

__all__ = ["create", "KVStore", "KVStoreBase", "KVStoreLocal"]

_LOCAL = ("local", "local_update_cpu", "local_allreduce_cpu",
          "local_allreduce_device", "device", "nccl")


def create(name="local", **kwargs):
    """A kvstore by type name (``mx.kv.create("local")``)."""
    if not isinstance(name, str):
        raise MXNetError("name must be a string")
    n = name.lower()
    if n in _LOCAL:
        return KVStoreLocal(name=n)
    if n.startswith("dist") or n == "horovod":
        klass = KVStoreBase.registered(n)
        if klass is not None:
            return klass(**kwargs)
        raise MXNetError(f"kvstore {name!r} is not yet ported to "
                         "mxnet_tpu_torch (one process: 'local')")
    klass = KVStoreBase.registered(n)
    if klass is not None:
        return klass(**kwargs)
    raise MXNetError(f"unknown kvstore type {name!r}")


KVStore = KVStoreLocal
