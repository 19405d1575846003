"""mx.kv — the port of ``mxnet_tpu/kvstore/``: ``create`` and the store of
one process (``KVStoreLocal``), with plug-in backends through
``KVStoreBase.register``.

``local``, ``device``, ``nccl``, ``local_update_cpu``,
``local_allreduce_cpu`` and ``local_allreduce_device`` are all the one
in-process store, as the reference maps them.  ``dist_sync``,
``dist_device_sync``, ``dist_tpu_sync`` and ``dist`` are the distributed
store over ``torch.distributed`` (``kvstore/dist.py``), which keeps
row-sparse keys in a host ``kvstore.sparse_ps.SparsePS``.  ``dist_async``
raises as the reference's does; ``horovod`` raises unless a backend of
that name is registered.
"""

from __future__ import annotations

from ..base import MXNetError
from .base import KVStoreBase
from . import fusion  # noqa: F401
from .local import KVStoreLocal
from .dist import KVStoreDistTPUSync

__all__ = ["create", "KVStore", "KVStoreBase", "KVStoreLocal",
           "KVStoreDistTPUSync", "num_data_devices"]

_LOCAL = ("local", "local_update_cpu", "local_allreduce_cpu",
          "local_allreduce_device", "device", "nccl")


def num_data_devices():
    """The devices a data-parallel axis spans in this process: the CUDA
    cards it sees, or 1 (the host) where there is none."""
    import torch
    return max(torch.cuda.device_count(), 1)


def create(name="local", **kwargs):
    """A kvstore by type name (``mx.kv.create("local")``)."""
    if not isinstance(name, str):
        raise MXNetError("name must be a string")
    n = name.lower()
    if n in _LOCAL:
        return KVStoreLocal(name=n)
    if n in ("dist_sync", "dist_device_sync", "dist_tpu_sync", "dist"):
        return KVStoreDistTPUSync(name=n, **kwargs)
    if n in ("dist_async", "dist_sync_device_async"):
        raise MXNetError(
            "kvstore 'dist_async' is intentionally unsupported in the TPU "
            "rebuild: asynchronous parameter-server SGD has no TPU-native "
            "equivalent (no server processes exist; gradients reduce via "
            "synchronous XLA collectives). Use 'dist_tpu_sync'.")
    # plug-in backends resolve by class name, after the built-ins
    klass = KVStoreBase.registered(n)
    if klass is not None:
        return klass(**kwargs)
    if n == "horovod":
        raise MXNetError("horovod backend not available in this build; use "
                         "'dist_tpu_sync' (or KVStoreBase.register a "
                         "custom backend class named Horovod)")
    raise MXNetError(f"unknown kvstore type {name!r}")


KVStore = KVStoreLocal
