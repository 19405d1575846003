"""KVStoreLocal — the port of ``mxnet_tpu/kvstore/local.py``: the store of
one process (``local``, ``device``, ``nccl`` and the ``local_*`` names).

A key holds one NDArray.  ``push`` of a list of per-context values sums
them (staged onto the first value's device, added by ``fusion.tree_sum``)
and either stores the sum or, with an optimizer set
(``update_on_kvstore``), hands it to the store's ``Updater``, which
updates the stored weight; ``pull`` copies the stored value into every
output, on its own device.  ``pushpull_list`` reduces many keys at once,
bucket by bucket (``fusion.GradBucketer``), with the same adds as the
per-key path, so the two give the same bits.

With ``set_gradient_compression`` each replica's pushed gradient is
quantized to 2 bits and dequantized (``compression.py``, a residual per
key and replica) before the reduction, as MXNet's workers quantize
before they send; keys then reduce one by one.

Not ported: ``row_sparse_pull`` (the port has no sparse storage) raises.
"""

from __future__ import annotations

import torch

from ..base import MXNetError
from ..ndarray.ndarray import NDArray
from . import fusion
from .base import KVStoreBase

__all__ = ["KVStoreLocal"]


def _is_list(v):
    return isinstance(v, (list, tuple))


def _write(out, t):
    """Copy ``t`` into the NDArray ``out`` (onto its device)."""
    if out._data is not t:
        with torch.no_grad():
            out._data.copy_(t)


class KVStoreLocal(KVStoreBase):
    def __init__(self, name="local"):
        self._type = name
        self._store = {}
        self._updater = None
        self._optimizer = None
        self._bucket_bytes = fusion.bucket_bytes_from_env()
        self._bucketer = None
        self._compression = None

    @property
    def type(self):
        return self._type

    # -- reduction ------------------------------------------------------------
    @staticmethod
    def _stage(values, device):
        return [v._data if v._data.device == device else v._data.to(device)
                for v in values]

    def _reduce(self, values):
        """The sum of a value list as a tensor on the first value's
        device."""
        if not _is_list(values):
            return values._data
        dev = values[0]._data.device
        return fusion.tree_sum(self._stage(values, dev))

    # -- API ------------------------------------------------------------------
    def init(self, key, value):
        if _is_list(key):
            for k, v in zip(key, value):
                self.init(k, v)
            return
        if key in self._store:
            raise MXNetError(f"key {key!r} already initialized")
        v = value[0] if _is_list(value) else value
        self._store[key] = v.copy()

    def _stored(self, key):
        if key not in self._store:
            raise MXNetError(f"key {key!r} not initialized")
        return self._store[key]

    def push(self, key, value, priority=0):  # noqa: ARG002
        if _is_list(key) and _is_list(value) and len(key) > 1:
            for k, v in zip(key, value):
                self.push(k, v)
            return
        if _is_list(key):
            key = key[0]
        stored = self._stored(key)
        merged = self._reduce(self._compress_values(key, value))
        if self._updater is not None:
            self._updater(key, merged, stored)
        else:
            _write(stored, merged)

    def pull(self, key, out=None, priority=0,  # noqa: ARG002
             ignore_sparse=True):  # noqa: ARG002
        if _is_list(key) and _is_list(out) and len(key) > 1 \
                and len(key) == len(out):
            for k, o in zip(key, out):
                self.pull(k, o)
            return
        if _is_list(key):
            key = key[0]
        stored = self._stored(key)
        for o in (out if _is_list(out) else [out]):
            _write(o, stored._data)

    def pushpull(self, key, value, out=None, priority=0):
        self.push(key, value, priority)
        if out is not None:
            self.pull(key, out, priority)

    def row_sparse_pull(self, key, out=None, priority=0,  # noqa: ARG002
                        row_ids=None):  # noqa: ARG002
        raise MXNetError("row_sparse_pull needs sparse storage, which is not "
                         "yet ported to mxnet_tpu_torch")

    # -- many keys at once ----------------------------------------------------
    def set_bucket_size(self, mb):
        """The bucket bound in MB; 0 reduces key by key."""
        self._bucket_bytes = int(float(mb) * (1 << 20))
        self._bucketer = None

    def pushpull_list(self, keys, values, outs, priority=0):
        """pushpull of every key: bucket by bucket, unless the store owns
        the update (it runs per key inside push), buckets are off or
        gradients are compressed."""
        if self._updater is not None or self._bucket_bytes <= 0 \
                or self._compression is not None:
            return KVStoreBase.pushpull_list(self, keys, values, outs,
                                             priority=priority)
        vlists = [list(v) if _is_list(v) else [v] for v in values]
        if self._bucketer is None:
            self._bucketer = fusion.GradBucketer(self._bucket_bytes)
        for k in keys:
            self._stored(k)
        signature = tuple((tuple(v[0].shape), v[0]._data.dtype, len(v))
                          for v in vlists)
        for b in self._bucketer.plan(signature):
            dev = vlists[b.positions[0]][0]._data.device
            arrays = [t for r in range(b.n_rep) for t in self._stage(
                [vlists[p][r] for p in b.positions], dev)]
            for p, t in zip(b.positions, self._bucketer.reduce_bucket(
                    b, arrays)):
                _write(self._store[keys[p]], t)
                o = outs[p]
                for out_nd in (o if _is_list(o) else [o]):
                    if out_nd is not None:
                        _write(out_nd, t)

    def pushpull_flat(self, keys, values, outs, priority=0):  # noqa: ARG002
        """The reference's flat hand-off to a fused optimizer exists only
        for a cross-process store; in one process there is none: None, and
        the caller takes ``pushpull_list``."""
        return None

    def broadcast(self, key, value, out, priority=0):
        self.init(key, value)
        self.pull(key, out, priority)

    # -- the update on the store ----------------------------------------------
    def set_optimizer(self, optimizer):
        """Run ``optimizer`` on every push (``update_on_kvstore``)."""
        from .. import optimizer as opt
        self._optimizer = optimizer
        self._updater = opt.get_updater(optimizer)

    def set_gradient_compression(self, compression_params):
        """2-bit compression with error feedback of every pushed gradient
        (MXNet's ``set_gradient_compression``)."""
        from .compression import GradientCompression
        self._compression = GradientCompression(compression_params)

    def _compress_values(self, key, values):
        """Each replica's value quantized and dequantized."""
        if self._compression is None:
            return values
        out = []
        for slot, v in enumerate(values if _is_list(values) else [values]):
            packed, shape, dtype = self._compression.compress(key, slot,
                                                              v._data)
            out.append(NDArray(self._compression.decompress(packed, shape,
                                                            dtype), v._ctx))
        return out if _is_list(values) else out[0]

    def save_optimizer_states(self, fname, dump_optimizer=False):
        if self._updater is None:
            raise MXNetError("no optimizer set on this kvstore")
        with open(fname, "wb") as f:
            f.write(self._updater.get_states(dump_optimizer))

    def load_optimizer_states(self, fname):
        if self._updater is None:
            raise MXNetError("no optimizer set on this kvstore")
        with open(fname, "rb") as f:
            self._updater.set_states(f.read())

    def _barrier(self):
        from ..ndarray.ndarray import waitall
        waitall()

