"""KVStoreLocal — the port of ``mxnet_tpu/kvstore/local.py``: the store of
one process (``local``, ``device``, ``nccl`` and the ``local_*`` names).

A key holds one NDArray.  ``push`` of a list of per-context values sums
them (staged onto the first value's device, added by ``fusion.tree_sum``)
and either stores the sum or, with an optimizer set
(``update_on_kvstore``), hands it to the store's ``Updater``, which
updates the stored weight; ``pull`` copies the stored value into every
output, on its own device.  ``pushpull_list`` reduces many keys at once,
bucket by bucket (``fusion.GradBucketer``), with the same adds as the
per-key path, so the two give the same bits.  The distributed store
(``dist.py``) is this store with two steps more: ``_push_sum`` and
``_across`` also sum a key's or a bucket's value over its workers.

With ``set_gradient_compression`` each replica's pushed gradient is
quantized to 2 bits and dequantized (``compression.py``, a residual per
key and replica) before the reduction, as MXNet's workers quantize
before they send; keys then reduce one by one.

With telemetry on, ``push`` and ``pull`` are ``kvstore.push`` and
``kvstore.pull`` spans counted in ``mxnet_kvstore_{push,pull}_bytes_total``
and ``mxnet_kvstore_{push,pull}_seconds``; ``pushpull_list`` is a
``kvstore.fused_pushpull`` span feeding the fused path's counters
(``fusion.record_*``).

A key may hold a row_sparse array (``ndarray/sparse.py``): pushed
row-sparse values merge by row (the rows' union, duplicates summed on the
values' device) and replace it, ``pull`` gives it dense, and
``row_sparse_pull`` gives each output the stored rows its ``row_ids``
ask for (a dense value is cast to row_sparse first).
"""

from __future__ import annotations

import time as _time

import torch

from .. import telemetry as _tel
from ..base import MXNetError
from ..telemetry import tracer as _ttrace
from ..ndarray import sparse as _sparse
from ..ndarray.ndarray import NDArray
from . import fusion
from .base import KVStoreBase

__all__ = ["KVStoreLocal"]


_M_PUSH_BYTES = _tel.counter(
    "mxnet_kvstore_push_bytes_total", "Bytes pushed into the kvstore.")
_M_PULL_BYTES = _tel.counter(
    "mxnet_kvstore_pull_bytes_total", "Bytes pulled out of the kvstore.")
_M_PUSH_SECONDS = _tel.histogram(
    "mxnet_kvstore_push_seconds", "kvstore push call latency.")
_M_PULL_SECONDS = _tel.histogram(
    "mxnet_kvstore_pull_seconds", "kvstore pull call latency.")


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
        device (row-sparse values: a RowSparseNDArray)."""
        if not _is_list(values):
            return values if isinstance(values, _sparse.BaseSparseNDArray) \
                else values._data
        if isinstance(values[0], _sparse.RowSparseNDArray):
            return self._reduce_rowsparse(values)
        dev = values[0]._data.device
        return fusion.tree_sum(self._stage(values, dev))

    def _push_sum(self, key, value):
        """The sum a push of ``value`` to ``key`` stores: the replicas',
        each compressed first when compression is on.  A distributed store
        overrides it to sum across its workers too."""
        return self._reduce(self._compress_values(key, value))

    @staticmethod
    def _reduce_rowsparse(values):
        """Row-sparse values merged: the union of their rows, each row's
        values summed, on the first value's device."""
        dev = values[0].data._data.device
        uniq, merged = _sparse.merge_rows(
            torch.cat([v.indices._data.to(dev) for v in values]),
            torch.cat([v.data._data.to(dev) for v in values]))
        return _sparse.RowSparseNDArray(NDArray(merged), NDArray(uniq),
                                        values[0].shape, ctx=values[0].ctx,
                                        dtype=values[0].dtype)

    # -- API ------------------------------------------------------------------
    def init(self, key, value):
        if _is_list(key):
            for k, v in zip(key, value):
                self.init(k, v)
            return
        if key in self._store:
            raise MXNetError(f"key {key!r} already initialized")
        v = value[0] if _is_list(value) else value
        self._store[key] = v if isinstance(v, _sparse.BaseSparseNDArray) \
            else v.copy()

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
        with _tel.span("kvstore.push", "kvstore") as sp:
            if sp is not _tel.NULL_SPAN:
                sp.set(key=str(key), bytes=_tel.payload_bytes(value))
            stored = self._stored(key)
            merged = self._push_sum(key, value)
            if self._updater is not None:
                self._updater(key, merged, stored)
            elif isinstance(merged, _sparse.BaseSparseNDArray) or \
                    isinstance(stored, _sparse.BaseSparseNDArray):
                self._store[key] = merged
            else:
                _write(stored, merged)
        if sp is not _tel.NULL_SPAN:
            _M_PUSH_SECONDS.observe(sp.duration_s)
            _M_PUSH_BYTES.inc(sp.attrs.get("bytes", 0))

    def pull(self, key, out=None, priority=0,  # noqa: ARG002
             ignore_sparse=True):  # noqa: ARG002
        if _is_list(key) and _is_list(out) and len(key) > 1 \
                and len(key) == len(out):
            for k, o in zip(key, out):
                self.pull(k, o)
            return
        if _is_list(key):
            key = key[0]
        with _tel.span("kvstore.pull", "kvstore") as sp:
            stored = self._stored(key)
            if isinstance(stored, _sparse.BaseSparseNDArray):
                stored = stored.tostype("default")
            outs = out if _is_list(out) else [out]
            for o in outs:
                _write(o, stored._data)
            if sp is not _tel.NULL_SPAN:
                sp.set(key=str(key),
                       bytes=_tel.payload_bytes(stored) * len(outs))
        if sp is not _tel.NULL_SPAN:
            _M_PULL_SECONDS.observe(sp.duration_s)
            _M_PULL_BYTES.inc(sp.attrs.get("bytes", 0))

    def pushpull(self, key, value, out=None, priority=0):
        self.push(key, value, priority)
        if out is not None:
            self.pull(key, out, priority)

    def row_sparse_pull(self, key, out=None, priority=0,  # noqa: ARG002
                        row_ids=None):
        """Each RowSparseNDArray of ``out`` takes the stored rows of its
        ``row_ids`` (one NDArray for all, or one an output), on its own
        device."""
        if row_ids is None:
            raise MXNetError("row_sparse_pull requires row_ids")
        if _is_list(key):
            key = key[0]
        stored = self._stored(key)
        if not isinstance(stored, _sparse.RowSparseNDArray):
            stored = _sparse.cast_storage(stored, "row_sparse")
        outs = out if _is_list(out) else [out]
        rids = row_ids if _is_list(row_ids) else [row_ids] * len(outs)
        for o, r in zip(outs, rids):
            if not isinstance(o, _sparse.RowSparseNDArray):
                raise MXNetError("row_sparse_pull writes RowSparseNDArray "
                                 "outputs; pull() gives a dense one")
            ret = stored.retain(r)
            o.data = ret.data.as_in_context(o.ctx)
            o.indices = ret.indices.as_in_context(o.ctx)

    # -- many keys at once ----------------------------------------------------
    def set_bucket_size(self, mb):
        """The bucket bound in MB; 0 reduces key by key."""
        self._bucket_bytes = int(float(mb) * (1 << 20))
        self._bucketer = None

    def _fusable(self, keys, values):  # noqa: ARG002
        """Whether ``keys`` may reduce bucket by bucket: no compression and
        no sparse value."""
        return self._compression is None and not any(
            isinstance(x, _sparse.BaseSparseNDArray) for v in values
            for x in (v if _is_list(v) else [v]))

    def _bucket_sums(self, keys, values):
        """(bucket, its keys' sums over the replicas) for each bucket of
        ``keys``, staged and reduced as the bucket is reached."""
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
            yield b, self._bucketer.reduce_bucket(b, arrays)

    def _across(self, bucket, sums):  # noqa: ARG002
        """A bucket's sums over every worker: in one process, the sums
        themselves.  A distributed store overrides it."""
        return sums

    def pushpull_list(self, keys, values, outs, priority=0):
        """pushpull of every key: bucket by bucket, unless the store owns
        the update (it runs per key inside push), buckets are off,
        gradients are compressed or a value is sparse."""
        if self._updater is not None or self._bucket_bytes <= 0:
            return KVStoreBase.pushpull_list(self, keys, values, outs,
                                             priority=priority)
        if not self._fusable(keys, values):
            # compressed and sparse keys reduce one by one
            if _ttrace._ENABLED:
                fusion.record_fallback(len(keys))
            return KVStoreBase.pushpull_list(self, keys, values, outs,
                                             priority=priority)
        enabled = _ttrace._ENABLED
        with _tel.span("kvstore.fused_pushpull", "kvstore") as sp:
            total_bytes = n_buckets = 0
            t0 = _time.perf_counter_ns() if enabled else 0
            for b, sums in self._bucket_sums(keys, values):
                for p, t in zip(b.positions, self._across(b, sums)):
                    _write(self._store[keys[p]], t)
                    o = outs[p]
                    for out_nd in (o if _is_list(o) else [o]):
                        if out_nd is not None:
                            _write(out_nd, t)
                n_buckets += 1
                if enabled:
                    fusion.record_bucket(b, _time.perf_counter_ns() - t0)
                    total_bytes += b.nbytes * b.n_rep
                    t0 = _time.perf_counter_ns()
            if enabled:
                fusion.record_pushpull()
                sp.set(keys=len(keys), buckets=n_buckets,
                       bytes=total_bytes)

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

