"""Gradient buckets — the port of ``mxnet_tpu/kvstore/fusion.py``
(``tree_sum``, ``GradBucketer`` and the fused path's counters).

``tree_sum`` adds a list of arrays as a pairwise tree: O(log n) depth and
a fixed association of IEEE adds, so every reduction of the local store
(per key, or a whole bucket of keys at once) gives the same bits, and the
same bits as the reference's ``tree_sum``, at any number of replicas.  A
sum over a stacked axis would not: its order is the library's to choose.

``GradBucketer.plan`` groups same ``(dtype, replicas)`` dense gradients, in
key order, into buckets of at most ``bucket_bytes``; ``reduce_bucket`` sums
each key of a bucket over its replicas with one ``torch._foreach_add`` per
level of the tree for the whole bucket (the reference runs one jitted
program per bucket).  A one-replica bucket is its own sum.

The reference's counters of the fused path count here too, with telemetry
on (:func:`record_pushpull`, :func:`record_bucket`,
:func:`record_fallback`, called by ``KVStoreLocal.pushpull_list``).
``mxnet_kvstore_fused_bucket_errors_total`` is registered and stays 0: a
bucket's reduction is the same torch ops as the per-key path, so there is
no separately compiled program whose failure is replayed key by key.
"""

from __future__ import annotations

import operator

import torch

from .. import config
from .. import telemetry as _tel
from ..analysis import runtime as _art
from ..telemetry import costmodel as _costmodel

_M_FUSED_PUSHPULLS = _tel.counter(
    "mxnet_kvstore_fused_pushpulls_total",
    "Fused pushpull_list calls taking the bucketed path.")
_M_FUSED_BUCKETS = _tel.counter(
    "mxnet_kvstore_fused_buckets_total",
    "Gradient buckets dispatched (one fused reduce each).")
_M_FUSED_BYTES = _tel.counter(
    "mxnet_kvstore_fused_bytes_total",
    "Bytes entering fused bucket reductions (all replicas).")
_M_FUSED_KEYS = _tel.counter(
    "mxnet_kvstore_fused_keys_total",
    "Keys reduced through the fused bucket path.")
_M_FALLBACK_KEYS = _tel.counter(
    "mxnet_kvstore_fused_fallback_keys_total",
    "pushpull_list keys that fell back to the per-key path "
    "(sparse / compressed / update-on-kvstore / uninitialized).")
_M_BUCKET_SECONDS = _tel.histogram(
    "mxnet_kvstore_fused_bucket_seconds",
    "Host-side latency per fused bucket (flatten+reduce+scatter dispatch).")
_M_BUCKET_ERRORS = _tel.counter(
    "mxnet_kvstore_fused_bucket_errors_total",
    "Fused buckets whose executable FAILED and were replayed through the "
    "per-key path (graceful degradation — distinct from the "
    "planned fallback rules above, which never enter a bucket).")


def record_bucket(bucket, dt_ns):
    _M_FUSED_BUCKETS.inc()
    _M_FUSED_KEYS.inc(len(bucket.positions))
    _M_FUSED_BYTES.inc(bucket.nbytes * bucket.n_rep)
    _M_BUCKET_SECONDS.observe(dt_ns / 1e9)


def record_pushpull():
    _M_FUSED_PUSHPULLS.inc()


def record_fallback(n_keys):
    if n_keys:
        _M_FALLBACK_KEYS.inc(n_keys)

__all__ = ["GradBucketer", "bucket_bytes_from_env", "tree_sum",
           "DEFAULT_BUCKET_MB"]

DEFAULT_BUCKET_MB = 25.0


def tree_sum(arrays, add=operator.add):
    """Pairwise-tree sum of ``arrays`` with ``add`` (``+`` by default;
    ``torch._foreach_add`` sums lists of tensors element by element)."""
    arrs = list(arrays)
    while len(arrs) > 1:
        nxt = [add(arrs[i], arrs[i + 1]) for i in range(0, len(arrs) - 1, 2)]
        if len(arrs) % 2:
            nxt.append(arrs[-1])
        arrs = nxt
    return arrs[0]


def bucket_bytes_from_env():
    """MXNET_KVSTORE_BUCKET_MB in bytes; <= 0 turns buckets off."""
    return int(config.get_float("MXNET_KVSTORE_BUCKET_MB", DEFAULT_BUCKET_MB)
               * (1 << 20))


class _Bucket:
    """One group: positions into the caller's key list, and its layout."""

    __slots__ = ("positions", "shapes", "sizes", "dtype", "n_rep", "nbytes")

    def __init__(self, dtype, n_rep):
        self.positions = []
        self.shapes = []
        self.sizes = []
        self.dtype = dtype
        self.n_rep = n_rep
        self.nbytes = 0

    def __repr__(self):
        return (f"<_Bucket keys={len(self.positions)} dtype={self.dtype} "
                f"n_rep={self.n_rep} bytes={self.nbytes}>")


class GradBucketer:
    """Plans size-bounded same-dtype buckets (cached per signature) and
    reduces them."""

    def __init__(self, bucket_bytes=None):
        if bucket_bytes is None:
            bucket_bytes = bucket_bytes_from_env()
        self.bucket_bytes = int(bucket_bytes)
        self._plan_cache = {}

    def plan(self, signature):
        """``signature``: one ``(shape, dtype, n_rep)`` per key -> the
        cached list of buckets (positions index into the signature)."""
        buckets = self._plan_cache.get(signature)
        if buckets is None:
            buckets = self._plan_cache[signature] = self._build(signature)
            _art.note_build("kvstore.fusion")
        return buckets

    def _build(self, signature):
        buckets, open_by_group = [], {}
        for pos, (shape, dtype, n_rep) in enumerate(signature):
            size = 1
            for d in shape:
                size *= int(d)
            nbytes = size * dtype.itemsize
            group = (dtype, n_rep)
            cur = open_by_group.get(group)
            if cur is not None and cur.nbytes + nbytes > self.bucket_bytes:
                cur = None          # close it; a new bucket takes this key
            if cur is None:
                cur = open_by_group[group] = _Bucket(dtype, n_rep)
                buckets.append(cur)
            cur.positions.append(pos)
            cur.shapes.append(tuple(shape))
            cur.sizes.append(size)
            cur.nbytes += nbytes
        return buckets

    @staticmethod
    def reduce_bucket(bucket, arrays):
        """``arrays``: replica-major (replica r's tensors for every key of
        the bucket, then replica r+1's), all on one device -> the list of
        per-key replica sums.  Armed, the cost ledger's
        ``kvstore.fusion.reduce`` site (the reference's), keyed by the
        bucket's layout."""
        if not _costmodel._ARMED:
            return _reduce(bucket, arrays)
        return _REDUCE_SITE.call(
            _reduce, (bucket, arrays),
            key=(bucket.dtype, bucket.n_rep, tuple(bucket.shapes)))


_REDUCE_SITE = _costmodel.Site("kvstore.fusion.reduce")


def _reduce(bucket, arrays):
    n = len(bucket.positions)
    if bucket.n_rep == 1:
        return list(arrays)
    return tree_sum([list(arrays[r * n:(r + 1) * n])
                     for r in range(bucket.n_rep)],
                    add=torch._foreach_add)
