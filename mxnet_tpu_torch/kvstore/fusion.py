"""Gradient buckets — the port of ``mxnet_tpu/kvstore/fusion.py``
(``tree_sum``, ``GradBucketer``), without its telemetry.

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
"""

from __future__ import annotations

import operator

import torch

from .. import config

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
        per-key replica sums."""
        n = len(bucket.positions)
        if bucket.n_rep == 1:
            return list(arrays)
        return tree_sum([list(arrays[r * n:(r + 1) * n])
                         for r in range(bucket.n_rep)],
                        add=torch._foreach_add)
