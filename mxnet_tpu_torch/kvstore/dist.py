"""``dist_sync`` — the distributed kvstore over ``torch.distributed``, the
port of ``mxnet_tpu/kvstore/dist.py`` (``KVStoreDistTPUSync``).

One process a worker, no scheduler or server processes: the rendezvous
is a TCP store that rank 0 serves at ``MXNET_DIST_COORDINATOR`` (host:port)
for ``MXNET_DIST_NUM_WORKERS`` workers, this one ``MXNET_DIST_RANK``
(``tools/launch.py`` writes the three); without a coordinator the store
is a world of one and needs no launcher.  The process group is NCCL when
the current context is a card and one is present, gloo on the host.
Under NCCL each rank binds one card at bring-up (``set_device`` and the
group's ``device_id``): the card of an open ``with mx.gpu(i):`` scope,
else card ``rank`` modulo the host's cards, so ``launch_local``'s N ranks
on a host of N cards take one card each.  A value crosses on that card
(the host under gloo) and comes back on its own device.

The store is ``KVStoreLocal`` with its two hooks overridden: a push of a
dense key sums the pushed replicas locally, then across processes (one
``all_reduce`` for every size: NCCL and gloo run it as reduce-scatter
plus all-gather where that pays, and ``MXNET_KVSTORE_BIGARRAY_BOUND`` is
accepted for parity and selects nothing), then stores the sum or hands
it to the store's optimizer; ``pushpull_list`` reduces bucket by bucket
(``fusion.GradBucketer``), each bucket one flat collective;
``pushpull_flat`` returns those flat buckets (keys, shapes, sizes, flat
sum) without writing the keys, when there is more than one worker, else
None.  ``init`` of a dense key takes rank 0's value on every worker (a
broadcast).  With 2-bit compression each process quantizes its local
sum, the packed codes cross with one ``all_gather`` and every process
sums the dequantized contributions.  Row-sparse keys live in a host
``SparsePS``: a push merges the replicas' rows into one gradient and one
server update.

Every collective is bounded by a ``resilience.Deadline``
(``MXNET_KVSTORE_TIMEOUT_S``), and so is the rendezvous: a missing peer
raises ``KVStoreTimeoutError``.  The Deadline runs the collective on its
own thread, with the rank's card made current there.  Transient
failures retry (``Retry``) before the collective is entered, and around
the whole attempt in a world of one; a ``kvstore.allreduce`` chaos site
sits at the gate, and ``dist.barrier`` at the barrier.  With
``MXNET_ELASTIC_HEARTBEAT_DIR`` set the heartbeat starts at bring-up
(phase ``bringup``, then ``running``); a bring-up timeout marks it
failed.  Telemetry: the ``kvstore.push`` and ``kvstore.allreduce``
spans, and ``mxnet_kvstore_{push,allreduce}_{bytes_total,seconds}``.
"""

from __future__ import annotations

import datetime

import torch
import torch.distributed as dist

from .. import config
from .. import telemetry as _tel
from ..base import MXNetError
from ..context import current_context, scoped_context
from ..ndarray import sparse as _sparse
from ..ndarray.ndarray import NDArray
from ..resilience import Deadline, KVStoreTimeoutError, Retry
from ..resilience import chaos as _chaos
from ..resilience import heartbeat as _hb
from .local import KVStoreLocal, _is_list, _write

__all__ = ["KVStoreDistTPUSync"]

# registry get-or-create: the same handles local.py registered
_M_PUSH_BYTES = _tel.counter("mxnet_kvstore_push_bytes_total")
_M_PUSH_SECONDS = _tel.histogram("mxnet_kvstore_push_seconds")
_M_ALLREDUCE_BYTES = _tel.counter(
    "mxnet_kvstore_allreduce_bytes_total",
    "Bytes entering the cross-process allreduce collective.")
_M_ALLREDUCE_SECONDS = _tel.histogram(
    "mxnet_kvstore_allreduce_seconds",
    "Cross-process allreduce latency (dispatch + transfer).")

# backend -> process group, one a process (a group is formed once)
_GROUPS = {}


def _is_timeout(exc):
    msg = str(exc).lower()
    return "timed out" in msg or "timeout" in msg or "deadline" in msg


def _rank_card(rank):
    """The card a rank's collectives run on: that of an open ``with
    mx.gpu(i):`` scope, else card ``rank`` modulo the host's cards."""
    ctx = scoped_context()
    if ctx is not None and ctx.device_type == "gpu":
        return torch.device("cuda", ctx.device_id)
    return torch.device("cuda", rank % torch.cuda.device_count())


def _process_group(backend, coord, rank, nproc, timeout_s):
    """(group, wire device) of ``backend``: the default group, formed here
    (a TCP store at ``coord``, or a world of one), or a group of the
    existing world when the default group has another backend.  Under
    NCCL the wire is the rank's card, bound to the group."""
    hit = _GROUPS.get(backend)
    if hit is not None:
        return hit
    timeout = datetime.timedelta(
        seconds=timeout_s if timeout_s and timeout_s > 0 else 1800)
    if dist.is_initialized():
        rank = dist.get_rank()
    wire, bind = torch.device("cpu"), {}
    if backend == "nccl":
        wire = _rank_card(rank)
        torch.cuda.set_device(wire)
        bind["device_id"] = wire
    if not dist.is_initialized():
        if coord:
            host, port = coord.rsplit(":", 1)
            try:
                store = dist.TCPStore(host, int(port), nproc, rank == 0,
                                      timeout=timeout)
                dist.init_process_group(backend, store=store, rank=rank,
                                        world_size=nproc, timeout=timeout,
                                        **bind)
            except RuntimeError as e:
                if not _is_timeout(e):
                    raise
                _tel.flightrec.dump("deadline.dist.bringup", exc=e)
                _hb.mark_failed(f"bringup-timeout: rank {rank}/{nproc} at "
                                f"{coord} after {timeout_s:g}s")
                raise KVStoreTimeoutError(
                    f"distributed bring-up: rank {rank} could not "
                    f"rendezvous with all {nproc} workers at {coord} "
                    f"within {timeout_s:g}s (MXNET_KVSTORE_TIMEOUT_S) — a "
                    "peer never arrived") from e
        else:
            dist.init_process_group(backend, store=dist.HashStore(),
                                    rank=0, world_size=1, timeout=timeout,
                                    **bind)
        group = dist.group.WORLD
    elif dist.get_backend() == backend:
        group = dist.group.WORLD
    else:
        group = dist.new_group(backend=backend, timeout=timeout)
    if coord and dist.get_world_size(group) != nproc:
        raise MXNetError(
            f"distributed bring-up: MXNET_DIST_NUM_WORKERS={nproc} but the "
            f"process group has {dist.get_world_size(group)} workers")
    _GROUPS[backend] = group, wire
    return group, wire


class KVStoreDistTPUSync(KVStoreLocal):
    def __init__(self, name="dist_tpu_sync"):
        super().__init__(name=name)
        self._group = None
        self._wire = None       # the device values cross on
        self._sparse_ps = None  # host tables, made at the first sparse key
        self._retry = Retry(site="kvstore.allreduce")
        self._deadline = Deadline(site="kvstore.allreduce")

    # -- bring-up --------------------------------------------------------------
    def connect(self):
        if self._group is not None:
            return
        hb_on = _hb.enabled()
        if hb_on:
            _hb.start()
            _hb.set_phase("bringup")
        coord = config.get("MXNET_DIST_COORDINATOR")
        nproc = config.get_int("MXNET_DIST_NUM_WORKERS", 1) if coord else 1
        rank = config.get_int("MXNET_DIST_RANK", 0) if coord else 0
        backend = "nccl" if torch.cuda.is_available() and \
            current_context().device_type == "gpu" else "gloo"
        self._group, self._wire = _process_group(
            backend, coord, rank, nproc, self._deadline.timeout_s)
        if hb_on:
            _hb.set_phase("running")
        # rank-tag this process's telemetry snapshots and dumps
        _tel.aggregate.set_rank(dist.get_rank(self._group))

    @property
    def rank(self):
        self.connect()
        return dist.get_rank(self._group)

    @property
    def num_workers(self):
        self.connect()
        return dist.get_world_size(self._group)

    @property
    def backend(self):
        """The process group's backend: ``"nccl"`` or ``"gloo"``."""
        self.connect()
        return dist.get_backend(self._group)

    def _on_wire(self, fn, *args, **kwargs):
        """``fn(*args, **kwargs)`` under the Deadline, on its thread, with
        the rank's card current there (a new thread's is card 0)."""
        def run():
            if self._wire.type != "cuda":
                return fn(*args, **kwargs)
            with torch.cuda.device(self._wire):
                return fn(*args, **kwargs)
        return self._deadline.call(run)

    # -- the cross-process reduction -------------------------------------------
    @staticmethod
    def _chaos_gate():
        if _chaos._ACTIVE:
            _chaos.hit("kvstore.allreduce")

    def _allreduce(self, t):
        """The sum of ``t`` over every process, on ``t``'s device.  Once
        there are peers a timeout or a failure after the gate is not
        retried: re-entering a collective the peers ran (or never joined)
        would put the processes' collectives out of order."""
        if self.num_workers <= 1:
            return self._retry.call(self._allreduce_attempt, t)
        self._retry.call(self._chaos_gate)
        return self._allreduce_collective(t)

    def _allreduce_attempt(self, t):
        self._chaos_gate()
        return self._allreduce_collective(t)

    def _allreduce_collective(self, t):
        nbytes = t.numel() * t.element_size()
        with _tel.span("kvstore.allreduce", "kvstore") as sp:
            if sp is not _tel.NULL_SPAN:
                sp.set(bytes=nbytes)
            res = self._on_wire(self._sum_across, t)
        if sp is not _tel.NULL_SPAN:
            _M_ALLREDUCE_SECONDS.observe(sp.duration_s)
            _M_ALLREDUCE_BYTES.inc(nbytes)
        return res

    def _sum_across(self, t):
        x = t.to(self._wire, copy=True)
        dist.all_reduce(x, group=self._group)
        return x.to(t.device)

    def _gather_packed(self, packed):
        """Every process's packed codes, (processes, nbytes)."""
        x = packed.to(self._wire)
        parts = [torch.empty_like(x) for _ in range(self.num_workers)]
        self._on_wire(dist.all_gather, parts, x, group=self._group)
        return torch.stack(parts).to(packed.device)

    # -- the hooks of KVStoreLocal ---------------------------------------------
    def _push_sum(self, key, value):
        """The replicas' sum, then its sum over every process; with
        compression each process's sum is quantized once."""
        merged = self._reduce(value)
        if isinstance(merged, _sparse.BaseSparseNDArray):
            return merged
        if self._compression is not None:
            if self.num_workers > 1:
                # 2-bit over the wire: the packed codes cross (16x fewer
                # bytes than f32), each process sums every contribution
                packed, shape, dtype = self._compression.compress(
                    key, "dist", merged)
                return self._compression.decompress_sum(
                    self._gather_packed(packed), shape, dtype)
            ctx = (value[0] if _is_list(value) else value)._ctx
            merged = self._compress_values(key, NDArray(merged, ctx))._data
        return self._allreduce(merged)

    def _across(self, bucket, sums):
        """The bucket crosses processes as one flat collective."""
        flat = self._allreduce(torch.cat([t.reshape(-1) for t in sums]))
        return [t.reshape(shape) for t, shape in
                zip(flat.split(bucket.sizes), bucket.shapes)]

    def _fusable(self, keys, values):
        return super()._fusable(keys, values) and not any(
            self._is_sparse_key(k) for k in keys)

    # -- sparse keys: the host tables ------------------------------------------
    def _ps(self):
        if self._sparse_ps is None:
            from .sparse_ps import SparsePS
            self._sparse_ps = SparsePS()
        return self._sparse_ps

    def _is_sparse_key(self, key):
        return self._sparse_ps is not None and not _is_list(key) \
            and key in self._sparse_ps._tables

    def init(self, key, value):
        if _is_list(key):
            for k, v in zip(key, value):
                self.init(k, v)
            return
        v = value[0] if _is_list(value) else value
        if isinstance(v, _sparse.BaseSparseNDArray):
            self._ps().init(key, v)
            return
        super().init(key, value)
        if self.num_workers > 1:
            # every worker starts from rank 0's value, as MXNet's servers
            # take the value rank 0 initializes
            stored = self._store[key]
            x = stored._data.to(self._wire, copy=True)
            self._on_wire(dist.broadcast, x, 0, group=self._group)
            _write(stored, x)

    def set_optimizer(self, optimizer):
        super().set_optimizer(optimizer)
        self._ps().set_optimizer(optimizer)

    def push(self, key, value, priority=0):
        k = key[0] if _is_list(key) and len(key) == 1 else key
        if self._is_sparse_key(k):
            # the replicas' gradients as one, then one server update (an
            # update a replica would advance a stateful optimizer n times)
            self._ps().push(k, self._reduce(value))
            return
        super().push(key, value, priority)

    def pull(self, key, out=None, priority=0, ignore_sparse=True):
        if _is_list(key) and len(key) == 1:
            key = key[0]
        if self._is_sparse_key(key):
            dense = self._ps().pull_dense(key)
            for o in out if _is_list(out) else [out]:
                if isinstance(o, _sparse.BaseSparseNDArray):
                    if ignore_sparse:
                        continue
                    raise MXNetError(
                        "pull of a sparse-PS key into a sparse out is not "
                        "supported; use row_sparse_pull(key, row_ids=...)")
                _write(o, dense._data)
            return
        super().pull(key, out=out, priority=priority,
                     ignore_sparse=ignore_sparse)

    def row_sparse_pull(self, key, out=None, priority=0, row_ids=None):
        if _is_list(key) and len(key) == 1:
            key = key[0]
        if not self._is_sparse_key(key):
            return super().row_sparse_pull(key, out=out, priority=priority,
                                           row_ids=row_ids)
        if row_ids is None:
            raise MXNetError("row_sparse_pull requires row_ids")
        if out is None:
            return self._ps().row_sparse_pull(
                key, row_ids[0] if _is_list(row_ids) else row_ids)
        outs = out if _is_list(out) else [out]
        rids = row_ids if _is_list(row_ids) else [row_ids] * len(outs)
        ret = None
        for o, r in zip(outs, rids):
            ret = self._ps().row_sparse_pull(key, r)
            o.data = ret.data.as_in_context(o.ctx)
            o.indices = ret.indices.as_in_context(o.ctx)
        return ret

    # -- many keys: one collective a bucket ------------------------------------
    def pushpull_flat(self, keys, values, outs, priority=0):  # noqa: ARG002
        """The reduced buckets, flat, for a fused optimizer to read:
        ``[(keys, shapes, sizes, flat sum), ...]``; neither the store nor
        ``outs`` is written for them.  None (take ``pushpull_list``) in a
        world of one, where no flat buffer has to exist, or where keys
        take the per-key path."""
        if self.num_workers <= 1 or self._updater is not None \
                or self._bucket_bytes <= 0 or not self._fusable(keys, values):
            return None
        return [([keys[p] for p in b.positions], b.shapes, b.sizes,
                 self._allreduce(torch.cat([t.reshape(-1) for t in sums])))
                for b, sums in self._bucket_sums(keys, values)]

    # -- barrier ---------------------------------------------------------------
    def _barrier(self):
        self.connect()
        if _chaos._ACTIVE:
            _chaos.hit("dist.barrier")
        n = self.num_workers
        if n > 1:
            # a tiny sum over every process, deadline-bounded: a dead peer
            # raises instead of hanging
            try:
                self._allreduce(torch.zeros(1))
            except KVStoreTimeoutError as e:
                rank = self.rank
                missing = sorted(set(range(n)) - {rank})
                raise KVStoreTimeoutError(
                    f"dist.barrier: rank {rank} reached the barrier but at "
                    f"least one of ranks {missing} (world size {n}) never "
                    f"arrived within {self._deadline.timeout_s:g}s "
                    "(MXNET_KVSTORE_TIMEOUT_S)") from e
        super()._barrier()
