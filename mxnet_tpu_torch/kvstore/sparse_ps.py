"""SparsePS, a host-resident store of row-sparse tables with the optimizer
on the store's side — the port of ``mxnet_tpu/kvstore/sparse_ps.py``
(MXNet's ``kvstore_dist_server.h`` storing the table, merging sparse
gradients and running the optimizer, ``kvstore_dist.h::PullRowSparse``,
and the lazy row_sparse updates of ``optimizer_op.cc``: only touched rows
advance).

A table too large for the card stays in host memory, a CPU tensor in the
table's dtype.  A training step pulls the rows its batch touches
(``row_sparse_pull``, onto the current context: the card) and pushes its
row-sparse gradient back; duplicate rows are summed, then the same Python
optimizer the card runs updates those rows on the host.  Its state is a
host tensor a leaf over the whole table, gathered and scattered a push;
a row's state starts at its first touch from
``create_state_multi_precision`` on the row's current values (a
multi-precision master starts at the row, a momentum at zero).

``set_optimizer`` resets every row's state.  A push snapshots (generation,
optimizer, updater) under the store's lock, updates under its table's
lock only (pushes to different tables run concurrently), and starts over
if the generation moved in between, so no push of an old optimizer
writes state after a reset.  Both locks go through the lock-order checker
(``analysis.runtime.tracked``, ``MXNET_LOCKCHECK``).

The port reaches it directly (``SparsePS()``); routing the ``dist_*``
kvstores' row_sparse keys to it waits for ``kvstore/dist.py`` (A.9).
"""

from __future__ import annotations

import threading

import torch

from ..analysis.runtime import tracked as _tracked
from ..base import MXNetError

__all__ = ["SparsePS"]


class _Table:
    __slots__ = ("value", "lock", "state_leaves", "state_inited")

    def __init__(self, value):
        self.value = value          # CPU tensor (rows, *cols)
        self.lock = _tracked(threading.Lock(), "SparsePS._Table.lock")
        # the optimizer state over the whole table, a tensor a leaf, and
        # which rows have theirs (SparsePS._state_tree keeps the structure)
        self.state_leaves = None
        self.state_inited = None


def _host(nd_or_tensor):
    t = nd_or_tensor._data if hasattr(nd_or_tensor, "_data") \
        else nd_or_tensor
    return t.detach().to("cpu")


def _current(t):
    """The host tensor ``t`` as an NDArray on the current context."""
    from ..context import current_context
    from ..ndarray.ndarray import _device, _placed
    ctx = current_context()
    return _placed(t.to(_device(ctx)), ctx)


class SparsePS:
    """The host store: ``init``, ``push``, ``row_sparse_pull``,
    ``pull_dense`` and the store-side optimizer."""

    def __init__(self):
        self._tables = {}
        self._optimizer = None
        self._updaters = {}
        self._state_tree = {}
        # guards the optimizer, updater and state maps; always taken
        # before a table's lock
        self._lock = _tracked(threading.Lock(), "SparsePS._lock")
        self._gen = 0

    # -- registration -------------------------------------------------------
    def init(self, key, value):
        if key in self._tables:
            raise MXNetError(f"sparse key {key!r} already initialized")
        from ..ndarray import sparse as sp
        if isinstance(value, sp.BaseSparseNDArray):
            value = value.tostype("default")
        self._tables[key] = _Table(_host(value).clone())

    def keys(self):
        return sorted(self._tables)

    def shape(self, key):
        return tuple(self._tables[key].value.shape)

    def set_optimizer(self, optimizer):
        """The store-side optimizer; a change resets every row's state."""
        with self._lock:
            self._gen += 1
            self._optimizer = optimizer
            self._updaters = {}
            self._state_tree = {}
            for tbl in self._tables.values():
                with tbl.lock:
                    tbl.state_leaves = None
                    tbl.state_inited = None
            # every push of the old generation has finished (each held its
            # table's lock); drop what one wrote between the two clears
            self._state_tree = {}

    # -- traffic ------------------------------------------------------------
    def push(self, key, grad):
        """Apply a row-sparse (or dense) gradient to the touched rows."""
        from .. import optimizer as opt
        from ..ndarray import sparse as sp
        tbl = self._tables.get(key)
        if tbl is None:
            raise MXNetError(f"sparse key {key!r} not initialized")
        if isinstance(grad, sp.RowSparseNDArray):
            rows = _host(grad.indices).to(torch.int64)
            vals = _host(grad.data)
        else:
            rows = torch.arange(tbl.value.shape[0])
            vals = _host(grad)
        if rows.numel() == 0:
            return
        # duplicate rows summed first (the reference's merge buffer)
        uniq, merged = sp.merge_rows(rows, vals)
        while True:
            with self._lock:
                gen = self._gen
                optimizer = self._optimizer
                upd = self._updaters.get(key)
                if optimizer is not None and upd is None:
                    upd = opt.get_updater(optimizer)
                    self._updaters[key] = upd
            with tbl.lock:
                if gen != self._gen:
                    continue    # the optimizer changed between the locks
                if optimizer is None:
                    tbl.value.index_add_(0, uniq, merged.to(tbl.value.dtype))
                    return
                self._update(tbl, key, uniq, merged, optimizer, upd)
                return

    def _update(self, tbl, key, rows, grad, optimizer, upd):
        from ..context import cpu
        from ..ndarray.ndarray import NDArray
        w = NDArray(tbl.value[rows], cpu())
        g = NDArray(grad.to(tbl.value.dtype), cpu())
        self._ensure_states(tbl, key, rows, optimizer)
        upd.states[key] = self._gather_states(tbl, key, rows)
        upd(key, g, w)
        self._scatter_states(tbl, rows, upd.states[key])
        tbl.value[rows] = w._data

    # -- the per-row optimizer state ----------------------------------------
    def _ensure_states(self, tbl, key, rows, optimizer):
        """Allocate the state leaves once; start the state of rows touched
        for the first time from their current values.  ``optimizer`` is
        the push's generation's (a concurrent swap must not be seen)."""
        if key not in self._state_tree:
            proto = optimizer.create_state_multi_precision(
                key, tbl.value[rows[:1]])
            # graftcheck: ignore[GC04] — caller (push) holds tbl.lock and
            # the generation check; set_optimizer re-clears this map after
            # synchronizing on every table lock, so a stale write here
            # cannot survive an optimizer swap
            self._state_tree[key] = _tree_of(proto)
            n = tbl.value.shape[0]
            tbl.state_leaves = [torch.zeros((n,) + tuple(lf.shape[1:]),
                                            dtype=lf.dtype)
                                for lf in _leaves_of(proto)]
            tbl.state_inited = torch.zeros(n, dtype=torch.bool)
        fresh = rows[~tbl.state_inited[rows]]
        if fresh.numel():
            init = optimizer.create_state_multi_precision(
                key, tbl.value[fresh])
            for dst, lf in zip(tbl.state_leaves, _leaves_of(init)):
                dst[fresh] = lf.to("cpu")
            tbl.state_inited[fresh] = True

    def _gather_states(self, tbl, key, rows):
        return _tree_build(self._state_tree[key],
                           iter([leaf[rows] for leaf in tbl.state_leaves]))

    @staticmethod
    def _scatter_states(tbl, rows, states):
        for leaf, new in zip(tbl.state_leaves, _leaves_of(states)):
            leaf[rows] = new

    def row_sparse_pull(self, key, row_ids):
        """The requested rows (sorted, each once) as a RowSparseNDArray on
        the current context (the card unless ``with mx.cpu():``)."""
        from ..ndarray import sparse as sp
        tbl = self._tables.get(key)
        if tbl is None:
            raise MXNetError(f"sparse key {key!r} not initialized")
        rows = torch.unique(_host(row_ids).to(torch.int64))
        with tbl.lock:
            block = tbl.value[rows]
        return sp.RowSparseNDArray(_current(block), _current(rows),
                                   tuple(tbl.value.shape))

    def pull_dense(self, key):
        """The whole table on the current context."""
        tbl = self._tables[key]
        with tbl.lock:
            return _current(tbl.value.clone())


# -- state-tree helpers ------------------------------------------------------
# a state is None, a tensor, or a (nested) tuple or list of those; leaves
# are enumerated left to right so the host leaves and a tree stay aligned

def _leaves_of(state):
    if state is None:
        return []
    if isinstance(state, (list, tuple)):
        out = []
        for s in state:
            out.extend(_leaves_of(s))
        return out
    return [state]


def _tree_of(state):
    """The structure: None, "leaf", or (type, [structures])."""
    if state is None:
        return None
    if isinstance(state, (list, tuple)):
        return (type(state), [_tree_of(s) for s in state])
    return "leaf"


def _tree_build(tmpl, leaf_iter):
    if tmpl is None:
        return None
    if tmpl == "leaf":
        return next(leaf_iter)
    t, subs = tmpl
    return t(_tree_build(s, leaf_iter) for s in subs)
