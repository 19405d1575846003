"""The port's distributed kvstore (``kvstore/dist.py``) against the closed
forms of the reference's worker (``tests/_dist_worker.py``).

``test_two_process_dist_sync`` starts two processes of this file through
``tools/launch.py::launch_local`` (the reference's launcher, which writes
``MXNET_DIST_COORDINATOR``/``RANK``/``NUM_WORKERS``); each runs ``worker``
below on the host, so the group is gloo.  Every expected value is a closed
form in N, exact in float32 (sums of small integers and of +-0.5).  The
other tests run in this process and hold the port's pieces to the
reference's: the names ``create`` takes and refuses, the 2-bit
``decompress_sum`` (exact), the row-sparse merge; and, with stand-ins for
the card queries and the process group, the card an NCCL rank binds.
``worker_card`` is the same worker over NCCL, for a host of several
cards (``launch_local(4, [python, this file, "worker_card"])``).
"""

import os
import subprocess
import sys
import time

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT_S = 2           # the missing-peer test's MXNET_KVSTORE_TIMEOUT_S


def worker():
    """One rank of the N-process job, on the host (a gloo group)."""
    import mxnet_tpu_torch as mx
    with mx.cpu():
        return _worker_body(mx, "gloo")


def worker_card():
    """One rank of the N-process job over NCCL, its values on card 0 (the
    default context): each rank binds card rank modulo the host's cards,
    so ranks of a host with as many cards never share one.  Run on a
    host of several cards:
    ``launch_local(4, [python, this file, "worker_card"])``."""
    import torch
    import mxnet_tpu_torch as mx
    kv = mx.kv.create("dist_sync")
    card = torch.device("cuda", kv.rank % torch.cuda.device_count())
    assert kv._wire == card, (kv._wire, card)
    return _worker_body(mx, "nccl")


def _worker_body(mx, backend):
    """The reference worker's checks, plus an array over the big-array
    bound, a gluon.Trainer over the store and row-sparse keys."""
    from mxnet_tpu_torch import nd
    from mxnet_tpu_torch.ndarray import sparse

    kv = mx.kv.create("dist_sync")
    N, rank = kv.num_workers, kv.rank
    assert N == int(os.environ["MXNET_DIST_NUM_WORKERS"]), N
    assert rank == int(os.environ["MXNET_DIST_RANK"])
    assert kv.backend == backend, kv.backend
    shape = (3, 4)
    tri = N * (N + 1) // 2               # sum_r (r + 1)

    # init: rank 0's value on every worker
    kv.init(2, nd.ones(shape) * (rank + 7))
    first = nd.zeros(shape)
    kv.pull(2, first)
    np.testing.assert_array_equal(first.asnumpy(), 7.0)

    # 1-3: dense sums, a second round, rank-dependent values
    kv.init(3, nd.zeros(shape))
    kv.push(3, nd.array(np.full(shape, rank + 1.0, np.float32)))
    out = nd.zeros(shape)
    kv.pull(3, out)
    np.testing.assert_array_equal(out.asnumpy(), float(tri))
    kv.push(3, nd.array(np.full(shape, (rank + 1) * 10.0, np.float32)))
    kv.pull(3, out)
    np.testing.assert_array_equal(out.asnumpy(), 10.0 * tri)
    base = np.add.outer(np.arange(3), np.arange(4)).astype(np.float32)
    kv.push(3, [nd.array(base + rank), nd.array(base)])     # two replicas
    kv.pull(3, out)
    np.testing.assert_array_equal(out.asnumpy(),
                                  2 * N * base + N * (N - 1) / 2.0)

    # 4: barrier and the list API
    kv.barrier()
    kv.init([5, 7], [nd.zeros((2,)), nd.zeros((2,))])
    kv.push([5, 7], [nd.ones((2,)) * (rank + 1), nd.ones((2,)) * (rank + 5)])
    outs = [nd.zeros((2,)), nd.zeros((2,))]
    kv.pull([5, 7], outs)
    np.testing.assert_array_equal(outs[0].asnumpy(), float(tri))
    np.testing.assert_array_equal(outs[1].asnumpy(), float(tri + 4 * N))

    # 5: pushpull_list, one collective a bucket, twice; pushpull_flat
    kv.init([20, 21, 22], [nd.zeros((3,)), nd.zeros((2, 2)), nd.zeros((5,))])
    for rnd in range(2):
        vals = [nd.ones((3,)) * (rank + 1 + rnd),
                nd.ones((2, 2)) * (rank + 2 + rnd),
                nd.ones((5,)) * (rank + 3 + rnd)]
        outs = [nd.zeros((3,)), nd.zeros((2, 2)), nd.zeros((5,))]
        kv.pushpull_list([20, 21, 22], vals, outs)
        for j, o in enumerate(outs):
            np.testing.assert_array_equal(o.asnumpy(),
                                          float(tri + N * (j + rnd)))
    flat = kv.pushpull_flat([20, 21, 22], vals, outs)
    (keys, shapes, sizes, total), = flat
    assert keys == [20, 21, 22] and shapes == [(3,), (2, 2), (5,)] \
        and sizes == [3, 4, 5]
    np.testing.assert_array_equal(total.cpu().numpy(), np.repeat(
        [tri + N, tri + 2 * N, tri + 3 * N], sizes).astype(np.float32))

    # an array over MXNET_KVSTORE_BIGARRAY_BOUND (16): the bound is kept
    # for parity and selects nothing, one all_reduce sums every size
    assert int(os.environ["MXNET_KVSTORE_BIGARRAY_BOUND"]) < 37
    kv.init(30, nd.zeros((37,)))
    ramp = np.arange(37, dtype=np.float32)
    kv.push(30, nd.array(ramp * (rank + 1)))
    big = nd.zeros((37,))
    kv.pull(30, big)
    np.testing.assert_array_equal(big.asnumpy(), ramp * tri)

    # 6: 2-bit compression over the wire, the reference's pattern at t=0.5
    kv2 = mx.kv.create("dist_sync")
    kv2.set_gradient_compression({"type": "2bit", "threshold": 0.5})
    kv2.init(11, nd.zeros((2, 3)))
    if rank == 0:
        first, second = 0.7, 0.4
    elif rank == 1:
        first, second = -0.6, -0.3
    else:
        first = second = 0.1 if rank % 2 == 0 else -0.1
    kv2.push(11, nd.array(np.full((2, 3), first, np.float32)))
    out2 = nd.zeros((2, 3))
    kv2.pull(11, out2)
    np.testing.assert_array_equal(out2.asnumpy(), 0.0)
    kv2.push(11, nd.array(np.full((2, 3), second, np.float32)))
    kv2.pull(11, out2)
    np.testing.assert_array_equal(out2.asnumpy(), 0.5)

    # a gluon.Trainer over the store: every worker starts from rank 0's
    # weights (0 here, rank elsewhere); the gradient of sum(w . x) is x =
    # rank + 1, summed over the workers; SGD at rate 1
    net = mx.gluon.nn.Dense(1, in_units=2, use_bias=False)
    net.initialize(mx.init.Constant(float(rank)))
    tr = mx.gluon.Trainer(net.collect_params(), "sgd",
                          {"learning_rate": 1.0}, kvstore="dist_sync")
    with mx.autograd.record():
        loss = net(nd.ones((1, 2)) * (rank + 1)).sum()
    loss.backward()
    tr.step(1)
    np.testing.assert_array_equal(net.weight.data().asnumpy(),
                                  np.full((1, 2), -tri, np.float32))

    # row_sparse keys: the process's host tables (SparsePS); two replicas'
    # rows merge into one push
    kv.init(40, sparse.row_sparse_array(np.zeros((5, 2), np.float32)))
    g = [sparse.row_sparse_array((np.full((2, 2), rank + 1.0, np.float32),
                                  np.array([1, 3])), shape=(5, 2)),
         sparse.row_sparse_array((np.ones((1, 2), np.float32),
                                  np.array([3])), shape=(5, 2))]
    kv.push(40, g)
    dense = nd.zeros((5, 2))
    kv.pull(40, dense)
    want = np.zeros((5, 2), np.float32)
    want[1], want[3] = rank + 1, rank + 2
    np.testing.assert_array_equal(dense.asnumpy(), want)
    rows = kv.row_sparse_pull(40, row_ids=nd.array(np.array([3, 1])))
    np.testing.assert_array_equal(rows.indices.asnumpy(), [1, 3])
    np.testing.assert_array_equal(rows.data.asnumpy(), want[[1, 3]])

    kv.barrier()
    print(f"worker {rank}/{N}: OK", flush=True)
    return 0


def alone():
    """Rank 0 of a world of two whose peer never comes: the rendezvous
    must raise KVStoreTimeoutError within the deadline."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.resilience import KVStoreTimeoutError
    kv = mx.kv.create("dist_sync")
    t0 = time.monotonic()
    try:
        with mx.cpu():
            kv.rank
    except KVStoreTimeoutError as e:
        print(f"timeout after {time.monotonic() - t0:.2f} s: {e}", flush=True)
        return 0
    return 1


def _launch_local():
    sys.path.insert(0, os.path.join(REPO, "tools"))
    try:
        from launch import _free_port, launch_local
    finally:
        sys.path.pop(0)
    return _free_port, launch_local


def test_two_process_dist_sync():
    _, launch_local = _launch_local()
    env = {"MXNET_KVSTORE_TIMEOUT_S": "60",
           "MXNET_KVSTORE_BIGARRAY_BOUND": "16",
           "PYTHONPATH": REPO, "OMP_NUM_THREADS": "1"}
    codes = launch_local(2, [sys.executable, os.path.abspath(__file__),
                             "worker"], env_extra=env, timeout=90)
    assert codes == [0, 0], f"worker exit codes {codes}"


def test_missing_peer_raises_within_the_deadline():
    free_port, _ = _launch_local()
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1",
               MXNET_DIST_COORDINATOR=f"127.0.0.1:{free_port()}",
               MXNET_DIST_NUM_WORKERS="2", MXNET_DIST_RANK="0",
               MXNET_KVSTORE_TIMEOUT_S=str(TIMEOUT_S))
    res = subprocess.run([sys.executable, os.path.abspath(__file__),
                          "alone"], env=env, capture_output=True, text=True,
                         timeout=60)
    assert res.returncode == 0, res.stdout + res.stderr
    line = next(ln for ln in res.stdout.splitlines()
                if ln.startswith("timeout after"))
    waited = float(line.split()[2])
    assert TIMEOUT_S <= waited + 0.5 and waited < TIMEOUT_S + 5, line
    assert "could not rendezvous with all 2 workers" in line


def test_create_names():
    import mxnet_tpu as jmx
    import mxnet_tpu_torch as mx
    for name in ("dist_sync", "dist_device_sync", "dist_tpu_sync", "dist",
                 "DIST_SYNC"):
        kv = mx.kv.create(name)
        assert isinstance(kv, mx.kv.KVStoreDistTPUSync)
        assert kv.type == name.lower()
    for name in ("dist_async", "dist_sync_device_async", "horovod"):
        with pytest.raises(mx.MXNetError) as got:
            mx.kv.create(name)
        with pytest.raises(jmx.MXNetError) as want:
            jmx.kv.create(name)
        assert str(got.value) == str(want.value)


def test_decompress_sum_matches_reference():
    """The wire path's sum of every process's dequantized codes, bit for
    bit against the reference's."""
    import torch
    from mxnet_tpu.kvstore.compression import GradientCompression as JGC
    from mxnet_tpu_torch.kvstore.compression import GradientCompression
    r = np.random.RandomState(0)
    shape = (3, 7)
    ours, ref = GradientCompression({"threshold": 0.5}), JGC(
        {"type": "2bit", "threshold": 0.5})
    rows_t, rows_j = [], []
    for p in range(3):
        g = r.randn(*shape).astype(np.float32)
        rows_t.append(ours.compress("k", p, torch.tensor(g))[0])
        rows_j.append(np.asarray(ref.compress("k", p, g)[0]))
    np.testing.assert_array_equal(torch.stack(rows_t).numpy(),
                                  np.stack(rows_j))
    got = ours.decompress_sum(torch.stack(rows_t), shape, torch.float32)
    want = np.asarray(ref.decompress_sum(np.stack(rows_j), shape,
                                         np.float32))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


def test_rowsparse_merge_matches_reference():
    """The replicas' row-sparse gradients a push hands to the host tables
    (the local store's merge, duplicate rows summed) against the
    reference's merge (a concatenation) with its duplicate rows summed,
    as both packages' servers sum them."""
    import mxnet_tpu as jmx
    import mxnet_tpu_torch as mx
    from mxnet_tpu.kvstore.dist import _merge_rowsparse as jmerge
    data = [np.arange(4, dtype=np.float32).reshape(2, 2),
            np.ones((2, 2), np.float32)]
    rows = [np.array([0, 3]), np.array([3, 4])]
    kv = mx.kv.create("dist_sync")
    with mx.cpu():
        got = kv._reduce([mx.nd.sparse.row_sparse_array(
            (d, i), shape=(6, 2)) for d, i in zip(data, rows)])
    want = jmerge([jmx.nd.sparse.row_sparse_array((d, i), shape=(6, 2))
                   for d, i in zip(data, rows)])
    summed = np.zeros((6, 2), np.float32)
    np.add.at(summed, want.indices.asnumpy().astype(np.int64),
              want.data.asnumpy())
    np.testing.assert_array_equal(got.tostype("default").asnumpy(), summed)


def test_nccl_rank_binds_the_card_of_its_context(monkeypatch):
    """Under NCCL a rank binds one card at bring-up and every collective
    runs there, also on the Deadline's thread (whose current card would
    be card 0): the card of an open ``with mx.gpu(i):`` scope, else card
    rank modulo the host's cards.  The card queries and the process group
    are stand-ins, so this runs on the host."""
    import threading

    import torch
    import torch.distributed as tdist
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.kvstore import dist as kd

    seen = {"set": [], "init": [], "current": []}

    class Card:             # torch.cuda.device, recording its thread
        def __init__(self, dev):
            self.dev = dev

        def __enter__(self):
            seen["current"].append((self.dev, threading.current_thread()))

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(torch.cuda, "set_device", seen["set"].append)
    monkeypatch.setattr(torch.cuda, "device", Card)
    monkeypatch.setattr(tdist, "is_initialized", lambda: False)
    monkeypatch.setattr(tdist, "TCPStore", lambda *a, **k: None)
    monkeypatch.setattr(tdist, "init_process_group",
                        lambda backend, **kw: seen["init"].append(
                            (backend, kw["rank"], kw.get("device_id"))))
    monkeypatch.setattr(tdist, "get_world_size", lambda group=None: 4)
    monkeypatch.setattr(tdist, "get_rank", lambda group=None: 3)
    monkeypatch.setenv("MXNET_DIST_COORDINATOR", "127.0.0.1:1")
    monkeypatch.setenv("MXNET_DIST_NUM_WORKERS", "4")
    monkeypatch.setenv("MXNET_DIST_RANK", "3")
    monkeypatch.setenv("MXNET_KVSTORE_TIMEOUT_S", "30")

    def bring_up(scope):
        monkeypatch.setattr(kd, "_GROUPS", {})
        kv = mx.kv.create("dist_sync")
        if scope is None:
            kv.connect()
        else:
            with scope:
                kv.connect()
        return kv

    kv = bring_up(None)                 # rank 3 of 4: card 3
    want = torch.device("cuda", 3)
    assert kv._wire == want and seen["set"][-1] == want
    assert seen["init"][-1] == ("nccl", 3, want)
    kv = bring_up(mx.gpu(2))            # the scope's card wins
    want = torch.device("cuda", 2)
    assert kv._wire == want and seen["set"][-1] == want
    assert seen["init"][-1] == ("nccl", 3, want)
    # a collective runs on the Deadline's thread under the rank's card
    assert kv._on_wire(lambda x: x + 1, 1) == 2
    dev, thread = seen["current"][-1]
    assert dev == want and thread is not threading.current_thread()
    kv._deadline.close()


if __name__ == "__main__":
    sys.exit({"worker": worker, "worker_card": worker_card,
              "alone": alone}[sys.argv[1]]())
