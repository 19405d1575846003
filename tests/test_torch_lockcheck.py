"""``analysis.tracked`` and ``MXNET_LOCKCHECK`` — the runtime twin of
graftcheck GC06 — on the port: the disarmed raw lock, direct and
transitive inversions, and the port's router and ``Deadline`` running
armed without an error (the reference's ``test_lockcheck_router`` and the
``Deadline`` half of ``test_lockcheck_controller_deadline``; the
controller waits for ElasticController, ROADMAP A.9)."""

import os
import sys
import threading

import pytest

from mxnet_tpu_torch import analysis
from mxnet_tpu_torch.analysis.runtime import _TrackedLock

HERE = os.path.dirname(os.path.abspath(__file__))


@pytest.fixture
def lockcheck():
    analysis.arm_lockcheck(True)
    analysis.lockcheck_reset()
    yield
    analysis.arm_lockcheck(None)
    analysis.lockcheck_reset()


def test_disarmed_tracked_returns_the_raw_lock(monkeypatch):
    monkeypatch.delenv("MXNET_LOCKCHECK", raising=False)
    analysis.arm_lockcheck(None)
    lk = threading.Lock()
    assert not analysis.lockcheck_armed()
    assert analysis.tracked(lk, "raw") is lk
    monkeypatch.setenv("MXNET_LOCKCHECK", "1")
    assert analysis.lockcheck_armed()
    assert isinstance(analysis.tracked(lk, "knob"), _TrackedLock)


def test_direct_inversion_raises(lockcheck):  # noqa: ARG001
    a = analysis.tracked(threading.Lock(), "A")
    b = analysis.tracked(threading.Lock(), "B")
    with a:
        with b:
            pass
    with pytest.raises(analysis.LockOrderError) as ei:
        with b:
            with a:
                pass
    assert "A" in str(ei.value) and "B" in str(ei.value)
    assert ("A", "B") in analysis.lockcheck_edges()


def test_transitive_inversion_raises(lockcheck):  # noqa: ARG001
    a = analysis.tracked(threading.Lock(), "A")
    b = analysis.tracked(threading.Lock(), "B")
    c = analysis.tracked(threading.Lock(), "C")
    with a:
        with b:
            pass
    with b:
        with c:
            pass
    with pytest.raises(analysis.LockOrderError) as ei:
        with c:
            with a:
                pass
    assert "A -> B" in str(ei.value) and "B -> C" in str(ei.value)


def test_condition_over_a_tracked_lock(lockcheck):  # noqa: ARG001
    """The router waits on a Condition over its tracked lock: wait()'s
    release and re-acquire stay balanced."""
    lk = analysis.tracked(threading.Lock(), "L")
    cond = threading.Condition(lk)
    other = analysis.tracked(threading.Lock(), "M")
    with cond:
        cond.wait(timeout=0.01)
        with other:
            pass
    assert ("L", "M") in analysis.lockcheck_edges()


def test_router_runs_armed(lockcheck, tmp_path):  # noqa: ARG001
    """The port's router creates its locks through tracked(): a tier
    bring-up and a request record Router edges and raise nothing."""
    from mxnet_tpu_torch.serving.router import Router
    stub = [sys.executable, os.path.join(HERE, "test_torch_router.py"),
            "stub"]
    r = Router(stub, 1, str(tmp_path),
               env_extra={"MXNET_ELASTIC_HEARTBEAT_S": "0.1"}).start()
    try:
        assert isinstance(r._lock, _TrackedLock)
        h = r.submit([1, 2, 3], max_new_tokens=4)
        assert len(h.result(timeout=60)) == 4
    finally:
        r.stop()
    held_first = {a for a, _ in analysis.lockcheck_edges()}
    assert any(name.startswith("Router.") for name in held_first), \
        analysis.lockcheck_edges()


def test_deadline_runs_armed(lockcheck):  # noqa: ARG001
    from mxnet_tpu_torch.resilience import Deadline
    d = Deadline(timeout_s=5, site="lockcheck.unit")
    assert isinstance(d._lock, _TrackedLock)
    assert d.call(lambda: "ok") == "ok"
    d.close()


def test_engine_and_sparse_ps_locks_are_tracked(lockcheck):  # noqa: ARG001
    import torch
    from mxnet_tpu_torch.kvstore.sparse_ps import SparsePS
    from mxnet_tpu_torch.optimizer import SGD
    ps = SparsePS()
    ps.init("emb", torch.zeros(8, 2))
    ps.set_optimizer(SGD(learning_rate=0.5))
    ps.push("emb", torch.ones(8, 2))
    assert isinstance(ps._lock, _TrackedLock)
    assert isinstance(ps._tables["emb"].lock, _TrackedLock)
    assert ("SparsePS._lock", "SparsePS._Table.lock") \
        in analysis.lockcheck_edges()
