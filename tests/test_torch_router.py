"""The port's serving router tier (``serving.router`` + ``serving.replica``)
through the reference's failure matrix (``tests/test_router.py``,
``tests/test_router_chaos.py``).

Every test drives the real router and the real ``ReplicaServer`` protocol
code.  The engine behind each replica is a stub of this file's own: run
as ``python tests/test_torch_router.py stub`` it serves the reference
stub's token oracle, ``tokens[k] = (sum(prompt) % 97 * 31 + k) % 97``
(replica- and batching-independent, so a retried request's output on a
survivor is the same by construction), with the same failure knobs:

  STUB_TOKEN_DELAY_S   per-token sleep (load, hedging, shedding)
  STUB_DIE_TOKEN       a prompt holding it => os._exit(1) before computing
  STUB_WEDGE_TOKEN     a prompt holding it => heartbeat stops, RPC hangs
  STUB_ONCE_MARKER     marker file: die/wedge fire once across respawns
  MXNET_CHAOS(_SITES)  the chaos grammar; ``serving.reply:exit:1`` is the
                       death between computing a result and acking it.

``python tests/test_torch_router.py router ...`` is the router process of
the router-death test: it arms ``router.dispatch`` to exit mid-dispatch,
and a second run on the same workdir re-adopts the live replicas.  The
last test serves two real llama_tiny replicas on the CPU (``--device
cpu``) and holds their tokens against one in-process engine.  Each test
checks that no process it started outlives it.
"""

import json
import os
import signal
import subprocess
import sys
import threading
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

HERE = os.path.abspath(__file__)
STUB = [sys.executable, HERE, "stub"]
FAST_HB = {"MXNET_ELASTIC_HEARTBEAT_S": "0.1"}


def oracle_tokens(prompt, max_new_tokens):
    s = sum(int(t) for t in prompt) % 97
    return [(s * 31 + k) % 97 for k in range(int(max_new_tokens))]


# -- the stub replica (run as a script) ---------------------------------------

class _StubHandle:
    def __init__(self):
        self._ev = threading.Event()
        self.tokens = None
        self.error = None

    def wait(self, timeout_s=None):
        return self._ev.wait(timeout_s)

    def result(self, timeout=None):
        from mxnet_tpu_torch.serving.engine import RequestDeadlineExceeded
        self._ev.wait(timeout if timeout else 300.0)
        if self.error is not None:
            raise self.error
        if self.tokens is None:
            raise RequestDeadlineExceeded("stub handle never resolved")
        return list(self.tokens)


class StubEngine:
    max_batch = 4

    def __init__(self):
        self.delay = float(os.environ.get("STUB_TOKEN_DELAY_S", "0"))
        self.die_token = int(os.environ.get("STUB_DIE_TOKEN", "-1"))
        self.wedge_token = int(os.environ.get("STUB_WEDGE_TOKEN", "-1"))
        self.once_marker = os.environ.get("STUB_ONCE_MARKER", "")
        self._lock = threading.Lock()
        self._queued = 0
        self._active = 0

    def _fire_once(self):
        if not self.once_marker:
            return True
        try:
            fd = os.open(self.once_marker,
                         os.O_CREAT | os.O_EXCL | os.O_WRONLY)
            os.close(fd)
            return True
        except FileExistsError:
            return False

    def submit(self, prompt, max_new_tokens=32, deadline_s=None):
        from mxnet_tpu_torch.resilience import heartbeat as hb
        from mxnet_tpu_torch.serving.engine import RequestDeadlineExceeded
        prompt = [int(t) for t in prompt]
        if self.die_token in prompt and self._fire_once():
            os._exit(1)                     # death before any token
        if self.wedge_token in prompt and self._fire_once():
            hb.stop()                       # heartbeat goes stale...
            time.sleep(10000)               # ...and the RPC thread hangs
        h = _StubHandle()
        with self._lock:
            self._queued += 1

        def work():
            with self._lock:
                self._queued -= 1
                self._active += 1
            t0 = time.monotonic()
            try:
                for _ in range(int(max_new_tokens)):
                    if self.delay:
                        time.sleep(self.delay)
                    if deadline_s is not None \
                            and time.monotonic() - t0 > float(deadline_s):
                        h.error = RequestDeadlineExceeded(
                            f"stub request blew its {deadline_s}s budget")
                        return
                h.tokens = oracle_tokens(prompt, max_new_tokens)
            finally:
                with self._lock:
                    self._active -= 1
                h._ev.set()

        threading.Thread(target=work, daemon=True).start()
        return h

    def load(self):
        with self._lock:
            return (self._queued, self._active, 999)

    def stop(self):
        pass


def stub_main():
    from mxnet_tpu_torch.resilience import heartbeat as hb
    from mxnet_tpu_torch.serving.replica import ReplicaServer
    workdir = os.environ["MXNET_ROUTER_DIR"]
    index = int(os.environ["MXNET_ROUTER_INDEX"])
    hb.start()
    hb.set_phase("bringup")
    srv = ReplicaServer(StubEngine(), workdir, index)
    srv.bind()
    hb.set_phase("running")
    srv.run()
    hb.mark_done()
    return 0


# -- the router process of the router-death test (run as a script) ----------

def router_main(argv):
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--workdir", required=True)
    ap.add_argument("--requests", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--dispatch-exit-after", type=int, default=None)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--keep-replicas", action="store_true")
    args = ap.parse_args(argv)
    from mxnet_tpu_torch.resilience import chaos
    from mxnet_tpu_torch.serving.router import Router
    if args.dispatch_exit_after is not None:
        chaos.inject("router.dispatch", kind="exit",
                     after=args.dispatch_exit_after, times=1)
    with open(args.requests) as f:
        want = json.load(f)
    router = Router(STUB, 2, args.workdir, queue_max=16).start()
    handles = dict(router.recovered()) if args.resume else {}
    for rec in want:
        if rec["tag"] not in handles:
            handles[rec["tag"]] = router.submit(
                rec["prompt"], rec["max_new_tokens"], tag=rec["tag"])
    results = {}
    for tag, h in handles.items():
        try:
            results[tag] = {"tokens": h.result(timeout=60)}
        except Exception as exc:  # noqa: BLE001 — recorded for the test
            results[tag] = {"error": type(exc).__name__}
    out = {"results": results, "replicas": router.replica_status()}
    with open(args.out + ".tmp", "w") as f:
        json.dump(out, f)
    os.replace(args.out + ".tmp", args.out)
    router.stop(shutdown_replicas=not args.keep_replicas)
    return 0


if __name__ == "__main__":
    if sys.argv[1] == "stub":
        sys.exit(stub_main())
    sys.exit(router_main(sys.argv[2:]))


# -- the tests ---------------------------------------------------------------

import numpy as np  # noqa: E402
import pytest  # noqa: E402

from mxnet_tpu_torch import telemetry  # noqa: E402
from mxnet_tpu_torch.resilience import chaos  # noqa: E402
from mxnet_tpu_torch.serving import engine as serving_engine  # noqa: E402
from mxnet_tpu_torch.serving.router import (  # noqa: E402
    ReplicaDeadError, Router, RouterOverloaded, STATE_FILE,
)


def _counter(name):
    m = telemetry.REGISTRY.get(name)
    return 0 if m is None else m.value


def _in_workdir(workdir):
    """Live pids whose cwd is ``workdir`` (replicas run there)."""
    out = []
    for d in os.listdir("/proc"):
        if not d.isdigit():
            continue
        try:
            cwd = os.readlink(f"/proc/{d}/cwd")
            with open(f"/proc/{d}/stat") as f:
                state = f.read().rsplit(")", 1)[1].split()[0]
        except OSError:
            continue
        if state != "Z" and os.path.realpath(cwd) == \
                os.path.realpath(workdir):
            out.append(int(d))
    return out


@pytest.fixture
def workdir(tmp_path):
    """The tier's workdir; after the test no process may still run in it
    (SIGKILLed and reported if one does)."""
    yield tmp_path
    deadline = time.monotonic() + 10.0
    while (left := _in_workdir(tmp_path)) and time.monotonic() < deadline:
        time.sleep(0.05)
    for pid in left:
        os.kill(pid, signal.SIGKILL)
    assert not left, f"processes outlived the test: {left}"


def _router(workdir, n=2, **kw):
    kw.setdefault("env_extra", dict(FAST_HB))
    kw.setdefault("queue_max", 64)
    return Router(STUB, n, str(workdir), **kw).start()


def _wait(pred, timeout=10.0, msg="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return
        time.sleep(0.02)
    raise AssertionError(f"timed out waiting for {msg}")


def _served_by(handle):
    for e in telemetry.get_tracer().events():
        if e.get("cat") == "router.request" and e.get("name") == \
                "dispatched" and e.get("id") == handle.rid:
            return e["args"]["replica"]
    raise AssertionError(f"no dispatch event for {handle.rid}")


@pytest.fixture
def traced():
    was = telemetry.enable()
    yield
    if not was:
        telemetry.disable()


def test_router_dispatch_results_and_balance(workdir, traced):
    d0 = _counter("mxnet_router_dispatched_total")
    r = _router(workdir, env_extra={"STUB_TOKEN_DELAY_S": "0.02",
                                    **FAST_HB})
    try:
        assert r.wait_up(timeout_s=30) == 2
        prompts = [[i, i + 1, 5] for i in range(8)]
        hs = [r.submit(p, max_new_tokens=4) for p in prompts]
        for p, h in zip(prompts, hs):
            assert h.result(timeout=30) == oracle_tokens(p, 4), p
        assert _counter("mxnet_router_dispatched_total") - d0 == 8
        assert {_served_by(h) for h in hs} == {0, 1}
        st = r.replica_status()
        assert [s["state"] for s in st] == ["up", "up"]
        assert "mxnet_router_replica_up" in telemetry.to_prometheus()
    finally:
        r.stop()


def test_router_prefix_affinity_dispatch(workdir, traced):
    r = _router(workdir, affinity_tokens=4)
    try:
        assert r.wait_up(timeout_s=30) == 2
        base = [3, 1, 4, 1]
        homes = []
        for i in range(6):          # sequential: replicas tie on load
            p = base + [10 + i]
            h = r.submit(p, max_new_tokens=3)
            assert h.result(timeout=30) == oracle_tokens(p, 3)
            homes.append(_served_by(h))
        assert len(set(homes)) == 1, homes
        spread = []
        for i in range(4):
            p = [50 + i, 60 + i, 70 + i, 80 + i, 1]
            h = r.submit(p, max_new_tokens=3)
            assert h.result(timeout=30) == oracle_tokens(p, 3)
            spread.append(_served_by(h))
        assert set(spread) == {0, 1}, spread
        assert r.drain(homes[0], restart=False)
        p = base + [99]
        h = r.submit(p, max_new_tokens=3)
        assert h.result(timeout=30) == oracle_tokens(p, 3)
        assert _served_by(h) == 1 - homes[0]
    finally:
        r.stop()


def test_replica_death_mid_decode_retry_token_identical(workdir):
    deaths0 = _counter("mxnet_router_replica_deaths_total")
    retries0 = _counter("mxnet_router_retries_total")
    respawns0 = _counter("mxnet_router_respawns_total")
    r = _router(workdir, env_extra={
        "STUB_DIE_TOKEN": "77",
        "STUB_ONCE_MARKER": str(workdir / "die.marker"), **FAST_HB})
    try:
        prompts = ([77, 3, 9], [4, 5], [6, 7])
        hs = [r.submit(p, max_new_tokens=5) for p in prompts]
        for p, h in zip(prompts, hs):
            assert h.result(timeout=30) == oracle_tokens(p, 5), p
        assert _counter("mxnet_router_replica_deaths_total") > deaths0
        assert _counter("mxnet_router_retries_total") > retries0
        _wait(lambda: all(s["state"] == "up" for s in r.replica_status()),
              timeout=30, msg="respawn after death")
        assert _counter("mxnet_router_respawns_total") > respawns0
    finally:
        r.stop()


def test_reply_ack_window_death_no_duplicate_tokens(workdir):
    retries0 = _counter("mxnet_router_retries_total")
    r = _router(workdir, env_per_replica={
        0: {"MXNET_CHAOS": "1",
            "MXNET_CHAOS_SITES": "serving.reply:exit:1"}})
    try:
        assert r.wait_up(timeout_s=30) == 2
        p = [9, 8, 7]
        # the tie-break sends the first request to replica 0, armed: it
        # computes, hits serving.reply and dies before acking
        got = r.submit(p, max_new_tokens=6).result(timeout=30)
        assert got == oracle_tokens(p, 6)
        assert _counter("mxnet_router_retries_total") > retries0
    finally:
        r.stop()


def test_hedge_fires_and_loser_cancelled(workdir):
    hedges0 = _counter("mxnet_router_hedges_total")
    r = _router(workdir, hedge_s=0.25,
                env_per_replica={0: {"STUB_TOKEN_DELAY_S": "0.5"}})
    try:
        assert r.wait_up(timeout_s=30) == 2
        p = [11, 12]
        t0 = time.monotonic()
        h = r.submit(p, max_new_tokens=4)     # tie-break -> slow replica 0
        got = h.result(timeout=30)
        wall = time.monotonic() - t0
        assert got == oracle_tokens(p, 4)
        assert _counter("mxnet_router_hedges_total") == hedges0 + 1
        assert h.stats()["hedged"]
        assert wall < 1.5, f"hedge should beat the 2 s straggler: {wall}"
        cancel_log = workdir / "cancels-0000.log"
        _wait(cancel_log.exists, msg="loser cancel log")
        assert h.rid in cancel_log.read_text().split()
    finally:
        r.stop()


def test_admission_shed_fails_fast_and_bounded(workdir):
    sheds0 = _counter("mxnet_router_shed_total")
    r = _router(workdir, n=1, queue_max=4,
                env_extra={"STUB_TOKEN_DELAY_S": "0.05", **FAST_HB})
    try:
        admitted, shed = [], 0
        for i in range(12):
            t0 = time.monotonic()
            try:
                admitted.append((i, r.submit([i, 2], max_new_tokens=4)))
            except RouterOverloaded:
                shed += 1
                assert time.monotonic() - t0 < 0.1, "shed must not block"
        assert shed >= 6 and len(admitted) >= 4
        assert _counter("mxnet_router_shed_total") - sheds0 == shed
        for i, h in admitted:
            assert h.result(timeout=30) == oracle_tokens([i, 2], 4)
            assert h.stats()["e2e_s"] < 15.0
    finally:
        r.stop()


def test_deadline_propagates_to_replica(workdir):
    r = _router(workdir, n=1,
                env_extra={"STUB_TOKEN_DELAY_S": "0.1", **FAST_HB})
    try:
        assert r.wait_up(timeout_s=30) == 1
        h = r.submit([3, 4], max_new_tokens=20, deadline_s=0.3)
        t0 = time.monotonic()
        with pytest.raises(serving_engine.RequestDeadlineExceeded):
            h.result(timeout=30)
        assert time.monotonic() - t0 < 5.0
    finally:
        r.stop()


def test_drain_rolling_restart(workdir):
    r = _router(workdir, env_extra={"STUB_TOKEN_DELAY_S": "0.02",
                                    **FAST_HB})
    try:
        assert r.wait_up(timeout_s=30) == 2
        hs = [r.submit([i, 9], max_new_tokens=4) for i in range(4)]
        pid0 = r.replica_status()[0]["pid"]
        assert r.drain(0, restart=True, timeout_s=30)
        for i, h in enumerate(hs):
            assert h.result(timeout=30) == oracle_tokens([i, 9], 4)
        _wait(lambda: r.replica_status()[0]["state"] == "up", timeout=30,
              msg="replica 0 back up after drain")
        assert r.replica_status()[0]["pid"] != pid0
        assert r.submit([42], max_new_tokens=3).result(timeout=30) \
            == oracle_tokens([42], 3)
    finally:
        r.stop()


def test_hung_replica_sigkilled_and_request_retried(workdir):
    deaths0 = _counter("mxnet_router_replica_deaths_total")
    r = _router(workdir, hang_s=1.0, env_extra={
        "STUB_WEDGE_TOKEN": "88",
        "STUB_ONCE_MARKER": str(workdir / "wedge.marker"), **FAST_HB})
    try:
        p = [88, 5]
        assert r.submit(p, max_new_tokens=4).result(timeout=30) \
            == oracle_tokens(p, 4)
        assert _counter("mxnet_router_replica_deaths_total") > deaths0
    finally:
        r.stop()


def test_replica_spawn_chaos_transient_absorbed(workdir):
    before = chaos.fault_count("router.replica_spawn")
    chaos.inject("router.replica_spawn", kind="transient", times=1)
    try:
        r = _router(workdir, n=1)
        try:
            assert chaos.fault_count("router.replica_spawn") == before + 1
            h = r.submit([5, 6], max_new_tokens=3)
            assert h.result(timeout=30) == oracle_tokens([5, 6], 3)
        finally:
            r.stop()
    finally:
        chaos.clear("router.replica_spawn")


def test_retry_budget_exhaustion_fails_not_hangs(workdir):
    r = _router(workdir, n=1, max_retries=1, max_respawns=1,
                env_extra={"STUB_DIE_TOKEN": "77", **FAST_HB})
    try:
        # no once-marker: the respawned replica dies on the retry too
        h = r.submit([77], max_new_tokens=3)
        with pytest.raises(ReplicaDeadError):
            h.result(timeout=60)
    finally:
        r.stop()


def test_router_death_mid_dispatch_readoption(workdir):
    """The router dies (chaos 'exit' at router.dispatch) with requests
    journaled but unsent; a router restarted on the workdir re-adopts the
    live replicas through their port files and re-dispatches the journal:
    every accepted request resolves to the oracle's tokens."""
    reqs = [{"tag": f"t{i}", "prompt": [i, 3], "max_new_tokens": 4}
            for i in range(6)]
    req_file = workdir / "reqs.json"
    req_file.write_text(json.dumps(reqs))
    out_file = workdir / "out.json"
    env = dict(os.environ, STUB_TOKEN_DELAY_S="0.1", **FAST_HB)
    base = [sys.executable, HERE, "router", "--workdir", str(workdir),
            "--requests", str(req_file), "--out", str(out_file)]
    p1 = subprocess.run(base + ["--dispatch-exit-after", "2",
                                "--keep-replicas"], env=env, timeout=90)
    assert p1.returncode != 0          # the chaos exit killed it
    assert not out_file.exists()
    st = json.loads((workdir / STATE_FILE).read_text())
    assert st["phase"] == "running" and st["requests"]
    pids1 = {r["index"]: r["pid"] for r in st["replicas"]}
    p2 = subprocess.run(base + ["--resume"], env=env, timeout=120)
    assert p2.returncode == 0, "the resumed router process failed"
    out = json.loads(out_file.read_text())
    for rec in reqs:
        assert out["results"][rec["tag"]].get("tokens") \
            == oracle_tokens(rec["prompt"], 4), rec["tag"]
    assert any(r["adopted"] and r["pid"] == pids1[r["index"]]
               for r in out["replicas"]), out["replicas"]


# -- two real llama_tiny replicas on the CPU ----------------------------------

REPLICA = ["--model", "llama_tiny", "--vocab", "101", "--seed", "7",
           "--eos", "-1", "--device", "cpu", "--max-batch", "4",
           "--block-tokens", "4", "--max-seq", "64", "--prefill-tokens",
           "16"]


def test_two_llama_replicas_match_one_engine(workdir):
    """Two real llama_tiny replicas (weights drawn from the same seed)
    behind the router, replica 0 dying once between computing a result
    and acking it: every answer equals one in-process engine's tokens."""
    import torch
    from mxnet_tpu_torch import serving
    from mxnet_tpu_torch.serving.replica import build_llama
    r = np.random.RandomState(5)
    prompts = [[int(t) for t in r.randint(3, 101, r.randint(3, 9))]
               for _ in range(8)]
    threads = torch.get_num_threads()
    torch.set_num_threads(1)            # as the replicas run
    try:
        net = build_llama("llama_tiny", 101, 7, "cpu")
        oracle = serving.ServingEngine(
            net, eos_id=-1, max_batch=4, block_tokens=4, max_seq=64,
            prefill_tokens=16).generate(prompts, max_new_tokens=6)
    finally:
        torch.set_num_threads(threads)
    retries0 = _counter("mxnet_router_retries_total")
    cmd = [sys.executable, "-m", "mxnet_tpu_torch.serving.replica"] + REPLICA
    router = Router(cmd, 2, str(workdir), env_extra=dict(FAST_HB),
                    env_per_replica={0: {
                        "MXNET_CHAOS": "1",
                        "MXNET_CHAOS_SITES": "serving.reply:exit:1"}}).start()
    try:
        assert router.wait_up(timeout_s=60) == 2
        hs = [router.submit(p, max_new_tokens=6) for p in prompts]
        got = [h.result(timeout=120) for h in hs]
    finally:
        router.stop()
    assert got == oracle
    assert _counter("mxnet_router_retries_total") > retries0
