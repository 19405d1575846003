"""The port's resilience package held against the JAX package's:

- ``Retry``: the jittered backoff sequence under one seed, the retries it
  absorbs, its counters, exhaustion; ``is_transient``;
- ``Deadline``: raising ``KVStoreTimeoutError`` on time, passing results
  and errors through, ``protect`` composing both;
- ``chaos``: the ``MXNET_CHAOS_SITES`` grammar (malformed entries warned
  and skipped), and what each ``hit`` does under ``after``/``times``;
- ``heartbeat``: the file's contents (pid and time aside) through the
  phases, ``read_all`` and ``status``;
- the port's departure (ROADMAP C.7): a ``start()`` after ``mark_failed``
  beats ``spawned`` with no error, where the reference keeps ``failed``.
"""

import random
import time

import pytest

from mxnet_tpu import resilience as jres
from mxnet_tpu.resilience import chaos as jchaos
from mxnet_tpu.resilience import heartbeat as jhb
from mxnet_tpu.telemetry import stepclock as jstepclock
from mxnet_tpu_torch.telemetry import stepclock as tstepclock

from mxnet_tpu_torch import resilience as tres
from mxnet_tpu_torch import telemetry as ttel
from mxnet_tpu_torch.resilience import chaos as tchaos
from mxnet_tpu_torch.resilience import heartbeat as thb
from mxnet_tpu_torch.resilience.controller import _pid_alive, _pid_matches

PKGS = (jres, tres)


def test_retry_backoff_sequence_under_one_seed():
    seqs = []
    for pkg in PKGS:
        random.seed(1234)
        r = pkg.Retry(max_retries=5, backoff_s=0.01, backoff_max_s=0.1,
                      jitter=0.25)
        seqs.append([r.backoff_delay(k) for k in range(-1, 8)])
    assert seqs[1] == seqs[0]
    assert seqs[1][0] == 0.0 and max(seqs[1]) <= 0.1 * 1.25


def _flaky(pkg, fails, exc=None):
    calls = []

    def fn(x):
        calls.append(x)
        if len(calls) <= fails:
            raise exc if exc is not None else pkg.TransientError("blip")
        return x * 2
    return fn, calls


def test_retry_absorbs_transients_and_exhausts():
    outs = []
    for pkg, counter in ((jres, None), (tres, ttel)):
        fn, calls = _flaky(pkg, 2)
        c0 = None if counter is None else \
            counter.counter("mxnet_resilience_retries_total").value
        r = pkg.Retry(max_retries=3, backoff_s=0.0, jitter=0.0, site="s")
        got = r.call(fn, 21)
        if counter is not None:
            assert counter.counter(
                "mxnet_resilience_retries_total").value - c0 == 2
        fn2, calls2 = _flaky(pkg, 9)
        with pytest.raises(pkg.RetryExhaustedError,
                           match="s failed after 2 attempts") as ei:
            pkg.Retry(max_retries=1, backoff_s=0.0, site="s").call(fn2, 1)
        fn3, calls3 = _flaky(pkg, 9, ValueError("permanent"))
        with pytest.raises(ValueError):
            pkg.Retry(max_retries=4, backoff_s=0.0).call(fn3, 1)
        outs.append((got, len(calls), len(calls2), len(calls3),
                     type(ei.value.__cause__).__name__))
    assert outs[1] == outs[0] == (42, 3, 2, 1, "TransientError")


def test_is_transient_matches():
    for exc in (ConnectionError(), BrokenPipeError(), ValueError(),
                RuntimeError()):
        assert tres.is_transient(exc) == jres.is_transient(exc)
    e = RuntimeError("x")
    e.transient = True
    assert tres.is_transient(e) and jres.is_transient(e)
    assert tres.is_transient(tchaos.ChaosTransientError("t"))
    assert not tres.is_transient(tchaos.ChaosWorkerDeath("d"))


def test_deadline_raises_on_time_and_passes_through():
    for pkg in PKGS:
        d = pkg.Deadline(timeout_s=0.2, site="probe")
        t0 = time.monotonic()
        with pytest.raises(pkg.KVStoreTimeoutError,
                           match="probe exceeded its 0.2s deadline"):
            d.call(time.sleep, 5)
        assert time.monotonic() - t0 < 1.5
        assert d.call(lambda a, b: a + b, 2, b=3) == 5
        with pytest.raises(KeyError):
            d.call({}.__getitem__, "missing")
        assert pkg.Deadline(timeout_s=0).call(lambda: 7) == 7
        fn, calls = _flaky(pkg, 1)
        assert pkg.protect(fn, retry=pkg.Retry(backoff_s=0.0),
                           deadline=pkg.Deadline(timeout_s=5.0))(4) == 8
        d.close()


SPEC = ("router.dispatch:exit:1:0:3, serving.reply:transient:2,"
        "router.replica_spawn:delay:1:0.01, bad:kind, x:fatal:0:0:1, "
        "nonint:transient:many")


def _chaos_run(mod):
    mod.clear()
    with pytest.warns(UserWarning, match="malformed MXNET_CHAOS_SITES"):
        mod.arm_from_spec(SPEC)
    sites = mod.sites()
    out = []
    for site in ("serving.reply",) * 3 + ("router.replica_spawn",) * 2 \
            + ("x",) * 3:
        try:
            mod.hit(site, rid="r")
            out.append("ok")
        except mod.ChaosError as exc:
            out.append(type(exc).__name__)
    counts = {s: mod.fault_count(s) for s in
              ("serving.reply", "router.replica_spawn", "x", "bad")}
    faults = {s: [(f.kind, f.times, f.after, f.delay_s, f.hits, f.fired)
                  for f in mod._faults[s]] for s in sorted(mod._faults)}
    mod.clear()
    return sites, out, counts, faults, mod.active()


def test_chaos_grammar_and_hits_match():
    c0 = {s: (jchaos.fault_count(s), tchaos.fault_count(s))
          for s in ("serving.reply", "router.replica_spawn", "x")}
    jr, tr = _chaos_run(jchaos), _chaos_run(tchaos)
    # fired counts survive clear() and accumulate: compare the deltas
    jr[2].update({s: n - c0[s][0] for s, n in jr[2].items() if s in c0})
    tr[2].update({s: n - c0[s][1] for s, n in tr[2].items() if s in c0})
    assert tr == jr
    sites, out, counts, _faults, active = tr
    assert sites == ["router.dispatch", "router.replica_spawn",
                     "serving.reply", "x"]
    assert out == ["ChaosTransientError", "ChaosTransientError", "ok",
                   "ok", "ok", "ok", "ChaosWorkerDeath", "ChaosWorkerDeath"]
    assert counts["serving.reply"] == 2 and not active
    with pytest.raises(ValueError, match="unknown chaos kind"):
        tchaos.inject("s", kind="boom")


def _keep_module_state(mod, monkeypatch):
    """Leave the heartbeat module's phase/step/error as this test found
    them (later tests in the process read them)."""
    for name in ("_phase", "_step", "_error", "_last_beat"):
        monkeypatch.setattr(mod, name, getattr(mod, name))


def _fresh_module_state(mod, monkeypatch):
    """Start the heartbeat module from its fresh-import state (an earlier
    test in the process may have marked it failed); restored afterwards."""
    monkeypatch.setattr(mod, "_phase", "spawned")
    for name in ("_step", "_error", "_last_beat"):
        monkeypatch.setattr(mod, name, None)


def _hb_records(mod, tmp_path, monkeypatch):
    _keep_module_state(mod, monkeypatch)
    _fresh_module_state(mod, monkeypatch)
    monkeypatch.setenv("MXNET_ELASTIC_HEARTBEAT_DIR", str(tmp_path))
    monkeypatch.setenv("MXNET_DIST_RANK", "3")
    monkeypatch.setenv("MXNET_DIST_NUM_WORKERS", "4")
    monkeypatch.setenv("MXNET_ELASTIC_INCARNATION", "2")
    monkeypatch.setenv("MXNET_ELASTIC_HEARTBEAT_S", "30")
    seen = []

    def snap():
        rec = dict(mod.read_all(str(tmp_path))[3])
        assert abs(rec.pop("time") - time.time()) < 60
        assert rec.pop("pid") > 0
        seen.append(rec)

    try:
        assert mod.start() is True
        snap()
        mod.set_phase("bringup")
        mod.set_step(17)
        mod.beat()
        snap()
        mod.set_phase("running")
        snap()
        mod.mark_done()
        snap()
        st = mod.status()
        seen.append((st["phase"], st["armed"],
                     st["heartbeat_age_s"] is not None))
    finally:
        mod.stop()
    assert mod.path_for(3, str(tmp_path)).endswith("hb-rank00003.json")
    return seen


def test_heartbeat_file_contents_match(tmp_path, monkeypatch):
    # both records embed their step clock's summary: idle in a process
    # that recorded no training step, as a serving replica
    monkeypatch.setattr(jstepclock, "STEP_CLOCK", jstepclock.StepClock())
    monkeypatch.setattr(tstepclock, "STEP_CLOCK", tstepclock.StepClock())
    j = _hb_records(jhb, tmp_path / "j", monkeypatch)
    t = _hb_records(thb, tmp_path / "t", monkeypatch)
    # the reference starts from whatever phase its module was left in;
    # compare from the first explicit phase on (the C.7 case is below)
    assert t[1:] == j[1:]
    assert t[0]["phase"] == "spawned" and t[0]["step"] is None
    assert [r["phase"] for r in t[:4]] == ["spawned", "bringup", "running",
                                           "done"]
    assert t[1]["step"] == 17 and t[1]["rank"] == 3 \
        and t[1]["world"] == 4 and t[1]["incarnation"] == 2
    assert t[4] == ("done", True, True)
    assert thb.read_all(str(tmp_path / "missing")) == {}


def test_heartbeat_start_after_failure_beats_spawned(tmp_path, monkeypatch):
    """ROADMAP C.7: the reference keeps ``failed`` across stop()/start();
    the port's new beater begins at ``spawned`` with no step or error."""
    _keep_module_state(thb, monkeypatch)
    monkeypatch.setenv("MXNET_ELASTIC_HEARTBEAT_DIR", str(tmp_path))
    monkeypatch.setenv("MXNET_ELASTIC_HEARTBEAT_S", "30")
    try:
        thb.start()
        thb.set_step(5)
        thb.mark_failed(RuntimeError("bring-up timed out"))
        rec = thb.read_all(str(tmp_path))[0]
        assert rec["phase"] == "failed" and "timed out" in rec["error"]
        thb.stop()
        assert thb.start() is True
        rec = thb.read_all(str(tmp_path))[0]
        assert (rec["phase"], rec["step"], rec["error"]) \
            == ("spawned", None, None)
        assert thb.status()["phase"] == "spawned"
    finally:
        thb.stop()
    monkeypatch.delenv("MXNET_ELASTIC_HEARTBEAT_DIR")
    assert thb.start() is False and thb.beat() is None


def test_pid_guards(tmp_path):
    import os
    import subprocess
    import sys
    assert _pid_alive(os.getpid())
    p = subprocess.Popen([sys.executable, "-c", "import time; "
                          "time.sleep(30)"], cwd=str(tmp_path))
    try:
        assert _pid_alive(p.pid) and _pid_matches(p.pid, str(tmp_path))
        assert not _pid_matches(p.pid, os.getcwd())
    finally:
        p.kill()
        p.wait()
    assert not _pid_alive(p.pid)


def test_record_counters():
    r0 = ttel.counter("mxnet_resilience_resumes_total").value
    f0 = ttel.counter("mxnet_resilience_fallbacks_total").value
    tres.record_resume()
    tres.record_fallback(2)
    assert ttel.counter("mxnet_resilience_resumes_total").value == r0 + 1
    assert ttel.counter("mxnet_resilience_fallbacks_total").value == f0 + 2
