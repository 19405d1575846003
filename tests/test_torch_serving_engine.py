"""The port's ``ServingEngine`` scheduling, hardening and telemetry held
against the JAX package's, on the same llama_tiny weights (vocab 101,
seed 7) and the workloads of ``tests/test_serving.py``:

- ``policy="static"`` gives the continuous policy's tokens (and the JAX
  engine's);
- ``load()`` is one (queue_depth, active_slots, free_blocks) snapshot,
  the reference's at every point of the same sequence;
- a blown deadline fails at submit with no prefill; a deadline that lapses
  while earlier admissions of the same iteration prefill skips its own
  prefill; ``stop()`` fails pending requests promptly;
- the SLO counters (admitted, completed, tokens, decode steps, prefills,
  positions, rejected, evicted, preempted) move by the reference's amounts
  over one workload, and the TTFT/TPOT/E2E/queue-wait histograms by the
  reference's counts;
- the request span tree (async ``b``/``n``/``e`` events keyed by request
  id, the ``serving.prefill`` and ``serving.decode_step`` spans with their
  rid links) has the reference's names, phases and nesting.
"""

import time

import numpy as np
import pytest

import mxnet_tpu as mx
from mxnet_tpu import serving as jserving
from mxnet_tpu import telemetry as jtel
from mxnet_tpu.base import MXNetError as JMXNetError
from mxnet_tpu.gluon.model_zoo import llama as jllama

from mxnet_tpu_torch import convert
from mxnet_tpu_torch import serving
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch import telemetry as ttel
from mxnet_tpu_torch.resilience import KVStoreTimeoutError

ERRORS = (JMXNetError, MXNetError)      # either package's
EOS = 2
ENGINE = dict(max_batch=4, block_tokens=4, max_seq=64, prefill_tokens=16)
PKGS = ((jserving, jtel), (serving, ttel))
COUNTERS = ("admitted", "completed", "tokens", "decode_steps", "prefills",
            "token_positions", "rejected", "evicted", "preempted")
HISTS = ("ttft", "tpot", "e2e", "queue_wait")


def _jax_net(name, vocab, seed):
    mx.random.seed(seed)
    np.random.seed(seed)
    net = jllama.llama_model(name, vocab_size=vocab, prefix="llm_")
    net.initialize(mx.initializer.Normal(0.05))
    net(mx.nd.array(np.zeros((1, 4), np.int32)))     # finish deferred init
    return net


@pytest.fixture(scope="module")
def nets():
    jnet = _jax_net("llama_tiny", 101, 7)
    params = {k: np.asarray(p.data().asnumpy(), np.float32)
              for k, p in jnet.collect_params().items()}
    return jnet, convert.llama_from_gluon(params, "llm_", "llama_tiny",
                                          device="cpu")


def _engine(pkg, nets, **kw):
    net = nets[0] if pkg is jserving else nets[1]
    kw = dict(ENGINE, **kw)
    return pkg.ServingEngine(net, eos_id=kw.pop("eos_id", EOS), **kw)


def _metric(tel, short):
    if short in COUNTERS:
        name = {"admitted": "requests_admitted", "completed":
                "requests_completed", "rejected": "requests_rejected",
                "evicted": "requests_evicted", "preempted":
                "requests_preempted"}.get(short, short)
        return tel.counter(f"mxnet_serving_{name}_total").value
    return tel.REGISTRY.get(f"mxnet_serving_{short}_seconds").count


def test_static_policy_same_tokens(nets):
    prompts = [[5, 9, 11], [7, 8, 9], [40, 41], [12, 13], [1, 2, 3]]
    outs = [_engine(pkg, nets, policy=policy).generate(prompts, 6)
            for pkg, _ in PKGS for policy in ("continuous", "static")]
    assert outs[0] == outs[1] == outs[2] == outs[3]
    with pytest.raises(ERRORS, match="policy"):
        _engine(serving, nets, policy="fifo")


def test_load_is_an_atomic_triple(nets):
    seqs = []
    for pkg, _ in PKGS:
        eng = _engine(pkg, nets)
        seq = [eng.load(), eng.free_slots]
        h = eng.submit([5, 6], max_new_tokens=4)
        seq.append(eng.load())
        eng.step()
        seq.append(eng.load())
        eng.drain()
        seq += [eng.load(), h.result(timeout=5)]
        seqs.append(seq)
    assert seqs[1] == seqs[0]
    total = seqs[1][0][2]
    assert seqs[1][:3] == [(0, 0, total), 4, (1, 0, total)]
    assert seqs[1][3][:2] == (0, 1) and seqs[1][4] == (0, 0, total)


def test_blown_deadline_fails_at_submit(nets):
    for pkg, tel in PKGS:
        eng = _engine(pkg, nets)
        p0 = _metric(tel, "prefills")
        h = eng.submit([5, 6, 7], max_new_tokens=4, deadline_s=-0.5)
        assert h.ready()
        with pytest.raises(pkg.RequestDeadlineExceeded):
            h.result(timeout=5)
        assert _metric(tel, "prefills") == p0


def test_deadline_lapsing_during_admission_skips_prefill(nets):
    for pkg, tel in PKGS:
        eng = _engine(pkg, nets)
        orig = eng.adapter.prefill
        calls = []

        def slow_prefill(slot, prompt, table_row, orig=orig, calls=calls):
            calls.append(slot)
            time.sleep(0.08)
            return orig(slot, prompt, table_row)

        eng.adapter.prefill = slow_prefill
        ha = eng.submit([5, 6], max_new_tokens=2)
        hb = eng.submit([7, 8], max_new_tokens=2, deadline_s=0.03)
        p0 = _metric(tel, "prefills")
        eng.step()       # A's 80 ms prefill lapses B's deadline
        with pytest.raises(pkg.RequestDeadlineExceeded):
            hb.result(timeout=5)
        assert _metric(tel, "prefills") == p0 + 1 and calls == [0]
        eng.drain()
        assert ha.result(timeout=5)


def test_stop_fails_pending_requests(nets):
    eng = _engine(serving, nets)
    h = eng.submit([5, 6, 7], max_new_tokens=8)
    eng.stop()
    with pytest.raises(serving.ServingError, match="abandoned"):
        h.result(timeout=5)
    assert h.stats()["e2e_s"] is not None
    assert eng.cache.free_blocks == eng.cache.allocator.num_blocks - 1
    late = eng.submit([8, 9], max_new_tokens=4)
    with pytest.raises(serving.ServingError, match="stopped"):
        late.result(timeout=5)
    # an unfinished request's wait is Deadline-bounded, not a hang
    eng2 = _engine(serving, nets)
    h2 = eng2.submit([5, 6], max_new_tokens=3)
    assert h2.wait(0.01) is False
    with pytest.raises(KVStoreTimeoutError, match="deadline"):
        h2.result(timeout=0.05)


def _workload(pkg, nets):
    """Rejections, an SLA eviction at submit, preemption under a small
    pool, more requests than slots."""
    eng = _engine(pkg, nets, eos_id=-1, max_batch=3, num_blocks=9)
    prompts = [[5, 9, 11], [7, 8, 9, 10, 3, 4], [40, 41], [12] * 9,
               [33, 2, 7], [64, 65, 66, 67]]
    hs = [eng.submit(p, max_new_tokens=10) for p in prompts]
    hs.append(eng.submit(list(range(3, 20)), max_new_tokens=4))  # too long
    hs.append(eng.submit([5, 6], max_new_tokens=4, deadline_s=-1.0))
    eng.drain()
    outs = []
    for h in hs:
        try:
            outs.append(h.result(timeout=5))
        except Exception as exc:  # noqa: BLE001 — compared across packages
            outs.append(type(exc).__name__)
    return outs


def test_slo_counters_equal_reference(nets):
    runs = []
    for pkg, tel in PKGS:
        before = {m: _metric(tel, m) for m in COUNTERS + HISTS}
        outs = _workload(pkg, nets)
        runs.append((outs, {m: _metric(tel, m) - before[m]
                            for m in COUNTERS + HISTS}))
    assert runs[1] == runs[0]
    outs, delta = runs[1]
    assert outs[-2:] == ["ServingError", "RequestDeadlineExceeded"]
    assert delta["preempted"] > 0 and delta["rejected"] == 1
    assert delta["evicted"] == 1 and delta["completed"] == 6
    assert delta["tokens"] == 60
    assert ttel.gauge("mxnet_serving_queue_depth").value == 0
    assert ttel.gauge("mxnet_serving_active_slots").value == 0


def _tree(tel):
    """Per request (in submit order): its async events' (name, ph), the
    end event's token count, and which requests each prefill and decode
    step span names, as request indices."""
    evs = tel.get_tracer().events()
    order = []
    for e in evs:
        if e.get("cat") == "serving.request" and e["ph"] == "b":
            order.append(e["id"])
    index = {rid: i for i, rid in enumerate(order)}
    trees = [[(e["name"], e["ph"]) for e in evs
              if e.get("cat") == "serving.request" and e.get("id") == rid]
             for rid in order]
    ends = [[e["args"]["tokens"] for e in evs
             if e.get("cat") == "serving.request" and e.get("id") == rid
             and e["ph"] == "e"] for rid in order]
    spans = [(e["name"],
              [index[str(r)] for r in e["args"]["rids"]]
              if e["name"] == "serving.decode_step"
              else [index[str(e["args"]["rid"])]])
             for e in evs if e.get("cat") == "serving"]
    stamps = [[e["ts"] for e in evs if e.get("cat") == "serving.request"
               and e.get("id") == rid] for rid in order]
    return trees, ends, spans, stamps


def test_request_span_tree_equals_reference(nets):
    runs = []
    for pkg, tel in PKGS:
        was = tel.enable()
        tel.get_tracer().clear()        # the trace buffer only
        try:
            eng = _engine(pkg, nets)
            h1, h2 = (eng.submit(p, max_new_tokens=4)
                      for p in ([5, 6], [7, 8]))
            eng.drain()
            assert h1.result(5) and h2.result(5)
            runs.append(_tree(tel))
        finally:
            tel.get_tracer().clear()
            if not was:
                tel.disable()
    (jt, je, js, _), (tt, te, ts, stamps) = runs
    assert (tt, te, ts) == (jt, je, js)
    for tree, st in zip(tt, stamps):
        assert tree[0] == ("request", "b") and tree[-1] == ("request", "e")
        assert {"admitted", "first_token"} <= {n for n, ph in tree
                                               if ph == "n"}
        assert st == sorted(st)
    assert {"serving.prefill", "serving.decode_step"} == {n for n, _ in ts}
