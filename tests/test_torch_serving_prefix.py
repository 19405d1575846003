"""The port's prefix cache held against the JAX package's.

- the cache bookkeeping of ``tests/test_serving.py``'s prefix unit test
  (registration, full-block sharing with refcounts, copy-on-write pairs,
  LRU eviction of refcount-0 blocks), step by step against the reference's
  ``PagedKVCache`` on the same calls: tables, refcounts, the prefix index's
  blocks, the free list and every tally equal;
- ``ServingEngine(prefix_cache=True)`` tokens equal the JAX engine's,
  exactly, on the same llama_tiny weights (vocab 101, seed 7) for the
  cases of ``tests/test_serving.py``: a shared-system-prompt hit, COW on
  the block next to the scratch-padded table tail, preemption of shared
  blocks, and an eviction racing a readmission; and equal the port's own
  greedy re-encode;
- the tallies (``prefix_hits``, ``prefix_hit_tokens``, ``cow_copies``,
  ``evictions``) and the prefill-position counter equal the reference's
  after the same workload.
"""

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import serving as jserving
from mxnet_tpu import telemetry as jtel
from mxnet_tpu.gluon.model_zoo import llama as jllama

from mxnet_tpu_torch import convert
from mxnet_tpu_torch import serving
from mxnet_tpu_torch import telemetry as ttel

EOS = 2
ENGINE = dict(max_batch=4, block_tokens=4, max_seq=64, prefill_tokens=16)
SYS12 = [30 + i for i in range(12)]       # 3 full blocks at T=4


def _jax_net(name, vocab, seed):
    mx.random.seed(seed)
    np.random.seed(seed)
    net = jllama.llama_model(name, vocab_size=vocab, prefix="llm_")
    net.initialize(mx.initializer.Normal(0.05))
    net(mx.nd.array(np.zeros((1, 4), np.int32)))     # finish deferred init
    return net


def _port(net, name):
    params = {k: np.asarray(p.data().asnumpy(), np.float32)
              for k, p in net.collect_params().items()}
    return convert.llama_from_gluon(params, "llm_", name, device="cpu")


@pytest.fixture(scope="module")
def nets():
    jnet = _jax_net("llama_tiny", 101, 7)
    return jnet, _port(jnet, "llama_tiny")


def _ref_greedy(port, prompt, max_new, eos=EOS, pad_to=32):
    """Full re-encode greedy decode on the port's own model."""
    buf = torch.zeros((1, pad_to), dtype=torch.long)
    buf[0, :len(prompt)] = torch.tensor(prompt)
    n, out = len(prompt), []
    with torch.no_grad():
        for _ in range(max_new):
            nxt = int(port(buf)[0, n - 1].argmax())
            out.append(nxt)
            if nxt == eos:
                break
            buf[0, n] = nxt
            n += 1
    return out


# -- the cache bookkeeping ---------------------------------------------------

def _state(c):
    return {
        "tables": c.tables.tolist(), "ctx_len": c.ctx_len.tolist(),
        "owned": [list(o) for o in c._owned],
        "refcount": dict(c._refcount),
        "index_blocks": sorted(c._prefix.values()),
        "cached_lru": list(c._cached_lru),
        "free": list(c.allocator._free),
        "tallies": (c.prefix_hits, c.prefix_hit_tokens, c.cow_copies,
                    c.evictions, c.cached_blocks, c.free_blocks, c.version),
    }


def test_cache_bookkeeping_matches_reference():
    """The calls of the reference's prefix unit test, on both caches:
    every return value and the whole state after each call agree."""
    kw = dict(max_batch=3, max_blocks_per_seq=4, block_tokens=4,
              num_blocks=6, prefix_cache=True)
    caches = (jserving.PagedKVCache(**kw), serving.PagedKVCache(**kw))
    prompt = list(range(10, 20))          # 10 tokens = 2 full blocks + 2
    steps = [
        ("admit", (0, 10, prompt)), ("register_prefix", (0, prompt)),
        ("admit", (1, 10, prompt)),       # shares the 2 full blocks
        ("prepare_write", (1, 5)),        # COW of the shared second block
        ("prepare_write", (0, 5)),        # sole owner: no copy
        ("release", (0,)), ("release", (1,)),   # park on the cached LRU
        ("admit", (2, 16)),               # pressure: LRU eviction
        ("release", (2,)),
        ("match_prefix", (prompt,)),      # the first block survives
        ("admit", (0, 9, prompt)), ("ensure_capacity", (0, 4)),
        ("advance", (0, 3)), ("release", (0,)),
    ]
    for name, args in steps:
        outs = [getattr(c, name)(*args) for c in caches]
        assert outs[0] == outs[1], (name, outs)
        assert _state(caches[0]) == _state(caches[1]), name
    j, t = caches
    assert (t.prefix_hits, t.prefix_hit_tokens, t.cow_copies,
            t.evictions) == (2, 12, 1, 1)
    assert t.match_prefix(prompt) == j.match_prefix(prompt)


# -- engine tokens against the JAX engine ------------------------------------

def _delta(counters, fn):
    before = [c.value for c in counters]
    out = fn()
    return out, [c.value - b for c, b in zip(counters, before)]


def _both(nets, prompts, max_new, **kw):
    """(JAX tokens, port tokens, JAX engine, port engine, JAX counter
    deltas, port counter deltas) of one generate on fresh engines."""
    jnet, port = nets
    names = ("mxnet_serving_prefill_positions_total",
             "mxnet_serving_prefix_hits_total",
             "mxnet_serving_prefix_hit_tokens_total",
             "mxnet_serving_prefix_cow_total",
             "mxnet_serving_prefix_evictions_total")
    jc = [jtel.counter(n) for n in names]
    tc = [ttel.counter(n) for n in names]
    kw = dict(ENGINE, **kw)
    eos = kw.pop("eos_id", EOS)
    jeng = jserving.ServingEngine(jnet, eos_id=eos, **kw)
    teng = serving.ServingEngine(port, eos_id=eos, **kw)
    want, jd = _delta(jc, lambda: jeng.generate(prompts, max_new))
    got, td = _delta(tc, lambda: teng.generate(prompts, max_new))
    return want, got, jeng, teng, jd, td


def _tallies(eng):
    c = eng.cache
    return (c.prefix_hits, c.prefix_hit_tokens, c.cow_copies, c.evictions,
            c.cached_blocks)


def test_prefix_hit_tokens_and_tallies_equal_reference(nets):
    prompts = [SYS12 + [60 + i] for i in range(5)]
    want, got, jeng, teng, jd, td = _both(nets, prompts, 8,
                                          prefix_cache=True)
    assert got == want
    assert got == [_ref_greedy(nets[1], p, 8) for p in prompts]
    assert _tallies(teng) == _tallies(jeng)
    assert teng.cache.prefix_hits == 4
    assert td == jd
    # 1 cold padded prefill + 4 one-block tail chunks
    assert td[0] == teng.adapter.prefill_tokens + 4 * teng.block_tokens


def test_prefix_cow_on_scratch_adjacent_block_equals_reference(nets):
    """The same block-aligned prompt twice in one batch: the sharer's
    boundary chunk writes the last shared block -> copy-on-write; a
    partial third block needs no copy."""
    p8 = [3, 1, 4, 1, 5, 9, 2, 6]
    want, got, jeng, teng, jd, td = _both(nets, [p8, list(p8)], 8,
                                          prefix_cache=True)
    assert got == want == [_ref_greedy(nets[1], p8, 8)] * 2
    assert teng.cache.cow_copies >= 1
    assert _tallies(teng) == _tallies(jeng) and td == jd
    p9 = p8 + [7]
    want, got, jeng, teng, jd, td = _both(nets, [p9, list(p9)], 8,
                                          prefix_cache=True)
    assert got == want
    assert teng.cache.cow_copies == 0 and teng.cache.prefix_hits == 1
    assert _tallies(teng) == _tallies(jeng) and td == jd


def test_prefix_preemption_of_shared_blocks_equals_reference(nets):
    sysp = [40 + i for i in range(8)]
    prompts = [sysp + [70], sysp + [71]]
    kw = dict(eos_id=255, max_batch=2, max_seq=16, num_blocks=6,
              prefix_cache=True)
    pre = (jtel.counter("mxnet_serving_requests_preempted_total"),
           ttel.counter("mxnet_serving_requests_preempted_total"))
    p0 = [c.value for c in pre]
    want, got, jeng, teng, jd, td = _both(nets, prompts, 6, **kw)
    assert got == want
    assert got == [_ref_greedy(nets[1], p, 6, eos=-1) for p in prompts]
    assert [c.value - v for c, v in zip(pre, p0)][1] \
        == [c.value - v for c, v in zip(pre, p0)][0] > 0
    assert _tallies(teng) == _tallies(jeng) and td == jd
    assert teng.cache.prefix_hits >= 1


def test_prefix_eviction_racing_readmission_equals_reference(nets):
    """An unrelated admission evicts the cached prefix between a request's
    first run and its resubmission: the resubmit runs cold, with the
    reference's tokens and tallies."""
    jnet, port = nets
    kw = dict(max_batch=1, block_tokens=4, max_seq=24, prefill_tokens=16,
              num_blocks=6, prefix_cache=True)
    engines = (jserving.ServingEngine(jnet, eos_id=EOS, **kw),
               serving.ServingEngine(port, eos_id=EOS, **kw))
    pa = [5, 6, 7, 8, 9, 10, 11, 12]
    pb = list(range(50, 66))
    runs = []
    for eng in engines:
        ra = eng.generate([pa], max_new_tokens=4)[0]
        cached = eng.cache.cached_blocks
        eng.generate([pb], max_new_tokens=4)
        hits0 = eng.cache.prefix_hits
        rb = eng.generate([pa], max_new_tokens=4)[0]
        runs.append((ra, rb, cached, eng.cache.prefix_hits - hits0,
                     _tallies(eng)))
    assert runs[1] == runs[0]
    ra, rb, cached, new_hits, tallies = runs[1]
    assert ra == rb == _ref_greedy(port, pa, 4)
    assert cached == 2 and tallies[3] >= 1 and new_hits == 0
