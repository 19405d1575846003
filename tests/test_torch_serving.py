"""The port's serving slice held against the JAX package's.

- ``ServingEngine.generate`` tokens of the port == the JAX engine's, token
  for token, on the same llama_tiny weights (vocab 101, seed 7) and the
  prompts of tests/test_serving.py (exact equality, no tolerance);
- one llama_small prefill at P = 256, where the port's attention takes the
  flash path (its plain version on the CPU) and the JAX serving prefill
  the dense path: logits within 2e-5 absolute (f32, other summation
  order);
- the port-only parts: host cache bookkeeping, preemption, SLA eviction,
  rejection, async mode and the features that are not ported yet.
"""

import threading
import time

import numpy as np
import pytest

import jax.numpy as jnp
import mxnet_tpu as mx
from mxnet_tpu import serving as jserving
from mxnet_tpu.gluon.model_zoo import llama as jllama
import torch

from mxnet_tpu_torch import convert
from mxnet_tpu_torch import serving
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.serving.cache import BlockAllocator, CacheOOMError

EOS = 2


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


ENGINE = dict(max_batch=4, block_tokens=4, max_seq=64, prefill_tokens=16)
PROMPTS = [[5, 9, 11], [7, 8, 9, 10, 3, 4], [40, 41], [12] * 9]


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


def test_generate_token_identical_to_jax(nets):
    jnet, port = nets
    want = jserving.ServingEngine(jnet, eos_id=EOS, **ENGINE).generate(
        PROMPTS, max_new_tokens=12)
    got = serving.ServingEngine(port, eos_id=EOS, **ENGINE).generate(
        PROMPTS, max_new_tokens=12)
    assert got == want


def test_generate_with_preemption_token_identical_to_jax(nets):
    """An oversubscribed pool (preemption-by-recompute) and more requests
    than slots: still the JAX engine's tokens."""
    jnet, port = nets
    prompts = PROMPTS + [[33, 2, 7], [64, 65, 66, 67], [90], [13, 37]]
    kw = dict(ENGINE, max_batch=3, num_blocks=9)
    want = jserving.ServingEngine(jnet, eos_id=-1, **kw).generate(
        prompts, max_new_tokens=10)
    eng = serving.ServingEngine(port, eos_id=-1, **kw)
    handles = [eng.submit(p, max_new_tokens=10) for p in prompts]
    eng.drain()
    assert [h.result(timeout=1) for h in handles] == want
    assert sum(h.stats()["preempts"] for h in handles) > 0


@pytest.mark.parametrize("block_tokens", [2, 8])
def test_block_sizes_token_identical_to_reencode(nets, block_tokens):
    _jnet, port = nets
    eng = serving.ServingEngine(port, eos_id=EOS,
                                **dict(ENGINE, block_tokens=block_tokens))
    prompts = [[3, 1, 4, 1, 5], [9, 2, 6]]
    for p, got in zip(prompts, eng.generate(prompts, max_new_tokens=9)):
        assert got == _ref_greedy(port, p, 9), p


def test_llama_small_prefill_flash_matches_jax_dense():
    """P = 256: the port's prefill attention goes through _attend's flash
    path, the JAX serving prefill through _dense_sdpa."""
    jnet = _jax_net("llama_small", 64, 11)
    port = _port(jnet, "llama_small")
    prompt = np.random.RandomState(12).randint(3, 64, 200).tolist()
    jad = jserving.LlamaServingAdapter(jnet, EOS, 256)
    jad.make_pools(20, 16)
    row = np.arange(1, 17, dtype=np.int32)
    _kv, jnxt, jlogits = jserving.models._jitted()["llama_prefill"](
        jad.cfg, jad.weights, jad._kv, jnp.asarray(jad.pad_prompt(prompt)),
        jnp.asarray(np.array([len(prompt)], np.int32)), jnp.asarray(row))
    tad = serving.LlamaServingAdapter(port, EOS, 256)
    tad.make_pools(20, 16)
    tnxt, tlogits = tad.prefill_logits(prompt, row)
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits),
                               rtol=0, atol=2e-5)
    assert tnxt == int(jnxt)


# -- port-only behaviour -----------------------------------------------------

def test_block_allocator_alloc_free_oom():
    a = BlockAllocator(6)
    got = a.alloc(3)
    assert len(got) == 3 and a.free_blocks == 2 and 0 not in got
    with pytest.raises(CacheOOMError):
        a.alloc(3)
    a.free(got)
    with pytest.raises(MXNetError, match="double free"):
        a.free(got[:1])
    with pytest.raises(MXNetError, match="invalid block"):
        a.free([0])


def test_paged_cache_admit_release_reuse():
    c = serving.PagedKVCache(max_batch=2, max_blocks_per_seq=4,
                             block_tokens=4, num_blocks=9)
    blocks = c.admit(0, 7)
    assert len(blocks) == 2 and c.free_blocks == 6
    c.ctx_len[0] = 8
    c.ensure_capacity(0)                  # pos 8 opens block 2
    assert c.free_blocks == 5
    freed = c.release(0)
    assert len(freed) == 3 and (c.tables[0] == 0).all()
    assert c.admit(1, 4)[0] in freed      # LIFO reuse
    with pytest.raises(CacheOOMError):
        c.admit(0, 17)                    # 5 blocks > max_blocks_per_seq


def test_unported_features_raise(nets):
    _jnet, port = nets
    with pytest.raises(MXNetError, match="prefix caching"):
        serving.ServingEngine(port, eos_id=EOS, prefix_cache=True, **ENGINE)
    with pytest.raises(MXNetError, match="speculative"):
        serving.ServingEngine(port, eos_id=EOS, draft_model=port, **ENGINE)

    class TransformerModel(torch.nn.Module):
        pass

    with pytest.raises(MXNetError, match="not yet ported"):
        serving.make_adapter(TransformerModel(), eos_id=EOS)


def test_submit_rejects_misfits_and_evicts_expired(nets):
    _jnet, port = nets
    eng = serving.ServingEngine(port, eos_id=EOS, **ENGINE)
    too_long = eng.submit(list(range(3, 20)), max_new_tokens=4)
    with pytest.raises(serving.ServingError, match="cannot fit"):
        too_long.result(timeout=1)
    late = eng.submit([5, 6], max_new_tokens=4, deadline_s=-1)
    with pytest.raises(serving.RequestDeadlineExceeded):
        late.result(timeout=1)
    with pytest.raises(MXNetError, match="max_new_tokens"):
        eng.submit([5], max_new_tokens=0)


def test_async_start_submit_stop(nets):
    _jnet, port = nets
    eng = serving.ServingEngine(port, eos_id=EOS, **ENGINE)
    eng.start()
    try:
        handles = [eng.submit(p, max_new_tokens=6) for p in PROMPTS]
        outs = [h.result(timeout=60) for h in handles]
    finally:
        eng.stop()
    assert outs == [_ref_greedy(port, p, 6) for p in PROMPTS]
    assert all(h.stats()["ttft_s"] is not None for h in handles)
    assert not any(t.name == "mx-serving" for t in threading.enumerate())
    after = eng.submit([5], max_new_tokens=2)
    with pytest.raises(serving.ServingError, match="engine stopped"):
        after.result(timeout=1)


def test_copy_block_and_unfinished_result(nets):
    """copy_block duplicates one pool block in every layer (in place);
    a request nobody drives times out as ServingError, not a hang."""
    _jnet, port = nets
    eng = serving.ServingEngine(port, eos_id=EOS, **ENGINE)
    ad = eng.adapter
    for kp, vp in ad._kv:
        kp[3] = 1.5
        vp[3] = -2.0
    ad.copy_block(7, 3)
    for kp, vp in ad._kv:
        assert torch.all(kp[7] == 1.5) and torch.all(vp[7] == -2.0)
    h = eng.submit([5, 6], max_new_tokens=3)
    with pytest.raises(serving.ServingError, match="not finished"):
        h.result(timeout=0.05)
    assert eng.generate([[5, 6]], max_new_tokens=3)[0] == h.result(timeout=1)


@pytest.mark.parametrize("where", ["queued", "decoding"])
def test_sla_eviction(nets, where):
    """A request past its deadline is failed wherever it sits, and its
    blocks go back to the pool."""
    _jnet, port = nets
    eng = serving.ServingEngine(port, eos_id=-1, **ENGINE)
    free0 = eng.cache.free_blocks
    h = eng.submit([5, 6, 7], max_new_tokens=20, deadline_s=0.05)
    if where == "decoding":
        eng.step()                        # admitted + one decode step
        assert h.stats()["tokens"] == 2
    time.sleep(0.06)
    eng.drain()
    with pytest.raises(serving.RequestDeadlineExceeded, match=where):
        h.result(timeout=1)
    assert eng.cache.free_blocks == free0
