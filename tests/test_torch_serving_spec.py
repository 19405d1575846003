"""The port's speculative decoding held against the JAX package's.

- ``LlamaServingAdapter.decode_multi`` (the (B, K) verify) on the same
  pools, tables, positions and tokens as the reference's
  ``_llama_multi_decode_raw``: the argmax per column equal, the logits
  within 2e-5 absolute and the written pools within 2e-5 (f32; the two
  frameworks sum in another order);
- ``ServingEngine(draft_model=, spec_k=)`` tokens equal the JAX engine's,
  exactly, and the port's greedy re-encode, on the cases of
  ``tests/test_serving.py``: a mixed batch, early EOS inside an accepted
  run, preemption under pool pressure, an identical draft (k+1 tokens
  every verify dispatch, the accepted-draft histogram filled), and prefix
  caching with speculation together.  Weights:
  llama_tiny at vocab 101, target seed 7, divergent draft seed 23.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import mxnet_tpu as mx
from mxnet_tpu import serving as jserving
from mxnet_tpu import telemetry as jtel
from mxnet_tpu.gluon.model_zoo import llama as jllama
from mxnet_tpu.serving import models as jmodels

from mxnet_tpu_torch import convert
from mxnet_tpu_torch import serving
from mxnet_tpu_torch import telemetry as ttel
from mxnet_tpu_torch.serving import models as tmodels

EOS = 2
ENGINE = dict(max_batch=4, block_tokens=4, max_seq=64, prefill_tokens=16)
SYS12 = [30 + i for i in range(12)]
TOL = 2e-5


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
    jdraft = _jax_net("llama_tiny", 101, 23)
    return jnet, _port(jnet, "llama_tiny"), jdraft, _port(jdraft,
                                                          "llama_tiny")


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


class _ArgmaxTap:
    """``jax.numpy`` with ``argmax`` recording its input: the reference's
    serving functions get their ``jnp`` from ``models._jnp()``, so this
    reads the logits of an unjitted reference call without changing it."""

    def __init__(self):
        self.seen = []

    def __getattr__(self, name):
        return getattr(jnp, name)

    def argmax(self, x, *a, **kw):
        self.seen.append(np.asarray(x))
        return jnp.argmax(x, *a, **kw)


def test_decode_multi_matches_reference(nets, monkeypatch):
    jnet, port = nets[0], nets[1]
    B, K, T, NB, MB = 3, 4, 4, 24, 6
    r = np.random.RandomState(0)
    jad = jserving.LlamaServingAdapter(jnet, EOS, 16)
    tad = serving.LlamaServingAdapter(port, EOS, 16)
    jad.make_pools(NB, T)
    tad.make_pools(NB, T)
    shape = tad._kv[0][0].shape
    pools = [(r.normal(0, 0.5, shape).astype(np.float32),
              r.normal(0, 0.5, shape).astype(np.float32))
             for _ in range(tad.cfg.layers)]
    tables = np.zeros((B, MB), np.int32)
    tables[:, :5] = r.permutation(np.arange(1, NB))[:B * 5].reshape(B, 5)
    pos0 = np.array([3, 9, 0], np.int32)
    n_valid = np.array([4, 2, 3], np.int32)
    tokens = r.randint(3, 101, (B, K)).astype(np.int32)

    # the reference, unjitted, its argmax input read through the tap
    tap = _ArgmaxTap()
    monkeypatch.setattr(jmodels, "_jnp", lambda: tap)
    jkv = tuple((jnp.asarray(k), jnp.asarray(v)) for k, v in pools)
    new_kv, jg = jmodels._llama_multi_decode_raw(
        jad.cfg, jad.weights, jkv, jnp.asarray(tokens),
        jnp.asarray(tables), jnp.asarray(pos0), jnp.asarray(n_valid))
    monkeypatch.undo()
    jlogits = tap.seen[-1]
    # the reference's jitted entry, as its engine runs it
    _kv, jg_jit = jmodels._jitted()["llama_multi"](
        jad.cfg, jad.weights, jkv, jnp.asarray(tokens),
        jnp.asarray(tables), jnp.asarray(pos0), jnp.asarray(n_valid))

    tad._kv = tuple((torch.from_numpy(k.copy()), torch.from_numpy(v.copy()))
                    for k, v in pools)
    tg, tlogits = tmodels._llama_multi_decode_raw(
        tad.cfg, tad.weights, tad._kv, torch.from_numpy(tokens).long(),
        torch.from_numpy(tables).long(), torch.from_numpy(pos0).long(),
        torch.from_numpy(n_valid).long())
    assert tlogits.shape == (B, K, 101)
    np.testing.assert_allclose(tlogits.numpy(), jlogits, rtol=0, atol=TOL)
    assert tg.numpy().tolist() == np.asarray(jg).tolist() \
        == np.asarray(jg_jit).tolist()
    for (tk, tv), (jk, jv) in zip(tad._kv, new_kv):
        np.testing.assert_allclose(tk.numpy(), np.asarray(jk), atol=TOL)
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=TOL)
    # the adapter's entry point gives the same argmax from fresh pools
    tad._kv = tuple((torch.from_numpy(k.copy()), torch.from_numpy(v.copy()))
                    for k, v in pools)
    g = tad.decode_multi(tokens, tad.to_device(tables), pos0, n_valid)
    assert g.dtype == np.int32 and g.tolist() == tg.numpy().tolist()


def _engines(nets, draft, **kw):
    jnet, port, jdraft, tdraft = nets
    kw = dict(ENGINE, **kw)
    eos = kw.pop("eos_id", EOS)
    jd, td = {"target": (jnet, port), "divergent": (jdraft, tdraft)}[draft]
    return (jserving.ServingEngine(jnet, eos_id=eos, draft_model=jd, **kw),
            serving.ServingEngine(port, eos_id=eos, draft_model=td, **kw))


def test_spec_mixed_batch_equals_reference(nets):
    prompts = [[5, 9, 11], [7, 8, 9, 10, 3, 4], [40, 41], [12] * 9]
    jeng, teng = _engines(nets, "divergent", spec_k=3)
    want = jeng.generate(prompts, max_new_tokens=12)
    got = teng.generate(prompts, max_new_tokens=12)
    assert got == want
    assert got == [_ref_greedy(nets[1], p, 12) for p in prompts]
    jeng, teng = _engines(nets, "divergent", spec_k=2, max_batch=2)
    assert teng.generate([prompts[0]], max_new_tokens=10) \
        == jeng.generate([prompts[0]], max_new_tokens=10) \
        == [_ref_greedy(nets[1], prompts[0], 10)]


def test_spec_early_eos_equals_reference(nets):
    prompts = [[5, 9, 11], [7, 8, 9, 10, 3, 4], [40, 41], [12] * 9,
               [33, 2, 7], [90]]
    eos = _ref_greedy(nets[1], prompts[0], 10, eos=-1)[2]
    jeng, teng = _engines(nets, "divergent", eos_id=eos, max_batch=3,
                          spec_k=3)
    want = jeng.generate(prompts, max_new_tokens=10)
    got = teng.generate(prompts, max_new_tokens=10)
    assert got == want
    assert got == [_ref_greedy(nets[1], p, 10, eos=eos) for p in prompts]
    assert any(o[-1] == eos and len(o) < 10 for o in got)


def test_spec_preemption_equals_reference(nets):
    prompts = [[5, 9, 11, 13], [7, 8, 9, 10]]
    names = "mxnet_serving_requests_preempted_total"
    j0, t0 = jtel.counter(names).value, ttel.counter(names).value
    jeng, teng = _engines(nets, "divergent", eos_id=255, max_batch=2,
                          max_seq=16, num_blocks=5, spec_k=2)
    want = jeng.generate(prompts, max_new_tokens=10)
    got = teng.generate(prompts, max_new_tokens=10)
    assert got == want
    assert got == [_ref_greedy(nets[1], p, 10, eos=-1) for p in prompts]
    assert ttel.counter(names).value - t0 \
        == jtel.counter(names).value - j0 > 0


def _hist(reg, name):
    h = reg.get(name)
    return (h.count, list(h._raw()[1])) if h is not None else (0, None)


@pytest.mark.parametrize("max_new", [12, 33])
def test_spec_identical_draft_accepts_every_draft(nets, max_new):
    """A draft with the target's weights: tokens equal the reference's and
    greedy decoding, the accepted-draft histogram fills, and every verify
    dispatch emits k+1 tokens (its budget's worth at the end): after a
    verify that accepts every draft, the port's draft writes the K/V of
    its last proposal, which the reference leaves stale, so the
    reference may need more dispatches (ROADMAP C.7)."""
    prompts = [[5, 6, 7], [8, 9], [40, 41, 42, 43], [12] * 9]
    hname = "mxnet_serving_accepted_draft_tokens"
    runs = []
    for tel, eng in zip((jtel, ttel), _engines(nets, "target", spec_k=3,
                                               eos_id=-1)):
        t0 = tel.counter("mxnet_serving_tokens_total").value
        s0 = tel.counter("mxnet_serving_decode_steps_total").value
        c0, _b0 = _hist(tel.REGISTRY, hname)
        outs = eng.generate(prompts, max_new_tokens=max_new)
        runs.append((outs,
                     tel.counter("mxnet_serving_tokens_total").value - t0,
                     tel.counter("mxnet_serving_decode_steps_total").value
                     - s0, _hist(tel.REGISTRY, hname)[0] - c0))
    (want, jtoks, jsteps, _), (got, toks, steps, hcount) = runs
    assert got == want
    assert got == [_ref_greedy(nets[1], p, max_new, eos=-1, pad_to=48)
                   for p in prompts]
    assert toks == jtoks == len(prompts) * max_new
    assert steps == -(-(max_new - 1) // 4) <= jsteps
    assert hcount == steps * len(prompts)
    assert toks / steps >= 1.5


def test_prefix_and_spec_together_equal_reference(nets):
    prompts = [SYS12 + [77], SYS12 + [78], [1, 2, 3], SYS12 + [88],
               [9] * 7]
    jeng, teng = _engines(nets, "divergent", prefix_cache=True, spec_k=3)
    want = jeng.generate(prompts, max_new_tokens=9)
    got = teng.generate(prompts, max_new_tokens=9)
    assert got == want
    assert got == [_ref_greedy(nets[1], p, 9) for p in prompts]
    assert teng.cache.prefix_hits == jeng.cache.prefix_hits >= 2
