"""The port's llama (``nn.Module``s) held against the JAX package's Gluon
llama on the same weights, carried across with ``convert.llama_from_gluon``.

Logits are compared in f32 at 2e-5 absolute (logits are O(1); the two
frameworks sum matmuls in another order).
"""

import numpy as np
import pytest

import mxnet_tpu as mx
from mxnet_tpu.gluon.model_zoo import llama as jllama
import torch

from mxnet_tpu_torch import convert
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.gluon.model_zoo import llama as tllama
from mxnet_tpu_torch.ops import contrib as tcontrib


def _jax_net(name, vocab, seed):
    mx.random.seed(seed)
    np.random.seed(seed)
    net = jllama.llama_model(name, vocab_size=vocab, prefix="llm_")
    net.initialize(mx.initializer.Normal(0.05))
    net(mx.nd.array(np.zeros((1, 4), np.int32)))     # finish deferred init
    return net


def _export(net):
    return {k: np.asarray(p.data().asnumpy(), np.float32)
            for k, p in net.collect_params().items()}


@pytest.fixture(scope="module")
def jax_nets():
    return {"llama_tiny": _jax_net("llama_tiny", 101, 3),
            "llama_small": _jax_net("llama_small", 64, 3)}


@pytest.mark.parametrize("name,vocab,L", [("llama_tiny", 101, 16),
                                          ("llama_small", 64, 24)])
def test_llama_logits_match_jax(jax_nets, name, vocab, L):
    net = jax_nets[name]
    port = convert.llama_from_gluon(_export(net), "llm_", name, device="cpu")
    toks = np.random.RandomState(5).randint(0, vocab, (2, L)) \
        .astype(np.int32)
    want = net(mx.nd.array(toks)).asnumpy()
    with torch.no_grad():
        got = port(torch.tensor(toks)).numpy()
    assert got.shape == want.shape == (2, L, vocab)
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-5)


def test_llama_flash_path_matches_jax_dense():
    """At L=256 the port's attention takes the flash path (its plain
    version on the CPU) while the JAX net on the CPU computes the dense
    path: same logits."""
    assert tcontrib._flash_eligible(256, 16)
    net = _jax_net("llama_tiny", 101, 4)
    port = convert.llama_from_gluon(_export(net), "llm_", "llama_tiny",
                                    device="cpu")
    toks = np.random.RandomState(6).randint(0, 101, (1, 256)) \
        .astype(np.int32)
    want = net(mx.nd.array(toks)).asnumpy()
    with torch.no_grad():
        got = port(torch.tensor(toks)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-5)


def test_convert_rejects_missing_and_misshapen():
    params = _export(_jax_net("llama_tiny", 101, 5))
    short = dict(params)
    del short["llm_layer1_down_weight"]
    with pytest.raises(MXNetError, match="missing"):
        convert.llama_from_gluon(short, "llm_", "llama_tiny", device="cpu")
    bad = dict(params)
    bad["llm_final_norm_weight"] = np.ones((63,), np.float32)
    with pytest.raises(MXNetError, match="shape"):
        convert.llama_from_gluon(bad, "llm_", "llama_tiny", device="cpu")


def test_gqa_uses_repeat_interleave_order():
    """kv head j serves query heads j*g .. j*g+g-1 (jnp.repeat order)."""
    k = torch.arange(2.0).reshape(1, 2, 1, 1).expand(1, 2, 256, 16)
    q = torch.zeros(1, 4, 256, 16)
    out = tcontrib.masked_att_qkv(q, k, k, num_kv_groups=2, causal=True)
    assert out[0, :, 0, 0].tolist() == [0.0, 0.0, 1.0, 1.0]


def test_model_init_is_seeded_and_needs_a_device():
    a = tllama.llama_model("llama_tiny", vocab_size=50, device="cpu",
                           generator=torch.Generator().manual_seed(1))
    b = tllama.llama_model("llama_tiny", vocab_size=50, device="cpu",
                           generator=torch.Generator().manual_seed(1))
    for pa, pb in zip(a.parameters(), b.parameters()):
        assert torch.equal(pa, pb)
    assert torch.all(a.norm.weight == 1.0)
    if not torch.cuda.is_available():
        with pytest.raises(MXNetError, match="no CUDA device"):
            tllama.llama_model("llama_tiny", vocab_size=50)
