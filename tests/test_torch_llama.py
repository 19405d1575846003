"""The port's Gluon llama held against the JAX package's on the same
weights, carried across by name (``convert.llama_from_gluon``) or by the
reference's ``.params`` file (``load_parameters``).

Logits are compared in f32 at 2e-5 absolute (logits are O(1); the two
frameworks sum matmuls in another order).
"""

import numpy as np
import pytest

import mxnet_tpu as mx
from mxnet_tpu.gluon.model_zoo import llama as jllama
import torch

import mxnet_tpu_torch as tmx
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


def _norms_one(std):
    return tmx.init.Mixed([".*norm_weight", ".*"],
                          [tmx.init.One(), tmx.init.Normal(std)])


def test_model_init_is_seeded_and_needs_a_device():
    """``initialize`` fills the Gluon llama on the given context from that
    device's generator: one seed gives one net, the norms stay ones under a
    Mixed initializer, and with no card the default context raises."""
    def build():
        tmx.random.seed(1)
        net = tllama.llama_model("llama_tiny", vocab_size=50)
        net.initialize(_norms_one(0.02), ctx=tmx.cpu())
        return net

    a, b = build(), build()
    pa, pb = a.collect_params(), b.collect_params()
    assert len(pa) == len(pb) == 2 + 2 * 9 + 1
    for (na, x), (nb, y) in zip(pa.items(), pb.items()):
        assert na.split("_", 1)[1] == nb.split("_", 1)[1]
        assert torch.equal(x.data()._data, y.data()._data), na
    assert torch.all(a.norm.weight.data()._data == 1.0)
    assert a.embed.weight.data()._data.std() > 0.01
    if not torch.cuda.is_available():
        with pytest.raises(MXNetError, match="no CUDA device"):
            tllama.llama_model("llama_tiny", vocab_size=50).initialize()


def test_load_parameters_of_the_reference_file(tmp_path):
    """A ``.params`` file the JAX llama saved (its structural names) loads
    into the port's llama, built under another prefix; logits as by
    name."""
    net = _jax_net("llama_tiny", 101, 8)
    f = str(tmp_path / "llama.params")
    net.save_parameters(f)
    port = tllama.llama_model("llama_tiny", vocab_size=101, prefix="other_")
    port.load_parameters(f, ctx=tmx.cpu())
    by_name = convert.llama_from_gluon(_export(net), "llm_", "llama_tiny",
                                       device="cpu")
    toks = np.random.RandomState(9).randint(0, 101, (2, 12)) \
        .astype(np.int32)
    want = net(mx.nd.array(toks)).asnumpy()
    for p in (port, by_name):
        got = p(tmx.nd.array(toks, ctx=tmx.cpu())).asnumpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=2e-5)


def test_save_load_round_trip_is_bit_exact(tmp_path):
    tmx.random.seed(3)
    a = tllama.llama_model("llama_tiny", vocab_size=50)
    a.initialize(_norms_one(0.05), ctx=tmx.cpu())
    f = str(tmp_path / "a.params")
    a.save_parameters(f)
    b = tllama.llama_model("llama_tiny", vocab_size=50)
    b.load_parameters(f, ctx=tmx.cpu())
    for x, y in zip(a.collect_params().values(),
                    b.collect_params().values()):
        assert torch.equal(x.data()._data, y.data()._data)


@pytest.mark.parametrize("kwargs,match", [
    ({"attn_impl": "dense"}, "attn_impl"),
    ({"attn_impl": "Ring"}, "attn_impl"),
    ({"remat": True, "attn_impl": "flash"}, "attn_impl")])
def test_unported_options_raise(kwargs, match):
    """"fused", "ring" and "ulysses" are the implementations (ring and
    Ulysses: ``tests/test_torch_sp_llama.py``); any other name raises, as
    in the reference."""
    with pytest.raises(MXNetError, match=match):
        tllama.llama_model("llama_tiny", vocab_size=50, **kwargs)
    with pytest.raises(mx.MXNetError, match="want fused"):
        jllama.llama_model("llama_tiny", vocab_size=50, **kwargs)


def test_backward_do_mirror_raises(monkeypatch):
    """MXNET_BACKWARD_DO_MIRROR no longer raises: it is remat's default,
    and an explicit ``remat`` wins over it."""
    monkeypatch.setenv("MXNET_BACKWARD_DO_MIRROR", "1")
    assert tllama.llama_model("llama_tiny", vocab_size=50)._remat
    assert not tllama.llama_model("llama_tiny", vocab_size=50,
                                  remat=False)._remat
    monkeypatch.setenv("MXNET_BACKWARD_DO_MIRROR", "0")
    assert not tllama.llama_model("llama_tiny", vocab_size=50)._remat


def test_hybridized_and_imperative_forward_agree():
    """The tensor path (hybridized) and the NDArray path (every op through
    the registry) give the same logits, and the imperative path records
    gradients for every parameter."""
    tmx.random.seed(4)
    net = tllama.llama_model("llama_tiny", vocab_size=50)
    net.initialize(_norms_one(0.05), ctx=tmx.cpu())
    x = tmx.nd.array(np.random.RandomState(2).randint(0, 50, (2, 8)),
                     ctx=tmx.cpu())
    with tmx.autograd.record():
        want = net(x)
        want.sum().backward()
    grads = [p.grad().asnumpy() for p in net.collect_params().values()]
    assert all(np.abs(g).sum() > 0 for g in grads)
    net.hybridize()
    np.testing.assert_allclose(net(x).asnumpy(), want.asnumpy(), rtol=0,
                               atol=1e-6)
