"""The port's BERT (``nn.Module``s) held against the JAX package's Gluon
BERT on the same weights, carried across with ``convert.bert_from_gluon``.

Outputs (sequence output, pooled, MLM logits) are compared in f32 at 2e-5
absolute: they are O(1) and the two frameworks sum matmuls in another
order.  At seq 16 both take the dense attention path; at seq 256 the port
takes the flash path (its plain version on the CPU) while the JAX net on
the CPU computes the dense path.
"""

import numpy as np
import pytest

import mxnet_tpu as mx
from mxnet_tpu.gluon.model_zoo import bert as jbert
import torch

from mxnet_tpu_torch import convert
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.gluon.model_zoo import bert as tbert
from mxnet_tpu_torch.gluon.model_zoo import llama as tllama
from mxnet_tpu_torch.ops import contrib as tcontrib

VOCAB = 97


def _jax_bert(seed, max_length=256):
    mx.random.seed(seed)
    np.random.seed(seed)
    net = jbert.bert_model("bert_3_128_2", vocab_size=VOCAB,
                           max_length=max_length, dropout=0.0,
                           prefix="bert_")
    net.initialize(mx.initializer.Normal(0.02))
    net(mx.nd.array(np.zeros((1, 4), np.int32)))     # finish deferred init
    return net


def _export(net):
    return {k: np.asarray(p.data().asnumpy(), np.float32)
            for k, p in net.collect_params().items()}


@pytest.fixture(scope="module")
def nets():
    net = _jax_bert(3)
    return net, convert.bert_from_gluon(_export(net), "bert_",
                                        "bert_3_128_2", device="cpu")


@pytest.mark.parametrize("L", [16, 256])
@pytest.mark.parametrize("padded", [False, True])
def test_bert_outputs_match_jax(nets, L, padded):
    jnet, port = nets
    assert tcontrib._flash_eligible(L, 64) == (L == 256)
    toks = np.random.RandomState(L).randint(0, VOCAB, (2, L)) \
        .astype(np.int32)
    vl = np.array([L - L // 4 - 1, L], np.int32) if padded else None
    args = [mx.nd.array(toks)] + ([mx.nd.array(vl)] if padded else [])
    want = [o.asnumpy() for o in jnet(*args)]
    with torch.no_grad():
        got = port(torch.tensor(toks),
                   None if vl is None else torch.tensor(vl))
    for name, w, g in zip(("sequence", "pooled", "logits"), want, got):
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=2e-5,
                                   err_msg=name)


def test_convert_rejects_missing_and_misshapen():
    params = _export(_jax_bert(5, max_length=64))
    short = dict(params)
    del short["bert_enc_layer2_ffn2_bias"]
    with pytest.raises(MXNetError, match="missing"):
        convert.bert_from_gluon(short, "bert_", "bert_3_128_2", device="cpu")
    bad = dict(params)
    bad["bert_pooler_weight"] = np.ones((128, 64), np.float32)
    with pytest.raises(MXNetError, match="shape"):
        convert.bert_from_gluon(bad, "bert_", "bert_3_128_2", device="cpu")
    extra = dict(params, bert_stray_weight=np.ones((2,), np.float32))
    with pytest.raises(MXNetError, match="unexpected"):
        convert.bert_from_gluon(extra, "bert_", "bert_3_128_2", device="cpu")


def test_bert_init_policy_and_trainable():
    """Normal weights and position table, zero biases and beta, unit gamma;
    every parameter trainable."""
    net = tbert.bert_model("bert_3_128_2", vocab_size=50, max_length=64,
                           device="cpu",
                           generator=torch.Generator().manual_seed(1))
    for name, p in net.named_parameters():
        assert p.requires_grad, name
        if name.endswith(("bias", "beta")):
            assert torch.all(p == 0), name
        elif name.endswith("gamma"):
            assert torch.all(p == 1), name
        else:
            assert 0.015 < float(p.detach().std()) < 0.025, name


def test_llama_parameters_trainable():
    """The zoo llama's parameters are trainable, as the reference's are
    (serving runs under ``torch.inference_mode`` and needs no freezing)."""
    net = tllama.llama_model("llama_tiny", vocab_size=50, device="cpu",
                             generator=torch.Generator().manual_seed(1))
    params = list(net.named_parameters())
    assert params
    for name, p in params:
        assert p.requires_grad, name
        assert p.is_leaf, name


def test_masked_selfatt_splits_heads_interleaved():
    """qkv (L, B, 3 H D) is [q, k, v] per head: with k = 0 attention is a
    uniform average of v, which must come from the v slot of each head."""
    L, B, H, D = 16, 1, 2, 8
    x = torch.zeros(L, B, H, 3, D)
    x[:, :, 0, 2] = 1.0          # head 0: v = 1
    x[:, :, 1, 2] = 2.0          # head 1: v = 2
    x[:, :, :, 0] = 5.0          # q ignored when k = 0
    out = tcontrib.masked_selfatt(x.reshape(L, B, 3 * H * D), heads=H)
    assert out.shape == (L, B, H * D)
    torch.testing.assert_close(out[..., :D], torch.ones(L, B, D))
    torch.testing.assert_close(out[..., D:], torch.full((L, B, D), 2.0))


def test_dropout_is_seeded_and_off_in_eval():
    net = tbert.bert_model("bert_3_128_2", vocab_size=50, max_length=64,
                           dropout=0.5, device="cpu",
                           generator=torch.Generator().manual_seed(1),
                           dropout_generator=torch.Generator().manual_seed(9))
    toks = torch.randint(0, 50, (2, 16), generator=torch.Generator()
                         .manual_seed(2))
    net.eval()
    a, b = net(toks)[2], net(toks)[2]
    assert torch.equal(a, b)
    net.train()
    c = net(toks)[2]
    assert not torch.equal(a, c)
