"""The port's transformer MT model (``gluon.model_zoo.transformer``) held
against the JAX package's at ``transformer_test`` size (2 + 2 layers, 64
units, 4 heads), f32, on the same weights set by name: logits, the
label-smoothed loss and its gradients with and without source lengths,
``encode`` + ``decode_from_memory`` against the full forward, greedy and
beam-search tokens, and the parameter names one to one (so
``convert.load_by_name`` carries the reference's weights).

Tolerance: 1e-4 relative to each tensor's max |ref| (f32; the two
frameworks sum matmuls and softmaxes in another order).  Below the flash
floor (length 256) both take the dense attention path.
"""

import numpy as np
import pytest

import mxnet_tpu as mx
from mxnet_tpu import autograd as jautograd
from mxnet_tpu.gluon.loss import LabelSmoothedCELoss as JLSCE
from mxnet_tpu.gluon.model_zoo import transformer as jtr

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import convert
from mxnet_tpu_torch.gluon.loss import LabelSmoothedCELoss as TLSCE
from mxnet_tpu_torch.gluon.model_zoo import transformer as ttr

V, B, LS, LT = 40, 3, 12, 10
TOL = 1e-4


@pytest.fixture(autouse=True)
def _on_cpu():
    with tmx.cpu():
        yield


def _weights(net, seed=0):
    r = np.random.RandomState(seed)
    out = {}
    for k, p in net.collect_params().items():
        w = r.normal(0.0, 0.3 if k.endswith("embed_weight") else 0.15,
                     p.shape).astype(np.float32)
        if k.endswith(("bias", "beta")):
            w[...] = 0.01
        elif k.endswith("gamma"):
            w[...] = 1.0
        out[k] = w
    return out


@pytest.fixture(scope="module")
def pair():
    """(JAX net, port net) on the same weights, dropout 0."""
    jnet = jtr.transformer_model("transformer_test", vocab_size=V,
                                 max_length=64, dropout=0.0, prefix="mt_")
    jnet.initialize(mx.initializer.Zero())
    w = _weights(jnet)
    for k, p in jnet.collect_params().items():
        p.set_data(mx.nd.array(w[k]))
    tnet = ttr.transformer_model("transformer_test", vocab_size=V,
                                 max_length=64, dropout=0.0, prefix="mt_")
    convert.load_by_name(tnet, w, device="cpu")
    return jnet, tnet


def _batch(seed=1):
    r = np.random.RandomState(seed)
    src = r.randint(3, V, (B, LS)).astype(np.int32)
    tgt = r.randint(3, V, (B, LT)).astype(np.int32)
    lab = r.randint(3, V, (B, LT)).astype(np.int32)
    lab[1, 6:] = 0                       # target padding, ignored
    vl = np.array([12, 7, 4], np.int32)
    return src, tgt, lab, vl


def _close(got, want, what):
    scale = max(float(np.abs(want).max()), 1e-12)
    err = float(np.abs(got - want).max())
    assert err <= TOL * scale, f"{what}: {err} vs {TOL} x {scale}"


def test_parameter_names_match_one_to_one(pair):
    jnet, tnet = pair
    jp, tp = jnet.collect_params(), tnet.collect_params()
    assert sorted(jp.keys()) == sorted(tp.keys())
    assert {k: tuple(p.shape) for k, p in jp.items()} == \
        {k: tuple(p.shape) for k, p in tp.items()}
    assert [k for k in tp.keys() if k.endswith("embed_weight")] == \
        ["mt_embed_weight"]           # one table: source, target, output


@pytest.mark.parametrize("lengths", [False, True], ids=["all", "valid"])
@pytest.mark.parametrize("hybridize", [False, True])
def test_logits_loss_and_gradients_match_jax(pair, lengths, hybridize):
    jnet, tnet = pair
    tnet.hybridize(hybridize)
    src, tgt, lab, vl = _batch()
    jin = [mx.nd.array(src), mx.nd.array(tgt)] + \
        ([mx.nd.array(vl)] if lengths else [])
    tin = [tmx.nd.array(src), tmx.nd.array(tgt)] + \
        ([tmx.nd.array(vl)] if lengths else [])
    with jautograd.record():
        jlogits = jnet(*jin)
        jl = JLSCE(0.1, ignore_index=0)(jlogits, mx.nd.array(lab)).mean()
    jl.backward()
    with tmx.autograd.record():
        tlogits = tnet(*tin)
        tl = TLSCE(0.1, ignore_index=0)(tlogits, tmx.nd.array(lab)).mean()
    tl.backward()
    _close(tlogits.asnumpy(), jlogits.asnumpy(), "logits")
    _close(tl.asnumpy(), jl.asnumpy(), "loss")
    jp, tp = jnet.collect_params(), tnet.collect_params()
    for k in jp.keys():
        _close(tp[k].grad().asnumpy(), jp[k].grad().asnumpy(), k)


def test_lengths_mask_the_source(pair):
    _, tnet = pair
    src, tgt, _, vl = _batch()
    out = tnet(tmx.nd.array(src), tmx.nd.array(tgt), tmx.nd.array(vl))
    s2 = src.copy()
    s2[2, 6] = (s2[2, 6] + 5) % V        # past row 2's length 4
    out2 = tnet(tmx.nd.array(s2), tmx.nd.array(tgt), tmx.nd.array(vl))
    np.testing.assert_array_equal(out.asnumpy(), out2.asnumpy())


@pytest.mark.parametrize("lengths", [False, True], ids=["all", "valid"])
def test_encode_then_decode_equals_the_forward(pair, lengths):
    _, tnet = pair
    src, tgt, _, vl = _batch(2)
    vl = tmx.nd.array(vl) if lengths else None
    full = tnet(tmx.nd.array(src), tmx.nd.array(tgt), vl)
    mem = tnet.encode(tmx.nd.array(src), vl)
    part = tnet.decode_from_memory(mem, tmx.nd.array(tgt), vl)
    np.testing.assert_allclose(part.asnumpy(), full.asnumpy(), rtol=1e-6,
                               atol=1e-6)


def test_greedy_decode_tokens_match_jax(pair):
    jnet, tnet = pair
    src, _, _, vl = _batch(3)
    want = jtr.greedy_decode(jnet, mx.nd.array(src), 1, 2, max_len=12,
                             src_valid_length=mx.nd.array(vl))
    got = ttr.greedy_decode(tnet, tmx.nd.array(src), 1, 2, max_len=12,
                            src_valid_length=tmx.nd.array(vl))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("beam", [1, 3])
def test_beam_search_tokens_match_jax(pair, beam):
    jnet, tnet = pair
    src, _, _, vl = _batch(4)
    want, wscore = jtr.beam_search_decode(
        jnet, mx.nd.array(src), 1, 2, beam_size=beam, max_len=10,
        src_valid_length=mx.nd.array(vl))
    got, gscore = ttr.beam_search_decode(
        tnet, tmx.nd.array(src), 1, 2, beam_size=beam, max_len=10,
        src_valid_length=tmx.nd.array(vl))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(gscore, wscore, rtol=1e-4)


def test_zoo_registration_and_configs():
    from mxnet_tpu_torch.gluon import model_zoo
    assert model_zoo.transformer is ttr
    net = ttr.transformer_model("transformer_base")
    assert len(net.encoder.cells) == len(net.decoder.cells) == 6
    assert net.collect_params()[net.prefix + "embed_weight"].shape == \
        (32768, 512)
    with pytest.raises(ValueError, match="unknown transformer"):
        ttr.transformer_model("transformer_huge")
