"""The port's MT serving adapter (``TransformerServingAdapter``) held
against the JAX package's, at ``transformer_test`` size (2 + 2 layers, 64
units, 4 heads), f32, on the same weights set by name.

Sources are padded to ``prefill_tokens`` = 256, the flash floor, so the
port's encoder attention takes ``_attend``'s flash route with the sources'
segment ids (its plain version on the CPU) while the reference's serving
encoder takes the dense path.  Checked:

- the served target tokens equal the JAX engine's and the port's
  ``greedy_decode`` on the same weights, for sources of several lengths;
- one encoder pass per request, however many tokens it emits;
- ``max_seq`` beyond the positional table is refused at construction;
- the source mask works: tokens past a source's length change nothing.
"""

import numpy as np
import pytest

import mxnet_tpu as mx
from mxnet_tpu import serving as jserving
from mxnet_tpu.base import MXNetError as JMXNetError
from mxnet_tpu.gluon.model_zoo import transformer as jtr

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import convert
from mxnet_tpu_torch import serving
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.gluon.model_zoo import transformer as ttr
from mxnet_tpu_torch.ops import contrib
from mxnet_tpu_torch.serving import models as tmodels

ERRORS = (JMXNetError, MXNetError)      # either package's
V, BOS, EOS, P, MAXLEN = 50, 1, 2, 256, 256
ENGINE = dict(max_batch=4, block_tokens=16, max_seq=256, prefill_tokens=P)


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
                                 max_length=MAXLEN, dropout=0.0,
                                 prefix="mt_")
    jnet.initialize(mx.initializer.Zero())
    w = _weights(jnet)
    for k, p in jnet.collect_params().items():
        p.set_data(mx.nd.array(w[k]))
    tnet = ttr.transformer_model("transformer_test", vocab_size=V,
                                 max_length=MAXLEN, dropout=0.0,
                                 prefix="mt_")
    convert.load_by_name(tnet, w, device="cpu")
    return jnet, tnet


def _sources():
    r = np.random.RandomState(4)
    return [r.randint(3, V, n).tolist() for n in (200, 37, 256, 9)]


def _greedy(tnet, src, max_new):
    """The port's greedy_decode of one source, BOS stripped, cut after
    EOS or ``max_new`` tokens (what the engine emits)."""
    with tmx.cpu():
        out = ttr.greedy_decode(tnet, tmx.nd.array(np.array([src])), BOS,
                                EOS, max_len=max_new + 1)
    toks = [int(t) for t in out[0, 1:]]
    return toks[:toks.index(EOS) + 1] if EOS in toks else toks


def test_mt_tokens_equal_reference_and_greedy_decode(pair):
    jnet, tnet = pair
    srcs = _sources()
    want = jserving.ServingEngine(jnet, eos_id=EOS, bos_id=BOS,
                                  **ENGINE).generate(srcs, max_new_tokens=12)
    eng = serving.ServingEngine(tnet, eos_id=EOS, bos_id=BOS, **ENGINE)
    assert isinstance(eng.adapter, serving.TransformerServingAdapter)
    got = eng.generate(srcs, max_new_tokens=12)
    assert got == want
    assert got == [_greedy(tnet, s, 12) for s in srcs]
    assert any(len(o) > 1 for o in got)


def test_mt_encodes_each_source_once(pair, monkeypatch):
    """One encoder pass a request, each layer's self-attention through the
    flash route (``ops.contrib.flash_attention``, plain on the CPU) with
    the source's segment ids."""
    _jnet, tnet = pair
    calls, flash = [], []
    orig = tmodels._tf_encode_raw
    orig_flash = contrib.flash_attention

    def counting(*a, **kw):
        calls.append(a[2].shape)
        return orig(*a, **kw)

    def counting_flash(q, k, v, seg_q, seg_kv, *a, **kw):
        flash.append((tuple(q.shape), int(seg_q.sum())))
        return orig_flash(q, k, v, seg_q, seg_kv, *a, **kw)

    monkeypatch.setattr(tmodels, "_tf_encode_raw", counting)
    monkeypatch.setattr(contrib, "flash_attention", counting_flash)
    eng = serving.ServingEngine(tnet, eos_id=-1, bos_id=BOS, **ENGINE)
    srcs = _sources()[:3]
    outs = eng.generate(srcs, max_new_tokens=10)
    assert [len(o) for o in outs] == [10, 10, 10]
    assert calls == [(1, P)] * 3
    layers = len(tnet.encoder.cells)
    assert flash == [((1, 4, P, 16), len(s)) for s in srcs
                     for _ in range(layers)]


def test_mt_refuses_max_seq_past_the_position_table(pair):
    jnet, tnet = pair
    for pkg, net in ((jserving, jnet), (serving, tnet)):
        with pytest.raises(ERRORS, match="positional table"):
            pkg.ServingEngine(net, eos_id=EOS, bos_id=BOS,
                              **dict(ENGINE, max_seq=MAXLEN + 16))
    with pytest.raises(MXNetError, match="bos_id"):
        serving.ServingEngine(tnet, eos_id=EOS, **ENGINE)


def test_mt_source_mask(pair):
    """A short source served alone gives greedy_decode's tokens for that
    source padded with other tokens under its valid length; and the
    adapter's cross-attention segment row marks exactly its positions."""
    _jnet, tnet = pair
    src = _sources()[3]
    eng = serving.ServingEngine(tnet, eos_id=EOS, bos_id=BOS, **ENGINE)
    got = eng.generate([src], max_new_tokens=12)[0]
    padded = np.array([src + [7] * 20, src + [44] * 20])
    with tmx.cpu():
        out = ttr.greedy_decode(
            tnet, tmx.nd.array(padded), BOS, EOS, max_len=13,
            src_valid_length=tmx.nd.array(np.array([len(src)] * 2)))
    for row in out:
        toks = [int(t) for t in row[1:]]
        toks = toks[:toks.index(EOS) + 1] if EOS in toks else toks
        assert toks == got
    seg = eng.adapter._seg[0].numpy()
    assert seg[:len(src)].all() and not seg[len(src):].any()
