"""The contrib attention family of the port held against the JAX
package's on the CPU: ``masked_encdec_att`` (cross attention, Lq != Lk,
padded keys), ``multihead_attention`` (self and cross lengths, causal,
key padding), the unfused score/value ops they fuse, forward and
gradients, on the same float32 numpy inputs made from a seed.

On the CPU both packages take their plain paths: the reference its dense
attention, the port the dense cross path or, for ``multihead_attention``
mask-free at an eligible self length, ``flash_attention``'s plain version
(the kernels run only for tensors on the card).  Tolerance: 1e-4 of max
|ref|, outputs and gradients (float32 sums in another order).
"""

import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from mxnet_tpu_torch.kernels import flash_attention as fa
from mxnet_tpu_torch.ops import contrib, sweep

TOL = 1e-4


@pytest.fixture(autouse=True)
def _on_cpu():
    with mx.cpu():
        yield


def _rand(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _compare(name, arrays, attrs):
    got, got_g = sweep.run(mx, name, arrays, attrs, mx.cpu())
    want, want_g = sweep.run(jmx, name, arrays, attrs, jmx.cpu())
    assert sweep.rel_err(got[0], want[0]) <= TOL, name
    assert len(got_g) == len(want_g)
    for i, (g, w) in enumerate(zip(got_g, want_g)):
        assert sweep.rel_err(g, w) <= TOL, f"{name}: gradient {i}"
    return got[0]


@pytest.mark.parametrize("lq,lk,valid", [
    (4, 6, (2, 6)), (6, 4, None), (256, 384, (256, 300)),
    (128, 512, (1, 512))])
def test_masked_encdec_att(lq, lk, valid):
    heads, D, B = 2, 8, 2
    arrays = [_rand(1, lq, B, heads * D), _rand(2, lk, B, 2 * heads * D)]
    if valid is not None:
        arrays.append(np.array(valid, np.float32))
    _compare("contrib.masked_encdec_att", arrays, {"heads": heads})


@pytest.mark.parametrize("lq,lk,causal,valid", [
    (5, 5, False, None), (5, 5, True, None), (256, 256, False, None),
    (256, 256, True, None), (4, 7, False, None), (4, 7, False, (3, 7)),
    (6, 6, True, (2, 6)), (256, 384, False, (200, 384))])
def test_multihead_attention(lq, lk, causal, valid):
    heads, D, B = 2, 8, 2
    arrays = [_rand(3, lq, B, heads * D), _rand(4, lk, B, heads * D),
              _rand(5, lk, B, heads * D)]
    if valid is not None:
        arrays.append(np.array(valid, np.float32))
    _compare("contrib.multihead_attention", arrays,
             {"heads": heads, "causal": causal})


def test_multihead_attention_causal_cross_raises():
    q, k = _rand(6, 4, 2, 8), _rand(7, 5, 2, 8)
    for m in (jmx, mx):
        with pytest.raises(m.MXNetError):
            m.nd.contrib.multihead_attention(
                m.nd.array(q), m.nd.array(k), m.nd.array(k), heads=2,
                causal=True)


def test_encdec_att_is_the_unfused_chain():
    """masked_encdec_att equals encdec_qk -> key mask -> softmax ->
    encdec_valatt, in the port as in the reference."""
    q, kv = _rand(8, 4, 2, 8), _rand(9, 6, 2, 16)
    valid = np.array([3, 6], np.float32)

    def run(m):
        qk = m.nd.contrib.interleaved_matmul_encdec_qk(
            m.nd.array(q), m.nd.array(kv), heads=2)        # (B H, Lq, Lk)
        mask = np.repeat(np.arange(6)[None, :] < valid[:, None], 2, axis=0)
        att = m.nd.softmax(m.nd.where(
            m.nd.array(np.broadcast_to(mask[:, None, :], qk.shape)
                       .astype(np.float32)), qk,
            m.nd.array(np.full(qk.shape, -1e9, np.float32))), axis=-1)
        chain = m.nd.contrib.interleaved_matmul_encdec_valatt(
            m.nd.array(kv), att, heads=2)
        fused = m.nd.contrib.masked_encdec_att(
            m.nd.array(q), m.nd.array(kv), m.nd.array(valid), heads=2)
        return chain.asnumpy(), fused.asnumpy()
    pc, pf = run(mx)
    jc, jf = run(jmx)
    for a, b in ((pc, pf), (jc, jf), (pf, jf)):
        assert sweep.rel_err(a, b) <= TOL


def test_multihead_attention_is_the_unfused_chain():
    q, k, v = _rand(10, 4, 2, 8), _rand(11, 5, 2, 8), _rand(12, 5, 2, 8)

    def run(m):
        att = m.nd.softmax(m.nd.contrib.multihead_attention_qk(
            m.nd.array(q), m.nd.array(k), heads=2), axis=-1)
        return m.nd.contrib.multihead_attention_valatt(
            att, m.nd.array(v), heads=2).asnumpy(), \
            m.nd.contrib.multihead_attention(
                m.nd.array(q), m.nd.array(k), m.nd.array(v),
                heads=2).asnumpy()
    for chain, fused in (run(mx), run(jmx)):
        assert sweep.rel_err(chain, fused) <= TOL


def test_flash_reference_switch_and_no_launch_on_the_host():
    """On the CPU the flash_reference switch gives the same values (the
    plain versions either way; the switch streams kv at the kernel's tile)
    and no kernel counter moves (the kernels run only for tensors on the
    card)."""
    q, kv = _rand(13, 256, 2, 16), _rand(14, 512, 2, 32)
    valid = mx.nd.array(np.array([300, 512], np.float32))
    before = (fa.launches, fa.bwd_fused_launches, fa.bwd_dq_launches,
              fa.bwd_dkv_launches)
    outs = [mx.nd.contrib.masked_encdec_att(
        mx.nd.array(q), mx.nd.array(kv), valid, heads=2,
        flash_reference=ref).asnumpy() for ref in (False, True)]
    x = mx.nd.array(_rand(15, 256, 2, 16))
    outs += [mx.nd.contrib.multihead_attention(
        x, x, x, heads=2, causal=True, flash_reference=ref).asnumpy()
        for ref in (False, True)]
    np.testing.assert_array_equal(outs[0], outs[1])
    assert sweep.rel_err(outs[2], outs[3]) <= 1e-5
    assert (fa.launches, fa.bwd_fused_launches, fa.bwd_dq_launches,
            fa.bwd_dkv_launches) == before


def test_fully_padded_row_kernel_zero_dense_mean():
    """valid_length 0 masks every key of a row: the flash kernels (and
    their plain version) return 0 there, the dense path the mean of v,
    since every score is -1e9."""
    import torch
    B, H, Lq, Lk, D = 2, 2, 128, 256, 8
    q = torch.from_numpy(_rand(16, B, H, Lq, D))
    k = torch.from_numpy(_rand(17, B, H, Lk, D))
    v = torch.from_numpy(_rand(18, B, H, Lk, D))
    seg_kv = torch.tensor([[0] * Lk, [1] * Lk], dtype=torch.int32)
    seg_q = torch.ones((B, Lq), dtype=torch.int32)
    kern = fa.flash_attention_reference(q, k, v, seg_q, seg_kv, False,
                                        D ** -0.5)[0]
    dense = contrib._dense_sdpa_cross(q, k, v, seg_kv, D ** -0.5)
    assert torch.count_nonzero(kern[0]) == 0
    torch.testing.assert_close(dense[0], v[0].mean(dim=1, keepdim=True)
                               .expand(H, Lq, D), rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(kern[1], dense[1], rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("lq,lk,causal", [(256, 512, False), (256, 256, True),
                                          (640, 384, False)])
def test_flash_attention_plain_matches_flash_attention(lq, lk, causal):
    """The plain twin the kernels are held against computes the same
    values and gradients as ``flash_attention`` (whose host path is the
    plain versions too), fused and split backward alike."""
    import torch
    B, H, D = 2, 2, 16
    gen = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(B, H, n, D, generator=gen, requires_grad=True)
               for n in (lq, lk, lk))
    seg_q = torch.ones(B, lq, dtype=torch.int32)
    seg_kv = (torch.arange(lk)[None, :] < torch.tensor([[lk - 37], [lk]])) \
        .to(torch.int32)
    w = torch.randn(B, H, lq, D, generator=gen)
    res = []
    for fn in (fa.flash_attention, fa.flash_attention_plain):
        out = fn(q, k, v, seg_q, seg_kv, causal, D ** -0.5)
        res.append([out] + list(torch.autograd.grad((out * w).sum(),
                                                    (q, k, v))))
    for a, b in zip(*res):
        assert sweep.rel_err(a.detach().numpy(), b.detach().numpy()) <= 1e-5
