"""The port's flash backward (plain version, the CPU path of the wrapper)
held against the JAX package's Pallas backward kernels in interpret mode.

Both sides take the same numpy inputs and the same forward out/lse (the
JAX forward's), so only the backward is compared.  Tolerances, relative to
max |grad|: f32 2e-5 (same math, other summation order), bf16 2e-2 (p and
ds round to bf16 where values an f32 ulp apart can round differently, as
in tests/test_torch_flash_attention.py).  Block 512 at L <= 512 runs the
fused ``_bwd_fused_kernel``; block 128 at L = 256 runs the split
``_dq_kernel``/``_dkv_kernel`` grid, which the plain version walks in the
same tile order.  The plain version is what ``chip_smoke.py`` holds the
CUDA kernels to on the card, so the comparison runs at head_dims that pick
each of their instantiations.
"""

import importlib

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.kernels import flash_attention as tfa

jfa = importlib.import_module("mxnet_tpu.kernels.flash_attention")

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _inputs(B=2, H=2, Lq=256, Lk=256, D=64, seed=11):
    r = np.random.RandomState(seed)
    return tuple(r.randn(*shape).astype(np.float32) for shape in
                 ((B, H, Lq, D), (B, H, Lk, D), (B, H, Lk, D), (B, H, Lq, D)))


def _seg(L, valid):
    return (np.arange(L)[None, :] < np.asarray(valid)[:, None]) \
        .astype(np.int32)


def _run_both(q, k, v, do, seg_q, seg_kv, causal, dname, block):
    """[(jax grad, port grad)] for dq, dk, dv as float32 numpy."""
    scale = 1.0 / q.shape[-1] ** 0.5
    jq, jk, jv, jdo = (jnp.asarray(x, JNP[dname]) for x in (q, k, v, do))
    js = [None if s is None else jnp.asarray(s) for s in (seg_q, seg_kv)]
    jout, jlse = jfa._fwd(jq, jk, jv, js[0], js[1], causal, scale,
                          block, block, 0, True)
    jgrads = jfa._bwd(jq, jk, jv, js[0], js[1], jout, jlse, jdo, causal,
                      scale, block, block, 0, True)
    t = [torch.tensor(x).to(TORCH[dname]) for x in (q, k, v, do)]
    ts = [None if s is None else torch.tensor(s) for s in (seg_q, seg_kv)]
    tout = torch.tensor(np.asarray(jout, np.float32)).to(TORCH[dname])
    tlse = torch.tensor(np.asarray(jlse, np.float32))
    bq = jfa._pick_block(q.shape[2], block)
    bk = jfa._pick_block(k.shape[2], block)
    tgrads = tfa.flash_attention_backward_reference(
        t[0], t[1], t[2], ts[0], ts[1], tout, tlse, t[3], causal, scale,
        bq, bk)
    return [(np.asarray(j, np.float32), g.float().numpy())
            for j, g in zip(jgrads, tgrads)]


def _assert_close(pairs, dname):
    for name, (want, got) in zip(("dq", "dk", "dv"), pairs):
        assert np.all(np.isfinite(got)), name
        err = np.abs(want - got).max() / max(np.abs(want).max(), 1e-30)
        assert err <= TOL[dname], f"{name} relative error {err}"


# head_dims that pick each instantiation of the CUDA-core kernels (f32: DP
# = 64, 128 and 256 for dkv / fused and dq, the last also for bf16 above
# the tensor cores' 128), their smallest and widest heads (f32 8 and 40
# under DP = 64, bf16 256) and the tensor-core route (bf16 64)
CASES = [("float32", 8), ("float32", 40), ("float32", 64), ("float32", 128),
         ("float32", 136), ("float32", 256), ("bfloat16", 64),
         ("bfloat16", 136), ("bfloat16", 256)]


@pytest.mark.parametrize("dname,D", CASES,
                         ids=[f"{d}-D{n}" for d, n in CASES])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("with_seg", [False, True])
@pytest.mark.parametrize("block", [512, 128], ids=["fused", "split"])
def test_backward_reference_matches_jax(dname, D, causal, with_seg, block):
    """L = 256: block 512 runs the fused kernel, block 128 the split one."""
    q, k, v, do = _inputs(D=D)
    seg = _seg(256, (190, 256)) if with_seg else None
    _assert_close(_run_both(q, k, v, do, seg, seg, causal, dname, block),
                  dname)


@pytest.mark.parametrize("block", [512, 128], ids=["fused", "split"])
@pytest.mark.parametrize("causal", [False, True])
def test_backward_reference_matches_jax_cross_lengths(block, causal):
    """Lq = 128 against Lk = 256, with segment ids; causal compares
    absolute indices (qi >= ki), as the reference does."""
    q, k, v, do = _inputs(Lq=128, Lk=256, seed=5)
    seg_q = np.ones((2, 128), np.int32)
    seg_kv = _seg(256, (200, 256))
    _assert_close(_run_both(q, k, v, do, seg_q, seg_kv, causal, "float32",
                            block), "float32")


@pytest.mark.parametrize("block", [512, 128], ids=["fused", "split"])
def test_fully_masked_rows_have_zero_finite_grads(block):
    """Queries whose id appears nowhere in kv (rows 0-63 of batch 0) get
    exactly zero dq in both packages, and no NaN reaches dk/dv."""
    q, k, v, do = _inputs(Lq=256, Lk=256, seed=9)
    seg_q = np.ones((2, 256), np.int32)
    seg_q[0, :64] = 2
    seg_kv = np.ones((2, 256), np.int32)
    pairs = _run_both(q, k, v, do, seg_q, seg_kv, False, "float32", block)
    (jdq, tdq), _, _ = pairs
    assert np.all(tdq[0, :, :64] == 0.0) and np.all(jdq[0, :, :64] == 0.0)
    _assert_close(pairs, "float32")


@pytest.mark.parametrize("L", [256, 384, 512, 1024, 2048, 200])
def test_dispatch_follows_the_reference(L):
    """fused iff each sequence is one reference block (block 512)."""
    want = jfa._pick_block(L, 512) == L
    assert tfa.bwd_is_fused(L, L) == want
    assert tfa.bwd_is_fused(256, L) == want


def test_autograd_function_runs_the_plain_backward_on_cpu():
    """On CPU tensors the gradient comes from the Function's backward,
    which is the plain backward, not autograd through the plain forward."""
    q, k, v, do = (torch.tensor(x) for x in _inputs(Lq=384, Lk=384, seed=3))
    seg = torch.tensor(_seg(384, (300, 384)))
    q, k, v = (x.requires_grad_() for x in (q, k, v))
    before = (tfa.bwd_fused_launches, tfa.bwd_dq_launches,
              tfa.bwd_dkv_launches)
    out = tfa.flash_attention(q, k, v, seg, seg, True, 0.125)
    assert type(out.grad_fn).__name__ == "_FlashAttentionBackward"
    got = torch.autograd.grad(out, (q, k, v), do)
    ref_out, lse = tfa.flash_attention_reference(q.detach(), k.detach(),
                                                 v.detach(), seg, seg, True,
                                                 0.125)
    # L = 384 is split by the reference's dispatch: 128-row tiles
    want = tfa.flash_attention_backward_reference(
        q.detach(), k.detach(), v.detach(), seg, seg, ref_out, lse, do,
        True, 0.125, 128, 128)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert (tfa.bwd_fused_launches, tfa.bwd_dq_launches,
            tfa.bwd_dkv_launches) == before
    # and the Function's gradient agrees with autograd of the plain forward
    auto = torch.autograd.grad(
        tfa.flash_attention_reference(q, k, v, seg, seg, True, 0.125)[0],
        (q, k, v), do)
    for g, a in zip(got, auto):
        torch.testing.assert_close(g, a, rtol=0, atol=2e-5)


def test_one_sided_segments_rejected_in_backward():
    q, k, v, do = (torch.tensor(x) for x in _inputs(Lq=128, Lk=128))
    seg = torch.ones((2, 128), dtype=torch.int32)
    out, lse = tfa.flash_attention_reference(q, k, v)
    with pytest.raises(ValueError, match="BOTH seg_q and seg_kv"):
        tfa.flash_attention_backward_reference(q, k, v, seg, None, out, lse,
                                               do)
    with pytest.raises(ValueError, match="BOTH seg_q and seg_kv"):
        tfa._bwd(q, k, v, None, seg, out, lse, do)


def test_noncontiguous_do_is_accepted():
    """A gradient arriving as a transposed view gives the same result (to
    f32 rounding: the CPU matmul sums a strided operand in another order)."""
    q, k, v, do = (torch.tensor(x) for x in _inputs(Lq=128, Lk=128))
    q, k, v = (x.requires_grad_() for x in (q, k, v))
    out = tfa.flash_attention(q, k, v, None, None, False, 0.125)
    do_t = do.transpose(2, 3).contiguous().transpose(2, 3)
    assert not do_t.is_contiguous()
    a = torch.autograd.grad(out, (q, k, v), do, retain_graph=True)
    b = torch.autograd.grad(out, (q, k, v), do_t)
    for x, y in zip(a, b):
        torch.testing.assert_close(x, y, rtol=0, atol=1e-6)


def test_backward_argument_checks_run_on_the_host():
    """``prepare_bwd`` refuses mismatched operands before any launch, and a
    device with no kernel raises rather than falling back."""
    q, k, v, do = (torch.tensor(x) for x in _inputs(Lq=128, Lk=128))
    out, lse = tfa.flash_attention_reference(q, k, v)
    with pytest.raises(MXNetError, match="do not match"):
        tfa.prepare_bwd(q, k, v, None, None, out, lse, do[:, :, :64], False,
                        0.125)
    x = tfa.prepare_bwd(q, k, v, None, None, out, lse, do.transpose(2, 3)
                        .contiguous().transpose(2, 3), False, 0.125)
    assert x.do.is_contiguous() and x.delta.shape == (2, 2, 128)
    m = torch.zeros((1, 2, 128, 64), device="meta")
    with pytest.raises(MXNetError, match="no kernel for device"):
        tfa._bwd(m, m, m, None, None, m, m[..., 0], m)


def test_each_library_is_built_by_its_own_wrapper(monkeypatch):
    """The forward asks the builder for ``flash_fwd`` alone and the
    backward for ``flash_bwd`` alone, so serving (forward only) never
    depends on the backward's source."""
    from types import SimpleNamespace
    from mxnet_tpu_torch.kernels import _build

    asked = []

    def fake_build(sources):
        asked.append(list(sources))
        names = ("mx_flash_fwd", "mx_flash_bwd_dq", "mx_flash_bwd_dkv",
                 "mx_flash_bwd_fused")
        return {s: SimpleNamespace(**{n: SimpleNamespace() for n in names})
                for s in sources}

    monkeypatch.setattr(_build, "build_kernel_libraries", fake_build)
    monkeypatch.setattr(tfa, "_libs", {})
    fwd = tfa._kernel_lib("flash_fwd")
    assert asked == [["flash_fwd"]]
    assert fwd.mx_flash_fwd.argtypes and fwd.mx_flash_fwd.restype
    assert tfa._kernel_lib("flash_fwd") is fwd          # built once
    bwd = tfa._kernel_lib("flash_bwd")
    assert asked == [["flash_fwd"], ["flash_bwd"]]
    assert len(bwd.mx_flash_bwd_fused.argtypes) == 20


@pytest.mark.parametrize("D", [64, 128, 136])
@pytest.mark.parametrize("dname", ["float32", "bfloat16"])
@pytest.mark.parametrize("block", [None, 128], ids=["fused", "split"])
def test_plain_backward_products_follow_the_kernels(monkeypatch, block,
                                                    dname, D):
    """Every product of the plain backward asks for the tensor cores
    exactly when the kernels run (dtype, head_dim) there, on both routes,
    and s, p and ds are formed once per tile: five products a tile (s, dp,
    dq, dv, dk)."""
    flags = []
    product = tfa._product

    def recording(a, b, tensor_cores):
        flags.append(tensor_cores)
        return product(a, b, tensor_cores)

    monkeypatch.setattr(tfa, "_product", recording)
    q, k, v, do = (torch.tensor(x).to(TORCH[dname])
                   for x in _inputs(B=1, H=1, D=D, seed=2))
    out, lse = tfa.flash_attention_reference(q, k, v, None, None, False,
                                             0.125)
    flags.clear()
    tfa.flash_attention_backward_reference(q, k, v, None, None, out, lse, do,
                                           False, 0.125, block, block)
    tiles = 1 if block is None else (256 // block) ** 2
    assert len(flags) == 5 * tiles
    assert set(flags) == {tfa.uses_tensor_cores(TORCH[dname], D)}


@pytest.mark.parametrize("D", [64, 128, 136])
@pytest.mark.parametrize("dname", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["fused", "dq", "dkv"])
def test_wide_head_counters_count_bf16_beyond_the_tensor_cores(
        monkeypatch, kind, dname, D):
    """Each backward wrapper counts its launch, and counts it again as a
    wide bf16 launch exactly when the C entry point runs it on a CUDA-core
    kernel although it is bf16 (head_dim > TC_MAX_D), and as an f32 launch
    exactly when it is f32."""
    from types import SimpleNamespace

    names = ("mx_flash_bwd_fused", "mx_flash_bwd_dq", "mx_flash_bwd_dkv")
    lib = SimpleNamespace(**{n: n for n in names})
    called = []
    monkeypatch.setattr(tfa, "_kernel_lib", lambda name: lib)
    monkeypatch.setattr(tfa, "_call_bwd",
                        lambda fn, x, outs, name: called.append(fn))
    counters = [f"bwd_{k}{w}_launches" for k in ("fused", "dq", "dkv")
                for w in ("", "_wide_bf16", "_f32")]
    for name in counters:
        monkeypatch.setattr(tfa, name, 0)
    q = torch.zeros((1, 2, 16, D), dtype=TORCH[dname])
    x = tfa.prepare_bwd(q, q, q, None, None, q, torch.zeros(1, 2, 16), q,
                        False, 0.125)
    getattr(tfa, f"launch_bwd_{kind}")(x)
    assert called == [f"mx_flash_bwd_{kind}"]
    want_wide = int(dname == "bfloat16" and D > tfa.TC_MAX_D)
    counts = {n: getattr(tfa, n) for n in counters}
    assert counts.pop(f"bwd_{kind}_launches") == 1
    assert counts.pop(f"bwd_{kind}_wide_bf16_launches") == want_wide
    assert counts.pop(f"bwd_{kind}_f32_launches") == int(dname == "float32")
    assert not any(counts.values())
