"""The port's flash forward (plain version, the CPU path of the wrapper)
held against the JAX package's Pallas kernels run in interpret mode.

Inputs are made with numpy from a seed and handed to both.  Tolerances:
f32 out/lse 1e-5 (same math, other summation order); bf16 out 2e-2 (p and
out round to bf16 where an ulp apart in f32 can flip a rounding), bf16
lse 1e-4.  Only rows whose query is a real token are compared, as in
tests/test_flash_attention.py.
"""

import importlib

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.kernels import flash_attention as tfa

jfa = importlib.import_module("mxnet_tpu.kernels.flash_attention")

TOL = {"float32": (1e-5, 1e-5), "bfloat16": (2e-2, 1e-4)}
JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _inputs(B=2, H=2, Lq=256, Lk=256, D=64, seed=7):
    r = np.random.RandomState(seed)
    return (r.randn(B, H, Lq, D).astype(np.float32),
            r.randn(B, H, Lk, D).astype(np.float32),
            r.randn(B, H, Lk, D).astype(np.float32))


def _seg(B, L, valid):
    return (np.arange(L)[None, :] < np.asarray(valid)[:, None]) \
        .astype(np.int32)


def _run_both(q, k, v, seg_q, seg_kv, causal, dname, block=512):
    """(jax out, jax lse, torch out, torch lse) as float32 numpy."""
    scale = 1.0 / q.shape[-1] ** 0.5
    jq, jk, jv = (jnp.asarray(x, JNP[dname]) for x in (q, k, v))
    js = [None if s is None else jnp.asarray(s) for s in (seg_q, seg_kv)]
    jout, jlse = jfa._fwd(jq, jk, jv, js[0], js[1], causal, scale,
                          block, block, 0, True)
    tq, tk, tv = (torch.tensor(x).to(TORCH[dname]) for x in (q, k, v))
    ts = [None if s is None else torch.tensor(s) for s in (seg_q, seg_kv)]
    # the plain version streams kv at the JAX kernel's block, so p rounds
    # to bf16 exactly where the TPU kernel rounds it
    bk = jfa._pick_block(k.shape[2], block)
    tout, tlse = tfa.flash_attention_reference(
        tq, tk, tv, ts[0], ts[1], causal, scale,
        block_k=None if bk == k.shape[2] else bk)
    return (np.asarray(jout, np.float32), np.asarray(jlse, np.float32),
            tout.float().numpy(), tlse.numpy())


def _assert_close(res, rows, dname):
    jout, jlse, tout, tlse = res
    tol_out, tol_lse = TOL[dname]
    d_out = (np.abs(jout - tout) * rows[:, None, :, None]).max()
    d_lse = (np.abs(jlse - tlse) * rows[:, None, :]).max()
    assert d_out <= tol_out, f"out max diff {d_out}"
    assert d_lse <= tol_lse, f"lse max diff {d_lse}"


@pytest.mark.parametrize("dname", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("with_seg", [False, True])
def test_reference_matches_jax_single_tile(dname, causal, with_seg):
    q, k, v = _inputs()
    seg = _seg(2, 256, (200, 256)) if with_seg else None
    res = _run_both(q, k, v, seg, seg, causal, dname)
    rows = np.ones((2, 256), bool) if seg is None else seg.astype(bool)
    _assert_close(res, rows, dname)


@pytest.mark.parametrize("dname", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [False, True])
def test_reference_matches_jax_multi_tile(dname, causal):
    """block 128 forces the streaming Pallas kernel (2 x 2 tiles, causal
    tile skipping) — the plain version streams at the same block."""
    q, k, v = _inputs()
    seg = _seg(2, 256, (177, 256))
    res = _run_both(q, k, v, seg, seg, causal, dname, block=128)
    _assert_close(res, seg.astype(bool), dname)


@pytest.mark.parametrize("with_seg", [False, True])
def test_reference_matches_jax_cross_lengths(with_seg):
    q, k, v = _inputs(Lq=128, Lk=256, seed=3)
    seg_q = np.ones((2, 128), np.int32) if with_seg else None
    seg_kv = _seg(2, 256, (180, 256)) if with_seg else None
    res = _run_both(q, k, v, seg_q, seg_kv, False, "float32")
    _assert_close(res, np.ones((2, 128), bool), "float32")


def test_fully_masked_rows_match_jax():
    """Queries whose id appears nowhere in kv: 0 output and lse = -1e4
    in both (the dense oracle would return a uniform average)."""
    q, k, v = _inputs(Lq=128, Lk=128)
    seg_q = np.ones((2, 128), np.int32)
    seg_kv = np.zeros((2, 128), np.int32)
    jout, jlse, tout, tlse = _run_both(q, k, v, seg_q, seg_kv, False,
                                       "float32")
    assert np.all(tout == 0.0) and np.all(jout == 0.0)
    np.testing.assert_allclose(tlse, jlse)
    assert np.all(tlse == np.float32(-1e4))


def test_one_sided_segments_rejected():
    q, k, v = (torch.tensor(x) for x in _inputs(Lq=128, Lk=128))
    seg = torch.ones((2, 128), dtype=torch.int32)
    with pytest.raises(ValueError, match="BOTH seg_q and seg_kv"):
        tfa.flash_attention(q, k, v, seg, None, False, 0.125)
    with pytest.raises(ValueError, match="BOTH seg_q and seg_kv"):
        tfa.flash_attention(q, k, v, None, seg, False, 0.125)


def test_cpu_wrapper_runs_plain_version():
    """On a CPU tensor the wrapper is the plain version, and launches
    nothing."""
    q, k, v = (torch.tensor(x) for x in _inputs(Lq=128, Lk=128))
    before = tfa.launches
    out = tfa.flash_attention(q, k, v, None, None, True, 0.125)
    ref, _ = tfa.flash_attention_reference(q, k, v, None, None, True, 0.125)
    assert torch.equal(out, ref) and tfa.launches == before


@pytest.mark.parametrize("tile", sorted({
    tfa.kv_tile(torch.float32, 64), tfa.kv_tile(torch.bfloat16, 64),
    tfa.kv_tile(torch.bfloat16, 256)}))
def test_streaming_reference_equals_single_block_f32(tile):
    """Streaming the kv axis at each kernel's tile (online softmax) gives
    the direct softmax in f32 up to rounding."""
    q, k, v = (torch.tensor(x) for x in _inputs(Lq=256, Lk=256))
    a, la = tfa.flash_attention_reference(q, k, v, None, None, True, 0.125)
    b, lb = tfa.flash_attention_reference(q, k, v, None, None, True, 0.125,
                                          block_k=tile)
    torch.testing.assert_close(a, b, rtol=0, atol=1e-5)
    torch.testing.assert_close(la, lb, rtol=0, atol=1e-5)


def test_kv_tile_follows_the_kernel_route():
    """bf16 up to TC_MAX_D runs the tensor-core kernel (kv tile 128); f32,
    and bf16 with a wider head, the CUDA-core kernel (kv tile 64)."""
    assert tfa.kv_tile(torch.bfloat16, 64) == 128
    assert tfa.kv_tile(torch.bfloat16, tfa.TC_MAX_D) == 128
    assert tfa.kv_tile(torch.bfloat16, tfa.TC_MAX_D + 8) == 64
    assert tfa.kv_tile(torch.float32, 64) == 64
    assert tfa.uses_tensor_cores(torch.bfloat16, 128)
    assert not tfa.uses_tensor_cores(torch.float32, 128)


@pytest.mark.parametrize("tensor_cores", [False, True])
def test_plain_products_are_float32_on_the_cpu(tensor_cores):
    """The plain versions sum every product in float32; on the CPU they
    multiply in float32 even for the products the card runs on its tensor
    cores (bf16 products are exact in float32)."""
    r = np.random.RandomState(0)
    a = torch.tensor(r.randn(2, 3, 8, 16)).to(torch.bfloat16)
    b = torch.tensor(r.randn(2, 3, 16, 4)).to(torch.bfloat16)
    got = tfa._product(a, b, tensor_cores)
    assert got.dtype == torch.float32
    assert torch.equal(got, torch.matmul(a.float(), b.float()))


@pytest.mark.parametrize("D", [64, 136])
@pytest.mark.parametrize("causal", [False, True])
def test_reference_at_bf16_kernel_tile_matches_jax(causal, D):
    """The plain version streaming at the bf16 kernel's kv tile against the
    Pallas streaming kernel at that block, bf16, seq 256, with segment ids:
    p rounds relative to the same running maxima.  head_dim 64 runs the
    tensor-core kernel (tile 128), head_dim 136 > TC_MAX_D the CUDA-core
    kernel (tile 64)."""
    q, k, v = _inputs(D=D)
    tile = tfa.kv_tile(torch.bfloat16, D)
    assert tile == (128 if tfa.uses_tensor_cores(torch.bfloat16, D) else 64)
    seg = _seg(2, 256, (177, 256))
    scale = 1.0 / D ** 0.5
    jq, jk, jv = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v))
    jout, jlse = jfa._fwd(jq, jk, jv, jnp.asarray(seg), jnp.asarray(seg),
                          causal, scale, tile, tile, 0, True)
    tq, tk, tv = (torch.tensor(x).to(torch.bfloat16) for x in (q, k, v))
    ts = torch.tensor(seg)
    tout, tlse = tfa.flash_attention_reference(tq, tk, tv, ts, ts, causal,
                                               scale, block_k=tile)
    _assert_close((np.asarray(jout, np.float32), np.asarray(jlse, np.float32),
                   tout.float().numpy(), tlse.numpy()),
                  seg.astype(bool), "bfloat16")


@pytest.mark.parametrize("D", [64, 136])
@pytest.mark.parametrize("dname", ["float32", "bfloat16"])
def test_forward_counters_count_f32_and_wide_bf16(monkeypatch, dname, D):
    """The forward wrapper counts its launch, apart as an f32 launch when
    q is f32, and apart as a wide bf16 launch when the C entry point runs
    bf16 on the CUDA-core kernel (head_dim > TC_MAX_D).  The C entry point
    and the card's stream are stubbed, so this runs on the CPU."""
    import contextlib
    from types import SimpleNamespace

    calls = []
    lib = SimpleNamespace(mx_flash_fwd=lambda *a: calls.append(a) or 0)
    monkeypatch.setattr(tfa, "_kernel_lib", lambda name: lib)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d: SimpleNamespace(cuda_stream=0))
    counters = ("launches", "fwd_f32_launches", "fwd_wide_bf16_launches")
    for name in counters:
        monkeypatch.setattr(tfa, name, 0)
    dt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dname]
    q = torch.zeros((1, 2, 16, D), dtype=dt)
    tfa._launch(q, q, q, None, None, True, 0.125)
    assert len(calls) == 1
    assert [getattr(tfa, n) for n in counters] == [
        1, int(dname == "float32"),
        int(dname == "bfloat16" and D > tfa.TC_MAX_D)]


@pytest.mark.parametrize("shape,dtype,match", [
    ((1, 2, 128, 12), torch.float32, "multiple of 8"),
    ((1, 2, 128, 264), torch.float32, "up to 256"),
    ((1, 2, 128, 64), torch.float16, "float32 or bfloat16"),
])
def test_kernel_argument_checks(shape, dtype, match):
    """The wrapper refuses what the kernel does not take before any
    launch (the checks run on the host)."""
    x = torch.zeros(shape, dtype=dtype)
    with pytest.raises(MXNetError, match=match):
        tfa._check(x, x, x, None, None)


def test_other_devices_raise():
    x = torch.zeros((1, 2, 128, 64), device="meta")
    with pytest.raises(MXNetError, match="no kernel for device"):
        tfa.flash_attention(x, x, x)
