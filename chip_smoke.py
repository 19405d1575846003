#!/usr/bin/env python3
"""On-card smoke of the PyTorch/CUDA port (``mxnet_tpu_torch``) on one GPU.

Run from the repository root with no arguments:  ``python3 chip_smoke.py``

Phases (a failing phase makes the script exit non-zero and print no
result line; each prints its seconds):
 1. device — the card's name and, as ``nvidia-smi --query-gpu=name,
    power.limit --format=csv,noheader`` gives them, its power limit;
 2. build — compile ``kernels/csrc/flash_fwd.cu`` and ``flash_bwd.cu`` for
    sm_90a from this checkout, one nvcc each, in parallel; ptxas registers
    and spills per kernel (any kernel but the CUDA-core dq, whose spill is
    reported, fails if it spills);
 3. forward kernel — flash_fwd against its plain PyTorch version on the
    card: out and lse on valid rows, f32 and bf16, causal and not, with and
    without segment ids (a padded row), at the serving prefill shape
    (1, 32, 1024, 128), a single-tile (2, 32, 512, 128), a streaming
    (1, 32, 2048, 128), a cross-length Lq=256 / Lk=512 shape, the training
    lanes' BERT (32, 12, 512, 64) and llama (4, 16, 2048, 128) shapes and a
    head_dim sweep; two f32 launches at the prefill shape must agree bit
    for bit; times (causal at the serving shapes, each lane's own masking
    at the lane shapes) of the kernel, the plain version and, as a
    yardstick only, ``torch.nn.functional.scaled_dot_product_attention``
    (for f32, with the names of the kernels SDPA ran);
 4. backward kernels — flash_bwd_fused, flash_bwd_dq and flash_bwd_dkv
    against ``flash_attention_backward_reference`` on the card: dq, dk, dv
    on valid rows, f32 and bf16, causal and not, with and without segment
    ids, at the BERT lane (32, 12, 512, 64) -> fused, the llama lane
    (4, 16, 2048, 128) -> dq + dkv, cross 256/512 -> fused, L=384 -> dq +
    dkv and a head_dim sweep on both routes; two f32 dkv launches at the
    llama lane shape, and the dk, dv of two f32 fused launches at the BERT
    lane shape, must agree bit for bit; autograd through
    ``flash_attention`` at both lane shapes; times of each kernel in f32
    and bf16 at the same shapes, the plain backward and, as a yardstick
    only, SDPA's backward in the same dtype (dq, dk, dv by
    ``torch.autograd.grad`` of one recorded SDPA forward), read twice: CUDA
    events around the call, and the sum of its device kernels in one
    ``torch.profiler`` window (the number the ``library_ms`` column takes),
    with the names of those kernels;
 5. serving oracle — llama_small served on the card (prefill 256: the
    flash kernel) must be token-identical to greedy full re-encode;
 6. serve — llama3_8b at full width (32 layers, vocab 128256, f32, random
    weights from a seeded generator on the card) behind ``ServingEngine(
    max_batch=8, block_tokens=16, max_seq=2048, prefill_tokens=1024)``
    answers 8 requests of 100-1000 prompt tokens, 16 new tokens each; the
    forward kernel's counter must grow by >= layers per prefill; one
    prefill is repeated with attention bound to the plain version and the
    logits compared;
 7. train oracle — bert_3_128_2 at seq 512 (fused backward) and llama_small
    at seq 1024 (dq + dkv) train 3 steps on the card and on the CPU (plain
    versions) from the same f32 weights and batches: per-step losses agree;
 8. train lanes — bench.py's bert_seq512 (BERT-base, batch 32, seq 512)
    and llama_seq2048 (8 layers, 2048 units, batch 4, seq 2048) lanes at
    full width, in bf16 with multi-precision Adam, then again in f32 with
    plain Adam (``bert_seq512_f32``, ``llama_seq2048_f32``, bench.py's
    lanes under MXNET_BENCH_DTYPE=float32), 8 steps on one batch (and one
    padded BERT step): losses finite and falling, kernel launches per step
    (every launch in the lane's dtype; none on the CUDA-core route for wide
    bf16 heads), median step ms, samples/s, MFU against the dtype's peak,
    peak memory, and one profiled step's device time by kernel family.
The second-to-last line is ``{"kernels": [...]}``: ``flash_fwd`` at the
f32 prefill shape (``launches`` counts all train lanes' timed steps,
``serve_launches`` the serve phase's, ``f32_launches`` the f32 launches of
both), and each backward entry point twice, bf16 (``flash_bwd_*``, the
tensor-core kernels, launches of the bf16 lanes) and f32
(``flash_bwd_*_f32``, the CUDA-core kernels, launches of the f32 lanes);
the last line is ``{"ok": true, "device": {...}}``.

Tolerances.  Forward, on valid rows: f32 out and lse 2e-5 max abs error
(f32 accumulation in another order); bf16 lse 1e-4; bf16 out at most 2
bf16 ulps of max(|ref|, 2^-6) per element.  out is rounded to bf16 once,
so a kernel that sums in another order differs by one ulp where a value
sits near a rounding boundary.  An absolute bound (4e-3) is half an ulp
at |out| in [1, 2), so one such flip there would fail it, and it says
nothing about small values; the floor keeps near-zero outputs from asking
for more than f32 sums give.  The plain version streams kv at the
kernel's tile (``kv_tile``) so p rounds relative to the same running
maxima, and on the card it computes the bf16 tensor-core kernels'
products on the tensor cores too (``flash_attention._product``): with
f32 products, p rounds differently wherever s differs in its last f32
bit, which moved out by up to 5.5 ulps at the causal BERT lane shape on
an H100.  Backward (max abs error over
max |ref|, valid rows): f32 1e-4 (sum order; the fused kernel's dq sums
with atomics in an order that changes from run to run); bf16 5e-3, about
twice the worst seen on an H100 (2.2e-3: ds rounds to bf16 where f32
values an ulp apart round differently).  Prefill logits kernel vs plain:
1e-3.  Train oracle: per-step losses 1e-4 relative (f32, 3 Adam steps).
"""

from __future__ import annotations

import argparse
import gc
import json
import re
import statistics
import subprocess
import sys
import time

import numpy as np

PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}  # H100 SXM, dense
HBM_BYTES_PER_S = 3.35e12
TOL = {"float32": (2e-5, 2e-5), "bfloat16": (None, 1e-4)}  # (out, lse)
BF16_OUT_ULPS = 2          # bf16 out: ulps of max(|ref|, 2^-6), per element
LOGITS_TOL = 1e-3


def _log(msg):
    print(msg, flush=True)


def _time_ms(torch, fn, iters=20, reps=5):
    """Median per-call device time (CUDA events) over ``reps`` runs of
    ``iters`` back-to-back calls, after a warm-up."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return statistics.median(times)


def _bound_ms(B, H, Lq, Lk, D, dtype_name, causal):
    """Least time for the work: flops (4 B H Lq Lk D, halved when causal)
    over the type's peak, or bytes (q, k, v read once; out, lse written
    once) over HBM bandwidth — the larger, and which one bounds."""
    elt = 4 if dtype_name == "float32" else 2
    flops = 4.0 * B * H * Lq * Lk * D * (0.5 if causal else 1.0)
    nbytes = elt * B * H * (2 * Lq * D + 2 * Lk * D) + 4 * B * H * Lq
    t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def _bf16_ulps(torch, got, ref, rows):
    """max over valid rows of |got - ref| in bf16 ulps of max(|ref|, 2^-6)
    (a bf16 ulp of x in [2^e, 2^(e+1)) is 2^(e-7))."""
    mag = ref.float().abs().clamp(min=2.0 ** -6)
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
    return ((got.float() - ref.float()).abs() / ulp
            * rows[:, None, :, None]).max().item()


def _segs(torch, B, L, pad, dev):
    """(B, L) int32 ids: row 0 padded by ``pad`` positions, others full."""
    valid = torch.tensor([L - pad] + [L] * (B - 1), device=dev)
    return (torch.arange(L, device=dev)[None, :] < valid[:, None]) \
        .to(torch.int32)


def kernel_phase(torch, fa):
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1234)
    shapes = [("prefill", 1, 32, 1024, 1024, 128),
              ("single-tile", 2, 32, 512, 512, 128),
              ("streaming", 1, 32, 2048, 2048, 128),
              ("cross", 2, 32, 256, 512, 128)]
    # the training lanes' shapes: the BERT lane runs non-causal (padded
    # batches with segment ids), the llama lane causal
    lanes = [("bert-lane", 32, 12, 512, 512, 64, False),
             ("llama-lane", 4, 16, 2048, 2048, 128, True)]
    # every output-column layout of the kernel, ragged tiles included
    head_dims = [(f"head_dim {D}", 2, 2, 200, 328, D)
                 for D in (8, 40, 64, 96, 136, 200, 256)]
    dtypes = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    errors = {}
    for label, B, H, Lq, Lk, D in shapes + [l[:6] for l in lanes] \
            + head_dims:
        for dname, dt in dtypes.items():
            q = torch.randn(B, H, Lq, D, generator=gen, device=dev).to(dt)
            k = torch.randn(B, H, Lk, D, generator=gen, device=dev).to(dt)
            v = torch.randn(B, H, Lk, D, generator=gen, device=dev).to(dt)
            scale = 1.0 / D ** 0.5
            for causal in (False, True):
                for with_seg in (False, True):
                    sq = _segs(torch, B, Lq, 37, dev) if with_seg else None
                    skv = _segs(torch, B, Lk, 53, dev) if with_seg else None
                    out, lse = fa._fwd(q, k, v, sq, skv, causal, scale)
                    torch.cuda.synchronize()
                    ref, ref_lse = fa.flash_attention_reference(
                        q, k, v, sq, skv, causal, scale,
                        block_k=fa.kv_tile(dt, D))
                    rows = torch.ones(B, Lq, dtype=torch.bool, device=dev) \
                        if sq is None else sq.bool()
                    e_out = ((out.float() - ref.float()).abs()
                             * rows[:, None, :, None]).max().item()
                    e_lse = ((lse - ref_lse).abs() * rows[:, None, :]) \
                        .max().item()
                    tol_out, tol_lse = TOL[dname]
                    if tol_out is None:
                        ulps = _bf16_ulps(torch, out, ref, rows)
                        ok_out = ulps <= BF16_OUT_ULPS
                        shown = f"{e_out:.3e} ({ulps:.2f} ulp)"
                    else:
                        ok_out, shown = e_out <= tol_out, f"{e_out:.3e}"
                    ok = ok_out and e_lse <= tol_lse
                    key = (label, dname, causal, with_seg)
                    errors[key] = (e_out, e_lse)
                    _log(f"check {label} B={B} H={H} Lq={Lq} Lk={Lk} D={D} "
                         f"{dname} causal={causal} seg={with_seg}: out err "
                         f"{shown} lse err {e_lse:.3e} "
                         f"{'ok' if ok else 'FAIL'}")
                    if not ok:
                        raise AssertionError(
                            f"flash_fwd disagrees with its plain version at "
                            f"{key}: out {shown} (tol {tol_out or BF16_OUT_ULPS}"
                            f"{'' if tol_out else ' ulp'}), lse {e_lse} (tol "
                            f"{tol_lse})")
    # the CUDA-core kernel sums without atomics: two launches on the same
    # inputs give the same bits
    B, H, L, D = 1, 32, 1024, 128
    q, k, v = (torch.randn(B, H, L, D, generator=gen, device=dev)
               for _ in range(3))
    first = fa._fwd(q, k, v, None, None, True, D ** -0.5)
    again = fa._fwd(q, k, v, None, None, True, D ** -0.5)
    same = all(torch.equal(a, b) for a, b in zip(first, again))
    _log(f"check determinism prefill B={B} H={H} L={L} D={D} float32 "
         f"causal=True: two launches {'bitwise equal' if same else 'DIFFER'}")
    if not same:
        raise AssertionError("flash_fwd f32 is not deterministic")

    timings, sdpa_kernels = {}, {}
    timed = [(label, B, H, Lq, Lk, D, True, dname)
             for label, B, H, Lq, Lk, D in shapes for dname in dtypes]
    timed += [lane + ("bfloat16",) for lane in lanes]
    for label, B, H, Lq, Lk, D, causal, dname in timed:
        dt = dtypes[dname]
        q = torch.randn(B, H, Lq, D, generator=gen, device=dev).to(dt)
        k = torch.randn(B, H, Lk, D, generator=gen, device=dev).to(dt)
        v = torch.randn(B, H, Lk, D, generator=gen, device=dev).to(dt)
        scale = 1.0 / D ** 0.5
        t_k = _time_ms(torch, lambda: fa._fwd(q, k, v, None, None, causal,
                                              scale))
        t_p = _time_ms(torch, lambda: fa.flash_attention_reference(
            q, k, v, None, None, causal, scale), iters=5)
        t_l = _time_ms(torch, lambda: torch.nn.functional
                       .scaled_dot_product_attention(
                           q, k, v, is_causal=causal, scale=scale))
        bound, bound_by = _bound_ms(B, H, Lq, Lk, D, dname, causal)
        timings[(label, dname)] = (t_k, t_p, t_l, bound, bound_by)
        extra = ""
        if dname == "float32":
            _, names = _device_ms(torch, lambda: torch.nn.functional
                                  .scaled_dot_product_attention(
                                      q, k, v, is_causal=causal,
                                      scale=scale), iters=1)
            sdpa_kernels[label] = names
            extra = f"; sdpa ran {names}"
        _log(f"time {label} B={B} H={H} Lq={Lq} Lk={Lk} D={D} {dname} "
             f"causal={causal}: kernel {t_k:.4f} ms, plain {t_p:.4f} ms, "
             f"sdpa {t_l:.4f} ms, bound {bound:.4f} ms ({bound_by}), "
             f"kernel/bound {t_k / bound:.2f}, kernel/sdpa {t_k / t_l:.2f}"
             + extra)
    return errors, timings, sdpa_kernels


BWD_TOL = {"float32": 1e-4, "bfloat16": 5e-3}   # relative to max |ref|


def _bwd_bound_ms(kind, B, H, Lq, Lk, D, dtype_name, causal):
    """Least time for one backward kernel's work: operations (10, 6 or 8
    B H Lq Lk D for fused, dq and dkv, halved when causal) over the type's
    peak, or bytes (inputs read once, outputs written once) over HBM
    bandwidth — the larger, and which one bounds."""
    elt = 4 if dtype_name == "float32" else 2
    mult = {"fused": 10, "dq": 6, "dkv": 8}[kind]
    flops = mult * B * H * Lq * Lk * D * (0.5 if causal else 1.0)
    ins = elt * B * H * (2 * Lq * D + 2 * Lk * D) + 2 * 4 * B * H * Lq
    outs = {"fused": elt * B * H * (Lq + 2 * Lk) * D,
            "dq": elt * B * H * Lq * D,
            "dkv": elt * B * H * 2 * Lk * D}[kind]
    t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
    t_bytes = (ins + outs) / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def _errs(got, ref, rows):
    """(max |got - ref|, that over max |ref|) over rows (B, L) marked
    valid."""
    m = rows[:, None, :, None]
    diff = ((got.float() - ref.float()).abs() * m).max().item()
    return diff, diff / max((ref.float().abs() * m).max().item(), 1e-30)


def bwd_kernel_phase(torch, fa):
    """The three backward kernels against the plain backward on the card:
    dq, dk, dv on valid rows, f32 and bf16, causal and not, with and
    without segment ids (a padded row); then autograd through
    ``flash_attention`` at the two lane shapes; then times."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(4321)
    shapes = [("bert-lane", 32, 12, 512, 512, 64),        # fused
              ("llama-lane", 4, 16, 2048, 2048, 128),     # dq + dkv
              ("cross", 2, 12, 256, 512, 64),             # fused
              ("L384", 2, 8, 384, 384, 64)]               # dq + dkv
    for D in (8, 40, 64, 96, 136, 200, 256):
        shapes.append((f"head_dim {D} fused", 2, 2, 200, 328, D))
        shapes.append((f"head_dim {D} split", 2, 2, 384, 640, D))
    dtypes = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    worst = {d: 0.0 for d in dtypes}
    errors = {}
    for label, B, H, Lq, Lk, D in shapes:
        fused = fa.bwd_is_fused(Lq, Lk)
        for dname, dt in dtypes.items():
            q, k, v, do = (torch.randn(B, H, L, D, generator=gen, device=dev)
                           .to(dt) for L in (Lq, Lk, Lk, Lq))
            scale = 1.0 / D ** 0.5
            for causal in (False, True):
                for with_seg in (False, True):
                    sq = _segs(torch, B, Lq, 37, dev) if with_seg else None
                    skv = _segs(torch, B, Lk, 53, dev) if with_seg else None
                    out, lse = fa._fwd(q, k, v, sq, skv, causal, scale)
                    got = fa._bwd(q, k, v, sq, skv, out, lse, do, causal,
                                  scale)
                    torch.cuda.synchronize()
                    ref = fa.flash_attention_backward_reference(
                        q, k, v, sq, skv, out, lse, do, causal, scale)
                    rq = torch.ones(B, Lq, device=dev) if sq is None \
                        else sq.float()
                    rk = torch.ones(B, Lk, device=dev) if skv is None \
                        else skv.float()
                    pairs = [_errs(g, r, rows) for g, r, rows in
                             zip(got, ref, (rq, rk, rk))]
                    errs = [rel for _, rel in pairs]
                    e = max(errs)
                    worst[dname] = max(worst[dname], e)
                    key = (label, dname, causal, with_seg)
                    errors[key] = [a for a, _ in pairs]   # dq, dk, dv
                    ok = e <= BWD_TOL[dname]
                    _log(f"check bwd {'fused' if fused else 'dq+dkv'} "
                         f"{label} B={B} H={H} Lq={Lq} Lk={Lk} D={D} {dname}"
                         f" causal={causal} seg={with_seg}: rel err dq "
                         f"{errs[0]:.2e} dk {errs[1]:.2e} dv {errs[2]:.2e} "
                         f"{'ok' if ok else 'FAIL'}")
                    if not ok:
                        raise AssertionError(
                            f"flash backward kernel disagrees with its plain "
                            f"version at {key}: {errs} (tol "
                            f"{BWD_TOL[dname]})")
    _log(f"bwd worst relative error: f32 {worst['float32']:.3e}, bf16 "
         f"{worst['bfloat16']:.3e}")

    # the CUDA-core dkv kernel sums dk and dv without atomics: two launches
    # on the same inputs give the same bits, in fused too (whose dq goes
    # through atomics and is not reproducible bit for bit)
    for kind, B, H, L, D, causal in [("dkv", 4, 16, 2048, 128, True),
                                     ("fused", 32, 12, 512, 64, False)]:
        q, k, v, do = (torch.randn(B, H, L, D, generator=gen, device=dev)
                       for _ in range(4))
        out, lse = fa._fwd(q, k, v, None, None, causal, D ** -0.5)
        x = fa.prepare_bwd(q, k, v, None, None, out, lse, do, causal,
                           D ** -0.5)
        launch = fa.launch_bwd_dkv if kind == "dkv" else \
            lambda x: fa.launch_bwd_fused(x)[1:]
        first, again = launch(x), launch(x)
        same = all(torch.equal(a, b) for a, b in zip(first, again))
        _log(f"check determinism bwd {kind} B={B} H={H} L={L} D={D} float32 "
             f"causal={causal}: dk, dv of two launches "
             f"{'bitwise equal' if same else 'DIFFER'}")
        if not same:
            raise AssertionError(f"flash_bwd {kind} f32 dk/dv is not "
                                 f"deterministic")

    # autograd through flash_attention at the lanes' shapes and types
    for label, B, H, L, D, causal, want in [
            ("bert-lane", 32, 12, 512, 64, False, "fused"),
            ("llama-lane", 4, 16, 2048, 128, True, "split")]:
        q, k, v, do = (torch.randn(B, H, L, D, generator=gen, device=dev)
                       .to(torch.bfloat16) for _ in range(4))
        seg = _segs(torch, B, L, 100, dev) if label == "bert-lane" else None
        scale = 1.0 / D ** 0.5
        before = (fa.bwd_fused_launches, fa.bwd_dq_launches,
                  fa.bwd_dkv_launches)
        qg, kg, vg = (x.clone().requires_grad_() for x in (q, k, v))
        out = fa.flash_attention(qg, kg, vg, seg, seg, causal, scale)
        got = torch.autograd.grad(out, (qg, kg, vg), do)
        after = (fa.bwd_fused_launches, fa.bwd_dq_launches,
                 fa.bwd_dkv_launches)
        o2, lse = fa._fwd(q, k, v, seg, seg, causal, scale)
        ref = fa.flash_attention_backward_reference(q, k, v, seg, seg, o2,
                                                    lse, do, causal, scale)
        rows = torch.ones(B, L, device=dev) if seg is None else seg.float()
        e = max(_errs(g, r, rows)[1] for g, r in zip(got, ref))
        step = [a - b for a, b in zip(after, before)]
        want_step = [1, 0, 0] if want == "fused" else [0, 1, 1]
        _log(f"check autograd {label} bf16 causal={causal}: rel err "
             f"{e:.2e}, launches fused/dq/dkv {step}")
        if e > BWD_TOL["bfloat16"] or step != want_step:
            raise AssertionError(f"autograd through flash_attention at "
                                 f"{label}: err {e}, launches {step}")

    timings = {}
    for kind, B, H, L, D, causal in [("fused", 32, 12, 512, 64, False),
                                     ("dq", 4, 16, 2048, 128, True),
                                     ("dkv", 4, 16, 2048, 128, True)]:
        launch = {"fused": fa.launch_bwd_fused, "dq": fa.launch_bwd_dq,
                  "dkv": fa.launch_bwd_dkv}[kind]
        # f32 (the CUDA-core kernels), then bf16 (the tensor cores), each
        # with the plain version and SDPA's backward in the same dtype
        for dname in ("float32", "bfloat16"):
            dt = dtypes[dname]
            shape = (f"B={B} H={H} Lq=Lk={L} D={D} {dname} "
                     f"{'causal' if causal else 'non-causal'}")
            q, k, v, do = (torch.randn(B, H, L, D, generator=gen, device=dev)
                           .to(dt) for _ in range(4))
            scale = 1.0 / D ** 0.5
            out, lse = fa._fwd(q, k, v, None, None, causal, scale)
            x = fa.prepare_bwd(q, k, v, None, None, out, lse, do, causal,
                               scale)
            t_k = _time_ms(torch, lambda: launch(x))
            bound, bound_by = _bwd_bound_ms(kind, B, H, L, L, D, dname,
                                            causal)
            t_p = _time_ms(torch, lambda: fa.flash_attention_backward_reference(
                q, k, v, None, None, out, lse, do, causal, scale), iters=3,
                reps=3)
            # SDPA's backward alone: dq, dk, dv of one recorded forward
            qg, kg, vg = (t.clone().requires_grad_() for t in (q, k, v))
            o = torch.nn.functional.scaled_dot_product_attention(
                qg, kg, vg, is_causal=causal, scale=scale)

            def sdpa_bwd():
                return torch.autograd.grad(o, (qg, kg, vg), do,
                                           retain_graph=True)

            t_le = _time_ms(torch, sdpa_bwd)
            t_l, names = _device_ms(torch, sdpa_bwd)
            del o
            rec = {"shape": shape, "ms": t_k, "plain_ms": t_p,
                   "library_ms": t_l, "library_events_ms": t_le,
                   "library_kernels": names, "bound_ms": bound,
                   "bound_by": bound_by}
            pre = "f32_" if dname == "float32" else ""
            timings.setdefault(kind, {}).update(
                {pre + key: val for key, val in rec.items()})
            _log(f"time bwd {kind} {shape}: kernel {t_k:.4f} ms, "
                 f"plain {t_p:.4f} ms, sdpa bwd (dq+dk+dv) {t_l:.4f} ms "
                 f"device kernels, {t_le:.4f} ms CUDA events, bound "
                 f"{bound:.4f} ms ({bound_by}), kernel/bound "
                 f"{t_k / bound:.2f}, kernel/sdpa {t_k / t_l:.2f}; sdpa ran "
                 f"{names}")
    return errors, worst, timings


def oracle_phase(torch, llama, serving):
    """Paged serving on the card == greedy full re-encode (token identity,
    the reference's serving oracle); prefill and re-encode run at L=256,
    so both go through the flash kernel."""
    gen = torch.Generator(device="cuda").manual_seed(7)
    net = llama.llama_model("llama_small", vocab_size=101, device="cuda",
                            generator=gen, init_std=0.05)
    P = 256
    eng = serving.ServingEngine(net, eos_id=-1, max_batch=4, block_tokens=16,
                                max_seq=P, prefill_tokens=P)
    rng = np.random.RandomState(7)
    prompts = [rng.randint(3, 101, n).tolist() for n in (5, 40, 131, 200)]
    new = 12
    outs = eng.generate(prompts, max_new_tokens=new)
    with torch.inference_mode():
        for p, got in zip(prompts, outs):
            buf = torch.zeros((1, P), dtype=torch.long, device="cuda")
            buf[0, :len(p)] = torch.tensor(p)
            n, want = len(p), []
            for _ in range(new):
                nxt = int(net(buf)[0, n - 1].argmax())
                want.append(nxt)
                buf[0, n] = nxt
                n += 1
            if got != want:
                raise AssertionError(
                    f"served tokens {got} != re-encode {want} for a "
                    f"{len(p)}-token prompt")
    _log(f"oracle llama_small: {len(prompts)} requests token-identical to "
         f"greedy re-encode")


def serve_phase(torch, fa, llama, serving, args):
    vocab = 128256
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    t0 = time.perf_counter()
    net = llama.llama_model("llama3_8b", vocab_size=vocab, device="cuda",
                            generator=gen, init_std=0.02)
    torch.cuda.synchronize()
    layers = len(net.blocks)
    n_params = sum(p.numel() for p in net.parameters())
    if {p.dtype for p in net.parameters()} != {torch.float32}:
        raise AssertionError("llama3_8b serving is meant to run in f32")
    _log(f"serve: llama3_8b layers={layers} params={n_params} "
         f"({n_params * 4 / 1e9:.2f} GB f32) built in "
         f"{time.perf_counter() - t0:.1f} s")
    eng = serving.ServingEngine(net, eos_id=-1, max_batch=8, block_tokens=16,
                                max_seq=2048, prefill_tokens=1024)
    ad = eng.adapter
    prefill_s, decode_s = [], []
    orig_prefill, orig_decode = ad.prefill, ad.decode

    def timed_prefill(*a, **kw):
        t = time.perf_counter()
        r = orig_prefill(*a, **kw)           # returns a host int: synced
        prefill_s.append(time.perf_counter() - t)
        return r

    def timed_decode(*a, **kw):
        t = time.perf_counter()
        r = orig_decode(*a, **kw)            # returns host numpy: synced
        decode_s.append(time.perf_counter() - t)
        return r

    ad.prefill, ad.decode = timed_prefill, timed_decode
    rng = np.random.RandomState(args.seed)
    lens = np.linspace(100, 1000, 8).astype(int)
    prompts = [rng.randint(3, vocab, int(n)).tolist() for n in lens]
    new = 16
    _reset_counts(fa)
    t0 = time.perf_counter()
    outs = eng.generate(prompts, max_new_tokens=new)
    wall = time.perf_counter() - t0
    counts = _counts(fa)
    launches = counts["flash_fwd"]
    ad.prefill, ad.decode = orig_prefill, orig_decode
    for p, o in zip(prompts, outs):
        if len(o) != new or not all(0 <= t < vocab for t in o):
            raise AssertionError(f"bad output for a {len(p)}-token prompt: "
                                 f"{o}")
    if len(prefill_s) < len(prompts) or launches < layers * len(prefill_s):
        raise AssertionError(
            f"flash kernel launched {launches} times over {len(prefill_s)} "
            f"prefills of {layers} layers")
    _log(f"serve: {len(prompts)} requests x {new} tokens in {wall:.2f} s; "
         f"{len(prefill_s)} prefills (P=1024) median "
         f"{statistics.median(prefill_s) * 1e3:.1f} ms "
         f"[{', '.join(f'{s * 1e3:.1f}' for s in prefill_s)}]; "
         f"{len(decode_s)} decode steps (B=8) median "
         f"{statistics.median(decode_s) * 1e3:.1f} ms; flash launches "
         f"{launches} ({launches / len(prefill_s):.1f} per prefill); "
         f"launches {counts}")
    row = np.zeros(eng.cache.max_blocks_per_seq, np.int32)   # scratch row
    tok_k, logits_k = ad.prefill_logits(prompts[-1], row)
    tok_p, logits_p = ad.prefill_logits(prompts[-1], row,
                                        flash_reference=True)
    if not bool(torch.isfinite(logits_k).all()):
        raise AssertionError("non-finite prefill logits")
    err = (logits_k - logits_p).abs().max().item()
    _log(f"serve: prefill logits kernel vs plain max abs err {err:.3e} "
         f"(|logits| max {logits_p.abs().max().item():.3f}, tol "
         f"{LOGITS_TOL}); first token kernel {tok_k} plain {tok_p} "
         f"served {outs[-1][0]}")
    if err > LOGITS_TOL or tok_k != outs[-1][0]:
        raise AssertionError("prefill with the kernel disagrees with the "
                             "plain version or with the served token")
    return counts


TRAIN_TOL = 1e-4       # relative, per-step losses card vs CPU (f32)


def _bert_loss(ops_nn):
    def loss_fn(out, labels):
        logits = out[2]
        return ops_nn.softmax_cross_entropy(
            logits.reshape(-1, logits.shape[-1]).float(),
            labels.reshape(-1)) / labels.numel()
    return loss_fn


def _llama_loss(ops_nn):
    def loss_fn(out, labels):
        return ops_nn.softmax_cross_entropy(
            out.reshape(-1, out.shape[-1]).float(),
            labels.reshape(-1)) / labels.numel()
    return loss_fn


_COUNTERS = {"flash_fwd": "launches",
             "flash_bwd_fused": "bwd_fused_launches",
             "flash_bwd_dq": "bwd_dq_launches",
             "flash_bwd_dkv": "bwd_dkv_launches",
             "flash_fwd_wide_bf16": "fwd_wide_bf16_launches",
             "flash_bwd_fused_wide_bf16": "bwd_fused_wide_bf16_launches",
             "flash_bwd_dq_wide_bf16": "bwd_dq_wide_bf16_launches",
             "flash_bwd_dkv_wide_bf16": "bwd_dkv_wide_bf16_launches",
             "flash_fwd_f32": "fwd_f32_launches",
             "flash_bwd_fused_f32": "bwd_fused_f32_launches",
             "flash_bwd_dq_f32": "bwd_dq_f32_launches",
             "flash_bwd_dkv_f32": "bwd_dkv_f32_launches"}


def _counts(fa):
    return {k: getattr(fa, attr) for k, attr in _COUNTERS.items()}


def _reset_counts(fa):
    for attr in _COUNTERS.values():
        setattr(fa, attr, 0)


def train_oracle_phase(torch, fa, mx):
    """A small model trains 3 steps on the card (kernels) and on the CPU
    (plain versions) from the same weights and batches, f32: per-step
    losses agree to TRAIN_TOL relative.  bert_3_128_2 at seq 512 runs the
    fused backward, llama_small at seq 1024 (causal) the dq + dkv pair."""
    import copy
    bert, llama = mx["bert"], mx["llama"]
    cases = [
        ("bert_3_128_2 seq 512", lambda g: bert.bert_model(
            "bert_3_128_2", vocab_size=1000, max_length=512, dropout=0.0,
            device="cpu", generator=g), _bert_loss(mx["nn"]), 4, 512,
         "flash_bwd_fused"),
        ("llama_small seq 1024", lambda g: llama.llama_model(
            "llama_small", vocab_size=1000, device="cpu", generator=g),
         _llama_loss(mx["nn"]), 2, 1024, "flash_bwd_dq"),
    ]
    for label, build, loss_fn, B, L, kernel in cases:
        cpu_net = build(torch.Generator().manual_seed(11))
        card_net = copy.deepcopy(cpu_net).to("cuda")
        rng = np.random.RandomState(12)
        toks = rng.randint(0, 1000, (3, B, L))
        labs = rng.randint(0, 1000, (3, B, L))
        losses = []
        _reset_counts(fa)
        for net in (card_net, cpu_net):
            step = mx["parallel"].TrainStep(
                net, loss_fn, "adam", optimizer_params={"learning_rate": 1e-3})
            losses.append(step.run(toks, labs).cpu().numpy())
        counts = _counts(fa)
        rel = float(np.max(np.abs(losses[0] - losses[1])
                           / np.abs(losses[1])))
        _log(f"oracle train {label}: card {losses[0].tolist()} cpu "
             f"{losses[1].tolist()} rel {rel:.2e} (tol {TRAIN_TOL}); "
             f"launches {counts}")
        if not rel <= TRAIN_TOL or counts[kernel] < 3:
            raise AssertionError(f"train oracle {label} failed: rel {rel}, "
                                 f"launches {counts}")


def _profiled(torch, fn):
    """Run fn once under torch.profiler: (wall ms to the end of its device
    work, [(device ms, count, kernel name)] largest first)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    rows = []
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:
            continue            # host ops: their kernels are listed apart
        dev_us = getattr(ev, "self_device_time_total",
                         getattr(ev, "self_cuda_time_total", 0))
        if dev_us > 0:
            rows.append((dev_us / 1e3, ev.count, ev.key))
    rows.sort(reverse=True)
    return wall, rows


def _device_ms(torch, fn, iters=20):
    """(device time per call of fn, names of the kernels it ran, cut to 100
    characters): the sum of its kernels' times in one torch.profiler window
    of ``iters`` calls, after a warm-up."""
    for _ in range(3):
        fn()

    def window():
        for _ in range(iters):
            fn()

    _, rows = _profiled(torch, window)
    return (sum(r[0] for r in rows) / iters,
            sorted({r[2][:100] for r in rows}))


def _profile_step(torch, step_fn, label):
    """Device time of one step by kernel family (torch.profiler), against
    the step's wall time; prints the top kernels."""
    wall, rows = _profiled(torch, step_fn)
    total = sum(r[0] for r in rows)
    fams = {"flash_fwd": 0.0, "flash_bwd": 0.0, "gemm": 0.0, "other": 0.0}
    for ms, _, key in rows:
        k = key.lower()
        fam = "flash_fwd" if "flash_fwd" in k else \
            "flash_bwd" if "flash_bwd" in k else \
            "gemm" if any(w in k for w in ("gemm", "xmma", "cutlass",
                                           "nvjet")) else "other"
        fams[fam] += ms
    _log(f"profile {label}: one step wall {wall:.1f} ms, device busy "
         f"{total:.1f} ms (idle share {max(0.0, 1 - total / wall):.3f}); "
         + ", ".join(f"{k} {v:.1f} ms" for k, v in fams.items()))
    for ms, n, key in rows[:12]:
        _log(f"profile {label}:   {ms:9.3f} ms  x{n:<4d} {key[:100]}")
    return {"wall_ms": wall, "device_ms": total, "families": fams}


# bench.py's training lanes (:529-535) and the dtype each runs in; the f32
# lanes are the same lanes under MXNET_BENCH_DTYPE=float32 (bench.py:392),
# with plain f32 Adam as bench.py takes it there (multi_precision only for
# bf16)
TRAIN_LANES = (("bert_seq512", "bfloat16"), ("llama_seq2048", "bfloat16"),
               ("bert_seq512_f32", "float32"),
               ("llama_seq2048_f32", "float32"))


def train_lane_phase(torch, fa, mx, args, lanes=TRAIN_LANES):
    """bench.py's training lanes at full width on the card: weights
    Normal(0.02) from a seeded generator on the card in the lane's dtype,
    Adam at lr 1e-4 (multi_precision for bf16, plain for f32), dropout 0;
    K steps on one repeated batch.  The loss must be finite and fall; each
    step must launch the forward and the backward kernels per layer, in the
    lane's dtype and on its route (bf16: tensor cores only; f32: no bf16
    launch); prints median step ms, samples/s, MFU (bench.py's flop
    formulas against the dtype's peak) and peak memory."""
    bert, llama = mx["bert"], mx["llama"]
    results = {}
    counts_total = {k: 0 for k in _counts(fa)}
    steps = 8

    class WithLength(torch.nn.Module):
        """BERT called with a settable valid_length (None = unpadded)."""

        def __init__(self, net):
            super().__init__()
            self.net = net
            self.valid_length = None

        def forward(self, x):
            return self.net(x, self.valid_length)

    for lane, dname in lanes:
        dtype = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dname]
        f32 = dname == "float32"
        # earlier phases' models (llama3_8b's 32 GB) may sit in reference
        # cycles until a collection: free them before measuring the peak
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        _log(f"lane {lane}: {torch.cuda.memory_allocated() / 2**30:.2f} GiB "
             f"allocated before the model is built")
        gen = torch.Generator(device="cuda").manual_seed(args.seed)
        t0 = time.perf_counter()
        sfx = "_f32" if f32 else ""
        if lane.startswith("bert_seq512"):
            layers, units, B, L, vocab = 12, 768, 32, 512, 30522
            core = bert.bert_model("bert_12_768_12", vocab_size=vocab,
                                   max_length=L, dropout=0.0, dtype=dtype,
                                   generator=gen)
            net = WithLength(core)
            loss_fn = _bert_loss(mx["nn"])
            n_matmul = sum(p.numel() for n, p in core.named_parameters()
                           if "word_embed" not in n and "position" not in n)
            flops_tok = 6 * n_matmul + 12 * layers * units * L
            want = {"flash_fwd" + sfx: layers, "flash_bwd_fused" + sfx: layers}
        else:
            layers, units, B, L, vocab = 8, 2048, 4, 2048, 8192
            with torch.device("meta"):
                net = llama.LlamaModel(vocab_size=vocab, num_layers=layers,
                                       units=units, hidden=5504, heads=16,
                                       kv_heads=8, dtype=dtype)
            net = net.to_empty(device="cuda")
            net.init_weights(gen, 0.02)
            loss_fn = _llama_loss(mx["nn"])
            n_matmul = sum(p.numel() for n, p in net.named_parameters()
                           if not n.startswith("embed"))
            flops_tok = 6 * n_matmul + 6 * layers * units * L
            want = {"flash_fwd" + sfx: layers, "flash_bwd_dq" + sfx: layers,
                    "flash_bwd_dkv" + sfx: layers}
        if {p.dtype for p in net.parameters()} != {dtype}:
            raise AssertionError(f"{lane}: weights are not all {dname}")
        n_params = sum(p.numel() for p in net.parameters())
        opt = mx["optimizer"].Adam(learning_rate=1e-4, multi_precision=not f32)
        step = mx["parallel"].TrainStep(net, loss_fn, opt)
        rng = np.random.RandomState(args.seed)
        toks = torch.tensor(rng.randint(0, vocab, (B, L)), device="cuda")
        labs = torch.tensor(rng.randint(0, vocab, (B, L)), device="cuda")
        torch.cuda.synchronize()
        _log(f"lane {lane}: {n_params} params ({n_matmul} in matmuls), "
             f"{dname}, built in {time.perf_counter() - t0:.1f} s")
        _reset_counts(fa)
        losses, step_ms = [], []
        for _ in range(steps):
            t = time.perf_counter()
            losses.append(step(toks, labs))
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t) * 1e3)
        counts = _counts(fa)
        losses = [float(x) for x in losses]
        prof = _profile_step(torch, lambda: step(toks, labs), lane)
        extra = {}
        if lane.startswith("bert_seq512"):
            # one step on a padded batch: segment ids reach the kernels
            lens = torch.tensor(rng.randint(L // 2, L + 1, B), device="cuda")
            net.valid_length = lens
            before = fa.bwd_fused_launches
            padded_loss = float(step(toks, labs))
            net.valid_length = None
            extra = {"padded_loss": padded_loss,
                     "padded_fused": fa.bwd_fused_launches - before}
            if not np.isfinite(padded_loss) or extra["padded_fused"] < layers:
                raise AssertionError(f"padded BERT step: {extra}")
        peak = torch.cuda.max_memory_allocated()
        med = statistics.median(step_ms[2:])
        sps = B / (med / 1e3)
        mfu = sps * L * flops_tok / PEAK_FLOPS[dname]
        for k in counts_total:
            counts_total[k] += counts[k]
        _log(f"lane {lane}: losses {[round(x, 5) for x in losses]}; step ms "
             f"{[round(x, 1) for x in step_ms]}; median (steps 3-{steps}) "
             f"{med:.2f} ms, {sps:.2f} samples/s, MFU {mfu:.4f} "
             f"({PEAK_FLOPS[dname] / 1e12:.0f} TFLOP/s {dname}), peak memory "
             f"{peak / 2**30:.2f} GiB; launches over {steps} steps {counts} "
             f"{extra}")
        if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
            raise AssertionError(f"{lane}: losses not finite and falling: "
                                 f"{losses}")
        for k, per_step in want.items():
            if counts[k] < per_step * steps:
                raise AssertionError(f"{lane}: {k} launched {counts[k]} "
                                     f"times in {steps} steps of {layers} "
                                     f"layers")
        wide = sum(n for k, n in counts.items() if k.endswith("_wide_bf16"))
        if wide:
            raise AssertionError(f"{lane}: {wide} bf16 launches ran on the "
                                 f"CUDA-core route for wide heads")
        # every launch in the lane's dtype: the f32 counters count all of
        # them in an f32 lane and none in a bf16 lane
        for kernel in ("flash_fwd", "flash_bwd_fused", "flash_bwd_dq",
                       "flash_bwd_dkv"):
            n, n32 = counts[kernel], counts[kernel + "_f32"]
            if n32 != (n if f32 else 0):
                raise AssertionError(f"{lane}: {n - n32} bf16 and {n32} f32 "
                                     f"{kernel} launches in a {dname} lane")
        results[lane] = {"step_ms": med, "samples_per_s": sps, "mfu": mfu,
                         "peak_gib": peak / 2**30, "profile": prof}
        step = opt = net = core = None
    return counts_total, results


def _ptxas_summary(log):
    """(kernel<template args>, registers, spill-store bytes, ptxas's spill
    line) for every compiled kernel."""
    out, name, spill = [], None, ""
    for line in log.splitlines():
        if "Compiling entry function" in line:
            mangled = line.split("'")[1]
            m = re.search(r"(flash_[a-z_]*?(?:bf16_tc_)?kernel)I(.*?)E+v",
                          mangled)
            name, spill = (f"{m.group(1)}<{m.group(2)}>" if m
                           else mangled[-60:]), ""
        elif "spill stores" in line and name:
            spill = line.strip()
        elif "Used" in line and "registers" in line and name:
            regs = line.split("Used")[1].split(",")[0].strip()
            m = re.search(r"(\d+) bytes spill stores", spill)
            out.append((name, regs, int(m.group(1)) if m else 0, spill))
            name = None
    return out


def _phase(label, fn, *a):
    t0 = time.perf_counter()
    r = fn(*a)
    _log(f"phase {label}: {time.perf_counter() - t0:.1f} s")
    return r


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        from mxnet_tpu_torch.kernels import _build
        from mxnet_tpu_torch.kernels import flash_attention as fa
        from mxnet_tpu_torch.gluon.model_zoo import bert, llama
        from mxnet_tpu_torch import optimizer, parallel, serving
        from mxnet_tpu_torch.ops import nn as ops_nn
    except ImportError as e:
        print(f"chip_smoke: the port is not importable here: {e}",
              file=sys.stderr)
        return 3
    mx = {"bert": bert, "llama": llama, "optimizer": optimizer,
          "parallel": parallel, "nn": ops_nn}

    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    _log(f"device: {kind} (torch {torch.__version__}, CUDA "
         f"{torch.version.cuda}, {torch.cuda.device_count()} visible)")
    _log(smi)

    t0 = time.perf_counter()
    _build.build_kernel_libraries(["flash_fwd", "flash_bwd"])
    _log(f"build: flash_fwd.cu and flash_bwd.cu for sm_90a (two nvcc in "
         f"parallel) in {time.perf_counter() - t0:.1f} s")
    for src in ("flash_fwd", "flash_bwd"):
        for name, regs, spilled, spill in _ptxas_summary(
                _build.build_log(src)):
            # every kernel but the CUDA-core dq (a known spill, its own
            # redesign) must keep its registers
            known = name.startswith("flash_bwd_dq_kernel<")
            _log(f"ptxas {src}: {name}: {regs}; {spill}"
                 + (" (reported, not failed)" if known and spilled else ""))
            if spilled and not known:
                raise AssertionError(f"{name} spills {spilled} bytes")

    errors, timings, sdpa_kernels = _phase("forward kernel", kernel_phase,
                                           torch, fa)
    bwd_errors, _, bwd_times = _phase("backward kernels", bwd_kernel_phase,
                                      torch, fa)
    _phase("serving oracle", oracle_phase, torch, llama, serving)
    serve_counts = _phase("serve", serve_phase, torch, fa, llama, serving,
                          args)
    _phase("train oracle", train_oracle_phase, torch, fa, mx)
    train_launches, lanes = _phase("train lanes", train_lane_phase, torch,
                                   fa, mx, args)

    t_k, t_p, t_l, bound, bound_by = timings[("prefill", "float32")]
    kernels = [{
        "name": "flash_fwd",
        "route": "cuda",
        "source": "mxnet_tpu_torch/kernels/csrc/flash_fwd.cu",
        "replaces": "mxnet_tpu/kernels/flash_attention.py:185,248",
        "shape": "B=1 H=32 Lq=Lk=1024 D=128 float32 causal",
        "launches": train_launches["flash_fwd"],
        "serve_launches": serve_counts["flash_fwd"],
        "max_abs_err": errors[("prefill", "float32", True, False)][0],
        "ms": t_k,
        "plain_ms": t_p,
        "bound_ms": bound,
        "bound_by": bound_by,
        "library_ms": t_l,
        "library_kernels": sdpa_kernels["prefill"],
        # f32 launches counted by the wrapper in serving and the lanes
        "f32_launches": serve_counts["flash_fwd_f32"]
        + train_launches["flash_fwd_f32"],
    }]
    t_k, t_p, t_l, bound, bound_by = timings[("single-tile", "float32")]
    kernels[0].update({
        "single_tile_shape": "B=2 H=32 Lq=Lk=512 D=128 float32 causal",
        "single_tile_ms": t_k, "single_tile_plain_ms": t_p,
        "single_tile_library_ms": t_l, "single_tile_bound_ms": bound,
        "single_tile_bound_by": bound_by,
        "single_tile_library_kernels": sdpa_kernels["single-tile"]})
    # the bf16 tensor-core kernel at the training lanes' shapes
    for lane, prefix in (("llama-lane", "lane"), ("bert-lane", "bert_lane")):
        t_k, t_p, t_l, bound, bound_by = timings[(lane, "bfloat16")]
        kernels[0].update({
            f"{prefix}_shape": {"llama-lane": "B=4 H=16 Lq=Lk=2048 D=128 "
                                              "bfloat16 causal",
                                "bert-lane": "B=32 H=12 Lq=Lk=512 D=64 "
                                             "bfloat16 non-causal"}[lane],
            f"{prefix}_ms": t_k, f"{prefix}_plain_ms": t_p,
            f"{prefix}_library_ms": t_l, f"{prefix}_bound_ms": bound,
            f"{prefix}_bound_by": bound_by})
    def err_of(kind_, dname):
        if kind_ == "fused":
            return max(bwd_errors[("bert-lane", dname, False, False)])
        e = bwd_errors[("llama-lane", dname, True, False)]
        return e[0] if kind_ == "dq" else max(e[1:])

    # one entry per backward entry point and dtype: bf16 runs the
    # tensor-core kernels (tc::), f32 the CUDA-core ones; launches are the
    # train lanes' (the bf16 lanes' for bf16, the f32 lanes' for f32)
    cuda_core = {"fused": "simt::flash_bwd_dkv_kernel<float, DP, BK, BQ, "
                          "true>",
                 "dq": "flash_bwd_dq_kernel<float, NG>",
                 "dkv": "simt::flash_bwd_dkv_kernel<float, DP, BK, BQ, "
                        "false>"}
    for kind_, line in (("fused", 464), ("dq", 373), ("dkv", 417)):
        t = bwd_times[kind_]
        n_all = train_launches[f"flash_bwd_{kind_}"]
        n_f32 = train_launches[f"flash_bwd_{kind_}_f32"]
        for dname, pre in (("bfloat16", ""), ("float32", "f32_")):
            kernels.append({
                "name": f"flash_bwd_{kind_}" + ("_f32" if pre else ""),
                "kernel": cuda_core[kind_] if pre
                else f"tc::flash_bwd_{kind_}_bf16_tc_kernel<DP>",
                "route": "cuda",
                "source": "mxnet_tpu_torch/kernels/csrc/flash_bwd.cu",
                "replaces": f"mxnet_tpu/kernels/flash_attention.py:{line}",
                "shape": t[pre + "shape"],
                "launches": n_f32 if pre else n_all - n_f32,
                "max_abs_err": err_of(kind_, dname),
                "ms": t[pre + "ms"],
                "plain_ms": t[pre + "plain_ms"],
                "bound_ms": t[pre + "bound_ms"],
                "bound_by": t[pre + "bound_by"],
                "library_ms": t[pre + "library_ms"],
                "library_events_ms": t[pre + "library_events_ms"],
                "library_kernels": t[pre + "library_kernels"],
            })
    for lane, r in lanes.items():
        _log(f"train {lane}: step {r['step_ms']:.2f} ms, "
             f"{r['samples_per_s']:.2f} samples/s, MFU {r['mfu']:.4f}, peak "
             f"{r['peak_gib']:.2f} GiB ({smi})")
    _log(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
