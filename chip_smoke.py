#!/usr/bin/env python3
"""On-card smoke of the PyTorch/CUDA port (``mxnet_tpu_torch``) on one GPU.

Run from the repository root with no arguments:  ``python3 chip_smoke.py``

Phases (a failing phase makes the script exit non-zero and print no
result line; each prints its seconds):
 1. device — the card's name and, as ``nvidia-smi --query-gpu=name,
    power.limit --format=csv,noheader`` gives them, its power limit;
 2. build — compile ``kernels/csrc/flash_fwd.cu`` and ``flash_bwd.cu`` for
    sm_90a from this checkout, one nvcc each, in parallel; ptxas registers
    and spills per kernel (the phase fails if any kernel spills);
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
    dkv and a head_dim sweep on both routes; two f32 dq and two f32 dkv
    launches at the llama lane shape, and the dk, dv of two f32 fused
    launches at the BERT lane shape, must agree bit for bit; autograd through
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
    peak memory, and one profiled step's device time by kernel family;
 9. gluon — MXNet's canonical Gluon loop (``autograd.record()``,
    ``SoftmaxCELoss``, ``backward()``, ``gluon.Trainer("adam").step(B)``)
    over the Gluon BERT: (a) bert_3_128_2 built on the CPU and carried to
    the card by its ``collect_params()`` names trains 3 steps on a padded
    seq-512 batch on both devices, per-step losses agreeing; (b)
    bert_12_768_12 (vocab 30522, batch 32, seq 512) in f32, hybridized,
    8 steps, then the same weights and batch through ``TrainStep``
    (per-step losses agree) and 3 steps not hybridized (the NDArray path;
    losses agree); (c) the same model cast to bf16 with multi-precision
    Adam, 8 steps, then ``TrainStep`` the same; every Gluon step launches
    12 forward and 12 fused-backward kernels of its dtype's route; median
    step ms, samples/s, MFU, peak memory and profiled idle share of the
    Gluon loop beside ``TrainStep``'s;
10. vision — the convolution, pooling, BatchNorm and pad ops card vs CPU,
    a small bottleneck ResNet (7x7 stem, max-pool) card vs CPU on the
    same weights carried by name (predict outputs, one SGD step, the
    running statistics), then bench.py's ResNet-50 lane: resnet50_v1
    (classes 1000, Xavier, hybridized) at batch 64, 224x224, 8 SGD
    momentum steps on one batch through the Gluon loop and through
    ``TrainStep``, in f32 and after ``net.cast("bfloat16")`` (BatchNorm
    kept f32, multi-precision SGD); 2 imperative steps; the two paths
    agreeing under deterministic cuDNN; ``save_parameters`` /
    ``load_parameters`` into a fresh net bit-identical in npz and dmlc
    (and bf16 in npz); no flash launch, no TF32 kernel in f32; step ms,
    images/s, FLOPs per step (counted from the layers), MFU, peak memory,
    idle share and device time by kernel family;
11. loop — MXNet's training loop around the model: (a) every optimizer
    of ``mx.optimizer`` with a schedule, 3 steps of the small bottleneck
    ResNet on the card and on the CPU, f32 and bf16 (multi_precision: the
    f32 masters held as f32, each bf16 weight its master rounded);
    ``update_on_kvstore`` against the trainer's update and an explicit
    store, bit for bit; ``save_states``/``load_states`` mid-run bit for
    bit; a 4-worker DataLoader bit-identical to one process; (b)
    resnet50_v1 one epoch (10 steps of 64 from 640 host images of ten
    classes) through ``gluon.data.DataLoader(num_workers=4)`` with
    RandomFlipLeftRight, ToTensor and Normalize, NAG with a MultiFactor
    schedule, ``Trainer(kvstore="local")``, accuracy, top-5 and loss
    metrics every batch, f32 and bf16, beside the vision phase's loop (SGD,
    one pre-staged batch); the local store's reduction of ResNet-50's
    gradients timed at 1, 2 and 4 replicas on the card; NAG at 0.025 in
    f32 and bf16 through the Trainer and in bf16 through TrainStep, each
    Trainer step held against a plain NAG, the loss curves printed; (d)
    ``Estimator.fit`` of resnet18_v1 over 4 batches with a
    CheckpointHandler, reloaded bit for bit; (c) BERT-base bf16 10
    steps from a 2-worker DataLoader, LAMB with polynomial warmup-decay,
    Loss and Accuracy of the argmax, beside the gluon phase's Adam loop;
    losses falling, the schedules' rates, no loader fallback, no worker
    left, 12 bf16 forward and 12 bf16 fused backward launches a BERT step;
    step ms, images or samples/s, MFU, peak memory, idle share, ms in
    next() and in the metrics' update;
12. nd — the rest of ``mx.nd``: (a) every op the port registers, the
    samplers apart (``mxnet_tpu_torch/ops/sweep.py``: 268 ops under 309
    names), on the card and on the CPU from the same numpy inputs,
    outputs, dtypes and the gradients of the differentiable ops; (b) every
    sampler on the card: one seed twice gives the same draws, two seeds
    different ones; at 10^6 draws per parameter set the mean and variance
    within 5 standard errors and a goodness-of-fit p-value (KS, or
    chi-square for a discrete distribution) above 1e-3; (c)
    ``contrib.masked_encdec_att`` (B 32, Lq 256, Lk 512, valid lengths in
    [256, 512]) and ``contrib.multihead_attention`` (self length 512,
    causal and not) at the zoo transformer's base widths (512 units, 8
    heads) in f32 and bf16, forward and gradients, against the same op
    with the flash call bound to its plain version on the card and against
    the CPU; their device ms and the flash kernels' share.
The second-to-last line is ``{"kernels": [...]}``: ``flash_fwd`` at the
f32 prefill shape (``launches`` counts all train lanes' timed steps,
``serve_launches`` the serve phase's, ``f32_launches`` the f32 launches of
both, ``gluon_launches`` those of the Gluon loop's timed steps, f32 and
bf16), and each backward entry point twice, bf16 (``flash_bwd_*``, the
tensor-core kernels, launches of the bf16 lanes) and f32
(``flash_bwd_*_f32``, the CUDA-core kernels, launches of the f32 lanes),
the fused ones with the Gluon loop's launches in its dtype
(``gluon_launches``), every entry with the vision phase's launches
(``vision_launches``, 0: ResNet-50 has no attention) and the loop
phase's BERT steps (``loop_launches``: the bf16 forward and fused
backward; 0 elsewhere) and the nd phase's attention ops (``nd_launches``:
the forward and, in each dtype's row, the fused backward, which both
shapes take; 0 on dq and dkv);
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
1e-3.  Train oracle: per-step losses 1e-4 relative (f32, 3 Adam steps);
the same for the Gluon oracle, the Gluon loop against ``TrainStep`` (f32,
8 steps) and the imperative against the hybridized loop (f32, 3 steps).
Vision: each op card vs CPU 1e-5 of max |ref| (f32 sums in another
order; 6.2e-7 seen on an H100); the small ResNet's outputs, loss and
statistics 1e-4 of max |ref|; the ResNet-50 Gluon loop against
``TrainStep`` and the imperative steps TRAIN_TOL relative, under
deterministic cuDNN (0 seen); checkpoints bit for bit.  Loop: the
optimizers card vs CPU ``LOOP_ORACLE_TOL`` (below), the loader, the
store and the states bit for bit.  nd: each op card vs CPU 1e-5 of max
|CPU| elementwise and 1e-4 for sums, products, linear algebra and
attention (cuBLAS and cuSOLVER sum in another order), gradients 1e-4,
decompositions by their invariants (reconstruction and orthogonality 1e-4
of |A|, values 1e-4); the attention ops against their plain flash
versions at the kernel phases' bounds, against the CPU f32 2e-5 out and
1e-4 gradients, bf16 2^-6 of max |ref| (``ND_BF16_HOST_TOL``).
"""

from __future__ import annotations

import argparse
import gc
import json
import math
import os
import random
import re
import statistics
import subprocess
import sys
import tempfile
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

    # the CUDA-core dq and dkv kernels sum without atomics: two launches on
    # the same inputs give the same bits, and so do fused's dk, dv (its dq
    # goes through atomics and is not reproducible bit for bit)
    for kind, B, H, L, D, causal in [("dq", 4, 16, 2048, 128, True),
                                     ("dkv", 4, 16, 2048, 128, True),
                                     ("fused", 32, 12, 512, 64, False)]:
        q, k, v, do = (torch.randn(B, H, L, D, generator=gen, device=dev)
                       for _ in range(4))
        out, lse = fa._fwd(q, k, v, None, None, causal, D ** -0.5)
        x = fa.prepare_bwd(q, k, v, None, None, out, lse, do, causal,
                           D ** -0.5)
        launch, what = {
            "dq": (lambda x: (fa.launch_bwd_dq(x),), "dq"),
            "dkv": (fa.launch_bwd_dkv, "dk, dv"),
            "fused": (lambda x: fa.launch_bwd_fused(x)[1:], "dk, dv")}[kind]
        first, again = launch(x), launch(x)
        same = all(torch.equal(a, b) for a, b in zip(first, again))
        _log(f"check determinism bwd {kind} B={B} H={H} L={L} D={D} float32 "
             f"causal={causal}: {what} of two launches "
             f"{'bitwise equal' if same else 'DIFFER'}")
        if not same:
            raise AssertionError(f"flash_bwd {kind} f32 {what} is not "
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


def _dtype_count(counts, kind, f32):
    """Launches of backward entry point ``kind`` in f32 (``f32``) or in
    bf16 (all launches less the f32 ones; the phases run no other
    dtype)."""
    n_f32 = counts[f"flash_bwd_{kind}_f32"]
    return n_f32 if f32 else counts[f"flash_bwd_{kind}"] - n_f32


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


# kernel families of a profiled step: the first family one of whose words
# is in the kernel's name, else "other"
_GEMM_WORDS = ("gemm", "xmma", "cutlass", "nvjet")
FLASH_FAMILIES = (("flash_fwd", ("flash_fwd",)), ("flash_bwd", ("flash_bwd",)),
                  ("gemm", _GEMM_WORDS))
VISION_FAMILIES = (
    ("convolution", ("conv", "fprop", "dgrad", "wgrad", "winograd",
                     "implicit", "precomputed")),
    ("batchnorm", ("batch_norm", "batchnorm", "bn_fw", "bn_bw")),
    ("pooling", ("pool",)),
    ("gemm", _GEMM_WORDS),
    ("optimizer", ("foreach", "multi_tensor")))


def _profile_step(torch, step_fn, label, families=FLASH_FAMILIES, steps=1):
    """Device time of one step by kernel family (torch.profiler), against
    the step's wall time; prints the top kernels.  ``step_fn`` may run
    ``steps`` steps: times are then per step, averaged over them."""
    wall, rows = _profiled(torch, step_fn)
    wall /= steps
    rows = [(ms / steps, n, key) for ms, n, key in rows]
    total = sum(r[0] for r in rows)
    fams = dict.fromkeys([f for f, _ in families] + ["other"], 0.0)
    for ms, _, key in rows:
        k = key.lower()
        fam = next((f for f, words in families
                    if any(w in k for w in words)), "other")
        fams[fam] += ms
    _log(f"profile {label}: one step wall {wall:.1f} ms"
         + (f" (mean of {steps})" if steps > 1 else "")
         + f", device busy {total:.1f} ms (idle share "
         f"{max(0.0, 1 - total / wall):.3f}); "
         + ", ".join(f"{k} {v:.1f} ms" for k, v in fams.items()))
    for ms, n, key in rows[:12]:
        _log(f"profile {label}:   {ms:9.3f} ms  x{n:<4d} {key[:100]}")
    return {"wall_ms": wall, "device_ms": total, "families": fams,
            "kernels": [r[2] for r in rows]}


# bench.py's training lanes (:529-535) and the dtype each runs in; the f32
# lanes are the same lanes under MXNET_BENCH_DTYPE=float32 (bench.py:392),
# with plain f32 Adam as bench.py takes it there (multi_precision only for
# bf16)
TRAIN_LANES = (("bert_seq512", "bfloat16"), ("llama_seq2048", "bfloat16"),
               ("bert_seq512_f32", "float32"),
               ("llama_seq2048_f32", "float32"))


def train_lane_phase(torch, fa, mx, args):
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

    for lane, dname in TRAIN_LANES:
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


def _gluon_inputs(tmx, ctx, toks, labs, vl=None):
    """The batch as NDArrays on ``ctx``: (net inputs, labels)."""
    x = [tmx.nd.array(toks, ctx=ctx)]
    if vl is not None:
        x.append(tmx.nd.array(vl, ctx=ctx))
    return x, tmx.nd.array(labs, ctx=ctx)


def _gluon_steps(tmx, net, inputs, labels, steps, trainer):
    """``steps`` iterations of MXNet's canonical loop on one batch:
    record, SoftmaxCELoss on the f32 MLM logits, backward, Trainer.step(B).
    Returns the per-step losses (the per-token mean) and wall ms."""
    loss_fn = tmx.gluon.loss.SoftmaxCELoss()
    losses, step_ms = [], []
    for _ in range(steps):
        t = time.perf_counter()
        with tmx.autograd.record():
            logits = net(*inputs)[2].astype("float32", copy=False)
            loss = loss_fn(logits, labels)
        loss.backward()
        trainer.step(labels.shape[0])
        losses.append(loss.mean())
        tmx.nd.waitall()
        step_ms.append((time.perf_counter() - t) * 1e3)
    return [float(l.asscalar()) for l in losses], step_ms


def _rel(a, b):
    return float(np.max(np.abs(np.asarray(a) - np.asarray(b))
                        / np.abs(np.asarray(b))))


def gluon_oracle(torch, fa, tmx):
    """(a) bert_3_128_2 built once on the CPU, carried to the card by its
    collect_params() names; 3 hybridized Gluon steps on a padded batch on
    both devices: per-step losses agree to TRAIN_TOL."""
    bert = tmx.gluon.model_zoo.bert
    nets = {}
    for ctx in (tmx.cpu(), tmx.gpu()):
        nets[ctx] = bert.BERTModel(vocab_size=1000, num_layers=3, units=128,
                                   hidden_size=512, num_heads=2,
                                   max_length=512, dropout=0.0,
                                   prefix="bert_")
    tmx.random.seed(21)
    nets[tmx.cpu()].initialize(tmx.init.Normal(0.02), ctx=tmx.cpu())
    nets[tmx.gpu()].initialize(tmx.init.Zero(), ctx=tmx.gpu())
    card = nets[tmx.gpu()].collect_params()
    for name, p in nets[tmx.cpu()].collect_params().items():
        card[name].set_data(p.data())
    rng = np.random.RandomState(22)
    B, L = 4, 512
    toks = rng.randint(0, 1000, (B, L))
    labs = rng.randint(0, 1000, (B, L))
    vl = rng.randint(L // 2, L + 1, B)
    losses = {}
    for ctx in (tmx.gpu(), tmx.cpu()):
        net = nets[ctx]
        net.hybridize()
        trainer = tmx.gluon.Trainer(net.collect_params(), "adam",
                                    {"learning_rate": 1e-3})
        inputs, labels = _gluon_inputs(tmx, ctx, toks, labs, vl)
        if ctx == tmx.gpu():
            _reset_counts(fa)
        losses[ctx], _ = _gluon_steps(tmx, net, inputs, labels, 3, trainer)
        if ctx == tmx.gpu():
            counts = _counts(fa)
    rel = _rel(losses[tmx.gpu()], losses[tmx.cpu()])
    _log(f"oracle gluon bert_3_128_2 seq 512 padded {vl.tolist()}: card "
         f"{losses[tmx.gpu()]} cpu {losses[tmx.cpu()]} rel {rel:.2e} (tol "
         f"{TRAIN_TOL}); launches {counts}")
    if not rel <= TRAIN_TOL or counts["flash_bwd_fused"] < 3:
        raise AssertionError(f"gluon oracle failed: rel {rel}, launches "
                             f"{counts}")


def _lane_numbers(torch, dname, step_ms, B, L, flops_tok, prof):
    med = statistics.median(step_ms[2:])
    sps = B / (med / 1e3)
    return {"step_ms": med, "samples_per_s": sps,
            "mfu": sps * L * flops_tok / PEAK_FLOPS[dname],
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
            "idle_share": max(0.0, 1 - prof["device_ms"] / prof["wall_ms"])}


def gluon_phase(torch, fa, mx, args, smi):
    """The Gluon loop over bert_12_768_12 (vocab 30522, batch 32, seq 512,
    dropout 0) on the card: (a) the oracle above; (b) f32 (MXNet's default
    dtype): initialize(Normal(0.02), ctx=gpu), hybridize, Trainer("adam",
    lr 1e-4), 8 steps on one batch; then the same weights and batch through
    parallel.TrainStep (losses agree to TRAIN_TOL), and 3 steps of the
    imperative NDArray path (no hybridize; losses agree with the first 3);
    (c) bf16 via net.cast("bfloat16") and multi_precision Adam, 8 steps,
    then TrainStep the same.  Each Gluon step must launch 12 flash_fwd and
    12 fused backward kernels of the lane's dtype and route and no dq or
    dkv; losses finite and falling.  Prints step ms, samples/s, MFU, peak
    memory and profiled idle share of the Gluon loop beside TrainStep's."""
    tmx = mx["pkg"]
    gluon_oracle(torch, fa, tmx)
    bert = tmx.gluon.model_zoo.bert
    layers, units, B, L, vocab, steps = 12, 768, 32, 512, 30522, 8
    gc.collect()
    torch.cuda.empty_cache()
    gpu = tmx.gpu()
    net = bert.BERTModel(vocab_size=vocab, num_layers=layers, units=units,
                         hidden_size=3072, num_heads=12, max_length=L,
                         dropout=0.0, prefix="bert_")
    tmx.random.seed(args.seed)
    net.initialize(tmx.init.Normal(0.02), ctx=gpu)
    params = net.collect_params()
    start = {k: p.data()._data.detach().clone() for k, p in params.items()}
    n_matmul = sum(p.numel() for n, p in net.named_parameters()
                   if "word_embed" not in n and "position" not in n)
    flops_tok = 6 * n_matmul + 12 * layers * units * L
    rng = np.random.RandomState(args.seed)
    toks = rng.randint(0, vocab, (B, L))
    labs = rng.randint(0, vocab, (B, L))
    loss_fn = _bert_loss(mx["nn"])
    inputs, labels = _gluon_inputs(tmx, gpu, toks, labs)
    results, gluon_counts = {}, {}

    def restart():
        """The start weights again; no gradient left from the last run."""
        for k, p in params.items():
            p.set_data(start[k])
            p.data()._data.grad = None
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()

    for dname, dtype in (("float32", torch.float32),
                         ("bfloat16", torch.bfloat16)):
        f32 = dname == "float32"
        sfx = "_f32" if f32 else ""
        lane = f"gluon_bert_seq512{sfx}"
        restart()
        net.hybridize()
        if not f32:
            net.cast("bfloat16")
        if {p.data()._data.dtype for p in params.values()} != {dtype}:
            raise AssertionError(f"{lane}: weights are not all {dname}")
        trainer = tmx.gluon.Trainer(params, "adam", {
            "learning_rate": 1e-4, "multi_precision": not f32})
        _reset_counts(fa)
        losses, step_ms = _gluon_steps(tmx, net, inputs, labels, steps,
                                       trainer)
        counts = _counts(fa)
        gluon_counts[dname] = counts

        prof = _profile_step(torch, lambda: _gluon_steps(
            tmx, net, inputs, labels, 1, trainer), lane)
        results[lane] = _lane_numbers(torch, dname, step_ms, B, L, flops_tok,
                                      prof)
        _log(f"lane {lane}: losses {[round(x, 5) for x in losses]}; step ms "
             f"{[round(x, 1) for x in step_ms]}; launches over {steps} steps "
             f"{counts}")
        if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
            raise AssertionError(f"{lane}: losses not finite and falling: "
                                 f"{losses}")
        want = {"flash_fwd": layers * steps, "flash_bwd_fused": layers * steps,
                "flash_bwd_dq": 0, "flash_bwd_dkv": 0,
                "flash_fwd_f32": layers * steps if f32 else 0,
                "flash_bwd_fused_f32": layers * steps if f32 else 0}
        wide = sum(n for k, n in counts.items() if k.endswith("_wide_bf16"))
        if any(counts[k] != n for k, n in want.items()) or wide:
            raise AssertionError(f"{lane}: launches {counts}, want {want} "
                                 f"and no wide bf16 launch")

        # the same weights and batch through parallel.TrainStep
        restart()
        opt = mx["optimizer"].Adam(learning_rate=1e-4, multi_precision=not f32)
        step = mx["parallel"].TrainStep(net, loss_fn, opt)
        tt, tl = torch.tensor(toks, device="cuda"), \
            torch.tensor(labs, device="cuda")
        ts_losses, ts_ms = [], []
        for _ in range(steps):
            t = time.perf_counter()
            ts_losses.append(step(tt, tl))
            torch.cuda.synchronize()
            ts_ms.append((time.perf_counter() - t) * 1e3)
        ts_losses = [float(x) for x in ts_losses]
        prof = _profile_step(torch, lambda: step(tt, tl), f"trainstep{sfx}")
        results[f"trainstep_bert_seq512{sfx}"] = _lane_numbers(
            torch, dname, ts_ms, B, L, flops_tok, prof)
        rel = _rel(losses, ts_losses)
        _log(f"lane {lane}: TrainStep on the same weights and batch, losses "
             f"{[round(x, 5) for x in ts_losses]} rel {rel:.2e}")
        if f32 and not rel <= TRAIN_TOL:
            raise AssertionError(f"{lane}: Gluon loop and TrainStep disagree "
                                 f"(rel {rel}, tol {TRAIN_TOL})")
        step = opt = None
        if f32:
            # the imperative NDArray path: no hybridize
            restart()
            net.hybridize(active=False)
            trainer = tmx.gluon.Trainer(params, "adam",
                                        {"learning_rate": 1e-4})
            _reset_counts(fa)
            imp, _ = _gluon_steps(tmx, net, inputs, labels, 3, trainer)
            counts = _counts(fa)
            rel = _rel(imp, losses[:3])
            _log(f"lane {lane}: imperative (not hybridized) losses "
                 f"{[round(x, 5) for x in imp]} rel {rel:.2e}; launches "
                 f"{counts}")
            if not rel <= TRAIN_TOL or counts["flash_bwd_fused_f32"] != 36:
                raise AssertionError(f"{lane}: imperative path: rel {rel}, "
                                     f"launches {counts}")
        trainer = None
    for lane, r in results.items():
        _log(f"train {lane}: step {r['step_ms']:.2f} ms, "
             f"{r['samples_per_s']:.2f} samples/s, MFU {r['mfu']:.4f}, peak "
             f"{r['peak_gib']:.2f} GiB, idle share {r['idle_share']:.3f} "
             f"({smi})")
    return gluon_counts, results


VISION_BATCH, VISION_SIZE = 64, 224   # bench.py:545-547
# bench.py:158-159 takes SGD lr 0.1, momentum 0.9 at batch 64 to time the
# step; from Xavier weights that rate does not train: one 64-image batch's
# loss went 7.82 -> 5.29 -> 9.66 over 8 steps on an H100.  The phase takes
# the reference recipe's 0.1 per 256 images, scaled to the batch: 0.025
VISION_SGD = {"learning_rate": 0.1 * VISION_BATCH / 256, "momentum": 0.9}
VISION_OP_TOL = 1e-5    # card vs CPU per op, f32: max |err| / max |ref|
VISION_NET_TOL = 1e-4   # card vs CPU small ResNet: outputs, loss, statistics


def _rel_err(torch, got, ref):
    """max |got - ref| / max |ref| over two tensors (any devices)."""
    g, r = got.detach().double().cpu(), ref.detach().double().cpu()
    return float((g - r).abs().max() / r.abs().max().clamp(min=1e-30))


def _vision_op_cases(tmx, rng):
    """(name, fn(ctx) -> list of NDArrays) for each op of the vision path,
    at the small oracle ResNet's shapes."""
    nd = tmx.nd

    def arr(*shape, lo=None):
        a = rng.uniform(lo, 1.5, shape) if lo is not None \
            else rng.randn(*shape)
        return a.astype(np.float32)

    x, w7 = arr(4, 3, 64, 64), arr(16, 3, 7, 7) * 0.1
    a16, w3 = arr(4, 16, 16, 16), arr(16, 16, 3, 3) * 0.1
    a64, w1 = arr(4, 64, 16, 16), arr(128, 64, 1, 1) * 0.1
    b128 = arr(128)
    g, b = arr(64, lo=0.5), arr(64) * 0.1
    mm, mv = arr(64) * 0.1, arr(64, lo=0.5)
    top = arr(4, 512, 2, 2)

    def bn(ctx, train):
        stats = [nd.array(mm, ctx=ctx), nd.array(mv, ctx=ctx)]
        mode = tmx.autograd.train_mode if train else \
            tmx.autograd.predict_mode
        with mode():
            out = nd.BatchNorm(nd.array(a64, ctx=ctx), nd.array(g, ctx=ctx),
                               nd.array(b, ctx=ctx), *stats, eps=1e-5,
                               fix_gamma=False)
        return [out] + stats

    return [
        ("Convolution 7x7/2 stem", lambda c: [nd.Convolution(
            nd.array(x, ctx=c), nd.array(w7, ctx=c), kernel=(7, 7),
            stride=(2, 2), pad=(3, 3), num_filter=16, no_bias=True)]),
        ("Convolution 3x3", lambda c: [nd.Convolution(
            nd.array(a16, ctx=c), nd.array(w3, ctx=c), kernel=(3, 3),
            pad=(1, 1), num_filter=16, no_bias=True)]),
        ("Convolution 1x1/2 bias", lambda c: [nd.Convolution(
            nd.array(a64, ctx=c), nd.array(w1, ctx=c), nd.array(b128, ctx=c),
            kernel=(1, 1), stride=(2, 2), num_filter=128)]),
        ("Pooling max 3/2/1", lambda c: [nd.Pooling(
            nd.array(a16, ctx=c), kernel=(3, 3), stride=(2, 2), pad=(1, 1),
            pool_type="max")]),
        ("Pooling global avg", lambda c: [nd.Pooling(
            nd.array(top, ctx=c), global_pool=True, pool_type="avg")]),
        ("BatchNorm train (out, mean, var)", lambda c: bn(c, True)),
        ("BatchNorm predict (out, mean, var)", lambda c: bn(c, False)),
        ("pad reflect", lambda c: [nd.pad(
            nd.array(a16, ctx=c), mode="reflect",
            pad_width=(0, 0, 0, 0, 1, 1, 1, 1))]),
    ]


def _vision_sgd_step(tmx, net, x, y, trainer, B):
    """One step of the ResNet loop: record, softmax cross-entropy of the
    f32 logits over B (bench.py:149-151), backward, Trainer.step(1)."""
    with tmx.autograd.record():
        out = net(x)
        loss = tmx.nd.softmax_cross_entropy(
            out.astype("float32", copy=False), y) / B
    loss.backward()
    trainer.step(1)
    return loss


def vision_oracle(torch, tmx):
    """(a) Every op of the vision path, then a small bottleneck ResNet with
    the 7x7 stem and max-pool (ResNetV1(BottleneckV1, [1,1,1,1],
    [16,64,128,256,512], classes=10), batch 4, 64x64) on the card and on
    the CPU from the same weights carried by name: predict-mode outputs,
    one hybridized Trainer SGD step's loss, the running statistics after
    it, and the outputs after it."""
    from mxnet_tpu_torch import convert
    v = tmx.gluon.model_zoo.vision
    rng = np.random.RandomState(31)
    gpu, cpu = tmx.gpu(), tmx.cpu()
    for name, fn in _vision_op_cases(tmx, rng):
        card, host = fn(gpu), fn(cpu)
        err = max(_rel_err(torch, c._data, h._data)
                  for c, h in zip(card, host))
        _log(f"oracle vision op {name}: card vs CPU {err:.2e} (tol "
             f"{VISION_OP_TOL})")
        if not err <= VISION_OP_TOL:
            raise AssertionError(f"vision op {name}: {err}")

    def build():
        return v.ResNetV1(v.BottleneckV1, [1, 1, 1, 1],
                          [16, 64, 128, 256, 512], classes=10,
                          prefix="oracle_")

    B = 4
    x = rng.randn(B, 3, 64, 64).astype(np.float32)
    y = rng.randint(0, 10, B).astype(np.float32)
    host = build()
    tmx.random.seed(32)
    host.initialize(tmx.init.Xavier(), ctx=cpu)
    with tmx.autograd.pause():
        host(tmx.nd.array(x, ctx=cpu))
    for k, p in host.collect_params().items():
        if k.endswith("running_mean"):
            p.set_data(rng.uniform(-0.1, 0.1, p.shape).astype(np.float32))
        elif k.endswith("running_var"):
            p.set_data(rng.uniform(0.5, 1.5, p.shape).astype(np.float32))
    card = convert.load_by_name(
        build(), {k: p.data().asnumpy()
                  for k, p in host.collect_params().items()}, device="cuda")
    res = {}
    for ctx, net in ((gpu, card), (cpu, host)):
        xs, ys = tmx.nd.array(x, ctx=ctx), tmx.nd.array(y, ctx=ctx)
        with tmx.autograd.predict_mode():
            before = net(xs)
        net.hybridize()
        trainer = tmx.gluon.Trainer(net.collect_params(), "sgd", {
            "learning_rate": 0.1, "momentum": 0.9})
        loss = _vision_sgd_step(tmx, net, xs, ys, trainer, B)
        with tmx.autograd.predict_mode():
            after = net(xs)
        stats = [p.data()._data for k, p in net.collect_params().items()
                 if "running" in k]
        res[ctx] = (before._data, loss._data.detach(), after._data, stats)
    errs = {"predict": _rel_err(torch, res[gpu][0], res[cpu][0]),
            "loss": _rel_err(torch, res[gpu][1], res[cpu][1]),
            "after step": _rel_err(torch, res[gpu][2], res[cpu][2]),
            "statistics": max(_rel_err(torch, a, b) for a, b in
                              zip(res[gpu][3], res[cpu][3]))}
    _log(f"oracle vision small ResNetV1 bottleneck (batch {B}, 64x64): card "
         f"vs CPU " + ", ".join(f"{k} {e:.2e}" for k, e in errs.items())
         + f" (tol {VISION_NET_TOL}); loss {res[cpu][1].item():.5f}")
    if not max(errs.values()) <= VISION_NET_TOL:
        raise AssertionError(f"vision oracle: {errs}")


def _net_flops(torch, tmx, net, x):
    """Forward FLOPs of ``net`` on ``x`` from its own layers, counted by
    forward hooks: 2 C_out (C_in / groups) k_h k_w H_out W_out per
    convolution, 2 in out per Dense row.  This forward also resolves the
    deferred shapes (predict mode: the statistics stay)."""
    nn = tmx.gluon.nn
    total = [0]

    def conv(block, inputs, out):
        c_out, c_in_g, kh, kw = block.weight.shape
        total[0] += 2 * c_out * c_in_g * kh * kw * out.shape[0] \
            * out.shape[2] * out.shape[3]

    def dense(block, inputs, out):
        total[0] += 2 * math.prod(block.weight.shape) * out.shape[0]

    hooks = [m.register_forward_hook(conv if isinstance(m, nn.Conv2D)
                                     else dense)
             for m in net.modules() if isinstance(m, (nn.Conv2D, nn.Dense))]
    with tmx.autograd.pause(), torch.no_grad():
        net(x)
    for h in hooks:
        h.remove()
    return total[0]


def vision_phase(torch, fa, mx, args, smi):
    """The reference's ResNet-50 lane (bench.py:126-193, :545-547) on the
    card: (a) the oracle above; (b) f32: get_model("resnet50_v1",
    classes=1000), initialize(Xavier(), ctx=gpu), hybridize(),
    Trainer("sgd", VISION_SGD), softmax cross-entropy / B, 8 steps on one
    batch of 64 images at 224x224 from --seed, then parallel.TrainStep
    from the same weights, statistics and batch, both timed; both again
    under cudnn.deterministic, losses agreeing to TRAIN_TOL, and 2
    imperative steps (not hybridized) agreeing with the first 2; (d)
    save_parameters in npz and in dmlc, load_parameters into a fresh
    resnet50_v1 on the card: predict-mode outputs and every parameter
    bit-identical; (c) bf16 by net.cast with multi-precision SGD, every
    BatchNorm parameter still f32, the same runs, and a round trip of the
    bf16 net through npz, bit-identical.  Losses finite and falling,
    running statistics moved, no flash kernel launched; f32 runs no TF32
    kernel.  Prints step ms, images/s, FLOPs per step, MFU, peak memory,
    idle share and device time by kernel family per lane."""
    tmx = mx["pkg"]
    vision_oracle(torch, tmx)
    v = tmx.gluon.model_zoo.vision
    gc.collect()
    torch.cuda.empty_cache()
    _reset_counts(fa)
    gpu, B, size, classes, steps = tmx.gpu(), VISION_BATCH, VISION_SIZE, \
        1000, 8
    net = tmx.gluon.model_zoo.get_model("resnet50_v1", classes=classes)
    tmx.random.seed(args.seed)
    net.initialize(tmx.init.Xavier(), ctx=gpu)
    rng = np.random.RandomState(args.seed)
    x = rng.randn(B, 3, size, size).astype(np.float32)
    y = rng.randint(0, classes, B).astype(np.float32)
    flops_img = _net_flops(torch, tmx, net, tmx.nd.array(x[:1], ctx=gpu))
    flops_step = 3 * B * flops_img
    params = net.collect_params()
    start = {k: p.data()._data.detach().clone() for k, p in params.items()}
    stats = [k for k in params.keys() if "running" in k]
    ops_nn = mx["nn"]
    results, counts = {}, {}
    _log(f"vision resnet50_v1: {len(params)} parameters "
         f"({sum(p.data()._data.numel() for p in params.values())} values), "
         f"{flops_img / 1e9:.4f} GFLOP forward per image, "
         f"{flops_step / 1e12:.4f} TFLOP per training step (3x forward, "
         f"batch {B})")

    def restart():
        for k, p in params.items():
            p.set_data(start[k])
            p.data()._data.grad = None
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()

    def moved():
        return all(not torch.equal(params[k].data()._data, start[k])
                   for k in stats)

    def numbers(dname, step_ms, prof):
        med = statistics.median(step_ms[2:])
        ips = B / (med / 1e3)
        return {"step_ms": med, "images_per_s": ips,
                "flops_per_step": flops_step,
                "mfu": flops_step / (med / 1e3) / PEAK_FLOPS[dname],
                "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
                "idle_share": max(0.0, 1 - prof["device_ms"]
                                  / prof["wall_ms"]),
                "families": prof["families"]}

    def gluon_run(dname, xs, ys, n):
        trainer = tmx.gluon.Trainer(params, "sgd", dict(
            VISION_SGD, multi_precision=dname == "bfloat16"))
        losses, ms = [], []
        for _ in range(n):
            t = time.perf_counter()
            losses.append(_vision_sgd_step(tmx, net, xs, ys, trainer, B))
            tmx.nd.waitall()
            ms.append((time.perf_counter() - t) * 1e3)
        return [float(l.asscalar()) for l in losses], ms, trainer

    def check_falls(lane, losses):
        if not all(np.isfinite(losses)) or not losses[-1] < losses[0] \
                or not moved():
            raise AssertionError(f"{lane}: losses {losses} not finite and "
                                 f"falling, or statistics unmoved")

    def check_no_tf32(lane, prof):
        tf32 = [k for k in prof["kernels"] if "tf32" in k.lower()]
        if tf32:
            raise AssertionError(f"{lane}: TF32 kernels in an f32 step: "
                                 f"{tf32[:3]}")

    def trainstep_run(dname, tx, ty, n):
        opt = mx["optimizer"].SGD(multi_precision=dname == "bfloat16",
                                  **VISION_SGD)
        step = mx["parallel"].TrainStep(
            net, lambda out, lab: ops_nn.softmax_cross_entropy(
                out.float(), lab) / B, opt)
        losses, ms = [], []
        for _ in range(n):
            t = time.perf_counter()
            losses.append(step(tx, ty))
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t) * 1e3)
        return [float(x) for x in losses], ms, step

    def lane_run(lane, dname, xs, ys):
        """The timed Gluon loop and TrainStep with cuDNN's default
        algorithms, as a user runs them; then both again, and 2 imperative
        steps (f32), under cudnn.deterministic: cuDNN's default backward
        algorithms sum in a run-dependent order, which 8 SGD steps of
        ResNet-50 amplify from 4e-6 to 1e-2 of the loss."""
        f32 = dname == "float32"
        tx, ty = xs._data, ys._data
        restart()
        losses, ms, trainer = gluon_run(dname, xs, ys, steps)
        check_falls(lane, losses)
        prof = _profile_step(torch, lambda: _vision_sgd_step(
            tmx, net, xs, ys, trainer, B), lane, VISION_FAMILIES)
        results[lane] = numbers(dname, ms, prof)
        _log(f"lane {lane}: Gluon loop losses "
             f"{[round(l, 5) for l in losses]}; step ms "
             f"{[round(t, 1) for t in ms]}")
        trainer = None
        restart()
        ts_losses, ts_ms, step = trainstep_run(dname, tx, ty, steps)
        check_falls(lane + " TrainStep", ts_losses)
        ts_prof = _profile_step(torch, lambda: step(tx, ty),
                                f"{lane}_trainstep", VISION_FAMILIES)
        results[f"{lane}_trainstep"] = numbers(dname, ts_ms, ts_prof)
        _log(f"lane {lane}: TrainStep losses "
             f"{[round(l, 5) for l in ts_losses]}; step ms "
             f"{[round(t, 1) for t in ts_ms]}")
        step = None
        if f32:
            check_no_tf32(lane, prof)
            check_no_tf32(lane + " TrainStep", ts_prof)
        prev = torch.backends.cudnn.deterministic
        torch.backends.cudnn.deterministic = True
        try:
            restart()
            want, _, _ = gluon_run(dname, xs, ys, steps)
            restart()
            got, _, _ = trainstep_run(dname, tx, ty, steps)
            rel = _rel(got, want)
            _log(f"lane {lane}: deterministic cuDNN, Gluon loop "
                 f"{[round(l, 5) for l in want]}, TrainStep on the same "
                 f"weights, statistics and batch rel {rel:.2e} (tol "
                 f"{TRAIN_TOL})")
            if not rel <= TRAIN_TOL:
                raise AssertionError(f"{lane}: TrainStep and the Gluon loop "
                                     f"disagree (rel {rel})")
            if f32:
                restart()
                net.hybridize(active=False)
                imp, _, _ = gluon_run(dname, xs, ys, 2)
                net.hybridize()
                rel = _rel(imp, want[:2])
                _log(f"lane {lane}: imperative (not hybridized) losses "
                     f"{[round(l, 5) for l in imp]} rel {rel:.2e} (tol "
                     f"{TRAIN_TOL})")
                if not rel <= TRAIN_TOL:
                    raise AssertionError(f"{lane}: imperative path rel "
                                         f"{rel}")
        finally:
            torch.backends.cudnn.deterministic = prev

    def roundtrip(fmt, hybridized, dtype=None):
        prev = os.environ.get("MXNET_PARAMS_FORMAT")
        os.environ["MXNET_PARAMS_FORMAT"] = fmt
        try:
            with tempfile.TemporaryDirectory() as d:
                path = os.path.join(d, f"resnet50_v1.{fmt}.params")
                net.save_parameters(path)
                fresh = v.resnet50_v1(classes=classes)
                fresh.hybridize(hybridized)
                if dtype:
                    fresh.cast(dtype)
                fresh.load_parameters(path, ctx=gpu)
        finally:
            if prev is None:
                os.environ.pop("MXNET_PARAMS_FORMAT")
            else:
                os.environ["MXNET_PARAMS_FORMAT"] = prev
        probe = xs if dtype is None else xs.astype(dtype)
        with tmx.autograd.predict_mode():
            a, b = net(probe)._data, fresh(probe)._data
        same = torch.equal(a, b) and all(
            p.data()._data.dtype == q.data()._data.dtype
            and torch.equal(p.data()._data, q.data()._data)
            for p, q in zip(params.values(),
                            fresh.collect_params().values()))
        _log(f"checkpoint resnet50_v1 {dtype or 'float32'} via {fmt}: "
             f"{len(params)} parameters, predict-mode outputs and every "
             f"parameter bit-identical: {same}")
        if not same:
            raise AssertionError(f"checkpoint via {fmt} not bit-identical")

    xs, ys = tmx.nd.array(x, ctx=gpu), tmx.nd.array(y, ctx=gpu)
    net.hybridize()
    # (b) f32, then (d) its checkpoint in both formats
    lane_run("vision_resnet50_f32", "float32", xs, ys)
    roundtrip("npz", True)
    roundtrip("dmlc", True)

    # (c) bf16: cast (BatchNorm stays f32), multi-precision SGD
    restart()
    net.cast("bfloat16")
    wrong = [k for k, p in params.items()
             if p.data()._data.dtype != (torch.float32 if "batchnorm" in k
                                         else torch.bfloat16)]
    if wrong:
        raise AssertionError(f"bf16 cast: dtypes of {wrong[:4]}")
    lane_run("vision_resnet50_bf16", "bfloat16", xs.astype("bfloat16"), ys)
    roundtrip("npz", True, "bfloat16")

    counts = _counts(fa)
    if any(counts.values()):
        raise AssertionError(f"vision path launched flash kernels: {counts}")
    for lane, r in results.items():
        _log(f"train {lane}: step {r['step_ms']:.2f} ms, "
             f"{r['images_per_s']:.2f} images/s, "
             f"{r['flops_per_step'] / 1e12:.4f} TFLOP/step, MFU "
             f"{r['mfu']:.4f}, peak {r['peak_gib']:.2f} GiB, idle share "
             f"{r['idle_share']:.3f}; device ms "
             + ", ".join(f"{k} {t:.1f}" for k, t in r["families"].items())
             + f" ({smi})")
    return counts, results


# -- the loop phase: the Gluon training loop around the model ----------------

# every optimizer of mx.optimizer, each with a schedule, for the small-ResNet
# oracle (card vs CPU, 3 steps)
LOOP_OPTIMIZERS = {
    "sgd": {"learning_rate": 0.05, "momentum": 0.9, "wd": 1e-4},
    "nag": {"learning_rate": 0.05, "momentum": 0.9, "wd": 1e-4},
    "adam": {"learning_rate": 1e-3, "wd": 1e-4},
    "adamw": {"learning_rate": 1e-3, "wd": 1e-2},
    "lars": {"learning_rate": 0.5, "momentum": 0.9, "wd": 1e-4},
    "rmsprop": {"learning_rate": 1e-3, "centered": True},
    "ftrl": {"learning_rate": 0.1, "lamda1": 1e-4},
    "signum": {"learning_rate": 1e-3, "momentum": 0.9},
    "lamb": {"learning_rate": 1e-3, "wd": 0.01},
    "adagrad": {"learning_rate": 0.01},
    "adadelta": {"rho": 0.9},
}
# card vs CPU after 3 steps on the same gradients, max |err| / max |ref|
# per parameter and over the losses.  f32: cuDNN and the CPU sum in other
# orders (6.2e-7 per op, 2.4e-6 for the small ResNet's step, in the
# vision oracle); 1e-5 for the losses and every parameter.  bf16: the
# update is f32 math on each trained parameter's f32 value (the master of
# a bf16 weight, BatchNorm's f32 gamma and beta themselves) fed the same
# gradients, so those values are held to f32's 1e-5 (LOOP_MASTER_TOL), and
# each bf16 weight must be its master rounded, bit for bit, on both
# devices (card and CPU weights then differ by at most one bf16 ulp, where
# the masters straddle a rounding boundary).  The losses and BatchNorm's
# running statistics come from each device's own bf16 forward, which
# rounds its products in other places: 1e-2, about two ulps (2^-8 of the
# value) of the largest
LOOP_ORACLE_TOL = {"float32": 1e-5, "bfloat16": 1e-2}
LOOP_MASTER_TOL = 1e-5
IMAGENET_MEAN, IMAGENET_STD = (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)
LOOP_IMAGES, LOOP_BERT_SAMPLES, LOOP_STEPS = 640, 320, 10
# the loop phase's data has something to learn within one epoch of distinct
# batches (random labels over 1000 classes do not: the loss cannot fall
# below ln 1000 and wanders): images of ten of the 1000 classes whose
# brightness grows with the class, and BERT asked for its own input tokens
LOOP_CLASSES, LOOP_SHADE = 10, 12
# LAMB moves each layer by lr times its norm per step: at 1e-4 the BERT
# loss does not move in 10 steps; at 1e-2 it falls.  NAG at the vision
# phase's 0.025 (the reference recipe's 0.1 per 256 images, which assumes
# epochs of warmup) overshoots after a 3-step warmup on distinct batches:
# the bf16 ResNet-50 loss rose far above its start on the card.  The loop
# takes 0.005; the rate witness runs 0.025 in both dtypes, through the
# Trainer and through TrainStep, each Trainer step held against a plain
# NAG, so the loss curves at 0.025 are printed in every run
LOOP_LAMB_LR = 1e-2
LOOP_NAG = {"learning_rate": 0.005, "momentum": 0.9, "wd": 1e-4}
LOOP_NAG_WITNESS_LR = 0.025
LOOP_BERT = {"layers": 12, "units": 768, "hidden": 3072, "heads": 12,
             "batch": 32, "seq": 512, "vocab": 30522}    # bert_12_768_12


def _small_resnet(tmx):
    v = tmx.gluon.model_zoo.vision
    return v.ResNetV1(v.BottleneckV1, [1, 1, 1, 1], [16, 64, 128, 256, 512],
                      classes=10, prefix="oracle_")


def _image_loader(tmx, x, y, num_workers, flip=True, B=VISION_BATCH):
    """(b)'s loader: an ArrayDataset of host uint8 HWC images and labels,
    RandomFlipLeftRight (unless ``flip`` is False), ToTensor, Normalize;
    shuffled, last batch discarded."""
    t = tmx.gluon.data.vision.transforms
    ds = tmx.gluon.data.ArrayDataset(tmx.nd.array(x, ctx=tmx.cpu()),
                                     tmx.nd.array(y, ctx=tmx.cpu()))
    steps = [t.RandomFlipLeftRight()] if flip else []
    ds = ds.transform_first(t.Compose(steps + [
        t.ToTensor(), t.Normalize(mean=IMAGENET_MEAN, std=IMAGENET_STD)]))
    return tmx.gluon.data.DataLoader(ds, batch_size=B, shuffle=True,
                                     last_batch="discard",
                                     num_workers=num_workers, timeout=300)


def loop_oracle(torch, tmx, x, y):
    """(a) On the card against the CPU or against itself: every optimizer
    with a schedule, 3 steps of the small bottleneck ResNet, f32 and bf16
    (multi_precision); the store owning the update against the trainer
    owning it; save_states / load_states mid-run; the worker loader
    against one process."""
    from mxnet_tpu_torch import convert
    from mxnet_tpu_torch.gluon.data import dataloader
    gpu, cpu, B = tmx.gpu(), tmx.cpu(), 4
    rng = np.random.RandomState(41)
    xs = rng.randn(B, 3, 64, 64).astype(np.float32)
    ys = rng.randint(0, 10, B).astype(np.float32)
    host = _small_resnet(tmx)
    tmx.random.seed(42)
    host.initialize(tmx.init.Xavier(), ctx=cpu)
    with tmx.autograd.pause():
        host(tmx.nd.array(xs, ctx=cpu))
    start = {k: p.data().asnumpy() for k, p in host.collect_params().items()}
    card = convert.load_by_name(_small_resnet(tmx), start, device="cuda")
    nets = {gpu: card, cpu: host}
    for net in nets.values():
        net.hybridize()

    def trainer(ctx, name, kw, dname, **tkw):
        """A Trainer on ``ctx``'s net, reset to the start weights."""
        for k, p in nets[ctx].collect_params().items():
            p.set_data(start[k])
        kw = dict(kw, lr_scheduler=tmx.lr_scheduler.FactorScheduler(
            step=1, factor=0.7), multi_precision=dname == "bfloat16")
        return tmx.gluon.Trainer(nets[ctx].collect_params(), name, kw,
                                 **tkw), kw

    def forward_backward(ctx, dname):
        a = tmx.nd.array(xs, ctx=ctx).astype(dname)
        with tmx.autograd.record():
            loss = tmx.nd.softmax_cross_entropy(nets[ctx](a).astype(
                "float32", copy=False), tmx.nd.array(ys, ctx=ctx)) / B
        loss.backward()
        return float(loss.asscalar())

    def weights(ctx):
        return {k: p.data()._data.detach().clone()
                for k, p in nets[ctx].collect_params().items()}

    def f32_values(ctx, tr):
        """Each trained parameter's f32 value: its master where the weight
        is bf16 (multi_precision), else the weight itself."""
        out = {}
        for i, (k, p) in enumerate(nets[ctx].collect_params().items()):
            if p.grad_req != "null":
                w = p.data()._data
                out[k] = (tr._states[i][0] if w.dtype == torch.bfloat16
                          else w).detach().clone()
        return out

    def pair(name, kw, dname):
        """3 steps on both devices; each step the card's update takes the
        CPU's gradients.  The devices' own gradients differ by rounding,
        and where a gradient is near 0 (the bias of a convolution ahead of
        a BatchNorm, a channel ReLU shuts) Adam-like updates scale that
        difference up to steps of lr; with one gradient the updates must
        agree."""
        tr = {c: trainer(c, name, kw, dname)[0] for c in (cpu, gpu)}
        host_p = nets[cpu].collect_params()
        card_p = nets[gpu].collect_params()
        losses = {cpu: [], gpu: []}
        for _ in range(3):
            for c in (cpu, gpu):
                losses[c].append(forward_backward(c, dname))
            with torch.no_grad():
                for k, p in host_p.items():
                    if p.grad_req != "null":
                        card_p[k].grad()._data.copy_(p.grad()._data)
            for c in (cpu, gpu):
                tr[c].step(1)
        return (losses, weights(gpu), weights(cpu), f32_values(gpu, tr[gpu]),
                f32_values(cpu, tr[cpu]))

    def worst(a, b, keys):
        """(max |a - b| / max |b| over ``keys``, the key where it is)."""
        return max((_rel_err(torch, a[k], b[k]), k) for k in keys)

    def card_run(name, kw, dname, steps, save_at=None, **tkw):
        tr, kw = trainer(gpu, name, kw, dname, **tkw)
        for i in range(steps):
            forward_backward(gpu, dname)
            tr.step(1)
            if i + 1 == save_at:
                with tempfile.TemporaryDirectory() as d:
                    f = os.path.join(d, "oracle.states")
                    tr.save_states(f)
                    tr = tmx.gluon.Trainer(nets[gpu].collect_params(), name,
                                           kw, **tkw)
                    tr.load_states(f)
        return weights(gpu)

    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for dname in ("float32", "bfloat16"):
            if dname == "bfloat16":
                for net in nets.values():
                    net.cast("bfloat16")
            tol = LOOP_ORACLE_TOL[dname]
            for name, kw in LOOP_OPTIMIZERS.items():
                losses, pc, ph, mc, mh = pair(name, kw, dname)
                lc, lh = losses[gpu], losses[cpu]
                el = _rel_err(torch, torch.tensor(lc), torch.tensor(lh))
                if dname == "float32":
                    ep, wk = worst(pc, ph, pc)
                    ok = ep <= tol
                    what = f"parameters {ep:.2e} ({wk}) (tol {tol})"
                else:
                    em, mk = worst(mc, mh, mc)
                    ew, wk = worst(pc, ph, mc)
                    es, sk = worst(pc, ph, [k for k in pc if k not in mc])
                    rounded = all(torch.equal(w[k], m[k].to(w[k].dtype))
                                  for w, m in ((pc, mc), (ph, mh))
                                  for k in m if w[k].dtype != m[k].dtype)
                    ok = em <= LOOP_MASTER_TOL and es <= tol and rounded
                    what = (f"f32 masters and weights {em:.2e} ({mk}) (tol "
                            f"{LOOP_MASTER_TOL}), trained weights {ew:.2e} "
                            f"({wk}), each bf16 weight its master rounded: "
                            f"{rounded}, running statistics {es:.2e} ({sk}) "
                            f"(tol {tol})")
                _log(f"oracle loop {name} {dname}: 3 steps card "
                     f"{[round(v, 6) for v in lc]} cpu "
                     f"{[round(v, 6) for v in lh]}, losses {el:.2e} (tol "
                     f"{tol}), {what}, of max |ref|")
                if not (el <= tol and ok):
                    raise AssertionError(f"loop oracle {name} {dname}: "
                                         f"losses {el}, {what}")
            # no store (one replica), the store owning the update, and an
            # explicit store reducing the one replica: the same bits
            nag = LOOP_OPTIMIZERS["nag"]
            plain = card_run("nag", nag, dname, 3, kvstore="local")
            on_kv = card_run("nag", nag, dname, 3, kvstore="local",
                             update_on_kvstore=True)
            store = card_run("nag", nag, dname, 3,
                             kvstore=tmx.kv.create("local"))
            same = all(torch.equal(plain[k], on_kv[k])
                       and torch.equal(plain[k], store[k]) for k in plain)
            # a states file written after step 2 and read by a new
            # Trainer: steps 3-4 as without it
            lamb = LOOP_OPTIMIZERS["lamb"]
            want = card_run("lamb", lamb, dname, 4)
            got = card_run("lamb", lamb, dname, 4, save_at=2)
            reload_same = all(torch.equal(want[k], got[k]) for k in want)
            _log(f"oracle loop {dname}: no store / update_on_kvstore / an "
                 f"explicit store, parameters bit-identical: {same}; "
                 f"save_states/load_states after step 2 of 4 (lamb), "
                 f"bit-identical: {reload_same}")
            if not (same and reload_same):
                raise AssertionError(f"loop oracle {dname}: kvstore {same}, "
                                     f"states {reload_same}")
    finally:
        torch.backends.cudnn.deterministic = prev

    # the worker loader against one process, transforms without the flip
    before = dataloader.fallbacks
    with_workers = _image_loader(tmx, x, y, 4, flip=False)
    try:
        np.random.seed(43)
        got = [(a._data, b._data) for a, b in with_workers]
    finally:
        with_workers._shutdown_pool()
    np.random.seed(43)
    want = [(a._data, b._data) for a, b in _image_loader(tmx, x, y, 0,
                                                         flip=False)]
    same = len(got) == len(want) == len(x) // VISION_BATCH and all(
        torch.equal(a, c) and torch.equal(b, d)
        for (a, b), (c, d) in zip(got, want))
    _log(f"oracle loop DataLoader: {len(got)} batches of {VISION_BATCH} with "
         f"4 workers bit-identical to one process: {same}; fallbacks "
         f"{dataloader.fallbacks - before}; batches on {got[0][0].device}")
    if not same or dataloader.fallbacks != before \
            or got[0][0].device != gpu.torch_device():
        raise AssertionError("loop oracle: the worker loader differs")


def _kvstore_times(torch, tmx, params):
    """pushpull_list of every trained gradient through a local store, on
    the card: one replica (the store's copies) and 2 and 4 replicas on the
    same card (copies of the gradients; the reduction's tree_sum adds).
    {replicas: median ms of 8}."""
    grads = [p.grad() for p in params.values() if p.grad_req != "null"]
    keys = list(range(len(grads)))
    nbytes = sum(g._data.numel() * g._data.element_size() for g in grads)
    times = {}
    for n in (1, 2, 4):
        kv = tmx.kv.create("local")
        kv.init(keys, [g.copy() for g in grads])
        vals = [[g.copy() for _ in range(n)] if n > 1 else g.copy()
                for g in grads]
        times[n] = statistics.median(_timed_ms(
            tmx, lambda: kv.pushpull_list(keys, vals, vals), 10)[2:])
        _log(f"kvstore local pushpull_list: {len(keys)} ResNet-50 gradients "
             f"({nbytes / 1e6:.1f} MB), {n} replica(s) on the card, "
             f"{times[n]:.3f} ms (median of 8)")
        kv = vals = None
    return times


def _nag_witness(torch, tmx, mx, net, params, restart, batches, schedule, B):
    """The loop's ResNet-50 from its start weights on ``batches`` (the
    first epoch's, fetched once) with NAG at LOOP_NAG_WITNESS_LR and
    ``schedule(lr)``: the Trainer in f32 and in bf16 (multi_precision),
    then TrainStep in bf16.  After every Trainer step each trained
    parameter's f32 value (a bf16 weight's master) is held against a plain
    NAG (the reference's nag_mom_update, tensor by tensor) of an f32 copy
    fed the same gradients, to LOOP_MASTER_TOL of its max |value|, and
    each bf16 weight must be its master rounded.  Returns {run: losses};
    the losses are not checked."""
    lr, ops_nn = LOOP_NAG_WITNESS_LR, mx["nn"]
    nag = dict(LOOP_NAG, learning_rate=lr)
    plist = list(params.values())
    trained = [i for i, p in enumerate(plist) if p.grad_req != "null"]
    curves = {}
    for dname in ("float32", "bfloat16"):
        mp = dname == "bfloat16"
        net.cast(dname)
        restart()
        trainer = tmx.gluon.Trainer(params, "nag", dict(
            nag, lr_scheduler=schedule(lr), multi_precision=mp),
            kvstore="local")
        plain = [plist[i].data()._data.detach().float().clone()
                 for i in trained]
        moms = [torch.zeros_like(w) for w in plain]
        rates = schedule(lr)
        losses, err, rounded = [], 0.0, True
        for k, (xb, yb) in enumerate(batches, 1):
            _, loss = _loop_step(tmx, net, xb, yb, trainer, dname, B)
            losses.append(float(loss.mean().asscalar()))
            with torch.no_grad():
                for j, i in enumerate(trained):
                    p = plist[i]
                    g = p.grad()._data.float() / B + nag["wd"] * p.wd_mult \
                        * plain[j]
                    moms[j].mul_(nag["momentum"]).add_(g)
                    plain[j].sub_(rates(k) * p.lr_mult
                                  * (g + nag["momentum"] * moms[j]))
                    w = p.data()._data
                    value = trainer._states[i][0] if w.dtype != torch.float32 \
                        else w
                    rounded &= torch.equal(w, value.to(w.dtype))
                    err = max(err, float((value - plain[j]).abs().max()
                                         / plain[j].abs().max()))
        lane = f"nag_witness_{'bf16' if mp else 'f32'}_trainer"
        curves[lane] = losses
        _log(f"{lane}: NAG lr {lr}, losses {[round(v, 5) for v in losses]}; "
             f"f32 values against a plain NAG on the same gradients "
             f"{err:.2e} of max |value| (tol {LOOP_MASTER_TOL}), each bf16 "
             f"weight its master rounded: {rounded}")
        if not (err <= LOOP_MASTER_TOL and rounded):
            raise AssertionError(f"{lane}: the NAG update is not the plain "
                                 f"one: {err}, rounded {rounded}")
        trainer = plain = moms = None
    # TrainStep, bf16: the same data, schedule and multi_precision
    restart()
    net.cast("bfloat16")
    opt = mx["optimizer"].NAG(multi_precision=True, lr_scheduler=schedule(lr),
                              **nag)
    step = mx["parallel"].TrainStep(
        net, lambda out, lab: ops_nn.softmax_cross_entropy(
            out.float(), lab) / B, opt)
    losses = [float(step(xb._data.to(torch.bfloat16), yb._data))
              for xb, yb in batches]
    curves["nag_witness_bf16_trainstep"] = losses
    _log(f"nag_witness_bf16_trainstep: NAG lr {lr}, losses "
         f"{[round(v, 5) for v in losses]}")
    return curves


def _loop_step(tmx, net, x, y, trainer, dtype, B):
    """record, forward, SoftmaxCrossEntropyLoss on f32 logits, backward,
    Trainer.step(B), the device drained: (logits, per-sample losses)."""
    if dtype != "float32":
        x = x.astype(dtype)
    with tmx.autograd.record():
        out = net(x)
        loss = tmx.gluon.loss.SoftmaxCrossEntropyLoss()(
            out.astype("float32", copy=False), y)
    loss.backward()
    trainer.step(B)
    tmx.nd.waitall()
    return out, loss


def _loop_epoch(tmx, it, step, update, steps, trainer, B):
    """``steps`` iterations of the canonical loop: next(it), ``step(x, y)``
    (forward, loss, backward, Trainer.step; the device drained), then
    ``update(y, *step's outputs)`` (the metrics; returns the batch's loss
    sum).  Per step: loss mean, wall ms, ms waiting in next(), ms of the
    metrics' update (the host copies and numpy work) and the learning
    rate the optimizer used."""
    rec = {k: [] for k in ("losses", "step_ms", "wait_ms", "metric_ms",
                           "lr")}
    for _ in range(steps):
        t0 = time.perf_counter()
        x, y = next(it)
        t1 = time.perf_counter()
        outs = step(x, y)
        t2 = time.perf_counter()
        total = update(y, *outs)
        t3 = time.perf_counter()
        rec["losses"].append(total / B)
        rec["wait_ms"].append((t1 - t0) * 1e3)
        rec["metric_ms"].append((t3 - t2) * 1e3)
        rec["step_ms"].append((t3 - t0) * 1e3)
        rec["lr"].append(trainer.learning_rate)
    return rec


def _loop_numbers(torch, rec, B, prof):
    """The run's numbers.  The idle share sets the device time per step
    (profiled) against the median step's wall time (not profiled): the
    profiler's own host cost per op would stretch a host-bound step."""
    window = slice(2, None)             # steps 3-10, as the other phases
    med = statistics.median(rec["step_ms"][window])
    return {"step_ms": med, "per_s": B / (med / 1e3),
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
            "idle_share": max(0.0, 1 - prof["device_ms"] / med),
            "wait_ms": statistics.mean(rec["wait_ms"][window]),
            "first_wait_ms": rec["wait_ms"][0],
            "metric_ms": statistics.mean(rec["metric_ms"][window])}


def _check_run(lane, rec, want_lr):
    _log(f"lane {lane}: losses {[round(v, 5) for v in rec['losses']]}; "
         f"step ms {[round(v, 1) for v in rec['step_ms']]}; next() ms "
         f"{[round(v, 1) for v in rec['wait_ms']]}; metric ms "
         f"{[round(v, 2) for v in rec['metric_ms']]}; lr {rec['lr']}")
    losses = rec["losses"]
    if not all(np.isfinite(losses)) \
            or not np.mean(losses[-3:]) < losses[0]:
        raise AssertionError(f"{lane}: losses {losses} not finite, or the "
                             f"last three steps' mean not below the first "
                             f"step's loss")
    if not np.allclose(rec["lr"], want_lr, rtol=1e-12, atol=0):
        raise AssertionError(f"{lane}: rates {rec['lr']}, the schedule "
                             f"{want_lr}")


def _timed_ms(tmx, step, steps):
    ms = []
    for _ in range(steps):
        t = time.perf_counter()
        step()
        tmx.nd.waitall()
        ms.append((time.perf_counter() - t) * 1e3)
    return ms


def loop_phase(torch, fa, mx, args, smi):
    """The loop phase: (a) the oracle above; (b) resnet50_v1 (1000 classes,
    Xavier from --seed, hybridized) trained one epoch (10 steps of 64) from
    a DataLoader over 640 host uint8 images with 4 workers
    (RandomFlipLeftRight, ToTensor, Normalize), NAG with a MultiFactor
    schedule and warmup, Trainer(kvstore="local"), accuracy, top-5 and loss
    metrics every batch; f32, then bf16 (net.cast, BatchNorm f32,
    multi_precision); each beside the vision phase's loop (SGD, one
    pre-staged batch) on the same weights; the store's reduction timed and
    the rate witness (_nag_witness); (d) Estimator.fit on resnet18_v1
    over 4 batches of (b)'s loader with a CheckpointHandler, the checkpoint
    reloaded bit for bit; (c) BERT-base bf16 10 steps from a 2-worker
    DataLoader, LAMB with a polynomial warmup-decay schedule, the loss and
    the accuracy of the argmax, beside the gluon phase's Adam loop on one
    batch.  The data is from --seed (LOOP_CLASSES, LOOP_SHADE; BERT
    reconstructs its tokens); NAG runs at LOOP_NAG's rate, LAMB at
    LOOP_LAMB_LR.  In every lane the last three steps' mean loss is below
    the first step's, the rates are the schedules', the loader never falls
    back and no worker outlives the phase; BERT launches 12 bf16 forward
    and 12 bf16 fused backward kernels a step, ResNet none."""
    import multiprocessing
    from mxnet_tpu_torch.gluon.data import dataloader
    tmx = mx["pkg"]
    gpu, B, size, classes = tmx.gpu(), VISION_BATCH, VISION_SIZE, 1000
    rng = np.random.RandomState(args.seed)
    y = rng.randint(0, LOOP_CLASSES, LOOP_IMAGES)
    x = (rng.randint(0, 256 - LOOP_SHADE * LOOP_CLASSES,
                     (LOOP_IMAGES, size, size, 3))
         + LOOP_SHADE * y[:, None, None, None]).astype(np.uint8)
    loop_oracle(torch, tmx, x, y)
    fallbacks0 = dataloader.fallbacks
    results = {}

    # (b) ResNet-50 through the DataLoader
    gc.collect()
    torch.cuda.empty_cache()
    _reset_counts(fa)
    loader = _image_loader(tmx, x, y, 4)
    procs = list(loader._pool._pool)
    net = tmx.gluon.model_zoo.get_model("resnet50_v1", classes=classes)
    tmx.random.seed(args.seed)
    net.initialize(tmx.init.Xavier(), ctx=gpu)
    flops_step = 3 * B * _net_flops(torch, tmx, net, tmx.nd.array(
        np.zeros((1, 3, size, size), np.float32), ctx=gpu))
    net.hybridize()
    params = net.collect_params()
    start = {k: p.data()._data.detach().clone() for k, p in params.items()}
    np.random.seed(args.seed)
    staged = next(iter(_image_loader(tmx, x, y, 0)))

    def restart():
        for k, p in params.items():
            p.set_data(start[k])
            p.data()._data.grad = None
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()

    nag_kw = LOOP_NAG

    def schedule(lr=nag_kw["learning_rate"]):
        return tmx.lr_scheduler.MultiFactorScheduler(
            step=[6, 8], factor=0.1, base_lr=lr, warmup_steps=3)

    kv_ms = None
    for dname in ("float32", "bfloat16"):
        lane = f"loop_resnet50_{'f32' if dname == 'float32' else 'bf16'}"
        mp = dname == "bfloat16"
        restart()
        if mp:
            net.cast("bfloat16")
        trainer = tmx.gluon.Trainer(params, "nag", dict(
            nag_kw, lr_scheduler=schedule(), multi_precision=mp),
            kvstore="local")
        metrics = tmx.metric.create(["acc", tmx.metric.TopKAccuracy(5)])
        loss_metric = tmx.metric.Loss()

        def update(y_, out, loss):
            before = loss_metric.sum_metric
            metrics.update([y_], [out])
            loss_metric.update(None, [loss])
            return loss_metric.sum_metric - before

        def step(x_, y_):
            return _loop_step(tmx, net, x_, y_, trainer, dname, B)

        np.random.seed(args.seed)
        it = iter(loader)
        rec = _loop_epoch(tmx, it, step, update, LOOP_STEPS, trainer, B)
        _check_run(lane, rec, [schedule()(k)
                               for k in range(1, LOOP_STEPS + 1)])
        _log(f"lane {lane}: metrics {metrics.get_name_value()} "
             f"{loss_metric.get_name_value()}")
        np.random.seed(args.seed + 1)
        it = iter(loader)
        for _ in range(2):
            step(*next(it))

        def iterations(n=3):
            for _ in range(n):
                x_, y_ = next(it)
                update(y_, *step(x_, y_))

        prof = _profile_step(torch, iterations, lane, VISION_FAMILIES, 3)
        r = results[lane] = _loop_numbers(torch, rec, B, prof)
        r["mfu"] = flops_step / (r["step_ms"] / 1e3) / PEAK_FLOPS[dname]
        if not mp:
            kv_ms = _kvstore_times(torch, tmx, params)
        trainer = it = None
        # the vision phase's loop on the same weights: SGD, one batch
        restart()
        if mp:
            net.cast("bfloat16")
        sgd = tmx.gluon.Trainer(params, "sgd", dict(VISION_SGD,
                                                    multi_precision=mp))
        bx, by = staged[0].astype(dname), staged[1].astype("float32")
        base = []
        ms = _timed_ms(tmx, lambda: base.append(_vision_sgd_step(
            tmx, net, bx, by, sgd, B)), LOOP_STEPS)
        med = statistics.median(ms[2:])
        results[lane + "_prestaged_sgd"] = {"step_ms": med,
                                            "per_s": B / (med / 1e3)}
        _log(f"lane {lane}: the vision phase's loop (SGD, one pre-staged "
             f"batch) on the "
             f"same weights, step ms {[round(v, 1) for v in ms]}, losses "
             f"{[round(float(v.asscalar()), 5) for v in base]}")
        sgd = base = None
    # NAG at LOOP_NAG_WITNESS_LR on the loop's first ten batches, fetched once
    np.random.seed(args.seed)
    random.seed(args.seed)
    it = iter(loader)
    batches = [next(it) for _ in range(LOOP_STEPS)]
    it = None
    witness = _nag_witness(torch, tmx, mx, net, params, restart, batches,
                           schedule, B)
    batches = None
    counts = _counts(fa)
    if any(counts.values()):
        raise AssertionError(f"the ResNet loop launched flash kernels: "
                             f"{counts}")
    # the share of next() that is the batch's host-to-card copy
    host = np.ones((B, 3, size, size), np.float32)
    copy_ms = statistics.median(_timed_ms(
        tmx, lambda: torch.from_numpy(host).to(gpu.torch_device()), 10)[2:])
    _log(f"host-to-card copy of one {host.nbytes / 1e6:.1f} MB f32 batch "
         f"(pageable, as the loader's): {copy_ms:.2f} ms (median of 8)")
    host = None

    # (d) Estimator.fit on resnet18_v1 over 4 batches of the same loader
    est_net = tmx.gluon.model_zoo.get_model("resnet18_v1", classes=classes)
    est_net.initialize(tmx.init.Xavier(), ctx=gpu)
    est_net.hybridize()
    est_mod = tmx.gluon.contrib.estimator
    est = est_mod.Estimator(
        est_net, tmx.gluon.loss.SoftmaxCrossEntropyLoss(),
        train_metrics=["acc"], trainer=tmx.gluon.Trainer(
            est_net.collect_params(), "nag", dict(nag_kw)))
    with tempfile.TemporaryDirectory() as d:
        t = time.perf_counter()
        est.fit(loader, epochs=1, batches=4, event_handlers=[
            est_mod.CheckpointHandler(d, model_prefix="resnet18")])
        fit_s = time.perf_counter() - t
        fresh = tmx.gluon.model_zoo.get_model("resnet18_v1",
                                              classes=classes)
        fresh.load_parameters(os.path.join(d, "resnet18-epoch0.params"),
                              ctx=gpu)
        states = os.path.exists(os.path.join(d, "resnet18-epoch0.states"))
    same = all(torch.equal(p.data()._data, q.data()._data)
               for p, q in zip(est_net.collect_params().values(),
                               fresh.collect_params().values()))
    _log(f"estimator resnet18_v1: fit 4 batches in {fit_s:.1f} s, "
         f"{est.train_loss_metric.get()} {est.train_metrics[0].get()}; "
         f"checkpoint reloads bit for bit: {same}; trainer states saved: "
         f"{states}")
    if not (same and states):
        raise AssertionError("estimator checkpoint does not reload")
    loader._shutdown_pool()
    net = est = est_net = fresh = loader = staged = params = start = None
    gc.collect()
    torch.cuda.empty_cache()

    # (c) BERT-base bf16 through a DataLoader, LAMB with warmup-decay
    bert = tmx.gluon.model_zoo.bert
    layers, units, Bb, L, vocab = (LOOP_BERT[k] for k in (
        "layers", "units", "batch", "seq", "vocab"))
    bnet = bert.BERTModel(vocab_size=vocab, num_layers=layers, units=units,
                          hidden_size=LOOP_BERT["hidden"],
                          num_heads=LOOP_BERT["heads"], max_length=L,
                          dropout=0.0, prefix="bert_")
    tmx.random.seed(args.seed)
    bnet.initialize(tmx.init.Normal(0.02), ctx=gpu)
    bparams = bnet.collect_params()
    n_matmul = sum(p.numel() for n, p in bnet.named_parameters()
                   if "word_embed" not in n and "position" not in n)
    flops_tok = 6 * n_matmul + 12 * layers * units * L
    bnet.hybridize()
    bnet.cast("bfloat16")
    bstart = {k: p.data()._data.detach().clone() for k, p in bparams.items()}
    toks = rng.randint(0, vocab, (LOOP_BERT_SAMPLES, L))
    bloader = tmx.gluon.data.DataLoader(
        tmx.gluon.data.ArrayDataset(toks, toks), batch_size=Bb, shuffle=True,
        last_batch="discard", num_workers=2, timeout=300)
    procs += list(bloader._pool._pool)

    def brestart():
        for k, p in bparams.items():
            p.set_data(bstart[k])
            p.data()._data.grad = None
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()

    def poly():
        return tmx.lr_scheduler.PolyScheduler(max_update=LOOP_STEPS,
                                              base_lr=LOOP_LAMB_LR, pwr=1,
                                              warmup_steps=2)

    brestart()
    trainer = tmx.gluon.Trainer(bparams, "lamb", {
        "learning_rate": LOOP_LAMB_LR, "wd": 0.01, "lr_scheduler": poly(),
        "multi_precision": True}, kvstore="local")
    lossf = tmx.gluon.loss.SoftmaxCELoss()
    loss_m, acc_m = tmx.metric.Loss(), tmx.metric.Accuracy()

    def bert_step(tb, lb):
        with tmx.autograd.record():
            logits = bnet(tb)[2]
            loss = lossf(logits.astype("float32", copy=False), lb)
        loss.backward()
        trainer.step(Bb)
        tmx.nd.waitall()
        return logits, loss

    def bert_update(lb, logits, loss):
        before = loss_m.sum_metric
        loss_m.update(None, [loss])
        acc_m.update([lb], [logits.argmax(axis=-1)])
        return loss_m.sum_metric - before

    _reset_counts(fa)
    np.random.seed(args.seed)
    it = iter(bloader)
    rec = _loop_epoch(tmx, it, bert_step, bert_update, LOOP_STEPS, trainer,
                      Bb)
    bert_counts = _counts(fa)
    lane = "loop_bert_seq512"
    _check_run(lane, rec, [poly()(k) for k in range(1, LOOP_STEPS + 1)])
    _log(f"lane {lane}: {loss_m.get()} {acc_m.get()}; launches over "
         f"{LOOP_STEPS} steps {bert_counts}")
    want = {"flash_fwd": layers * LOOP_STEPS,
            "flash_bwd_fused": layers * LOOP_STEPS}
    if any(n != want.get(k, 0) for k, n in bert_counts.items()):
        raise AssertionError(f"{lane}: launches {bert_counts}, want {want} "
                             f"and no other")
    np.random.seed(args.seed + 1)
    it = iter(bloader)
    for _ in range(2):
        tb, lb = next(it)
        bert_step(tb, lb)

    def bert_iterations(n=3):
        for _ in range(n):
            tb_, lb_ = next(it)
            bert_update(lb_, *bert_step(tb_, lb_))

    prof = _profile_step(torch, bert_iterations, lane, FLASH_FAMILIES, 3)
    r = results[lane] = _loop_numbers(torch, rec, Bb, prof)
    r["mfu"] = r["per_s"] * L * flops_tok / PEAK_FLOPS["bfloat16"]
    bloader._shutdown_pool()
    it = trainer = None
    # the gluon phase's loop on the same weights: Adam, one batch
    brestart()
    adam = tmx.gluon.Trainer(bparams, "adam", {"learning_rate": 1e-4,
                                               "multi_precision": True})
    _, ms = _gluon_steps(tmx, bnet, [tb], lb, LOOP_STEPS, adam)
    med = statistics.median(ms[2:])
    results[lane + "_prestaged_adam"] = {"step_ms": med,
                                         "per_s": Bb / (med / 1e3)}
    _log(f"lane {lane}: the gluon phase's loop (Adam, one pre-staged "
         f"batch) on the "
         f"same weights, step ms {[round(v, 1) for v in ms]}")
    adam = bnet = bparams = bstart = tb = lb = None
    gc.collect()
    torch.cuda.empty_cache()

    alive = [p for p in procs if p.is_alive()]
    if alive or multiprocessing.active_children():
        raise AssertionError(f"DataLoader workers outlive their loaders: "
                             f"{alive or multiprocessing.active_children()}")
    if dataloader.fallbacks != fallbacks0:
        raise AssertionError(f"the DataLoader fell back "
                             f"{dataloader.fallbacks - fallbacks0} times")
    for lane, r in results.items():
        unit = "samples/s" if "bert" in lane else "images/s"
        extra = "" if "idle_share" not in r else (
            f", MFU {r['mfu']:.4f}, peak {r['peak_gib']:.2f} GiB, idle share "
            f"{r['idle_share']:.3f}, next() {r['wait_ms']:.2f} ms (first "
            f"{r['first_wait_ms']:.1f}), metric.update {r['metric_ms']:.2f} "
            f"ms")
        _log(f"train {lane}: step {r['step_ms']:.2f} ms, {r['per_s']:.2f} "
             f"{unit}{extra} ({smi})")
    _log("kvstore local pushpull_list (ResNet-50 gradients): "
         + ", ".join(f"{n} replica{'s' if n > 1 else ''} {t:.3f} ms"
                     for n, t in kv_ms.items()) + f" ({smi})")
    for lane, losses in witness.items():
        _log(f"rate witness {lane}: NAG lr {LOOP_NAG_WITNESS_LR}, losses "
             f"{[round(v, 5) for v in losses]} ({smi})")
    return bert_counts, results


# -- nd: the rest of mx.nd ----------------------------------------------------

ND_SAMPLER_DRAWS = 10 ** 6      # draws per parameter set of each sampler
ND_TRANSFORMER = {"units": 512, "heads": 8, "batch": 32, "lq": 256,
                  "lk": 512, "self_len": 512}   # zoo transformer.py:45
ND_CPU_BATCH = 4                # batch rows the CPU recomputes
# bf16 card vs CPU, of max |CPU|: 4 bf16 ulps at the largest value.  The
# CPU's bf16 path rounds p, the output and each gradient step at other
# points than the flash tiles (a dense softmax and bf16 autograd), so each
# side sits about 2 ulps from the f32 result (7.1e-3 seen on an H100)
ND_BF16_HOST_TOL = 2.0 ** -6


def _nd_sweep(tmx, sweep):
    """Every op the port registers (the samplers apart) on the card and on
    the CPU from the same numpy inputs (``ops/sweep.py``): outputs and
    dtypes, and for a differentiable op the gradients of sum(out * w),
    within ``sweep.TOL`` of max |CPU| (1e-5 elementwise, 1e-4 for sums,
    linear algebra and attention; gradients 1e-4), the decompositions by
    their invariants.  Returns (ops compared, mismatches)."""
    names = sweep.sweep_ops()
    bad = []
    for name in names:
        arrays, attrs = sweep.op_inputs(name)
        got, got_g = sweep.run(tmx, name, arrays, attrs, tmx.gpu())
        want, want_g = sweep.run(tmx, name, arrays, attrs, tmx.cpu())
        err, tol = sweep.close(name, got, want, arrays)
        gerr = max((sweep.rel_err(g, w) for g, w in zip(got_g, want_g)),
                   default=0.0) if len(got_g) == len(want_g) else math.inf
        same_dtypes = [g.dtype for g in got] == [w.dtype for w in want]
        if err > tol or gerr > sweep.TOL["reduction"] or not same_dtypes:
            bad.append(name)
            _log(f"nd sweep MISMATCH {name}: outputs {err:.3g} (bound "
                 f"{tol:g}), gradients {gerr:.3g}, dtypes "
                 f"{[str(g.dtype) for g in got]} vs "
                 f"{[str(w.dtype) for w in want]}")
    _log(f"nd sweep: {len(names)} ops compared card vs CPU (of "
         f"{len(tmx.ops.registry.list_ops())} registered names, the "
         f"{len(sweep.SAMPLERS)} samplers apart), {len(bad)} mismatches")
    return len(names), bad


def _nd_default_context(tmx):
    """With no ctx, the samplers, mx.random, the creation ops and linalg
    land on the card.  Returns the names that did not."""
    nd = tmx.nd
    outs = {"nd.random.uniform": nd.random.uniform(shape=(4,)),
            "nd.random.randint": nd.random.randint(low=0, high=3,
                                                   shape=(4,)),
            "random.randn": tmx.random.randn(2, 2),
            "random.normal": tmx.random.normal(shape=(3,)),
            "nd.eye": nd.eye(N=3), "nd.linspace": nd.linspace(num=5),
            "nd.linalg.gemm2": nd.linalg.gemm2(nd.ones((2, 2)),
                                               nd.ones((2, 2)))}
    return [k for k, v in outs.items() if v.context.device_type != "gpu"]


def _nd_draw(tmx, name, arrays, attrs, ctx):
    reg = tmx.ops.registry
    out = reg.invoke(reg.get(name), [tmx.nd.array(a, ctx=ctx)
                                     for a in arrays], dict(attrs), ctx=ctx)
    out = out.asnumpy()
    return out.argmax(-1) if name == "gumbel_softmax" else out


def _nd_samplers(tmx, sweep):
    """With no ctx, the samplers land on the card (_nd_default_context);
    each sampler on the card: the same seed gives the same draws and
    two seeds different ones (1000 draws); at ND_SAMPLER_DRAWS draws per
    parameter set, f32, the sample mean and variance lie within 5
    standard errors of the distribution's and the goodness-of-fit p-value
    (KS, or chi-square for a discrete distribution) is above 1e-3.
    ``shuffle`` permutes rows, reproducibly."""
    gpu = tmx.gpu()
    bad = [f"{n} not on the card" for n in _nd_default_context(tmx)]
    for name, arrays, attrs, _ in sweep.sampler_cases(1000):
        draws = []
        for seed in (11, 11, 12):
            tmx.random.seed(seed)
            draws.append(_nd_draw(tmx, name, arrays, attrs, gpu))
        if not np.array_equal(draws[0], draws[1]) \
                or np.array_equal(draws[0], draws[2]):
            bad.append(f"{name} seeding")
    x = np.arange(4000, dtype=np.float32).reshape(1000, 4)
    perms = []
    for seed in (5, 5):
        tmx.random.seed(seed)
        perms.append(tmx.nd.shuffle(tmx.nd.array(x, ctx=gpu)).asnumpy())
    if not np.array_equal(perms[0], perms[1]) \
            or not np.array_equal(np.sort(perms[0][:, 0]), x[:, 0]) \
            or np.array_equal(perms[0], x):
        bad.append("shuffle")
    tmx.random.seed(13)
    for name, arrays, attrs, dists in sweep.sampler_cases(ND_SAMPLER_DRAWS):
        t0 = time.perf_counter()
        rows = _nd_draw(tmx, name, arrays, attrs, gpu).reshape(len(dists),
                                                               -1)
        t_draw = time.perf_counter() - t0
        for row, dist in zip(rows, dists):
            mz, vz, p = sweep.draw_stats(row, dist)
            ok = abs(mz) < 5 and abs(vz) < 5 and p > 1e-3
            _log(f"nd sampler {name} {dist[0]}{dist[1]}: {row.size} draws "
                 f"({t_draw:.2f} s with the copy): mean z {mz:+.2f}, var z "
                 f"{vz:+.2f}, fit p {p:.3g}" + ("" if ok else "  FAIL"))
            if not ok:
                bad.append(f"{name} {dist}")
    return bad


def _nd_attention_cases(rng):
    """(label, op, numpy inputs, attrs) at the zoo transformer's base
    widths: masked_encdec_att with valid lengths in [Lq, Lk], and
    multihead_attention at self length, not causal and causal."""
    t = ND_TRANSFORMER
    E, B, L = t["units"], t["batch"], t["self_len"]

    def arr(*shape):
        return (rng.standard_normal(shape) * 0.5).astype(np.float32)

    valid = rng.integers(t["lq"], t["lk"] + 1, B).astype(np.float32)
    return [
        (f"masked_encdec_att B={B} Lq={t['lq']} Lk={t['lk']} units={E} "
         f"heads={t['heads']}", "contrib.masked_encdec_att",
         [arr(t["lq"], B, E), arr(t["lk"], B, 2 * E), valid],
         {"heads": t["heads"]}),
        (f"multihead_attention B={B} L={L} units={E} heads={t['heads']}",
         "contrib.multihead_attention", [arr(L, B, E) for _ in range(3)],
         {"heads": t["heads"], "causal": False}),
        (f"multihead_attention causal B={B} L={L} units={E} "
         f"heads={t['heads']}", "contrib.multihead_attention",
         [arr(L, B, E) for _ in range(3)],
         {"heads": t["heads"], "causal": True}),
    ]


def _nd_inputs(tmx, arrays, ctx, dtype, batch=None):
    """The (L, B, E) inputs in ``dtype`` with a gradient buffer, the
    valid lengths (B,) in float32; ``batch`` keeps that many batch rows.
    Returns (inputs, the ones with a gradient)."""
    if batch is not None:
        arrays = [a[:, :batch] if a.ndim == 3 else a[:batch]
                  for a in arrays]
    ins = [tmx.nd.array(a, ctx=ctx, dtype=dtype if a.ndim == 3 else None)
           for a in arrays]
    floats = [a for a in ins if a.ndim == 3]
    for a in floats:
        a.attach_grad()
    return ins, floats


def _nd_attention_run(torch, tmx, name, arrays, attrs, ctx, dtype,
                      batch=None, flash_reference=False):
    """(out, grads of sum(out * w) in the inputs' order) as float32 CPU
    tensors; w is fixed for the full batch and cut with it."""
    reg = tmx.ops.registry
    L, B, E = arrays[0].shape
    w = np.random.RandomState(1).standard_normal((L, B, E)) \
        .astype(np.float32)[:, :batch]
    ins, floats = _nd_inputs(tmx, arrays, ctx, dtype, batch)
    with tmx.autograd.record():
        out = reg.invoke(reg.get(name), ins,
                         dict(attrs, flash_reference=flash_reference))
        (out * tmx.nd.array(w, ctx=ctx, dtype=dtype)).sum().backward()
    return [torch.from_numpy(out.asnumpy())] + \
        [torch.from_numpy(a.grad.asnumpy()) for a in floats]


def _nd_attention(torch, fa, tmx, args):
    """(c) the contrib attention family at the transformer's base widths,
    f32 and bf16, forward and gradients: each op against itself with the
    flash call bound to its plain version on the card
    (``flash_reference=True``), at the kernel phases' bounds (out: f32
    2e-5 max abs error, bf16 2 ulps of max(|ref|, 2^-6); gradients f32
    1e-4, bf16 5e-3 of max |ref|), and its first ND_CPU_BATCH batch rows
    against the CPU (the dense cross path, or the plain flash versions at
    self length): f32 2e-5 out and 1e-4 gradients, bf16 ND_BF16_HOST_TOL
    of max |ref|.  Returns the flash launches of the kernel
    runs (reset just before them, read just after), the cases and the
    failures."""
    gpu, cpu = tmx.gpu(), tmx.cpu()
    cases = _nd_attention_cases(np.random.default_rng(args.seed))
    dtypes = ("float32", "bfloat16")
    _reset_counts(fa)
    runs = {(d, c[0]): _nd_attention_run(torch, tmx, c[1], c[2], c[3], gpu,
                                         d)
            for d in dtypes for c in cases}
    torch.cuda.synchronize()
    launches = _counts(fa)
    bad = []
    for dname in dtypes:
        for label, name, arrays, attrs in cases:
            got = runs[(dname, label)]
            plain = _nd_attention_run(torch, tmx, name, arrays, attrs, gpu,
                                      dname, flash_reference=True)
            host = _nd_attention_run(torch, tmx, name, arrays, attrs, cpu,
                                     dname, batch=ND_CPU_BATCH)
            if dname == "float32":
                e_out = (got[0] - plain[0]).abs().max().item()
                out_ok = e_out <= TOL["float32"][0]
            else:                   # (L, B, E) as (B, 1, L, E), every row
                g, p = (t.permute(1, 0, 2)[:, None] for t in (got[0],
                                                             plain[0]))
                e_out = _bf16_ulps(torch, g, p,
                                   torch.ones(g.shape[0], g.shape[2]))
                out_ok = e_out <= BF16_OUT_ULPS
            e_grad = max(_rel_err(torch, g, r)
                         for g, r in zip(got[1:], plain[1:]))
            sub = [g[:, :ND_CPU_BATCH] for g in got]
            e_host_out = (sub[0] - host[0]).abs().max().item() \
                if dname == "float32" else _rel_err(torch, sub[0], host[0])
            e_host_grad = max(_rel_err(torch, g, r)
                              for g, r in zip(sub[1:], host[1:]))
            if dname == "float32":
                host_ok = e_host_out <= TOL["float32"][0] \
                    and e_host_grad <= BWD_TOL["float32"]
            else:
                host_ok = max(e_host_out, e_host_grad) <= ND_BF16_HOST_TOL
            ok = out_ok and e_grad <= BWD_TOL[dname] and host_ok
            unit = "max abs" if dname == "float32" else "bf16 ulps"
            _log(f"nd attention {label} {dname}: kernel vs plain out "
                 f"{e_out:.3g} ({unit}), grads {e_grad:.3g} (rel); card vs "
                 f"CPU (batch {ND_CPU_BATCH}) out {e_host_out:.3g}, grads "
                 f"{e_host_grad:.3g}" + ("" if ok else "  FAIL"))
            if not ok:
                bad.append(f"{label} {dname}")
    return launches, cases, bad


def _nd_attention_times(torch, tmx, cases, smi):
    """Device ms of one forward and backward of each case (its mean over
    10 in one torch.profiler window), and the flash kernels' share."""
    gpu = tmx.gpu()
    reg = tmx.ops.registry
    for dname in ("float32", "bfloat16"):
        for label, name, arrays, attrs in cases:
            ins, _ = _nd_inputs(tmx, arrays, gpu, dname)

            def step():
                with tmx.autograd.record():
                    out = reg.invoke(reg.get(name), ins, dict(attrs))
                out.backward()

            for _ in range(3):
                step()
            iters = 10
            _, rows = _profiled(torch, lambda: [step() for _ in
                                                range(iters)])
            total = sum(r[0] for r in rows) / iters
            flash = sum(r[0] for r in rows if "flash_" in r[2]) / iters
            _log(f"time nd {label} {dname}: forward+backward device "
                 f"{total:.3f} ms, flash kernels {flash:.3f} ms (share "
                 f"{flash / max(total, 1e-9):.3f}) ({smi})")


def nd_phase(torch, fa, mx, args, smi):
    """The nd phase: (a) the op sweep card vs CPU (_nd_sweep); (b) the
    samplers on the card (_nd_samplers); (c) masked_encdec_att and
    multihead_attention at the zoo transformer's base widths through the
    flash kernels (_nd_attention), with their device times.  Fails on any
    mismatch or failed check, or if the attention ops launched no flash
    forward or backward kernel."""
    from mxnet_tpu_torch.ops import sweep
    tmx = mx["pkg"]
    t0 = time.perf_counter()
    n_ops, bad_ops = _nd_sweep(tmx, sweep)
    t1 = time.perf_counter()
    bad_draws = _nd_samplers(tmx, sweep)
    t2 = time.perf_counter()
    launches, cases, bad_att = _nd_attention(torch, fa, tmx, args)
    t3 = time.perf_counter()
    _nd_attention_times(torch, tmx, cases, smi)
    _log(f"nd: sweep {t1 - t0:.1f} s, samplers {t2 - t1:.1f} s, attention "
         f"{t3 - t2:.1f} s, times {time.perf_counter() - t3:.1f} s; flash "
         f"launches " + ", ".join(f"{k} {v}" for k, v in launches.items()
                                  if v))
    want_bwd = "flash_bwd_fused" if fa.bwd_is_fused(
        ND_TRANSFORMER["lq"], ND_TRANSFORMER["lk"]) else "flash_bwd_dq"
    if not launches["flash_fwd"] or not launches[want_bwd]:
        raise AssertionError(f"the attention ops launched no flash kernel: "
                             f"{launches}")
    if bad_ops or bad_draws or bad_att:
        raise AssertionError(f"nd phase: op mismatches {bad_ops}, samplers "
                             f"{bad_draws}, attention {bad_att}")
    return launches, n_ops


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
        import mxnet_tpu_torch
        from mxnet_tpu_torch import optimizer, parallel, serving
        from mxnet_tpu_torch.ops import nn as ops_nn
    except ImportError as e:
        print(f"chip_smoke: the port is not importable here: {e}",
              file=sys.stderr)
        return 3
    mx = {"bert": bert, "llama": llama, "optimizer": optimizer,
          "parallel": parallel, "nn": ops_nn, "pkg": mxnet_tpu_torch}

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
            _log(f"ptxas {src}: {name}: {regs}; {spill}")
            if spilled:
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
    gluon_counts, _ = _phase("gluon", gluon_phase, torch, fa, mx, args, smi)
    vision_counts, _ = _phase("vision", vision_phase, torch, fa, mx, args,
                              smi)
    loop_counts, _ = _phase("loop", loop_phase, torch, fa, mx, args, smi)
    nd_counts, _ = _phase("nd", nd_phase, torch, fa, mx, args, smi)

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
        # the Gluon loop's timed steps, f32 and bf16 lanes
        "gluon_launches": sum(c["flash_fwd"] for c in gluon_counts.values()),
        # the ResNet-50 vision phase has no attention
        "vision_launches": vision_counts["flash_fwd"],
        # the loop phase's timed steps: BERT bf16 (ResNet-50 launches none)
        "loop_launches": loop_counts["flash_fwd"],
        # the nd phase's attention ops, f32 and bf16
        "nd_launches": nd_counts["flash_fwd"],
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
                 "dq": "simt::flash_bwd_dq_kernel<float, DP, BQ, BK>",
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
                "vision_launches": vision_counts[
                    f"flash_bwd_{kind_}" + ("_f32" if pre else "")],
                "loop_launches": loop_counts[
                    f"flash_bwd_{kind_}" + ("_f32" if pre else "")],
                "nd_launches": _dtype_count(nd_counts, kind_, pre),
            })
            if kind_ == "fused":
                kernels[-1]["gluon_launches"] = \
                    gluon_counts[dname]["flash_bwd_fused"]
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
