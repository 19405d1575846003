#!/usr/bin/env python3
"""A/B of the port's flash backward kernels on one GPU, in one process.

Compares ``kernels/csrc/flash_bwd.cu`` of this checkout ("head") with the
same source of another revision ("base"), on one card in one call, so that
the spread between calls and cards stays out of the difference:

    mkdir -p build/base
    git archive <rev> mxnet_tpu_torch/kernels/csrc | tar -x -C build/base
    python3 tools/torch_bwd_ab.py --base build/base/mxnet_tpu_torch/kernels/csrc

It builds both libraries (one ``nvcc`` each, in parallel with the forward),
then
 1. times each backward entry point at ``chip_smoke.py``'s shapes, f32 and
    bf16, in turns base, head, head, base (CUDA events, as chip_smoke);
 2. runs ``chip_smoke.py``'s four training lanes (``bert_seq512``,
    ``llama_seq2048`` and their f32 twins) with each library in turns
    base, head, head, base, and prints each run's median step ms,
    samples/s, MFU, peak memory and device time by kernel family.
Only the backward library differs between the two sides; the forward is
the checkout's.  Both sides must build and launch; nothing falls back.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--base", required=True,
                    help="directory holding the base revision's csrc/")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("torch_bwd_ab: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from mxnet_tpu_torch.kernels import _build
    from mxnet_tpu_torch.kernels import flash_attention as fa
    from mxnet_tpu_torch.gluon.model_zoo import bert, llama
    from mxnet_tpu_torch import optimizer, parallel
    from mxnet_tpu_torch.ops import nn as ops_nn

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    print(f"device: {torch.cuda.get_device_name(0)}; {smi}", flush=True)
    t0 = time.perf_counter()
    base_so = os.path.join(_build.BUILD_DIR, "libflash_bwd_base.so")
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    proc = subprocess.Popen(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-o", base_so,
         os.path.join(args.base, "flash_bwd.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    _build.build_kernel_libraries(["flash_fwd", "flash_bwd"])
    base_log = proc.communicate()[0]
    if proc.returncode != 0:
        raise RuntimeError(f"base flash_bwd.cu did not build:\n{base_log}")
    print(f"build: {time.perf_counter() - t0:.1f} s", flush=True)
    for side, log in (("base", base_log),
                      ("head", _build.build_log("flash_bwd"))):
        for name, regs, _, spill in cs._ptxas_summary(log):
            print(f"ptxas {side}: {name}: {regs}; {spill}", flush=True)
    base = ctypes.CDLL(base_so)
    fa._declare("flash_bwd", base)
    head = fa._kernel_lib("flash_bwd")
    sides = {"base": base, "head": head}
    order = ("base", "head", "head", "base")

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(4321)
    for kind, B, H, L, D, causal in [("fused", 32, 12, 512, 64, False),
                                     ("dq", 4, 16, 2048, 128, True),
                                     ("dkv", 4, 16, 2048, 128, True)]:
        launch = {"fused": fa.launch_bwd_fused, "dq": fa.launch_bwd_dq,
                  "dkv": fa.launch_bwd_dkv}[kind]
        for dt in (torch.float32, torch.bfloat16):
            q, k, v, do = (torch.randn(B, H, L, D, generator=gen, device=dev)
                           .to(dt) for _ in range(4))
            out, lse = fa._fwd(q, k, v, None, None, causal, D ** -0.5)
            x = fa.prepare_bwd(q, k, v, None, None, out, lse, do, causal,
                               D ** -0.5)
            times = {s: [] for s in sides}
            for s in order:
                fa._libs["flash_bwd"] = sides[s]
                times[s].append(cs._time_ms(torch, lambda: launch(x)))
            bound, by = cs._bwd_bound_ms(kind, B, H, L, L, D,
                                         str(dt).split(".")[1], causal)
            print(f"time {kind} B={B} H={H} L={L} D={D} {dt} causal="
                  f"{causal}: base {times['base']} ms, head {times['head']} "
                  f"ms, bound {bound:.4f} ms ({by})", flush=True)
    mx = {"bert": bert, "llama": llama, "optimizer": optimizer,
          "parallel": parallel, "nn": ops_nn}
    for s in order:
        fa._libs["flash_bwd"] = sides[s]
        _, res = cs.train_lane_phase(torch, fa, mx, args)
        for lane, r in res.items():
            fams = {k: round(v, 1)
                    for k, v in r["profile"]["families"].items()}
            print(f"lanes {s} {lane}: step {r['step_ms']:.2f} ms, "
                  f"{r['samples_per_s']:.2f} samples/s, MFU {r['mfu']:.4f}, "
                  f"peak {r['peak_gib']:.2f} GiB, device busy "
                  f"{r['profile']['device_ms']:.1f} ms, families {fams}",
                  flush=True)
    fa._libs["flash_bwd"] = head
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
