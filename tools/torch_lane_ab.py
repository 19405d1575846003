#!/usr/bin/env python3
"""A/B of the port's BERT training lanes between two revisions of the
package, on one GPU, in one process.

Loads ``mxnet_tpu_torch`` of this checkout ("head") and the same package of
another revision ("base", imported under the name
``mxnet_tpu_torch_base``), so the spread between calls and cards stays out
of the difference:

    mkdir -p build/base
    git archive <rev> mxnet_tpu_torch | tar -x -C build/base
    python3 tools/torch_lane_ab.py --base build/base

It builds both revisions' kernels (one ``nvcc`` per source, all at once),
then runs ``chip_smoke.py``'s ``bert_seq512`` (bf16, multi-precision Adam)
and ``bert_seq512_f32`` lanes through ``parallel.TrainStep`` with each
revision in turns base, head, head, base, and prints each run's median
step ms, samples/s, MFU, peak memory and one profiled step (device busy
time and idle share), with the card's name and power limit.  Everything
but the package (the lane's model, batch, optimizer and timing) is
``chip_smoke.py``'s.  Both sides must build and launch; nothing falls
back.
"""

from __future__ import annotations

import argparse
import importlib.util
import os
import subprocess
import sys
import threading

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def _load_base(root):
    """Import ``root/mxnet_tpu_torch`` as ``mxnet_tpu_torch_base``."""
    pkg = os.path.join(os.path.abspath(root), "mxnet_tpu_torch")
    spec = importlib.util.spec_from_file_location(
        "mxnet_tpu_torch_base", os.path.join(pkg, "__init__.py"),
        submodule_search_locations=[pkg])
    mod = importlib.util.module_from_spec(spec)
    sys.modules["mxnet_tpu_torch_base"] = mod
    spec.loader.exec_module(mod)
    return mod


def _side(name):
    """The modules ``chip_smoke.train_lane_phase`` takes, of package
    ``name``, and its flash_attention module (the launch counters)."""
    sub = {k: importlib.import_module(f"{name}.{m}") for k, m in (
        ("bert", "gluon.model_zoo.bert"), ("llama", "gluon.model_zoo.llama"),
        ("optimizer", "optimizer"), ("parallel", "parallel"),
        ("nn", "ops.nn"), ("fa", "kernels.flash_attention"),
        ("build", "kernels._build"))}
    return sub


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--base", required=True,
                    help="directory holding the base revision's "
                         "mxnet_tpu_torch/")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("torch_lane_ab: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    _load_base(args.base)
    sides = {"base": _side("mxnet_tpu_torch_base"),
             "head": _side("mxnet_tpu_torch")}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    print(f"device: {torch.cuda.get_device_name(0)}; {smi}", flush=True)
    errors = []

    def build(side):
        try:
            side["build"].build_kernel_libraries(["flash_fwd", "flash_bwd"])
        except Exception as e:  # reported and re-raised below
            errors.append(e)
    threads = [threading.Thread(target=build, args=(s,))
               for s in sides.values()]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    cs.TRAIN_LANES = (("bert_seq512", "bfloat16"),
                      ("bert_seq512_f32", "float32"))
    rows = []
    for turn, name in enumerate(("base", "head", "head", "base")):
        side = sides[name]
        print(f"== turn {turn + 1}: {name}", flush=True)
        _, lanes = cs.train_lane_phase(torch, side["fa"], side, args)
        for lane, r in lanes.items():
            prof = r["profile"]
            rows.append((lane, name, r["step_ms"], r["samples_per_s"],
                         r["mfu"], r["peak_gib"], prof["wall_ms"],
                         prof["device_ms"]))
    for lane, name, ms, sps, mfu, peak, wall, busy in sorted(
            rows, key=lambda r: r[0]):
        print(f"ab {lane} {name}: step {ms:.2f} ms, {sps:.2f} samples/s, "
              f"MFU {mfu:.4f}, peak {peak:.2f} GiB; profiled step wall "
              f"{wall:.1f} ms, device busy {busy:.1f} ms (idle share "
              f"{max(0.0, 1 - busy / wall):.3f}) ({smi})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
