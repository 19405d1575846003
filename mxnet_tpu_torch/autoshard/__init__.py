"""Auto-sharder — the port of ``mxnet_tpu/autoshard``: pick mesh shape +
rule pack + microbatch/remat under a per-device memory budget,
analytically.

    from mxnet_tpu_torch import autoshard
    p = autoshard.plan(net, global_batch=512, seq=2048,
                       hbm_budget_bytes=16 << 30)
    step = parallel.TrainStep(net, loss_fn, "adam", plan=p)
    p.save("plan.json")

See planner.py for the search space and the determinism contract.
"""

from .planner import (Plan, plan, enumerate_candidates, load_plan,
                      infer_family, zoo_shapes, PLAN_VERSION)

__all__ = ["Plan", "plan", "enumerate_candidates", "load_plan",
           "infer_family", "zoo_shapes", "PLAN_VERSION"]
