"""Designated scopes the graftcheck passes key on — the port's tables.

One committed registry of WHERE each rule applies: the hot-path purity
scope (GC01/GC05), the flag-discipline module set (GC05), and the
threaded-module prefixes (GC04/GC06/GC10).  Passes import these instead
of hard-coding paths so adding a module to a scope is one reviewable
diff line.  The tables name the port's own modules and functions (a test
holds every name to a function that exists); where the port's names
differ from the reference's, the port's are here.
"""

from __future__ import annotations

import ast

# --------------------------------------------------------------------------
# designated scopes
# --------------------------------------------------------------------------

# Hot-path purity scope (GC01/GC05): module rel-path -> function names, or
# None meaning every function in the module is hot.
# ``resilience/controller.py``'s monitor loop (the reference's
# _watch_loop, _poll_workers, _read_heartbeats, _check_hangs,
# _check_straggler, _manifest_latest) joins the table when
# ElasticController is ported (ROADMAP A.9): the port's controller.py
# holds only the pid probes so far.
HOT_PATHS = {
    # op dispatch: every imperative op and every F.<op> of a hybridized
    # block runs these
    "ops/registry.py": {"invoke", "invoke_arrays", "_invoke_costed",
                        "_invoke_tensors", "_write_back", "_promote",
                        "_run_host_f32"},
    "kvstore/fusion.py": None,
    "kvstore/local.py": {"_reduce", "_reduce_rowsparse", "_push_sum",
                         "push", "pull", "pushpull", "pushpull_list",
                         "pushpull_flat", "_bucket_sums", "_stage",
                         "_fusable", "_across"},
    "gluon/trainer.py": {"step", "_allreduce_grads", "_reduce", "_update",
                         "_update_all", "_update_fused",
                         "_update_per_param", "_fused_kind"},
    "optimizer_fusion.py": None,
    # serving hot path: the per-iteration scheduler core and the decode
    # bodies (models.py, the paged attention gather) must stay
    # host-sync-free
    "serving/engine.py": {"step", "_admit", "_admit_one", "_ensure_blocks",
                          "_emit", "_req_finished", "_finish", "_preempt",
                          "_spec_step", "_spec_budgets", "_upload_tables",
                          "_sync_prefix_counters"},
    "serving/models.py": None,
    # prefix-cache bookkeeping: match/admit/prepare_write/ensure_capacity
    # run on every admission and scheduler iteration
    "serving/cache.py": None,
    "kernels/paged_attention.py": None,
    # the flash kernels' wrappers run inside every captured training step
    # and every prefill: a host sync there would fail the capture or
    # stall serving
    "kernels/flash_attention.py": {"_launch", "_fwd", "_fwd_run",
                                   "_delta", "prepare_bwd", "_call_bwd",
                                   "launch_bwd_fused", "launch_bwd_dq",
                                   "launch_bwd_dkv", "_bwd", "_bwd_run",
                                   "forward", "backward",
                                   "flash_attention"},
    # io decode pipeline: the per-batch scheduler/collector core and the
    # worker decode body are the input-bound hot path
    "io/pipeline.py": {"next_batch", "_assemble_loop", "_collect", "_pump",
                       "_issue", "_inline_chunk", "_decode_chunk",
                       "_decode_into", "_attach_slab"},
    # sharding rules resolve on the TrainStep's first call of a layout,
    # on its dispatch path
    "sharding.py": None,
    # TrainStep: the per-step dispatch (__call__, run), the step body the
    # card captures (_body and the loss it calls), the host's per-step
    # scalars (_advance) and the replay (_step)
    "parallel.py": {"__call__", "run", "_step", "_eager", "_advance",
                    "_update", "_body", "_loss", "_shard_loss",
                    "_forward_in"},
    # observability plane: the StepClock feeds from the trainer/TrainStep
    # step path and counter shipping rides the decode ack channel — both
    # must stay host-sync-free and flag-disciplined
    "telemetry/stepclock.py": {"begin_step", "note", "end_step"},
    "telemetry/aggregate.py": {"counter_deltas", "absorb_counter_deltas"},
    # the cost ledger's site boundary sits on every instrumented call (op
    # dispatch included when armed) and the scrape handler runs per
    # request on server threads
    "telemetry/costmodel.py": {"__call__", "admit", "call"},
    "telemetry/httpd.py": {"do_GET"},
    # perf-regression gate: the steady-state capture window is the
    # measured region of every lane — a host sync inside it would
    # serialize the dispatches it is counting (lane warm-up/drain syncs
    # deliberately sit OUTSIDE these functions)
    "telemetry/perfgate.py": {"_steady_capture", "_metric_value",
                              "_site_rollup"},
    "resilience/heartbeat.py": {"set_step", "beat", "_beater"},
    # serving router tier: the dispatch/ack/reader loops run per request,
    # the monitor polls several times a second, and the replica's
    # waiter/handler sit on every ack
    "serving/router.py": {"_dispatch_loop", "_dispatch_one",
                          "_pick_replica", "_send_to", "_on_ack",
                          "_reader_loop", "_monitor_loop", "_hedge_scan",
                          "_respawn_dead", "_check_heartbeats",
                          "_sweep_queued_deadlines", "_finish_req"},
    "serving/replica.py": {"_handle", "_waiter", "_send", "_load"},
}

# GC05 additionally audits these (they sit on the per-batch/per-call path
# even though they are not purity-critical).
FLAG_DISCIPLINE_MODULES = set(HOT_PATHS) | {
    "gluon/data/dataloader.py", "kvstore/dist.py",
}

# Threaded modules (GC04): rel-path prefixes.  These own locks or run user
# code on worker threads.
THREADED_MODULES = (
    "engine.py", "native.py", "profiler.py", "checkpoint.py",
    "ops/registry.py", "telemetry/", "resilience/",
    "gluon/data/dataloader.py", "kvstore/sparse_ps.py", "serving/",
    "io/pipeline.py", "kernels/_build.py",
)


def _dotted(expr):
    """'a.b.c' for a Name/Attribute chain, else None."""
    parts = []
    while isinstance(expr, ast.Attribute):
        parts.append(expr.attr)
        expr = expr.value
    if isinstance(expr, ast.Name):
        parts.append(expr.id)
        return ".".join(reversed(parts))
    return None


def _is_threaded(rel):
    return any(rel == t or (t.endswith("/") and rel.startswith(t))
               for t in THREADED_MODULES)


def _walk_shallow(fn):
    """Yield nodes of ``fn``'s body without descending into nested
    function definitions (those are analyzed as their own scopes)."""
    stack = [fn]
    while stack:
        node = stack.pop()
        yield node
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.Lambda)):
                continue
            stack.append(child)


def _hot_functions(module):
    """Yield (qualname, FunctionDef) for every designated hot function in
    the module (nested defs inside a hot function are hot too)."""
    spec = HOT_PATHS.get(module.rel)
    if module.rel not in HOT_PATHS:
        return

    def walk(node, prefix, inside_hot):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                qual = f"{prefix}{child.name}"
                hot = inside_hot or spec is None or child.name in spec
                if hot:
                    yield qual, child
                yield from walk(child, qual + ".", hot)
            elif isinstance(child, ast.ClassDef):
                yield from walk(child, f"{prefix}{child.name}.", inside_hot)

    yield from walk(module.tree, "", False)


