"""Environment knobs the port reads — its own small copy of the entries of
``mxnet_tpu/config.py`` that the port reads (same
names, same defaults, same typed accessors)."""

from __future__ import annotations

import os

__all__ = ["get", "get_int", "get_float", "get_bool", "describe",
           "KNOWN_VARS"]

# name -> (default, help)
KNOWN_VARS = {
    "MXNET_DATALOADER_RETRIES": (
        "2",
        "Worker-pool batch failures a DataLoader absorbs by refetching in "
        "its own process before it loads in one process for good."),
    "MXNET_IO_POOL": (
        "1",
        "If 1 (default), ImageRecordIter(preprocess_threads>1) and a "
        "DataLoader with workers over a decode-aware dataset run the "
        "shared-memory decode pipeline; 0 keeps the per-batch pools."),
    "MXNET_IO_PREFETCH": (
        "2",
        "Batches the decode pipeline keeps in flight ahead of the "
        "consumer (shared-memory slabs: this + 1)."),
    "MXNET_IO_CHUNK": (
        "0",
        "Records per decode-pool task; 0 = one task wave per batch across "
        "the workers."),
    "MXNET_IO_TIMEOUT_S": (
        "60",
        "Seconds a decode chunk may take before its worker counts as hung "
        "and the pool is killed and rebuilt."),
    "MXNET_FUSED_ATTENTION": (
        "1",
        "If 1 (default), attention at flash-eligible shapes runs the "
        "hand-written flash kernels; 0 forces the dense path."),
    "MXNET_FLASH_MIN_SEQ": (
        "256",
        "Shortest sequence the flash kernel handles; shorter ones take the "
        "dense masked-softmax path."),
    "MXNET_GELU_TANH": (
        "0",
        "If 1, gelu defaults to the tanh approximation "
        "0.5x(1+tanh(sqrt(2/pi)(x+0.044715x^3))) instead of the exact erf "
        "form; an explicit approximate= argument always wins."),
    "MXNET_KVSTORE_BUCKET_MB": (
        "25",
        "Gradient bucket size (MB) of the local kvstore's pushpull_list: "
        "dense gradients reduce bucket by bucket; 0 reduces key by key."),
    "MXNET_PARAMS_FORMAT": (
        "npz",
        "Default mx.nd.save container: 'npz' (bfloat16 included) or 'dmlc' "
        "(the reference's byte-compatible .params layout); load() "
        "auto-detects both."),
    "MXNET_MICROBATCH": (
        "1",
        "Default of parallel.TrainStep(n_micro=): the batch splits into "
        "this many slices whose gradients accumulate in a fixed order "
        "before ONE optimizer update. 1 (default) keeps the single-pass "
        "step, bit for bit."),
    "MXNET_REMAT": (
        "0",
        "Default of parallel.TrainStep(remat=): if 1, the net's forward "
        "runs under gluon.utils.remat_call, so its activations are "
        "recomputed during backward instead of kept (memory for compute; "
        "single-output nets only)."),
    "MXNET_BACKWARD_DO_MIRROR": (
        "0",
        "If 1, LlamaModel(remat=None) recomputes each decoder block's "
        "activations during backward (remat_call per block) instead of "
        "keeping them (MXNet's mirror memory/compute trade)."),
    "MXNET_ENGINE_TYPE": (
        "ThreadedEnginePerDevice",
        "Execution engine. 'NaiveEngine' synchronizes the device after "
        "every op, so an asynchronous CUDA error surfaces at the op that "
        "caused it; anything else keeps torch's asynchronous launches."),
    "MXNET_OPTIMIZER_FUSED": (
        "1",
        "If 1 (default), exact Adam and SGD updates of a gluon.Trainer "
        "run as one update over all parameters (optimizer_fusion: one "
        "chain of in-place torch._foreach_* passes per dtype, bitwise "
        "identical to the per-key path); 0 updates key by key."),
    "MXNET_OPTIMIZER_BUCKET_MB": (
        "25",
        "The reference's fused-optimizer bucket bound (MB). <= 0 "
        "disables optimizer fusion; a positive value bounds nothing here "
        "(the fused update covers all parameters at once)."),
    "MXNET_CHECKPOINT_KEEP": (
        "3",
        "How many step checkpoints mx.checkpoint.CheckpointManager keeps."),
    "MXNET_RESILIENCE_SIGTERM_SAVE": (
        "1",
        "If 1, mx.checkpoint.auto_resume installs a SIGTERM hook that "
        "checkpoints after the in-flight step and returns cleanly "
        "(preemption-safe save); 0 leaves the default signal behavior."),
    "MXNET_SERVING_BLOCK_TOKENS": (
        "16", "Paged-KV block size (token positions per pool block)."),
    "MXNET_SERVING_MAX_BATCH": (
        "8", "Decode slots in the continuous batch."),
    "MXNET_SERVING_MAX_SEQ": (
        "256", "Longest sequence (prompt + generation) a request may reach."),
    "MXNET_SERVING_NUM_BLOCKS": (
        "0", "KV pool blocks (plus scratch block 0); 0 = worst case."),
    "MXNET_SERVING_PREFILL_TOKENS": (
        "64", "Fixed padded prompt shape (1, P) of the prefill step."),
    "MXNET_SERVING_SLA_S": (
        "0", "Default per-request SLA deadline in seconds; 0 = none."),
    "MXNET_SERVING_PREFIX_CACHE": (
        "0",
        "If 1, the paged KV cache refcounts blocks and indexes full blocks "
        "of prompt tokens: a prompt sharing a cached prefix maps those "
        "blocks (copy-on-write on contended writes) and prefills only its "
        "tail. Decoder-only (llama) engines only."),
    "MXNET_SERVING_DRAFT": (
        None,
        "Draft-model zoo config name for speculative decoding in the "
        "replica CLI (built with the engine's vocab and seed); unset = "
        "off. In-process callers pass ServingEngine(draft_model=)."),
    "MXNET_SERVING_SPEC_K": (
        "3",
        "Draft tokens proposed per scheduler iteration when speculative "
        "decoding is armed; the target verifies them in one (B, K+1) "
        "dispatch, so output equals plain greedy decoding."),
    "MXNET_TELEMETRY": (
        "0",
        "If 1, the span tracer records from import; 0 leaves it off until "
        "telemetry.enable()."),
    "MXNET_TELEMETRY_BUFFER": (
        "65536",
        "Span ring-buffer capacity (events); oldest events drop beyond it."),
    "MXNET_TELEMETRY_DIR": (
        None,
        "Cross-process telemetry collection directory: every process "
        "exports a rank-tagged span+metric snapshot here at exit (and on "
        "flight-recorder dumps); telemetry.aggregate merges the shards "
        "into one Chrome trace and one Prometheus snapshot.  Unset = no "
        "export."),
    "MXNET_TELEMETRY_PORT": (
        None,
        "If set, a daemon-thread HTTP server exposes the live telemetry "
        "plane on this port: /metrics (Prometheus exposition of the "
        "registry), /statusz (knobs, world, step-clock verdict, serving "
        "gauges), /ledger.json (cost and op ledgers), /healthz, "
        "/perfgate.json (the live ledger against the committed perf "
        "baseline).  0 binds an ephemeral port; unset (default) = no "
        "server."),
    "MXNET_PERFGATE_BASELINE": (
        None,
        "Path of the committed perf baseline the gate diffs against "
        "(tools/torch_perfgate.py --check, /perfgate.json).  Unset "
        "(default) = tests/perf_baseline_torch.json, the host tier; the "
        "card tier is tests/perf_baseline_torch_cuda.json."),
    "MXNET_PERFGATE_LANES": (
        None,
        "Comma-separated lane filter for perfgate snapshot/check runs "
        "(e.g. 'bert_headline,trainer_fused_kvstore').  Unset (default) = "
        "every registered lane; a filtered --check is reported as "
        "PARTIAL."),
    "MXNET_PERFGATE_CHILD_TIMEOUT_S": (
        "420",
        "Per-lane wall budget (seconds) of the perfgate snapshot child "
        "processes (each lane builds its workload and runs its "
        "steady-state window in a fresh interpreter)."),
    "MXNET_STEPCLOCK_WINDOW": (
        "64",
        "Steps the StepClock keeps for the rolling input-/comms-/compute-"
        "bound verdict and telemetry.report()'s phase medians."),
    "MXNET_COSTMODEL": (
        "0",
        "If 1, the cost ledger arms at import: each captured TrainStep "
        "signature, each (op, shapes) dispatched through ops.registry, "
        "the fused optimizer update and the serving entries record their "
        "FLOPs (torch's FlopCounterMode, the flash kernels by formula), "
        "bytes accessed and peak device bytes into "
        "telemetry.costmodel.LEDGER."),
    "MXNET_PEAK_FLOPS": (
        "0",
        "Per-card peak FLOP/s for analytic-MFU accounting (0 = from the "
        "device table: H100 SXM 989.4e12 bf16 / 66.9e12 f32, H100 PCIe "
        "756e12 / 51.2e12; CPU 5e11)."),
    "MXNET_PEAK_HBM_GBS": (
        "0",
        "Per-card memory bandwidth in GB/s for the roofline ridge (0 = "
        "from the device table: H100 SXM 3350, H100 PCIe 2000, CPU 50)."),
    "MXNET_FLIGHTREC": (
        "1",
        "If 1 (default), the crash flight recorder arms at import: "
        "unhandled exceptions, deadline-exceeded, chaos 'exit' faults, "
        "SIGTERM, and SIGUSR2 (on demand) each dump a bounded postmortem "
        "(last spans, metric state, chaos sites, resolved knobs) per "
        "rank.  0 disables the dumps and installs no handlers."),
    "MXNET_FLIGHTREC_DIR": (
        None,
        "Directory for flight-recorder dumps (default: MXNET_TELEMETRY_DIR "
        "when set, else ~/.cache/mxnet_tpu_torch/flightrec, never the "
        "working tree)."),
    "MXNET_FLIGHTREC_SPANS": (
        "256",
        "Most-recent trace events included in each flight-recorder dump."),
    "MXNET_FLIGHTREC_MAX_DUMPS": (
        "16",
        "Flight-recorder dump-file cap per process (a retry loop hitting "
        "deadlines must not flood the disk)."),
    "MXNET_KVSTORE_TIMEOUT_S": (
        "300",
        "Default resilience.Deadline bound (seconds) on blocking waits "
        "(ResultHandle.result, RouterHandle.result, the dist kvstore's "
        "rendezvous and collectives); 0 disables it."),
    "MXNET_RESILIENCE_MAX_RETRIES": (
        "3",
        "Re-attempts a Retry policy makes after the first failure of a "
        "transient (retryable) operation; 0 fails fast."),
    "MXNET_RESILIENCE_BACKOFF_S": (
        "0.05",
        "Base backoff (seconds) before retry attempt k sleeps "
        "backoff * 2^k (with +/-25% jitter)."),
    "MXNET_RESILIENCE_BACKOFF_MAX_S": (
        "2", "Cap on the exponential retry backoff (seconds)."),
    "MXNET_LOCKCHECK": (
        "0",
        "If 1, locks created through analysis.tracked() record their "
        "acquisition order and raise LockOrderError on a cycle — the "
        "runtime twin of graftcheck GC06 (debug/test builds; disarmed "
        "locks are returned raw, zero overhead)."),
    "MXNET_CHAOS": (
        "0",
        "If 1, arm chaos faults from MXNET_CHAOS_SITES at import "
        "(resilience.chaos fault injection for recovery testing)."),
    "MXNET_CHAOS_SITES": (
        None,
        "Comma list of faults to arm when MXNET_CHAOS=1: "
        "'site:kind[:times[:delay_s[:after]]]' with kind in "
        "delay|transient|fatal|exit, e.g. 'serving.reply:exit:1'."),
    "MXNET_DIST_COORDINATOR": (
        None,
        "host:port of the dist kvstore's rendezvous (a TCP store that rank "
        "0 serves; tools/launch.py writes it); unset = a world of one."),
    "MXNET_DIST_NUM_WORKERS": (
        "1", "World size the dist kvstore rendezvous waits for (and a "
             "heartbeat record reports)."),
    "MXNET_DIST_RANK": (
        "0", "This process's rank in the dist kvstore world (heartbeat "
             "file name; the router sets it to the replica index)."),
    "MXNET_KVSTORE_BIGARRAY_BOUND": (
        str(1000 * 1000),
        "Accepted for parity and ignored: the dist kvstore sums every "
        "array with one all_reduce, which NCCL and gloo run as "
        "reduce-scatter + all-gather where that pays."),
    "MXNET_ELASTIC_HEARTBEAT_S": (
        "2", "Heartbeat interval (seconds) of resilience.heartbeat."),
    "MXNET_ELASTIC_HEARTBEAT_DIR": (
        None,
        "Directory of per-rank heartbeat files (hb-rank<R>.json, atomic "
        "rewrites); the router injects one; unset = heartbeats off."),
    "MXNET_ELASTIC_INCARNATION": (
        "0", "Incarnation counter a heartbeat record carries."),
    "MXNET_ROUTER_QUEUE": (
        "64",
        "Admission bound on requests outstanding in the router (waiting "
        "+ dispatched, unfinished); submits beyond it raise "
        "RouterOverloaded at once."),
    "MXNET_ROUTER_HEDGE_S": (
        "0",
        "A dispatched request unfinished after this many seconds is "
        "duplicated to a second replica; the first completion wins and "
        "the loser is cancelled. 0 (default) disables hedging."),
    "MXNET_ROUTER_MAX_RETRIES": (
        "2",
        "Times the router resubmits one request to a surviving replica "
        "after the replica serving it died; beyond it the handle fails "
        "with ReplicaDeadError."),
    "MXNET_ROUTER_MAX_RESPAWNS": (
        "8",
        "Per-replica respawn budget; beyond it the replica stays down and "
        "the tier serves on the survivors."),
    "MXNET_ROUTER_HANG_S": (
        "20",
        "Replica heartbeat staleness after which the router SIGKILLs it, "
        "resubmits its requests and respawns it. 0 disables it."),
    "MXNET_ROUTER_PING_S": (
        "1",
        "Interval at which the router pings each replica for its load."),
    "MXNET_ROUTER_AFFINITY_TOKENS": (
        "16",
        "Prompt-prefix length (tokens) hashed for the router's prefix-"
        "affinity hint: least-loaded ties prefer the replica that last "
        "served the same prefix. 0 disables the hint."),
    "MXNET_ROUTER_DIR": (
        None,
        "Router tier working directory (written by the router into each "
        "replica's env): port files, state journal, heartbeats, logs."),
    "MXNET_ROUTER_INDEX": (
        None, "This replica's index in the router tier (written by the "
              "router; mirrored into MXNET_DIST_RANK)."),
}


def get(name, default=None):
    """String value of an env var, with catalog defaults."""
    if name in os.environ:
        return os.environ[name]
    if name in KNOWN_VARS:
        return KNOWN_VARS[name][0]
    return default


def _typed(name, default, caster):
    v = get(name)
    if v is None:
        return default
    try:
        return caster(v)
    except (TypeError, ValueError):
        return default


def get_int(name, default=0):
    return _typed(name, default, int)


def get_float(name, default=0.0):
    return _typed(name, default, float)


def get_bool(name, default=False):
    v = get(name)
    if v is None:
        return default
    return str(v).lower() in ("1", "true", "yes", "on")


def describe():
    """The catalog as rows (name, current, default, help)."""
    return [(name, get(name), default, doc)
            for name, (default, doc) in sorted(KNOWN_VARS.items())]
