"""Environment knobs the port reads — its own small copy of the entries of
``mxnet_tpu/config.py`` that the port reads (same
names, same defaults, same typed accessors)."""

from __future__ import annotations

import os

__all__ = ["get", "get_int", "get_float", "KNOWN_VARS"]

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
