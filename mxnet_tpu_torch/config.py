"""Environment knobs the port reads — its own small copy of the entries of
``mxnet_tpu/config.py`` that the serving and training slices use (same
names, same defaults, same typed accessors)."""

from __future__ import annotations

import os

__all__ = ["get", "get_int", "get_float", "KNOWN_VARS"]

# name -> (default, help)
KNOWN_VARS = {
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
