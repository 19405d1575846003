"""Automatic mixed precision — the port of ``mxnet_tpu/amp.py``.

The reference's design, not ``torch.autocast`` (whose op lists differ):
``init()`` installs a cast hook at the single dispatch chokepoint
(``ops/registry.py``), which both ``mx.nd`` and a hybridized block's
tensor ops pass through.  Per op, by name:

- float inputs wider than 16 bits of the matmul/conv ops (``TARGET_OPS``)
  are cast to the target dtype;
- 16-bit float inputs of numerically sensitive ops (``FP32_OPS``) are cast
  up to float32;
- when the float inputs of a multi-input op (``WIDEST_OPS``) differ in
  dtype, all are cast to the widest (``amp_multicast``).

The three lists are the reference's, name for name, so the casts match it
op for op.  Each ``init``/``off`` bumps the registry's dispatch epoch, on
which ``parallel.TrainStep`` drops its captured graphs.

The reference lets matmuls of float32 inputs run at the backend's default
precision under amp (``jax_default_matmul_precision="default"``); the
twin here is TF32 for float32 matmuls and convolutions
(``torch.backends.cuda.matmul.allow_tf32`` and
``torch.backends.cudnn.allow_tf32``), which the port keeps off otherwise.
``off()`` puts both back as ``init`` found them, so exact float32 work
after it runs without TF32 again.

bfloat16 (the default target) needs no loss scaling; ``float16`` runs the
reference's dynamic scaling (``LossScaler``: halve on overflow, double
after ``scale_window`` clean steps), attached to a ``gluon.Trainer`` by
``init_trainer`` and used through ``scale_loss``/``unscale``, and
``Trainer.step`` skips the update of a step whose gradients overflowed.
``convert_model`` casts a symbolic checkpoint's parameter dicts
(``mx.sym``); its graph then runs under the same cast hook.
"""

from __future__ import annotations

import contextlib

import torch

from .base import MXNetError, torch_dtype
from .ops import registry

__all__ = ["init", "off", "init_trainer", "scale_loss", "unscale",
           "LossScaler", "convert_model", "convert_hybrid_block",
           "list_lp16_ops", "list_fp32_ops", "list_widest_ops"]

# the reference's lists (mxnet_tpu/amp.py), name for name
TARGET_OPS = {
    "dot", "batch_dot", "matmul", "einsum",
    "FullyConnected", "Convolution", "Deconvolution", "RNN",
    "contrib.interleaved_matmul_selfatt_qk",
    "contrib.interleaved_matmul_selfatt_valatt",
    "contrib.interleaved_matmul_encdec_qk",
    "contrib.interleaved_matmul_encdec_valatt",
    "contrib.masked_selfatt",
}

FP32_OPS = {
    "softmax", "log_softmax", "softmin", "SoftmaxActivation", "SoftmaxOutput",
    "softmax_cross_entropy", "gumbel_softmax",
    "BatchNorm", "LayerNorm", "GroupNorm", "InstanceNorm", "L2Normalization",
    "LRN", "norm", "linalg.norm", "mean", "sum", "sum_axis", "nansum",
    "logsumexp", "cumsum",
    "exp", "expm1", "log", "log1p", "log2", "log10",
    "erf", "erfinv", "rsqrt", "sqrt", "square",
    "linalg.slogdet", "linalg.sumlogdiag",
}

WIDEST_OPS = {
    "elemwise_add", "elemwise_sub", "elemwise_mul", "elemwise_div",
    "broadcast_add", "broadcast_sub", "broadcast_mul", "broadcast_div",
    "add_n", "concat", "stack", "where",
}


def list_lp16_ops():
    """The ops cast to the low-precision target."""
    return sorted(TARGET_OPS)


def list_fp32_ops():
    return sorted(FP32_OPS)


def list_widest_ops():
    return sorted(WIDEST_OPS)


class _AmpState:
    def __init__(self):
        self.active = False
        self.target_dtype = None
        self.target_ops = frozenset()
        self.fp32_ops = frozenset()
        self.widest_ops = frozenset()
        self.tf32 = None        # (matmul, cudnn) allow_tf32 before init


_state = _AmpState()


def _is_float(t):
    return isinstance(t, torch.Tensor) and t.is_floating_point()


# inputs that carry integers (lengths) as floats: never narrowed, since a
# 16-bit float holds integers exactly only up to 256 (bf16) or 2048 (fp16);
# the reference narrows them (ROADMAP C.7)
_INTEGER_INPUTS = {"contrib.masked_selfatt": frozenset({1})}


def _cast_hook(op_name, tensors):
    """The dispatch hook: ``tensors`` cast as the op's list says."""
    st = _state
    if op_name in st.target_ops:
        keep = _INTEGER_INPUTS.get(op_name, ())
        return [t.to(st.target_dtype)
                if _is_float(t) and t.itemsize > 2 and i not in keep else t
                for i, t in enumerate(tensors)]
    if op_name in st.fp32_ops:
        return [t.float() if _is_float(t) and t.itemsize < 4 else t
                for t in tensors]
    if op_name in st.widest_ops:
        dts = [t.dtype for t in tensors if _is_float(t)]
        if len(set(dts)) > 1:
            widest = max(dts, key=lambda d: d.itemsize)
            return [t.to(widest) if _is_float(t) else t for t in tensors]
    return tensors


def _target(target_dtype):
    name = str(torch_dtype(target_dtype)).replace("torch.", "")
    if name not in ("bfloat16", "float16"):
        raise MXNetError(f"amp target_dtype must be bfloat16 or float16, got "
                         f"{target_dtype!r}")
    return torch_dtype(name)


def init(target_dtype="bfloat16", target_precision_ops=None,
         conditional_fp32_ops=None, fp32_ops=None):
    """Turn amp on for the process (the reference's ``amp.init``).

    target_dtype : ``"bfloat16"`` (default) or ``"float16"``.
    target_precision_ops : more op names to run in the target dtype.
    conditional_fp32_ops / fp32_ops : more op names forced to float32 (the
        reference's ``(op, attr, values)`` triples count by their op name).
    """
    st = _state
    st.target_dtype = _target(target_dtype)
    st.target_ops = frozenset(TARGET_OPS) | frozenset(
        target_precision_ops or ())
    extra = set(fp32_ops or ())
    for item in conditional_fp32_ops or ():
        extra.add(item[0] if isinstance(item, (tuple, list)) else item)
    st.fp32_ops = (frozenset(FP32_OPS) | extra) - st.target_ops
    st.widest_ops = frozenset(WIDEST_OPS) - st.target_ops - st.fp32_ops
    if st.tf32 is None:
        st.tf32 = (torch.backends.cuda.matmul.allow_tf32,
                   torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    st.active = True
    registry.set_dispatch_cast_hook(_cast_hook)


def off():
    """Turn amp off: dispatch without casts, TF32 as ``init`` found it."""
    st = _state
    st.active = False
    if st.tf32 is not None:
        torch.backends.cuda.matmul.allow_tf32, \
            torch.backends.cudnn.allow_tf32 = st.tf32
        st.tf32 = None
    registry.set_dispatch_cast_hook(None)


class LossScaler:
    """Dynamic loss scaler (the reference's ``LossScaler``).

    bfloat16 needs no scaling: ``loss_scale`` stays 1 and ``has_overflow``
    still guards against non-finite gradients.  float16 starts at 2^16,
    halves on overflow (not below 1) and doubles after ``scale_window``
    clean steps."""

    def __init__(self, init_scale=None, scale_factor=2.0, scale_window=2000,
                 target_dtype="float16"):
        self._dynamic = str(target_dtype) in ("float16", "torch.float16")
        if init_scale is None:
            init_scale = 2.0 ** 16 if self._dynamic else 1.0
        self.loss_scale = float(init_scale)
        self._scale_factor = float(scale_factor)
        self._scale_window = int(scale_window)
        self._unskipped = 0

    def has_overflow(self, grad_arrays):
        """Whether any gradient holds a non-finite value; updates the
        scale.  One read to the host for all of them."""
        bad = None
        for g in grad_arrays:
            t = getattr(g, "_data", g)
            if not t.is_floating_point():
                continue
            n = (~torch.isfinite(t)).sum()
            bad = n if bad is None else bad + n.to(bad.device)
        if bad is not None and bool(bad > 0):
            if self._dynamic:
                self.loss_scale = max(self.loss_scale / self._scale_factor,
                                      1.0)
            self._unskipped = 0
            return True
        self._unskipped += 1
        if self._dynamic and self._unskipped >= self._scale_window:
            self.loss_scale *= self._scale_factor
            self._unskipped = 0
        return False


def init_trainer(trainer):
    """Attach a ``LossScaler`` to a ``gluon.Trainer``."""
    if not _state.active:
        raise MXNetError("call amp.init() before amp.init_trainer()")
    trainer._amp_loss_scaler = LossScaler(
        target_dtype=str(_state.target_dtype).replace("torch.", ""))
    trainer._amp_original_scale = trainer._scale


@contextlib.contextmanager
def scale_loss(loss, trainer):
    """``with amp.scale_loss(loss, trainer) as scaled: scaled.backward()``:
    the loss times the current scale, whose inverse the trainer's
    gradient rescale takes, so ``trainer.step`` sees unscaled gradients."""
    scaler = getattr(trainer, "_amp_loss_scaler", None)
    trainer._amp_grads_unscaled = False
    if scaler is None or scaler.loss_scale == 1.0:
        yield loss
        return
    s = scaler.loss_scale
    trainer._scale = trainer._amp_original_scale / s
    if isinstance(loss, (list, tuple)):
        yield [l * s for l in loss]
    else:
        yield loss * s


def unscale(trainer):
    """Divide the gradients by the loss scale in place (to clip them
    between ``backward()`` and ``step()``)."""
    scaler = getattr(trainer, "_amp_loss_scaler", None)
    if scaler is None or scaler.loss_scale == 1.0:
        return
    inv = 1.0 / scaler.loss_scale
    for p in trainer._params:
        if p.grad_req == "null":
            continue
        for g in p.list_grad():
            g *= inv
    trainer._scale = trainer._amp_original_scale
    trainer._amp_grads_unscaled = True


_KEEP_FP32_PARAM_MARKERS = ("gamma", "beta", "running_mean", "running_var",
                            "moving_mean", "moving_var")


def convert_hybrid_block(block, target_dtype="bfloat16",
                         cast_optional_params=False):
    """Cast a block's float parameters to ``target_dtype`` for
    low-precision inference, but for the norm layers' statistics and
    affine parameters (kept float32 unless ``cast_optional_params``).
    Returns ``block``."""
    tgt = _target(target_dtype)
    for name, p in block.collect_params().items():
        if p._data is None:
            continue
        if not cast_optional_params and any(
                m in name for m in _KEEP_FP32_PARAM_MARKERS):
            continue
        if p._data._data.is_floating_point():
            p.cast(tgt)
    return block


def convert_model(sym, arg_params, aux_params, target_dtype="bfloat16",
                  target_dtype_ops=None, fp32_ops=None,
                  conditional_fp32_ops=None, excluded_sym_names=()):
    """Symbolic-graph conversion: ``(sym, arg_params, aux_params)`` with
    the float parameters cast to ``target_dtype``, but for those named in
    ``excluded_sym_names`` and the norm layers' (kept float32).  The graph
    needs no rewrite: the executor's ops go through the same cast hook
    (``amp.init``).  The op lists are accepted and have no effect, as in
    the reference."""
    del target_dtype_ops, fp32_ops, conditional_fp32_ops
    tgt = _target(target_dtype)
    excluded = set(excluded_sym_names)

    def conv(d):
        out = {}
        for k, v in d.items():
            if k not in excluded and v._data.is_floating_point() \
                    and not any(m in k for m in _KEEP_FP32_PARAM_MARKERS):
                out[k] = v.astype(tgt)
            else:
                out[k] = v
        return out

    return sym, conv(arg_params), conv(aux_params)
