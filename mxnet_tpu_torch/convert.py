"""Carries weights of a ``mxnet_tpu`` zoo model across to the port.

The reference exports a Gluon net as ``{name: p.data().asnumpy()}`` (over
``net.collect_params()``); this module maps those names onto the port's
``nn.Module`` parameters.  For a llama built with ``prefix="llm_"``::

    llm_tok_weight                          -> embed.weight
    llm_layer{i}_{q,k,v,o}_weight           -> blocks.{i}.{q,k,v,o}_proj.weight
    llm_layer{i}_{gate,up,down}_weight      -> blocks.{i}.{gate,up,down}.weight
    llm_layer{i}_{attn,mlp}_norm_weight     -> blocks.{i}.{attn,mlp}_norm.weight
    llm_final_norm_weight                   -> norm.weight
    llm_lm_head_weight                      -> lm_head.weight

Dense weights are (out, in) on both sides, so nothing is transposed.
"""

from __future__ import annotations

import numpy as np
import torch

from .base import MXNetError
from .context import resolve_device
from .gluon.model_zoo.llama import LLAMA_CONFIGS, _build

__all__ = ["llama_from_gluon"]


def _param_names(prefix, num_layers):
    """Gluon name -> port parameter name for a llama of ``num_layers``."""
    names = {f"{prefix}tok_weight": "embed.weight",
             f"{prefix}final_norm_weight": "norm.weight",
             f"{prefix}lm_head_weight": "lm_head.weight"}
    for i in range(num_layers):
        g, t = f"{prefix}layer{i}_", f"blocks.{i}."
        for w in ("q", "k", "v", "o"):
            names[f"{g}{w}_weight"] = f"{t}{w}_proj.weight"
        for w in ("gate", "up", "down", "attn_norm", "mlp_norm"):
            names[f"{g}{w}_weight"] = f"{t}{w}.weight"
    return names


def llama_from_gluon(params, prefix="llm_", config="llama_tiny", device=None,
                     dtype=torch.float32):
    """Build the port's ``LlamaModel`` for zoo ``config`` holding the
    reference net's weights ``params`` (name -> numpy array).  Every
    expected name must be present with the expected shape, and no other
    name may be left over."""
    if config not in LLAMA_CONFIGS:
        raise MXNetError(
            f"unknown llama config {config!r}; options "
            f"{sorted(LLAMA_CONFIGS)}")
    tok = params.get(f"{prefix}tok_weight")
    if tok is None:
        raise MXNetError(f"no {prefix}tok_weight in the exported params")
    model = _build(config, int(tok.shape[0]), resolve_device(device), dtype)
    names = _param_names(prefix, LLAMA_CONFIGS[config][0])
    extra = sorted(set(params) - set(names))
    missing = sorted(set(names) - set(params))
    if extra or missing:
        raise MXNetError(f"llama_from_gluon: missing {missing}, "
                         f"unexpected {extra}")
    own = dict(model.named_parameters())
    with torch.no_grad():
        for gname, tname in names.items():
            src = np.asarray(params[gname], dtype=np.float32)
            dst = own[tname]
            if tuple(src.shape) != tuple(dst.shape):
                raise MXNetError(
                    f"{gname}: shape {src.shape} != {tname} "
                    f"{tuple(dst.shape)}")
            dst.copy_(torch.tensor(src))
    return model
