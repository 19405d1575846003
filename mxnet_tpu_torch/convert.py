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

and for a BERT built with ``prefix="bert_"``::

    bert_word_weight                        -> word_embed.weight
    bert_position_weight                    -> position_weight
    bert_embln_{gamma,beta}                 -> embed_norm.{gamma,beta}
    bert_enc_layer{i}_{attn_qkv,attn_proj}_{weight,bias}
        -> encoder.cells.{i}.{attn_qkv,attn_proj}.{weight,bias}
    bert_enc_layer{i}_ffn{1,2}_{weight,bias}
        -> encoder.cells.{i}.ffn_{1,2}.{weight,bias}
    bert_enc_layer{i}_ln{1,2}_{gamma,beta}
        -> encoder.cells.{i}.layer_norm_{att,ffn}.{gamma,beta}
    bert_{pooler,decoder}_{weight,bias}     -> {pooler,decoder}.{weight,bias}

Dense weights are (out, in) on both sides, so nothing is transposed.
"""

from __future__ import annotations

import numpy as np
import torch

from .base import MXNetError
from .context import resolve_device
from .gluon.model_zoo import bert as _bert
from .gluon.model_zoo.llama import LLAMA_CONFIGS, _build

__all__ = ["llama_from_gluon", "bert_from_gluon"]


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


def _load(model, params, names, what):
    """Copy ``params`` (Gluon name -> numpy) into ``model`` by ``names``
    (Gluon name -> port name): every expected name present with the
    expected shape, and no other name left over."""
    extra = sorted(set(params) - set(names))
    missing = sorted(set(names) - set(params))
    if extra or missing:
        raise MXNetError(f"{what}: missing {missing}, unexpected {extra}")
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


def _required(params, name):
    arr = params.get(name)
    if arr is None:
        raise MXNetError(f"no {name} in the exported params")
    return arr


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
    tok = _required(params, f"{prefix}tok_weight")
    model = _build(config, int(tok.shape[0]), resolve_device(device), dtype)
    return _load(model, params, _param_names(prefix, LLAMA_CONFIGS[config][0]),
                 "llama_from_gluon")


def _bert_names(prefix, num_layers):
    """Gluon name -> port parameter name for a BERT of ``num_layers``."""
    names = {f"{prefix}word_weight": "word_embed.weight",
             f"{prefix}position_weight": "position_weight",
             f"{prefix}embln_gamma": "embed_norm.gamma",
             f"{prefix}embln_beta": "embed_norm.beta"}
    for part in ("pooler", "decoder"):
        for w in ("weight", "bias"):
            names[f"{prefix}{part}_{w}"] = f"{part}.{w}"
    for i in range(num_layers):
        g, t = f"{prefix}enc_layer{i}_", f"encoder.cells.{i}."
        for gp, tp in (("attn_qkv", "attn_qkv"), ("attn_proj", "attn_proj"),
                       ("ffn1", "ffn_1"), ("ffn2", "ffn_2")):
            for w in ("weight", "bias"):
                names[f"{g}{gp}_{w}"] = f"{t}{tp}.{w}"
        for gp, tp in (("ln1", "layer_norm_att"), ("ln2", "layer_norm_ffn")):
            for w in ("gamma", "beta"):
                names[f"{g}{gp}_{w}"] = f"{t}{tp}.{w}"
    return names


def bert_from_gluon(params, prefix="bert_", config="bert_3_128_2",
                    device=None, dtype=torch.float32):
    """Build the port's ``BERTModel`` for zoo ``config`` (dropout 0)
    holding the reference net's weights ``params`` (name -> numpy array),
    as strictly as :func:`llama_from_gluon`."""
    if config not in _bert.BERT_CONFIGS:
        raise MXNetError(f"unknown BERT config {config!r}; options "
                         f"{sorted(_bert.BERT_CONFIGS)}")
    word = _required(params, f"{prefix}word_weight")
    pos = _required(params, f"{prefix}position_weight")
    model = _bert._build(config, int(word.shape[0]), int(pos.shape[0]), 0.0,
                         None, resolve_device(device), dtype)
    return _load(model, params,
                 _bert_names(prefix, _bert.BERT_CONFIGS[config][0]),
                 "bert_from_gluon")
