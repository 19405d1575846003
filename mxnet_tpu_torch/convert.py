"""Carries weights of a ``mxnet_tpu`` zoo model across to the port.

The reference exports a Gluon net as ``{name: p.data().asnumpy()}`` over
``net.collect_params()``.  The port's Gluon BERT and ResNets are Blocks
with the reference's prefixes, so :func:`bert_from_gluon` and
:func:`resnet_from_gluon` load by those names over their own
``collect_params()`` (:func:`load_by_name`; a ResNet's BatchNorm running
statistics are parameters, so they come along).  The same function
carries any Gluon net built alike in both packages: a ``gluon.rnn``
layer's per-layer Parameters, or a tied language model, whose shared
weight is one name of ``collect_params()``.  The llama is a Gluon block
too: :func:`llama_from_gluon` builds the zoo llama under the reference
net's prefix and loads by name.

Every expected name must be present with the expected shape,
and no other name may be left over.  Dense weights are (out, in) on both
sides, so nothing is transposed.
"""

from __future__ import annotations

import numpy as np
import torch

from .base import MXNetError
from .context import resolve_device
from .gluon.model_zoo import bert as _bert
from .gluon.model_zoo import vision as _vision
from .gluon.model_zoo import llama as _llama

__all__ = ["llama_from_gluon", "bert_from_gluon", "resnet_from_gluon",
           "load_by_name"]


def _check_names(params, shapes, what):
    """Every name of ``shapes`` (name -> shape, 0 for a dim not known yet)
    in ``params`` (name -> numpy) with that shape, and no other."""
    extra = sorted(set(params) - set(shapes))
    missing = sorted(set(shapes) - set(params))
    if extra or missing:
        raise MXNetError(f"{what}: missing {missing}, unexpected {extra}")
    for name, shape in shapes.items():
        got = tuple(np.shape(params[name]))
        if len(got) != len(shape) or any(s not in (0, g)
                                          for g, s in zip(got, shape)):
            raise MXNetError(f"{name}: shape {got} != {tuple(shape)}")


def _required(params, name):
    arr = params.get(name)
    if arr is None:
        raise MXNetError(f"no {name} in the exported params")
    return arr


def llama_from_gluon(params, prefix="llm_", config="llama_tiny", device=None,
                     dtype=torch.float32):
    """Build the port's Gluon zoo llama ``config`` under ``prefix``
    holding the reference net's weights ``params`` (name -> numpy array),
    loaded by name over ``collect_params()``."""
    if config not in _llama.LLAMA_CONFIGS:
        raise MXNetError(
            f"unknown llama config {config!r}; options "
            f"{sorted(_llama.LLAMA_CONFIGS)}")
    tok = _required(params, f"{prefix}tok_weight")
    net = _llama.llama_model(config, vocab_size=int(tok.shape[0]),
                             prefix=prefix)
    return load_by_name(net, params, "llama_from_gluon", device, dtype)


def bert_from_gluon(params, prefix="bert_", config="bert_3_128_2",
                    device=None, dtype=torch.float32):
    """Build the port's Gluon ``BERTModel`` for zoo ``config`` (dropout 0,
    names under ``prefix``) holding the reference net's weights ``params``
    (name -> numpy array), loaded by name over ``collect_params()``."""
    if config not in _bert.BERT_CONFIGS:
        raise MXNetError(f"unknown BERT config {config!r}; options "
                         f"{sorted(_bert.BERT_CONFIGS)}")
    word = _required(params, f"{prefix}word_weight")
    pos = _required(params, f"{prefix}position_weight")
    L, U, H, A = _bert.BERT_CONFIGS[config]
    net = _bert.BERTModel(vocab_size=int(word.shape[0]), num_layers=L,
                          units=U, hidden_size=H, num_heads=A,
                          max_length=int(pos.shape[0]), dropout=0.0,
                          prefix=prefix)
    return load_by_name(net, params, "bert_from_gluon", device, dtype)


def load_by_name(net, params, what="load_by_name", device=None,
                 dtype=torch.float32):
    """Set every parameter of the Gluon ``net`` (not yet initialized, or
    with deferred shapes) from ``params`` (the reference's ``collect_params``
    name -> numpy array) as float32 on ``device``, then cast to ``dtype``.
    Every name must be present in both with a matching shape."""
    own = net.collect_params()
    _check_names(params, {k: p.shape or () for k, p in own.items()}, what)
    dev = resolve_device(device)
    for name, p in own.items():
        p.set_data(torch.from_numpy(np.array(params[name], np.float32))
                   .to(dev))
    if dtype != torch.float32:
        net.cast(dtype)
    return net


def resnet_from_gluon(params, name="resnet50_v1", classes=1000,
                      thumbnail=False, device=None, dtype=torch.float32):
    """Build the port's zoo ResNet ``name`` (``get_model``'s names) holding
    the reference net's weights and running statistics ``params`` (name ->
    numpy array), loaded by name over ``collect_params()``; deferred
    shapes take the file's."""
    net = _vision.get_model(name, classes=classes, thumbnail=thumbnail)
    return load_by_name(net, params, "resnet_from_gluon", device, dtype)
