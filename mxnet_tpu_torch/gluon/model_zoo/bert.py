"""BERT-style transformer encoder as Gluon HybridBlocks — the port of
``mxnet_tpu/gluon/model_zoo/bert.py`` (``BERTEncoderCell``,
``BERTEncoder``, ``BERTModel``, ``bert_model``) with the reference's
prefixes, so ``collect_params()`` gives the reference's names.

Same structure and layout contracts as the reference: time-major (L, B, C)
through the encoder cells, q/k/v interleaved per head in one ``attn_qkv``
projection attended by ``F.contrib.masked_selfatt`` (the hand-written flash
kernels at flash-eligible lengths on the card), post-norm blocks with
LayerNorm eps 1e-5, exact (erf) GELU unless ``MXNET_GELU_TANH=1``, a tanh
pooler over the first token and an untied MLM decoder.  Dropout reads
``autograd.is_training()`` and draws from the device's generator.
"""

from __future__ import annotations

import torch

from ...base import MXNetError
from ...context import context_of, resolve_device
from ... import initializer
from ..block import HybridBlock
from ..nn import Dense, Dropout, Embedding, LayerNorm

__all__ = ["BERTEncoderCell", "BERTEncoder", "BERTModel", "bert_model",
           "BERT_CONFIGS", "apply_tp_shardings"]

# name -> (num_layers, units, hidden, heads)
BERT_CONFIGS = {
    "bert_12_768_12": (12, 768, 3072, 12),
    "bert_24_1024_16": (24, 1024, 4096, 16),
    "bert_6_512_8": (6, 512, 2048, 8),
    "bert_3_128_2": (3, 128, 512, 2),   # tiny (tests)
}


class BERTEncoderCell(HybridBlock):
    """One post-norm transformer encoder block over the fused attention
    op."""

    def __init__(self, units=768, hidden_size=3072, num_heads=12,
                 dropout=0.1, **kwargs):
        super().__init__(**kwargs)
        self._units = units
        self._num_heads = num_heads
        with self.name_scope():
            self.attn_qkv = Dense(3 * units, flatten=False, in_units=units,
                                  prefix="attn_qkv_")
            self.attn_proj = Dense(units, flatten=False, in_units=units,
                                   prefix="attn_proj_")
            self.ffn_1 = Dense(hidden_size, flatten=False, in_units=units,
                               prefix="ffn1_")
            self.ffn_2 = Dense(units, flatten=False, in_units=hidden_size,
                               prefix="ffn2_")
            self.layer_norm_att = LayerNorm(in_channels=units, prefix="ln1_")
            self.layer_norm_ffn = LayerNorm(in_channels=units, prefix="ln2_")
            self.drop = Dropout(dropout)

    def hybrid_forward(self, F, x, valid_length=None):
        # x: (L, B, C) time-major; valid_length (B,): padded positions
        # neither attend nor are attended to (None: all valid)
        ctx_vec = F.contrib.masked_selfatt(self.attn_qkv(x), valid_length,
                                           heads=self._num_heads)
        out = self.layer_norm_att(x + self.drop(self.attn_proj(ctx_vec)))
        h = self.ffn_2(F.gelu(self.ffn_1(out)))
        return self.layer_norm_ffn(out + self.drop(h))


class BERTEncoder(HybridBlock):
    def __init__(self, num_layers=12, units=768, hidden_size=3072,
                 num_heads=12, dropout=0.1, **kwargs):
        super().__init__(**kwargs)
        self.cells = []
        with self.name_scope():
            for i in range(num_layers):
                cell = BERTEncoderCell(units, hidden_size, num_heads, dropout,
                                       prefix=f"layer{i}_")
                self.register_child(cell, f"layer{i}")
                self.cells.append(cell)

    def hybrid_forward(self, F, x, valid_length=None):  # noqa: ARG002
        for cell in self.cells:
            x = cell(x) if valid_length is None else cell(x, valid_length)
        return x


class BERTModel(HybridBlock):
    """Embeddings + encoder + pooler + MLM decoder.

    ``forward(tokens)`` or ``forward(tokens, valid_length)`` (batch-major
    (B, L) integer tokens; (B,) lengths, padded positions masked out of
    attention) returns ``(sequence_output (B, L, C), pooled (B, C),
    mlm_logits (B, L, V))``."""

    def __init__(self, vocab_size=30522, num_layers=12, units=768,
                 hidden_size=3072, num_heads=12, max_length=512,
                 dropout=0.1, **kwargs):
        super().__init__(**kwargs)
        self._units = units
        self._max_length = max_length
        with self.name_scope():
            self.word_embed = Embedding(vocab_size, units, prefix="word_")
            self.position_weight = self.params.get(
                "position_weight", shape=(max_length, units), init=None)
            self.embed_norm = LayerNorm(in_channels=units, prefix="embln_")
            self.embed_drop = Dropout(dropout)
            self.encoder = BERTEncoder(num_layers, units, hidden_size,
                                       num_heads, dropout, prefix="enc_")
            self.pooler = Dense(units, flatten=False, in_units=units,
                                activation="tanh", prefix="pooler_")
            self.decoder = Dense(vocab_size, flatten=False, in_units=units,
                                 prefix="decoder_")

    def hybrid_forward(self, F, tokens, valid_length=None,
                       position_weight=None):
        seq_len = tokens.shape[1]
        x = self.word_embed(tokens)
        pos = F.slice_axis(position_weight, axis=0, begin=0, end=seq_len)
        x = x + F.expand_dims(pos, axis=0)
        x = self.embed_drop(self.embed_norm(x))
        x = F.transpose(x, axes=(1, 0, 2))       # (B, L, C) -> (L, B, C)
        x = self.encoder(x, valid_length) if valid_length is not None \
            else self.encoder(x)
        x = F.transpose(x, axes=(1, 0, 2))       # back to (B, L, C)
        first = F.reshape(F.slice_axis(x, axis=1, begin=0, end=1),
                          shape=(0, -1))
        return x, self.pooler(first), self.decoder(x)


def bert_model(name="bert_12_768_12", vocab_size=30522, max_length=512,
               dropout=0.1, device=None, dtype=torch.float32, generator=None,
               init_std=0.02):
    """A zoo BERT (parameters named under ``bert_``) on ``device`` (the
    current context when None: the CUDA card unless ``with mx.cpu():``) in
    ``dtype``, its weights and position table Normal(0, ``init_std``) from
    ``generator`` (seeded by the caller, on the device), biases and
    LayerNorm beta 0, gamma 1."""
    if name not in BERT_CONFIGS:
        raise MXNetError(f"unknown BERT config {name!r}; known "
                         f"{sorted(BERT_CONFIGS)}")
    L, U, H, A = BERT_CONFIGS[name]
    net = BERTModel(vocab_size=vocab_size, num_layers=L, units=U,
                    hidden_size=H, num_heads=A, max_length=max_length,
                    dropout=dropout, prefix="bert_")
    net.initialize(initializer.Zero(), ctx=context_of(resolve_device(device)))
    if dtype != torch.float32:
        net.cast(dtype)
    return initializer.init_weights(net, generator, init_std)


def apply_tp_shardings(model, axis="tp"):
    """Annotate megatron-style tensor-parallel shardings on a BERTModel —
    delegates to the declarative rule pack (``sharding.bert_rules``):
    attn qkv + ffn_1 column-parallel, attn proj + ffn_2 row-parallel,
    word/decoder tables over the vocab dim.  Dense weights are
    (out_features, in_features).  A sharded ``parallel.TrainStep`` gathers
    these weights at use: a contiguous row chunk of the fused qkv weight
    mixes q, k and v, so the encoder computes the dense math."""
    from ... import sharding as _sh
    _sh.apply_rules(model, _sh.bert_rules(tp=axis))
    return model
