"""BERT-style transformer encoder as ``torch.nn.Module``s — the port of
``mxnet_tpu/gluon/model_zoo/bert.py``.

Same structure and layout contracts as the reference: time-major (L, B, C)
through the encoder cells, q/k/v interleaved per head in one ``attn_qkv``
projection and attended by the port's ``ops.contrib.masked_selfatt`` (the
flash kernels at flash-eligible lengths on the card), post-norm blocks with
LayerNorm eps 1e-5, exact (erf) GELU unless ``MXNET_GELU_TANH=1``, a tanh
pooler over the first token and an untied MLM decoder.  Dense weights are
(out_features, in_features), as in the reference.  Dropout draws from an
explicit ``torch.Generator``; ``train()``/``eval()`` stand in for the
reference's autograd training scope.
"""

from __future__ import annotations

import torch
from torch import nn

from ...base import MXNetError
from ...context import resolve_device
from ...initializer import init_weights
from ...ops.contrib import masked_selfatt
from ...ops.elemwise import gelu
from ...ops.nn import dropout, layer_norm

__all__ = ["BERTEncoderCell", "BERTEncoder", "BERTModel", "bert_model",
           "BERT_CONFIGS"]

# name -> (num_layers, units, hidden, heads)
BERT_CONFIGS = {
    "bert_12_768_12": (12, 768, 3072, 12),
    "bert_24_1024_16": (24, 1024, 4096, 16),
    "bert_6_512_8": (6, 512, 2048, 8),
    "bert_3_128_2": (3, 128, 512, 2),   # tiny (tests)
}


class LayerNorm(nn.Module):
    """LayerNorm over the last axis with the reference's parameter names
    (``gamma``, ``beta``)."""

    def __init__(self, units, eps=1e-5, device=None, dtype=torch.float32):
        super().__init__()
        self.eps = eps
        self.gamma = nn.Parameter(torch.ones(units, device=device,
                                             dtype=dtype))
        self.beta = nn.Parameter(torch.zeros(units, device=device,
                                             dtype=dtype))

    def forward(self, x):
        return layer_norm(x, self.gamma, self.beta, self.eps)


class Dropout(nn.Module):
    """Dropout with rate ``rate`` while training, drawing its mask from
    ``generator`` (the torch default when None)."""

    def __init__(self, rate, generator=None):
        super().__init__()
        self.rate = rate
        self.generator = generator

    def forward(self, x):
        return dropout(x, self.rate, self.training, self.generator)


def _dense(units_in, units_out, device, dtype):
    return nn.Linear(units_in, units_out, device=device, dtype=dtype)


class BERTEncoderCell(nn.Module):
    """One post-norm transformer encoder block over the fused attention
    op."""

    def __init__(self, units=768, hidden_size=3072, num_heads=12,
                 dropout=0.1, generator=None, device=None,
                 dtype=torch.float32):
        super().__init__()
        self.num_heads = num_heads
        self.attn_qkv = _dense(units, 3 * units, device, dtype)
        self.attn_proj = _dense(units, units, device, dtype)
        self.ffn_1 = _dense(units, hidden_size, device, dtype)
        self.ffn_2 = _dense(hidden_size, units, device, dtype)
        self.layer_norm_att = LayerNorm(units, device=device, dtype=dtype)
        self.layer_norm_ffn = LayerNorm(units, device=device, dtype=dtype)
        self.drop = Dropout(dropout, generator)

    def forward(self, x, valid_length=None):
        # x: (L, B, C) time-major; valid_length (B,) or None (all valid)
        ctx_vec = masked_selfatt(self.attn_qkv(x), valid_length,
                                 heads=self.num_heads)
        out = self.layer_norm_att(x + self.drop(self.attn_proj(ctx_vec)))
        h = self.ffn_2(gelu(self.ffn_1(out)))
        return self.layer_norm_ffn(out + self.drop(h))


class BERTEncoder(nn.Module):
    def __init__(self, num_layers=12, units=768, hidden_size=3072,
                 num_heads=12, dropout=0.1, generator=None, device=None,
                 dtype=torch.float32):
        super().__init__()
        self.cells = nn.ModuleList(
            BERTEncoderCell(units, hidden_size, num_heads, dropout,
                            generator, device, dtype)
            for _ in range(num_layers))

    def forward(self, x, valid_length=None):
        for cell in self.cells:
            x = cell(x, valid_length)
        return x


class BERTModel(nn.Module):
    """Embeddings + encoder + pooler + MLM decoder.

    ``forward(tokens, valid_length=None)`` takes batch-major (B, L) integer
    tokens and optional (B,) lengths (padded positions neither attend nor
    are attended to) and returns ``(sequence_output (B, L, C), pooled
    (B, C), mlm_logits (B, L, V))``."""

    def __init__(self, vocab_size=30522, num_layers=12, units=768,
                 hidden_size=3072, num_heads=12, max_length=512,
                 dropout=0.1, dropout_generator=None, device=None,
                 dtype=torch.float32):
        super().__init__()
        self.word_embed = nn.Embedding(vocab_size, units, device=device,
                                       dtype=dtype)
        self.position_weight = nn.Parameter(
            torch.zeros(max_length, units, device=device, dtype=dtype))
        self.embed_norm = LayerNorm(units, device=device, dtype=dtype)
        self.embed_drop = Dropout(dropout, dropout_generator)
        self.encoder = BERTEncoder(num_layers, units, hidden_size, num_heads,
                                   dropout, dropout_generator, device, dtype)
        self.pooler = _dense(units, units, device, dtype)
        self.decoder = _dense(units, vocab_size, device, dtype)

    def init_weights(self, generator=None, std=0.02):
        """Normal(0, std) weights and position table, zero biases and
        LayerNorm beta, unit gamma — drawn from ``generator`` (which must
        live on the parameters' device)."""
        return init_weights(self, generator, std)

    def forward(self, tokens, valid_length=None):
        seq_len = tokens.shape[1]
        x = self.word_embed(tokens.long()) + self.position_weight[:seq_len]
        x = self.embed_drop(self.embed_norm(x))
        x = self.encoder(x.transpose(0, 1), valid_length).transpose(0, 1)
        pooled = torch.tanh(self.pooler(x[:, 0]))
        return x, pooled, self.decoder(x)


def _build(name, vocab_size, max_length, dropout, dropout_generator, device,
           dtype):
    if name not in BERT_CONFIGS:
        raise MXNetError(f"unknown BERT config {name!r}; known "
                         f"{sorted(BERT_CONFIGS)}")
    L, U, H, A = BERT_CONFIGS[name]
    with torch.device("meta"):
        model = BERTModel(vocab_size=vocab_size, num_layers=L, units=U,
                          hidden_size=H, num_heads=A, max_length=max_length,
                          dropout=dropout, dropout_generator=dropout_generator,
                          dtype=dtype)
    return model.to_empty(device=device)


def bert_model(name="bert_12_768_12", vocab_size=30522, max_length=512,
               dropout=0.1, device=None, dtype=torch.float32, generator=None,
               init_std=0.02, dropout_generator=None):
    """A zoo BERT with random weights: Normal(0, ``init_std``) from
    ``generator`` (seeded by the caller; it must live on ``device``).
    ``device=None`` is the CUDA card."""
    model = _build(name, vocab_size, max_length, dropout, dropout_generator,
                   resolve_device(device), dtype)
    model.init_weights(generator, init_std)
    return model
