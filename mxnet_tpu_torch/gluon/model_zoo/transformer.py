"""Transformer-base machine translation (encoder-decoder) as Gluon
HybridBlocks — the port of ``mxnet_tpu/gluon/model_zoo/transformer.py``
with the reference's prefixes, so ``collect_params()`` gives its names and
weights carry across by name (``convert.load_by_name``).

Vaswani et al.'s transformer-base: 6 + 6 post-norm layers, d 512, FFN
2048 (ReLU), 8 heads, sinusoidal positions, one (vocab, units) embedding
shared by the source, the target and the output projection.  Time-major
(L, B, C) through the cells, as the fused attention ops want it:
self-attention is ``F.contrib.masked_selfatt`` over an interleaved q/k/v
projection (the decoder's causal), cross-attention
``F.contrib.masked_encdec_att`` over the query and one fused [k, v]
projection of the encoder memory, masked by the source lengths; both run
the hand-written flash kernels at flash-eligible lengths on the card.
Target padding is the loss's business (``LabelSmoothedCELoss`` with
``ignore_index``).

``greedy_decode`` and ``beam_search_decode`` encode the source once and
decode against the cached memory over one fixed (B, max_len) buffer, as
the reference does; the beams are picked on the host in numpy.
"""

from __future__ import annotations

import numpy as np
import torch

from ...ndarray.ndarray import NDArray
from ..block import HybridBlock
from ..nn import Dense, Dropout, LayerNorm

__all__ = ["TransformerEncoderCell", "TransformerDecoderCell",
           "TransformerEncoder", "TransformerDecoder", "TransformerModel",
           "transformer_model", "greedy_decode", "beam_search_decode"]


def _positional_encoding(max_len, units):
    """Sinusoidal position table (max_len, units), float32."""
    pos = np.arange(max_len)[:, None]
    dim = np.arange(0, units, 2)[None, :]
    angle = pos / np.power(10000.0, dim / units)
    enc = np.zeros((max_len, units), np.float32)
    enc[:, 0::2] = np.sin(angle)
    enc[:, 1::2] = np.cos(angle)
    return enc


class TransformerEncoderCell(HybridBlock):
    """Post-norm encoder block over the fused self-attention op."""

    def __init__(self, units=512, hidden_size=2048, num_heads=8,
                 dropout=0.1, **kwargs):
        super().__init__(**kwargs)
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
            self.ln_att = LayerNorm(in_channels=units, prefix="ln1_")
            self.ln_ffn = LayerNorm(in_channels=units, prefix="ln2_")
            self.drop = Dropout(dropout)

    def hybrid_forward(self, F, x, valid_length=None):
        ctx = F.contrib.masked_selfatt(self.attn_qkv(x), valid_length,
                                       heads=self._num_heads)
        out = self.ln_att(x + self.drop(self.attn_proj(ctx)))
        h = self.ffn_2(F.relu(self.ffn_1(out)))
        return self.ln_ffn(out + self.drop(h))


class TransformerDecoderCell(HybridBlock):
    """Post-norm decoder block: causal self-attention, then
    cross-attention over the encoder memory."""

    def __init__(self, units=512, hidden_size=2048, num_heads=8,
                 dropout=0.1, **kwargs):
        super().__init__(**kwargs)
        self._num_heads = num_heads
        with self.name_scope():
            self.attn_qkv = Dense(3 * units, flatten=False, in_units=units,
                                  prefix="self_qkv_")
            self.attn_proj = Dense(units, flatten=False, in_units=units,
                                   prefix="self_proj_")
            self.cross_q = Dense(units, flatten=False, in_units=units,
                                 prefix="cross_q_")
            self.cross_kv = Dense(2 * units, flatten=False, in_units=units,
                                  prefix="cross_kv_")
            self.cross_proj = Dense(units, flatten=False, in_units=units,
                                    prefix="cross_proj_")
            self.ffn_1 = Dense(hidden_size, flatten=False, in_units=units,
                               prefix="ffn1_")
            self.ffn_2 = Dense(units, flatten=False, in_units=hidden_size,
                               prefix="ffn2_")
            self.ln_self = LayerNorm(in_channels=units, prefix="ln1_")
            self.ln_cross = LayerNorm(in_channels=units, prefix="ln2_")
            self.ln_ffn = LayerNorm(in_channels=units, prefix="ln3_")
            self.drop = Dropout(dropout)

    def hybrid_forward(self, F, x, mem, mem_valid_length=None):
        # x (Lt, B, C) the target stream; mem (Ls, B, C) the encoder's
        ctx = F.contrib.masked_selfatt(self.attn_qkv(x), None,
                                       heads=self._num_heads, causal=True)
        out = self.ln_self(x + self.drop(self.attn_proj(ctx)))
        cross = F.contrib.masked_encdec_att(
            self.cross_q(out), self.cross_kv(mem), mem_valid_length,
            heads=self._num_heads)
        out = self.ln_cross(out + self.drop(self.cross_proj(cross)))
        h = self.ffn_2(F.relu(self.ffn_1(out)))
        return self.ln_ffn(out + self.drop(h))


class TransformerEncoder(HybridBlock):
    def __init__(self, num_layers=6, units=512, hidden_size=2048,
                 num_heads=8, dropout=0.1, **kwargs):
        super().__init__(**kwargs)
        self.cells = []
        with self.name_scope():
            for i in range(num_layers):
                cell = TransformerEncoderCell(units, hidden_size, num_heads,
                                              dropout, prefix=f"layer{i}_")
                self.register_child(cell, f"layer{i}")
                self.cells.append(cell)

    def hybrid_forward(self, F, x, valid_length=None):  # noqa: ARG002
        for cell in self.cells:
            x = cell(x) if valid_length is None else cell(x, valid_length)
        return x


class TransformerDecoder(HybridBlock):
    def __init__(self, num_layers=6, units=512, hidden_size=2048,
                 num_heads=8, dropout=0.1, **kwargs):
        super().__init__(**kwargs)
        self.cells = []
        with self.name_scope():
            for i in range(num_layers):
                cell = TransformerDecoderCell(units, hidden_size, num_heads,
                                              dropout, prefix=f"layer{i}_")
                self.register_child(cell, f"layer{i}")
                self.cells.append(cell)

    def hybrid_forward(self, F, x, mem, mem_valid_length=None):  # noqa: ARG002
        for cell in self.cells:
            x = cell(x, mem, mem_valid_length)
        return x


class TransformerModel(HybridBlock):
    """Encoder-decoder MT model.

    ``forward(src_tokens, tgt_tokens[, src_valid_length])`` takes
    batch-major (B, Ls) / (B, Lt) integer tokens (the target already
    shifted right, BOS first) and returns (B, Lt, V) next-token logits.
    ``src_valid_length`` (B,) masks source padding out of the encoder's
    and the cross attention; target padding is the loss's business.  One
    (vocab, units) table, ``embed_weight``, embeds source and target and
    is the output projection."""

    def __init__(self, vocab_size=32768, num_layers=6, units=512,
                 hidden_size=2048, num_heads=8, max_length=1024,
                 dropout=0.1, **kwargs):
        super().__init__(**kwargs)
        self._units = units
        self._vocab = vocab_size
        with self.name_scope():
            self.embed_weight = self.params.get(
                "embed_weight", shape=(vocab_size, units), init=None)
            self.encoder = TransformerEncoder(num_layers, units, hidden_size,
                                              num_heads, dropout,
                                              prefix="enc_")
            self.decoder = TransformerDecoder(num_layers, units, hidden_size,
                                              num_heads, dropout,
                                              prefix="dec_")
            self.drop = Dropout(dropout)
        self._pos = _positional_encoding(max_length, units)
        self._pos_on = {}       # (device, dtype) -> the table there

    def _pos_table(self, x, length):
        """The first ``length`` rows of the position table on ``x``'s
        device in its dtype (kept there: no host copy per forward, and
        none inside a captured step)."""
        t = x._data if isinstance(x, NDArray) else x
        key = (t.device, t.dtype)
        if key not in self._pos_on:
            self._pos_on[key] = torch.from_numpy(self._pos).to(t.device,
                                                               t.dtype)
        pos = self._pos_on[key][:length]
        return NDArray(pos, x._ctx) if isinstance(x, NDArray) else pos

    def _embed(self, F, weight, tokens):
        # gather, scale by sqrt(d), add the sinusoids
        x = F.Embedding(tokens, weight, input_dim=self._vocab,
                        output_dim=self._units) * float(self._units) ** 0.5
        x = x + F.expand_dims(self._pos_table(x, tokens.shape[1]), axis=0)
        return F.transpose(self.drop(x), axes=(1, 0, 2))   # (L, B, C)

    def _encode_impl(self, F, embed_weight, src_tokens, src_valid_length):
        mem = self._embed(F, embed_weight, src_tokens)
        return self.encoder(mem) if src_valid_length is None \
            else self.encoder(mem, src_valid_length)

    def _decode_impl(self, F, embed_weight, mem, tgt_tokens,
                     src_valid_length):
        y = self._embed(F, embed_weight, tgt_tokens)
        y = self.decoder(y, mem, src_valid_length)
        y = F.transpose(y, axes=(1, 0, 2))                 # (B, Lt, C)
        # the tied output projection: logits = y @ embed^T
        logits = F.dot(y.reshape((-1, self._units)), embed_weight,
                       transpose_b=True)
        return logits.reshape((tgt_tokens.shape[0], tgt_tokens.shape[1], -1))

    def hybrid_forward(self, F, src_tokens, tgt_tokens,
                       src_valid_length=None, embed_weight=None):
        mem = self._encode_impl(F, embed_weight, src_tokens,
                                src_valid_length)
        return self._decode_impl(F, embed_weight, mem, tgt_tokens,
                                 src_valid_length)

    def encode(self, src_tokens, src_valid_length=None):
        """The encoder's memory (Ls, B, C) of NDArray ``src_tokens``: the
        half of the forward that autoregressive decoding runs once."""
        from ... import ndarray as F
        return self._encode_impl(F, self.embed_weight.data(src_tokens.ctx),
                                 src_tokens, src_valid_length)

    def decode_from_memory(self, mem, tgt_tokens, src_valid_length=None):
        """The decoder and the tied projection over a memory from
        :meth:`encode`: the logits of ``self(src, tgt, vl)``."""
        from ... import ndarray as F
        return self._decode_impl(F, self.embed_weight.data(tgt_tokens.ctx),
                                 mem, tgt_tokens, src_valid_length)


_CONFIGS = {
    # name: (layers, units, hidden, heads)
    "transformer_base": (6, 512, 2048, 8),
    "transformer_big": (6, 1024, 4096, 16),
    "transformer_test": (2, 64, 128, 4),     # tests
}


def transformer_model(name="transformer_base", vocab_size=32768,
                      max_length=1024, dropout=0.1, **kwargs):
    """The zoo transformer ``name`` (``_CONFIGS``), not yet initialized;
    ``kwargs`` go to ``TransformerModel`` (``prefix`` ...)."""
    if name not in _CONFIGS:
        raise ValueError(f"unknown transformer config {name!r}; "
                         f"known {sorted(_CONFIGS)}")
    L, U, H, A = _CONFIGS[name]
    return TransformerModel(vocab_size=vocab_size, num_layers=L, units=U,
                            hidden_size=H, num_heads=A,
                            max_length=max_length, dropout=dropout, **kwargs)


def _ctx_of(tokens):
    return tokens.ctx if isinstance(tokens, NDArray) else None


def greedy_decode(model, src_tokens, bos_id, eos_id, max_len=64,
                  src_valid_length=None):
    """Greedy decode of NDArray ``src_tokens`` (B, Ls): the argmax next
    token until every row has emitted EOS or ``max_len`` tokens stand.
    The target rides one fixed (B, max_len) buffer whose tail, past the
    current position, causality hides; the source is encoded once.
    Returns (B, <= max_len) int32 tokens, BOS first."""
    from ... import ndarray as mxnd
    B = src_tokens.shape[0]
    ctx = _ctx_of(src_tokens)
    max_len = min(max_len, model._pos.shape[0])
    buf = np.full((B, max_len), eos_id, np.int32)
    buf[:, 0] = bos_id
    done = np.zeros((B,), bool)
    n = 1
    mem = model.encode(src_tokens, src_valid_length)
    for t in range(max_len - 1):
        logits = model.decode_from_memory(mem, mxnd.array(buf, ctx=ctx),
                                          src_valid_length)
        nxt = np.asarray(logits[:, t].asnumpy().argmax(-1), np.int32)
        nxt = np.where(done, eos_id, nxt)
        buf[:, t + 1] = nxt
        done |= nxt == eos_id
        n = t + 2
        if done.all():
            break
    return buf[:, :n]


def beam_search_decode(model, src_tokens, bos_id, eos_id, beam_size=4,
                       max_len=64, alpha=0.6, src_valid_length=None):
    """Beam-search decode (GluonNLP's BeamSearchSampler role): scores
    normalised by GNMT's ``((5 + len) / 6) ** alpha``; a hypothesis that
    emits EOS moves to a pool of completed ones at its normalised score,
    and the search stops once no live beam can beat the pool.  One fixed
    (B K, max_len) buffer, the replicated source encoded once, the beams
    picked on the host.  Returns (best (B, <= max_len) int32 tokens, BOS
    first, scores (B,) length-normalised log-probabilities)."""
    from ... import ndarray as mxnd
    B = src_tokens.shape[0]
    K = beam_size
    ctx = _ctx_of(src_tokens)
    max_len = min(max_len, model._pos.shape[0])
    src_np = src_tokens.asnumpy() if hasattr(src_tokens, "asnumpy") \
        else np.asarray(src_tokens)
    src_rep = mxnd.array(np.repeat(src_np, K, axis=0), ctx=ctx)
    vl_rep = None
    if src_valid_length is not None:
        vl_np = src_valid_length.asnumpy() \
            if hasattr(src_valid_length, "asnumpy") \
            else np.asarray(src_valid_length)
        vl_rep = mxnd.array(np.repeat(vl_np, K, axis=0), ctx=ctx)

    def penalty(length):
        return ((5.0 + length) / 6.0) ** alpha

    buf = np.full((B, K, max_len), eos_id, np.int32)
    buf[:, :, 0] = bos_id
    scores = np.full((B, K), -np.inf, np.float64)
    scores[:, 0] = 0.0            # the beams start equal: keep one live
    best_done = [(-np.inf, None)] * B
    n = 1
    mem = model.encode(src_rep, vl_rep)
    for t in range(max_len - 1):
        flat = mxnd.array(buf.reshape(B * K, max_len), ctx=ctx)
        logits = model.decode_from_memory(mem, flat, vl_rep)
        logp = mxnd.log_softmax(logits[:, t], axis=-1).asnumpy() \
            .astype(np.float64)
        V = logp.shape[-1]
        logp = logp.reshape(B, K, V)
        # an EOS continuation completes a hypothesis: into the pool at its
        # normalised score, and out of the live expansion
        for b in range(B):
            for k in range(K):
                if not np.isfinite(scores[b, k]):
                    continue
                fin = (scores[b, k] + logp[b, k, eos_id]) / penalty(t + 1)
                if fin > best_done[b][0]:
                    seq = buf[b, k, :t + 2].copy()
                    seq[t + 1] = eos_id
                    best_done[b] = (fin, seq)
        logp[:, :, eos_id] = -np.inf
        cand = scores[:, :, None] + logp            # (B, K, V)
        flat_cand = cand.reshape(B, K * V)
        part = np.argpartition(-flat_cand, K - 1, axis=1)[:, :K]
        part_scores = np.take_along_axis(flat_cand, part, 1)
        order = np.argsort(-part_scores, axis=1)
        top = np.take_along_axis(part, order, 1)     # (B, K) best first
        new_scores = np.take_along_axis(flat_cand, top, 1)
        beam_idx, tok_idx = top // V, top % V
        buf = np.take_along_axis(
            buf, beam_idx[:, :, None].astype(np.int64), axis=1)
        buf[:, :, t + 1] = tok_idx.astype(np.int32)
        scores = new_scores
        n = t + 2
        # no live beam can beat the pool even with a perfect continuation
        bound = scores[:, 0] / penalty(max_len - 1)
        if all(best_done[b][0] >= bound[b] for b in range(B)):
            break
    out = np.full((B, n), eos_id, np.int32)
    final = np.empty((B,), np.float64)
    for b in range(B):
        sc, seq = best_done[b]
        if seq is None:
            # no hypothesis finished: the best live beam
            seq = buf[b, 0, :n]
            sc = scores[b, 0] / penalty(n - 1)
        out[b, :len(seq)] = seq[:n]
        final[b] = sc
    return out, final
