"""Model adapter: fixed-shape prefill + single-token decode for the llama
zoo model — the port of ``mxnet_tpu/serving/models.py`` (llama only).

The adapter owns the device half of one engine's state — the weights of an
initialised Gluon ``LlamaModel`` (its Parameters' values, read once) and
the per-layer paged K/V pools — and exposes
numpy-in/numpy-out operations to the scheduler:

- ``prefill(slot, prompt, table_row)`` — one sequence enters: its prompt's
  K/V is written into the slot's pages at the padded prefill shape
  ``(1, prefill_tokens)`` and the first generated token (argmax at the last
  prompt position) comes back.  Attention goes through the port's
  ``ops.contrib._attend``, the op the zoo model itself uses, so an
  eligible prefill shape runs the flash forward kernel on the card.
- ``decode(tokens, tables, ctx)`` — one continuous-batch iteration at the
  fixed shape ``(B_max, 1)`` through ``kernels.paged_attention``.

Numerics mirror the zoo forward (same op order, f32 softmax/norm islands,
``-1e9`` masking on the dense paths).  PyTorch runs eagerly, so there is no
jit cache; the pools are updated in place.
"""

from __future__ import annotations

from collections import namedtuple

import numpy as np
import torch
import torch.nn.functional as F

from ..base import MXNetError
from ..gluon.model_zoo import llama
from ..kernels import paged_attention as _pa
from ..ops.contrib import _attend
from ..ops.registry import tensor_ops

__all__ = ["LlamaServingAdapter", "make_adapter"]


def _rms(x, w, eps):
    """llama.RMSNorm (f32 island, 1/sqrt as the reference's serving path)."""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    out = xf * (1.0 / torch.sqrt(var + eps))
    return (out * w.float()).to(x.dtype)


def _rope_full(x, base):
    """llama._rope of a (B, H, P, D) prefill: positions 0..P-1."""
    return llama._rope(tensor_ops, x, base)


def _rope_at(x, pos, base):
    """llama._rope on (B, H, 1, D) at per-sequence positions ``pos`` (B,)."""
    ang = llama._rope_angles(pos, x.shape[3] // 2, base)[:, None, None, :]
    return llama._rotate(tensor_ops, x, torch.cos(ang).to(x.dtype),
                         torch.sin(ang).to(x.dtype))


def _heads(x, n, hd):
    """(B, L, n*hd) -> (B, n, L, hd)."""
    B, L = x.shape[0], x.shape[1]
    return x.reshape(B, L, n, hd).transpose(1, 2)


def _merge(x):
    """(B, n, L, hd) -> (B, L, n*hd)."""
    B, n, L, hd = x.shape
    return x.transpose(1, 2).reshape(B, L, n * hd)


def _w(param):
    """A Gluon Parameter's value as a tensor outside autograd."""
    return param.data()._data.detach()


LlamaCfg = namedtuple("LlamaCfg", [
    "layers", "units", "heads", "kv_heads", "head_dim", "eps", "rope_base"])

LlamaBlockW = namedtuple("LlamaBlockW", [
    "attn_norm", "q", "k", "v", "o", "mlp_norm", "gate", "up", "down"])

LlamaW = namedtuple("LlamaW", ["embed", "blocks", "norm", "lm_head"])


def _llama_layer(cfg, bw, x, att):
    """Post-attention block body: o-proj residual + SwiGLU MLP residual.
    ``att`` is the (B, H, L, hd) attention context."""
    x = x + torch.matmul(_merge(att), bw.o.T)
    h = _rms(x, bw.mlp_norm, cfg.eps)
    mlp = torch.matmul(F.silu(torch.matmul(h, bw.gate.T))
                       * torch.matmul(h, bw.up.T), bw.down.T)
    return x + mlp


def _llama_qkv(cfg, bw, x):
    h = _rms(x, bw.attn_norm, cfg.eps)
    q = _heads(torch.matmul(h, bw.q.T), cfg.heads, cfg.head_dim)
    k = _heads(torch.matmul(h, bw.k.T), cfg.kv_heads, cfg.head_dim)
    v = _heads(torch.matmul(h, bw.v.T), cfg.kv_heads, cfg.head_dim)
    return q, k, v


def _llama_decode_raw(cfg, w, kv, tokens, tables, ctx, valid=None):
    """One continuous-batching iteration: tokens (B,) at positions ``ctx``
    (B,) -> (next tokens (B,), logits (B, V)).  Reads and writes (in
    place) the paged pools ``kv``."""
    scale = 1.0 / float(cfg.head_dim) ** 0.5
    groups = cfg.heads // cfg.kv_heads
    x = w.embed[tokens][:, None, :]                           # (B, 1, C)
    for li in range(cfg.layers):
        bw = w.blocks[li]
        kp, vp = kv[li]
        q, k, v = _llama_qkv(cfg, bw, x)
        q = _rope_at(q, ctx, cfg.rope_base)
        k = _rope_at(k, ctx, cfg.rope_base)
        _pa.write_kv(kp, vp, tables, ctx, k[:, :, 0, :], v[:, :, 0, :],
                     valid=valid)
        att = _pa.paged_attention(q, kp, vp, tables, ctx + 1,
                                  num_kv_groups=groups, sm_scale=scale)
        x = _llama_layer(cfg, bw, x, att)
    xf = _rms(x, w.norm, cfg.eps)
    logits = torch.matmul(xf[:, 0], w.lm_head.T)              # (B, V)
    return torch.argmax(logits, dim=-1), logits


def _copy_block_raw(kv, src, dst):
    """Device-side block copy (copy-on-write): every layer's k/v pool row
    ``dst`` becomes a copy of row ``src``, in place."""
    for kp, vp in kv:
        kp[dst] = kp[src]
        vp[dst] = vp[src]


def _llama_prefill_raw(cfg, w, kv, tokens, plen, table_row,
                       flash_reference=False):
    """Whole (padded) prompt at the fixed shape (1, P): causal attention
    through the port's ``_attend`` (flash at eligible P, dense below),
    whose K/V is scattered into the slot's pages (pads -> scratch).
    Returns (first generated token, logits (V,)) at the last valid
    position ``plen - 1``."""
    groups = cfg.heads // cfg.kv_heads
    x = w.embed[tokens]                                       # (1, P, C)
    for li in range(cfg.layers):
        bw = w.blocks[li]
        kp, vp = kv[li]
        q, k, v = _llama_qkv(cfg, bw, x)
        q = _rope_full(q, cfg.rope_base)
        k = _rope_full(k, cfg.rope_base)
        _pa.write_kv_prefill(kp, vp, table_row, plen,
                             k[0].transpose(0, 1), v[0].transpose(0, 1))
        kr = torch.repeat_interleave(k, groups, dim=1)
        vr = torch.repeat_interleave(v, groups, dim=1)
        att = _attend(q, kr, vr, None, True, flash_reference=flash_reference)
        x = _llama_layer(cfg, bw, x, att)
    xf = _rms(x, w.norm, cfg.eps)
    logits = torch.matmul(xf[0, plen - 1], w.lm_head.T)       # (V,)
    return torch.argmax(logits, dim=-1), logits


class LlamaServingAdapter:
    """LlamaModel -> paged serving (decoder-only: GQA pools, RoPE decode,
    prefill emits the first token).  Preemption-by-recompute works
    because prompt + generated re-prefills as a longer prompt.  One
    adapter serves one engine: the pools are engine state."""

    def __init__(self, model, eos_id, prefill_tokens):
        if not isinstance(model, llama.LlamaModel):
            raise MXNetError("LlamaServingAdapter wants a LlamaModel")
        self.prefill_tokens = int(prefill_tokens)
        self.eos_id = int(eos_id)
        blk0 = model.blocks[0]
        self.cfg = LlamaCfg(
            layers=len(model.blocks), units=model._units,
            heads=blk0._heads, kv_heads=blk0._kv, head_dim=blk0._hd,
            eps=model.norm._eps, rope_base=500000.0)
        self.weights = LlamaW(
            embed=_w(model.embed.weight),
            blocks=tuple(
                LlamaBlockW(
                    attn_norm=_w(b.attn_norm.weight),
                    q=_w(b.q_proj.weight), k=_w(b.k_proj.weight),
                    v=_w(b.v_proj.weight), o=_w(b.o_proj.weight),
                    mlp_norm=_w(b.mlp_norm.weight),
                    gate=_w(b.gate.weight), up=_w(b.up.weight),
                    down=_w(b.down.weight))
                for b in model.blocks),
            norm=_w(model.norm.weight),
            lm_head=_w(model.lm_head.weight))
        self.device = self.weights.embed.device
        self._kv = None
        self._all_valid = None

    def to_device(self, array):
        """A copy of a host integer array on the adapter's device."""
        return torch.tensor(np.asarray(array), dtype=torch.long,
                            device=self.device)

    def make_pools(self, num_blocks, block_tokens):
        shape = (num_blocks, block_tokens, self.cfg.kv_heads,
                 self.cfg.head_dim)
        self._kv = tuple(
            (torch.zeros(shape, dtype=torch.float32, device=self.device),
             torch.zeros(shape, dtype=torch.float32, device=self.device))
            for _ in range(self.cfg.layers))

    def cache_positions(self, prompt_len, max_new_tokens):
        """Worst-case paged-cache positions a request can reach."""
        return prompt_len + max_new_tokens

    def pad_prompt(self, prompt):
        if len(prompt) > self.prefill_tokens:
            raise MXNetError(
                f"prompt of {len(prompt)} tokens exceeds the prefill "
                f"shape {self.prefill_tokens} (MXNET_SERVING_PREFILL_TOKENS)")
        buf = np.zeros((1, self.prefill_tokens), np.int64)
        buf[0, :len(prompt)] = prompt
        return buf

    @torch.inference_mode()
    def prefill_logits(self, prompt, table_row, flash_reference=False):
        """Prefill ``prompt`` into the pages of ``table_row``; returns the
        first generated token and the last position's logits (V,).
        ``flash_reference=True`` runs attention through the flash kernel's
        plain twin (for holding the kernel against it end to end)."""
        toks = self.to_device(self.pad_prompt(prompt))
        row = self.to_device(table_row)
        nxt, logits = _llama_prefill_raw(
            self.cfg, self.weights, self._kv, toks, len(prompt), row,
            flash_reference=flash_reference)
        return int(nxt), logits

    def prefill(self, slot, prompt, table_row):
        del slot  # llama keeps no per-slot state beyond the pages
        return self.prefill_logits(prompt, table_row)[0]

    @torch.inference_mode()
    def decode(self, tokens, tables, ctx):
        """One (B, 1) step: next token per slot (B,) int32.  ``tables`` is
        the device copy of the block tables (``to_device``)."""
        if self._all_valid is None or len(self._all_valid) != len(tokens):
            self._all_valid = torch.ones((len(tokens),), dtype=torch.bool,
                                         device=self.device)
        nxt, _ = _llama_decode_raw(
            self.cfg, self.weights, self._kv, self.to_device(tokens),
            tables, self.to_device(ctx), self._all_valid)
        return nxt.cpu().numpy().astype(np.int32)

    @torch.inference_mode()
    def copy_block(self, dst, src):
        """Duplicate pool block ``src`` into ``dst`` in every layer."""
        _copy_block_raw(self._kv, int(src), int(dst))


def make_adapter(model, eos_id, prefill_tokens=64):
    """Adapter for a zoo model by type (the ServingEngine entry point)."""
    if eos_id is None:
        raise MXNetError("serving needs eos_id (generation stop token)")
    if isinstance(model, llama.LlamaModel):
        return LlamaServingAdapter(model, eos_id, prefill_tokens)
    if type(model).__name__ == "TransformerModel":
        raise MXNetError("transformer (encoder-decoder) serving is not yet "
                         "ported to mxnet_tpu_torch")
    raise MXNetError(f"no serving adapter for {type(model).__name__}")
