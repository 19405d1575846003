"""Model adapters: fixed-shape prefill + decode for the serving engine —
the port of ``mxnet_tpu/serving/models.py``.

Each adapter owns the device half of one engine's state — the weights of
an initialised Gluon zoo model (its Parameters' values, read once), the
per-layer paged K/V pools, and (for the encoder-decoder) the per-slot
encoder-side caches — and exposes numpy-in/numpy-out operations to the
scheduler:

- ``prefill(slot, prompt, table_row)`` — one sequence enters at the padded
  prefill shape ``(1, prefill_tokens)``.  The llama writes its prompt's
  K/V into the slot's pages and returns the first generated token; its
  attention goes through the port's ``ops.contrib._attend``, the op the
  zoo model itself uses, so an eligible prefill shape runs the flash
  forward kernel on the card.  The MT transformer runs its encoder (the
  same ``_attend`` with the source's segment ids, so a source padded to
  ``prefill_tokens`` >= 256 runs the flash kernel too) and caches every
  decoder layer's cross K/V for the slot.
- ``decode(tokens, tables, ctx)`` — one continuous-batch iteration at the
  fixed shape ``(B_max, 1)`` through ``kernels.paged_attention``.
- llama only: ``prefill_tail`` (a prefix-cache hit prefills just its tail
  in ``(1, block_tokens)`` chunks), ``decode_multi`` (the ``(B, K)``
  speculative verify) and ``copy_block`` (copy-on-write).

Numerics mirror the zoo forward (same op order, f32 softmax/norm islands,
``-1e9`` masking on the dense paths).  PyTorch runs eagerly, so there is
no jit cache; the pools are updated in place.  The six entries are cost
ledger sites (``telemetry.costmodel``): ``serving.llama_prefill``,
``serving.llama_decode``, ``serving.llama_multi``,
``serving.llama_copy_block``, ``serving.tf_encode`` and
``serving.tf_decode``, one flag read each while the ledger is disarmed.
"""

from __future__ import annotations

from collections import namedtuple

import numpy as np
import torch
import torch.nn.functional as F

from ..base import MXNetError
from ..gluon.model_zoo import llama
from ..kernels import paged_attention as _pa
from ..ops.contrib import _attend, _dense_sdpa_cross
from ..ops.nn import _layer_norm
from ..ops.registry import tensor_ops
from ..telemetry import costmodel as _costmodel

__all__ = ["LlamaServingAdapter", "TransformerServingAdapter",
           "make_adapter"]


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


def _rope_at_multi(x, pos, base):
    """llama._rope on (B, H, K, D) at per-(sequence, column) positions
    ``pos`` (B, K) — the K-token verify/tail-chunk generalization of
    :func:`_rope_at` (K=1 reduces to it exactly)."""
    B, _, K, D = x.shape
    half = D // 2
    ang = llama._rope_angles(pos.reshape(-1), half, base).reshape(B, K, half)
    return llama._rotate(tensor_ops, x,
                         torch.cos(ang)[:, None].to(x.dtype),
                         torch.sin(ang)[:, None].to(x.dtype))


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


# --------------------------------------------------------------------------
# llama: decoder-only LM, RMSNorm/RoPE/GQA/SwiGLU
# --------------------------------------------------------------------------

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
    place) the paged pools ``kv``; ``valid`` (B,) bool routes the k/v
    writes of over-budget rows to scratch (the draft model's speculation
    steps are the masked caller)."""
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


def _llama_multi_decode_raw(cfg, w, kv, tokens, tables, pos0, n_valid):
    """K tokens per slot in ONE dispatch — the speculative-verify /
    prefix-tail-chunk body.  ``tokens`` (B, K) sit at positions
    ``pos0[b] + j``; their k/v scatters into the pages first (columns
    past ``n_valid[b]`` -> scratch), then every column attends its own
    causal bound through the pool, so column j's logits are what a j-step
    sequential decode would have produced.  Returns (the greedy argmax per
    column (B, K), logits (B, K, V))."""
    scale = 1.0 / float(cfg.head_dim) ** 0.5
    groups = cfg.heads // cfg.kv_heads
    B, K = tokens.shape
    pos = pos0[:, None] + torch.arange(K, dtype=pos0.dtype,
                                       device=pos0.device)[None]  # (B, K)
    x = w.embed[tokens]                                       # (B, K, C)
    for li in range(cfg.layers):
        bw = w.blocks[li]
        kp, vp = kv[li]
        q, k, v = _llama_qkv(cfg, bw, x)
        q = _rope_at_multi(q, pos, cfg.rope_base)
        k = _rope_at_multi(k, pos, cfg.rope_base)
        _pa.write_kv_multi(kp, vp, tables, pos0, n_valid,
                           k.transpose(1, 2), v.transpose(1, 2))
        att = _pa.paged_attention_multi(q, kp, vp, tables, pos0,
                                        num_kv_groups=groups, sm_scale=scale)
        x = _llama_layer(cfg, bw, x, att)
    xf = _rms(x, w.norm, cfg.eps)
    logits = torch.matmul(xf, w.lm_head.T)                    # (B, K, V)
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


# --------------------------------------------------------------------------
# transformer (encoder-decoder MT): post-norm, sinusoidal pos, tied embed
# --------------------------------------------------------------------------

TransformerCfg = namedtuple("TransformerCfg", [
    "layers", "units", "hidden", "heads", "head_dim", "eps", "src_tokens"])

EncCellW = namedtuple("EncCellW", [
    "qkv", "qkv_b", "proj", "proj_b", "ffn1", "ffn1_b", "ffn2", "ffn2_b",
    "ln_att_g", "ln_att_b", "ln_ffn_g", "ln_ffn_b"])

DecCellW = namedtuple("DecCellW", [
    "qkv", "qkv_b", "proj", "proj_b",
    "cq", "cq_b", "ckv", "ckv_b", "cproj", "cproj_b",
    "ffn1", "ffn1_b", "ffn2", "ffn2_b",
    "ln_self_g", "ln_self_b", "ln_cross_g", "ln_cross_b",
    "ln_ffn_g", "ln_ffn_b"])

TransformerW = namedtuple("TransformerW", ["embed", "pos", "enc", "dec"])


def _ln(x, gamma, beta, eps):
    return _layer_norm(x, gamma, beta, eps=eps)


def _tf_embed(cfg, w, tokens, pos_rows):
    """TransformerModel._embed, batch-major: gather, scale sqrt(d), add
    the sinusoid rows for ``pos_rows`` ((B, L) positions)."""
    x = w.embed[tokens] * float(cfg.units) ** 0.5
    return x + w.pos[pos_rows].to(x.dtype)


def _tf_ffn(cfg, cell, out):
    h = torch.matmul(F.relu(torch.matmul(out, cell.ffn1.T) + cell.ffn1_b),
                     cell.ffn2.T) + cell.ffn2_b
    return _ln(out + h, cell.ln_ffn_g, cell.ln_ffn_b, cfg.eps)


def _tf_encode_raw(cfg, w, src, svl):
    """Encoder at the fixed shape (1, S): self-attention through the
    port's ``_attend`` with the source's valid length (segment ids: flash
    at eligible S, dense below).  Returns the per-layer cross K/V
    ((H, S, hd) each) the decoder will attend to, plus the source segment
    row (S,)."""
    S = src.shape[1]
    steps = torch.arange(S, device=src.device)
    seg = (steps[None, :] < svl[:, None]).to(torch.int32)        # (1, S)
    x = _tf_embed(cfg, w, src, steps[None].expand(src.shape))
    for cell in w.enc:
        qkv = torch.matmul(x, cell.qkv.T) + cell.qkv_b            # (1, S, 3C)
        qh = qkv.reshape(1, S, cfg.heads, 3, cfg.head_dim)
        q = qh[:, :, :, 0].transpose(1, 2)
        k = qh[:, :, :, 1].transpose(1, 2)
        v = qh[:, :, :, 2].transpose(1, 2)
        ctxv = _attend(q, k, v, svl, False)
        out = _ln(x + torch.matmul(_merge(ctxv), cell.proj.T) + cell.proj_b,
                  cell.ln_att_g, cell.ln_att_b, cfg.eps)
        x = _tf_ffn(cfg, cell, out)
    cross_k, cross_v = [], []
    for cell in w.dec:
        kv = torch.matmul(x, cell.ckv.T) + cell.ckv_b             # (1, S, 2C)
        kvh = kv.reshape(1, S, cfg.heads, 2, cfg.head_dim)
        cross_k.append(kvh[0, :, :, 0].transpose(0, 1))           # (H, S, hd)
        cross_v.append(kvh[0, :, :, 1].transpose(0, 1))
    return cross_k, cross_v, seg[0]


def _tf_decode_raw(cfg, w, kv, cross_k, cross_v, seg, tokens, tables, ctx):
    """One decoder token per slot: paged causal self-attention + cached
    cross-attention against the slot's encoder K/V.  Returns (next tokens
    (B,), logits (B, V))."""
    scale = 1.0 / float(cfg.head_dim) ** 0.5
    B = tokens.shape[0]
    x = _tf_embed(cfg, w, tokens[:, None], ctx[:, None])          # (B, 1, C)
    for li in range(cfg.layers):
        cell = w.dec[li]
        kp, vp = kv[li]
        qkv = torch.matmul(x, cell.qkv.T) + cell.qkv_b            # (B, 1, 3C)
        qh = qkv.reshape(B, 1, cfg.heads, 3, cfg.head_dim)
        q = qh[:, :, :, 0].transpose(1, 2)                  # (B, H, 1, hd)
        k = qh[:, :, :, 1].transpose(1, 2)
        v = qh[:, :, :, 2].transpose(1, 2)
        _pa.write_kv(kp, vp, tables, ctx, k[:, :, 0, :], v[:, :, 0, :])
        selfv = _pa.paged_attention(q, kp, vp, tables, ctx + 1,
                                    sm_scale=scale)
        out = _ln(x + torch.matmul(_merge(selfv), cell.proj.T) + cell.proj_b,
                  cell.ln_self_g, cell.ln_self_b, cfg.eps)
        cq = _heads(torch.matmul(out, cell.cq.T) + cell.cq_b,
                    cfg.heads, cfg.head_dim)
        crossv = _dense_sdpa_cross(cq, cross_k[li], cross_v[li], seg, scale)
        out = _ln(out + torch.matmul(_merge(crossv), cell.cproj.T)
                  + cell.cproj_b,
                  cell.ln_cross_g, cell.ln_cross_b, cfg.eps)
        x = _tf_ffn(cfg, cell, out)
    logits = torch.matmul(x[:, 0], w.embed.T)                     # tied head
    return torch.argmax(logits, dim=-1), logits


# --------------------------------------------------------------------------
# adapters
# --------------------------------------------------------------------------

def _entry(name, site):
    """The module function ``name`` (looked up at each call) as the cost
    ledger's ``site``."""
    scope = globals()
    return _costmodel.wrap(lambda *a, **kw: scope[name](*a, **kw), site)


_llama_decode = _entry("_llama_decode_raw", "serving.llama_decode")
_llama_multi = _entry("_llama_multi_decode_raw", "serving.llama_multi")
_copy_block = _entry("_copy_block_raw", "serving.llama_copy_block")
_llama_prefill = _entry("_llama_prefill_raw", "serving.llama_prefill")
_tf_encode = _entry("_tf_encode_raw", "serving.tf_encode")
_tf_decode = _entry("_tf_decode_raw", "serving.tf_decode")


class _AdapterBase:
    """Device-state owner for one engine (weights, pools).

    ``decode`` and ``prefill`` take/return numpy; all device tensors stay
    inside.  One adapter serves one engine — pools are engine state.
    """

    first_token_from_prefill = False
    supports_recompute = False
    # prompt K/V lives in the pages AND the adapter can score/write a
    # multi-token chunk against them — what prefix-cache block sharing
    # (tail-only prefill) and speculative verify both require
    supports_prefix_cache = False
    # hard ceiling on cache positions the model can embed (None = no
    # table, e.g. RoPE); the engine refuses a max_seq beyond it — decode
    # positions past a sinusoid table would index out of it
    max_positions = None

    def __init__(self, prefill_tokens, eos_id, bos_id, device):
        self.prefill_tokens = int(prefill_tokens)
        self.eos_id = int(eos_id)
        self.bos_id = None if bos_id is None else int(bos_id)
        self.device = device
        self._kv = None
        self._block_tokens = None

    def _pool_shape(self, num_blocks, block_tokens):
        raise NotImplementedError

    def _layers(self):
        raise NotImplementedError

    def to_device(self, array):
        """A copy of a host integer array on the adapter's device."""
        return torch.tensor(np.asarray(array), dtype=torch.long,
                            device=self.device)

    def make_pools(self, num_blocks, block_tokens):
        self._block_tokens = int(block_tokens)
        shape = self._pool_shape(num_blocks, block_tokens)
        self._kv = tuple(
            (torch.zeros(shape, dtype=torch.float32, device=self.device),
             torch.zeros(shape, dtype=torch.float32, device=self.device))
            for _ in range(self._layers()))

    def cache_positions(self, prompt_len, max_new_tokens):
        """Worst-case paged-cache positions a request can reach — what
        the engine checks against MXNET_SERVING_MAX_SEQ.  Decoder-only
        models cache the prompt too; encoder-decoder models only cache
        the growing target."""
        del prompt_len
        return max_new_tokens

    def pad_prompt(self, prompt):
        if len(prompt) > self.prefill_tokens:
            raise MXNetError(
                f"prompt of {len(prompt)} tokens exceeds the prefill "
                f"shape {self.prefill_tokens} (MXNET_SERVING_PREFILL_TOKENS)")
        buf = np.zeros((1, self.prefill_tokens), np.int64)
        buf[0, :len(prompt)] = prompt
        return buf


class LlamaServingAdapter(_AdapterBase):
    """LlamaModel -> paged serving (decoder-only: GQA pools, RoPE decode,
    prefill emits the first token).  Preemption-by-recompute works
    because prompt + generated re-prefills as a longer prompt."""

    first_token_from_prefill = True
    supports_recompute = True
    supports_prefix_cache = True

    def __init__(self, model, eos_id, prefill_tokens):
        if not isinstance(model, llama.LlamaModel):
            raise MXNetError("LlamaServingAdapter wants a LlamaModel")
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
        super().__init__(prefill_tokens, eos_id, None,
                         self.weights.embed.device)
        self._all_valid = None
        # weight-FLOPs per token position (2 * matmul params): the
        # dominant, length-independent term of the serving cost
        hidden = blk0.gate._units
        per_blk = (2 * self.cfg.units * self.cfg.units            # q + o
                   + 2 * self.cfg.units * blk0._hd * blk0._kv     # k + v
                   + 3 * self.cfg.units * hidden)                 # swiglu
        self.flops_per_position = 2 * (
            self.cfg.layers * per_blk
            + self.cfg.units * self.weights.lm_head.shape[0])

    def _layers(self):
        return self.cfg.layers

    def _pool_shape(self, num_blocks, block_tokens):
        return (num_blocks, block_tokens, self.cfg.kv_heads,
                self.cfg.head_dim)

    def cache_positions(self, prompt_len, max_new_tokens):
        return prompt_len + max_new_tokens

    @torch.inference_mode()
    def prefill_logits(self, prompt, table_row, flash_reference=False):
        """Prefill ``prompt`` into the pages of ``table_row``; returns the
        first generated token and the last position's logits (V,).
        ``flash_reference=True`` runs attention through the flash kernel's
        plain twin (for holding the kernel against it end to end)."""
        toks = self.to_device(self.pad_prompt(prompt))
        row = self.to_device(table_row)
        nxt, logits = _llama_prefill(
            self.cfg, self.weights, self._kv, toks, len(prompt), row,
            flash_reference=flash_reference)
        return int(nxt), logits

    def prefill(self, slot, prompt, table_row):
        del slot  # llama keeps no per-slot state beyond the pages
        return self.prefill_logits(prompt, table_row)[0]

    @torch.inference_mode()
    def prefill_tail(self, slot, prompt, tail_start, table_row):
        """Prefix-cache-hit admission: positions < ``tail_start`` already
        sit in blocks shared from the prefix index, so only the tail
        re-computes — in fixed ``(1, block_tokens)`` chunks from the
        containing block boundary (the boundary chunk re-writes its
        already-correct shared positions bit-identically into the slot's
        copy-on-write copy).  Returns (first generated token, positions
        computed) — the second is what the prefill telemetry counts
        instead of the full padded prefill shape."""
        del slot
        T = self._block_tokens
        plen = len(prompt)
        base = (int(tail_start) // T) * T
        row = self.to_device(np.asarray(table_row)[None])
        nxt = None
        positions = 0
        for lo in range(base, plen, T):
            chunk = np.zeros((1, T), np.int64)
            nv = min(T, plen - lo)
            chunk[0, :nv] = prompt[lo:lo + nv]
            g, _ = _llama_multi(
                self.cfg, self.weights, self._kv, self.to_device(chunk), row,
                self.to_device([lo]), self.to_device([nv]))
            nxt = int(g[0, nv - 1])
            positions += T
        return nxt, positions

    @torch.inference_mode()
    def decode(self, tokens, tables, ctx, valid=None):
        """One (B, 1) step: next token per slot (B,) int32.  ``tables`` is
        the device copy of the block tables (``to_device``); ``valid``
        (B,) bool, when given, routes invalid rows' writes to scratch."""
        if valid is None:
            if self._all_valid is None \
                    or len(self._all_valid) != len(tokens):
                self._all_valid = torch.ones((len(tokens),),
                                             dtype=torch.bool,
                                             device=self.device)
            rows = self._all_valid
        else:
            rows = torch.as_tensor(np.asarray(valid, bool),
                                   device=self.device)
        nxt, _ = _llama_decode(
            self.cfg, self.weights, self._kv, self.to_device(tokens),
            tables, self.to_device(ctx), rows)
        # graftcheck: ignore[GC01] — the scheduler's one read-back a step:
        # the engine checks EOS and emits the (B,) next tokens on the host
        return nxt.cpu().numpy().astype(np.int32)

    @torch.inference_mode()
    def decode_multi(self, tokens, tables, ctx, n_valid):
        """One (B, K) speculative-verify dispatch: greedy argmax per
        chunk column (B, K) int32."""
        g, _ = _llama_multi(
            self.cfg, self.weights, self._kv, self.to_device(tokens), tables,
            self.to_device(ctx), self.to_device(n_valid))
        # graftcheck: ignore[GC01] — the verify's one read-back: the engine
        # accepts drafts and emits tokens on the host
        return g.cpu().numpy().astype(np.int32)

    @torch.inference_mode()
    def copy_block(self, dst, src):
        """Copy-on-write: duplicate pool block ``src`` into ``dst`` in
        every layer's k/v pools."""
        _copy_block(self._kv, int(src), int(dst))


class TransformerServingAdapter(_AdapterBase):
    """TransformerModel (encoder-decoder MT) -> paged serving.  The
    "prompt" is the SOURCE sentence: prefill runs the encoder once and
    caches each decoder layer's cross K/V for the slot; decode then grows
    the target from BOS through the paged self-attention cache.  No
    recompute-preemption (cross K/V would have to be rebuilt mid-stream);
    the engine reserves worst-case blocks at admission instead."""

    def __init__(self, model, bos_id, eos_id, prefill_tokens, max_batch):
        from ..gluon.model_zoo.transformer import TransformerModel
        if not isinstance(model, TransformerModel):
            raise MXNetError(
                "TransformerServingAdapter wants a TransformerModel")
        cell0 = model.decoder.cells[0]
        units = model._units
        heads = cell0._num_heads
        self.cfg = TransformerCfg(
            layers=len(model.decoder.cells), units=units,
            hidden=cell0.ffn_1._units, heads=heads,
            head_dim=units // heads, eps=cell0.ln_self._epsilon,
            src_tokens=int(prefill_tokens))
        if model._pos.shape[0] < prefill_tokens:
            raise MXNetError("model max_length smaller than the prefill "
                             "shape (MXNET_SERVING_PREFILL_TOKENS)")
        self.max_positions = int(model._pos.shape[0])

        def enc_w(c):
            return EncCellW(
                qkv=_w(c.attn_qkv.weight), qkv_b=_w(c.attn_qkv.bias),
                proj=_w(c.attn_proj.weight), proj_b=_w(c.attn_proj.bias),
                ffn1=_w(c.ffn_1.weight), ffn1_b=_w(c.ffn_1.bias),
                ffn2=_w(c.ffn_2.weight), ffn2_b=_w(c.ffn_2.bias),
                ln_att_g=_w(c.ln_att.gamma), ln_att_b=_w(c.ln_att.beta),
                ln_ffn_g=_w(c.ln_ffn.gamma), ln_ffn_b=_w(c.ln_ffn.beta))

        def dec_w(c):
            return DecCellW(
                qkv=_w(c.attn_qkv.weight), qkv_b=_w(c.attn_qkv.bias),
                proj=_w(c.attn_proj.weight), proj_b=_w(c.attn_proj.bias),
                cq=_w(c.cross_q.weight), cq_b=_w(c.cross_q.bias),
                ckv=_w(c.cross_kv.weight), ckv_b=_w(c.cross_kv.bias),
                cproj=_w(c.cross_proj.weight), cproj_b=_w(c.cross_proj.bias),
                ffn1=_w(c.ffn_1.weight), ffn1_b=_w(c.ffn_1.bias),
                ffn2=_w(c.ffn_2.weight), ffn2_b=_w(c.ffn_2.bias),
                ln_self_g=_w(c.ln_self.gamma), ln_self_b=_w(c.ln_self.beta),
                ln_cross_g=_w(c.ln_cross.gamma),
                ln_cross_b=_w(c.ln_cross.beta),
                ln_ffn_g=_w(c.ln_ffn.gamma), ln_ffn_b=_w(c.ln_ffn.beta))

        embed = _w(model.embed_weight)
        self.weights = TransformerW(
            embed=embed,
            pos=torch.from_numpy(model._pos).to(embed.device),
            enc=tuple(enc_w(c) for c in model.encoder.cells),
            dec=tuple(dec_w(c) for c in model.decoder.cells))
        super().__init__(prefill_tokens, eos_id, bos_id, embed.device)
        # per-slot encoder-side caches (stale rows are harmless: a slot's
        # slabs are rewritten at admission before any decode reads them)
        S = self.cfg.src_tokens
        self._cross_k = [
            torch.zeros((max_batch, heads, S, self.cfg.head_dim),
                        dtype=torch.float32, device=self.device)
            for _ in range(self.cfg.layers)]
        self._cross_v = [
            torch.zeros((max_batch, heads, S, self.cfg.head_dim),
                        dtype=torch.float32, device=self.device)
            for _ in range(self.cfg.layers)]
        self._seg = torch.zeros((max_batch, S), dtype=torch.int32,
                                device=self.device)
        n_enc = len(model.encoder.cells)
        per_enc = 4 * units * units + 2 * units * self.cfg.hidden
        per_dec = 8 * units * units + 2 * units * self.cfg.hidden
        vocab = self.weights.embed.shape[0]
        self.flops_per_position = 2 * (
            n_enc * per_enc + self.cfg.layers * per_dec + units * vocab)

    def _layers(self):
        return self.cfg.layers

    def _pool_shape(self, num_blocks, block_tokens):
        return (num_blocks, block_tokens, self.cfg.heads, self.cfg.head_dim)

    @torch.inference_mode()
    def prefill(self, slot, prompt, table_row):
        del table_row  # the source rides the cross cache, not the pages
        toks = self.to_device(self.pad_prompt(prompt))
        svl = self.to_device([len(prompt)])
        ck, cv, seg = _tf_encode(self.cfg, self.weights, toks, svl)
        for li in range(self.cfg.layers):
            self._cross_k[li][slot] = ck[li]
            self._cross_v[li][slot] = cv[li]
        self._seg[slot] = seg
        return None                         # first token comes from decode

    @torch.inference_mode()
    def decode(self, tokens, tables, ctx):
        nxt, _ = _tf_decode(
            self.cfg, self.weights, self._kv, self._cross_k, self._cross_v,
            self._seg, self.to_device(tokens), tables, self.to_device(ctx))
        # graftcheck: ignore[GC01] — the scheduler's one read-back a step:
        # the engine checks EOS and emits the (B,) next tokens on the host
        return nxt.cpu().numpy().astype(np.int32)


def make_adapter(model, eos_id, bos_id=None, prefill_tokens=64,
                 max_batch=8):
    """Adapter for a zoo model by type (the ServingEngine entry point)."""
    from ..gluon.model_zoo.transformer import TransformerModel
    if eos_id is None:
        raise MXNetError("serving needs eos_id (generation stop token)")
    if isinstance(model, llama.LlamaModel):
        return LlamaServingAdapter(model, eos_id, prefill_tokens)
    if isinstance(model, TransformerModel):
        if bos_id is None:
            raise MXNetError("transformer serving needs bos_id")
        return TransformerServingAdapter(model, bos_id, eos_id,
                                         prefill_tokens, max_batch)
    raise MXNetError(f"no serving adapter for {type(model).__name__}")
