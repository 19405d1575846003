"""Llama-style decoder LLM as ``torch.nn.Module``s — the port of
``mxnet_tpu/gluon/model_zoo/llama.py``.

Architecture (Llama 3 family): pre-RMSNorm decoder blocks, rotary position
embeddings, grouped-query attention (kv_heads < heads), SwiGLU MLP, untied
LM head, causal masking.  Attention runs through the port's
``ops.contrib.masked_att_qkv`` like the reference's Gluon forward, so a
flash-eligible sequence takes the flash forward kernel on the card.
Dense weights are (out_features, in_features), as in the reference.
"""

from __future__ import annotations

import torch
from torch import nn
import torch.nn.functional as F

from ...base import MXNetError
from ...context import resolve_device
from ...initializer import init_weights
from ...ops.contrib import masked_att_qkv

__all__ = ["LlamaModel", "llama_model", "LLAMA_CONFIGS"]

# name -> (layers, units, hidden, heads, kv_heads)
LLAMA_CONFIGS = {
    "llama3_8b": (32, 4096, 14336, 32, 8),
    "llama_tiny": (2, 64, 172, 4, 2),        # tests
    "llama_small": (4, 256, 688, 8, 4),
}


class RMSNorm(nn.Module):
    """Root-mean-square norm (no mean subtraction, no bias), in f32."""

    def __init__(self, units, eps=1e-5, device=None, dtype=torch.float32):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(units, device=device,
                                              dtype=dtype))

    def forward(self, x):
        xf = x.float()
        var = (xf * xf).mean(dim=-1, keepdim=True)
        out = xf * torch.rsqrt(var + self.eps)
        return (out * self.weight.float()).to(x.dtype)


def _rope_angles(pos, half, base):
    """Rotary angles (len(pos), half) for integer positions ``pos``."""
    inv = 1.0 / (base ** (torch.arange(0, half, device=pos.device).float()
                          / half))
    return pos.float()[:, None] * inv[None, :]


def _rotate(x, ang):
    """Rotate the two halves of x's last dim by ``ang`` (broadcast against
    x[..., :half])."""
    half = x.shape[-1] // 2
    cos = torch.cos(ang).to(x.dtype)
    sin = torch.sin(ang).to(x.dtype)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def _rope(x, base=500000.0):
    """Rotary embeddings over the last dim; x: (B, H, L, D)."""
    L, D = x.shape[2], x.shape[3]
    return _rotate(x, _rope_angles(torch.arange(L, device=x.device),
                                   D // 2, base))


def _linear(units_in, units_out, device, dtype):
    return nn.Linear(units_in, units_out, bias=False, device=device,
                     dtype=dtype)


class LlamaBlock(nn.Module):
    def __init__(self, units, hidden, heads, kv_heads, device=None,
                 dtype=torch.float32):
        super().__init__()
        if units % heads or heads % kv_heads:
            raise MXNetError("units % heads and heads % kv_heads must be 0")
        self.units = units
        self.heads = heads
        self.kv_heads = kv_heads
        self.head_dim = units // heads
        self.hidden = hidden
        kvw = self.head_dim * kv_heads
        self.q_proj = _linear(units, units, device, dtype)
        self.k_proj = _linear(units, kvw, device, dtype)
        self.v_proj = _linear(units, kvw, device, dtype)
        self.o_proj = _linear(units, units, device, dtype)
        self.gate = _linear(units, hidden, device, dtype)
        self.up = _linear(units, hidden, device, dtype)
        self.down = _linear(hidden, units, device, dtype)
        self.attn_norm = RMSNorm(units, device=device, dtype=dtype)
        self.mlp_norm = RMSNorm(units, device=device, dtype=dtype)

    def forward(self, x):
        # x: (B, L, C) batch-major
        B, L, _ = x.shape
        h = self.attn_norm(x)
        q = self.q_proj(h).reshape(B, L, self.heads, self.head_dim) \
            .transpose(1, 2)                                # (B, H, L, D)
        k = self.k_proj(h).reshape(B, L, self.kv_heads, self.head_dim) \
            .transpose(1, 2)
        v = self.v_proj(h).reshape(B, L, self.kv_heads, self.head_dim) \
            .transpose(1, 2)
        q = _rope(q)
        k = _rope(k)
        ctx_vec = masked_att_qkv(q, k, v, None,
                                 num_kv_groups=self.heads // self.kv_heads,
                                 causal=True)
        attn = self.o_proj(ctx_vec.transpose(1, 2).reshape(B, L, self.units))
        x = x + attn
        h = self.mlp_norm(x)
        return x + self.down(F.silu(self.gate(h)) * self.up(h))


class LlamaModel(nn.Module):
    def __init__(self, vocab_size=128256, num_layers=2, units=64,
                 hidden=172, heads=4, kv_heads=2, device=None,
                 dtype=torch.float32):
        """Widths as keywords, as ``bench.py``'s llama lane builds the
        reference (``LlamaModel(vocab_size=, num_layers=, units=, hidden=,
        heads=, kv_heads=)``).  Parameters are trainable, as in the
        reference; serving runs under ``torch.inference_mode``."""
        super().__init__()
        self.units = units
        self.embed = nn.Embedding(vocab_size, units, device=device,
                                  dtype=dtype)
        self.blocks = nn.ModuleList(
            LlamaBlock(units, hidden, heads, kv_heads, device=device,
                       dtype=dtype)
            for _ in range(num_layers))
        self.norm = RMSNorm(units, device=device, dtype=dtype)
        self.lm_head = _linear(units, vocab_size, device, dtype)

    @property
    def device(self):
        return self.embed.weight.device

    def init_weights(self, generator=None, std=0.02):
        """Normal(0, std) for every matrix, ones for the norms — drawn from
        ``generator`` (which must live on the parameters' device)."""
        return init_weights(self, generator, std)

    def forward(self, tokens):
        # tokens: (B, L) integer -> logits (B, L, vocab)
        x = self.embed(tokens.long())
        for blk in self.blocks:
            x = blk(x)
        return self.lm_head(self.norm(x))


def _build(name, vocab_size, device, dtype):
    if name not in LLAMA_CONFIGS:
        raise MXNetError(
            f"unknown llama config {name!r}; options {sorted(LLAMA_CONFIGS)}")
    L, U, H, A, KV = LLAMA_CONFIGS[name]
    # parameters are allocated uninitialised on the target device (no
    # default init pass over 8B weights); callers fill them
    with torch.device("meta"):
        model = LlamaModel(vocab_size=vocab_size, num_layers=L, units=U,
                           hidden=H, heads=A, kv_heads=KV, dtype=dtype)
    return model.to_empty(device=device)


def llama_model(name="llama_tiny", vocab_size=32000, device=None,
                dtype=torch.float32, generator=None, init_std=0.02):
    """A zoo llama with random weights: Normal(0, ``init_std``) matrices
    from ``generator`` (seeded by the caller; it must live on ``device``).
    ``device=None`` is the current context's device (the CUDA card unless
    ``with mx.cpu():``)."""
    model = _build(name, vocab_size, resolve_device(device), dtype)
    model.init_weights(generator, init_std)
    return model
