"""Llama-style decoder LLM as Gluon HybridBlocks — the port of
``mxnet_tpu/gluon/model_zoo/llama.py`` (``RMSNorm``, ``LlamaBlock``,
``LlamaModel``, ``llama_model``) with the reference's prefixes, so
``collect_params()`` gives the reference's names (``tok_``, ``layer{i}_``,
``q_`` ... ``down_``, ``attn_norm_``, ``mlp_norm_``, ``final_norm_``,
``lm_head_``) and weights carry across by name (``convert.py``).

Architecture (Llama 3 family): pre-RMSNorm decoder blocks, rotary position
embeddings, grouped-query attention (kv_heads < heads), SwiGLU MLP, untied
LM head, causal masking.  Attention runs through
``F.contrib.masked_att_qkv`` like the reference's, so a flash-eligible
sequence takes the flash kernels on the card.  Dense weights are
(out_features, in_features), as in the reference.

A net is built without values; ``initialize(init, ctx=...)`` allocates
each Parameter on ``ctx`` and fills it there from that device's generator
(``mx.random``), so an 8B llama on the card makes no host copy.  Serving
needs no gradient buffers: set ``grad_req`` to ``"null"`` first
(``net.collect_params().setattr("grad_req", "null")``).  ``remat`` (None:
``MXNET_BACKWARD_DO_MIRROR``) recomputes each decoder block's activations
in the backward (``gluon.utils.remat_call`` per block while recording).
``attn_impl="ring"`` or ``"ulysses"`` runs attention through
``F.contrib.sp_att_qkv`` over the current mesh's axis ``sp_axis``
(``parallel.set_mesh``), local attention when no mesh carries it; the
parameters are the same as the fused net's.
"""

from __future__ import annotations

import torch

from ... import config
from ...base import MXNetError
from ...ndarray.ndarray import NDArray
from ..block import HybridBlock
from ..nn import Dense, Embedding
from ..utils import remat_call

__all__ = ["RMSNorm", "LlamaBlock", "LlamaModel", "llama_model",
           "LLAMA_CONFIGS"]

# name -> (layers, units, hidden, heads, kv_heads)
LLAMA_CONFIGS = {
    "llama3_8b": (32, 4096, 14336, 32, 8),
    "llama_tiny": (2, 64, 172, 4, 2),        # tests
    "llama_small": (4, 256, 688, 8, 4),
}


class RMSNorm(HybridBlock):
    """Root-mean-square norm (no mean subtraction, no bias), in f32."""

    def __init__(self, units, eps=1e-5, **kwargs):
        super().__init__(**kwargs)
        self._eps = eps
        with self.name_scope():
            self.weight = self.params.get("weight", shape=(units,),
                                          init="ones")

    def hybrid_forward(self, F, x, weight):
        xf = F.cast(x, dtype="float32")
        var = F.mean(xf * xf, axis=-1, keepdims=True)
        out = xf * F.rsqrt(var + self._eps)
        return F.cast(out * F.cast(weight, dtype="float32"), dtype=x.dtype)


def _rope_angles(pos, half, base):
    """Rotary angles (len(pos), half) for integer positions ``pos``."""
    inv = 1.0 / (base ** (torch.arange(0, half, device=pos.device).float()
                          / half))
    return pos.float()[:, None] * inv[None, :]


def _rope(F, x, base=500000.0):
    """Rotary embeddings over the last dim of x (B, H, L, D), a tensor
    (``F`` the tensor ops) or an NDArray (``F`` = ``mx.nd``): the cos and
    sin tables are constants of the shape, the rotation ``F``'s ops."""
    L, D = x.shape[2], x.shape[3]
    half = D // 2
    t = x._data if isinstance(x, NDArray) else x
    ang = _rope_angles(torch.arange(L, device=t.device), half, base)
    cos, sin = torch.cos(ang).to(t.dtype), torch.sin(ang).to(t.dtype)
    if isinstance(x, NDArray):
        cos, sin = NDArray(cos, x._ctx), NDArray(sin, x._ctx)
    return _rotate(F, x, cos, sin)


def _rotate(F, x, cos, sin):
    """Rotate the two halves of x's last dim by the angles whose ``cos``
    and ``sin`` broadcast against x[..., :half]."""
    D = x.shape[-1]
    x1 = F.slice_axis(x, axis=-1, begin=0, end=D // 2)
    x2 = F.slice_axis(x, axis=-1, begin=D // 2, end=D)
    return F.concat(x1 * cos - x2 * sin, x1 * sin + x2 * cos, dim=-1)


class LlamaBlock(HybridBlock):
    """One pre-norm decoder block; ``attn_impl`` is "fused" (the flash
    path of ``masked_att_qkv``), "ring" or "ulysses" (``sp_att_qkv`` over
    the current mesh's axis ``sp_axis``)."""

    def __init__(self, units, hidden, heads, kv_heads, attn_impl="fused",
                 sp_axis="sp", **kwargs):
        super().__init__(**kwargs)
        if units % heads or heads % kv_heads:
            raise MXNetError("units % heads and heads % kv_heads must be 0")
        if attn_impl not in ("fused", "ring", "ulysses"):
            raise MXNetError(
                f"attn_impl {attn_impl!r}: want fused|ring|ulysses")
        self._attn_impl = attn_impl
        self._sp_axis = sp_axis
        self._units = units
        self._heads = heads
        self._kv = kv_heads
        self._hd = units // heads
        with self.name_scope():
            self.q_proj = Dense(units, flatten=False, use_bias=False,
                                in_units=units, prefix="q_")
            self.k_proj = Dense(self._hd * kv_heads, flatten=False,
                                use_bias=False, in_units=units, prefix="k_")
            self.v_proj = Dense(self._hd * kv_heads, flatten=False,
                                use_bias=False, in_units=units, prefix="v_")
            self.o_proj = Dense(units, flatten=False, use_bias=False,
                                in_units=units, prefix="o_")
            self.gate = Dense(hidden, flatten=False, use_bias=False,
                              in_units=units, prefix="gate_")
            self.up = Dense(hidden, flatten=False, use_bias=False,
                            in_units=units, prefix="up_")
            self.down = Dense(units, flatten=False, use_bias=False,
                              in_units=hidden, prefix="down_")
            self.attn_norm = RMSNorm(units, prefix="attn_norm_")
            self.mlp_norm = RMSNorm(units, prefix="mlp_norm_")

    def _heads_of(self, F, x, n):
        """(B, L, n hd) -> (B, n, L, hd)."""
        return F.transpose(F.reshape(x, shape=(0, 0, n, self._hd)),
                           axes=(0, 2, 1, 3))

    def hybrid_forward(self, F, x):
        # x: (B, L, C) batch-major
        h = self.attn_norm(x)
        q = _rope(F, self._heads_of(F, self.q_proj(h), self._heads))
        k = _rope(F, self._heads_of(F, self.k_proj(h), self._kv))
        v = self._heads_of(F, self.v_proj(h), self._kv)
        if self._attn_impl == "fused":
            ctx_vec = F.contrib.masked_att_qkv(
                q, k, v, None, num_kv_groups=self._heads // self._kv,
                causal=True)                               # (B, H, L, D)
        else:
            ctx_vec = F.contrib.sp_att_qkv(
                q, k, v, impl=self._attn_impl, axis=self._sp_axis,
                num_kv_groups=self._heads // self._kv, causal=True)
        attn = self.o_proj(F.reshape(F.transpose(ctx_vec, axes=(0, 2, 1, 3)),
                                     shape=(0, 0, self._units)))
        x = x + attn
        h = self.mlp_norm(x)
        return x + self.down(F.silu(self.gate(h)) * self.up(h))


class LlamaModel(HybridBlock):
    """Token embedding, ``num_layers`` decoder blocks, the final norm and
    the LM head: ``forward(tokens (B, L))`` -> logits (B, L, vocab).
    ``remat`` (None: ``MXNET_BACKWARD_DO_MIRROR``) recomputes each block's
    activations in the backward instead of keeping them."""

    def __init__(self, vocab_size=128256, num_layers=2, units=64,
                 hidden=172, heads=4, kv_heads=2, attn_impl="fused",
                 sp_axis="sp", remat=None, **kwargs):
        super().__init__(**kwargs)
        if remat is None:
            remat = bool(config.get_int("MXNET_BACKWARD_DO_MIRROR", 0))
        self._remat = bool(remat)
        self._units = units
        with self.name_scope():
            self.embed = Embedding(vocab_size, units, prefix="tok_")
            self.blocks = []
            for i in range(num_layers):
                blk = LlamaBlock(units, hidden, heads, kv_heads,
                                 attn_impl=attn_impl, sp_axis=sp_axis,
                                 prefix=f"layer{i}_")
                self.register_child(blk, f"layer{i}")
                self.blocks.append(blk)
            self.norm = RMSNorm(units, prefix="final_norm_")
            self.lm_head = Dense(vocab_size, flatten=False, use_bias=False,
                                 in_units=units, prefix="lm_head_")

    def hybrid_forward(self, F, tokens):
        x = self.embed(tokens)
        for blk in self.blocks:
            # remat_call recomputes only while recording; else blk(x)
            x = remat_call(blk, x) if self._remat else blk(x)
        return self.lm_head(self.norm(x))


def llama_model(name="llama_tiny", vocab_size=32000, **kwargs):
    """The zoo llama ``name`` (``LLAMA_CONFIGS``), not yet initialized;
    ``kwargs`` go to ``LlamaModel`` (``prefix``, ``attn_impl``, ...)."""
    if name not in LLAMA_CONFIGS:
        raise MXNetError(
            f"unknown llama config {name!r}; options {sorted(LLAMA_CONFIGS)}")
    L, U, H, A, KV = LLAMA_CONFIGS[name]
    return LlamaModel(vocab_size=vocab_size, num_layers=L, units=U,
                      hidden=H, heads=A, kv_heads=KV, **kwargs)
