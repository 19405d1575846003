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

Tensor parallelism (Megatron): inside a sharded ``parallel.TrainStep``
whose placements split the weights over one model axis (not a data axis)
as ``sharding.llama_rules`` does (``apply_tp_shardings``; ``tp`` or the
axis name given), each decoder block computes per shard of that axis, tp
of them: the column-parallel q/k/v/gate/up chunks and
the row-parallel o/down chunks of shard k, attention over its ``heads/tp``
query heads and ``kv_heads/tp`` kv heads (GQA's repeat per shard: the
flash kernels at ``(B, heads/tp, L, hd)``), and the row-parallel partial
outputs summed over the shards.  The vocab-split token table looks up its
own rows (others read zeros) and sums; the vocab-split LM head's logits
are concatenated.  A block whose heads or kv heads tp does not divide,
or whose weights a model axis splits otherwise, gathers its weights at
use and computes the dense math.  The block's math is written once
(``_Shards``: the dense block is one shard).  ``TP_COUNTS``
counts the blocks' forwards that took each way (``"split"``,
``"gathered"``; a captured step's are counted at its capture).
"""

from __future__ import annotations

import functools

import torch

from ... import config
from ...base import MXNetError
from ...ndarray.ndarray import NDArray
from ..block import HybridBlock
from ..nn import Dense, Embedding
from ..parameter import _entered, _shard_view
from ..utils import remat_call

__all__ = ["RMSNorm", "LlamaBlock", "LlamaModel", "llama_model",
           "LLAMA_CONFIGS", "apply_tp_shardings", "TP_COUNTS"]

TP_COUNTS = {"split": 0, "gathered": 0}

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

    def _ways(self, view):
        """The shards this block computes over in ``view``: the one model
        axis that splits its weights the Megatron way (column-parallel
        q/k/v/gate/up by rows, row-parallel o/down by columns) where its
        size divides the heads and kv heads; else the block's own Dense
        children, which gather split weights at use (counted when a model
        axis splits them)."""
        if view is None:
            return _Shards()
        cols = (self.q_proj, self.k_proj, self.v_proj, self.gate, self.up)
        rows = (self.o_proj, self.down)
        axes = {view.model_axes(d.weight, 0) for d in cols} \
            | {view.model_axes(d.weight, 1) for d in rows}
        if len(axes) == 1:
            only = axes.pop()
            if len(only) == 1 and not (self._heads % view.size(only[0])
                                       or self._kv % view.size(only[0])):
                TP_COUNTS["split"] += 1
                return _Shards(view, only[0])
        if any(view.model_axes(d.weight, dim) for d in cols + rows
               for dim in (0, 1)):
            TP_COUNTS["gathered"] += 1
        return _Shards()

    def _attend(self, F, q, k, v):
        if self._attn_impl == "fused":
            return F.contrib.masked_att_qkv(
                q, k, v, None, num_kv_groups=self._heads // self._kv,
                causal=True)                               # (B, H, L, D)
        return F.contrib.sp_att_qkv(
            q, k, v, impl=self._attn_impl, axis=self._sp_axis,
            num_kv_groups=self._heads // self._kv, causal=True)

    def hybrid_forward(self, F, x):
        # x: (B, L, C) batch-major; shard k of n runs heads/n query heads,
        # kv_heads/n kv heads and hidden/n MLP units
        ways = self._ways(_shard_view())
        heads, kv = self._heads // ways.n, self._kv // ways.n

        def attn(h, k):
            h = ways.at(h, k)
            q = _rope(F, self._heads_of(
                F, ways.linear(F, self.q_proj, h, k, 0), heads))
            kk = _rope(F, self._heads_of(
                F, ways.linear(F, self.k_proj, h, k, 0), kv))
            v = self._heads_of(F, ways.linear(F, self.v_proj, h, k, 0), kv)
            ctx_vec = F.reshape(F.transpose(self._attend(F, q, kk, v),
                                            axes=(0, 2, 1, 3)),
                                shape=(0, 0, heads * self._hd))
            return ways.linear(F, self.o_proj, ctx_vec, k, 1)

        def mlp(h, k):
            h = ways.at(h, k)
            return ways.linear(
                F, self.down, F.silu(ways.linear(F, self.gate, h, k, 0))
                * ways.linear(F, self.up, h, k, 0), k, 1)

        h = self.attn_norm(x)
        x = x + ways.summed(attn(h, k) for k in range(ways.n))
        h = self.mlp_norm(x)
        return x + ways.summed(mlp(h, k) for k in range(ways.n))


class _Shards:
    """Where a forward's products run: over the ``n`` shards of the model
    axis ``axis`` of a sharded step's data shard ``view``, shard k's
    product with chunk k of a Dense's weight (rows: column-parallel, dim
    0; columns: row-parallel, dim 1) on shard k's device, partial results
    summed on the data shard's device; without a view, one shard: the
    Dense blocks themselves."""

    def __init__(self, view=None, axis=None):
        self.view, self.axis = view, axis
        self.n = 1 if view is None else view.size(axis)

    @classmethod
    def of_rows(cls, view, param):
        """The shards of the one model axis that splits ``param``'s rows
        (the token table and LM head by vocabulary), else one."""
        axes = () if view is None else view.model_axes(param, 0)
        return cls(view, axes[0]) if len(axes) == 1 else cls()

    def at(self, t, k):
        """``t`` on shard ``k``'s device."""
        return t if self.view is None else \
            t.to(self.view.tp_device(k, self.axis))

    def home(self, t):
        """``t`` on the data shard's device."""
        return t if self.view is None else t.to(self.view.device)

    def linear(self, F, dense, h, k, dim):
        """Shard ``k``'s product of ``h`` with ``dense``'s weight chunk
        along ``dim`` (no bias: the llama has none)."""
        if self.view is None:
            return dense(h)
        w = self.view.tp_part(dense.weight, dim, k, self.axis)
        return F.FullyConnected(h, w, None, num_hidden=w.shape[0],
                                flatten=False, no_bias=True)

    def summed(self, parts):
        total = None
        for part in parts:
            part = self.home(part)
            total = part if total is None else total + part
        return total

    def lookup(self, F, embed, tokens):
        """The rows of ``embed``'s table for ``tokens``: shard k looks up
        the tokens in its vocabulary rows (the others read zeros), and
        the parts are summed."""
        if self.view is None:
            return embed(tokens)
        rows = embed.weight.shape[0] // self.n

        def part(k):
            w = self.view.tp_part(embed.weight, 0, k, self.axis)
            local = tokens.to(w.device).long() - k * rows
            mine = (local >= 0) & (local < rows)
            out = F.Embedding(local.clamp(0, rows - 1), w, input_dim=rows,
                              output_dim=w.shape[1])
            return out * mine.unsqueeze(-1).to(out.dtype)
        return self.summed(part(k) for k in range(self.n))


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
        view = _shard_view()
        x = _Shards.of_rows(view, self.embed.weight).lookup(
            F, self.embed, tokens)
        for blk in self.blocks:
            # remat_call recomputes only while recording; else blk(x).  In
            # a sharded step the recompute (on autograd's thread) runs as
            # the same data shard
            if not self._remat:
                x = blk(x)
            elif view is None:
                x = remat_call(blk, x)
            else:
                x = remat_call(functools.partial(_as_shard, view, blk), x)
        h = self.norm(x)
        head = _Shards.of_rows(view, self.lm_head.weight)
        logits = [head.home(head.linear(F, self.lm_head, head.at(h, k), k, 0))
                  for k in range(head.n)]
        return logits[0] if head.n == 1 else F.concat(*logits, dim=-1)


def _as_shard(view, blk, x):
    with _entered(view):
        return blk(x)


def llama_model(name="llama_tiny", vocab_size=32000, **kwargs):
    """The zoo llama ``name`` (``LLAMA_CONFIGS``), not yet initialized;
    ``kwargs`` go to ``LlamaModel`` (``prefix``, ``attn_impl``, ...)."""
    if name not in LLAMA_CONFIGS:
        raise MXNetError(
            f"unknown llama config {name!r}; options {sorted(LLAMA_CONFIGS)}")
    L, U, H, A, KV = LLAMA_CONFIGS[name]
    return LlamaModel(vocab_size=vocab_size, num_layers=L, units=U,
                      hidden=H, heads=A, kv_heads=KV, **kwargs)


def apply_tp_shardings(model, axis="tp"):
    """Megatron tensor-parallel annotation for a LlamaModel — delegates
    to the declarative rule pack (``sharding.llama_rules``): q/k/v +
    gate/up + lm_head column-parallel, o_proj + down row-parallel, the
    token table over the vocab dim, norms replicated.  Dense weights are
    (out_features, in_features)."""
    from ... import sharding as _sh
    _sh.apply_rules(model, _sh.llama_rules(tp=axis))
    return model
