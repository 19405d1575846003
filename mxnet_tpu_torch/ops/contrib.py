"""Fused masked attention — the port of ``mxnet_tpu/ops/contrib.py``'s
attention core (``_split_interleaved``, ``_flash_eligible``,
``_dense_sdpa``, ``_attend``, ``masked_selfatt``, ``masked_att_qkv``).

``_attend`` picks flash attention whenever ``_flash_eligible`` holds
(seq >= MXNET_FLASH_MIN_SEQ, seq % 128 == 0, head_dim % 8 == 0), exactly
as the reference does on an accelerator; shorter sequences take the dense
fp32-softmax path.  Both carry gradients: flash through its autograd
Function (the backward kernels on the card), dense through torch autograd.
There is no compile probe: on the card the kernels build and launch or the
call raises.
"""

from __future__ import annotations

import torch

from .. import config
from ..kernels.flash_attention import (flash_attention,
                                       flash_attention_reference)

__all__ = ["masked_selfatt", "masked_att_qkv"]


def _split_interleaved(qkv, heads):
    """(L, B, 3 H D) with q/k/v interleaved per head ([q_h0, k_h0, v_h0,
    q_h1, ...], the reference transformer.cc layout) -> three (L, B, H, D)
    views."""
    L, B, E = qkv.shape
    x = qkv.reshape(L, B, heads, 3, E // (3 * heads))
    return x[:, :, :, 0], x[:, :, :, 1], x[:, :, :, 2]


def _flash_eligible(seq, head_dim):
    """Whether the flash kernel's tiling applies to these shapes."""
    if not config.get_int("MXNET_FUSED_ATTENTION", 1):
        return False
    floor = config.get_int("MXNET_FLASH_MIN_SEQ", 256)
    return seq >= floor and seq % 128 == 0 and head_dim % 8 == 0


def _dense_sdpa(q, k, v, seg, causal, scale):
    """Masked softmax(QK^T)V, fp32 softmax, -1e9 masking — the dense path
    below the flash floor."""
    att = torch.einsum("bhqd,bhkd->bhqk", q, k).float() * scale
    neg = torch.tensor(-1e9, dtype=torch.float32, device=q.device)
    if seg is not None:
        mask = seg[:, None, :, None] == seg[:, None, None, :]
        att = torch.where(mask, att, neg)
    if causal:
        L = att.shape[-1]
        cm = torch.tril(torch.ones((L, L), dtype=torch.bool,
                                   device=q.device))
        att = torch.where(cm[None, None], att, neg)
    p = torch.softmax(att, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bhkd->bhqd", p, v)


def _attend(q, k, v, valid_length, causal, flash_reference=False):
    """Masked attention on (B, H, L, D) tensors.

    ``valid_length=None`` means every position is valid (no segment ids).
    ``flash_reference=True`` binds the flash path to its plain PyTorch
    version instead of the kernel — an explicit request used only to hold
    the kernel against its twin; nothing selects it automatically."""
    L, D = q.shape[2], q.shape[3]
    scale = 1.0 / float(D) ** 0.5
    if valid_length is None:
        seg = None
    else:
        steps = torch.arange(L, dtype=torch.int32, device=q.device)
        seg = (steps[None, :] < valid_length.to(torch.int32)[:, None]) \
            .to(torch.int32)                        # (B, L): 1=valid, 0=pad
    if _flash_eligible(L, D):
        if flash_reference:
            return flash_attention_reference(q, k, v, seg, seg, causal,
                                             scale)[0]
        return flash_attention(q, k, v, seg, seg, causal, scale)
    return _dense_sdpa(q, k, v, seg, causal, scale)


def masked_selfatt(qkv, valid_length=None, heads=1, causal=False):
    """Fused masked multi-head self-attention over the interleaved
    (L, B, 3 heads D) ``qkv``; ``valid_length`` (B,) masks positions >=
    valid_length[b] on both sides.  Returns the context (L, B, heads D)."""
    L, B, E = qkv.shape
    q, k, v = (t.permute(1, 2, 0, 3) for t in _split_interleaved(qkv, heads))
    out = _attend(q, k, v, valid_length, causal)           # (B, H, L, D)
    return out.permute(2, 0, 1, 3).reshape(L, B, E // 3)


def masked_att_qkv(q, k, v, valid_length=None, num_kv_groups=1,
                   causal=False):
    """Masked attention over separate (B, H, L, D) q/k/v.  k/v may carry
    fewer heads (GQA): each kv head serves ``num_kv_groups`` consecutive
    query heads (``repeat_interleave``, the reference's ``jnp.repeat``)."""
    if num_kv_groups > 1:
        k = torch.repeat_interleave(k, num_kv_groups, dim=1)
        v = torch.repeat_interleave(v, num_kv_groups, dim=1)
    return _attend(q, k, v, valid_length, causal)
