"""Paged-KV attention — the serving engine's decode-step attention core.

Counterpart of ``mxnet_tpu/kernels/paged_attention.py`` (plain tensor code
there too: no Pallas kernel backs it).  The KV cache is a pool of
fixed-size blocks of ``block_tokens`` positions; every sequence owns a row
of a block table mapping its logical positions to pool blocks.  Numerics
mirror ``ops.contrib._dense_sdpa``: scores in the input dtype, cast to
f32, ``-1e9`` masking, f32 softmax, cast back.

Unlike the JAX functions, which return new pools, the ``write_kv*``
functions update the pools IN PLACE (and return them): the pools are the
largest serving state and a copy per token would double their traffic.

Shape glossary (one layer):
    k_pool, v_pool : (num_blocks, block_tokens, kv_heads, head_dim)
    block_table    : (B, max_blocks) integer pool indices per sequence
    ctx_len        : (B,) positions readable (current included)
    q              : (B, heads, q_len, head_dim)

Block 0 of every pool is the SCRATCH block: inactive slots point their
whole table at it and pad positions write there, so freed blocks can be
re-issued without zeroing.
"""

from __future__ import annotations

import torch

__all__ = ["paged_attention", "paged_attention_multi", "write_kv",
           "write_kv_multi", "write_kv_prefill", "SCRATCH_BLOCK"]

# pool index reserved for discarded writes (inactive slots, pad positions)
SCRATCH_BLOCK = 0


def _paged_gather_attend(q, k_pool, v_pool, block_table, readable,
                         num_kv_groups, sm_scale):
    """Gather + masked-softmax core: ``readable`` is the (B, Lq) per-query
    count of readable pool positions."""
    B, H, Lq, D = q.shape
    _, T, KV, _ = k_pool.shape
    MB = block_table.shape[1]
    S = MB * T
    table = block_table.long()
    # gather: (B, MB, T, KV, D) -> (B, KV, S, D), head-major like _attend
    k = k_pool[table].reshape(B, S, KV, D).permute(0, 2, 1, 3)
    v = v_pool[table].reshape(B, S, KV, D).permute(0, 2, 1, 3)
    if num_kv_groups > 1:
        k = torch.repeat_interleave(k, num_kv_groups, dim=1)
        v = torch.repeat_interleave(v, num_kv_groups, dim=1)
    scale = sm_scale if sm_scale is not None else 1.0 / float(D) ** 0.5
    att = torch.einsum("bhqd,bhkd->bhqk", q, k).float() * scale
    pos = torch.arange(S, device=q.device)
    mask = pos[None, None, None, :] < readable.long()[:, None, :, None]
    att = torch.where(mask, att, torch.tensor(-1e9, dtype=torch.float32,
                                              device=q.device))
    p = torch.softmax(att, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bhkd->bhqd", p, v)


def paged_attention(q, k_pool, v_pool, block_table, ctx_len,
                    num_kv_groups=1, sm_scale=None):
    """Attention of ``q`` (B, H, Lq, D) against the paged K/V of each
    sequence; ``ctx_len`` (B,) counts readable positions (the caller writes
    the current token's k/v first).  GQA rides ``num_kv_groups`` = H /
    kv_heads.  Returns (B, H, Lq, D)."""
    readable = ctx_len[:, None].expand(q.shape[0], q.shape[2])
    return _paged_gather_attend(q, k_pool, v_pool, block_table, readable,
                                num_kv_groups, sm_scale)


def paged_attention_multi(q, k_pool, v_pool, block_table, pos0,
                          num_kv_groups=1, sm_scale=None):
    """Multi-query paged attention: query j of sequence b sits at position
    ``pos0[b] + j`` and attends every pool position <= its own."""
    K = q.shape[2]
    readable = pos0.long()[:, None] + torch.arange(1, K + 1,
                                                   device=pos0.device)[None]
    return _paged_gather_attend(q, k_pool, v_pool, block_table, readable,
                                num_kv_groups, sm_scale)


def _scatter(k_pool, v_pool, idx, k_new, v_new):
    """Write rows ``idx`` of the flattened (N*T, KV, D) pools in place."""
    N, T, KV, D = k_pool.shape
    k_pool.view(N * T, KV, D)[idx] = k_new.reshape(-1, KV, D).to(k_pool.dtype)
    v_pool.view(N * T, KV, D)[idx] = v_new.reshape(-1, KV, D).to(v_pool.dtype)
    return k_pool, v_pool


def write_kv(k_pool, v_pool, block_table, pos, k_new, v_new, valid=None):
    """Scatter one token's k/v (B, KV, D) per sequence at logical position
    ``pos`` (B,).  ``valid`` (B,) bool, when given, routes invalid rows'
    writes to the scratch block.  Updates the pools in place; returns them.
    """
    T = k_pool.shape[1]
    table = block_table.long()
    pos = pos.long()
    MB = table.shape[1]
    bi = pos // T
    blk = torch.gather(table, 1, bi.clamp(max=MB - 1)[:, None])[:, 0]
    idx = blk * T + pos % T
    if valid is not None:
        ok = valid.bool() & (bi < MB)
        idx = torch.where(ok, idx, SCRATCH_BLOCK * T + pos % T)
    return _scatter(k_pool, v_pool, idx, k_new, v_new)


def write_kv_multi(k_pool, v_pool, block_table, pos0, n_valid,
                   k_new, v_new):
    """Scatter a K-token chunk's k/v (B, K, KV, D) at positions
    ``pos0[b] + j``; columns ``j >= n_valid[b]`` and positions past the
    block table go to the scratch block.  Updates the pools in place."""
    T = k_pool.shape[1]
    table = block_table.long()
    MB = table.shape[1]
    K = k_new.shape[1]
    cols = torch.arange(K, device=k_new.device)
    pos = pos0.long()[:, None] + cols[None]                     # (B, K)
    bi = pos // T
    blk = torch.gather(table, 1, bi.clamp(max=MB - 1))
    ok = (cols[None] < n_valid.long()[:, None]) & (bi < MB)
    idx = torch.where(ok, blk * T + pos % T, SCRATCH_BLOCK * T + pos % T)
    return _scatter(k_pool, v_pool, idx.reshape(-1), k_new, v_new)


def write_kv_prefill(k_pool, v_pool, block_table_row, valid_len,
                     k_new, v_new):
    """Scatter a whole (padded) prompt's k/v (P, KV, D) into one
    sequence's blocks; positions >= ``valid_len`` (padding) go to the
    scratch block.  Updates the pools in place; returns them."""
    T = k_pool.shape[1]
    row = block_table_row.long()
    P = k_new.shape[0]
    pos = torch.arange(P, device=k_new.device)
    blk = row[(pos // T).clamp(max=row.shape[0] - 1)]
    idx = torch.where(pos < int(valid_len), blk * T + pos % T,
                      SCRATCH_BLOCK * T + pos % T)
    return _scatter(k_pool, v_pool, idx, k_new, v_new)
