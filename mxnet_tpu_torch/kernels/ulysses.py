"""Ulysses sequence parallelism: all-to-all head sharding — the port of
``mxnet_tpu/kernels/ulysses.py``.

Where the ring keeps the sequence split and moves kv blocks round the
shards, Ulysses re-shards once: shard i gives up its sequence block of
every head and takes head group i of the whole sequence (the reference's
tiled ``all_to_all``: head group i of every shard's block, concatenated
along L in shard order), runs attention over the full sequence for its
H/n heads through the port's ``flash_attention`` (the hand-written kernels
on the card; the reference computes the same function densely), and the
inverse exchange gives each shard its sequence block of every head back.
In one process the exchange is slicing, ``.to(device, non_blocking=True)``
(nothing when the shards share a card) and ``torch.cat``; gradients flow
through those ops and the flash Function.

H must divide over the axis; segment masks are the ring's
(``sequence_parallel_attention``).  ``scale``/``sm_scale`` default to 1.0:
the caller applies 1/sqrt(D).
"""

from __future__ import annotations

import torch

from .flash_attention import flash_attention

__all__ = ["ulysses_attention", "ulysses_sequence_parallel_attention"]


def ulysses_attention(q, k, v, axis_name, causal=False, scale=1.0):
    """Ulysses attention over the shards of one mesh axis, given as the
    shards' blocks: q, k, v are sequences of n (B, H, Lb, D) sequence
    blocks, block i on shard i's device (the reference's per-device view
    inside ``shard_map``; ``axis_name`` names that axis).  Returns the n
    output blocks (B, H, Lb, D) in q's dtype."""
    del axis_name           # the shards are the blocks given
    q, k, v = list(q), list(k), list(v)
    n = len(q)
    H = q[0].shape[1]
    if H % n:
        raise ValueError(f"ulysses: heads {H} not divisible by axis {n}")
    devices = [t.device for t in q]
    g = H // n

    def seq_to_heads(blocks):
        # shard i: head group i of every shard's block, in shard order
        return [torch.cat([b[:, i * g:(i + 1) * g].to(devices[i],
                                                       non_blocking=True)
                           for b in blocks], dim=2) for i in range(n)]

    qh, kh, vh = seq_to_heads(q), seq_to_heads(k), seq_to_heads(v)
    out = [flash_attention(a, b, c, causal=causal, sm_scale=scale)
           for a, b, c in zip(qh, kh, vh)]
    # the inverse: shard j takes its sequence block of every head group
    Lb = q[0].shape[2]
    return [torch.cat([o[:, :, j * Lb:(j + 1) * Lb].to(devices[j],
                                                        non_blocking=True)
                       for o in out], dim=1) for j in range(n)]


def ulysses_sequence_parallel_attention(q, k, v, mesh, axis="sp",
                                        seg_q=None, seg_kv=None,
                                        causal=False, sm_scale=1.0):
    """Ulysses attention over ``mesh``'s axis ``axis`` on whole (B, H, L, D)
    tensors, with the signature and defaults of the ring's
    ``sequence_parallel_attention``: L is split into one block a shard,
    and the output comes back on q's device, differentiable in q, k and
    v.  Segment masks raise: they are the ring's."""
    if seg_q is not None or seg_kv is not None:
        raise NotImplementedError(
            "ulysses: segment masking not implemented — use the ring "
            "strategy (sequence_parallel_attention) for segmented batches")
    devices = mesh.axis_devices(axis)
    n = len(devices)
    if q.shape[2] % n:
        raise ValueError(f"sequence length {q.shape[2]} must divide over "
                         f"{n} '{axis}' devices")

    def split(t):
        return [b.to(d, non_blocking=True)
                for b, d in zip(t.chunk(n, dim=2), devices)]

    outs = ulysses_attention(split(q), split(k), split(v), axis,
                             causal=causal, scale=sm_scale)
    return torch.cat([o.to(q.device, non_blocking=True) for o in outs],
                     dim=2)
