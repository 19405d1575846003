"""Ring attention: sequence parallelism over a mesh axis on the flash
kernels — the port of ``mxnet_tpu/kernels/ring_attention.py``.

The sequence is split into n blocks, one a shard of the mesh axis.  Shard
i keeps q block i and sees the kv blocks come round the ring: at step s it
attends to kv block ``src = (i - s) % n``, the order the reference's
``ppermute`` rotation gives.  Each (q block, kv block) pair is one call of
the flash forward (``flash_attention._fwd``: the hand-written kernel on the
card, its plain version on the host), which returns the block's output and
log-sum-exp; the blocks merge in float32 exactly as the reference's
``_merge`` combines its partials, and the output is cast to q's dtype
once (the first block's partial is the block itself, as the reference's
merge into its empty partial gives).  Causal attention skips ``src > i``
(the reference's fully masked block, whose merge weight is exp(-1e30));
the diagonal block runs with the kernel's top-left causal mask (Lq = Lk
there), the blocks before it unmasked.  No dense score tile is built.

The backward is explicit (the reference gets it from ``ppermute``'s
transpose): for each pair the forward ran, ``flash_attention._bwd`` with
shard i's FINAL output and lse, so that p = exp(s - lse) is the global
softmax restricted to the block and delta = rowsum(dO * O) is the global
one.  dq sums on q's shard, dk and dv on the kv block's owner, in float32,
each cast to its input's dtype once.

Shards lie on the devices of the mesh axis (``DeviceMesh.axis_devices``);
a kv block moves to the shard that reads it with ``.to(device,
non_blocking=True)``, which is nothing when the shards share a card.
Batch and heads stay whole on every shard.

``sm_scale`` defaults to 1.0: the caller applies 1/sqrt(D).  Output rows
whose every key is masked are undefined (the reference gives finite
garbage there, the kernels 0).
"""

from __future__ import annotations

import torch

from ..telemetry import costmodel as _costmodel
from . import flash_attention as _fa

__all__ = ["ring_attention", "sequence_parallel_attention"]


def _merge(out_a, lse_a, out_b, lse_b):
    """Combine two normalized partials (out, lse) exactly, in float32:
    (out_a e^(lse_a - m) + out_b e^(lse_b - m)) / (the sum of the two
    weights), m the larger lse.  ``out_a`` (float32) is updated in
    place."""
    m = torch.maximum(lse_a, lse_b)
    ea, eb = torch.exp(lse_a - m), torch.exp(lse_b - m)
    denom = ea + eb
    out = out_a.mul_(ea[..., None]).add_(out_b * eb[..., None]) \
        .div_(denom[..., None])
    return out, m + torch.log(denom)


def _sources(i, n, causal):
    """The kv blocks shard i attends to, in ring-step order: step s brings
    block (i - s) % n; causal attention skips the blocks after i."""
    return [(i - s) % n for s in range(n) if not (causal and (i - s) % n > i)]


class _Ring(torch.autograd.Function):
    """Ring attention over n per-shard blocks: inputs are n q blocks, n k
    blocks, n v blocks, then (with segment ids) n seg_q and n seg_kv
    blocks; outputs the n output blocks."""

    @staticmethod
    def forward(ctx, n, causal, sm_scale, has_seg, *blocks):
        q, k, v = blocks[:n], blocks[n:2 * n], blocks[2 * n:3 * n]
        sq, skv = (blocks[3 * n:4 * n], blocks[4 * n:5 * n]) if has_seg \
            else ([None] * n, [None] * n)
        outs, lses = [], []
        for i in range(n):
            dev = q[i].device
            acc = lse = None
            for src in _sources(i, n, causal):
                kb, vb = (t[src].to(dev, non_blocking=True) for t in (k, v))
                sb = None if skv[src] is None \
                    else skv[src].to(dev, non_blocking=True)
                o, l = _fa._fwd(q[i], kb, vb, sq[i], sb,
                                causal and src == i, sm_scale)
                if acc is None:
                    # the reference merges into (0, -1e30) first: weights
                    # 0 and 1, the block itself
                    acc, lse = o.float(), l
                else:
                    acc, lse = _merge(acc, lse, o, l)
            outs.append(acc.to(q[i].dtype))
            lses.append(lse)
        ctx.n, ctx.causal, ctx.sm_scale, ctx.has_seg = \
            n, causal, sm_scale, has_seg
        # the backward of a CUDA graph runs on autograd's device thread,
        # which does not see the analysing thread's flag
        ctx.counted = _costmodel.counting()
        ctx.save_for_backward(*blocks, *outs, *lses)
        return tuple(outs)

    @staticmethod
    def backward(ctx, *douts):
        n, causal, sm_scale = ctx.n, ctx.causal, ctx.sm_scale
        saved = ctx.saved_tensors
        nin = 5 * n if ctx.has_seg else 3 * n
        q, k, v = saved[:n], saved[n:2 * n], saved[2 * n:3 * n]
        sq, skv = (saved[3 * n:4 * n], saved[4 * n:5 * n]) if ctx.has_seg \
            else ([None] * n, [None] * n)
        outs, lses = saved[nin:nin + n], saved[nin + n:nin + 2 * n]
        dq = [torch.zeros(t.shape, dtype=torch.float32, device=t.device)
              for t in q]
        dk = [torch.zeros(t.shape, dtype=torch.float32, device=t.device)
              for t in k]
        dv = [torch.zeros(t.shape, dtype=torch.float32, device=t.device)
              for t in v]
        for i in range(n):
            dev = q[i].device
            for src in _sources(i, n, causal):
                kb, vb = (t[src].to(dev, non_blocking=True) for t in (k, v))
                sb = None if skv[src] is None \
                    else skv[src].to(dev, non_blocking=True)
                gq, gk, gv = _fa._bwd(q[i], kb, vb, sq[i], sb, outs[i],
                                      lses[i], douts[i], causal and src == i,
                                      sm_scale, counted=ctx.counted)
                dq[i] += gq
                owner = k[src].device
                dk[src] += gk.to(owner, non_blocking=True)
                dv[src] += gv.to(owner, non_blocking=True)
        grads = [g.to(t.dtype) for g, t in zip(dq + dk + dv, q + k + v)]
        return (None, None, None, None, *grads,
                *([None] * (nin - 3 * n)))


def ring_attention(q, k, v, axis_name, seg_q=None, seg_kv=None,
                   causal=False, sm_scale=1.0):
    """Ring attention over the shards of one mesh axis, given as the
    shards' blocks: q, k, v are sequences of n (B, H, Lb, D) blocks, block
    i on shard i's device (the reference's per-device view inside
    ``shard_map``; ``axis_name`` names that axis); seg_q/seg_kv are
    sequences of n (B, Lb) int32 segment-id blocks or None (attend all;
    one side alone defaults the other to zeros of its own length).
    Returns the n output blocks, in q's dtype."""
    del axis_name           # the shards are the blocks given
    q, k, v = list(q), list(k), list(v)
    n = len(q)
    has_seg = seg_q is not None or seg_kv is not None
    segs = []
    if has_seg:
        if seg_q is None:
            seg_q = [torch.zeros(t.shape[0], t.shape[2], dtype=torch.int32,
                                 device=t.device) for t in q]
        if seg_kv is None:
            seg_kv = [torch.zeros(t.shape[0], t.shape[2], dtype=torch.int32,
                                  device=t.device) for t in k]
        segs = [t.to(torch.int32) for t in list(seg_q) + list(seg_kv)]
    return list(_Ring.apply(n, bool(causal), float(sm_scale), has_seg,
                            *q, *k, *v, *segs))


def sequence_parallel_attention(q, k, v, mesh, axis="sp", seg_q=None,
                                seg_kv=None, causal=False, sm_scale=1.0):
    """Ring attention over ``mesh``'s axis ``axis`` on whole (B, H, L, D)
    tensors (seg_q/seg_kv (B, L) int32 or None): L is split into one block
    a shard of the axis, each moved to its shard's device, and the output
    comes back on q's device, differentiable in q, k and v.  L must
    divide over the axis."""
    devices = mesh.axis_devices(axis)
    n = len(devices)
    L = q.shape[2]
    if L % n:
        raise ValueError(f"sequence length {L} must divide over "
                         f"{n} '{axis}' devices")
    if seg_q is not None or seg_kv is not None:
        # one-sided segment masks are legal: the absent side is all zeros
        if seg_q is None:
            seg_q = torch.zeros(q.shape[0], q.shape[2], dtype=torch.int32,
                                device=q.device)
        if seg_kv is None:
            seg_kv = torch.zeros(k.shape[0], k.shape[2], dtype=torch.int32,
                                 device=k.device)

    def split(t, dim):
        if t is None:
            return None
        return [b.to(d, non_blocking=True).contiguous()
                for b, d in zip(t.chunk(n, dim=dim), devices)]

    outs = ring_attention(split(q, 2), split(k, 2), split(v, 2), axis,
                          split(seg_q, 1), split(seg_kv, 1), causal,
                          sm_scale)
    return torch.cat([o.to(q.device, non_blocking=True) for o in outs],
                     dim=2)
