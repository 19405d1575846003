"""contrib operators — the port of ``mxnet_tpu/ops/contrib.py``: the fused
masked attention family (``_attend``, ``masked_selfatt``,
``masked_att_qkv``, ``masked_encdec_att``, ``multihead_attention``), the
unfused interleaved and multi-head score/value ops, and the small ops
(``div_sqrt_dim``, ``arange_like``, ``index_array``,
``gradient_multiplier``, ``quadratic``, ``allclose``, ``hawkes_ll``,
``fft``, ``ifft``, ``count_sketch``), ``ctc_loss`` and the box ops
``box_iou`` and ``box_nms``, and ``sp_att_qkv``, attention over a
sequence-parallel mesh axis.

``sp_att_qkv`` reads the mesh from ``parallel.current_mesh()`` at each
call: with no mesh, or one without its axis, it is the local
``masked_att_qkv`` with every position valid; else ring attention
(``kernels/ring_attention.py``) or Ulysses (``kernels/ulysses.py``) over
the axis's shards, on the flash kernels, the result back on q's device.

``box_nms`` (and the detection ops of ``vision.py``) suppress on the
tensors' device: ``greedy_nms`` builds the suppression matrix in blocks
and resolves the greedy order by matrix-vector sweeps, with one host check
a sweep and none a candidate (the reference runs a numpy loop on the
host).

``ctc_loss`` is ``torch.nn.functional.ctc_loss`` over the log-softmax of
the logits, one loss per sequence, with MXNet's conventions.  Where no
alignment exists (a label longer than its input can hold) it gives
``inf``; the reference (``optax.ctc_loss``) gives a large finite value
near 1e5 there.

``_attend`` picks flash attention whenever ``_flash_eligible`` holds
(seq >= MXNET_FLASH_MIN_SEQ, seq % 128 == 0, head_dim % 8 == 0), exactly
as the reference does on an accelerator; shorter sequences take the dense
fp32-softmax path.  Both carry gradients: flash through its autograd
Function (the backward kernels on the card), dense through torch autograd.
There is no compile probe: on the card the kernels build and launch or the
call raises.  ``masked_selfatt`` and ``masked_att_qkv`` are registered as
``contrib.masked_selfatt`` and ``contrib.masked_att_qkv``, the names Gluon
blocks call them by (``F.contrib.masked_selfatt``).

``masked_encdec_att`` (cross attention, Lq != Lk, padding on the keys only)
calls the flash kernels with ``seg_q`` all ones and ``seg_kv`` the padding
when both lengths are eligible and the tensors lie on the card, where the
reference forks on its TPU backend; a host tensor, or an ineligible
length, takes ``_dense_sdpa_cross``.  ``multihead_attention`` reaches the
kernels through ``_attend`` only when it is mask-free at self length, as in
the reference.  On a fully padded row (``valid_length`` 0) the kernels give
0 and the dense path the mean of ``v``.
"""

from __future__ import annotations

import torch

from .. import config
from ..kernels.flash_attention import flash_attention, flash_attention_plain
from ..base import MXNetError
from .registry import register

__all__ = ["masked_selfatt", "masked_att_qkv", "masked_encdec_att",
           "multihead_attention", "sp_att_qkv"]


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
    the kernel against its twin; nothing selects it automatically.  A
    ``meta`` tensor (``mx.sym``'s shape inference) gets an empty output of
    the right shape: nothing is computed and no kernel is asked for."""
    if q.device.type == "meta":
        return q.new_empty(q.shape[:3] + v.shape[3:])
    L, D = q.shape[2], q.shape[3]
    scale = 1.0 / float(D) ** 0.5
    seg = None if valid_length is None else _seg_of(valid_length, L,
                                                    q.device)
    if _flash_eligible(L, D):
        flash = flash_attention_plain if flash_reference else flash_attention
        return flash(q, k, v, seg, seg, causal, scale)
    return _dense_sdpa(q, k, v, seg, causal, scale)


def _seg_of(valid_length, L, device):
    """(B, L) int32 ids: 1 below each valid length, 0 past it."""
    steps = torch.arange(L, dtype=torch.int32, device=device)
    return (steps[None, :] < valid_length.to(torch.int32)[:, None]) \
        .to(torch.int32)


def _dense_sdpa_cross(q, k, v, seg_kv, scale, causal=False):
    """Cross attention with only KEY positions masked (``seg_kv`` (B, Lk);
    None: all valid), fp32 softmax, -1e9 masking; ``causal`` (Lq == Lk)
    adds the lower-triangular mask."""
    att = torch.einsum("bhqd,bhkd->bhqk", q, k).float() * scale
    neg = torch.tensor(-1e9, dtype=torch.float32, device=q.device)
    if seg_kv is not None:
        att = torch.where((seg_kv > 0)[:, None, None, :], att, neg)
    if causal:
        cm = torch.tril(torch.ones(att.shape[-2:], dtype=torch.bool,
                                   device=q.device))
        att = torch.where(cm[None, None], att, neg)
    p = torch.softmax(att, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bhkd->bhqd", p, v)


@register("contrib.masked_selfatt")
def masked_selfatt(qkv, valid_length=None, heads=1, causal=False):
    """Fused masked multi-head self-attention over the interleaved
    (L, B, 3 heads D) ``qkv``; ``valid_length`` (B,) masks positions >=
    valid_length[b] on both sides.  Returns the context (L, B, heads D)."""
    L, B, E = qkv.shape
    q, k, v = (t.permute(1, 2, 0, 3) for t in _split_interleaved(qkv, heads))
    out = _attend(q, k, v, valid_length, causal)           # (B, H, L, D)
    return out.permute(2, 0, 1, 3).reshape(L, B, E // 3)


@register("contrib.masked_att_qkv", promote="common")
def masked_att_qkv(q, k, v, valid_length=None, num_kv_groups=1,
                   causal=False):
    """Masked attention over separate (B, H, L, D) q/k/v.  k/v may carry
    fewer heads (GQA): each kv head serves ``num_kv_groups`` consecutive
    query heads (``repeat_interleave``, the reference's ``jnp.repeat``)."""
    if num_kv_groups > 1:
        k = torch.repeat_interleave(k, num_kv_groups, dim=1)
        v = torch.repeat_interleave(v, num_kv_groups, dim=1)
    return _attend(q, k, v, valid_length, causal)


@register("contrib.sp_att_qkv", promote="common")
def sp_att_qkv(q, k, v, impl="ring", axis="sp", num_kv_groups=1,
               causal=False):
    """Sequence-parallel attention over separate (B, H, L, D) q/k/v, every
    position valid: ``impl`` "ring" or "ulysses" over the current mesh's
    axis ``axis``, scale 1/sqrt(D); k/v may carry fewer heads (GQA, as
    ``masked_att_qkv``)."""
    from .. import parallel
    if num_kv_groups > 1:
        k = torch.repeat_interleave(k, num_kv_groups, dim=1)
        v = torch.repeat_interleave(v, num_kv_groups, dim=1)
    mesh = parallel.current_mesh()
    if mesh is None or axis not in mesh.axis_names \
            or q.device.type == "meta":
        return _attend(q, k, v, None, causal)
    scale = 1.0 / float(q.shape[3]) ** 0.5
    if impl == "ulysses":
        from ..kernels.ulysses import ulysses_sequence_parallel_attention \
            as attend
    else:
        from ..kernels.ring_attention import sequence_parallel_attention \
            as attend
    return attend(q, k, v, mesh, axis=axis, causal=causal, sm_scale=scale)


# -- the unfused interleaved and multi-head ops -------------------------------

@register("contrib.div_sqrt_dim")
def _div_sqrt_dim(data):
    return data / torch.sqrt(torch.tensor(float(data.shape[-1]),
                                          dtype=data.dtype,
                                          device=data.device))


def _inv_sqrt(d, like):
    """1 / sqrt(d) in ``like``'s dtype, as the reference scales q."""
    return 1.0 / torch.sqrt(torch.tensor(float(d), dtype=like.dtype,
                                         device=like.device))


@register("contrib.interleaved_matmul_selfatt_qk")
def _interleaved_matmul_selfatt_qk(qkv, heads=1):
    """Scaled scores (B heads, L, L) of the interleaved (L, B, 3 heads D)
    ``qkv``."""
    q, k, _ = _split_interleaved(qkv, heads)
    L = qkv.shape[0]
    return torch.einsum("qbhd,kbhd->bhqk", q * _inv_sqrt(q.shape[-1], q),
                        k).reshape(-1, L, L)


@register("contrib.interleaved_matmul_selfatt_valatt", promote="common")
def _interleaved_matmul_selfatt_valatt(qkv, att, heads=1):
    """(B heads, L, L) weights applied to the v of ``qkv`` -> (L, B,
    heads D)."""
    _, _, v = _split_interleaved(qkv, heads)
    L, B = qkv.shape[0], qkv.shape[1]
    a = att.reshape(B, heads, L, L)
    return torch.einsum("bhqk,kbhd->qbhd", a, v).reshape(L, B, -1)


def _kv_pair(kv, heads):
    """(Lk, B, 2 heads D) with [k, v] interleaved per head -> two (Lk, B,
    heads, D) views."""
    Lk, B, E2 = kv.shape
    x = kv.reshape(Lk, B, heads, 2, E2 // (2 * heads))
    return x[:, :, :, 0], x[:, :, :, 1]


@register("contrib.interleaved_matmul_encdec_qk", promote="common")
def _interleaved_matmul_encdec_qk(q, kv, heads=1):
    """Scaled scores (B heads, Lq, Lk) of q (Lq, B, heads D) against the k
    of the interleaved ``kv``."""
    Lq, B, E = q.shape
    qh = q.reshape(Lq, B, heads, E // heads)
    k, _ = _kv_pair(kv, heads)
    return torch.einsum("qbhd,kbhd->bhqk", qh * _inv_sqrt(E // heads, q),
                        k).reshape(-1, Lq, kv.shape[0])


@register("contrib.interleaved_matmul_encdec_valatt", promote="common")
def _interleaved_matmul_encdec_valatt(kv, att, heads=1):
    """(B heads, Lq, Lk) weights applied to the v of ``kv`` -> (Lq, B,
    heads D)."""
    _, v = _kv_pair(kv, heads)
    B, Lq = kv.shape[1], att.shape[1]
    a = att.reshape(B, heads, Lq, kv.shape[0])
    return torch.einsum("bhqk,kbhd->qbhd", a, v).reshape(Lq, B, -1)


def _split_heads(x, heads):
    """(L, B, H D) -> (B, H, L, D)."""
    L, B, E = x.shape
    return x.reshape(L, B, heads, E // heads).permute(1, 2, 0, 3)


def _merge_heads(x):
    """(B, H, L, D) -> (L, B, H D)."""
    B, H, L, D = x.shape
    return x.permute(2, 0, 1, 3).reshape(L, B, H * D)


@register("contrib.multihead_attention_qk", promote="common")
def _multihead_attention_qk(q, k, heads=1):
    """Scaled scores (B heads, Lq, Lk) of q (Lq, B, heads D) and k (Lk, B,
    heads D)."""
    qh, kh = _split_heads(q, heads), _split_heads(k, heads)
    att = torch.einsum("bhqd,bhkd->bhqk", qh * _inv_sqrt(qh.shape[-1], q),
                       kh)
    return att.reshape(-1, q.shape[0], k.shape[0])


@register("contrib.multihead_attention_valatt", promote="common")
def _multihead_attention_valatt(att, v, heads=1):
    """(B heads, Lq, Lk) weights applied to v (Lk, B, heads D)."""
    vh = _split_heads(v, heads)
    a = att.reshape(v.shape[1], heads, att.shape[1], att.shape[2])
    return _merge_heads(torch.einsum("bhqk,bhkd->bhqd", a, vh))


@register("contrib.multihead_attention", promote="common")
def multihead_attention(q, k, v, valid_length=None, heads=1, causal=False,
                        flash_reference=False):
    """Masked multi-head attention over separate time-major projections q
    (Lq, B, heads D), k and v (Lk, B, heads D) -> (Lq, B, heads D).

    ``valid_length`` (B,) masks KEY positions at or past the length;
    queries are always valid.  ``causal`` needs Lq == Lk.  Mask-free at
    self length it is ``_attend`` (the flash kernels once eligible);
    otherwise ``_dense_sdpa_cross``.  ``flash_reference`` as in
    ``_attend``."""
    if causal and q.shape[0] != k.shape[0]:
        raise MXNetError(
            "contrib.multihead_attention: causal=True needs Lq == Lk "
            f"(got {q.shape[0]} vs {k.shape[0]})")
    qh, kh, vh = (_split_heads(t, heads) for t in (q, k, v))
    scale = 1.0 / float(qh.shape[-1]) ** 0.5
    if valid_length is None and q.shape[0] == k.shape[0]:
        out = _attend(qh, kh, vh, None, causal, flash_reference)
    elif valid_length is None:
        out = _dense_sdpa_cross(qh, kh, vh, None, scale)
    else:
        seg_kv = _seg_of(valid_length, k.shape[0], q.device)
        out = _dense_sdpa_cross(qh, kh, vh, seg_kv, scale, causal=causal)
    return _merge_heads(out)


@register("contrib.masked_encdec_att", promote="common")
def masked_encdec_att(q, kv, valid_length=None, heads=1,
                      flash_reference=False):
    """Masked encoder-decoder attention: decoder queries q (Lq, B, heads D)
    against the interleaved per-head [k, v] of ``kv`` (Lk, B, 2 heads D);
    ``valid_length`` (B,) masks encoder padding keys (queries are all
    valid).  Returns (Lq, B, heads D).

    On the card, with both lengths eligible, the flash kernels run with
    ``seg_q`` all ones and ``seg_kv`` the padding (Lq != Lk allowed);
    otherwise ``_dense_sdpa_cross``.  ``flash_reference`` binds the flash
    call to its plain version, as in ``_attend``."""
    Lq, B, E = q.shape
    D = E // heads
    Lk = kv.shape[0]
    qh = q.reshape(Lq, B, heads, D).permute(1, 2, 0, 3)
    k, v = _kv_pair(kv, heads)
    kh, vh = k.permute(1, 2, 0, 3), v.permute(1, 2, 0, 3)
    scale = 1.0 / float(D) ** 0.5
    if valid_length is None:
        seg_q = seg_kv = None
    else:
        seg_kv = _seg_of(valid_length, Lk, q.device)
        seg_q = torch.ones((B, Lq), dtype=torch.int32, device=q.device)
    if _flash_eligible(Lq, D) and _flash_eligible(Lk, D) and q.is_cuda:
        flash = flash_attention_plain if flash_reference else flash_attention
        out = flash(qh, kh, vh, seg_q, seg_kv, False, scale)
    else:
        out = _dense_sdpa_cross(qh, kh, vh, seg_kv, scale)
    return out.permute(2, 0, 1, 3).reshape(Lq, B, E)


# -- small contrib ops --------------------------------------------------------

@register("contrib.arange_like", differentiable=False)
def _arange_like(data, start=0.0, step=1.0, repeat=1, axis=None):
    """start + step * [0, n) in float32, n the size of ``data`` (of its
    ``axis``), each value ``repeat`` times."""
    n = data.numel() if axis is None else data.shape[axis]
    r = start + step * torch.arange(n, dtype=torch.float32,
                                    device=data.device)
    return torch.repeat_interleave(r, repeat) if repeat != 1 else r


@register("contrib.index_array", differentiable=False)
def _index_array(data, axes=None):
    """int64 coordinates of each element over ``axes`` (every axis when
    None): shape (sizes of axes) + (len(axes),)."""
    axes = tuple(axes) if axes is not None else tuple(range(data.ndim))
    grids = torch.meshgrid(*[torch.arange(data.shape[a], device=data.device)
                             for a in axes], indexing="ij")
    return torch.stack(grids, dim=-1).to(torch.int64)


class _GradientMultiplier(torch.autograd.Function):
    """Identity forward; the gradient times ``scalar``."""

    @staticmethod
    def forward(ctx, x, scalar):
        ctx.scalar = scalar
        return x.clone()

    @staticmethod
    def backward(ctx, g):
        return g * ctx.scalar, None


@register("contrib.gradient_multiplier")
def _gradient_multiplier(data, scalar=1.0):
    return _GradientMultiplier.apply(data, scalar)


def _corner(b):
    """(x, y, w, h) center boxes -> (x0, y0, x1, y1) corners."""
    x, y, w, h = b.unbind(-1)
    return torch.stack([x - w / 2, y - h / 2, x + w / 2, y + h / 2], -1)


@register("contrib.box_iou", differentiable=False)
def _box_iou(lhs, rhs, format="corner"):
    """IoU of every box of ``lhs`` (..., N, 4) with every box of ``rhs``
    (..., M, 4): (..., N, M), over the union plus 1e-12."""
    if format == "center":
        lhs, rhs = _corner(lhs), _corner(rhs)
    l, r = lhs[..., :, None, :], rhs[..., None, :, :]
    wh = (torch.minimum(l[..., 2:], r[..., 2:])
          - torch.maximum(l[..., :2], r[..., :2])).clamp(min=0)
    inter = wh[..., 0] * wh[..., 1]
    area_l = (l[..., 2] - l[..., 0]) * (l[..., 3] - l[..., 1])
    area_r = (r[..., 2] - r[..., 0]) * (r[..., 3] - r[..., 1])
    return inter / (area_l + area_r - inter + 1e-12)


# IoU entries of one block of the suppression matrix
_NMS_BLOCK_ELEMS = 1 << 24


def greedy_nms(boxes, valid, thresh, iou_fn, classes=None):
    """Greedy non-maximum suppression on the boxes' device.

    ``boxes`` (B, K, 4) are candidates in rank order (best first),
    ``valid`` (B, K) marks the real ones; candidate k is kept iff it is
    valid and no kept candidate ranked before it has ``iou_fn`` IoU above
    ``thresh`` with it (and, with ``classes`` (B, K), the same class).
    Returns ``keep`` (B, K) bool.

    The candidates go in blocks of rows of the suppression matrix (at most
    ``_NMS_BLOCK_ELEMS`` IoU entries a block).  A block first drops what
    the kept candidates of earlier blocks suppress, then resolves the
    greedy order inside itself by the fixed point keep = alive & not
    (keep @ S), S the block's strictly upper-triangular suppression
    matrix: a Jacobi sweep from keep = alive settles one more rank each
    sweep at least, and its fixed point is the greedy result.  Each sweep
    is one batched matrix-vector product on the device and one host check
    of convergence (sweeps = the depth of the longest suppression chain
    plus one, not one per candidate)."""
    B, K = valid.shape
    keep = torch.zeros_like(valid)
    step = max(1, min(K, _NMS_BLOCK_ELEMS // max(B * K, 1)))
    mm = torch.float16 if boxes.is_cuda else torch.float32

    def hits(lo, hi, s, e):
        """(B, hi - lo, e - s): candidates [lo, hi) suppress [s, e)."""
        h = iou_fn(boxes[:, lo:hi], boxes[:, s:e]) > thresh
        if classes is not None:
            h &= classes[:, lo:hi, None] == classes[:, None, s:e]
        return h

    for s in range(0, K, step):
        e = min(K, s + step)
        alive = valid[:, s:e]
        if s:
            alive = alive & ~(hits(0, s, s, e) & keep[:, :s, None]).any(1)
        inner = hits(s, e, s, e).to(mm).triu(1)
        x = alive
        while True:
            sup = torch.bmm(x.to(mm)[:, None, :], inner)[:, 0] > 0
            nxt = alive & ~sup
            if torch.equal(nxt, x):
                break
            x = nxt
        keep[:, s:e] = x
    return keep


def compact_rows(rows, keep, n_out, fill=-1.0):
    """The kept ``rows`` (B, K, W) of each batch entry, in order, at the
    top of a (B, n_out, W) array of ``fill`` (at most n_out of them)."""
    B, K, W = rows.shape
    pos = torch.cumsum(keep.to(torch.int64), 1) - 1
    dest = torch.where(keep & (pos < n_out), pos, n_out)
    out = torch.full((B, n_out + 1, W), fill, dtype=rows.dtype,
                     device=rows.device)
    out.scatter_(1, dest[..., None].expand(B, K, W), rows)
    return out[:, :n_out]


@register("contrib.box_nms", differentiable=False)
def _box_nms(data, overlap_thresh=0.5, valid_thresh=0.0, topk=-1,
             coord_start=2, score_index=1, id_index=-1, background_id=-1,
             force_suppress=False, in_format="corner", out_format="corner"):
    """Greedy NMS over the rows of ``data`` (..., M, W): rows with a score
    above ``valid_thresh``, best first, the first ``topk`` of them (all if
    <= 0); a kept row suppresses every later one whose corner box
    overlaps it by more than ``overlap_thresh`` (with ``id_index`` >= 0
    and not ``force_suppress``: only rows of its class).  The kept rows
    come first, in score order, the rest are -1.  Ties in score keep the
    rows' order.  The reference ignores ``background_id``, ``in_format``
    and ``out_format``; the port raises on a value other than the
    default."""
    if background_id != -1 or in_format != "corner" \
            or out_format != "corner":
        raise MXNetError(
            "contrib.box_nms: background_id, in_format and out_format are "
            "ignored by the reference; only their defaults (-1, 'corner', "
            "'corner') are supported")
    shape = data.shape
    x = data.reshape(-1, shape[-2], shape[-1])
    B, M, W = x.shape
    scores = x[..., score_index]
    valid = scores > valid_thresh
    order = torch.sort(torch.where(valid, scores, float("-inf")), dim=1,
                       descending=True, stable=True).indices
    K = M if topk <= 0 else min(int(topk), M)
    order = order[:, :K]
    rows = torch.gather(x, 1, order[..., None].expand(B, K, W))
    classes = rows[..., id_index] if id_index >= 0 and not force_suppress \
        else None
    keep = greedy_nms(rows[..., coord_start:coord_start + 4],
                      torch.gather(valid, 1, order), overlap_thresh,
                      _box_iou, classes)
    return compact_rows(rows, keep, M).reshape(shape)


@register("contrib.quadratic")
def _quadratic(data, a=0.0, b=0.0, c=0.0):
    return a * data * data + b * data + c


@register("contrib.allclose", differentiable=False, promote="common")
def _allclose(a, b, rtol=1e-5, atol=1e-8, equal_nan=False):
    """1.0 when every element of ``a`` is close to ``b``, compared in
    their promoted dtype, else 0.0 (a float32 scalar)."""
    close = torch.isclose(a, b, rtol=rtol, atol=atol,
                          equal_nan=equal_nan).all()
    return close.to(torch.float32)


@register("contrib.hawkes_ll", num_outputs=2)
def _hawkes_ll(lda, alpha, beta, state, lags, marks, valid_length,
               max_time):
    """Log-likelihood (N,) of marked Hawkes processes and their final
    state (N, K): lda (N, K) base rates, alpha and beta (K,), state (N, K),
    lags and marks (N, T), valid_length and max_time (N,)."""
    K = lda.shape[-1]
    N, T = lags.shape
    mk = (marks.long().unsqueeze(-1) == torch.arange(
        K, device=marks.device)).to(lags.dtype)
    steps = torch.arange(T, device=lags.device)
    valid = (steps[None, :] < valid_length[:, None]).to(lags.dtype)
    st = state
    ll = torch.zeros(N, dtype=lags.dtype, device=lags.device)
    for t in range(T):
        st = st * torch.exp(-beta * lags[:, t, None])
        lam = torch.sum((lda + alpha * st) * mk[:, t], dim=-1)
        ll = ll + valid[:, t] * torch.log(lam.clamp(min=1e-37))
        st = st + mk[:, t]
    return ll - torch.sum(lda * max_time[:, None], dim=-1), st


@register("contrib.fft")
def _fft(data, compute_size=128):  # noqa: ARG001 (a cuFFT batching knob)
    """FFT along the last axis of real ``data``, real and imaginary parts
    interleaved: the last axis doubles (float32)."""
    f = torch.fft.fft(data.float(), dim=-1)
    return torch.stack([f.real, f.imag], dim=-1).reshape(
        data.shape[:-1] + (2 * data.shape[-1],))


@register("contrib.ifft")
def _ifft(data, compute_size=128):  # noqa: ARG001
    """The inverse of ``fft``, unnormalized: interleaved (..., 2 n) in,
    the real part (..., n) times n out (float32)."""
    n = data.shape[-1] // 2
    x = data.float().reshape(data.shape[:-1] + (n, 2))
    c = torch.complex(x[..., 0], x[..., 1])
    return torch.fft.ifft(c, dim=-1).real * n


@register("contrib.count_sketch")
def _count_sketch(data, h, s, out_dim=16):
    """(N, d) data projected onto ``out_dim`` buckets by hash ``h`` (d,)
    with signs ``s`` (d,)."""
    idx = h.long().reshape(-1)
    sign = s.to(data.dtype).reshape(-1)
    oh = (idx[:, None] == torch.arange(out_dim, device=data.device)[None, :]) \
        .to(data.dtype)
    return (data * sign[None, :]) @ oh


@register("ctc_loss", host_f32=True)
def _ctc_loss(data, label, data_lengths=None, label_lengths=None,
              use_data_lengths=False, use_label_lengths=False,
              blank_label="first"):
    """Connectionist temporal classification loss of (T, N, C) logits
    against (N, L) labels, one value per sequence.  ``blank_label="first"``:
    the blank is class 0 and a label of 0 pads; ``"last"``: the blank is
    class C - 1 and -1 pads.  ``data_lengths`` / ``label_lengths`` (with
    ``use_*_lengths``) give each sequence's lengths instead."""
    T, N, C = data.shape
    labels = label.long()
    if use_data_lengths and data_lengths is not None:
        in_len = data_lengths.long()
    else:
        in_len = torch.full((N,), T, dtype=torch.long, device=data.device)
    if use_label_lengths and label_lengths is not None:
        tgt_len = label_lengths.long()
    else:
        tgt_len = (labels != (0 if blank_label == "first" else -1)).sum(1)
    blank = C - 1 if blank_label == "last" else 0
    return torch.nn.functional.ctc_loss(
        torch.log_softmax(data, dim=-1), labels.clamp(0, C - 1), in_len,
        tgt_len, blank=blank, reduction="none")
