"""Flash attention: the hand-written CUDA kernels and their plain twins.

Counterpart of ``mxnet_tpu/kernels/flash_attention.py``: ``_fwd``/
``_fwd_single`` and ``_bwd``/``_bwd_fused`` with their Pallas kernels,
``_pick_block``, ``_canon_segs`` and the public ``flash_attention``
(a ``jax.custom_vjp`` there, a ``torch.autograd.Function`` here).  The
kernels are ``csrc/flash_fwd.cu`` (forward) and ``csrc/flash_bwd.cu``
(fused, dq and dkv backward), built for ``sm_90a`` at first use
(``kernels/_build.py``).

Layout: q, k, v are (B, H, L, D); segment ids are (B, L) int32 and
attention flows only between positions with EQUAL ids.  Lq != Lk is
allowed.  Numeric contract (as the TPU kernels): the scale is folded into q
in q's dtype, masked logits are -1e30 and the running max starts at
``_M_FLOOR`` = -1e4, so fully-masked rows return 0 with zero gradients (the
dense oracle returns a uniform average there instead); out is in q's dtype
and lse (B, H, Lq) in float32.  The backward recomputes p = exp(s - lse)
and takes delta = rowsum(dO * O) in float32 from torch, as the reference
takes it from XLA.

Dispatch: a tensor on the CUDA card launches the kernels (or raises); a
tensor on the CPU runs :func:`flash_attention_reference` and
:func:`flash_attention_backward_reference`, the plain PyTorch versions of
the same functions.  There is no fallback from the card to the plain
versions.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from ..base import MXNetError

__all__ = ["flash_attention", "flash_attention_plain",
           "flash_attention_reference",
           "flash_attention_backward_reference", "kv_tile",
           "uses_tensor_cores", "launches", "bwd_fused_launches",
           "bwd_dq_launches", "bwd_dkv_launches", "fwd_wide_bf16_launches",
           "bwd_fused_wide_bf16_launches", "bwd_dq_wide_bf16_launches",
           "bwd_dkv_wide_bf16_launches", "fwd_f32_launches",
           "bwd_fused_f32_launches", "bwd_dq_f32_launches",
           "bwd_dkv_f32_launches"]

_NEG_INF = -1e30
_M_FLOOR = -1e4
# widest head_dim of the bf16 tensor-core kernels (tc::kMaxD in csrc/): the
# C entry points send bf16 calls with a wider head to the CUDA-core kernels
TC_MAX_D = 128

# launches of each kernel since its counter was last reset (chip_smoke.py
# resets them before driving a path and reads them after); only the
# wrappers' successful launches count
launches = 0              # flash_fwd
bwd_fused_launches = 0    # mx_flash_bwd_fused
bwd_dq_launches = 0       # mx_flash_bwd_dq
bwd_dkv_launches = 0      # mx_flash_bwd_dkv
# of those, the bf16 launches with head_dim > TC_MAX_D, which the C entry
# point runs on the CUDA-core kernel instead of the tensor cores
fwd_wide_bf16_launches = 0
bwd_fused_wide_bf16_launches = 0
bwd_dq_wide_bf16_launches = 0
bwd_dkv_wide_bf16_launches = 0
# and, apart, the f32 launches
fwd_f32_launches = 0
bwd_fused_f32_launches = 0
bwd_dq_f32_launches = 0
bwd_dkv_f32_launches = 0
# the names of the counters above; a replayed CUDA graph runs no Python, so
# parallel.TrainStep adds the counts its capture saw on each replay
COUNTERS = ("launches", "bwd_fused_launches", "bwd_dq_launches",
            "bwd_dkv_launches", "fwd_wide_bf16_launches",
            "bwd_fused_wide_bf16_launches", "bwd_dq_wide_bf16_launches",
            "bwd_dkv_wide_bf16_launches", "fwd_f32_launches",
            "bwd_fused_f32_launches", "bwd_dq_f32_launches",
            "bwd_dkv_f32_launches")
# sequence block of the reference's dispatch (_bwd's block_q = block_k):
# the fused backward runs iff each side is one such block
BWD_BLOCK = 512

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_libs = {}


def _declare(name, lib):
    """Declare the C signatures of library ``name``'s entry points."""
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    if name == "flash_fwd":
        lib.mx_flash_fwd.argtypes = [p, p, p, p, p, p, p, i, i, i, i, i, i,
                                     f, i, p]
        lib.mx_flash_fwd.restype = i
        return
    head = [p] * 8                       # q k v do lse delta seg_q seg_kv
    tail = [i, i, i, i, i, i, f, i, p]   # B H Lq Lk D causal scale dt s
    lib.mx_flash_bwd_dq.argtypes = head + [p] + tail
    lib.mx_flash_bwd_dkv.argtypes = head + [p, p] + tail
    lib.mx_flash_bwd_fused.argtypes = head + [p, p, p] + tail
    for fn in (lib.mx_flash_bwd_dq, lib.mx_flash_bwd_dkv,
               lib.mx_flash_bwd_fused):
        fn.restype = i


def _kernel_lib(name):
    """The library built from ``csrc/<name>.cu`` with its C signatures
    declared, built at the first launch of one of its kernels (so the
    forward never waits on, or fails with, the backward's source)."""
    if name not in _libs:
        from ._build import build_kernel_libraries
        lib = build_kernel_libraries([name])[name]
        _declare(name, lib)
        _libs[name] = lib
    return _libs[name]


def uses_tensor_cores(dtype, head_dim):
    """Whether the C entry points run (q's dtype, head_dim) on the bf16
    tensor-core kernels (flash_fwd and every flash_bwd kernel)."""
    return dtype == torch.bfloat16 and head_dim <= TC_MAX_D


def kv_tile(dtype, head_dim):
    """kv rows per tile of the forward kernel that takes (dtype, head_dim):
    128 on the tensor cores (tc::kBN), 64 on the CUDA cores (simt::kBK).
    p is rounded relative to the running max after each tile, so the
    plain version streams at this block to round p where the kernel does."""
    return 128 if uses_tensor_cores(dtype, head_dim) else 64


def _pick_block(L, want):
    """Largest of (want, 256, 128) that divides L, else L (the reference's
    sequence block, which decides fused vs split backward)."""
    for b in (want, 256, 128):
        if b <= L and L % b == 0:
            return b
    return L


def bwd_is_fused(Lq, Lk):
    """The reference's ``_bwd`` dispatch: the fused kernel iff both
    sequences are a single block, else the dq + dkv kernels."""
    return (_pick_block(Lq, BWD_BLOCK) == Lq
            and _pick_block(Lk, BWD_BLOCK) == Lk)


def _canon_segs(seg_q, seg_kv):
    if seg_q is None and seg_kv is None:
        return None, None
    if seg_q is None or seg_kv is None:
        # equality masking cannot express "one side all-valid" without
        # knowing the other side's ids
        raise ValueError(
            "flash_attention: pass BOTH seg_q and seg_kv or neither "
            "(one-sided segment ids have no well-defined mask)")
    return seg_q.to(torch.int32), seg_kv.to(torch.int32)


def _mask(seg_q, seg_kv, causal, q0, nq, k0, nk, device):
    """(B or 1, 1, nq, nk) bool mask of q rows q0.. against kv columns
    k0.. (absolute indices for the causal test), or None."""
    mask = None
    if seg_q is not None:
        mask = seg_q[:, None, q0:q0 + nq, None] \
            == seg_kv[:, None, None, k0:k0 + nk]
    if causal:
        qi = torch.arange(q0, q0 + nq, device=device)[:, None]
        ki = torch.arange(k0, k0 + nk, device=device)[None, :]
        cm = (qi >= ki)[None, None]
        mask = cm if mask is None else mask & cm
    return mask


def _product(a, b, tensor_cores):
    """a @ b over the last two dims, summed in float32: the reference's
    ``_bmm`` (operands in their dtype, ``preferred_element_type=f32``).

    With ``tensor_cores`` and bf16 operands on the card the product runs as
    ``torch.bmm(..., out_dtype=torch.float32)`` on the tensor cores, as the
    bf16 tensor-core kernels compute it, so the plain version rounds p and ds
    to bf16 after the same sums; otherwise in float32 (bf16 products are
    exact there), as the CUDA-core kernels and the CPU compute it."""
    if tensor_cores and a.is_cuda and a.dtype == b.dtype == torch.bfloat16:
        lead = a.shape[:-2]
        out = torch.bmm(a.reshape(-1, *a.shape[-2:]),
                        b.reshape(-1, *b.shape[-2:]), out_dtype=torch.float32)
        return out.reshape(*lead, a.shape[-2], b.shape[-1])
    return torch.matmul(a.float(), b.float())


def flash_attention_reference(q, k, v, seg_q=None, seg_kv=None,
                              causal=False, sm_scale=1.0, block_k=None):
    """Plain PyTorch version of the flash forward: returns (out, lse).

    Same numerics as the kernel (scale folded into q in q's dtype, -1e30
    masking, running max floored at -1e4, p rounded to v's dtype before
    the PV product, f32 accumulation, fully-masked rows -> 0; on the card
    the products of the tensor-core kernel's inputs run on the tensor
    cores, see :func:`_product`).  With ``block_k`` the kv axis streams in
    blocks with the online-softmax update of the TPU ``_fwd_kernel``; by
    default the whole row is one block, as in ``_fwd_single_kernel``."""
    seg_q, seg_kv = _canon_segs(seg_q, seg_kv)
    Lq, Lk = q.shape[2], k.shape[2]
    tc = uses_tensor_cores(q.dtype, q.shape[-1])
    qs = q * torch.tensor(sm_scale, dtype=q.dtype)
    bk = Lk if block_k is None else int(block_k)
    m = torch.full(q.shape[:3] + (1,), _M_FLOOR, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    for k0 in range(0, Lk, bk):
        kt = k[:, :, k0:k0 + bk]
        vt = v[:, :, k0:k0 + bk]
        s = _product(qs, kt.transpose(-1, -2), tc)
        mask = _mask(seg_q, seg_kv, causal, 0, Lq, k0, kt.shape[2],
                     q.device)
        if mask is not None:
            s = s.masked_fill(~mask, _NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.exp(s - m_new)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + _product(p.to(v.dtype), vt, tc)
        m = m_new
    safe_l = torch.where(l == 0.0, torch.ones_like(l), l)
    out = (acc / safe_l).to(q.dtype)
    lse = (m + torch.log(safe_l))[..., 0]
    return out, lse


def _check(q, k, v, seg_q, seg_kv):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise MXNetError("flash_attention wants (B, H, L, D) q, k, v")
    B, H, Lq, D = q.shape
    Lk = k.shape[2]
    if k.shape != (B, H, Lk, D) or v.shape != k.shape:
        raise MXNetError(
            f"flash_attention: k {tuple(k.shape)} / v {tuple(v.shape)} do "
            f"not match q {tuple(q.shape)}")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise MXNetError(
            f"flash_attention kernel takes float32 or bfloat16 q/k/v of one "
            f"dtype, got {q.dtype}/{k.dtype}/{v.dtype}")
    if D % 8 or not 8 <= D <= 256:
        raise MXNetError(
            f"flash_attention kernel takes head_dim a multiple of 8 up to "
            f"256, got {D}")
    if B > 65535 or H > 65535:
        raise MXNetError("flash_attention kernel: B and H must be <= 65535")
    devs = {t.device for t in (q, k, v)}
    if seg_q is not None:
        if seg_q.shape != (B, Lq) or seg_kv.shape != (B, Lk):
            raise MXNetError(
                f"segment ids must be (B, Lq)=({B}, {Lq}) and (B, Lk)="
                f"({B}, {Lk}), got {tuple(seg_q.shape)} and "
                f"{tuple(seg_kv.shape)}")
        devs |= {seg_q.device, seg_kv.device}
    if len(devs) != 1:
        raise MXNetError(f"flash_attention inputs on several devices: {devs}")


def _dense(t):
    """Contiguous, with the 16-byte aligned base the kernel's vector loads
    need (a contiguous view into a larger buffer may start anywhere)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _launch(q, k, v, seg_q, seg_kv, causal, sm_scale):
    """Run the CUDA kernel: returns (out, lse)."""
    global launches, fwd_wide_bf16_launches, fwd_f32_launches
    _check(q, k, v, seg_q, seg_kv)
    q, k, v = _dense(q), _dense(k), _dense(v)
    if seg_q is not None:
        seg_q, seg_kv = seg_q.contiguous(), seg_kv.contiguous()
    B, H, Lq, D = q.shape
    Lk = k.shape[2]
    out = torch.empty_like(q)
    lse = torch.empty((B, H, Lq), dtype=torch.float32, device=q.device)
    lib = _kernel_lib("flash_fwd")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.mx_flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if seg_q is None else seg_q.data_ptr(),
            None if seg_kv is None else seg_kv.data_ptr(),
            out.data_ptr(), lse.data_ptr(), B, H, Lq, Lk, D, int(causal),
            float(sm_scale), _DTYPE_CODE[q.dtype], stream)
    if rc != 0:
        raise MXNetError(f"flash_fwd kernel launch failed (code {rc}) at "
                         f"q {tuple(q.shape)} {q.dtype}")
    launches += 1
    fwd_wide_bf16_launches += _wide_bf16(q)
    fwd_f32_launches += q.dtype == torch.float32
    return out, lse


def _fwd(q, k, v, seg_q=None, seg_kv=None, causal=False, sm_scale=1.0):
    """Forward returning (out, lse): the kernel for CUDA tensors, the plain
    version for CPU tensors, an error for anything else."""
    seg_q, seg_kv = _canon_segs(seg_q, seg_kv)
    if q.is_cuda:
        return _launch(q, k, v, seg_q, seg_kv, causal, sm_scale)
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, seg_q, seg_kv, causal,
                                         sm_scale)
    raise MXNetError(f"flash_attention: no kernel for device {q.device}")


# --------------------------------------------------------------------------
# backward
# --------------------------------------------------------------------------

def _delta(out, do):
    """delta_i = rowsum(dO * O) in float32, (B, H, Lq)."""
    return (do.float() * out.float()).sum(dim=-1)


def flash_attention_backward_reference(q, k, v, seg_q, seg_kv, out, lse, do,
                                       causal=False, sm_scale=1.0,
                                       block_q=None, block_k=None):
    """Plain PyTorch version of the flash backward: returns (dq, dk, dv).

    The TPU kernels' rounding steps, spelled out: s = (q * scale in q's
    dtype) k^T with -1e30 masking, p = exp(s - lse), dp = dO v^T (dO in v's
    dtype), ds = p (dp - delta); dq sums (ds in k's dtype) k, dv sums
    (p in dO's dtype)^T dO, dk sums (ds in q's dtype)^T q with raw q; scale
    multiplies dq and dk once at the end; every sum is float32 and each
    gradient is cast to its input's dtype.  With ``block_q``/``block_k`` the
    work walks (q block, kv block) tiles in the order of the reference's
    split ``_dq_kernel``/``_dkv_kernel`` grids (kv innermost for dq, q
    innermost for dk/dv), skipping causal tiles that are wholly masked; by
    default one tile covers everything, as in ``_bwd_fused_kernel``.

    The products are computed as the kernels compute them
    (:func:`_product`): on the card, bf16 with head_dim <= TC_MAX_D (the
    tensor-core kernels, both routes) on the tensor cores, everything else
    in float32.  s, p and ds are formed once per tile, as the kernels form
    them, and feed dq, dk and dv alike."""
    seg_q, seg_kv = _canon_segs(seg_q, seg_kv)
    Lq, Lk = q.shape[2], k.shape[2]
    tc = uses_tensor_cores(q.dtype, q.shape[-1])
    bq = Lq if block_q is None else int(block_q)
    bk = Lk if block_k is None else int(block_k)
    delta = _delta(out, do)[..., None]
    lse = lse.float()[..., None]
    qs = q * torch.tensor(sm_scale, dtype=q.dtype)
    p_dtype, do = do.dtype, do.to(v.dtype)
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    dk = torch.zeros(k.shape, dtype=torch.float32, device=q.device)
    dv = torch.zeros(v.shape, dtype=torch.float32, device=q.device)
    for k0 in range(0, Lk, bk):
        ks = slice(k0, k0 + bk)
        for q0 in range(0, Lq, bq):
            qsl = slice(q0, q0 + bq)
            nq = min(bq, Lq - q0)
            if causal and q0 + nq - 1 < k0:
                continue                    # every entry of the tile masked
            mask = _mask(seg_q, seg_kv, causal, q0, nq, k0,
                         k[:, :, ks].shape[2], q.device)
            s = _product(qs[:, :, qsl], k[:, :, ks].transpose(-1, -2), tc)
            if mask is not None:
                s = s.masked_fill(~mask, _NEG_INF)
            p = torch.exp(s - lse[:, :, qsl])
            dp = _product(do[:, :, qsl], v[:, :, ks].transpose(-1, -2), tc)
            ds = p * (dp - delta[:, :, qsl])
            dq[:, :, qsl] += _product(ds.to(k.dtype), k[:, :, ks], tc)
            dv[:, :, ks] += _product(p.to(p_dtype).transpose(-1, -2),
                                     do[:, :, qsl], tc)
            dk[:, :, ks] += _product(ds.to(q.dtype).transpose(-1, -2),
                                     q[:, :, qsl], tc)
    scale = torch.tensor(sm_scale, dtype=torch.float32)
    return ((dq * scale).to(q.dtype), (dk * scale).to(k.dtype),
            dv.to(v.dtype))


class BwdInputs(NamedTuple):
    """The backward kernels' operands, checked, contiguous and on one card
    (what :func:`prepare_bwd` returns and every ``launch_bwd_*`` takes)."""
    q: torch.Tensor
    k: torch.Tensor
    v: torch.Tensor
    do: torch.Tensor
    lse: torch.Tensor
    delta: torch.Tensor
    seg_q: Optional[torch.Tensor]
    seg_kv: Optional[torch.Tensor]
    causal: bool
    sm_scale: float


def prepare_bwd(q, k, v, seg_q, seg_kv, out, lse, do, causal, sm_scale):
    """Check the backward's operands and compute delta = rowsum(dO * O)."""
    seg_q, seg_kv = _canon_segs(seg_q, seg_kv)
    _check(q, k, v, seg_q, seg_kv)
    if do.shape != q.shape or out.shape != q.shape \
            or lse.shape != q.shape[:3]:
        raise MXNetError(
            f"flash_attention backward: do {tuple(do.shape)} / out "
            f"{tuple(out.shape)} / lse {tuple(lse.shape)} do not match q "
            f"{tuple(q.shape)}")
    if seg_q is not None:
        seg_q, seg_kv = seg_q.contiguous(), seg_kv.contiguous()
    return BwdInputs(_dense(q), _dense(k), _dense(v), _dense(do.to(q.dtype)),
                     lse.float().contiguous(), _delta(out, do).contiguous(),
                     seg_q, seg_kv, bool(causal), float(sm_scale))


def _call_bwd(fn, x, outs, name):
    """Launch one backward entry point on x's stream with ``outs`` (data
    pointers) between the inputs and the sizes; raise on a refused
    launch."""
    B, H, Lq, D = x.q.shape
    ptr = [t.data_ptr() for t in (x.q, x.k, x.v, x.do, x.lse, x.delta)]
    ptr += [None if x.seg_q is None else x.seg_q.data_ptr(),
            None if x.seg_kv is None else x.seg_kv.data_ptr()]
    with torch.cuda.device(x.q.device):
        stream = torch.cuda.current_stream(x.q.device).cuda_stream
        rc = fn(*ptr, *outs, B, H, Lq, x.k.shape[2], D, int(x.causal),
                x.sm_scale, _DTYPE_CODE[x.q.dtype], stream)
    if rc != 0:
        raise MXNetError(f"{name} launch failed (code {rc}) at q "
                         f"{tuple(x.q.shape)} {x.q.dtype}")


def _wide_bf16(q):
    """Whether the C entry point runs q on a CUDA-core kernel although it
    is bf16 (head_dim > TC_MAX_D)."""
    return q.dtype == torch.bfloat16 \
        and not uses_tensor_cores(q.dtype, q.shape[-1])


def launch_bwd_fused(x):
    """``mx_flash_bwd_fused``: (dq, dk, dv) from one launch.  dq sums in an
    f32 workspace with atomics, in an order that changes from run to run;
    its scale and cast are torch ops."""
    global bwd_fused_launches, bwd_fused_wide_bf16_launches, \
        bwd_fused_f32_launches
    ws = torch.zeros(x.q.shape, dtype=torch.float32, device=x.q.device)
    dk, dv = torch.empty_like(x.k), torch.empty_like(x.v)
    _call_bwd(_kernel_lib("flash_bwd").mx_flash_bwd_fused, x,
              [ws.data_ptr(), dk.data_ptr(), dv.data_ptr()],
              "flash_bwd_fused")
    bwd_fused_launches += 1
    bwd_fused_wide_bf16_launches += _wide_bf16(x.q)
    bwd_fused_f32_launches += x.q.dtype == torch.float32
    # dq = round(ws * scale) in q's dtype, in one pass
    dq = torch.mul(ws, torch.tensor(x.sm_scale, dtype=torch.float32),
                   out=torch.empty_like(x.q))
    return dq, dk, dv


def launch_bwd_dq(x):
    """``mx_flash_bwd_dq``: dq."""
    global bwd_dq_launches, bwd_dq_wide_bf16_launches, bwd_dq_f32_launches
    dq = torch.empty_like(x.q)
    _call_bwd(_kernel_lib("flash_bwd").mx_flash_bwd_dq, x,
              [dq.data_ptr()], "flash_bwd_dq")
    bwd_dq_launches += 1
    bwd_dq_wide_bf16_launches += _wide_bf16(x.q)
    bwd_dq_f32_launches += x.q.dtype == torch.float32
    return dq


def launch_bwd_dkv(x):
    """``mx_flash_bwd_dkv``: (dk, dv)."""
    global bwd_dkv_launches, bwd_dkv_wide_bf16_launches, bwd_dkv_f32_launches
    dk, dv = torch.empty_like(x.k), torch.empty_like(x.v)
    _call_bwd(_kernel_lib("flash_bwd").mx_flash_bwd_dkv, x,
              [dk.data_ptr(), dv.data_ptr()], "flash_bwd_dkv")
    bwd_dkv_launches += 1
    bwd_dkv_wide_bf16_launches += _wide_bf16(x.q)
    bwd_dkv_f32_launches += x.q.dtype == torch.float32
    return dk, dv


def _bwd(q, k, v, seg_q, seg_kv, out, lse, do, causal=False, sm_scale=1.0):
    """Backward returning (dq, dk, dv): the kernels for CUDA tensors, the
    plain version (tiled as the reference tiles it) for CPU tensors, an
    error for anything else."""
    if q.is_cuda:
        x = prepare_bwd(q, k, v, seg_q, seg_kv, out, lse, do, causal,
                        sm_scale)
        if bwd_is_fused(q.shape[2], k.shape[2]):
            return launch_bwd_fused(x)
        return (launch_bwd_dq(x),) + launch_bwd_dkv(x)
    seg_q, seg_kv = _canon_segs(seg_q, seg_kv)
    if q.device.type == "cpu":
        Lq, Lk = q.shape[2], k.shape[2]
        return flash_attention_backward_reference(
            q, k, v, seg_q, seg_kv, out, lse, do, causal, sm_scale,
            _pick_block(Lq, BWD_BLOCK), _pick_block(Lk, BWD_BLOCK))
    raise MXNetError(f"flash_attention: no kernel for device {q.device}")


class _FlashAttention(torch.autograd.Function):
    """The reference's ``jax.custom_vjp``: forward saves q, k, v, the
    segment ids, out and lse; backward runs :func:`_bwd`."""

    @staticmethod
    def forward(ctx, q, k, v, seg_q, seg_kv, causal, sm_scale):
        out, lse = _fwd(q, k, v, seg_q, seg_kv, causal, sm_scale)
        ctx.save_for_backward(q, k, v, seg_q, seg_kv, out, lse)
        ctx.causal, ctx.sm_scale = causal, sm_scale
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, seg_q, seg_kv, out, lse = ctx.saved_tensors
        dq, dk, dv = _bwd(q, k, v, seg_q, seg_kv, out, lse, do, ctx.causal,
                          ctx.sm_scale)
        return dq, dk, dv, None, None, None, None


def flash_attention(q, k, v, seg_q=None, seg_kv=None, causal=False,
                    sm_scale=1.0):
    """Blockwise (flash) attention: softmax(scale * Q K^T + mask) V.

    q, k, v: (B, H, L, D); seg_q/seg_kv: (B, L) int32 segment ids (None =
    no masking).  Returns (B, H, Lq, D) in q's dtype.  Differentiable in
    q, k and v: the backward runs the fused kernel when each sequence is a
    single reference block (<= 512 or no 512/256/128 divisor), else the dq
    and dkv kernels."""
    seg_q, seg_kv = _canon_segs(seg_q, seg_kv)
    return _FlashAttention.apply(q, k, v, seg_q, seg_kv, causal, sm_scale)


class _FlashAttentionPlain(torch.autograd.Function):
    """:class:`_FlashAttention` with both directions bound to their plain
    versions on any device: the forward streams kv at the forward kernel's
    tile (:func:`kv_tile`), the backward walks the blocks the kernels'
    dispatch would (one tile when fused)."""

    @staticmethod
    def forward(ctx, q, k, v, seg_q, seg_kv, causal, sm_scale):
        out, lse = flash_attention_reference(
            q, k, v, seg_q, seg_kv, causal, sm_scale,
            block_k=kv_tile(q.dtype, q.shape[-1]))
        ctx.save_for_backward(q, k, v, seg_q, seg_kv, out, lse)
        ctx.causal, ctx.sm_scale = causal, sm_scale
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, seg_q, seg_kv, out, lse = ctx.saved_tensors
        Lq, Lk = q.shape[2], k.shape[2]
        blocks = (None, None) if bwd_is_fused(Lq, Lk) else \
            (_pick_block(Lq, BWD_BLOCK), _pick_block(Lk, BWD_BLOCK))
        dq, dk, dv = flash_attention_backward_reference(
            q, k, v, seg_q, seg_kv, out, lse, do, ctx.causal, ctx.sm_scale,
            *blocks)
        return dq, dk, dv, None, None, None, None


def flash_attention_plain(q, k, v, seg_q=None, seg_kv=None, causal=False,
                          sm_scale=1.0):
    """:func:`flash_attention` computed by the plain versions of its
    kernels on the tensors' own device, forward and backward: the twin the
    kernels are held against, which callers select only explicitly."""
    seg_q, seg_kv = _canon_segs(seg_q, seg_kv)
    return _FlashAttentionPlain.apply(q, k, v, seg_q, seg_kv, causal,
                                      sm_scale)
