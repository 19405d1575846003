"""Flash-attention forward: the hand-written CUDA kernel and its plain twin.

Counterpart of ``mxnet_tpu/kernels/flash_attention.py`` (forward half:
``_fwd``/``_fwd_single`` and their Pallas kernels, ``_canon_segs`` and the
public ``flash_attention``).  The kernel is ``csrc/flash_fwd.cu``, built for
``sm_90a`` at first use (``kernels/_build.py``).

Layout: q, k, v are (B, H, L, D); segment ids are (B, L) int32 and
attention flows only between positions with EQUAL ids.  Lq != Lk is
allowed.  Numeric contract (as the TPU kernel): the scale is folded into q
in q's dtype, masked logits are -1e30 and the running max starts at
``_M_FLOOR`` = -1e4, so fully-masked rows return 0 (the dense oracle
returns a uniform average there instead); out is in q's dtype and lse
(B, H, Lq) in float32.

Dispatch: a tensor on the CUDA card launches the kernel (or raises); a
tensor on the CPU runs :func:`flash_attention_reference`, the plain
PyTorch version of the same function.  There is no fallback from the card
to the plain version.
"""

from __future__ import annotations

import ctypes

import torch

from ..base import MXNetError

__all__ = ["flash_attention", "flash_attention_reference", "launches"]

_NEG_INF = -1e30
_M_FLOOR = -1e4
# kv rows per tile of the CUDA kernel (kBK in csrc/flash_fwd.cu): the plain
# version streams at this block to round p exactly where the kernel does
KV_TILE = 64

# kernel launches since the counter was last reset (chip_smoke.py resets it
# before driving the serving path and reads it after); only the wrapper's
# successful launches count
launches = 0

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_lib = None


def _kernel_lib():
    """The built ``flash_fwd`` library with its C signature declared."""
    global _lib
    if _lib is None:
        from ._build import load_kernel_library
        lib = load_kernel_library("flash_fwd")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.mx_flash_fwd.argtypes = [p, p, p, p, p, p, p, i, i, i, i, i, i,
                                     ctypes.c_float, i, p]
        lib.mx_flash_fwd.restype = i
        _lib = lib
    return _lib


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


def _mask(seg_q, seg_kv, causal, Lq, k0, bk, device):
    """(B or 1, 1, Lq, bk) bool mask of kv columns k0..k0+bk-1, or None."""
    mask = None
    if seg_q is not None:
        mask = seg_q[:, None, :, None] == seg_kv[:, None, None, k0:k0 + bk]
    if causal:
        qi = torch.arange(Lq, device=device)[:, None]
        ki = torch.arange(k0, k0 + bk, device=device)[None, :]
        cm = (qi >= ki)[None, None]
        mask = cm if mask is None else mask & cm
    return mask


def flash_attention_reference(q, k, v, seg_q=None, seg_kv=None,
                              causal=False, sm_scale=1.0, block_k=None):
    """Plain PyTorch version of the flash forward: returns (out, lse).

    Same numerics as the kernel (scale folded into q in q's dtype, -1e30
    masking, running max floored at -1e4, p rounded to v's dtype before
    the PV product, f32 accumulation, fully-masked rows -> 0).  With
    ``block_k`` the kv axis streams in blocks with the online-softmax
    update of the TPU ``_fwd_kernel``; by default the whole row is one
    block, as in ``_fwd_single_kernel``."""
    seg_q, seg_kv = _canon_segs(seg_q, seg_kv)
    Lq, Lk = q.shape[2], k.shape[2]
    qs = (q * torch.tensor(sm_scale, dtype=q.dtype)).float()
    bk = Lk if block_k is None else int(block_k)
    m = torch.full(q.shape[:3] + (1,), _M_FLOOR, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    for k0 in range(0, Lk, bk):
        kt = k[:, :, k0:k0 + bk]
        vt = v[:, :, k0:k0 + bk]
        s = torch.matmul(qs, kt.float().transpose(-1, -2))
        mask = _mask(seg_q, seg_kv, causal, Lq, k0, kt.shape[2], q.device)
        if mask is not None:
            s = s.masked_fill(~mask, _NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.exp(s - m_new)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + torch.matmul(p.to(v.dtype).float(), vt.float())
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
    global launches
    _check(q, k, v, seg_q, seg_kv)
    q, k, v = _dense(q), _dense(k), _dense(v)
    if seg_q is not None:
        seg_q, seg_kv = seg_q.contiguous(), seg_kv.contiguous()
    B, H, Lq, D = q.shape
    Lk = k.shape[2]
    out = torch.empty_like(q)
    lse = torch.empty((B, H, Lq), dtype=torch.float32, device=q.device)
    lib = _kernel_lib()
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


def flash_attention(q, k, v, seg_q=None, seg_kv=None, causal=False,
                    sm_scale=1.0):
    """Blockwise (flash) attention: softmax(scale * Q K^T + mask) V.

    q, k, v: (B, H, L, D); seg_q/seg_kv: (B, L) int32 segment ids (None =
    no masking).  Returns (B, H, Lq, D) in q's dtype.  Forward only: the
    backward kernels are not ported yet."""
    return _fwd(q, k, v, seg_q, seg_kv, causal, sm_scale)[0]
