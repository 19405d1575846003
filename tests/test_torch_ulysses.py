"""The port's Ulysses attention (``kernels/ulysses.py``) against the
reference's ``ulysses_sequence_parallel_attention`` on 4 of the forced
host devices, and against the port's ring.

Each shard's head group runs the flash forward's and backward's plain
versions on the CPU; the reference computes the same attention densely.
Tolerances (float32): outputs within 1e-5 of max |ref|, gradients within
1e-4 of max |ref|.
"""

import numpy as np
import pytest
import torch

import mxnet_tpu  # noqa: F401 - configures jax (x64, the host devices)
import jax
import jax.numpy as jnp
from mxnet_tpu import parallel as jparallel
from mxnet_tpu.kernels.ulysses import \
    ulysses_sequence_parallel_attention as julysses

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import parallel
from mxnet_tpu_torch.kernels import flash_attention as fa
from mxnet_tpu_torch.kernels import sequence_parallel_attention
from mxnet_tpu_torch.kernels import ulysses
from mxnet_tpu_torch.kernels.ulysses import \
    ulysses_sequence_parallel_attention

OUT_TOL = 1e-5
GRAD_TOL = 1e-4
N_SP = 4


def _meshes():
    return (parallel.DeviceMesh((N_SP,), ("sp",),
                                devices=[mx.cpu(i) for i in range(N_SP)]),
            jparallel.DeviceMesh((N_SP,), ("sp",),
                                 devices=jax.devices()[:N_SP]))


def _qkv(seed, B=2, H=4, L=16, D=8):
    r = np.random.RandomState(seed)
    return [r.randn(B, H, L, D).astype(np.float32) for _ in range(3)]


def _close(got, want, tol):
    err = np.abs(np.asarray(got) - np.asarray(want)).max()
    assert err <= tol * np.abs(np.asarray(want)).max(), err


@pytest.mark.parametrize("causal", [False, True])
def test_ulysses_matches_reference(causal):
    mesh, jmesh = _meshes()
    q, k, v = _qkv(0)
    sc = 1.0 / q.shape[-1] ** 0.5
    got = ulysses_sequence_parallel_attention(
        *map(torch.tensor, (q, k, v)), mesh, axis="sp", causal=causal,
        sm_scale=sc)
    want = julysses(q, k, v, jmesh, axis="sp", causal=causal, sm_scale=sc)
    assert got.shape == want.shape and got.dtype == torch.float32
    _close(got.numpy(), want, OUT_TOL)


def test_ulysses_gradients_match_reference():
    mesh, jmesh = _meshes()
    q, k, v = _qkv(3)
    sc = 1.0 / q.shape[-1] ** 0.5
    w = np.random.RandomState(4).randn(*q.shape).astype(np.float32)
    want = jax.jit(jax.grad(lambda a, b, c: (julysses(
        a, b, c, jmesh, axis="sp", causal=True, sm_scale=sc) * w).sum(),
        argnums=(0, 1, 2)))(*map(jnp.asarray, (q, k, v)))
    tq, tk, tv = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    out = ulysses_sequence_parallel_attention(tq, tk, tv, mesh, causal=True,
                                              sm_scale=sc)
    got = torch.autograd.grad((out * torch.tensor(w)).sum(), (tq, tk, tv))
    for g, r in zip(got, want):
        _close(g.numpy(), r, GRAD_TOL)


def test_ulysses_matches_ring():
    mesh, _ = _meshes()
    q, k, v = map(torch.tensor, _qkv(5))
    sc = 1.0 / q.shape[-1] ** 0.5
    out_u = ulysses_sequence_parallel_attention(q, k, v, mesh, causal=True,
                                                sm_scale=sc)
    out_r = sequence_parallel_attention(q, k, v, mesh, causal=True,
                                        sm_scale=sc)
    _close(out_u.numpy(), out_r.numpy(), OUT_TOL)


def test_ulysses_calls_flash_once_a_shard(monkeypatch):
    """One flash forward and one backward a head group: n of each."""
    calls = {"fwd": 0, "bwd": 0}
    real_fwd, real_bwd = fa._fwd, fa._bwd

    def count(kind, fn):
        def wrapped(*a, **kw):
            calls[kind] += 1
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(fa, "_fwd", count("fwd", real_fwd))
    monkeypatch.setattr(fa, "_bwd", count("bwd", real_bwd))
    mesh, _ = _meshes()
    q, k, v = (torch.tensor(x, requires_grad=True) for x in _qkv(6))
    ulysses_sequence_parallel_attention(q, k, v, mesh, causal=True).sum() \
        .backward()
    assert calls == {"fwd": N_SP, "bwd": N_SP}
    blocks = [list(t.detach().chunk(N_SP, dim=2)) for t in (q, k, v)]
    outs = ulysses.ulysses_attention(*blocks, "sp", causal=True)
    assert len(outs) == N_SP and outs[0].shape == blocks[0][0].shape
    assert parallel.ulysses_attention is ulysses.ulysses_attention


def test_ulysses_rejects_bad_heads_and_segments():
    mesh, jmesh = _meshes()
    q = np.random.RandomState(0).randn(1, 3, 16, 8).astype(np.float32)
    with pytest.raises(ValueError, match="heads") as got:
        t = torch.tensor(q)
        ulysses_sequence_parallel_attention(t, t, t, mesh, axis="sp")
    with pytest.raises(Exception, match="heads") as want:
        julysses(q, q, q, jmesh, axis="sp")
    assert str(got.value) in str(want.value)
    seg = np.zeros((1, 16), np.int32)
    q = np.zeros((1, 4, 16, 8), np.float32)
    with pytest.raises(NotImplementedError) as got:
        t = torch.tensor(q)
        ulysses_sequence_parallel_attention(t, t, t, mesh,
                                            seg_q=torch.tensor(seg))
    with pytest.raises(NotImplementedError) as want:
        julysses(q, q, q, jmesh, seg_q=seg)
    assert str(got.value) == str(want.value)
