"""The port's ring attention (``kernels/ring_attention.py``) against the
reference's ``sequence_parallel_attention`` on 4 of the forced host
devices (``tests/conftest.py``).

The port's shards are 4 host Contexts of one process; on the CPU each
(q block, kv block) pair runs the flash forward's and backward's plain
versions.  The reference runs under ``jax.jit`` (called eagerly, its
``shard_map`` takes 10-50 s a call here).  Tolerances (float32): outputs
within 1e-5 of max |ref|, gradients within 1e-4 of max |ref| (the
reference sums dense score tiles, the port blockwise with an online
softmax).
"""

import importlib

import numpy as np
import pytest
import torch

import mxnet_tpu  # noqa: F401 - configures jax (x64, the host devices)
import jax
import jax.numpy as jnp
from mxnet_tpu import parallel as jparallel

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import parallel
from mxnet_tpu_torch.kernels import flash_attention as fa
from mxnet_tpu_torch.kernels import sequence_parallel_attention

# the modules (each package's kernels namespace exports the function
# ring_attention under the module's name)
jring = importlib.import_module("mxnet_tpu.kernels.ring_attention")
ring = importlib.import_module("mxnet_tpu_torch.kernels.ring_attention")

OUT_TOL = 1e-5
GRAD_TOL = 1e-4
N_SP = 4


def _meshes(n=N_SP):
    return (parallel.DeviceMesh((n,), ("sp",),
                                devices=[mx.cpu(i) for i in range(n)]),
            jax.sharding.Mesh(np.array(jax.devices()[:n]), ("sp",)))


def _qkv(seed, B=2, H=2, L=32, D=8):
    r = np.random.RandomState(seed)
    return [r.randn(B, H, L, D).astype(np.float32) for _ in range(3)]


def _reference(jmesh, **kw):
    """The reference's ring over ``jmesh``, jitted."""
    return jax.jit(lambda a, b, c, *segs: jring.sequence_parallel_attention(
        a, b, c, jmesh, "sp", *segs, **kw))


def _close(got, want, tol):
    err = np.abs(np.asarray(got) - np.asarray(want)).max()
    assert err <= tol * np.abs(np.asarray(want)).max(), err


@pytest.mark.parametrize("causal", [False, True])
def test_ring_matches_reference(causal):
    mesh, jmesh = _meshes()
    q, k, v = _qkv(0)
    got = sequence_parallel_attention(*map(torch.tensor, (q, k, v)), mesh,
                                      axis="sp", causal=causal, sm_scale=0.5)
    want = _reference(jmesh, causal=causal, sm_scale=0.5)(
        *map(jnp.asarray, (q, k, v)))
    assert got.shape == want.shape and got.dtype == torch.float32
    _close(got.numpy(), want, OUT_TOL)


@pytest.mark.parametrize("one_sided", [False, True])
def test_ring_segment_masks_match_reference(one_sided):
    """Two-sided ids (sample 0 padded after 20 positions) and kv-only ids
    (the last 8 keys padding; the q side defaults to zeros)."""
    mesh, jmesh = _meshes()
    q, k, v = _qkv(1)
    B, L = q.shape[0], q.shape[2]
    if one_sided:
        seg_q, seg_kv = None, np.zeros((B, L), np.int32)
        seg_kv[:, 24:] = 1
    else:
        seg_q = np.ones((B, L), np.int32)
        seg_q[0, 20:] = 0
        seg_kv = seg_q
    tq = None if seg_q is None else torch.tensor(seg_q)
    got = sequence_parallel_attention(*map(torch.tensor, (q, k, v)), mesh,
                                      seg_q=tq, seg_kv=torch.tensor(seg_kv),
                                      causal=True, sm_scale=0.7)
    want = _reference(jmesh, causal=True, sm_scale=0.7)(
        *map(jnp.asarray, (q, k, v)),
        None if seg_q is None else jnp.asarray(seg_q), jnp.asarray(seg_kv))
    _close(got.numpy(), want, OUT_TOL)


def test_ring_gradients_match_reference():
    mesh, jmesh = _meshes()
    q, k, v = _qkv(2, B=1, H=2, L=16)
    w = np.random.RandomState(3).randn(*q.shape).astype(np.float32)

    def jloss(a, b, c):
        o = jring.sequence_parallel_attention(a, b, c, jmesh, axis="sp",
                                              causal=True, sm_scale=0.7)
        return (o * w).sum()

    want = jax.jit(jax.grad(jloss, argnums=(0, 1, 2)))(
        *map(jnp.asarray, (q, k, v)))
    tq, tk, tv = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    out = sequence_parallel_attention(tq, tk, tv, mesh, causal=True,
                                      sm_scale=0.7)
    got = torch.autograd.grad((out * torch.tensor(w)).sum(), (tq, tk, tv))
    for g, r, name in zip(got, want, "qkv"):
        assert g.dtype == torch.float32, name
        _close(g.numpy(), r, GRAD_TOL)


@pytest.mark.parametrize("causal,fwd,bwd", [(True, 10, 10),
                                            (False, 16, 16)])
def test_ring_block_counts(monkeypatch, causal, fwd, bwd):
    """n(n+1)/2 causal blocks (n*n without the mask), each one flash call
    forward and one backward; the diagonal alone is causal."""
    calls = {"fwd": [], "bwd": []}
    real_fwd, real_bwd = fa._fwd, fa._bwd

    def count_fwd(*a, **kw):
        calls["fwd"].append(a[5])
        return real_fwd(*a, **kw)

    def count_bwd(*a, **kw):
        calls["bwd"].append(a[8])
        return real_bwd(*a, **kw)

    monkeypatch.setattr(fa, "_fwd", count_fwd)
    monkeypatch.setattr(fa, "_bwd", count_bwd)
    mesh, _ = _meshes()
    q, k, v = (torch.tensor(x, requires_grad=True) for x in _qkv(4, L=16))
    sequence_parallel_attention(q, k, v, mesh, causal=causal).sum() \
        .backward()
    assert len(calls["fwd"]) == fwd and len(calls["bwd"]) == bwd
    assert sum(calls["fwd"]) == sum(calls["bwd"]) == (N_SP if causal else 0)


def test_ring_rejects_indivisible_length_and_exports():
    mesh, jmesh = _meshes()
    x = torch.zeros(1, 1, 10, 8)
    with pytest.raises(ValueError, match="divide") as got:
        sequence_parallel_attention(x, x, x, mesh, axis="sp")
    with pytest.raises(ValueError) as want:
        jring.sequence_parallel_attention(jnp.zeros((1, 1, 10, 8)),
                                          jnp.zeros((1, 1, 10, 8)),
                                          jnp.zeros((1, 1, 10, 8)), jmesh,
                                          axis="sp")
    assert str(got.value) == str(want.value)
    assert parallel.attention is sequence_parallel_attention \
        is ring.sequence_parallel_attention
    assert parallel.ring_attention is ring.ring_attention
    assert jparallel.attention is jring.sequence_parallel_attention


def test_ring_attention_over_shard_blocks():
    """The per-shard entry point: lists of blocks in, blocks out, equal to
    the whole-tensor entry cut at the same places."""
    mesh, _ = _meshes()
    q, k, v = map(torch.tensor, _qkv(5))
    blocks = [list(t.chunk(N_SP, dim=2)) for t in (q, k, v)]
    outs = ring.ring_attention(*blocks, "sp", causal=True, sm_scale=0.5)
    whole = sequence_parallel_attention(q, k, v, mesh, causal=True,
                                        sm_scale=0.5)
    assert len(outs) == N_SP
    assert torch.equal(torch.cat(outs, dim=2), whole)
