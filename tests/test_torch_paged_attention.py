"""The port's paged attention and KV writes held against the JAX package
on the same pools and tables (inputs made with numpy from a seed).

Attention: f32 tolerance 1e-5 (same math, other summation order).  Writes
are pure copies, so the written pools must match exactly — outside the
scratch block, where several discarded writes may land on one row in an
unspecified order in either framework.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from mxnet_tpu.kernels import paged_attention as jpa
from mxnet_tpu_torch.kernels import paged_attention as tpa

N, T, KV, D = 12, 4, 2, 8
H, MB, B = 4, 3, 3


def _pools(seed=0):
    r = np.random.RandomState(seed)
    return (r.randn(N, T, KV, D).astype(np.float32),
            r.randn(N, T, KV, D).astype(np.float32))


# three sequences over disjoint blocks; the last slot is parked on scratch
TABLES = np.array([[3, 7, 1], [5, 2, 9], [0, 0, 0]], np.int32)


def _both(fn_j, fn_t, *args):
    """Call the JAX and torch versions on the same numpy arguments."""
    ja = [jnp.asarray(a) if isinstance(a, np.ndarray) else a for a in args]
    ta = [torch.tensor(a) if isinstance(a, np.ndarray) else a for a in args]
    return fn_j(*ja), fn_t(*ta)


@pytest.mark.parametrize("groups", [1, 2])
def test_paged_attention_matches_jax(groups):
    kp, vp = _pools(1)
    r = np.random.RandomState(2)
    q = r.randn(B, KV * groups, 1, D).astype(np.float32)
    ctx = np.array([9, 5, 1], np.int32)
    j, t = _both(
        lambda *a: jpa.paged_attention(*a, num_kv_groups=groups,
                                       sm_scale=0.3),
        lambda *a: tpa.paged_attention(*a, num_kv_groups=groups,
                                       sm_scale=0.3),
        q, kp, vp, TABLES, ctx)
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0, atol=1e-5)


def test_paged_attention_multi_matches_jax():
    kp, vp = _pools(3)
    r = np.random.RandomState(4)
    q = r.randn(B, H, 3, D).astype(np.float32)
    pos0 = np.array([4, 0, 2], np.int32)
    j, t = _both(
        lambda *a: jpa.paged_attention_multi(*a, num_kv_groups=2),
        lambda *a: tpa.paged_attention_multi(*a, num_kv_groups=2),
        q, kp, vp, TABLES, pos0)
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0, atol=1e-5)


def _assert_pools_equal(j, t):
    for jp, tp in zip(j, t):
        np.testing.assert_array_equal(tp.numpy()[1:], np.asarray(jp)[1:])


@pytest.mark.parametrize("with_valid", [False, True])
def test_write_kv_matches_jax(with_valid):
    kp, vp = _pools(5)
    r = np.random.RandomState(6)
    kn = r.randn(B, KV, D).astype(np.float32)
    vn = r.randn(B, KV, D).astype(np.float32)
    pos = np.array([6, 11, 0], np.int32)    # 11 sits past a 3-block table
    valid = np.array([True, False, True]) if with_valid else None
    j, t = _both(
        lambda kp, vp, tb, p, k, v: jpa.write_kv(
            kp, vp, tb, p, k, v,
            valid=None if valid is None else jnp.asarray(valid)),
        lambda kp, vp, tb, p, k, v: tpa.write_kv(
            kp, vp, tb, p, k, v,
            valid=None if valid is None else torch.tensor(valid)),
        kp, vp, TABLES, pos, kn, vn)
    _assert_pools_equal(j, t)


def test_write_kv_multi_matches_jax():
    kp, vp = _pools(7)
    r = np.random.RandomState(8)
    K = 3
    kn = r.randn(B, K, KV, D).astype(np.float32)
    vn = r.randn(B, K, KV, D).astype(np.float32)
    pos0 = np.array([2, 10, 0], np.int32)   # slot 1 runs off its table
    n_valid = np.array([3, 3, 1], np.int32)
    j, t = _both(jpa.write_kv_multi, tpa.write_kv_multi,
                 kp, vp, TABLES, pos0, n_valid, kn, vn)
    _assert_pools_equal(j, t)


def test_write_kv_prefill_matches_jax():
    kp, vp = _pools(9)
    r = np.random.RandomState(10)
    P = 12
    kn = r.randn(P, KV, D).astype(np.float32)
    vn = r.randn(P, KV, D).astype(np.float32)
    j, t = _both(jpa.write_kv_prefill, tpa.write_kv_prefill,
                 kp, vp, TABLES[1], 7, kn, vn)
    _assert_pools_equal(j, t)


def test_writes_update_pools_in_place():
    kp, vp = (torch.tensor(p) for p in _pools(11))
    out = tpa.write_kv(kp, vp, torch.tensor(TABLES), torch.tensor([1, 2, 3]),
                       torch.ones(B, KV, D), torch.ones(B, KV, D))
    assert out[0] is kp and out[1] is vp
    assert torch.all(kp[3, 1] == 1.0)
