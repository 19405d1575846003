"""The port's samplers (``mx.nd.random.*``, ``sample_*``,
``mx.random.*``, ``shuffle``, ``gumbel_softmax``) held against the JAX
package's on the CPU.  Parity is in distribution, not bit for bit: the two
draw from different generators.

- seeded determinism: ``mx.random.seed(s)`` twice gives the same draws, two
  seeds different ones;
- shapes and dtypes equal to the reference's (``randint``'s "float32"
  gives int32 in both);
- moments and a goodness-of-fit test, for both packages at the same
  bounds: at 20000 draws per parameter set the sample mean and variance
  lie within 5 standard errors of the distribution's and the p-value of
  a Kolmogorov-Smirnov test (continuous distributions) or of Pearson's
  chi-square (discrete ones, where KS does not apply) is above 1e-3
  (``mxnet_tpu_torch.ops.sweep.sampler_cases`` and ``draw_stats``).
"""

import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from mxnet_tpu_torch.ops import sweep

N = 20000
CASES = {c[0]: c for c in sweep.sampler_cases(N)}
SMALL = {c[0]: c for c in sweep.sampler_cases(6)}


@pytest.fixture(autouse=True)
def _on_cpu():
    with mx.cpu():
        yield


def _draw(m, name, arrays, attrs):
    """The sampler's draws through ``m``'s registry, one row per parameter
    set (the argmax of gumbel_softmax)."""
    reg = m.ops.registry
    out = reg.invoke(reg.get(name), [m.nd.array(a) for a in arrays],
                     dict(attrs), ctx=m.cpu())
    out = out.asnumpy()
    return out.argmax(-1) if name == "gumbel_softmax" else out


@pytest.mark.parametrize("name", sorted(SMALL))
def test_seeded_determinism(name):
    _, arrays, attrs, _ = SMALL[name]
    mx.random.seed(7)
    a = _draw(mx, name, arrays, attrs)
    mx.random.seed(7)
    b = _draw(mx, name, arrays, attrs)
    mx.random.seed(8)
    c = _draw(mx, name, arrays, attrs)
    np.testing.assert_array_equal(a, b)
    if name != "random.bernoulli":          # 6 coin flips may repeat
        assert not np.array_equal(a, c)


@pytest.mark.parametrize("name", sorted(SMALL))
def test_shapes_and_dtypes_match_reference(name):
    _, arrays, attrs, _ = SMALL[name]
    got, want = _draw(mx, name, arrays, attrs), _draw(jmx, name, arrays,
                                                      attrs)
    assert got.shape == want.shape and got.dtype == want.dtype


@pytest.mark.parametrize("name", sorted(CASES))
@pytest.mark.parametrize("pkg", ["port", "reference"])
def test_moments_and_ks(name, pkg):
    m = mx if pkg == "port" else jmx
    _, arrays, attrs, dists = CASES[name]
    m.random.seed(3)
    rows = _draw(m, name, arrays, attrs).reshape(len(dists), -1)
    for row, dist in zip(rows, dists):
        mean_z, var_z, p = sweep.draw_stats(row, dist)
        assert abs(mean_z) < 5 and abs(var_z) < 5 and p > 1e-3, \
            (name, dist, mean_z, var_z, p)


def test_random_shorthands_and_dtypes():
    mx.random.seed(1)
    assert mx.random.uniform(low=0, high=2, shape=(3, 4)).shape == (3, 4)
    assert mx.random.normal(shape=(5,)).dtype == np.float32
    assert mx.random.randn(2, 3).shape == (2, 3)
    r = mx.random.randint(low=0, high=5, shape=(100,))
    assert r.dtype == np.int32 and 0 <= r.asnumpy().min() \
        and r.asnumpy().max() < 5
    assert mx.random.randint(low=0, high=5, shape=(2,),
                             dtype="int64").dtype == np.int64
    draws, logp = mx.nd.random.multinomial(
        mx.nd.array([[0.2, 0.8]]), shape=(4,), get_prob=True)
    assert draws.shape == (1, 4) and logp.shape == (1, 4)
    np.testing.assert_allclose(
        logp.asnumpy(), np.log(np.where(draws.asnumpy() == 1, 0.8, 0.2)),
        rtol=1e-6)


def test_shuffle_permutes_rows():
    x = np.arange(40, dtype=np.float32).reshape(10, 4)
    mx.random.seed(2)
    a = mx.random.shuffle(mx.nd.array(x)).asnumpy()
    mx.random.seed(2)
    b = mx.nd.shuffle(mx.nd.array(x)).asnumpy()
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(np.sort(a[:, 0]), x[:, 0])
    np.testing.assert_array_equal(a[:, 1:] - a[:, :1], x[:, 1:] - x[:, :1])
    assert not np.array_equal(a, x)


def test_gumbel_softmax_gradient_and_hard():
    logits = np.random.RandomState(0).randn(3, 5).astype(np.float32)
    x = mx.nd.array(logits)
    x.attach_grad()
    with mx.autograd.record():
        y = mx.nd.gumbel_softmax(x, tau=0.7)
        (y * mx.nd.array(np.arange(5, dtype=np.float32))).sum().backward()
    np.testing.assert_allclose(y.asnumpy().sum(-1), np.ones(3), rtol=1e-6)
    g = x.grad.asnumpy()
    assert np.isfinite(g).all() and np.abs(g).max() > 0
    np.testing.assert_allclose(g.sum(-1), np.zeros(3), atol=1e-5)
    h = mx.nd.gumbel_softmax(x, hard=True).asnumpy()
    np.testing.assert_array_equal(np.sort(h, -1)[:, -1], np.ones(3))
    np.testing.assert_array_equal(h.sum(-1), np.ones(3))
