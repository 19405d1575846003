"""The port's ``mx.autograd`` held against the JAX package's, on the CPU:
each case runs the same code on the same inputs through ``mxnet_tpu`` and
``mxnet_tpu_torch`` (``with mx.cpu():``) and compares the gradients.
Mirrors ``tests/test_autograd.py``; the error cases must raise
``MXNetError`` in both packages.

Tolerance: gradients rtol 1e-5 (the same formulas; the two frameworks may
fold constants in another order).
"""

import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx

PKGS = (jmx, mx)


@pytest.fixture(autouse=True)
def _on_cpu():
    with mx.cpu():
        yield


def _both(fn, rtol=1e-5):
    """fn(package) on both packages; the numpy results must agree."""
    jax_out, port_out = fn(jmx), fn(mx)
    if not isinstance(jax_out, (list, tuple)):
        jax_out, port_out = [jax_out], [port_out]
    for j, p in zip(jax_out, port_out):
        np.testing.assert_allclose(np.asarray(p), np.asarray(j), rtol=rtol,
                                   atol=0)
    return port_out


X = np.random.RandomState(0).uniform(0.5, 2.0, (3,)).astype(np.float32)


def test_basic_backward():
    def run(m):
        x = m.nd.array(X)
        x.attach_grad()
        with m.autograd.record():
            y = (x * x).sum()
        y.backward()
        return x.grad.asnumpy()
    np.testing.assert_allclose(_both(run)[0], 2 * X, rtol=1e-6)


def test_chain_and_fanout():
    def run(m):
        x = m.nd.array([2.0])
        x.attach_grad()
        with m.autograd.record():
            y = (x * 3) * (x * 5)      # 15 x^2 -> 30 x
        y.backward()
        return x.grad.asnumpy()
    np.testing.assert_allclose(_both(run)[0], [60.0])


def test_head_gradient():
    def run(m):
        x = m.nd.array([1., 2.])
        x.attach_grad()
        with m.autograd.record():
            y = x * 2
        y.backward(m.nd.array([10., 100.]))
        return x.grad.asnumpy()
    np.testing.assert_allclose(_both(run)[0], [20, 200])


@pytest.mark.parametrize("req,want", [("add", 6.0), ("write", 2.0)])
def test_grad_req_add_and_write(req, want):
    """``write`` overwrites the buffer on every backward, ``add``
    accumulates (torch alone would always accumulate)."""
    def run(m):
        x = m.nd.array([1., 1.])
        x.attach_grad(grad_req=req)
        for _ in range(3):
            with m.autograd.record():
                y = (x * 2).sum()
            y.backward()
        return x.grad.asnumpy()
    np.testing.assert_allclose(_both(run)[0], [want, want])


def test_detach_stops_grad():
    def run(m):
        x = m.nd.array([3.0])
        x.attach_grad()
        with m.autograd.record():
            z = (x * 2).detach() * 5
        z.backward()
        return x.grad.asnumpy()
    np.testing.assert_allclose(_both(run)[0], [0.0])


def test_stop_gradient_op():
    def run(m):
        x = m.nd.array([3.0])
        x.attach_grad()
        with m.autograd.record():
            y = x * x + m.nd.stop_gradient(x * 4)
        y.backward()
        return x.grad.asnumpy()
    np.testing.assert_allclose(_both(run)[0], [6.0])


def test_training_flags():
    for m in PKGS:
        ag = m.autograd
        assert not ag.is_training()
        with ag.record():
            assert ag.is_training() and ag.is_recording()
            with ag.pause():
                assert not ag.is_recording()
            with ag.predict_mode():
                assert not ag.is_training()
        with ag.train_mode():
            assert ag.is_training() and not ag.is_recording()
        assert ag.set_training(True) is False
        assert ag.set_training(False) is True


def test_autograd_grad_api():
    def run(m):
        x = m.nd.array(X)
        x.attach_grad()
        with m.autograd.record():
            y = (x * x * x).sum()
            g = m.autograd.grad(y, x, create_graph=False, retain_graph=True)
        return g.asnumpy()
    np.testing.assert_allclose(_both(run)[0], 3 * X ** 2, rtol=1e-5)


def test_higher_order():
    def run(m):
        x = m.nd.array(X)
        x.attach_grad()
        with m.autograd.record():
            y = (x * x * x).sum()
            g = m.autograd.grad(y, x, create_graph=True, retain_graph=True)
            z = (g * g).sum()
        z.backward()
        return x.grad.asnumpy()
    np.testing.assert_allclose(_both(run)[0], 36 * X ** 3, rtol=1e-5)


def test_higher_order_sigmoid():
    def run(m):
        x = m.nd.array([0.5])
        x.attach_grad()
        with m.autograd.record():
            y = m.nd.sigmoid(x)
            g = m.autograd.grad(y, x, create_graph=True, retain_graph=True)
            z = g.sum()
        z.backward()
        return x.grad.asnumpy()
    s = 1 / (1 + np.exp(-0.5))
    np.testing.assert_allclose(_both(run)[0], [s * (1 - s) * (1 - 2 * s)],
                               rtol=1e-4)


def test_unreached_variable_raises():
    for m in PKGS:
        w = m.nd.ones((2,))
        w.attach_grad()
        x = m.nd.ones((2,))
        x.attach_grad()
        with m.autograd.record():
            y = (x * 2).sum()
        with pytest.raises(m.MXNetError):
            m.autograd.grad(y, [w])


def test_custom_function():
    def run(m):
        class ScaleGrad(m.autograd.Function):
            def forward(self, x):
                return x * 1.0

            def backward(self, dy):
                return dy * 7.0

        x = m.nd.array([1., 2.])
        x.attach_grad()
        with m.autograd.record():
            y = ScaleGrad()(x).sum()
        y.backward()
        return x.grad.asnumpy()
    np.testing.assert_allclose(_both(run)[0], [7, 7])


def test_mark_variables():
    def run(m):
        x = m.nd.array([2.0])
        g = m.nd.zeros((1,))
        m.autograd.mark_variables(x, g)
        with m.autograd.record():
            y = (x * x).sum()
        y.backward()
        return g.asnumpy()
    np.testing.assert_allclose(_both(run)[0], [4.0])


def test_exc_propagates_at_sync():
    """Errors surface no later than the next sync point."""
    for m in PKGS:
        with pytest.raises(Exception):
            a = m.nd.array([1.0, 2.0])
            b = m.nd.array([1.0, 2.0, 3.0])
            m.nd.broadcast_add(a, b).asnumpy()


def test_double_backward_raises():
    """A second backward through a freed graph raises MXNetError (not
    torch's own error); retain_graph=True allows it."""
    for m in PKGS:
        x = m.nd.array([2.0])
        x.attach_grad()
        with m.autograd.record():
            y = (x * x).sum()
        y.backward()
        with pytest.raises(m.MXNetError):
            y.backward()
        with m.autograd.record():
            y = (x * x).sum()
        y.backward(retain_graph=True)
        y.backward()
        np.testing.assert_allclose(x.grad.asnumpy(), [4.0])


def test_inplace_on_recorded_raises():
    """``+=`` on the output of a recorded op raises at the write."""
    for m in PKGS:
        x = m.nd.array([2.0])
        x.attach_grad()
        with m.autograd.record():
            y = x * 2
            with pytest.raises(m.MXNetError):
                y += 1


def test_inplace_on_plain_array_inside_record_carries_grad():
    """``z += y`` on an array that is not on the tape takes y's graph."""
    def run(m):
        x = m.nd.array([2.0, 3.0])
        x.attach_grad()
        z = m.nd.zeros((2,))
        with m.autograd.record():
            z += x * x
            w = (z * 3).sum()
        w.backward()
        return x.grad.asnumpy()
    np.testing.assert_allclose(_both(run)[0], [12.0, 18.0])


def test_ops_outside_record_are_not_taped():
    """Outside record() nothing is taped, even on a variable."""
    x = mx.nd.array([1.0, 2.0])
    x.attach_grad()
    y = x * 2
    assert y._data.grad_fn is None and not y._data.requires_grad
    with mx.autograd.record():
        z = x * 2
        assert z._data.grad_fn is not None
        with mx.autograd.pause():
            assert (x * 2)._data.grad_fn is None
