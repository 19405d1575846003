"""Gradients through ``mx.np`` under ``autograd.record()`` held against
the JAX package's, on the CPU (the cases split in thirds over this file,
``test_torch_np_grad2.py`` and ``test_torch_np_grad3.py``): every case of
``numpy/_sweep.py`` with a
float input and a float output, through both packages on the same inputs,
the gradient of sum(out * w) (w fixed per output) with respect to each
float input, within 1e-4 of max |reference gradient|.

Not compared, each for a reason of the reference's:
- ``GRAD_REF_RAISES``: the reference's backward raises (its ``eig``
  eigenvectors; ``slogdet``, ``qr``, ``svd`` and ``eigh``, whose tuple
  outputs its VJP refuses; ``from_dlpack`` of its own array;
  ``nextafter`` and ``spacing``, which JAX does not differentiate); the port's
  gradient is checked to exist and be finite;
- ``block``: the reference binds it on the host, outside the tape, so its
  gradient is zero; the port records it (ROADMAP C.7) and its gradient is
  the weights, checked here;
- ``polyfit``: the reference's gradient with respect to ``x`` is NaN at
  x = 0 (``jnp.vander``'s power); the gradient with respect to ``y`` is
  compared, and the port's with respect to ``x`` is finite.
"""

import numpy as onp
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from mxnet_tpu_torch.numpy import _sweep

GRAD_REF_RAISES = {"linalg.eig", "linalg.eigh", "linalg.qr",
                   "linalg.slogdet", "linalg.svd", "from_dlpack",
                   "nextafter", "spacing"}
HOST_VALUED = {"shape", "ndim", "size", "iscomplexobj", "isrealobj",
               "isscalar", "broadcast_shapes", "result_type",
               "promote_types", "can_cast", "isdtype", "empty",
               "empty_like"}


def _float_case(name):
    ins = _sweep.inputs(name)
    return name not in HOST_VALUED and any(
        onp.asarray(a).dtype.kind == "f" for a in ins)


CASES = [n for n in _sweep.names() if _float_case(n)]


def _grads(pkg, name):
    """(gradients of each float input, or None where no output is float)."""
    raw = _sweep.inputs(name)
    xs = [pkg.np.array(a) for a in raw]
    fl = [x for x, a in zip(xs, raw) if a.dtype.kind == "f"]
    for x in fl:
        x.attach_grad()
    with pkg.autograd.record():
        outs = []

        def flat(v):
            if isinstance(v, (list, tuple)):
                for u in v:
                    flat(u)
            elif hasattr(v, "asnumpy") and onp.dtype(v.dtype).kind == "f":
                outs.append(v)
        flat(_sweep.call(pkg.np, name, xs))
        if not outs:
            return None
        total = None
        for o in outs:
            w = pkg.np.array(onp.linspace(0.5, 1.5, o.size, dtype=onp.float32)
                             .reshape(o.shape))
            t = (o * w).sum()
            total = t if total is None else total + t
    total.backward()
    return [x.grad.asnumpy() for x in fl]


THIRD = -(-len(CASES) // 3)


def check_grads(name):
    with mx.cpu():
        got = _grads(mx, name)
    if got is None:
        return
    for g in got:
        assert onp.isfinite(g).all(), name
    if name in GRAD_REF_RAISES:
        return
    with jmx.cpu():
        want = _grads(jmx, name)
    if name == "block":
        a, b = _sweep.inputs(name)
        w = onp.linspace(0.5, 1.5, 4 * 5, dtype=onp.float32).reshape(4, 5)
        onp.testing.assert_allclose(got[0], w[:2, :2] + w[2:, :2])
        onp.testing.assert_allclose(got[1], w[:2, 2:] + w[2:, 2:])
        assert not onp.any(want[0])
        return
    if name == "polyfit":
        got, want = got[1:], want[1:]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        scale = max(float(onp.abs(w).max()), 1e-6)
        assert float(onp.abs(g - w).max()) / scale <= 1e-4, name


@pytest.mark.parametrize("name", CASES[:THIRD])
def test_gradient_matches_reference(name):
    check_grads(name)
