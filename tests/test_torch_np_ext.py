"""The port's ``mx.np`` held against the JAX package's over the extended
case tables of ``tests/test_numpy_broad.py`` (``EXT_FNS``, ``EXT_FNS3``
and ``EXT_FNS4`` here: searching and counting, nan statistics, logic, bit
math, construction, axis moves, sets; ``EXT_FNS5`` ... ``EXT_FNS8`` in
``test_torch_np_ext2.py``: windows, polynomials, bit packing, the
array-API aliases, ``np.fft``, the linalg additions and the host helpers),
imported from that file, on the CPU.

Each case is checked as the reference's test checks it against numpy
(shape, bool and integer results equal, floats at its tolerance: rtol
2e-5, atol 2e-6; 2e-4 / 2e-5 for round 8's transforms), and against the
reference's own result: the same values at that tolerance and the same
dtype, apart from the ROADMAP C.7 float32 departures in ``DEPARTS``
(pinned by ``test_torch_np_semantics.py``).
"""

import numpy as onp
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from test_numpy_broad import EXT_FNS, EXT_FNS3, EXT_FNS4, _r

tnp, jnp_ = mx.np, jmx.np

# float outputs the reference takes from its x64 default float: float32 here
DEPARTS = {"linspace", "logspace", "eye", "arange", "full", "identity",
           "ones", "zeros", "bartlett", "blackman", "hamming", "hanning",
           "kaiser", "fromfunction", "geomspace", "fft.fftfreq",
           "fft.rfftfreq"}

def cases_of(*tables):
    """(table, seed, case) of each case of ``tables``."""
    return [(t, seed, case) for t, seed, cases in tables for case in cases]


TABLES = cases_of(("ext", 29, EXT_FNS), ("ext3", 37, EXT_FNS3),
                  ("ext4", 41, EXT_FNS4))


@pytest.fixture(autouse=True)
def _on_cpu():
    with mx.cpu():
        yield


def _val(r):
    return r.asnumpy() if hasattr(r, "asnumpy") else onp.asarray(r)


def check_case(table, seed, case):
    """One case against numpy and against the reference."""
    name, mx_fn, onp_fn = case
    rtol, atol = (2e-4, 2e-5) if table == "ext8" else (2e-5, 2e-6)
    x = _r((4, 5), seed)
    got = _val(mx_fn(tnp, x))
    ref = _val(mx_fn(jnp_, x))
    want = onp.asarray(onp_fn(x))
    assert got.shape == want.shape == ref.shape, (got.shape, want.shape)
    if want.dtype.kind == "b":
        assert got.dtype.kind == "b"
        onp.testing.assert_array_equal(got, want)
    elif want.dtype.kind in "iu":
        assert got.dtype.kind in "iu"
        onp.testing.assert_array_equal(got, want)
    else:
        onp.testing.assert_allclose(onp.asarray(got, want.dtype), want,
                                    rtol=rtol, atol=atol)
    if ref.dtype.kind in "biu":
        onp.testing.assert_array_equal(got, ref)
    else:
        onp.testing.assert_allclose(onp.asarray(got, ref.dtype), ref,
                                    rtol=rtol, atol=atol)
    if name in DEPARTS:
        assert got.dtype == onp.float32 and ref.dtype == onp.float64
    else:
        assert got.dtype == ref.dtype, (got.dtype, ref.dtype)


@pytest.mark.parametrize("table,seed,case", TABLES,
                         ids=[f"{t}-{c[0]}" for t, _, c in TABLES])
def test_extended_surface(table, seed, case):
    check_case(table, seed, case)
