"""The second half of ``test_torch_np_ext.py``: the extended case tables
``EXT_FNS5`` ... ``EXT_FNS8`` of ``tests/test_numpy_broad.py`` (the
constructors and reductions of round 5, windows, sets, polynomials and bit
packing, the array-API aliases, ``np.fft`` and the linalg additions) and
the round-8 host helpers, through both packages on the CPU, checked as
``test_torch_np_ext.check_case`` says.
"""

import numpy as onp
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from test_numpy_broad import EXT_FNS5, EXT_FNS6, EXT_FNS7, EXT_FNS8
from test_torch_np_ext import cases_of, check_case

tnp, jnp_ = mx.np, jmx.np

TABLES = cases_of(("ext5", 51, EXT_FNS5), ("ext6", 61, EXT_FNS6),
                  ("ext7", 71, EXT_FNS7), ("ext8", 81, EXT_FNS8))


@pytest.fixture(autouse=True)
def _on_cpu():
    with mx.cpu():
        yield


@pytest.mark.parametrize("table,seed,case", TABLES,
                         ids=[f"{t}-{c[0]}" for t, _, c in TABLES])
def test_extended_surface(table, seed, case):
    check_case(table, seed, case)


def test_round8_host_helpers():
    """The string, bool and plan helpers take an array and answer with
    host values, as the reference's do."""
    for m in (tnp, jnp_):
        a = m.array(onp.arange(4.0, dtype=onp.float32))
        r, s = m.array_repr(a), m.array_str(a)
        assert isinstance(r, str) and "3." in r
        assert isinstance(s, str) and "3." in s
        assert m.iterable(a) is True and m.iterable(3.0) is False
        assert m.issubdtype(onp.float32, onp.floating)
        assert not m.issubdtype(onp.int32, onp.floating)
        path, info = m.einsum_path("ij,jk->ik", a.reshape(2, 2),
                                   a.reshape(2, 2))
        assert isinstance(path, list) and "Complete contraction" in str(info)
