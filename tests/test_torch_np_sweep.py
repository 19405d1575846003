"""Every ``np.*`` registry name held against the JAX package's, on the
CPU, through ``mxnet_tpu_torch.numpy._sweep`` (the table the card's sweep
in ``chip_smoke.py`` runs): one case a name, the same seeded numpy inputs
through both packages.

The cases are split in two halves by name, this file and
``test_torch_np_sweep2.py``.  Outputs agree within ``_sweep.TOL`` of max
|reference| (1e-5 elementwise,
1e-4 where the function sums, sorts or factors; integers and bools equal;
decompositions by their invariants) and have the reference's dtypes, apart
from the ROADMAP C.7 float32 departures in ``DEPARTS``.  Gradients are in
``test_torch_np_grad.py``.
"""

import numpy as onp
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from mxnet_tpu_torch.numpy import _sweep
from mxnet_tpu_torch.ops import registry

# float outputs the reference takes from its x64 default float
DEPARTS = {"zeros", "full", "arange", "linspace", "logspace", "geomspace",
           "eye", "identity", "bartlett", "blackman", "hamming", "hanning",
           "kaiser", "fromfunction", "fft.fftfreq", "fft.rfftfreq"}


def test_a_case_for_every_registry_name():
    from mxnet_tpu.ops import registry as jreg
    jmx.np  # noqa: B018 (registers the reference's np.* names)
    ref = {n[3:] for n in jreg.list_ops() if n.startswith("np.")}
    ported = {n[3:] for n in registry.list_ops() if n.startswith("np.")}
    assert ported == ref and len(ref) == 370
    assert set(_sweep.CASES) == ref
    assert _sweep.HOST_SYNC <= ref


HALF = len(_sweep.names()) // 2


def check_case(name):
    """Case ``name`` through both packages: values and dtypes."""
    got = _sweep.run(mx.np, name, mx.cpu())
    want = _sweep.run(jmx.np, name, jmx.cpu())
    err, tol, same = _sweep.close(name, got, want)
    assert err <= tol, (name, err, tol)
    if name in DEPARTS:
        assert [g.dtype for g in got] == [onp.dtype("float32")] * len(got)
        assert [w.dtype for w in want] == [onp.dtype("float64")] * len(want)
    else:
        assert same, ([g.dtype for g in got], [w.dtype for w in want])


@pytest.mark.parametrize("name", _sweep.names()[:HALF])
def test_case_matches_reference(name):
    check_case(name)
