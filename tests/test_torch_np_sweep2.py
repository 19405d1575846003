"""The second half, by name, of the ``np.*`` sweep of
``test_torch_np_sweep.py``: each case through both packages on the CPU,
values within ``_sweep.TOL`` and the reference's dtypes apart from the
C.7 float32 departures (``test_torch_np_sweep.check_case``).
"""

import pytest

from mxnet_tpu_torch.numpy import _sweep
from test_torch_np_sweep import HALF, check_case


@pytest.mark.parametrize("name", _sweep.names()[HALF:])
def test_case_matches_reference(name):
    check_case(name)
