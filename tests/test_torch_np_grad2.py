"""The second third of ``test_torch_np_grad.py``'s cases: gradients
through ``mx.np`` held against the JAX package's
(``test_torch_np_grad.check_grads``)."""

import pytest

from test_torch_np_grad import CASES, THIRD, check_grads


@pytest.mark.parametrize("name", CASES[THIRD:2 * THIRD])
def test_gradient_matches_reference(name):
    check_grads(name)
