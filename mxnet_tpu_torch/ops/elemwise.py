"""Elementwise operators the training slice needs — the port of
``mxnet_tpu/ops/elemwise.py``'s ``gelu``."""

from __future__ import annotations

import torch.nn.functional as F

from .. import config

__all__ = ["gelu"]


def gelu(x, approximate=None):
    """GELU: the exact erf form 0.5 x (1 + erf(x / sqrt 2)) by default;
    ``approximate=True`` (or ``MXNET_GELU_TANH=1`` when ``approximate`` is
    None) selects 0.5 x (1 + tanh(sqrt(2/pi) (x + 0.044715 x^3)))."""
    if approximate is None:
        approximate = bool(config.get_int("MXNET_GELU_TANH", 0))
    return F.gelu(x, approximate="tanh" if approximate else "none")
