"""Neural-network operators the training slice needs — the port of
``mxnet_tpu/ops/nn.py``'s ``softmax_cross_entropy``, ``LayerNorm`` and
``Dropout``, as plain PyTorch (the reference leaves them to XLA)."""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["softmax_cross_entropy", "layer_norm", "dropout"]


def softmax_cross_entropy(data, label):
    """Summed negative log-likelihood of integer ``label`` under
    softmax(``data``) over the last axis; data (N, C), label (N,)."""
    logp = torch.log_softmax(data, dim=-1)
    return -logp.gather(-1, label.long().reshape(-1, 1)).sum()


def layer_norm(data, gamma, beta, eps=1e-5):
    """(data - mean) / sqrt(var + eps) * gamma + beta over the last axis
    (biased variance, as the reference's ``jnp.var``)."""
    return F.layer_norm(data, data.shape[-1:], gamma, beta, eps)


def dropout(data, p=0.5, training=False, generator=None):
    """Zero each element with probability ``p`` and scale the rest by
    1 / (1 - p) while training; identity otherwise or when p <= 0.  The
    keep mask is drawn from ``generator`` (the torch default when None)."""
    if not training or p <= 0:
        return data
    keep = 1.0 - p
    mask = torch.rand(data.shape, generator=generator, device=data.device) \
        < keep
    return data * mask.to(data.dtype) / keep
