"""Weight initialisation by parameter name — the port of the policy that
``mxnet_tpu/initializer.py`` applies with ``Normal(sigma)``.

The reference's ``Initializer.__call__`` dispatches on the parameter's
name: ``*bias`` and ``*beta`` get zeros, ``*gamma`` ones, and everything
else (weights, BERT's ``position_weight``) the initializer's own draw;
parameters that declare ``init="ones"`` (the llama RMSNorm weight) keep
ones.  :func:`init_weights` applies the same policy to a ``torch.nn``
module with Normal(0, std) drawn from a caller's generator.
"""

from __future__ import annotations

import torch

__all__ = ["init_weights"]

# name endings that are ones / zeros whatever the initializer draws
_ONES = ("gamma", "norm.weight")
_ZEROS = ("bias", "beta")


@torch.no_grad()
def init_weights(module, generator=None, std=0.02):
    """Fill every parameter of ``module`` in place by the policy above;
    ``generator`` must live on the parameters' device."""
    for name, p in module.named_parameters():
        if name.endswith(_ONES):
            p.fill_(1.0)
        elif name.endswith(_ZEROS):
            p.zero_()
        else:
            p.normal_(0.0, std, generator=generator)
    return module
