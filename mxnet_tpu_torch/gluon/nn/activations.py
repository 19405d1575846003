"""gluon.nn activation layers — the port of
``mxnet_tpu/gluon/nn/activations.py``: LeakyReLU, PReLU, ELU, SELU, GELU
and Swish (SiLU), over the ``LeakyReLU`` op."""

from __future__ import annotations

from ... import config
from ... import initializer
from ..block import HybridBlock

__all__ = ["LeakyReLU", "PReLU", "ELU", "SELU", "Swish", "GELU", "SiLU"]


class LeakyReLU(HybridBlock):
    def __init__(self, alpha, **kwargs):
        super().__init__(**kwargs)
        self._alpha = alpha

    def hybrid_forward(self, F, x):
        return F.LeakyReLU(x, act_type="leaky", slope=self._alpha)

    def __repr__(self):
        return f"LeakyReLU({self._alpha})"


class PReLU(HybridBlock):
    def __init__(self, alpha_initializer=None, **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            self.alpha = self.params.get(
                "alpha", shape=(1,),
                init=alpha_initializer or initializer.Constant(0.25))

    def hybrid_forward(self, F, x, alpha):
        return F.LeakyReLU(x, alpha, act_type="prelu")


class ELU(HybridBlock):
    def __init__(self, alpha=1.0, **kwargs):
        super().__init__(**kwargs)
        self._alpha = alpha

    def hybrid_forward(self, F, x):
        return F.LeakyReLU(x, act_type="elu", slope=self._alpha)


class SELU(HybridBlock):
    def hybrid_forward(self, F, x):
        return F.LeakyReLU(x, act_type="selu")


class GELU(HybridBlock):
    """Exact (erf) GELU by default; ``approximate=True``, or
    ``MXNET_GELU_TANH=1`` when the layer is built, selects the tanh form."""

    def __init__(self, approximate=None, **kwargs):
        super().__init__(**kwargs)
        if approximate is None:
            approximate = bool(config.get_int("MXNET_GELU_TANH", 0))
        self._approximate = bool(approximate)

    def hybrid_forward(self, F, x):
        return F.LeakyReLU(x, act_type="gelu",
                           approximate=self._approximate)

    def __repr__(self):
        return f"GELU(approximate={self._approximate})"


class Swish(HybridBlock):
    def __init__(self, beta=1.0, **kwargs):
        super().__init__(**kwargs)
        self._beta = beta

    def hybrid_forward(self, F, x):
        return x * F.sigmoid(self._beta * x)


SiLU = Swish
