"""mx.nd — the imperative NDArray API (the port of ``mxnet_tpu/ndarray/``):
``NDArray``, the creation functions, and one function per registered
operator, dotted names as sub-namespaces (``mx.nd.random.uniform``,
``mx.nd.linalg.gemm2``, ``mx.nd.contrib.masked_encdec_att``) and flattened
(``random_uniform``)."""

import sys as _sys

from .. import ops as _ops  # noqa: F401  (registers the operators)
from .ndarray import (  # noqa: F401
    NDArray, array, zeros, ones, full, empty, arange, concat, waitall, save,
    load, from_numpy, from_dlpack,
)
from . import register as _register


def Custom(*inputs, op_type=None, **kwargs):  # noqa: N802 (MXNet's name)
    """A user-registered Python op (``mx.operator``); under autograd its
    ``backward`` is the gradient."""
    from ..base import MXNetError
    if op_type is None:
        raise MXNetError("nd.Custom requires op_type=")
    from .. import operator as _op
    return _op.invoke_custom(list(inputs), op_type, **kwargs)


_GENERATED = _register.populate(_sys.modules[__name__])
