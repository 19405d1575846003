"""``mx.sym`` — the symbolic graph API, the port of ``mxnet_tpu/symbol/``
(MXNet's ``python/mxnet/symbol/``): ``Symbol``, ``var``, ``Group``,
``load``/``load_json``, the generated ``mx.sym.<op>`` functions (with
``mx.sym.contrib``, ``mx.sym.linalg`` and ``mx.sym.random``), the control
flow of ``mx.sym.contrib``, ``register_backend`` and the ``INT8`` pass of
``optimize_for``."""

import sys as _sys

from .symbol import (  # noqa: F401
    Symbol, var, Variable, Group, load, load_json, zeros, ones,
    register_backend,
)
from .executor import Executor  # noqa: F401
from . import contrib  # noqa: F401
from . import register as _register

_GENERATED = _register.populate(_sys.modules[__name__])

from . import int8_pass  # noqa: F401,E402 (registers the INT8 backend)
