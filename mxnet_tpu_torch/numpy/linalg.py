"""mx.np.linalg — the reference's 31 ``np.linalg`` names over
``torch.linalg``, each the registry op ``np.linalg.<name>``
(``_linalg_impl.py`` says where numpy's conventions differ from torch's)."""

from __future__ import annotations

import sys as _sys

from . import _linalg_impl
from ._dispatch import dispatch as _dispatch

_NAMES = ("norm", "inv", "det", "slogdet", "solve", "lstsq", "pinv",
          "matrix_rank", "matrix_power", "cholesky", "qr", "svd", "svdvals",
          "eig", "eigh", "eigvals", "eigvalsh", "cond", "tensorinv",
          "tensorsolve", "multi_dot", "cross", "outer", "matmul", "trace",
          "vector_norm", "matrix_norm", "diagonal", "matrix_transpose",
          "tensordot", "vecdot")

_self = _sys.modules[__name__]
for _n in _NAMES:
    setattr(_self, _n, _dispatch("linalg." + _n, getattr(_linalg_impl, _n),
                                 _n != "matrix_rank"))
del _n
