"""``mx.runtime`` — feature introspection, the port of
``mxnet_tpu/runtime.py``.  The names are the reference's, and MXNet 1.x's
``NCCL``; each says what this build and host have: CUDA, cuDNN and NCCL
from torch, no TPU, XLA or Pallas, and no OpenCV (images decode with the
port's own codec)."""

from __future__ import annotations

import torch

__all__ = ["Feature", "Features", "feature_list"]


class Feature:
    def __init__(self, name, enabled):
        self.name = name
        self.enabled = enabled

    def __repr__(self):
        return f"[{'✔' if self.enabled else '✖'} {self.name}]"


def _nccl():
    import torch.distributed as dist
    return dist.is_available() and dist.is_nccl_available()


def _detect():
    cuda = torch.cuda.is_available()
    return {
        "TPU": False,
        "CPU": True,
        "CUDA": cuda,
        "CUDNN": cuda and torch.backends.cudnn.is_available(),
        "NCCL": cuda and _nccl(),
        "MKLDNN": torch.backends.mkldnn.is_available(),
        "XLA": False,
        "PALLAS": False,
        "BF16": True,
        "F16C": True,
        "BLAS_OPEN": True,
        "LAPACK": torch._C.has_lapack,
        "OPENCV": False,
        "DIST_KVSTORE": False,
        "INT64_TENSOR_SIZE": True,
        "SIGNAL_HANDLER": False,
        "PROFILER": True,
        "OPENMP": torch.backends.openmp.is_available(),
        "SSE": False,
        "TENSORRT": False,
        "TVM_OP": False,
    }


class Features(dict):
    """``mx.runtime.Features()``: a dict of :class:`Feature` by name, made
    once per process."""

    instance = None

    def __new__(cls):
        if cls.instance is None:
            inst = super().__new__(cls)
            inst.update({k: Feature(k, v) for k, v in _detect().items()})
            cls.instance = inst
        return cls.instance

    def __init__(self):
        super().__init__()

    def is_enabled(self, name):
        name = name.upper()
        if name not in self:
            raise RuntimeError(f"feature {name!r} does not exist")
        return self[name].enabled

    def __repr__(self):
        return str(list(self.values()))


def feature_list():
    return list(Features().values())
