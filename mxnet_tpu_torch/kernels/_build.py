"""Builds the port's CUDA kernels from the sources in this checkout.

Each kernel source under ``kernels/csrc/`` has a plain C entry point (no
PyTorch headers, so ``nvcc`` takes seconds rather than minutes).  It is
compiled for ``sm_90a`` by ``torch.utils.cpp_extension.load`` into
``build/torch_ext/`` at the repository root (listed in ``.gitignore``) at
first use, and bound with ``ctypes``.  Nothing is built at import time; a
build failure raises.
"""

from __future__ import annotations

import ctypes
import os
import threading

__all__ = ["load_kernel_library", "BUILD_DIR", "NVCC_FLAGS"]

_CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
BUILD_DIR = os.path.join(_REPO, "build", "torch_ext")
NVCC_FLAGS = ["-O3", "-gencode=arch=compute_90a,code=sm_90a",
              "-std=c++17"]

_lock = threading.Lock()
_libs = {}


def load_kernel_library(source):
    """Build (once per process) and load ``csrc/<source>.cu`` and return
    its ``ctypes.CDLL``."""
    with _lock:
        lib = _libs.get(source)
        if lib is None:
            from torch.utils.cpp_extension import load
            os.makedirs(BUILD_DIR, exist_ok=True)
            path = load(
                name=f"mxnet_tpu_torch_{source}",
                sources=[os.path.join(_CSRC, f"{source}.cu")],
                extra_cuda_cflags=NVCC_FLAGS,
                build_directory=BUILD_DIR,
                is_python_module=False,
                verbose=False)
            lib = ctypes.CDLL(path)
            _libs[source] = lib
        return lib
