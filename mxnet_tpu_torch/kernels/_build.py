"""Builds the port's CUDA kernels from the sources in this checkout.

Each kernel source under ``kernels/csrc/`` has plain C entry points (no
PyTorch headers, so ``nvcc`` takes seconds rather than minutes).  It is
compiled for ``sm_90a`` by one ``nvcc`` process into a shared library under
``build/torch_ext/`` at the repository root (listed in ``.gitignore``) at
first use, and bound with ``ctypes``.  :func:`build_kernel_libraries`
starts one ``nvcc`` per source, all at once.  Nothing is built at import
time; a build failure raises.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

from ..base import MXNetError

__all__ = ["build_kernel_libraries", "build_log", "BUILD_DIR",
           "NVCC_FLAGS"]

_CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
BUILD_DIR = os.path.join(_REPO, "build", "torch_ext")
NVCC_FLAGS = ["-O3", "-gencode=arch=compute_90a,code=sm_90a", "-std=c++17",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v"]

_lock = threading.Lock()
_libs = {}
_logs = {}


def _nvcc():
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise MXNetError("no CUDA toolkit found to build the kernels")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def build_kernel_libraries(sources):
    """Build (once per process) and load ``csrc/<source>.cu`` for every
    name in ``sources``, compiling the missing ones in parallel; returns
    ``{source: ctypes.CDLL}``."""
    with _lock:
        todo = [s for s in sources if s not in _libs]
        if todo:
            os.makedirs(BUILD_DIR, exist_ok=True)
            nvcc = _nvcc()
            procs = {}
            for s in todo:
                out = os.path.join(BUILD_DIR, f"lib{s}.so")
                procs[s] = (out, subprocess.Popen(
                    [nvcc, *NVCC_FLAGS, "-o", out + ".tmp",
                     os.path.join(_CSRC, f"{s}.cu")],
                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                    text=True))
            failed = []
            for s, (out, proc) in procs.items():
                _logs[s] = proc.communicate()[0]
                if proc.returncode != 0:
                    failed.append(f"{s}.cu (nvcc exit {proc.returncode}):\n"
                                  f"{_logs[s]}")
                    continue
                os.replace(out + ".tmp", out)
                _libs[s] = ctypes.CDLL(out)
            if failed:
                raise MXNetError("kernel build failed: " + "\n".join(failed))
        return {s: _libs[s] for s in sources}


def build_log(source):
    """nvcc's output for ``source`` (ptxas registers, shared memory and
    spills per kernel), or '' before it was built in this process."""
    return _logs.get(source, "")
