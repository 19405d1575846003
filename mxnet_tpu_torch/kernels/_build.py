"""Builds the port's CUDA kernels from the sources in this checkout.

Each kernel source under ``kernels/csrc/`` has plain C entry points (no
PyTorch headers, so ``nvcc`` takes seconds rather than minutes).  It is
compiled for ``sm_90a`` by one ``nvcc`` process into a shared library under
``build/torch_ext/`` at the repository root (listed in ``.gitignore``) at
first use, and bound with ``ctypes``.  :func:`build_kernel_libraries`
starts one ``nvcc`` per source, all at once.  Nothing is built at import
time; a build failure raises.

The library is named by a digest of ``csrc/`` and the flags
(``lib<source>.<digest>.so``, nvcc's output beside it as ``.log``), built
under a temporary name of this process and renamed into place: a process
that finds both files loads them instead of compiling (the serving
replicas a router starts beside a process that built them), and processes
that build at once never write one file.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

from ..analysis import runtime as _art
from ..base import MXNetError

__all__ = ["build_kernel_libraries", "build_log", "library_path",
           "BUILD_DIR", "NVCC_FLAGS"]

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


def _digest():
    """sha1 over the flags and every file of ``csrc/`` (the sources and
    the headers they share), 12 hex digits."""
    h = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for name in sorted(os.listdir(_CSRC)):
        h.update(name.encode())
        with open(os.path.join(_CSRC, name), "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:12]


def library_path(source):
    """Where ``csrc/<source>.cu``'s library of this checkout lives."""
    return os.path.join(BUILD_DIR, f"lib{source}.{_digest()}.so")


def build_kernel_libraries(sources):
    """Build (once per process, unless a built copy of these sources is
    there) and load ``csrc/<source>.cu`` for every name in ``sources``,
    compiling the missing ones in parallel; returns
    ``{source: ctypes.CDLL}``."""
    with _lock:
        todo = [s for s in sources if s not in _libs]
        procs = {}
        for s in todo:
            out = library_path(s)
            log = out[:-3] + ".log"
            if os.path.exists(out) and os.path.exists(log):
                with open(log) as f:
                    _logs[s] = f.read()
                _libs[s] = ctypes.CDLL(out)
                _art.note_build(f"kernels.{s}")
                continue
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = f"{out}.tmp.{os.getpid()}"
            procs[s] = (out, tmp, subprocess.Popen(
                [_nvcc(), *NVCC_FLAGS, "-o", tmp,
                 os.path.join(_CSRC, f"{s}.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True))
        failed = []
        for s, (out, tmp, proc) in procs.items():
            _logs[s] = proc.communicate()[0]
            if proc.returncode != 0:
                failed.append(f"{s}.cu (nvcc exit {proc.returncode}):\n"
                              f"{_logs[s]}")
                continue
            # the log first: a library in place always has its log
            with open(f"{tmp}.log", "w") as f:
                f.write(_logs[s])
            os.replace(f"{tmp}.log", out[:-3] + ".log")
            os.replace(tmp, out)
            _libs[s] = ctypes.CDLL(out)
            _art.note_build(f"kernels.{s}")
        if failed:
            raise MXNetError("kernel build failed: " + "\n".join(failed))
        return {s: _libs[s] for s in sources}


def build_log(source):
    """nvcc's output for ``source`` (ptxas registers, shared memory and
    spills per kernel), or '' before it was built in this process."""
    return _logs.get(source, "")
