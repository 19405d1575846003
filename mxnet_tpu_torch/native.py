"""The port's host C++ libraries, built from this checkout and bound with
``ctypes``: the RecordIO framing scanner and bulk reader
(``src/recordio.cc``, a copy of the reference's) and the image codec
(``src/image_codec.cc``: a baseline JPEG decoder and encoder with no
library).

Each source is compiled with the host C++ compiler (``c++``) into
``build/torch_ext/`` at the repository root at first use, under a name
that carries a hash of the source, so that a library built from another
version of the source is never loaded.  The compiler writes a temporary
file that is then renamed, so that processes building at once never load a
half-written library; a worker pool's parent builds before its workers
start.  A failed build raises ``MXNetError``: there is no other decoder.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

from .base import MXNetError
from .kernels._build import BUILD_DIR

__all__ = ["recordio_lib", "codec_lib", "index_recordio",
           "read_recordio_batch", "jpeg_info", "jpeg_decode",
           "jpeg_decode_crop_norm", "jpeg_encode", "BUILD_DIR"]

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "src")
CXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]

_lock = threading.Lock()
_libs = {}

_RIO_ERRORS = {
    -1: "cannot open file",
    -2: "bad record framing (magic/length mismatch or truncated record)",
    -3: "split (multi-chunk) records are not supported",
    -4: "I/O error",
    -5: "output buffer too small",
    -6: "out of memory",
}

u8p = ctypes.POINTER(ctypes.c_uint8)
u64p = ctypes.POINTER(ctypes.c_uint64)
f32p = ctypes.POINTER(ctypes.c_float)
i32p = ctypes.POINTER(ctypes.c_int)


def _build(name):
    """Compile ``src/<name>.cc`` (once per source version) and load it."""
    src = os.path.join(_SRC, f"{name}.cc")
    with open(src, "rb") as f:
        digest = hashlib.sha1(f.read() + " ".join(CXX_FLAGS).encode()) \
            .hexdigest()[:12]
    out = os.path.join(BUILD_DIR, f"lib{name}.{digest}.so")
    if not os.path.exists(out):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{out}.{os.getpid()}.{threading.get_ident()}.tmp"
        try:
            proc = subprocess.run(["c++", *CXX_FLAGS, "-o", tmp, src],
                                  capture_output=True, text=True,
                                  timeout=300)
            if proc.returncode != 0:
                raise MXNetError(f"building {src} failed (c++ exit "
                                 f"{proc.returncode}):\n{proc.stderr}")
            os.replace(tmp, out)
        except (OSError, subprocess.SubprocessError) as e:
            raise MXNetError(f"building {src} failed: {e}") from e
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    return ctypes.CDLL(out)


def _lib(name, bind):
    lib = _libs.get(name)
    if lib is None:
        with _lock:
            lib = _libs.get(name)
            if lib is None:
                lib = _build(name)
                bind(lib)
                _libs[name] = lib
    return lib


def _bind_recordio(lib):
    lib.rio_index.argtypes = [ctypes.c_char_p, ctypes.POINTER(u64p),
                              ctypes.POINTER(u64p),
                              ctypes.POINTER(ctypes.c_uint64)]
    lib.rio_index.restype = ctypes.c_int
    lib.rio_read_batch.argtypes = [ctypes.c_char_p, u64p, u64p,
                                   ctypes.c_uint64, u8p, ctypes.c_uint64,
                                   ctypes.POINTER(ctypes.c_uint64)]
    lib.rio_read_batch.restype = ctypes.c_int
    lib.rio_free.argtypes = [ctypes.c_void_p]
    lib.rio_free.restype = None


def _bind_codec(lib):
    lib.mxc_last_error.argtypes = []
    lib.mxc_last_error.restype = ctypes.c_char_p
    lib.mxc_free.argtypes = [ctypes.c_void_p]
    lib.mxc_free.restype = None
    lib.mxc_jpeg_info.argtypes = [u8p, ctypes.c_uint64, i32p, i32p, i32p]
    lib.mxc_jpeg_decode.argtypes = [u8p, ctypes.c_uint64, ctypes.c_int, u8p,
                                    ctypes.c_uint64]
    lib.mxc_jpeg_decode_crop_norm.argtypes = [
        u8p, ctypes.c_uint64, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, f32p, f32p, f32p]
    lib.mxc_jpeg_encode.argtypes = [u8p, ctypes.c_int, ctypes.c_int,
                                    ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                    ctypes.POINTER(u8p),
                                    ctypes.POINTER(ctypes.c_uint64)]
    for fn in (lib.mxc_jpeg_info, lib.mxc_jpeg_decode,
               lib.mxc_jpeg_decode_crop_norm, lib.mxc_jpeg_encode):
        fn.restype = ctypes.c_int


def recordio_lib():
    """The RecordIO scanner, built at first use."""
    return _lib("recordio", _bind_recordio)


def codec_lib():
    """The image codec, built at first use."""
    return _lib("image_codec", _bind_codec)


# -- RecordIO -----------------------------------------------------------------

def _rio_check(rc, what):
    if rc != 0:
        raise MXNetError(f"recordio {what}: "
                         f"{_RIO_ERRORS.get(rc, f'error {rc}')}")


def index_recordio(path):
    """Scan a .rec file: ``(offsets, lengths)`` uint64 arrays of the
    payloads.  A malformed or truncated file raises."""
    lib = recordio_lib()
    offs, lens = u64p(), u64p()
    count = ctypes.c_uint64()
    rc = lib.rio_index(os.fsencode(path), ctypes.byref(offs),
                       ctypes.byref(lens), ctypes.byref(count))
    _rio_check(rc, f"index of {path}")
    n = count.value
    try:
        o = np.ctypeslib.as_array(offs, shape=(n,)).copy() if n \
            else np.empty((0,), np.uint64)
        ln = np.ctypeslib.as_array(lens, shape=(n,)).copy() if n \
            else np.empty((0,), np.uint64)
    finally:
        lib.rio_free(offs)
        lib.rio_free(lens)
    return o, ln


def read_recordio_batch(path, offsets, lengths):
    """The payloads at ``(offsets, lengths)``, read in one pass, as a list
    of bytes."""
    offsets = np.ascontiguousarray(offsets, np.uint64)
    lengths = np.ascontiguousarray(lengths, np.uint64)
    total = int(lengths.sum())
    out = np.empty((total,), np.uint8)
    written = ctypes.c_uint64()
    rc = recordio_lib().rio_read_batch(
        os.fsencode(path), offsets.ctypes.data_as(u64p),
        lengths.ctypes.data_as(u64p), len(offsets), out.ctypes.data_as(u8p),
        total, ctypes.byref(written))
    _rio_check(rc, f"read of {path}")
    res, pos = [], 0
    for ln in lengths.tolist():
        res.append(out[pos:pos + ln].tobytes())
        pos += ln
    return res


# -- the codec ----------------------------------------------------------------

def _codec_check(lib, rc, what):
    if rc != 0:
        raise MXNetError(f"{what}: {lib.mxc_last_error().decode()}")


def _buffer(buf):
    arr = np.frombuffer(buf, np.uint8) if not isinstance(buf, np.ndarray) \
        else np.ascontiguousarray(buf, np.uint8).reshape(-1)
    return arr, arr.ctypes.data_as(u8p)


def jpeg_info(buf):
    """``(width, height, components)`` from a JPEG header."""
    lib = codec_lib()
    arr, ptr = _buffer(buf)
    w, h, n = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    _codec_check(lib, lib.mxc_jpeg_info(ptr, arr.size, ctypes.byref(w),
                                        ctypes.byref(h), ctypes.byref(n)),
                 "JPEG header")
    return w.value, h.value, n.value


def jpeg_decode(buf, mode):
    """Decode a JPEG to HWC uint8: ``mode`` "gray" (one channel: the Y
    plane), "rgb" or "bgr"."""
    lib = codec_lib()
    arr, ptr = _buffer(buf)
    w, h, _ = jpeg_info(arr)
    ch = 1 if mode == "gray" else 3
    out = np.empty((h, w, ch), np.uint8)
    _codec_check(lib, lib.mxc_jpeg_decode(
        ptr, arr.size, {"gray": 0, "rgb": 1, "bgr": 2}[mode],
        out.ctypes.data_as(u8p), out.size), "JPEG decode")
    return out


def jpeg_decode_crop_norm(buf, crop_hw, crop_xy=None, mirror=False,
                          mean=(0.0, 0.0, 0.0), std=(1.0, 1.0, 1.0),
                          out=None):
    """Decode the crop ``crop_hw`` at top-left ``crop_xy`` (None: centred)
    of a JPEG, mirror it if asked, and write ``(rgb - mean) * (1 / std)``
    as float32 CHW into ``out`` (allocated when None); returns ``out``.
    A JPEG smaller than the crop raises."""
    lib = codec_lib()
    arr, ptr = _buffer(buf)
    h, w = crop_hw
    if out is None:
        out = np.empty((3, h, w), np.float32)
    if out.dtype != np.float32 or out.shape != (3, h, w) \
            or not out.flags.c_contiguous:
        raise MXNetError("jpeg_decode_crop_norm: out must be a contiguous "
                         f"float32 array of shape {(3, h, w)}")
    mean_a = np.ascontiguousarray(mean, np.float32)
    stdi_a = 1.0 / np.ascontiguousarray(std, np.float32)
    x, y = (-1, -1) if crop_xy is None else (int(crop_xy[0]),
                                             int(crop_xy[1]))
    _codec_check(lib, lib.mxc_jpeg_decode_crop_norm(
        ptr, arr.size, w, h, x, y, int(bool(mirror)),
        mean_a.ctypes.data_as(f32p), stdi_a.ctypes.data_as(f32p),
        out.ctypes.data_as(f32p)), "JPEG decode")
    return out


def jpeg_encode(img, quality=95, bgr=True):
    """Encode an HWC (or HW) uint8 image as a baseline JPEG (4:2:0 for
    colour); channel order BGR when ``bgr``, as cv2's ``imencode``."""
    lib = codec_lib()
    img = np.ascontiguousarray(img, np.uint8)
    if img.ndim == 3 and img.shape[2] == 1:
        img = img[:, :, 0]
    ch = 1 if img.ndim == 2 else img.shape[2]
    if ch not in (1, 3):
        raise MXNetError(f"jpeg_encode: {ch} channels (1 or 3 only)")
    out, n = u8p(), ctypes.c_uint64()
    _codec_check(lib, lib.mxc_jpeg_encode(
        img.ctypes.data_as(u8p), img.shape[1], img.shape[0], ch,
        int(bool(bgr)), int(quality), ctypes.byref(out), ctypes.byref(n)),
        "JPEG encode")
    try:
        return ctypes.string_at(out, n.value)
    finally:
        lib.mxc_free(out)
