"""The port's image codec front: JPEG through the C++ codec
(``src/image_codec.cc`` via ``native``), PNG in Python (``zlib`` plus
numpy).  It takes the place of cv2's ``imdecode``/``imencode`` in the
reference, with cv2's flags and channel order:

- ``imdecode_bgr(buf, flag)``: ``flag`` > 0 gives HxWx3 BGR, 0 gives HxW
  gray (a JPEG's Y plane, as libjpeg gives it), < 0 the image as stored;
- ``imencode(ext, img, quality)``: ``img`` in BGR (or gray, or BGRA for
  PNG); JPEG at the IJG ``quality``, PNG at zlib level ``quality``
  clamped to 0-9 (cv2's ``IMWRITE_PNG_COMPRESSION``).

PNG decode reads 8-bit gray, gray+alpha, RGB, RGBA and palette images with
all five filters; interlaced and 16-bit files raise.  A format that is
neither JPEG nor PNG raises ``MXNetError``.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

from .base import MXNetError

__all__ = ["imdecode_bgr", "imencode", "is_jpeg"]

_PNG_SIG = b"\x89PNG\r\n\x1a\n"


def is_jpeg(buf):
    return bytes(buf[:2]) == b"\xff\xd8"


def imdecode_bgr(buf, flag=1):
    """Decode JPEG or PNG bytes with cv2's flag and channel order."""
    from . import native
    if is_jpeg(buf):
        if flag == 0:
            return native.jpeg_decode(buf, "gray")[:, :, 0]
        img = native.jpeg_decode(buf, "bgr")
        if flag < 0 and native.jpeg_info(buf)[2] == 1:
            return img[:, :, 0].copy()
        return img
    if bytes(buf[:8]) == _PNG_SIG:
        return _png_decode(bytes(buf), flag)
    raise MXNetError("imdecode: the data is neither JPEG nor PNG")


def imencode(ext, img, quality=95):
    """Encode ``img`` (BGR/gray uint8) as ``.jpg``/``.jpeg`` or ``.png``
    bytes."""
    from . import native
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise MXNetError(f"imencode: uint8 images only, not {img.dtype}")
    ext = ext.lower()
    if ext in (".jpg", ".jpeg"):
        return native.jpeg_encode(img, quality, bgr=True)
    if ext == ".png":
        return _png_encode(img, min(max(int(quality), 0), 9))
    raise MXNetError(f"imencode: format {ext!r} (.jpg or .png only)")


# -- PNG ----------------------------------------------------------------------

def _paeth_row(line, prev, bpp):
    cur = bytearray(line)
    for i in range(len(cur)):
        a = cur[i - bpp] if i >= bpp else 0
        b = prev[i]
        c = prev[i - bpp] if i >= bpp else 0
        pa, pb, pc = abs(b - c), abs(a - c), abs(a + b - 2 * c)
        p = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        cur[i] = (cur[i] + p) & 255
    return cur


def _avg_row(line, prev, bpp):
    cur = bytearray(line)
    for i in range(len(cur)):
        a = cur[i - bpp] if i >= bpp else 0
        cur[i] = (cur[i] + ((a + prev[i]) >> 1)) & 255
    return cur


def _unfilter(raw, h, stride, bpp):
    out = np.empty((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    if len(raw) < h * (stride + 1):
        raise MXNetError("PNG image data is truncated")
    for y in range(h):
        pos = y * (stride + 1)
        ft = raw[pos]
        line = np.frombuffer(raw, np.uint8, stride, pos + 1)
        if ft == 0:
            cur = line
        elif ft == 1:
            cur = np.cumsum(line.reshape(-1, bpp), axis=0,
                            dtype=np.uint8).reshape(-1)
        elif ft == 2:
            cur = line + prev
        elif ft == 3:
            cur = np.frombuffer(_avg_row(line, prev.tobytes(), bpp), np.uint8)
        elif ft == 4:
            cur = np.frombuffer(_paeth_row(line, prev.tobytes(), bpp),
                                np.uint8)
        else:
            raise MXNetError(f"PNG row filter {ft} is invalid")
        out[y] = cur
        prev = out[y]
    return out


def _png_decode(buf, flag):
    pos, idat, plte, ihdr = 8, [], None, None
    while pos + 8 <= len(buf):
        length, kind = struct.unpack(">I4s", buf[pos:pos + 8])
        data = buf[pos + 8:pos + 8 + length]
        pos += 12 + length
        if kind == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", data)
        elif kind == b"PLTE":
            plte = np.frombuffer(data, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(data)
        elif kind == b"IEND":
            break
    if ihdr is None or not idat:
        raise MXNetError("PNG without IHDR or image data")
    w, h, depth, ctype, _, _, interlace = ihdr
    if interlace:
        raise MXNetError("interlaced PNG is not supported")
    if depth != 8:
        raise MXNetError(f"{depth}-bit PNG is not supported (8-bit only)")
    chans = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}.get(ctype)
    if chans is None:
        raise MXNetError(f"PNG colour type {ctype} is invalid")
    try:
        raw = zlib.decompress(b"".join(idat))
    except zlib.error as e:
        raise MXNetError(f"PNG image data is corrupt: {e}") from e
    px = _unfilter(raw, h, w * chans, chans).reshape(h, w, chans)
    if ctype == 3:
        if plte is None:
            raise MXNetError("palette PNG without PLTE")
        px = plte[px[:, :, 0]]
    elif ctype == 4:
        px = px[:, :, :1] if flag >= 0 else px
    gray = px.shape[2] <= 2
    if flag == 0:
        if gray:
            return px[:, :, 0].copy()
        # libpng's rgb_to_gray at cv2's weights (0.299, 0.587): 15-bit
        # coefficients truncated from them, no rounding
        r, g, b = (px[:, :, k].astype(np.int32) for k in range(3))
        y = (9797 * r + 19234 * g + 3737 * b) >> 15
        return np.where((r == g) & (g == b), r, y).astype(np.uint8)
    if flag > 0:
        if gray:
            return np.repeat(px[:, :, :1], 3, axis=2)
        return px[:, :, 2::-1].copy()
    if gray:
        return px[:, :, 0].copy() if px.shape[2] == 1 else px
    order = [2, 1, 0, 3] if px.shape[2] == 4 else [2, 1, 0]
    return px[:, :, order].copy()


def _png_filter_rows(px, bpp):
    """Each row filtered by the filter of least sum |signed byte| (libpng's
    heuristic); returns the filtered bytes with their filter bytes."""
    x = px.astype(np.int16)
    up = np.zeros_like(x)
    up[1:] = x[:-1]
    left = np.zeros_like(x)
    left[:, bpp:] = x[:, :-bpp]
    ul = np.zeros_like(x)
    ul[1:, bpp:] = x[:-1, :-bpp]
    pa, pb, pc = np.abs(up - ul), np.abs(left - ul), np.abs(left + up - 2 * ul)
    paeth = np.where((pa <= pb) & (pa <= pc), left,
                     np.where(pb <= pc, up, ul))
    cands = np.stack([x, x - left, x - up, x - ((left + up) >> 1),
                      x - paeth]).astype(np.uint8)
    cost = np.abs(cands.astype(np.int8).astype(np.int32)).sum(axis=2)
    best = cost.argmin(axis=0)
    rows = cands[best, np.arange(px.shape[0])]
    return np.concatenate([best[:, None].astype(np.uint8), rows], axis=1)


def _chunk(kind, data):
    return struct.pack(">I", len(data)) + kind + data + struct.pack(
        ">I", zlib.crc32(kind + data) & 0xFFFFFFFF)


def _png_encode(img, level):
    if img.ndim == 2:
        img = img[:, :, None]
    h, w, c = img.shape
    if c == 1:
        ctype, px = 0, img
    elif c == 3:
        ctype, px = 2, img[:, :, ::-1]
    elif c == 4:
        ctype, px = 6, img[:, :, [2, 1, 0, 3]]
    else:
        raise MXNetError(f"PNG encode: {c} channels")
    rows = _png_filter_rows(np.ascontiguousarray(px).reshape(h, w * c), c)
    return (_PNG_SIG
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0,
                                          0))
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), level))
            + _chunk(b"IEND", b""))
