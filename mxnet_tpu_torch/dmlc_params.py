"""The reference ``.params`` byte format — the port's own copy of
``mxnet_tpu/dmlc_params.py`` (numpy only), byte for byte the same layout.

Upstream MXNet writes it in ``NDArray::Save`` / ``MXNDArraySave`` over
``dmlc::Stream``.  Layout (little-endian throughout):

  file      := uint64 0x112 (kMXAPINDArrayListMagic) | uint64 reserved=0
             | uint64 n_arrays | NDArray*  | uint64 n_names | name*
  name      := uint64 len | utf-8 bytes   (dmlc::Stream string)
  NDArray   := uint32 0xF993FAC9 (NDARRAY_V2_FILE_MAGIC)
             | int32 stype (=0 dense)
             | shape | int32 dev_type=1(cpu) | int32 dev_id=0
             | int32 type_flag | raw data bytes (C-order, no length prefix)
  shape     := uint32 ndim | int64 dim[ndim]   (64-bit dims, the 1.5+
               default; the reader also accepts the 32-bit dims of V1-era
               files by probing both widths)

type_flag mapping (mshadow): 0=f32 1=f64 2=f16 3=u8 4=i32 5=i8 6=i64.  The
format predates bfloat16: saving one raises ``MXNetError``, as in the
reference.
"""

from __future__ import annotations

import struct

import numpy as _np

from .base import MXNetError

_LIST_MAGIC = 0x112
_V2_MAGIC = 0xF993FAC9
_V1_MAGIC = 0xF993FAC8

_TYPE_FLAGS = {0: _np.float32, 1: _np.float64, 2: _np.float16,
               3: _np.uint8, 4: _np.int32, 5: _np.int8, 6: _np.int64}
_FLAG_OF = {_np.dtype(v): k for k, v in _TYPE_FLAGS.items()}


def _dtype_flag(dt):
    dt = _np.dtype(dt)
    if dt in _FLAG_OF:
        return _FLAG_OF[dt]
    if dt.name == "bfloat16" or (dt.kind == "V" and dt.itemsize == 2):
        # a 2-byte void is how the port hands bfloat16 to numpy
        raise MXNetError(
            "the reference .params format predates bfloat16; cast to "
            "float32 before saving in dmlc format (or use the default npz)")
    raise MXNetError(f"dtype {dt} has no reference .params type_flag")


def _write_shape(out, shape):
    out.append(struct.pack("<I", len(shape)))
    out.append(struct.pack(f"<{len(shape)}q", *shape) if shape else b"")


def _write_str(out, s):
    b = s.encode("utf-8")
    out.append(struct.pack("<Q", len(b)))
    out.append(b)


def save_bytes(arrays, names=None):
    """Serialize numpy arrays to the reference .params byte layout."""
    out = [struct.pack("<QQ", _LIST_MAGIC, 0)]
    out.append(struct.pack("<Q", len(arrays)))
    for a in arrays:
        a = _np.ascontiguousarray(a)
        out.append(struct.pack("<I", _V2_MAGIC))
        out.append(struct.pack("<i", 0))              # stype dense
        _write_shape(out, a.shape)
        out.append(struct.pack("<ii", 1, 0))          # cpu ctx
        out.append(struct.pack("<i", _dtype_flag(a.dtype)))
        out.append(a.tobytes())
    names = list(names or [])
    out.append(struct.pack("<Q", len(names)))
    for n in names:
        _write_str(out, n)
    return b"".join(out)


class _Reader:
    def __init__(self, buf):
        self.buf = buf
        self.pos = 0

    def take(self, n):
        if self.pos + n > len(self.buf):
            raise MXNetError("truncated .params file")
        b = self.buf[self.pos:self.pos + n]
        self.pos += n
        return b

    def u32(self):
        return struct.unpack("<I", self.take(4))[0]

    def i32(self):
        return struct.unpack("<i", self.take(4))[0]

    def u64(self):
        return struct.unpack("<Q", self.take(8))[0]


def _read_shape(r, dim64):
    ndim = r.u32()
    if ndim > 32:
        raise MXNetError(f"implausible ndim {ndim} in .params file")
    fmt = "q" if dim64 else "i"
    width = 8 if dim64 else 4
    return struct.unpack(f"<{ndim}{fmt}", r.take(ndim * width))


def _read_ndarray(r):
    magic = r.u32()
    if magic not in (_V2_MAGIC, _V1_MAGIC):
        raise MXNetError(f"bad NDArray magic 0x{magic:x} in .params file")
    if magic == _V2_MAGIC:
        stype = r.i32()
        if stype != 0:
            raise MXNetError(
                "sparse arrays in .params are not supported by this bridge "
                "(use the npz default for row_sparse/csr)")
    # dims width probe: TShape dims were 32-bit in early files and 64-bit
    # from ~1.5 on, under the SAME magics.  Validate the WHOLE header
    # (dev fields, type_flag, and that the data payload fits in the
    # remaining buffer) before committing to a width, so e.g. a 2-D f64
    # 32-bit-dims array can't masquerade as a garbage 64-bit shape.
    start = r.pos
    widths = (True, False) if magic == _V2_MAGIC else (False, True)
    parsed = None
    reasons = []
    for dim64 in widths:
        try:
            r.pos = start
            shape = _read_shape(r, dim64)
            dev_type = r.i32()
            dev_id = r.i32()
            flag = r.i32()
            if not (0 < dev_type <= 16 and 0 <= dev_id < 4096):
                reasons.append(f"implausible ctx ({dev_type},{dev_id})")
                continue
            if flag not in _TYPE_FLAGS:
                reasons.append(f"unknown type_flag {flag}")
                continue
            if not all(0 <= d < 2 ** 48 for d in shape):
                reasons.append(f"implausible shape {shape}")
                continue
            n = 1
            for d in shape:
                n *= d
            nbytes = n * _np.dtype(_TYPE_FLAGS[flag]).itemsize
            if r.pos + nbytes > len(r.buf):
                reasons.append(f"payload {nbytes}B exceeds file")
                continue  # wrong width
            parsed = (shape, flag, n)
            break
        except (MXNetError, struct.error) as e:
            reasons.append(str(e))
            continue
    if parsed is None:
        raise MXNetError(
            "could not parse .params array header: "
            + "; ".join(reasons or ["empty header"]))
    shape, flag, n = parsed
    dt = _np.dtype(_TYPE_FLAGS[flag])
    data = _np.frombuffer(r.take(n * dt.itemsize), dtype=dt).reshape(shape)
    return data.copy()


def is_dmlc_params(head):
    """True if these leading bytes carry the reference list magic."""
    return len(head) >= 8 and \
        struct.unpack("<Q", head[:8])[0] == _LIST_MAGIC


def load_bytes(buf):
    """Parse reference .params bytes → (list_of_numpy, list_of_names)."""
    r = _Reader(buf)
    if r.u64() != _LIST_MAGIC:
        raise MXNetError("not a reference .params file (bad list magic)")
    r.u64()  # reserved
    n_arr = r.u64()
    if n_arr > 10 ** 7:
        raise MXNetError(f"implausible array count {n_arr}")
    arrays = [_read_ndarray(r) for _ in range(n_arr)]
    n_names = r.u64()
    names = []
    for _ in range(n_names):
        ln = r.u64()
        names.append(r.take(ln).decode("utf-8"))
    return arrays, names
