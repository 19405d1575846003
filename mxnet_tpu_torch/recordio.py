"""RecordIO, MXNet's packed binary record format — the port of
``mxnet_tpu/recordio.py``.

The byte format is the reference's (magic 0xced7230a framing, 4-byte
alignment, the IRHeader struct), so ``.rec``/``.idx`` files written by
either package read in the other.  Bulk reads go through the port's own
C++ framing scanner (``src/recordio.cc``, built at first use by
``native``); a file whose framing is broken or truncated raises.
``pack_img``/``unpack_img`` encode and decode through the port's codec
(``codec``), with cv2's channel order: ``pack_img`` takes BGR and
``unpack_img`` returns BGR.
"""

from __future__ import annotations

import os
import struct
import sys as _sys
from collections import namedtuple

import numpy as np

from .base import MXNetError

__all__ = ["MXRecordIO", "MXIndexedRecordIO", "IRHeader", "pack", "unpack",
           "pack_img", "unpack_img"]

_MAGIC = 0xced7230a
# IRHeader: flag (uint32), label (float32), id (uint64), id2 (uint64)
_IR_FORMAT = "IfQQ"
_IR_SIZE = struct.calcsize(_IR_FORMAT)

IRHeader = namedtuple("HEADER", ["flag", "label", "id", "id2"])


def _encode_record(data):
    """magic + (cflag<<29 | length) + payload + pad to 4 bytes."""
    length = len(data)
    pad = (4 - length % 4) % 4
    return struct.pack("<II", _MAGIC, length) + data + b"\x00" * pad


class MXRecordIO:
    """Sequential .rec reader/writer."""

    def __init__(self, uri, flag):
        self.uri = uri
        self.flag = flag
        self.pid = None
        self.record = None
        self.open()

    def open(self):
        if self.flag == "w":
            self.record = open(self.uri, "wb")
            self.writable = True
        elif self.flag == "r":
            self.record = open(self.uri, "rb")
            self.writable = False
        else:
            raise MXNetError("flag must be 'r' or 'w'")
        self.pid = os.getpid()

    def close(self):
        if self.record is not None:
            self.record.close()
            self.record = None

    def reset(self):
        self.close()
        self.open()

    def _check_pid(self):
        # a forked child reopens its own handle
        if self.pid != os.getpid():
            self.reset()

    def write(self, buf):
        if not self.writable:
            raise MXNetError("not opened for writing")
        self._check_pid()
        self.record.write(_encode_record(buf))

    def tell(self):
        return self.record.tell()

    def read(self):
        if self.writable:
            raise MXNetError("not opened for reading")
        self._check_pid()
        header = self.record.read(8)
        if not header:
            return None
        if len(header) < 8:
            raise MXNetError(f"truncated record header in {self.uri}")
        magic, lrec = struct.unpack("<II", header)
        if magic != _MAGIC:
            raise MXNetError(f"invalid record magic {magic:#x} in {self.uri}")
        length = lrec & ((1 << 29) - 1)
        data = self.record.read(length)
        if len(data) < length:
            raise MXNetError(f"truncated record in {self.uri}")
        pad = (4 - length % 4) % 4
        if pad:
            self.record.read(pad)
        return data

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self, _is_finalizing=_sys.is_finalizing):
        try:
            self.close()
        except AttributeError:
            pass    # the constructor failed before anything was open
        except Exception:  # noqa: BLE001
            if not _is_finalizing():
                raise


class MXIndexedRecordIO(MXRecordIO):
    """Random-access .rec through its .idx sidecar."""

    def __init__(self, idx_path, uri, flag, key_type=int):
        self.idx_path = idx_path
        self.idx = {}
        self.keys = []
        self.key_type = key_type
        super().__init__(uri, flag)

    def open(self):
        super().open()
        self.idx = {}
        self.keys = []
        self._scan_cache = None     # the framing scan, built lazily
        if not self.writable and os.path.isfile(self.idx_path):
            with open(self.idx_path) as fin:
                for line in fin:
                    parts = line.strip().split("\t")
                    if len(parts) >= 2:
                        key = self.key_type(parts[0])
                        self.idx[key] = int(parts[1])
                        self.keys.append(key)

    def close(self):
        if self.writable and self.idx:
            with open(self.idx_path, "w") as fout:
                for key in self.keys:
                    fout.write(f"{key}\t{self.idx[key]}\n")
        super().close()

    def seek(self, idx):
        self._check_pid()
        self.record.seek(self.idx[idx])

    def read_idx(self, idx):
        self.seek(idx)
        return self.read()

    def write_idx(self, idx, buf):
        key = self.key_type(idx)
        pos = self.tell()
        self.write(buf)
        self.idx[key] = pos
        self.keys.append(key)

    def _scan(self):
        """The file's framing scan (record starts, payload offsets,
        lengths), one C pass cached per open(); kept as uint64 arrays (an
        ImageNet .rec has ~1.3M records)."""
        if self._scan_cache is None:
            from . import native
            offs, lens = native.index_recordio(self.uri)
            self._scan_cache = (offs - 8, offs, lens)
        return self._scan_cache

    def payload_spans(self, indices):
        """``(offsets, lengths)`` of the payloads of ``indices`` (keys), for
        readers in other processes (the decode pool preads them).  An
        ``.idx`` position that is not a record start raises."""
        if self.writable:
            raise MXNetError("payload_spans: file opened for writing")
        positions = np.asarray([self.idx[self.key_type(i)] for i in indices],
                               np.uint64)
        starts, offs, lens = self._scan()
        rows = np.searchsorted(starts, positions)
        if len(positions) and (len(starts) == 0
                               or (rows >= len(starts)).any()
                               or (starts[np.minimum(rows, len(starts) - 1)]
                                   != positions).any()):
            raise MXNetError(f"{self.idx_path} names positions that are not "
                             f"record starts in {self.uri}")
        return offs[rows], lens[rows].astype(np.int64)

    def read_batch(self, indices):
        """The records of ``indices`` (keys), read in one C pass."""
        from . import native
        if self.writable:
            raise MXNetError("read_batch: file opened for writing")
        offs, lens = self.payload_spans(indices)
        return native.read_recordio_batch(self.uri, offs, lens)


def pack(header, s):
    """An IRHeader and a payload as one record body."""
    header = IRHeader(*header)
    if isinstance(header.label, (int, float)):
        hdr = struct.pack(_IR_FORMAT, 0, float(header.label), header.id,
                          header.id2)
        return hdr + s
    label = np.asarray(header.label, dtype=np.float32)
    hdr = struct.pack(_IR_FORMAT, label.size, 0.0, header.id, header.id2)
    return hdr + label.tobytes() + s


def unpack(s):
    """A record body as ``(IRHeader, payload)``."""
    flag, label, id_, id2 = struct.unpack(_IR_FORMAT, s[:_IR_SIZE])
    s = s[_IR_SIZE:]
    if flag > 0:
        label = np.frombuffer(s[:flag * 4], dtype=np.float32)
        s = s[flag * 4:]
    return IRHeader(flag, label, id_, id2), s


def pack_img(header, img, quality=95, img_fmt=".jpg"):
    """Pack an image given in BGR order (cv2's), encoded as JPEG at
    ``quality`` or as PNG at zlib level ``quality`` (clamped to 0-9)."""
    from . import codec
    return pack(header, codec.imencode(img_fmt, img, quality))


def unpack_img(s, iscolor=1):
    """``(IRHeader, image)``: BGR for ``iscolor`` > 0, HxW gray for 0, as
    stored for < 0 (cv2's flags)."""
    from . import codec
    header, img_bytes = unpack(s)
    return header, codec.imdecode_bgr(img_bytes, iscolor)
