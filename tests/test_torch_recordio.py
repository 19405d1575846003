"""The port's RecordIO (``mxnet_tpu_torch/recordio.py`` over the C++
framing scanner ``src/recordio.cc``) held against the JAX package's, on
the CPU.

Records written by either package are read by the other bit for bit (the
files themselves are byte-identical); the C scan of a file equals a scan
in Python; a truncated tail raises.  Packed images cross packages: a JPEG
the port packs decodes in the reference (cv2) to the port's own decode
exactly, and a PNG the reference packs unpacks in the port exactly.
"""

import os
import struct

import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import native


def _payloads(n=17, seed=0):
    r = np.random.RandomState(seed)
    return [r.randint(0, 256, r.randint(0, 300)).astype(np.uint8).tobytes()
            for _ in range(n)]


def _write(pkg, tmp_path, tag, payloads):
    rec, idx = str(tmp_path / f"{tag}.rec"), str(tmp_path / f"{tag}.idx")
    w = pkg.recordio.MXIndexedRecordIO(idx, rec, "w")
    for i, p in enumerate(payloads):
        w.write_idx(i, p)
    w.close()
    return rec, idx


def _python_scan(path):
    """(payload offsets, lengths) by walking the framing in Python."""
    data = open(path, "rb").read()
    pos, offs, lens = 0, [], []
    while pos < len(data):
        magic, lrec = struct.unpack("<II", data[pos:pos + 8])
        assert magic == 0xced7230a
        n = lrec & ((1 << 29) - 1)
        offs.append(pos + 8)
        lens.append(n)
        pos += 8 + n + (4 - n % 4) % 4
    return offs, lens


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_records_cross_packages(tmp_path, writer):
    payloads = _payloads()
    w, r = (mx, jmx) if writer == "port" else (jmx, mx)
    rec, idx = _write(w, tmp_path, "a", payloads)
    other = _write(r, tmp_path, "b", payloads)
    assert open(rec, "rb").read() == open(other[0], "rb").read()
    assert open(idx).read() == open(other[1]).read()
    for pkg in (mx, jmx):
        reader = pkg.recordio.MXIndexedRecordIO(idx, rec, "r")
        assert [reader.read_idx(i) for i in range(len(payloads))] == payloads
        order = [5, 0, 16, 3, 3]
        assert reader.read_batch(order) == [payloads[i] for i in order]
        reader.close()
        seq = pkg.recordio.MXRecordIO(rec, "r")
        got = []
        while (b := seq.read()) is not None:
            got.append(b)
        assert got == payloads
        seq.close()


def test_framing_scan_matches_python(tmp_path):
    rec, _ = _write(mx, tmp_path, "a", _payloads(40, seed=3))
    offs, lens = native.index_recordio(rec)
    want_o, want_l = _python_scan(rec)
    assert offs.tolist() == want_o and lens.tolist() == want_l
    empty = tmp_path / "empty.rec"
    empty.write_bytes(b"")
    assert native.index_recordio(str(empty))[0].size == 0


def test_truncated_tail_raises(tmp_path):
    payloads = _payloads(5, seed=1)
    payloads[-1] = b"x" * 100
    rec, idx = _write(mx, tmp_path, "a", payloads)
    data = open(rec, "rb").read()
    open(rec, "wb").write(data[:-50])
    reader = mx.recordio.MXIndexedRecordIO(idx, rec, "r")
    with pytest.raises(mx.MXNetError, match="truncated|framing"):
        reader.read_batch([0])
    with pytest.raises(mx.MXNetError, match="truncated"):
        reader.read_idx(4)
    with pytest.raises(mx.MXNetError):
        native.index_recordio(str(tmp_path / "missing.rec"))


@pytest.mark.parametrize("label", [3.0, [1.0, 2.5, -4.0]],
                         ids=["scalar", "vector"])
def test_pack_unpack_match_reference(label):
    hdr = (0, label, 7, 11)
    body = mx.recordio.pack(hdr, b"payload")
    assert body == jmx.recordio.pack(hdr, b"payload")
    h1, s1 = mx.recordio.unpack(body)
    h0, s0 = jmx.recordio.unpack(body)
    assert s1 == s0 == b"payload"
    assert h1.flag == h0.flag and h1.id == h0.id and h1.id2 == h0.id2
    assert np.array_equal(np.asarray(h1.label), np.asarray(h0.label))


def test_pack_img_crosses_packages():
    cv2 = pytest.importorskip("cv2")
    r = np.random.RandomState(4)
    yy, xx = np.mgrid[0:48, 0:64]
    bgr = np.clip(np.stack([xx * 3, yy * 4, xx + yy], -1)
                  + r.randn(48, 64, 3) * 4, 0, 255).astype(np.uint8)
    hdr = mx.recordio.IRHeader(0, 2.0, 5, 0)
    # the port's JPEG, read by the reference through cv2
    s = mx.recordio.pack_img(hdr, bgr, quality=90)
    h_ref, img_ref = jmx.recordio.unpack_img(s)
    h_got, img_got = mx.recordio.unpack_img(s)
    assert h_got.label == h_ref.label == 2.0
    assert np.array_equal(img_got, img_ref)
    assert np.abs(img_got.astype(int) - bgr).mean() < 4
    # the reference's PNG, read by the port; gray as cv2 returns it
    s = jmx.recordio.pack_img(hdr, bgr, quality=3, img_fmt=".png")
    assert np.array_equal(mx.recordio.unpack_img(s)[1], bgr)
    assert np.array_equal(mx.recordio.unpack_img(s, 0)[1],
                          jmx.recordio.unpack_img(s, 0)[1])
    s = mx.recordio.pack_img(hdr, bgr, img_fmt=".png")
    assert np.array_equal(cv2.imdecode(np.frombuffer(
        mx.recordio.unpack(s)[1], np.uint8), cv2.IMREAD_COLOR), bgr)


def test_payload_spans_and_pid_check(tmp_path):
    payloads = _payloads(9, seed=2)
    rec, idx = _write(mx, tmp_path, "a", payloads)
    reader = mx.recordio.MXIndexedRecordIO(idx, rec, "r")
    offs, lens = reader.payload_spans([2, 7])
    data = open(rec, "rb").read()
    for k, o, n in zip((2, 7), offs, lens):
        assert data[int(o):int(o) + int(n)] == payloads[k]
    reader.pid = -1         # as if inherited by a forked child
    assert reader.read_idx(1) == payloads[1]
    assert reader.pid == os.getpid()
    with pytest.raises(mx.MXNetError, match="writing"):
        mx.recordio.MXIndexedRecordIO(str(tmp_path / "w.idx"),
                                      str(tmp_path / "w.rec"),
                                      "w").payload_spans([0])
