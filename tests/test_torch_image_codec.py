"""The port's image codec held against cv2 and the reference's native
decoder, on the CPU: the JPEG decoder and encoder of
``mxnet_tpu_torch/src/image_codec.cc`` (built here with the host C++
compiler) and the PNG codec of ``mxnet_tpu_torch/codec.py``.

Tolerances:
- JPEG decode: within 1 of ``cv2.imdecode`` (libjpeg-turbo at its
  defaults) on every pixel; the codec follows libjpeg's islow IDCT, fancy
  upsampling and colour tables, and the share of exact pixels is printed;
- ``jpeg_decode_crop_norm``: equal to the port's own full decode cropped,
  mirrored and normalized (a photo-like image), and within 5 raw units /
  std of the reference's native fused decoder (libjpeg's IFAST IDCT
  without fancy upsampling) on a smooth gradient, the reference's own
  bound and kind of image (``tests/test_native.py:187-202``);
- the encoder: cv2 decodes its output at a PSNR of >= 40 dB at quality 95
  and >= 34 dB at 75 on a photo-like image (a smooth field and grain);
- PNG: bit-exact both ways.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import codec, native

cv2 = pytest.importorskip("cv2")


def _photo(h, w, c=3, seed=0, grain=12.0):
    """A smooth colour field with grain, as a uint8 HxWxC image."""
    r = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.stack([128 + 100 * np.sin(xx / 17.0 + k) * np.cos(yy / 23.0 - k)
                     for k in range(c)], -1)
    img = np.clip(base + r.randn(h, w, c) * grain, 0, 255).astype(np.uint8)
    return img[:, :, 0] if c == 1 else img


S = cv2.IMWRITE_JPEG_SAMPLING_FACTOR
JPEGS = {
    "420_q95": ((61, 83), 95, {}),
    "420_q75": ((120, 160), 75, {}),
    "444_q95": ((37, 45), 95, {S: cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444}),
    "444_q75": ((37, 45), 75, {S: cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444}),
    "422": ((37, 45), 90, {S: cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422}),
    "440": ((37, 45), 90, {S: cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440}),
    "restart": ((50, 70), 90, {cv2.IMWRITE_JPEG_RST_INTERVAL: 3}),
    "size_3x2": ((3, 2), 95, {}),
    "size_9x17": ((9, 17), 95, {}),
    "gray": ((45, 51), 90, {}),
}


def _jpeg(name):
    (h, w), q, extra = JPEGS[name]
    img = _photo(h, w, 1 if name == "gray" else 3, seed=len(name))
    params = [cv2.IMWRITE_JPEG_QUALITY, q]
    for k, v in extra.items():
        params += [k, v]
    ok, buf = cv2.imencode(".jpg", img, params)
    assert ok
    return buf.tobytes()


def _check_lsb(got, want, what):
    d = np.abs(got.astype(np.int32) - want.astype(np.int32))
    print(f"{what}: max |diff| {d.max()}, exact {np.mean(d == 0):.6f}")
    assert got.shape == want.shape and d.max() <= 1, what


@pytest.mark.parametrize("name", sorted(JPEGS))
def test_jpeg_decode_matches_cv2(name):
    buf = _jpeg(name)
    arr = np.frombuffer(buf, np.uint8)
    _check_lsb(codec.imdecode_bgr(buf, 1), cv2.imdecode(arr, cv2.IMREAD_COLOR),
               f"{name} colour")
    # flag 0 on a colour file is libjpeg's Y plane, not a weighted gray
    _check_lsb(codec.imdecode_bgr(buf, 0),
               cv2.imdecode(arr, cv2.IMREAD_GRAYSCALE), f"{name} gray")
    h, w = cv2.imdecode(arr, cv2.IMREAD_COLOR).shape[:2]
    assert native.jpeg_info(buf)[:2] == (w, h)


def test_imdecode_channel_orders():
    """imdecode gives RGB (BGR with to_rgb=False) and HxWx1 for flag 0;
    unpack_img gives BGR, as cv2."""
    buf = _jpeg("444_q95")
    bgr = cv2.imdecode(np.frombuffer(buf, np.uint8), cv2.IMREAD_COLOR)
    with mx.cpu():
        rgb = mx.image.imdecode(buf).asnumpy()
        raw = mx.image.imdecode(buf, to_rgb=False).asnumpy()
        gray = mx.image.imdecode(buf, flag=0).asnumpy()
    assert np.array_equal(rgb, bgr[:, :, ::-1])
    assert np.array_equal(raw, bgr)
    assert gray.shape == bgr.shape[:2] + (1,) and gray.dtype == np.uint8
    hdr, img = mx.recordio.unpack_img(
        mx.recordio.pack(mx.recordio.IRHeader(0, 1.0, 0, 0), buf))
    assert np.array_equal(img, bgr)


CROPS = [((224, 224), (0, 0), False), ((224, 224), (37, 11), True),
         ((100, 150), None, True), ((341, 480), (5, 0), False)]


@pytest.mark.parametrize("crop_hw,crop_xy,mirror", CROPS)
def test_decode_crop_norm(crop_hw, crop_xy, mirror):
    import mxnet_tpu.native as ref_native
    img = _photo(341, 480, seed=3)
    ok, buf = cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_QUALITY, 95])
    buf = buf.tobytes()
    mean = np.array([123.68, 116.779, 103.939], np.float32)
    std = np.array([58.393, 57.12, 57.375], np.float32)
    got = native.jpeg_decode_crop_norm(buf, crop_hw, crop_xy, mirror,
                                       mean, std)
    h, w = crop_hw
    full = native.jpeg_decode(buf, "rgb").astype(np.float32)
    x0, y0 = crop_xy if crop_xy is not None else ((480 - w) // 2,
                                                  (341 - h) // 2)
    x0, y0 = min(x0, 480 - w), min(y0, 341 - h)     # clamped into the image
    want = full[y0:y0 + h, x0:x0 + w]
    if mirror:
        want = want[:, ::-1]
    want = ((want - mean) * (np.float32(1.0) / std)).transpose(2, 0, 1)
    assert np.array_equal(got, want)
    if not ref_native.jpeg_decode_available():
        pytest.skip("the reference's native decoder is not built here")
    # the reference's bound holds on smooth content (its IFAST decode and
    # box-upsampled chroma are off by tens of units on grain)
    yy, xx = np.mgrid[0:341, 0:480]
    grad = np.stack([xx * 255 // 480, yy * 255 // 341,
                     (xx + yy) * 255 // 821], -1).astype(np.uint8)
    ok, buf = cv2.imencode(".jpg", grad, [cv2.IMWRITE_JPEG_QUALITY, 95])
    buf = buf.tobytes()
    got = native.jpeg_decode_crop_norm(buf, crop_hw, crop_xy, mirror,
                                       mean, std)
    ref = ref_native.jpeg_decode_crop_norm(buf, crop_hw, crop_xy, mirror,
                                           mean=mean, std=std)
    err = np.abs(got - ref).max(axis=(1, 2)) * std
    print(f"crop {crop_hw} at {crop_xy}: max raw units vs the reference's "
          f"IFAST decode {err.max():.3f}")
    assert (err <= 5.0 + 1e-3).all()


def _psnr(a, b):
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return 10 * np.log10(255.0 ** 2 / mse)


@pytest.mark.parametrize("quality,floor", [(95, 40.0), (75, 34.0)])
@pytest.mark.parametrize("channels", [3, 1])
def test_jpeg_encoder_decodes_in_cv2(quality, floor, channels):
    img = _photo(123, 157, channels, seed=5, grain=2.0)
    enc = codec.imencode(".jpg", img, quality)
    flag = cv2.IMREAD_COLOR if channels == 3 else cv2.IMREAD_GRAYSCALE
    dec = cv2.imdecode(np.frombuffer(enc, np.uint8), flag)
    ok, cvbuf = cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_QUALITY, quality])
    ours, theirs = _psnr(dec, img), _psnr(cv2.imdecode(cvbuf, flag), img)
    print(f"q{quality} c{channels}: {len(enc)} B at {ours:.2f} dB "
          f"(cv2 {cvbuf.size} B at {theirs:.2f} dB)")
    assert dec.shape == img.shape and ours >= floor
    # the port reads its own files as cv2 does
    assert np.array_equal(codec.imdecode_bgr(enc, 1 if channels == 3 else 0),
                          dec)


@pytest.mark.parametrize("shape", [(23, 31, 3), (17, 9), (20, 21, 4)],
                         ids=["bgr", "gray", "bgra"])
def test_png_round_trip_with_cv2(shape):
    img = np.random.RandomState(1).randint(0, 256, shape).astype(np.uint8)
    img[:5] = 7     # flat rows, so that every row filter is in use
    ok, buf = cv2.imencode(".png", img)
    for flag in (1, 0, -1):
        want = cv2.imdecode(buf, flag)
        got = codec.imdecode_bgr(buf.tobytes(), flag)
        assert got.shape == want.shape and np.array_equal(got, want), flag
    back = cv2.imdecode(np.frombuffer(codec.imencode(".png", img, 6),
                                      np.uint8), cv2.IMREAD_UNCHANGED)
    assert np.array_equal(back, img)


def test_unsupported_and_garbage_raise():
    ok, prog = cv2.imencode(".jpg", _photo(40, 40),
                            [cv2.IMWRITE_JPEG_PROGRESSIVE, 1])
    with pytest.raises(mx.MXNetError, match=r"progressive JPEG \(SOF2\)"):
        codec.imdecode_bgr(prog.tobytes(), 1)
    good = _jpeg("420_q95")
    for bad in (b"garbage" * 10, good[:40], b"\xff\xd8\xff\xd9"):
        with pytest.raises(mx.MXNetError):
            codec.imdecode_bgr(bad, 1)
    ok, png16 = cv2.imencode(".png", np.zeros((4, 4), np.uint16))
    with pytest.raises(mx.MXNetError, match="16-bit PNG"):
        codec.imdecode_bgr(png16.tobytes(), 1)
    with pytest.raises(mx.MXNetError, match="smaller than the crop"):
        native.jpeg_decode_crop_norm(good, (100, 100))


def test_concurrent_first_builds(tmp_path):
    """Three processes build the codec into an empty directory at once:
    each loads a whole library (the compiler writes a temporary file that
    is renamed), and no temporary file is left."""
    code = ("import sys, numpy as np; from mxnet_tpu_torch import native; "
            "native.BUILD_DIR = sys.argv[1]; "
            "print(native.jpeg_info(open(sys.argv[2], 'rb').read()))")
    path = tmp_path / "x.jpg"
    path.write_bytes(_jpeg("420_q95"))
    env = dict(os.environ, PYTHONPATH=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    procs = [subprocess.Popen([sys.executable, "-c", code,
                               str(tmp_path / "b"), str(path)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True, env=env) for _ in range(3)]
    outs = [p.communicate(timeout=120) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
        assert out.strip() == "(83, 61, 3)"
    files = os.listdir(tmp_path / "b")
    assert len(files) == 1 and files[0].endswith(".so"), files
