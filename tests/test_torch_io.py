"""The port's ``mx.io`` and ``mx.image`` iterators held against the JAX
package's, on the CPU.

- ``NDArrayIter`` (every ``last_batch_handle``), ``CSVIter``,
  ``MNISTIter``, ``ResizeIter`` and ``PrefetchingIter``: batches and pads
  equal to the reference's, exactly.
- ``ImageRecordIter`` over a ``.rec`` the test writes (smooth images, the
  kind the reference's own native-decoder bound is stated on):
  - the native lane (crop within the JPEG, no resize) with random crops
    and mirrors: each image equals the port's full decode cropped and
    mirrored where a replay of the reference's draws (x0, y0, coin from
    ``RandomState(_mix_seed(...))``) puts it, and is within 5 raw units /
    std of the reference's native lane;
  - centre crops with mirrors against the reference's cv2 lane
    (``MXNET_USE_NATIVE=0``): within 1 raw unit / std (the decoders agree
    bit for bit; the lanes multiply by 1/std or divide by std);
  - the generic lane (``resize=256``-style shorter-side resize, here 40):
    within 1 raw unit / std of the reference (cv2's resize vs the port's,
    within 1 on uint8);
  - pooled (2 workers), 'threads' and 'processes' bit-identical to one
    process, and ``part_index``/``num_parts`` the reference's shards;
  - a pipeline worker killed with ``os.kill``: its chunks decode in this
    process, no record lost or duplicated (bit-identical epoch).
- ``ImageIter`` and ``ImageDetIter`` with their augmenters, under the same
  Python and numpy seeds: within 1 raw unit of the reference (its crops
  resize through cv2's bicubic, within 1 on uint8).

Tests that start worker processes use at most 2, bound every wait
(``MXNET_IO_TIMEOUT_S``) and close their pools in ``finally``.
"""

import os
import random
import signal
import struct
import time

import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import native
from mxnet_tpu_torch.io import io as tio
from mxnet_tpu_torch.io import pipeline as tpipe

cv2 = pytest.importorskip("cv2")

MEAN = (123.68, 116.779, 103.939)
STD = (58.393, 57.12, 57.375)


@pytest.fixture(autouse=True)
def _on_cpu(monkeypatch):
    monkeypatch.setenv("MXNET_IO_TIMEOUT_S", "60")
    with mx.cpu():
        yield


def _smooth(h, w, seed):
    """Gradients of slope <= 2 a pixel, as ``tests/test_native.py:187``'s
    image, on which the reference states its native decoder's bound."""
    r = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    a, b, c = r.uniform(0.5, 2.0, 3)
    img = np.stack([xx * a, yy * b, (xx + yy) * c / 2], -1) + r.uniform(0, 60)
    return np.clip(img, 0, 255).astype(np.uint8)


def _write_rec(tmp_path, n=24, seed=0, pkg=mx, fmt=".jpg"):
    """A .rec/.idx of n smooth BGR images 40-64 px a side, label i % 5."""
    r = np.random.RandomState(seed)
    rec, idx = str(tmp_path / "d.rec"), str(tmp_path / "d.idx")
    w = pkg.recordio.MXIndexedRecordIO(idx, rec, "w")
    for i in range(n):
        img = _smooth(r.randint(40, 65), r.randint(40, 65), seed * 100 + i)
        w.write_idx(i, pkg.recordio.pack_img(
            pkg.recordio.IRHeader(0, float(i % 5), i, 0), img, quality=95,
            img_fmt=fmt))
    w.close()
    return rec, idx


def _collect(pkg, rec, epochs=1, **kw):
    args = dict(path_imgrec=rec, data_shape=(3, 32, 32), batch_size=4,
                mean_r=MEAN[0], mean_g=MEAN[1], mean_b=MEAN[2],
                std_r=STD[0], std_g=STD[1], std_b=STD[2], seed=11,
                preprocess_threads=1, ctx=pkg.cpu())
    args.update(kw)
    it = pkg.io.ImageRecordIter(**args)
    out = []
    try:
        for e in range(epochs):
            if e:
                it.reset()
            out += [(b.data[0].asnumpy(), b.label[0].asnumpy()) for b in it]
    finally:
        it.close()
    return out


def _raw_units(got, want):
    """max |got - want| * std per channel, over a list of batches."""
    std = np.asarray(STD, np.float32).reshape(1, 3, 1, 1)
    return max(float((np.abs(g[0] - w[0]) * std).max())
               for g, w in zip(got, want))


# -- NDArrayIter and friends --------------------------------------------------

@pytest.mark.parametrize("handle", ["pad", "discard", "roll_over"])
@pytest.mark.parametrize("shuffle", [False, True])
def test_ndarray_iter_matches_reference(handle, shuffle):
    x = np.arange(70, dtype=np.float32).reshape(10, 7)
    y = np.arange(10, dtype=np.float32)
    out = {}
    for m in (jmx, mx):
        np.random.seed(5)
        it = m.io.NDArrayIter(x, y, batch_size=4, shuffle=shuffle,
                              last_batch_handle=handle)
        epochs = []
        for _ in range(2):
            epochs.append([(b.data[0].asnumpy(), b.label[0].asnumpy(),
                            b.pad) for b in it])
            it.reset()
        out[m] = (epochs, [tuple(d) for d in it.provide_data],
                  [tuple(d) for d in it.provide_label])
    (je, jd, jl), (te, td, tl) = out[jmx], out[mx]
    assert td == jd and tl == jl
    assert len(te[0]) == len(je[0]) and len(te[1]) == len(je[1])
    for a, b in zip(te[0] + te[1], je[0] + je[1]):
        assert np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])
        assert a[2] == b[2]


def test_csv_mnist_resize_prefetch_match_reference(tmp_path):
    r = np.random.RandomState(2)
    data = r.rand(13, 6).astype(np.float32)
    np.savetxt(tmp_path / "d.csv", data, delimiter=",")
    np.savetxt(tmp_path / "l.csv", np.arange(13), delimiter=",")
    imgs = r.randint(0, 256, (11, 28, 28)).astype(np.uint8)
    labs = r.randint(0, 10, 11).astype(np.uint8)
    with open(tmp_path / "img", "wb") as f:
        f.write(struct.pack(">IIII", 2051, 11, 28, 28) + imgs.tobytes())
    with open(tmp_path / "lab", "wb") as f:
        f.write(struct.pack(">II", 2049, 11) + labs.tobytes())

    def batches(it, n=None):
        out = []
        for i, b in enumerate(it):
            if n is not None and i == n:
                break
            out.append([d.asnumpy() for d in b.data + (b.label or [])]
                       + [b.pad])
        return out

    out = {}
    for m in (jmx, mx):
        csv = m.io.CSVIter(data_csv=str(tmp_path / "d.csv"), data_shape=(6,),
                           label_csv=str(tmp_path / "l.csv"), batch_size=5)
        mnist = m.io.MNISTIter(image=str(tmp_path / "img"),
                               label=str(tmp_path / "lab"), batch_size=4,
                               shuffle=False, flat=True, part_index=1,
                               num_parts=2)
        resized = m.io.ResizeIter(
            m.io.NDArrayIter(data, batch_size=5), size=7)
        pre = m.io.PrefetchingIter(m.io.NDArrayIter(data, batch_size=3))
        out[m] = [batches(csv), batches(mnist), batches(resized),
                  batches(pre)]
    for got, want in zip(out[mx], out[jmx]):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert all(np.array_equal(a, b) for a, b in zip(g[:-1], w[:-1]))
            assert g[-1] == w[-1]


def test_libsvm_iter_raises_naming_sparse_storage(tmp_path):
    with pytest.raises(mx.MXNetError, match="queue A item 10"):
        mx.io.LibSVMIter(data_libsvm=str(tmp_path / "x"), data_shape=(3,))


# -- ImageRecordIter ----------------------------------------------------------

def test_native_lane_crops_and_mirrors(tmp_path):
    """Random crops and mirrors: each image is the port's decode at the
    crop the reference's draws give, and within 5 raw units / std of the
    reference's native lane."""
    rec, idx = _write_rec(tmp_path)
    got = _collect(mx, rec, epochs=2, shuffle=True, rand_crop=True,
                   rand_mirror=True)
    want = _collect(jmx, rec, epochs=2, shuffle=True, rand_crop=True,
                    rand_mirror=True)
    assert len(got) == len(want) == 12
    for g, w in zip(got, want):
        assert np.array_equal(g[1], w[1])
    err = _raw_units(got, want)
    print(f"native lane vs the reference's: {err:.3f} raw units")
    assert err <= 5.0 + 1e-3
    # replay the draws of epoch 1 (x0, y0, then the coin)
    reader = mx.recordio.MXIndexedRecordIO(idx, rec, "r")
    eseed = tio._mix_seed(11, 1)
    order = np.arange(24)
    np.random.RandomState(tio._mix_seed(11, 0)).shuffle(order)
    np.random.RandomState(eseed).shuffle(order)
    mean, stdi = np.float32(MEAN), np.float32(1.0) / np.float32(STD)
    for pos in range(24):
        k = int(order[pos])
        _, buf = mx.recordio.unpack(reader.read_idx(k))
        full = native.jpeg_decode(buf, "rgb").astype(np.float32)
        ih, iw = full.shape[:2]
        rng = np.random.RandomState(tio._mix_seed(eseed, pos))
        x0 = rng.randint(0, iw - 32 + 1)
        y0 = rng.randint(0, ih - 32 + 1)
        crop = full[y0:y0 + 32, x0:x0 + 32]
        if rng.rand() < 0.5:
            crop = crop[:, ::-1]
        want_img = ((crop - mean) * stdi).transpose(2, 0, 1)
        assert np.array_equal(got[6 + pos // 4][0][pos % 4], want_img), pos


def _reference_cv2_lane(monkeypatch):
    """MXNET_USE_NATIVE=0 for the reference, after its native libraries
    are loaded: a first load under 0 would leave them off for the rest of
    the process (``mxnet_tpu/native.py`` caches the answer)."""
    jmx.native.recordio_lib()
    jmx.native.jpeg_lib()
    monkeypatch.setenv("MXNET_USE_NATIVE", "0")


def test_center_crops_match_the_reference_cv2_lane(tmp_path, monkeypatch):
    rec, _ = _write_rec(tmp_path, seed=1)
    got = _collect(mx, rec, rand_mirror=True)
    _reference_cv2_lane(monkeypatch)
    want = _collect(jmx, rec, rand_mirror=True)
    err = _raw_units(got, want)
    print(f"centre crops vs the reference's cv2 lane: {err:.2e} raw units")
    assert err <= 1.0


def test_generic_lane_matches_reference(tmp_path):
    rec, _ = _write_rec(tmp_path, seed=2, fmt=".png")
    kw = dict(resize=40, shuffle=True, rand_crop=True, rand_mirror=True)
    got, want = _collect(mx, rec, **kw), _collect(jmx, rec, **kw)
    err = _raw_units(got, want)
    print(f"resize lane vs the reference: {err:.3f} raw units")
    assert err <= 1.0 + 1e-3
    for g, w in zip(got, want):
        assert np.array_equal(g[1], w[1])


def test_pooled_and_pools_bit_identical(tmp_path):
    rec, _ = _write_rec(tmp_path, n=20, seed=3)
    kw = dict(shuffle=True, rand_crop=True, rand_mirror=True)
    one = _collect(mx, rec, epochs=2, preprocess_threads=1, **kw)
    for decoder in ("pool", "threads", "processes"):
        many = _collect(mx, rec, epochs=2, preprocess_threads=2,
                        decoder=decoder, **kw)
        assert len(many) == len(one) == 10
        for a, b in zip(one, many):
            assert np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])


def test_part_index_shards_match_reference(tmp_path):
    rec, _ = _write_rec(tmp_path, n=20, seed=4)
    for part in (0, 1, 2):
        kw = dict(part_index=part, num_parts=3, batch_size=3)
        got, want = _collect(mx, rec, **kw), _collect(jmx, rec, **kw)
        assert len(got) == len(want) == 2
        for g, w in zip(got, want):
            assert np.array_equal(g[1], w[1])
        assert _raw_units(got, want) <= 5.0 + 1e-3


def test_killed_worker_is_redecoded_in_process(tmp_path):
    """A worker killed mid-run: the next epoch's chunks on the dead pool
    decode in this process and the pool is rebuilt; both epochs equal a
    single-process run's."""
    rec, _ = _write_rec(tmp_path, n=24, seed=5)
    kw = dict(path_imgrec=rec, data_shape=(3, 32, 32), batch_size=4,
              shuffle=True, rand_crop=True, rand_mirror=True, seed=3,
              ctx=mx.cpu())

    def epochs(it):
        out = [(b.data[0].asnumpy(), b.label[0].asnumpy()) for b in it]
        it.reset()
        return out + [(b.data[0].asnumpy(), b.label[0].asnumpy())
                      for b in it]

    want = epochs(mx.io.ImageRecordIter(preprocess_threads=1, **kw))
    before = tpipe.episodes
    it = mx.io.ImageRecordIter(preprocess_threads=2, decoder="pool", **kw)
    try:
        b = next(it)
        got = [(b.data[0].asnumpy(), b.label[0].asnumpy())]
        pool = it._pipeline._pool
        pids = list(pool._processes)
        assert len(pids) == 2
        with pytest.warns(UserWarning, match="decode pool failure"):
            os.kill(pids[0], signal.SIGKILL)
            # wait until that executor has seen the death (the pipeline may
            # already have replaced it), so that the next epoch's tasks
            # cannot race ahead of the kill on the surviving worker
            deadline = time.monotonic() + 30
            while not pool._broken:
                assert time.monotonic() < deadline
                time.sleep(0.01)
            got += epochs(it)
    finally:
        it.close()
    assert tpipe.episodes > before
    assert len(got) == len(want) == 12
    for a, b in zip(got, want):
        assert np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])


def test_shared_memory_check_raises(tmp_path, monkeypatch):
    rec, idx = _write_rec(tmp_path, n=4, seed=6)
    reader = mx.recordio.MXIndexedRecordIO(idx, rec, "r")
    monkeypatch.setattr(tpipe, "shm_free_bytes", lambda: 1000)
    cfg = {"rec_path": rec, "data_shape": (3, 32, 32), "resize": -1,
           "rand_crop": False, "rand_mirror": False,
           "mean": np.zeros(3, np.float32), "std": np.ones(3, np.float32)}
    with pytest.raises(mx.MXNetError, match="has 1000 free"):
        tpipe.PooledDecodePipeline(reader, cfg, workers=2, slots=4)


# -- ImageIter and ImageDetIter -----------------------------------------------

def _det_rec(pkg, tmp_path, n=8):
    r = np.random.RandomState(7)
    rec, idx = str(tmp_path / "det.rec"), str(tmp_path / "det.idx")
    w = pkg.recordio.MXIndexedRecordIO(idx, rec, "w")
    for i in range(n):
        objs = []
        for _ in range(r.randint(1, 4)):
            x0, y0 = r.uniform(0, 0.6, 2)
            objs += [r.randint(0, 3), x0, y0, x0 + r.uniform(0.2, 0.4),
                     y0 + r.uniform(0.2, 0.4)]
        label = np.array([2, 5] + objs, np.float32)
        img = _smooth(r.randint(40, 60), r.randint(40, 60), 300 + i)
        w.write_idx(i, pkg.recordio.pack_img(
            pkg.recordio.IRHeader(0, label, i, 0), img, quality=95))
    w.close()
    return rec


def _iter_batches(it, n):
    out = []
    for _ in range(n):
        b = next(it)
        out.append((b.data[0].asnumpy(), b.label[0].asnumpy()))
    return out


def test_image_iter_matches_reference(tmp_path):
    rec, _ = _write_rec(tmp_path, n=12, seed=8)
    out = {}
    for m in (jmx, mx):
        random.seed(3)
        np.random.seed(3)
        it = m.image.ImageIter(batch_size=4, data_shape=(3, 32, 32),
                               path_imgrec=rec, shuffle=True, rand_crop=True,
                               rand_mirror=True, mean=True, std=True)
        out[m] = _iter_batches(it, 3)
    for g, w in zip(out[mx], out[jmx]):
        assert np.array_equal(g[1], w[1])
        assert np.abs(g[0] - w[0]).max() * 58.395 <= 1.0 + 1e-3


def test_image_det_iter_matches_reference(tmp_path):
    rec = _det_rec(mx, tmp_path)
    out = {}
    for m in (jmx, mx):
        random.seed(4)
        np.random.seed(4)
        it = m.image.ImageDetIter(batch_size=4, data_shape=(3, 32, 32),
                                  path_imgrec=rec, shuffle=True, rand_crop=0.5,
                                  rand_pad=0.5, rand_mirror=True,
                                  mean=(10, 20, 30), std=(50, 60, 70))
        out[m] = (_iter_batches(it, 2), it.label_shape)
    assert out[mx][1] == out[jmx][1]
    for g, w in zip(out[mx][0], out[jmx][0]):
        assert np.allclose(g[1], w[1], rtol=0, atol=1e-6)
        assert np.abs(g[0] - w[0]).max() * 70 <= 1.0 + 1e-3
