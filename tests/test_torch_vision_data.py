"""The port's vision datasets, the resize and crop transforms, the
decode-pool DataLoader and the image slice as a whole, held against the
JAX package on the CPU.

- MNIST, FashionMNIST, CIFAR10 and CIFAR100 read files the test writes
  (idx-ubyte with and without ``.gz``; the CIFAR pickle batches): samples
  and labels equal to the reference's, exactly; a missing root raises.
- ``ImageFolderDataset`` and ``ImageRecordDataset``: the same images (the
  decoders agree bit for bit) and labels.
- ``Resize`` (square, (w, h), shorter side with ``keep_ratio``),
  ``CenterCrop`` and ``RandomResizedCrop`` for all five interpolation
  codes, under the same Python seed: within 1 of the reference (cv2's
  resize on uint8).
- The decode-pool DataLoader (2 workers) over ``DecodedImageRecordDataset``
  is bit-identical to ``num_workers=0``, and to the reference's dataset
  within 5 raw units / std (its native lane, smooth images).
- The slice as a whole: a ``.rec`` the port writes feeds
  ``ImageRecordIter`` in both packages (centre crops; the reference's cv2
  lane), and ``resnet18_v1`` at 64x64 with the reference's weights
  carried by ``convert.load_by_name`` gives logits within 1e-4 of max
  |ref|.
"""

import gzip
import os
import pickle
import random
import struct
import threading

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import convert

cv2 = pytest.importorskip("cv2")

NET_TOL = 1e-4


@pytest.fixture(autouse=True)
def _on_cpu():
    with mx.cpu():
        yield


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _fresh(build):
    """``build()`` in a new thread: fresh prefix counters and scopes."""
    out = {}
    t = threading.Thread(target=lambda: out.setdefault("v", build()))
    t.start()
    t.join(timeout=120)
    assert not t.is_alive() and "v" in out
    return out["v"]


def _np(x):
    return x.asnumpy() if hasattr(x, "asnumpy") else np.asarray(x)


def _smooth(h, w, seed):
    r = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    a, b, c = r.uniform(0.5, 2.0, 3)
    img = np.stack([xx * a, yy * b, (xx + yy) * c / 2], -1) + r.uniform(0, 60)
    return np.clip(img, 0, 255).astype(np.uint8)


# -- the downloadable datasets, from local files ------------------------------

def _write_idx(root, prefix, n, gz, seed):
    r = np.random.RandomState(seed)
    imgs = r.randint(0, 256, (n, 28, 28)).astype(np.uint8)
    labs = r.randint(0, 10, n).astype(np.uint8)
    opener = gzip.open if gz else open
    ext = ".gz" if gz else ""
    with opener(os.path.join(root, f"{prefix}-images-idx3-ubyte{ext}"),
                "wb") as f:
        f.write(struct.pack(">IIII", 2051, n, 28, 28) + imgs.tobytes())
    with opener(os.path.join(root, f"{prefix}-labels-idx1-ubyte{ext}"),
                "wb") as f:
        f.write(struct.pack(">II", 2049, n) + labs.tobytes())


def _same_samples(name, root, **kw):
    tds = getattr(mx.gluon.data.vision, name)(root=root, **kw)
    jds = getattr(jmx.gluon.data.vision, name)(root=root, **kw)
    assert len(tds) == len(jds) > 0
    for i in (0, len(tds) // 2, len(tds) - 1):
        (tx, ty), (jx, jy) = tds[i], jds[i]
        assert tx.dtype == np.uint8 and tx.shape == jx.shape
        assert np.array_equal(_np(tx), _np(jx)) and int(ty) == int(jy)


@pytest.mark.parametrize("gz", [False, True], ids=["raw", "gz"])
@pytest.mark.parametrize("name", ["MNIST", "FashionMNIST"])
def test_mnist_family_reads_local_files(tmp_path, name, gz):
    _write_idx(tmp_path, "train", 12, gz, 1)
    _write_idx(tmp_path, "t10k", 5, gz, 2)
    for train in (True, False):
        _same_samples(name, str(tmp_path), train=train)


def test_cifar_reads_local_files(tmp_path):
    r = np.random.RandomState(3)
    c10 = tmp_path / "c10" / "cifar-10-batches-py"
    c10.mkdir(parents=True)
    for b in [f"data_batch_{i}" for i in range(1, 6)] + ["test_batch"]:
        with open(c10 / b, "wb") as f:
            pickle.dump({b"data": r.randint(0, 256, (3, 3072)).astype(
                np.uint8), b"labels": list(r.randint(0, 10, 3))}, f)
    c100 = tmp_path / "c100"
    c100.mkdir()
    for b in ("train", "test"):
        with open(c100 / b, "wb") as f:
            pickle.dump({b"data": r.randint(0, 256, (4, 3072)).astype(
                np.uint8), b"fine_labels": list(r.randint(0, 100, 4)),
                b"coarse_labels": list(r.randint(0, 20, 4))}, f)
    for train in (True, False):
        _same_samples("CIFAR10", str(tmp_path / "c10"), train=train)
        for fine in (True, False):
            _same_samples("CIFAR100", str(c100), train=train,
                          fine_label=fine)


def test_missing_root_raises(tmp_path):
    for name in ("MNIST", "CIFAR10"):
        with pytest.raises(mx.MXNetError, match="does not exist"):
            getattr(mx.gluon.data.vision, name)(root=str(tmp_path / "no"))


def test_transformed_mnist_batches(tmp_path):
    _write_idx(tmp_path, "train", 10, False, 4)
    out = {}
    for m in (jmx, mx):
        ds = m.gluon.data.vision.MNIST(str(tmp_path)).transform_first(
            m.gluon.data.vision.transforms.ToTensor())
        out[m] = [(_np(x), _np(y)) for x, y in
                  m.gluon.data.DataLoader(ds, batch_size=4)]
    for (tx, ty), (jx, jy) in zip(out[mx], out[jmx]):
        assert tx.shape == (4, 1, 28, 28) or tx.shape == (2, 1, 28, 28)
        assert np.abs(tx - jx).max() <= 1e-7 and np.array_equal(ty, jy)


# -- image datasets -----------------------------------------------------------

def test_image_folder_dataset_matches_reference(tmp_path):
    for k, cls in enumerate(("cat", "dog")):
        (tmp_path / cls).mkdir()
        for i in range(3):
            img = _smooth(30 + i, 40, 10 * k + i)
            ext = ".jpg" if i % 2 else ".png"
            ok, buf = cv2.imencode(ext, img)
            (tmp_path / cls / f"{i}{ext}").write_bytes(buf.tobytes())
    (tmp_path / "notes.txt").write_text("not a class")
    tds = mx.gluon.data.vision.ImageFolderDataset(str(tmp_path))
    jds = jmx.gluon.data.vision.ImageFolderDataset(str(tmp_path))
    assert tds.synsets == jds.synsets == ["cat", "dog"]
    assert len(tds) == len(jds) == 6
    for i in range(6):
        (tx, ty), (jx, jy) = tds[i], jds[i]
        assert ty == jy and np.array_equal(_np(tx), _np(jx))


def _write_rec(tmp_path, n, seed, size=(40, 64)):
    r = np.random.RandomState(seed)
    rec, idx = str(tmp_path / "d.rec"), str(tmp_path / "d.idx")
    w = mx.recordio.MXIndexedRecordIO(idx, rec, "w")
    for i in range(n):
        img = _smooth(r.randint(*size), r.randint(*size), seed * 100 + i)
        w.write_idx(i, mx.recordio.pack_img(
            mx.recordio.IRHeader(0, float(i % 3), i, 0), img, quality=95))
    w.close()
    return rec


def test_image_record_dataset_matches_reference(tmp_path):
    rec = _write_rec(tmp_path, 6, 1)
    tds = mx.gluon.data.vision.ImageRecordDataset(rec)
    jds = jmx.gluon.data.vision.ImageRecordDataset(rec)
    assert len(tds) == len(jds) == 6
    for i in range(6):
        (tx, ty), (jx, jy) = tds[i], jds[i]
        assert float(ty) == float(jy) and np.array_equal(_np(tx), _np(jx))
    assert mx.gluon.data.RecordFileDataset(rec)[2] == \
        jmx.gluon.data.RecordFileDataset(rec)[2]


TRANSFORMS = {
    "resize_square": lambda t, i: t.Resize(24, interpolation=i),
    "resize_wh": lambda t, i: t.Resize((30, 17), interpolation=i),
    "resize_keep_ratio": lambda t, i: t.Resize(20, keep_ratio=True,
                                               interpolation=i),
    "center_crop": lambda t, i: t.CenterCrop((20, 30), interpolation=i),
    "random_resized_crop": lambda t, i: t.RandomResizedCrop(
        24, interpolation=i),
}


@pytest.mark.parametrize("interp", range(5))
@pytest.mark.parametrize("name", sorted(TRANSFORMS))
def test_resize_transforms_match_reference(name, interp):
    r = np.random.RandomState(interp)
    imgs = [r.randint(0, 256, (33 + 4 * k, 45 - 3 * k, 3)).astype(np.uint8)
            for k in range(3)]
    out = {}
    for m in (jmx, mx):
        fn = TRANSFORMS[name](m.gluon.data.vision.transforms, interp)
        random.seed(9)
        out[m] = [_np(fn(m.nd.array(i))) for i in imgs]
    for a, b in zip(out[mx], out[jmx]):
        assert a.shape == b.shape and a.dtype == b.dtype == np.uint8
        assert np.abs(a.astype(int) - b).max() <= 1, name


# -- the decode-pool DataLoader -----------------------------------------------

def test_decode_pool_loader_bit_identical(tmp_path):
    rec = _write_rec(tmp_path, 20, 2)
    kw = dict(data_shape=(3, 32, 32), rand_crop=True, rand_mirror=True,
              mean=(123.68, 116.779, 103.939), std=(58.393, 57.12, 57.375),
              seed=5)
    ds = mx.gluon.data.vision.DecodedImageRecordDataset(rec, **kw)

    def epoch(loader):
        return [(_np(x), _np(y)) for x, y in loader]

    one = epoch(mx.gluon.data.DataLoader(ds, batch_size=6))
    loader = mx.gluon.data.DataLoader(ds, batch_size=6, num_workers=2,
                                      timeout=60)
    try:
        assert loader._use_decode_pool
        pooled = [epoch(loader), epoch(loader)]
    finally:
        loader._shutdown_pool()
    jds = jmx.gluon.data.vision.DecodedImageRecordDataset(rec, **kw)
    ref = epoch(jmx.gluon.data.DataLoader(jds, batch_size=6))
    std = np.asarray(kw["std"], np.float32).reshape(1, 3, 1, 1)
    for a, b, c, d in zip(one, pooled[0], pooled[1], ref):
        for u, v in ((a, b), (a, c)):
            assert np.array_equal(u[0], v[0]) and np.array_equal(u[1], v[1])
        assert np.array_equal(a[1], d[1])
        assert (np.abs(a[0] - d[0]) * std).max() <= 5.0 + 1e-3


# -- the slice as a whole -----------------------------------------------------

def test_rec_to_resnet18_matches_reference(tmp_path, monkeypatch):
    rec = _write_rec(tmp_path, 8, 3, size=(64, 90))
    # the reference's cv2 lane; its native libraries loaded first (a first
    # load under MXNET_USE_NATIVE=0 stays off for the rest of the process)
    jmx.native.recordio_lib()
    jmx.native.jpeg_lib()
    monkeypatch.setenv("MXNET_USE_NATIVE", "0")
    batches = {}
    for m in (jmx, mx):
        it = m.io.ImageRecordIter(
            path_imgrec=rec, data_shape=(3, 64, 64), batch_size=4,
            shuffle=True, rand_mirror=True, mean_r=123.68, mean_g=116.779,
            mean_b=103.939, std_r=58.393, std_g=57.12, std_b=57.375,
            seed=7, preprocess_threads=1, ctx=m.cpu())
        batches[m] = [(b.data[0], b.label[0]) for b in it]
    assert len(batches[mx]) == len(batches[jmx]) == 2
    for (tx, ty), (jx, jy) in zip(batches[mx], batches[jmx]):
        assert np.array_equal(_np(ty), _np(jy))
        assert np.abs(_np(tx) - _np(jx)).max() <= 1e-5

    def build(m):
        return m.gluon.model_zoo.vision.resnet18_v1(classes=10)

    seed_net = _fresh(lambda: build(mx))
    seed_net.initialize(mx.init.Xavier())
    seed_net(batches[mx][0][0])
    jnet = _fresh(lambda: build(jmx))
    for name, p in seed_net.collect_params().items():
        jnet.collect_params()[name].set_data(p.data().asnumpy())
    params = {k: p.data().asnumpy() for k, p in
              jnet.collect_params().items()}
    tnet = convert.load_by_name(_fresh(lambda: build(mx)), params,
                                device="cpu")
    jnet.hybridize()
    for (tx, _), (jx, _) in zip(batches[mx], batches[jmx]):
        with mx.autograd.predict_mode():
            got = _np(tnet(tx))
        with jmx.autograd.predict_mode():
            want = _np(jnet(jx))
        assert got.shape == (4, 10)
        err = np.abs(got - want).max() / np.abs(want).max()
        print(f"resnet18_v1 logits from the .rec: {err:.2e} of max |ref|")
        assert err <= NET_TOL
