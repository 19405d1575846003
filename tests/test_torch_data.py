"""The port's ``gluon.data`` (samplers, datasets, DataLoader) and
``gluon.data.vision.transforms`` held against the JAX package's, on the
CPU, and the port's DataLoader with worker processes.

Parity: the same numpy data (seeded), the same ``np.random.seed`` for the
shuffling samplers and the same ``random.seed`` for the random transforms;
batches and orders are compared exactly, transformed images to 1e-6 of
max |ref| (float32 elementwise math in both; the hue rotation is a 3x3
product).  The reference's loader runs with ``num_workers=0`` only: a
forked child of a process that imported JAX can deadlock in JAX
(``ROADMAP.md`` queue C).  Tests with workers use the port only, pass a
``timeout`` to the loader and shut its pool down in ``finally``.
"""

import os
import random

import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from mxnet_tpu_torch.gluon.data import dataloader as tdl


@pytest.fixture(autouse=True)
def _on_cpu():
    with mx.cpu():
        yield


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


# -- samplers and datasets ----------------------------------------------------

@pytest.mark.parametrize("last_batch", ["keep", "discard", "rollover"])
def test_samplers_match_reference(last_batch):
    out = {}
    for m in (jmx, mx):
        d = m.gluon.data
        np.random.seed(3)
        rand = list(d.RandomSampler(23))
        seq = list(d.SequentialSampler(5, start=2))
        filt = list(d.FilterSampler(lambda x: x % 3 == 0,
                                    d.SimpleDataset(list(range(20)))))
        bs = d.BatchSampler(d.SequentialSampler(10), 4, last_batch)
        epochs = [list(bs) for _ in range(3)]
        out[m] = (rand, seq, filt, epochs, len(bs))
    assert out[mx] == out[jmx]
    assert sorted(out[mx][0]) == list(range(23))


def test_datasets_match_reference():
    x = np.arange(24, dtype=np.float32).reshape(6, 4)
    y = np.arange(6)
    out = {}
    for m in (jmx, mx):
        d = m.gluon.data
        ds = d.ArrayDataset(x, y)
        lazy = ds.transform(lambda a, b: (a * 2, b + 1))
        eager = ds.transform_first(lambda a: a - 1, lazy=False)
        out[m] = ([ds[i] for i in range(len(ds))],
                  [lazy[i] for i in range(len(lazy))],
                  [eager[i] for i in range(len(eager))],
                  [v for v in ds.filter(lambda s: s[1] % 2 == 0)],
                  [v for v in d.SimpleDataset([1, 2, 3]).take(2)])
        with pytest.raises(m.MXNetError):
            d.ArrayDataset(x, y[:3])
    for a, b in zip(out[mx], out[jmx]):
        assert len(a) == len(b)
        for u, v in zip(a, b):
            for p, q in zip(u if isinstance(u, tuple) else (u,),
                            v if isinstance(v, tuple) else (v,)):
                assert np.array_equal(np.asarray(p), np.asarray(q))


@pytest.mark.parametrize("last_batch", ["keep", "discard", "rollover"])
@pytest.mark.parametrize("shuffle", [False, True])
def test_dataloader_without_workers_matches_reference(last_batch, shuffle):
    r = np.random.RandomState(0)
    x = r.randint(0, 255, (13, 6, 5, 3)).astype(np.uint8)
    y = r.randint(0, 10, (13,))
    got = {}
    for m in (jmx, mx):
        t = m.gluon.data.vision.transforms
        ds = m.gluon.data.ArrayDataset(m.nd.array(x), m.nd.array(y))
        ds = ds.transform_first(t.Compose([
            t.ToTensor(), t.Normalize(mean=(0.4, 0.5, 0.6),
                                      std=(0.2, 0.25, 0.3))]))
        loader = m.gluon.data.DataLoader(ds, batch_size=4, shuffle=shuffle,
                                         last_batch=last_batch)
        np.random.seed(5)
        got[m] = [[b.asnumpy() for b in batch] for _ in range(2)
                  for batch in loader]
        assert len(loader) == len(got[m]) // 2 or last_batch == "rollover"
    assert len(got[mx]) == len(got[jmx])
    for bt, bj in zip(got[mx], got[jmx]):
        assert bt[0].shape == bj[0].shape == (bt[0].shape[0], 3, 6, 5)
        assert _rel(bt[0], bj[0]) <= 1e-6
        assert np.array_equal(bt[1], bj[1])


def test_pin_memory_is_accepted_and_ignored_as_in_the_reference():
    r = np.random.RandomState(1)
    x = r.randn(10, 3, 4).astype(np.float32)
    y = r.randint(0, 10, (10,))
    for m in (jmx, mx):
        ds = m.gluon.data.ArrayDataset(x, y)
        got = {}
        for pin in (False, True):
            loader = m.gluon.data.DataLoader(ds, batch_size=4, shuffle=True,
                                             pin_memory=pin, pin_device_id=0)
            np.random.seed(3)
            got[pin] = [[b.asnumpy() for b in batch] for batch in loader]
        assert len(got[True]) == len(got[False]) == 3
        for a, b in zip(got[True], got[False]):
            assert all(np.array_equal(u, v) for u, v in zip(a, b))


def test_default_batchify_stacks_numpy_samples():
    for m in (jmx, mx):
        batch = m.gluon.data.dataloader.default_batchify_fn(
            [(np.ones((2, 2), np.float32) * i, i) for i in range(3)])
        assert batch[0].shape == (3, 2, 2) and batch[1].shape == (3,)
        assert batch[1].asnumpy().tolist() == [0, 1, 2]


def test_record_file_dataset_waits_for_recordio(tmp_path):
    """RecordFileDataset (once waiting for recordio) reads the records a
    reference writer packed, in .idx order, as the reference does."""
    rec, idx = str(tmp_path / "d.rec"), str(tmp_path / "d.idx")
    w = jmx.recordio.MXIndexedRecordIO(idx, rec, "w")
    for i in (3, 1, 2):
        w.write_idx(i, bytes([i]) * (i + 5))
    w.close()
    got, want = (m.gluon.data.RecordFileDataset(rec) for m in (mx, jmx))
    assert len(got) == len(want) == 3
    assert [got[i] for i in range(3)] == [want[i] for i in range(3)]


# -- transforms ---------------------------------------------------------------

TRANSFORMS = {
    "cast": lambda t: t.Cast("float16"),
    "to_tensor": lambda t: t.ToTensor(),
    "normalize": lambda t: t.Normalize(mean=(0.1, 0.2, 0.3),
                                       std=(0.5, 0.6, 0.7)),
    "compose": lambda t: t.Compose([t.ToTensor(), t.Normalize(0.5, 0.25)]),
    "flip_left_right": lambda t: t.RandomFlipLeftRight(),
    "flip_top_bottom": lambda t: t.RandomFlipTopBottom(),
    "brightness": lambda t: t.RandomBrightness(0.4),
    "contrast": lambda t: t.RandomContrast(0.4),
    "saturation": lambda t: t.RandomSaturation(0.4),
    "hue": lambda t: t.RandomHue(0.3),
    "color_jitter": lambda t: t.RandomColorJitter(0.3, 0.3, 0.3, 0.2),
    "lighting": lambda t: t.RandomLighting(0.5),
    "gray": lambda t: t.RandomGray(0.5),
}


@pytest.mark.parametrize("name", sorted(TRANSFORMS))
def test_transform_matches_reference(name):
    r = np.random.RandomState(sorted(TRANSFORMS).index(name))
    imgs = [r.uniform(0, 255, (5, 4, 3)).astype(np.float32)
            for _ in range(6)]
    if name in ("normalize",):
        imgs = [np.transpose(i / 255.0, (2, 0, 1)) for i in imgs]
    out = {}
    for m in (jmx, mx):
        fn = TRANSFORMS[name](m.gluon.data.vision.transforms)
        random.seed(7)
        np.random.seed(7)
        out[m] = [fn(m.nd.array(i)).asnumpy() for i in imgs]
    for a, b in zip(out[mx], out[jmx]):
        assert a.shape == b.shape and a.dtype == b.dtype
        assert _rel(a, b) <= 1e-6, name


def test_image_library_transforms_wait_for_the_decode_slice():
    """Resize, CenterCrop and RandomResizedCrop (once waiting for the
    decode slice) on a uint8 image: within 1 of the reference's cv2
    resize, under the same Python seed."""
    img = np.random.RandomState(4).randint(0, 256, (37, 50, 3)) \
        .astype(np.uint8)
    out = {}
    for m in (jmx, mx):
        t = m.gluon.data.vision.transforms
        random.seed(2)
        out[m] = [fn(m.nd.array(img)).asnumpy() for fn in (
            t.Resize(24), t.CenterCrop(20), t.RandomResizedCrop(16))]
    for a, b in zip(out[mx], out[jmx]):
        assert a.shape == b.shape and a.dtype == b.dtype
        assert np.abs(a.astype(int) - b).max() <= 1


# -- the port's DataLoader with worker processes ------------------------------

def _image_dataset(n=20, seed=0, flip=False):
    r = np.random.RandomState(seed)
    x = mx.nd.array(r.randint(0, 255, (n, 8, 6, 3)).astype(np.uint8))
    y = mx.nd.array(r.randint(0, 10, (n,)))
    t = mx.gluon.data.vision.transforms
    steps = [t.RandomFlipLeftRight()] if flip else []
    return mx.gluon.data.ArrayDataset(x, y).transform_first(t.Compose(
        steps + [t.ToTensor(), t.Normalize(mean=(0.485, 0.456, 0.406),
                                           std=(0.229, 0.224, 0.225))]))


def _epoch(loader, seed=1):
    np.random.seed(seed)
    return [[b.asnumpy() for b in batch] for batch in loader]


def _pool_processes(loader):
    return list(loader._pool._pool) if loader._pool is not None else []


def test_workers_give_the_batches_of_one_process_bit_for_bit():
    before = tdl.fallbacks
    ds = _image_dataset()
    want = _epoch(mx.gluon.data.DataLoader(ds, batch_size=6, shuffle=True,
                                           last_batch="discard"))
    # the pool is forked while the card is the default context: a worker
    # must still run the transforms on the host
    with mx.gpu():
        loader = mx.gluon.data.DataLoader(
            ds, batch_size=6, shuffle=True, last_batch="discard",
            num_workers=2, timeout=60)
    procs = _pool_processes(loader)
    try:
        got = _epoch(loader)
        again = _epoch(loader)
    finally:
        loader._shutdown_pool()
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert all(a.tobytes() == b.tobytes() for a, b in zip(g, w))
    assert all(a.tobytes() == b.tobytes() for x, y in zip(got, again)
               for a, b in zip(x, y))
    assert tdl.fallbacks == before
    assert len(procs) == 2 and not any(p.is_alive() for p in procs)


def test_worker_random_transforms_draw_from_pythons_random():
    loader = mx.gluon.data.DataLoader(_image_dataset(flip=True),
                                      batch_size=5, num_workers=2,
                                      timeout=60)
    try:
        batches = _epoch(loader)
    finally:
        loader._shutdown_pool()
    assert [b[0].shape for b in batches] == [(5, 3, 8, 6)] * 4
    assert all(np.isfinite(b[0]).all() for b in batches)


class _FailsInWorkers:
    """A dataset whose items raise in any process but its creator's."""

    def __init__(self, n):
        self._pid = os.getpid()
        self._n = n

    def __len__(self):
        return self._n

    def __getitem__(self, i):
        if os.getpid() != self._pid:
            raise RuntimeError("worker fault")
        return np.full((2,), i, np.float32)


def test_failed_worker_batches_are_refetched_then_the_pool_given_up():
    before = tdl.fallbacks
    loader = mx.gluon.data.DataLoader(_FailsInWorkers(12), batch_size=3,
                                      num_workers=2, timeout=60)
    procs = _pool_processes(loader)
    try:
        with pytest.warns(UserWarning):
            got = [b.asnumpy() for b in loader]
    finally:
        loader._shutdown_pool()
    assert [g[:, 0].tolist() for g in got] == [
        [0, 1, 2], [3, 4, 5], [6, 7, 8], [9, 10, 11]]
    # two refetches (MXNET_DATALOADER_RETRIES = 2), then one switch to a
    # single process for good
    assert tdl.fallbacks - before == 3
    assert loader._pool is None and not any(p.is_alive() for p in procs)


class _Slow:
    """Items that take a while, so that batches are still in flight."""

    def __len__(self):
        return 40

    def __getitem__(self, i):
        import time
        time.sleep(0.01)
        return np.full((2,), i, np.float32)


def test_shutdown_mid_epoch_lets_batches_in_flight_finish(monkeypatch):
    """A loader left mid-epoch shuts down after its batches in flight have
    arrived: Pool.terminate() with a worker still writing a large batch
    waits forever on the result pipe's lock (eight workers of 38.5 MB
    batches, on the CPU and on the card's machine)."""
    loader = mx.gluon.data.DataLoader(_Slow(), batch_size=4, num_workers=2,
                                      timeout=60)
    procs = _pool_processes(loader)
    pool = loader._pool
    pending, seen = [], []
    real = pool.terminate
    monkeypatch.setattr(pool, "terminate", lambda: (
        seen.append([r.ready() for _, r in pending]), real()))
    try:
        it = iter(loader)
        assert next(it).asnumpy()[:, 0].tolist() == [0, 1, 2, 3]
        pending.extend(loader._in_flight)   # prefetched batches outstanding
        assert pending and not all(r.ready() for _, r in pending)
    finally:
        loader._shutdown_pool()
    assert len(seen) == 1 and all(seen[0])
    assert loader._pool is None and not any(p.is_alive() for p in procs)
