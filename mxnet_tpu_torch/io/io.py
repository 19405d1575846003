"""The DataIter stack — the port of ``mxnet_tpu/io/io.py``.

``DataDesc``/``DataBatch``/``DataIter``, ``NDArrayIter`` (pad, discard and
roll_over), ``ResizeIter``, ``PrefetchingIter``, ``CSVIter``, ``MNISTIter``
and ``ImageRecordIter`` keep the reference's contract: the
``part_index``/``num_parts`` sharding, ``provide_data``/``provide_label``
and batch padding.  Batches are NDArrays on the current context (the
card), except where the caller passes ``ctx`` (``ImageRecordIter(
ctx=mx.cpu())`` keeps them on the host).  ``LibSVMIter`` yields CSR
batches, which need sparse storage: it raises.

``ImageRecordIter`` decodes with the port's codec.  ``_decode_record``
keeps the reference's two lanes, because they draw their augmentations
in different orders: the native lane (3 channels, no resize stage, a
JPEG payload that covers the crop) draws x0, then y0, then the mirror
coin, and decodes crop, mirror and normalize in one C call that multiplies
by 1/std; the generic lane (decode, shorter-side resize, crop) draws y0,
then x0, then the coin, and divides by std.  Draws come from
``numpy.random.RandomState(_mix_seed(epoch_seed, position))``, so every
record gets the reference's crop and mirror for the same seed, whoever
decodes it.  The reference's ``MXNET_USE_NATIVE=0`` (its cv2 lane) is not
read: the port has one decoder.
"""

from __future__ import annotations

import os
import queue as _queue
import threading
from collections import namedtuple

import numpy as np
import torch

from .. import ndarray as nd
from ..base import MXNetError
from ..context import Context, resolve_device
from ..ndarray.ndarray import NDArray

__all__ = ["DataDesc", "DataBatch", "DataIter", "NDArrayIter", "ResizeIter",
           "PrefetchingIter", "CSVIter", "MNISTIter", "ImageRecordIter",
           "LibSVMIter"]


class DataDesc(namedtuple("DataDesc", ["name", "shape", "dtype", "layout"])):
    def __new__(cls, name, shape, dtype=np.float32, layout="NCHW"):
        return super().__new__(cls, name, tuple(shape), dtype, layout)

    @staticmethod
    def get_batch_axis(layout):
        if layout is None:
            return 0
        return layout.find("N")


class DataBatch:
    def __init__(self, data, label=None, pad=None, index=None,
                 provide_data=None, provide_label=None):
        self.data = data
        self.label = label
        self.pad = pad
        self.index = index
        self.provide_data = provide_data
        self.provide_label = provide_label

    def __str__(self):
        return (f"DataBatch(data={[d.shape for d in self.data]}, "
                f"label={[l.shape for l in (self.label or [])]}, "
                f"pad={self.pad})")


class DataIter:
    def __init__(self, batch_size=0):
        self.batch_size = batch_size

    def __iter__(self):
        return self

    def reset(self):
        pass

    def next(self):
        if self.iter_next():
            return DataBatch(self.getdata(), self.getlabel(),
                             pad=self.getpad(), index=self.getindex())
        raise StopIteration

    __next__ = next

    def iter_next(self):
        raise NotImplementedError

    def getdata(self):
        raise NotImplementedError

    def getlabel(self):
        raise NotImplementedError

    def getindex(self):
        return None

    def getpad(self):
        return 0


def _init_data(data, allow_empty, default_name):
    """[(name, numpy array)] of the iterator's fields."""
    if data is None:
        if not allow_empty:
            raise MXNetError("data cannot be None")
        return []
    if isinstance(data, (NDArray, np.ndarray)):
        data = [data]
    if isinstance(data, (list, tuple)):
        data = {f"{default_name}{'_%d' % i if i else ''}": d
                for i, d in enumerate(data)}
    return [(k, v.asnumpy() if isinstance(v, NDArray) else np.asarray(v))
            for k, v in data.items()]


class NDArrayIter(DataIter):
    """Batches of in-memory arrays.  ``last_batch_handle`` 'pad' wraps
    round to fill the last batch and reports the pad, 'discard' drops it;
    'roll_over' wraps round like 'pad' with a pad of 0, as the reference
    does (MXNet 1.x carries the tail into the next epoch instead)."""

    def __init__(self, data, label=None, batch_size=1, shuffle=False,
                 last_batch_handle="pad", data_name="data",
                 label_name="softmax_label"):
        super().__init__(batch_size)
        self.data = _init_data(data, False, data_name)
        self.label = _init_data(label, True, label_name)
        self.num_data = self.data[0][1].shape[0]
        self.shuffle = shuffle
        self.last_batch_handle = last_batch_handle
        self.cursor = -batch_size
        self._cache_idx = np.arange(self.num_data)
        self.reset()

    @property
    def provide_data(self):
        return [DataDesc(k, (self.batch_size,) + v.shape[1:], v.dtype)
                for k, v in self.data]

    @property
    def provide_label(self):
        return [DataDesc(k, (self.batch_size,) + v.shape[1:], v.dtype)
                for k, v in self.label]

    def reset(self):
        self.cursor = -self.batch_size
        if self.shuffle:
            np.random.shuffle(self._cache_idx)

    def iter_next(self):
        self.cursor += self.batch_size
        if self.last_batch_handle == "discard":
            return self.cursor + self.batch_size <= self.num_data
        return self.cursor < self.num_data

    def _take(self, arrays):
        end = self.cursor + self.batch_size
        idx = self._cache_idx
        out = []
        for _, a in arrays:
            if end <= self.num_data:
                sel = a[idx[self.cursor:end]]
            else:                   # pad by wrapping round
                sel = np.concatenate([a[idx[self.cursor:]],
                                      a[idx[:end - self.num_data]]])
            out.append(nd.array(sel, dtype=sel.dtype))
        return out

    def getdata(self):
        return self._take(self.data)

    def getlabel(self):
        return self._take(self.label)

    def getpad(self):
        end = self.cursor + self.batch_size
        if self.last_batch_handle == "pad" and end > self.num_data:
            return end - self.num_data
        return 0


class ResizeIter(DataIter):
    """An iterator resized to ``size`` batches an epoch."""

    def __init__(self, data_iter, size, reset_internal=True):
        super().__init__(data_iter.batch_size)
        self.data_iter = data_iter
        self.size = size
        self.reset_internal = reset_internal
        self.cur = 0
        self.current_batch = None

    @property
    def provide_data(self):
        return self.data_iter.provide_data

    @property
    def provide_label(self):
        return self.data_iter.provide_label

    def reset(self):
        self.cur = 0
        if self.reset_internal:
            self.data_iter.reset()

    def iter_next(self):
        if self.cur == self.size:
            return False
        try:
            self.current_batch = self.data_iter.next()
        except StopIteration:
            self.data_iter.reset()
            self.current_batch = self.data_iter.next()
        self.cur += 1
        return True

    def next(self):
        if self.iter_next():
            return self.current_batch
        raise StopIteration

    __next__ = next


class PrefetchingIter(DataIter):
    """A thread that runs ahead of the consumer over one or more
    iterators (their batches merged)."""

    def __init__(self, iters, rename_data=None, rename_label=None,
                 prefetch_depth=2):  # noqa: ARG002
        if not isinstance(iters, list):
            iters = [iters]
        super().__init__(iters[0].batch_size)
        self.iters = iters
        self._depth = max(1, prefetch_depth)
        self._queue = _queue.Queue(maxsize=self._depth)
        self._stop = threading.Event()
        self._thread = None
        self._start()

    @property
    def provide_data(self):
        return sum([i.provide_data for i in self.iters], [])

    @property
    def provide_label(self):
        return sum([i.provide_label for i in self.iters], [])

    def _start(self):
        ctx = Context._default.__dict__.get("value")

        def loop():
            Context._default.value = ctx    # the consumer's context
            while not self._stop.is_set():
                try:
                    batches = [i.next() for i in self.iters]
                except StopIteration:
                    self._queue.put(None)
                    return
                self._queue.put(batches)
        self._thread = threading.Thread(target=loop, daemon=True)
        self._thread.start()

    def reset(self):
        self._stop.set()
        try:
            while True:
                self._queue.get_nowait()
        except _queue.Empty:
            pass
        if self._thread is not None:
            self._thread.join(timeout=5)
        for i in self.iters:
            i.reset()
        self._stop = threading.Event()
        self._queue = _queue.Queue(maxsize=self._depth)
        self._start()

    def next(self):
        batches = self._queue.get()
        if batches is None:
            raise StopIteration
        b = batches[0]
        if len(batches) > 1:
            b = DataBatch(sum([x.data for x in batches], []),
                          sum([x.label or [] for x in batches], []),
                          pad=batches[0].pad)
        return b

    __next__ = next

    def iter_next(self):
        raise NotImplementedError


class CSVIter(NDArrayIter):
    """CSV files -> batches (the reference's iter_csv)."""

    def __init__(self, data_csv, data_shape, label_csv=None, label_shape=(1,),
                 batch_size=1, round_batch=True, dtype=np.float32, **kwargs):
        data = np.loadtxt(data_csv, delimiter=",", dtype=dtype,
                          ndmin=2).reshape((-1,) + tuple(data_shape))
        label = None
        if label_csv is not None:
            label = np.loadtxt(label_csv, delimiter=",", dtype=dtype,
                               ndmin=2).reshape((-1,) + tuple(label_shape))
        super().__init__(data, label, batch_size,
                         last_batch_handle="pad" if round_batch else "discard",
                         **kwargs)


def _open_maybe_gz(path):
    import gzip
    return gzip.open(path, "rb") if path.endswith(".gz") else open(path, "rb")


class MNISTIter(NDArrayIter):
    """idx-ubyte files -> batches (the reference's iter_mnist)."""

    def __init__(self, image, label, batch_size=128, shuffle=True, flat=False,
                 part_index=0, num_parts=1, seed=0, **kwargs):  # noqa: ARG002
        import struct as _struct
        with _open_maybe_gz(label) as f:
            _struct.unpack(">II", f.read(8))
            lab = np.frombuffer(f.read(), dtype=np.uint8).astype(np.float32)
        with _open_maybe_gz(image) as f:
            _, n, r, c = _struct.unpack(">IIII", f.read(16))
            img = np.frombuffer(f.read(), dtype=np.uint8)
            img = img.reshape(n, 1, r, c).astype(np.float32) / 255.0
        if flat:
            img = img.reshape(n, r * c)
        shard = slice(part_index * n // num_parts,
                      (part_index + 1) * n // num_parts)
        super().__init__(img[shard], lab[shard], batch_size, shuffle=shuffle,
                         **kwargs)


class LibSVMIter(DataIter):
    """libsvm text -> CSR batches: needs sparse storage, which the port
    does not have yet (ROADMAP queue A item 10)."""

    def __init__(self, *args, **kwargs):  # noqa: ARG002
        raise MXNetError("LibSVMIter yields CSR batches, and sparse storage "
                         "is not yet ported (ROADMAP queue A item 10)")


def _mix_seed(seed, k):
    """Deterministic per-(seed, k) 32-bit stream split (splitmix-style
    avalanche): record k of an epoch gets the same draws whichever worker
    (or the parent) decodes it."""
    h = (int(seed) ^ (int(k) * 0x9E3779B1)) & 0xFFFFFFFF
    h = (h ^ (h >> 16)) * 0x85EBCA6B & 0xFFFFFFFF
    h = (h ^ (h >> 13)) * 0xC2B2AE35 & 0xFFFFFFFF
    return (h ^ (h >> 16)) & 0xFFFFFFFF


def _decode_record(raw, cfg, rng, out=None):
    """Decode and augment one packed image record: a pure function of
    (record bytes, cfg, rng), so it runs bit-identically in the parent, a
    thread or a decode-pool worker.  ``out`` (a float32 CHW view, such as
    a shared-memory slot) receives the pixels; the native lane writes it
    from C.  Returns ``(chw, label)``."""
    from .. import codec, native, recordio
    from ..image import resize_numpy
    header, img_bytes = recordio.unpack(raw)
    c, h, w = cfg["data_shape"]
    resize = cfg["resize"]
    label = header.label if np.isscalar(header.label) \
        else np.asarray(header.label).ravel()[0]
    if c == 3 and resize <= 0 and codec.is_jpeg(img_bytes):
        iw, ih, _ = native.jpeg_info(img_bytes)
        if iw >= w and ih >= h:
            if cfg["rand_crop"]:
                x0 = rng.randint(0, iw - w + 1)
                y0 = rng.randint(0, ih - h + 1)
            else:
                x0, y0 = (iw - w) // 2, (ih - h) // 2
            mirror = bool(cfg["rand_mirror"]) and rng.rand() < 0.5
            res = native.jpeg_decode_crop_norm(
                img_bytes, (h, w), crop_xy=(x0, y0), mirror=mirror,
                mean=cfg["mean"], std=cfg["std"], out=out)
            return res, np.float32(label)
    img = codec.imdecode_bgr(img_bytes, 1)[:, :, ::-1]
    if resize > 0:
        ih, iw = img.shape[:2]
        if ih < iw:
            img = resize_numpy(img, int(iw * resize / ih), resize)
        else:
            img = resize_numpy(img, resize, int(ih * resize / iw))
    ih, iw = img.shape[:2]
    if ih < h or iw < w:
        img = resize_numpy(img, max(w, iw), max(h, ih))
        ih, iw = img.shape[:2]
    if cfg["rand_crop"]:
        y0 = rng.randint(0, ih - h + 1)
        x0 = rng.randint(0, iw - w + 1)
    else:
        y0, x0 = (ih - h) // 2, (iw - w) // 2
    img = img[y0:y0 + h, x0:x0 + w]
    if cfg["rand_mirror"] and rng.rand() < 0.5:
        img = img[:, ::-1]
    img = (img.astype(np.float32) - cfg["mean"]) / cfg["std"]
    chw = img.transpose(2, 0, 1)
    if out is not None:
        out[:] = chw
        return out, np.float32(label)
    return chw, np.float32(label)


_DECODE_CFG = None


def _decode_worker_init(cfg):
    global _DECODE_CFG
    _DECODE_CFG = cfg
    torch.set_num_threads(1)


def _decode_worker(raw_seed):
    raw, seed = raw_seed
    return _decode_record(raw, _DECODE_CFG, np.random.RandomState(seed))


def _mp_context():
    """forkserver (spawn where there is none): never fork a parent that
    holds a CUDA context and runtime threads.  The fork server (a fresh
    process with no CUDA context) imports the decode modules once, so
    that each worker it forks starts with torch and the codec's module
    loaded instead of importing them again (this takes effect when this
    process starts its fork server)."""
    import multiprocessing as mp
    try:
        ctx = mp.get_context("forkserver")
    except ValueError:
        return mp.get_context("spawn")
    ctx.set_forkserver_preload(["mxnet_tpu_torch.io.pipeline"])
    return ctx


def _to_ctx(a, ctx):
    """A private numpy batch as an NDArray on ``ctx`` (None: the current
    context), one host-to-device copy."""
    t = torch.from_numpy(a)
    dev = resolve_device(ctx)
    return NDArray(t if dev.type == "cpu" else t.to(dev),
                   ctx if isinstance(ctx, Context) else None)


class ImageRecordIter(DataIter):
    """The ImageNet pipeline: a RecordIO pack, decode and augmentation on
    the host, batches on ``ctx`` (the current context when None).

    Parameters as the reference's: data_shape, batch_size, shuffle,
    rand_crop, rand_mirror, mean_[rgb], std_[rgb], resize,
    part_index/num_parts (sharding), preprocess_threads, seed.
    ``preprocess_threads=N`` with the default ``decoder='pool'`` runs the
    shared-memory decode pipeline (``io.pipeline``): N worker processes
    decode into shared batch slabs ahead of the consumer, and the batches
    are bit-identical to ``preprocess_threads=1``.  'threads' and
    'processes' map each batch over a thread or process pool.
    """

    def __init__(self, path_imgrec, data_shape, batch_size=1, shuffle=False,
                 rand_crop=False, rand_mirror=False, mean_r=0.0, mean_g=0.0,
                 mean_b=0.0, std_r=1.0, std_g=1.0, std_b=1.0, resize=-1,
                 part_index=0, num_parts=1, preprocess_threads=4,
                 label_width=1, path_imgidx=None, decoder="pool",
                 seed=None, ctx=None, **kwargs):  # noqa: ARG002
        super().__init__(batch_size)
        if decoder not in ("pool", "threads", "processes"):
            raise MXNetError(
                f"decoder {decoder!r}: want pool|threads|processes")
        self._decoder = decoder
        self._ctx = ctx
        from .. import recordio
        self._rec_path = path_imgrec
        idx_path = path_imgidx or os.path.splitext(path_imgrec)[0] + ".idx"
        if not os.path.exists(idx_path):
            raise MXNetError(
                f"ImageRecordIter requires an index file ({idx_path}); "
                "create it with tools/im2rec.py")
        self._rec = recordio.MXIndexedRecordIO(idx_path, path_imgrec, "r")
        self._keys = list(self._rec.keys[part_index::num_parts])
        self.data_shape = tuple(data_shape)
        self.shuffle = shuffle
        self.rand_crop = rand_crop
        self.rand_mirror = rand_mirror
        self.mean = np.array([mean_r, mean_g, mean_b], np.float32)
        self.std = np.array([std_r, std_g, std_b], np.float32)
        self.resize = resize
        # the base seed sets the shuffle order and every record's draws;
        # None draws one from numpy's global generator
        self._seed = int(seed) if seed is not None \
            else int(np.random.randint(0, 2 ** 31 - 1))
        self._epoch = -1
        self._epoch_seed = 0
        self._order = np.arange(len(self._keys))
        self._cursor = -batch_size
        self._threads = max(1, preprocess_threads)
        self._pool = None       # 'threads'/'processes' pool, made lazily
        self._pipeline = None   # the shared-memory pipeline (decoder=pool)
        self.reset()

    def close(self):
        if self._pool is not None:
            if hasattr(self._pool, "shutdown"):
                self._pool.shutdown(wait=False)
            else:
                self._pool.terminate()
            self._pool = None
        if self._pipeline is not None:
            self._pipeline.close()
            self._pipeline = None

    def __del__(self):
        try:
            self.close()
        except Exception:  # noqa: BLE001 (interpreter teardown)
            pass

    @property
    def provide_data(self):
        return [DataDesc("data", (self.batch_size,) + self.data_shape)]

    @property
    def provide_label(self):
        return [DataDesc("softmax_label", (self.batch_size,))]

    def reset(self):
        self._cursor = -self.batch_size
        self._epoch += 1
        self._epoch_seed = _mix_seed(self._seed, self._epoch)
        if self.shuffle:
            np.random.RandomState(self._epoch_seed).shuffle(self._order)
        if self._pipeline is not None:
            self._pipeline.drain()
            self._pipeline.begin(self._epoch_schedule())

    def iter_next(self):
        self._cursor += self.batch_size
        return self._cursor + self.batch_size <= len(self._keys)

    def _cfg(self):
        return {"rec_path": self._rec_path,
                "data_shape": self.data_shape, "resize": self.resize,
                "rand_crop": self.rand_crop, "rand_mirror": self.rand_mirror,
                "mean": self.mean, "std": self.std}

    def _seed_at(self, pos):
        return _mix_seed(self._epoch_seed, pos)

    def _epoch_schedule(self):
        """The epoch's batch plan [(keys, seeds), ...]."""
        out = []
        for b in range(len(self._keys) // self.batch_size):
            idxs = self._order[b * self.batch_size:(b + 1) * self.batch_size]
            out.append(([self._keys[i] for i in idxs],
                        [self._seed_at(b * self.batch_size + j)
                         for j in range(len(idxs))]))
        return out

    def _use_pipeline(self):
        from .. import config
        return (self._decoder == "pool" and self._threads > 1
                and config.get_int("MXNET_IO_POOL", 1))

    def _batch(self, imgs, labels):
        return DataBatch([_to_ctx(imgs, self._ctx)],
                         [_to_ctx(labels, self._ctx)], pad=0)

    def next(self):
        if not self.iter_next():
            raise StopIteration
        if self._use_pipeline():
            if self._pipeline is None:
                from .pipeline import PooledDecodePipeline
                self._pipeline = PooledDecodePipeline(
                    self._rec, self._cfg(), workers=self._threads,
                    slots=self.batch_size)
                self._pipeline.begin(self._epoch_schedule())
                for _ in range(self._cursor // self.batch_size):
                    self._pipeline.next_batch()
            return self._batch(*self._pipeline.next_batch())
        idxs = self._order[self._cursor:self._cursor + self.batch_size]
        seeds = [self._seed_at(self._cursor + j) for j in range(len(idxs))]
        # every record of the batch in one C pass before the fan-out
        raws = self._rec.read_batch([self._keys[i] for i in idxs])
        cfg = self._cfg()
        if self._threads > 1:
            if self._pool is None:
                from .. import native
                native.codec_lib()      # built before any worker starts
                if self._decoder == "processes":
                    self._pool = _mp_context().Pool(
                        self._threads, initializer=_decode_worker_init,
                        initargs=(cfg,))
                else:
                    from concurrent.futures import ThreadPoolExecutor
                    self._pool = ThreadPoolExecutor(self._threads)
            if self._decoder == "processes":
                results = self._pool.map(_decode_worker,
                                         list(zip(raws, seeds)))
            else:
                results = list(self._pool.map(
                    lambda rs: _decode_record(
                        rs[0], cfg, np.random.RandomState(rs[1])),
                    zip(raws, seeds)))
        else:
            results = [_decode_record(r, cfg, np.random.RandomState(s))
                       for r, s in zip(raws, seeds)]
        imgs = np.stack([r[0] for r in results])
        labels = np.asarray([r[1] for r in results], np.float32)
        return self._batch(imgs, labels)

    __next__ = next
