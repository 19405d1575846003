"""The multi-process record -> decode -> batch pipeline — the port of
``mxnet_tpu/io/pipeline.py``.

- **Shared-memory batch slabs** (``_Slab``): each in-flight batch owns a
  ``multiprocessing.shared_memory`` segment of ``slots`` CxHxW float32
  images and a label lane.  Workers write pixels straight into the slab
  (the codec's ``jpeg_decode_crop_norm`` takes the slot as its output), so
  no image bytes cross a pipe; a task answers with its record count.  At
  start the pipeline checks that the slabs (``MXNET_IO_PREFETCH`` + 1 of
  them) fit in ``/dev/shm`` and raises with both sizes if they do not: a
  worker writing past a full ``/dev/shm`` would die of SIGBUS.
- **A persistent decode pool with ordered chunks**
  (``PooledDecodePipeline``): each batch splits into chunks of records
  over N worker processes (forkserver, else spawn: never a fork of a
  parent with a CUDA context).  Workers ``pread`` the payload spans that
  the parent resolved with the framing scan, and handle numpy and the
  ctypes codec only; none touches CUDA.  Every record's draws come from
  a ``RandomState`` seeded per (epoch, position) (``io._mix_seed``), so
  batches are bit-identical to single-process decode.
- **Prefetch with an assembler thread**: ``MXNET_IO_PREFETCH`` batches
  decode ahead of the consumer; one thread collects finished slabs,
  copies them into private arrays and recycles the slab, so ``next_batch``
  hands over arrays that are already whole.

Failures ride the DataLoader's ladder: a dead, hung (``MXNET_IO_TIMEOUT_S``)
or failing worker starts one episode — the pool is hard-killed (a hung
worker could otherwise wake and write into a recycled slab), each
affected chunk is decoded again in this process from the same seeds
(nothing lost or duplicated), and the pool is rebuilt; after
``MXNET_DATALOADER_RETRIES`` episodes decoding stays in this process for
good.  Each episode warns and adds one to the module counter ``episodes``.
"""

from __future__ import annotations

import os
import threading
import warnings
from collections import deque
from multiprocessing import shared_memory

import numpy as np

from .. import config
from ..base import MXNetError

__all__ = ["PooledDecodePipeline", "shm_free_bytes"]

_SHM = "/dev/shm"

episodes = 0
"""Decode-pool failure episodes in this process: 0 while workers are
healthy."""


def shm_free_bytes():
    """Bytes free for shared memory (``/dev/shm``)."""
    st = os.statvfs(_SHM)
    return st.f_bavail * st.f_frsize


# -- worker side (forkserver/spawn children) ----------------------------------

_W_CFG = None
_W_FD = -1
_W_SLABS: dict = {}


def _worker_init(cfg):
    global _W_CFG, _W_FD
    import torch
    _W_CFG = cfg
    _W_FD = -1
    torch.set_num_threads(1)


def _worker_fd():
    global _W_FD
    if _W_FD < 0:
        _W_FD = os.open(_W_CFG["rec_path"], os.O_RDONLY)
    return _W_FD


def _attach_slab(name):
    """numpy views over a slab the parent made, cached per worker (the
    parent owns the unlink)."""
    views = _W_SLABS.get(name)
    if views is None:
        shm = shared_memory.SharedMemory(name=name)
        views = (shm,) + _slab_views(shm, _W_CFG["slots"],
                                     _W_CFG["data_shape"])
        _W_SLABS[name] = views
    return views[1], views[2]


def _decode_into(fd, cfg, imgs, labels, start_slot, recs):
    """Decode ``recs = [(payload offset, length, seed), ...]`` (spans from
    the framing scan) into slots ``start_slot..`` of a slab."""
    from .io import _decode_record
    for i, (off, length, seed) in enumerate(recs):
        raw = os.pread(fd, length, off)
        slot = start_slot + i
        _, labels[slot] = _decode_record(raw, cfg,
                                         np.random.RandomState(seed),
                                         out=imgs[slot])


def _decode_chunk(slab_name, start_slot, recs):
    """The pool task: decode ``recs`` into the slab from ``start_slot``;
    returns the count."""
    imgs, labels = _attach_slab(slab_name)
    _decode_into(_worker_fd(), _W_CFG, imgs, labels, start_slot, recs)
    return len(recs)


# -- parent side --------------------------------------------------------------

def _slab_bytes(slots, data_shape):
    return slots * int(np.prod(data_shape)) * 4 + slots * 4


def _slab_views(shm, slots, data_shape):
    img_bytes = slots * int(np.prod(data_shape)) * 4
    imgs = np.ndarray((slots,) + tuple(data_shape), np.float32,
                      buffer=shm.buf)
    labels = np.ndarray((slots,), np.float32, buffer=shm.buf,
                        offset=img_bytes)
    return imgs, labels


class _Slab:
    """One batch's shared memory: ``slots`` CHW float32 images + labels."""

    def __init__(self, slots, data_shape):
        self.shm = shared_memory.SharedMemory(
            create=True, size=_slab_bytes(slots, data_shape))
        self.name = self.shm.name
        self.imgs, self.labels = _slab_views(self.shm, slots, data_shape)

    def destroy(self):
        self.imgs = self.labels = None
        # unlink first: close() raises while a view is still exported
        try:
            self.shm.unlink()
        except FileNotFoundError:
            pass
        try:
            self.shm.close()
        except BufferError:
            pass


class _Entry:
    """One in-flight batch: its slab and its chunks
    [(start_slot, recs, future or None, pool generation at submit)]."""

    __slots__ = ("slab", "n", "chunks")

    def __init__(self, slab, n, chunks):
        self.slab = slab
        self.n = n
        self.chunks = chunks


class PooledDecodePipeline:
    """Ordered multi-process decode into shared memory with prefetch.

    ``begin(schedule)`` installs an epoch's ``[(keys, seeds), ...]``;
    ``next_batch()`` returns the next ``(images, labels)`` as private
    float32 arrays; ``drain()`` parks between epochs with the pool kept;
    ``close()`` tears it all down.  All scheduler state changes under
    ``_lock``; the assembler never holds it across a wait, copy or
    decode.
    """

    def __init__(self, rec, cfg, workers, slots, prefetch=None, chunk=None,
                 timeout_s=None, retries=None):
        self._rec = rec
        self._cfg = dict(cfg)
        self._cfg["slots"] = int(slots)
        self._slots = int(slots)
        self._workers = max(1, int(workers))
        self._prefetch = max(1, int(prefetch if prefetch is not None
                             else config.get_int("MXNET_IO_PREFETCH", 2)))
        chunk = int(chunk if chunk is not None
                    else config.get_int("MXNET_IO_CHUNK", 0))
        # auto: one task wave per batch
        self._chunk = chunk if chunk > 0 else max(
            1, -(-self._slots // self._workers))
        self._timeout = float(timeout_s if timeout_s is not None
                              else config.get_float("MXNET_IO_TIMEOUT_S", 60))
        self._retries = int(retries if retries is not None
                            else config.get_int("MXNET_DATALOADER_RETRIES", 2))
        shape = tuple(self._cfg["data_shape"])
        need = (self._prefetch + 1) * _slab_bytes(self._slots, shape)
        free = shm_free_bytes()
        if need > free:
            raise MXNetError(
                f"the decode pipeline needs {need} bytes of shared memory "
                f"({self._prefetch + 1} slabs of {self._slots} images "
                f"{shape}) and {_SHM} has {free} free; lower "
                "MXNET_IO_PREFETCH or the batch, or enlarge /dev/shm")
        from .. import native
        native.codec_lib()      # built here, before any worker starts
        native.recordio_lib()
        self._slabs = [_Slab(self._slots, shape)
                       for _ in range(self._prefetch + 1)]
        self._lock = threading.RLock()
        self._cv = threading.Condition(self._lock)
        self._free = list(range(len(self._slabs)))
        self._pending = deque()     # (keys, seeds) not yet issued
        self._inflight = deque()    # _Entry, in consumption order
        self._ready = deque()       # (imgs, labels) ready to hand over
        self._ready_bound = 2
        self._error = None          # assembler exception -> consumer
        self._epoch_gen = 0         # bumps on drain()
        self._busy = False          # assembler mid-entry
        self._pool = None
        self._gen = 0               # bumps on every pool kill
        self._failures = 0
        self._permanent = False     # True: decode in this process for good
        self._parent_fd = -1
        self._closed = False
        self._assembler = threading.Thread(
            target=self._assemble_loop, name="mx-io-assembler", daemon=True)
        self._assembler.start()

    # -- pool lifecycle -----------------------------------------------------

    def _ensure_pool(self):
        if self._pool is not None or self._permanent:
            return self._pool
        from concurrent.futures import ProcessPoolExecutor
        from .io import _mp_context
        self._pool = ProcessPoolExecutor(
            self._workers, mp_context=_mp_context(),
            initializer=_worker_init, initargs=(self._cfg,))
        return self._pool

    def _hard_kill_pool(self):
        """Kill the pool so that no worker can touch a slab again."""
        with self._lock:
            pool, self._pool = self._pool, None
            if pool is None:
                return
            self._gen += 1
        procs = list(getattr(pool, "_processes", {}).values())
        pool.shutdown(wait=False, cancel_futures=True)
        for p in procs:
            try:
                p.terminate()
            except Exception:  # noqa: BLE001 (already dead)
                pass

    def _episode(self, exc):
        """One failure episode: kill the pool, spend budget, warn."""
        global episodes
        with self._lock:
            if self._pool is None:
                return
            self._hard_kill_pool()
            self._failures += 1
            episodes += 1
            permanent = self._failures > self._retries
            if permanent:
                self._permanent = True
        warnings.warn(
            f"io decode pool failure ({exc!r}); " + (
                f"{self._failures} failures: decoding in one process for "
                "good" if permanent else "decoding the affected chunks "
                "in-process and rebuilding the pool"), stacklevel=3)

    # -- scheduling ---------------------------------------------------------

    def begin(self, schedule):
        """Install an epoch's batch plan and start prefetching."""
        with self._lock:
            if self._inflight or self._pending or self._ready or self._busy:
                raise MXNetError("pipeline.begin: epoch already in progress "
                                 "(drain() first)")
            self._pending.extend(schedule)
            self._pump()
            self._cv.notify_all()

    def _pump(self):
        while self._free and self._pending:
            keys, seeds = self._pending.popleft()
            self._issue(keys, seeds)

    def _issue(self, keys, seeds):
        n = len(keys)
        if n > self._slots:
            raise MXNetError(f"batch of {n} exceeds slab slots {self._slots}")
        slab = self._free.pop()
        offs, lens = self._rec.payload_spans(keys)
        recs = [(int(offs[i]), int(lens[i]), int(seeds[i]))
                for i in range(n)]
        chunks = []
        for s in range(0, n, self._chunk):
            part = recs[s:s + self._chunk]
            fut = None
            if not self._permanent:
                try:
                    fut = self._ensure_pool().submit(
                        _decode_chunk, self._slabs[slab].name, s, part)
                except Exception as exc:  # noqa: BLE001 (broken pool)
                    self._episode(exc)
            chunks.append((s, part, fut, self._gen))
        self._inflight.append(_Entry(slab, n, chunks))

    def _inline_chunk(self, slab, start_slot, recs):
        """Decode one chunk in this process: the ladder's refetch and the
        single-process fallback; the same pread and seeds as a worker."""
        if self._parent_fd < 0:
            self._parent_fd = os.open(self._cfg["rec_path"], os.O_RDONLY)
        _decode_into(self._parent_fd, self._cfg, self._slabs[slab].imgs,
                     self._slabs[slab].labels, start_slot, recs)

    def _collect(self, entry):
        """Wait until every chunk of ``entry`` is in its slab, riding the
        ladder for any chunk whose worker failed."""
        for start_slot, recs, fut, fgen in entry.chunks:
            if fut is not None and fgen == self._gen:
                try:
                    fut.result(self._timeout)
                    continue
                except Exception as exc:  # noqa: BLE001 (ladder)
                    self._episode(exc)
            self._inline_chunk(entry.slab, start_slot, recs)

    def _assemble_loop(self):
        while True:
            with self._lock:
                while not self._closed and (
                        not self._inflight
                        or len(self._ready) >= self._ready_bound):
                    self._cv.wait()
                if self._closed:
                    return
                entry = self._inflight.popleft()
                self._busy = True
                egen = self._epoch_gen
            imgs = labels = err = None
            try:
                self._collect(entry)
                slab = self._slabs[entry.slab]
                imgs = slab.imgs[:entry.n].copy()
                labels = slab.labels[:entry.n].copy()
            except BaseException as exc:  # noqa: BLE001 (to the consumer)
                err = exc
            with self._lock:
                self._busy = False
                if err is not None:
                    self._error = err
                elif egen == self._epoch_gen:
                    self._free.append(entry.slab)
                    self._ready.append((imgs, labels))
                    self._pump()
                self._cv.notify_all()

    def next_batch(self):
        """(images, labels) of the next batch in schedule order; raises
        StopIteration when the schedule is spent."""
        with self._lock:
            while True:
                if self._error is not None:
                    exc, self._error = self._error, None
                    raise exc
                if self._ready:
                    batch = self._ready.popleft()
                    self._cv.notify_all()
                    return batch
                if self._closed or not (self._inflight or self._pending
                                        or self._busy):
                    raise StopIteration
                self._cv.wait()

    # -- lifecycle ----------------------------------------------------------

    def drain(self):
        """Drop unissued and undelivered work and wait until no worker or
        the assembler can touch a slab; the pool stays up."""
        with self._lock:
            self._epoch_gen += 1
            self._pending.clear()
            entries = list(self._inflight)
            self._inflight.clear()
            self._cv.notify_all()
            while self._busy:
                self._cv.wait()
            gen = self._gen
        for entry in entries:
            for _, _, fut, fgen in entry.chunks:
                if fut is not None and fgen == gen:
                    try:
                        fut.result(self._timeout)
                    except Exception:  # noqa: BLE001
                        self._episode(RuntimeError("drain"))
        with self._lock:
            self._ready.clear()
            self._error = None
            self._free = list(range(len(self._slabs)))

    def close(self):
        with self._lock:
            if self._closed:
                return
            self._closed = True
            self._cv.notify_all()
        if self._assembler.is_alive() \
                and self._assembler is not threading.current_thread():
            self._assembler.join(timeout=self._timeout)
        self._hard_kill_pool()
        self._pending.clear()
        self._inflight.clear()
        self._ready.clear()
        for slab in self._slabs:
            slab.destroy()
        self._slabs = []
        if self._parent_fd >= 0:
            try:
                os.close(self._parent_fd)
            except OSError:
                pass
            self._parent_fd = -1

    def __del__(self):
        try:
            self.close()
        except Exception:  # noqa: BLE001 (interpreter teardown)
            pass
