"""gluon.data.DataLoader — the port of
``mxnet_tpu/gluon/data/dataloader.py``.

``num_workers=0`` loads each batch in this process: the samples go through
``batchify_fn`` (``default_batchify_fn`` stacks them).  With workers, a
forked ``multiprocessing`` pool, as in the reference, builds batches ahead
of the consumer (at most ``prefetch``, default twice the workers): each
worker fetches its samples, transforms included, on the host and returns
numpy arrays; this process turns each field of a batch into one tensor and
copies it to the current context, one host-to-device copy per field.

A worker must never reach CUDA (a forked child that does dies: "Cannot
re-initialize CUDA in forked subprocess"), yet the default context is the
card and the transforms are Blocks over NDArrays.  So each worker starts
with ``cpu(0)`` as its default context, no autograd recording and one
torch thread, and hands back numpy only.

A loader left mid-epoch lets the batches already issued arrive (within
``timeout``) before it terminates its pool: ``Pool.terminate()`` stops
reading results while a worker may be blocked writing a large batch,
holding the result queue's lock that ``terminate`` then waits for.

A worker batch that fails or does not arrive within ``timeout`` seconds is
fetched again in this process; after ``MXNET_DATALOADER_RETRIES`` such
failures the pool is shut down and the loader loads in this process from
then on.  Each refetch and each such switch adds one to the module counter
``fallbacks``: on a healthy pool it stays 0.

Batches from workers are bit-identical to those without for the same
sampler order and transforms that draw no random numbers.  Random
transforms draw from Python's ``random`` in each worker, whose state every
forked worker inherits, as in the reference.

``pin_memory`` and ``pin_device_id`` are accepted and ignored, as in the
reference: every batch takes the same pageable host-to-device copy.

A decode-aware dataset (one with ``_decode_plan``, such as
``vision.DecodedImageRecordDataset``) with workers, the default
``batchify_fn`` and ``MXNET_IO_POOL`` not 0 skips the forked pool and
runs the shared-memory decode pipeline (``io.pipeline``) instead: its
forkserver workers decode straight into shared slabs ahead of the
consumer, with batches bit-identical to ``num_workers=0``.  A nested
iteration of the same loader decodes in this process.  A pipeline error
past the pipeline's own ladder finishes the epoch in this process from
the same seeds (adding one to ``fallbacks``); after
``MXNET_DATALOADER_RETRIES`` such errors the loader loads in this process
for good.

With telemetry on, each batch handed over is a ``dataloader.batch`` span
whose seconds count in ``mxnet_dataloader_batch_seconds`` and
``mxnet_dataloader_batches_total`` and go to the step clock as
``data_wait`` (folded into the step the batch feeds); the pool path sets
``mxnet_dataloader_queue_depth``.  ``dataloader.fetch`` is a chaos site
(``resilience.chaos``) on every path; the in-process refetch that handles
a failure does not hit it again.
"""

from __future__ import annotations

import multiprocessing as mp
import time
import warnings

import numpy as np
import torch

from ... import autograd, config
from ... import telemetry as _tel
from ...context import Context, cpu, resolve_device
from ...ndarray.ndarray import NDArray
from ...resilience import chaos as _chaos
from ...telemetry import stepclock as _sclock
from .sampler import BatchSampler, RandomSampler, SequentialSampler

__all__ = ["DataLoader", "default_batchify_fn", "default_mp_batchify_fn"]

_M_BATCH_SECONDS = _tel.histogram(
    "mxnet_dataloader_batch_seconds",
    "Host latency to materialize one batch (fetch + batchify).")
_M_BATCHES = _tel.counter(
    "mxnet_dataloader_batches_total", "Batches yielded by DataLoader.")
_M_QUEUE_DEPTH = _tel.gauge(
    "mxnet_dataloader_queue_depth",
    "Outstanding prefetched batches in the worker pool.")


def _observe(sp):
    """A finished ``dataloader.batch`` span: the batch counters and the
    step clock's data_wait."""
    if sp is not _tel.NULL_SPAN:
        _M_BATCHES.inc()
        _M_BATCH_SECONDS.observe(sp.duration_s)
        _sclock.STEP_CLOCK.note("data_wait", sp.duration_s)

fallbacks = 0
"""Worker batches refetched in this process, plus pools given up: 0 while
every worker batch arrives."""


def _to_context(t):
    """An NDArray of ``t`` on the current context."""
    dev = resolve_device(None)
    if t.device == dev:
        return NDArray(t)
    return NDArray(t.to(dev))


def default_batchify_fn(data):
    """Stack samples into a batch on the current context: NDArrays by
    ``torch.stack``, tuples field by field, anything else through numpy."""
    if isinstance(data[0], NDArray):
        return _to_context(torch.stack([d._data for d in data]))
    if isinstance(data[0], (tuple, list)):
        return tuple(default_batchify_fn(list(x)) for x in zip(*data))
    return _to_context(torch.from_numpy(np.array(data)))


default_mp_batchify_fn = default_batchify_fn


def _as_numpy_sample(sample):
    if isinstance(sample, NDArray):
        return sample.asnumpy()
    if isinstance(sample, (tuple, list)):
        return tuple(_as_numpy_sample(s) for s in sample)
    return sample


_worker_dataset = None


def _worker_init(dataset):
    global _worker_dataset
    _worker_dataset = dataset
    _tel.flightrec.default_sigterm()   # terminate() must end the worker
    Context._default.value = cpu(0)
    autograd.set_recording(False)
    autograd.set_training(False)
    torch.set_num_threads(1)


def _worker_fn(samples):
    batch = [_as_numpy_sample(_worker_dataset[i]) for i in samples]
    if isinstance(batch[0], tuple):
        return tuple(np.asarray(x) for x in zip(*batch))
    return np.asarray(batch)


class DataLoader:
    def __init__(self, dataset, batch_size=None, shuffle=False, sampler=None,
                 last_batch=None, batch_sampler=None, batchify_fn=None,
                 num_workers=0, pin_memory=False,  # noqa: ARG002
                 pin_device_id=0,  # noqa: ARG002
                 prefetch=None, thread_pool=False,  # noqa: ARG002
                 timeout=120):
        self._dataset = dataset
        self._timeout = timeout
        if batch_sampler is None:
            if batch_size is None:
                raise ValueError("batch_size required when batch_sampler "
                                 "is not given")
            if sampler is None:
                sampler = RandomSampler(len(dataset)) if shuffle \
                    else SequentialSampler(len(dataset))
            elif shuffle:
                raise ValueError("shuffle must be False with custom sampler")
            batch_sampler = BatchSampler(sampler, batch_size,
                                         last_batch or "keep")
        self._batch_sampler = batch_sampler
        self._num_workers = max(0, num_workers)
        self._batchify_fn = batchify_fn or default_batchify_fn
        self._prefetch = max(0, prefetch or 2 * self._num_workers)
        self._max_pool_failures = config.get_int("MXNET_DATALOADER_RETRIES", 2)
        self._pool = None
        self._io_pipeline = None
        self._io_pipeline_slots = 0
        self._io_pipeline_busy = False
        self._decode_pool_failures = 0
        self._use_decode_pool = (
            self._num_workers > 0 and batchify_fn is None
            and hasattr(dataset, "_decode_plan")
            and config.get_int("MXNET_IO_POOL", 1) != 0)
        if self._num_workers > 0 and not self._use_decode_pool:
            self._pool = mp.get_context("fork").Pool(
                self._num_workers, initializer=_worker_init,
                initargs=(dataset,))

    def _materialize(self, batch_idx, hit_chaos=True):
        """Fetch and batchify one batch in this process (the path without
        workers, and the refetch of a failed one, which passes
        ``hit_chaos=False``: it is the fault's handler)."""
        with _tel.span("dataloader.batch", "data",
                       samples=len(batch_idx)) as sp:
            if hit_chaos and _chaos._ACTIVE:
                _chaos.hit("dataloader.fetch")
            batch = self._batchify_fn([self._dataset[i] for i in batch_idx])
        _observe(sp)
        return batch

    def _load(self, batch):
        """A worker's numpy batch as NDArrays on the current context."""
        if isinstance(batch, tuple):
            return tuple(self._load(b) for b in batch)
        return _to_context(torch.from_numpy(batch))

    def __iter__(self):
        if self._use_decode_pool:
            yield from self._iter_decode_pool()
            return
        if self._pool is None:
            for batch_idx in self._batch_sampler:
                yield self._materialize(batch_idx)
            return
        yield from self._iter_pool()

    def _iter_pool(self):
        """The pool with bounded prefetch; each ``get`` waits at most
        ``timeout`` seconds, a failed batch is refetched here, and after
        MXNET_DATALOADER_RETRIES failures the pool is given up."""
        global fallbacks
        # (batch indices, AsyncResult); kept on the loader so that a
        # shutdown mid-epoch can let the batches in flight finish
        results = self._in_flight = []
        it = iter(self._batch_sampler)
        failures = 0

        def issue():
            try:
                idx = next(it)
            except StopIteration:
                return False
            results.append((idx, self._pool.apply_async(_worker_fn, (idx,))))
            return True

        for _ in range(self._prefetch):
            if not issue():
                break
        while results:
            idx, r = results.pop(0)
            issue()
            if _tel.enabled():
                _M_QUEUE_DEPTH.set(len(results))
            with _tel.span("dataloader.batch", "data",
                           queue_depth=len(results)) as sp:
                try:
                    if _chaos._ACTIVE:
                        _chaos.hit("dataloader.fetch")
                    out = self._load(r.get(self._timeout))
                except Exception as exc:  # noqa: BLE001 (refetch, don't hang)
                    failures += 1
                    fallbacks += 1
                    warnings.warn(f"DataLoader worker batch failed "
                                  f"({exc!r}); refetched in-process",
                                  stacklevel=2)
                    out = self._batchify_fn(
                        [self._dataset[i] for i in idx])
            _observe(sp)
            yield out
            if failures and failures >= self._max_pool_failures \
                    and self._pool is not None:
                fallbacks += 1
                warnings.warn(f"DataLoader worker pool failed {failures} "
                              "times; loading in one process from now on",
                              stacklevel=2)
                pending = [i for i, _ in results]
                results.clear()
                self._shutdown_pool()
                for batch_idx in pending:
                    yield self._materialize(batch_idx, hit_chaos=False)
                for batch_idx in it:
                    yield self._materialize(batch_idx, hit_chaos=False)
                return

    def _iter_decode_pool(self):
        """The shared-memory decode pipeline's path: the epoch's batch
        plan goes to one ``PooledDecodePipeline`` (kept across epochs)."""
        global fallbacks
        from ...io.pipeline import PooledDecodePipeline
        if self._io_pipeline_busy:
            # the pipeline is one ordered stream: a nested iteration
            # decodes here (same seeds, same bytes)
            for b in self._batch_sampler:
                yield self._materialize(list(b))
            return
        self._io_pipeline_busy = True
        try:
            rec, cfg, keys, seed_fn = self._dataset._decode_plan()
            batches = [list(b) for b in self._batch_sampler]
            if not batches:
                return
            slots = max(len(b) for b in batches)
            if self._io_pipeline is None or self._io_pipeline_slots < slots:
                if self._io_pipeline is not None:
                    self._io_pipeline.close()
                self._io_pipeline = PooledDecodePipeline(
                    rec, cfg, workers=self._num_workers, slots=slots)
                self._io_pipeline_slots = slots
            pipe = self._io_pipeline
            pipe.drain()
            pipe.begin([([keys[i] for i in b], [seed_fn(i) for i in b])
                        for b in batches])
            for bi in range(len(batches)):
                try:
                    with _tel.span("dataloader.batch", "data") as sp:
                        if _chaos._ACTIVE:
                            _chaos.hit("dataloader.fetch")
                        imgs, labels = pipe.next_batch()
                        out = (_to_context(torch.from_numpy(imgs)),
                               _to_context(torch.from_numpy(labels)))
                except Exception as exc:  # noqa: BLE001 (ladder)
                    self._decode_pool_failures += 1
                    fallbacks += 1
                    pipe.drain()
                    permanent = \
                        self._decode_pool_failures > self._max_pool_failures
                    if permanent:
                        self._use_decode_pool = False
                        self._shutdown_pool()
                    warnings.warn(
                        f"DataLoader decode pipeline failed ({exc!r}); "
                        + ("loading in one process from now on" if permanent
                           else "finishing this epoch in-process"),
                        stacklevel=2)
                    for bj in range(bi, len(batches)):
                        yield self._materialize(batches[bj], hit_chaos=False)
                    return
                _observe(sp)
                yield out
        finally:
            self._io_pipeline_busy = False

    def _shutdown_pool(self):
        pool, self._pool = getattr(self, "_pool", None), None
        if pool is not None:
            # batches still in flight finish first (within ``timeout``):
            # Pool.terminate() stops reading results, then waits for the
            # result pipe's lock, which a worker writing a large batch
            # holds while it blocks on the unread pipe
            deadline = time.monotonic() + self._timeout
            for _, r in getattr(self, "_in_flight", ()):
                r.wait(max(0.0, deadline - time.monotonic()))
            self._in_flight = []
            pool.terminate()
        pipe, self._io_pipeline = getattr(self, "_io_pipeline", None), None
        if pipe is not None:
            pipe.close()

    def __len__(self):
        return len(self._batch_sampler)

    def __del__(self):
        self._shutdown_pool()
