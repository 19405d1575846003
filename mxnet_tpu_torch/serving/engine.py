"""Continuous-batching serving engine (Orca iteration-level scheduling) —
the port of ``mxnet_tpu/serving/engine.py``'s default path.

One ``ServingEngine`` owns a model adapter (``serving.models``), a paged
KV cache (``serving.cache``) and an async request queue.  Every iteration
of :meth:`step`:

1. fails queued/running requests past their SLA deadline
   (``RequestDeadlineExceeded``);
2. backfills free decode slots from the queue;
3. runs ONE fixed-shape ``(B_max, 1)`` decode for every slot (inactive
   slots ride along pointed at the scratch block) and retires sequences
   that emitted EOS or their token budget.

When the block pool runs dry mid-decode the scheduler preempts the
youngest sequence (vLLM's recompute policy: its blocks are freed, the
request re-queues at the FRONT and later re-prefills prompt +
generated-so-far).

Not ported in this slice: prefix caching and speculative decoding (asking
for either raises), telemetry, and the replica/router tier.
"""

from __future__ import annotations

import collections
import itertools
import threading
import time

import numpy as np

from .. import config
from ..base import MXNetError
from .cache import CacheOOMError, PagedKVCache
from .models import make_adapter

__all__ = ["ServingEngine", "Request", "ResultHandle", "ServingError",
           "RequestDeadlineExceeded"]

# bound on ResultHandle.result waits when the caller gives none (the
# reference bounds them by MXNET_KVSTORE_TIMEOUT_S, default 300 s)
_RESULT_TIMEOUT_S = 300.0


class ServingError(MXNetError):
    """Base for serving-layer failures attached to a request."""


class RequestDeadlineExceeded(ServingError):
    """A request blew its SLA deadline (queued or mid-decode) and was
    evicted."""


_rid = itertools.count()


class Request:
    """One generation request moving through the engine."""

    __slots__ = ("rid", "prompt", "max_new_tokens", "deadline_s",
                 "submit_t", "outputs", "error", "done", "first_token_t",
                 "finish_t", "preempts")

    def __init__(self, prompt, max_new_tokens, deadline_s):
        self.rid = next(_rid)
        self.prompt = [int(t) for t in prompt]
        self.max_new_tokens = int(max_new_tokens)
        self.deadline_s = deadline_s
        self.submit_t = time.perf_counter()
        self.outputs = []
        self.error = None
        self.done = threading.Event()
        self.first_token_t = None
        self.finish_t = None
        self.preempts = 0

    def expired(self, now):
        return (self.deadline_s is not None and self.deadline_s > 0
                and now - self.submit_t > self.deadline_s)


class ResultHandle:
    """Caller-side view of a submitted request."""

    def __init__(self, req):
        self._req = req

    @property
    def rid(self):
        return self._req.rid

    def ready(self):
        return self._req.done.is_set()

    def stats(self):
        """Per-request SLO sample (seconds): ttft, e2e, tokens, preempts."""
        req = self._req
        return {
            "ttft_s": (None if req.first_token_t is None
                       else req.first_token_t - req.submit_t),
            "e2e_s": (None if req.finish_t is None
                      else req.finish_t - req.submit_t),
            "finish_t": req.finish_t,
            "tokens": len(req.outputs),
            "preempts": req.preempts,
        }

    def result(self, timeout=None):
        """Block for the generated tokens, at most ``timeout`` seconds
        (default 300): a dead engine thread surfaces as ServingError
        instead of a hang.  Request-level failures re-raise here."""
        wait_s = _RESULT_TIMEOUT_S if timeout is None else float(timeout)
        if not self._req.done.wait(wait_s):
            raise ServingError(
                f"request {self._req.rid} not finished within {wait_s:g}s")
        if self._req.error is not None:
            raise self._req.error
        return list(self._req.outputs)


class _Slot:
    __slots__ = ("req", "last_token", "admitted_t")

    def __init__(self, req, last_token, now):
        self.req = req
        self.last_token = last_token
        self.admitted_t = now


class ServingEngine:
    """Paged-KV continuous-batching server for one zoo model: free slots
    are backfilled from the queue every iteration.  The model's device is
    the engine's device."""

    def __init__(self, model, eos_id=None, max_batch=None, block_tokens=None,
                 max_seq=None, num_blocks=None, prefill_tokens=None,
                 prefix_cache=None, draft_model=None, spec_k=None):
        if prefix_cache:
            raise MXNetError("prefix caching is not ported to "
                             "mxnet_tpu_torch yet")
        if draft_model is not None or spec_k is not None:
            raise MXNetError("speculative decoding is not ported to "
                             "mxnet_tpu_torch yet")
        self.max_batch = int(max_batch if max_batch is not None else
                             config.get_int("MXNET_SERVING_MAX_BATCH", 8))
        self.block_tokens = int(
            block_tokens if block_tokens is not None else
            config.get_int("MXNET_SERVING_BLOCK_TOKENS", 16))
        max_seq = int(max_seq if max_seq is not None else
                      config.get_int("MXNET_SERVING_MAX_SEQ", 256))
        prefill_tokens = int(
            prefill_tokens if prefill_tokens is not None else
            config.get_int("MXNET_SERVING_PREFILL_TOKENS", 64))
        if prefill_tokens > max_seq:
            raise MXNetError("MXNET_SERVING_PREFILL_TOKENS must be <= "
                             "MXNET_SERVING_MAX_SEQ")
        self.max_seq = max_seq
        mbs = -(-max_seq // self.block_tokens)
        if num_blocks is None:
            num_blocks = config.get_int("MXNET_SERVING_NUM_BLOCKS", 0)
        if not num_blocks:                 # worst case every slot maxed out
            num_blocks = self.max_batch * mbs + 1
        if hasattr(model, "decode") and hasattr(model, "prefill"):
            self.adapter = model
        else:
            self.adapter = make_adapter(model, eos_id=eos_id,
                                        prefill_tokens=prefill_tokens)
        self.eos_id = self.adapter.eos_id
        self.cache = PagedKVCache(self.max_batch, mbs, self.block_tokens,
                                  num_blocks)
        self.adapter.make_pools(num_blocks, self.block_tokens)
        self.default_sla_s = config.get_float("MXNET_SERVING_SLA_S", 0.0)
        self._lock = threading.Lock()      # queue + slots + cache
        self._queue = collections.deque()
        self._slots = [None] * self.max_batch
        self._tables_dev = None            # device copy of cache.tables
        self._tables_version = -1
        self._thread = None
        self._running = False
        self._stopped = False              # stop() is terminal

    # -- submission ---------------------------------------------------------

    def submit(self, prompt, max_new_tokens=32, deadline_s=None):
        """Queue one request; returns a :class:`ResultHandle`.  Requests
        that can never fit (prompt beyond the prefill shape, total beyond
        max_seq) are rejected immediately."""
        if deadline_s is None:
            deadline_s = self.default_sla_s or None
        if deadline_s is not None:
            deadline_s = float(deadline_s)
        req = Request(prompt, max_new_tokens, deadline_s)
        if req.max_new_tokens < 1:
            raise MXNetError("max_new_tokens must be >= 1")
        if not req.prompt:
            raise MXNetError("empty prompt")
        if deadline_s is not None and deadline_s <= 0:
            self._evict(req, "queued")
            return ResultHandle(req)
        total = self.adapter.cache_positions(len(req.prompt),
                                             req.max_new_tokens)
        if len(req.prompt) > self.adapter.prefill_tokens \
                or total > self.max_seq:
            req.error = ServingError(
                f"request {req.rid} cannot fit: prompt {len(req.prompt)} "
                f"(prefill cap {self.adapter.prefill_tokens}), cache "
                f"positions {total} (max_seq {self.max_seq})")
            req.finish_t = time.perf_counter()
            req.done.set()
            return ResultHandle(req)
        with self._lock:
            if self._stopped:
                req.error = ServingError(
                    f"request {req.rid} rejected: engine stopped")
                req.finish_t = time.perf_counter()
                req.done.set()
                return ResultHandle(req)
            self._queue.append(req)
        return ResultHandle(req)

    # -- scheduling core (callers hold self._lock) --------------------------

    def _finish(self, slot_idx, error=None):
        slot = self._slots[slot_idx]
        self._slots[slot_idx] = None
        self.cache.release(slot_idx)
        req = slot.req
        req.error = error
        req.finish_t = time.perf_counter()
        req.done.set()

    def _evict(self, req, where):
        req.error = RequestDeadlineExceeded(
            f"request {req.rid} exceeded its {req.deadline_s:g}s SLA "
            f"deadline while {where} (MXNET_SERVING_SLA_S)")
        req.finish_t = time.perf_counter()
        req.done.set()

    def _preempt(self, slot_idx):
        """Free a running sequence's blocks and requeue it (front) for
        recompute — prompt + generated-so-far re-prefills later."""
        slot = self._slots[slot_idx]
        self._slots[slot_idx] = None
        self.cache.release(slot_idx)
        slot.req.preempts += 1
        self._queue.appendleft(slot.req)

    def _recompute_prompt(self, req):
        return req.prompt + req.outputs

    def _emit(self, req, token, now):
        req.outputs.append(int(token))
        if req.first_token_t is None:
            req.first_token_t = now

    def _req_finished(self, req):
        return (req.outputs and req.outputs[-1] == self.eos_id) \
            or len(req.outputs) >= req.max_new_tokens

    def _admit_one(self, req, slot_idx):
        """Prefill one request into a free slot.  Raises CacheOOMError
        with nothing mutated if the pool can't cover the reservation."""
        now = time.perf_counter()
        prompt = self._recompute_prompt(req)
        # positions reserved: the prompt only (preemption recomputes)
        self.cache.admit(slot_idx, len(prompt))
        try:
            first = self.adapter.prefill(slot_idx, prompt,
                                         self.cache.tables[slot_idx])
        except Exception:
            # the blocks claimed above must not leak with the slot empty
            self.cache.release(slot_idx)
            raise
        # prompt tokens (incl. recomputed generations) now sit in the
        # pages; the new token decodes next iteration
        self.cache.ctx_len[slot_idx] = len(prompt)
        self._emit(req, first, time.perf_counter())
        self._slots[slot_idx] = _Slot(req, first, now)
        if self._req_finished(req):
            self._finish(slot_idx)

    def _admit(self, now):
        # SLA sweep of the whole queue first
        expired = [r for r in self._queue if r.expired(now)]
        for req in expired:
            self._queue.remove(req)
            self._evict(req, "queued")
        free = [i for i, s in enumerate(self._slots) if s is None]
        while self._queue and free:
            req = self._queue.popleft()
            if req.expired(time.perf_counter()):
                self._evict(req, "queued")
                continue
            try:
                self._admit_one(req, free[0])
            except CacheOOMError as oom:
                if any(s is not None for s in self._slots):
                    self._queue.appendleft(req)  # blocks will free; wait
                    break
                # nothing running will ever free blocks: permanent misfit
                req.error = oom
                req.finish_t = time.perf_counter()
                req.done.set()
                continue
            except Exception as exc:  # noqa: BLE001 — adapter failure
                # prefill failed: fail THIS request and keep serving the
                # rest; blocks were released by _admit_one
                req.error = exc
                req.finish_t = time.perf_counter()
                req.done.set()
                continue
            free.pop(0)

    def _ensure_blocks(self):
        """Every active slot's next write position gets a block; pool
        pressure preempts the youngest slot whose recompute prompt still
        fits the prefill shape."""
        for i in range(self.max_batch):
            while self._slots[i] is not None:
                try:
                    self.cache.ensure_capacity(i)
                    break
                except CacheOOMError as oom:
                    victims = sorted(
                        (j for j, s in enumerate(self._slots)
                         if s is not None
                         and len(self._recompute_prompt(s.req))
                         <= self.adapter.prefill_tokens),
                        key=lambda j: self._slots[j].admitted_t)
                    if not victims:
                        self._finish(i, error=oom)
                        break
                    self._preempt(victims[-1])
                    # if i preempted itself the outer while exits

    def _upload_tables(self):
        if self._tables_version != self.cache.version:
            # tables only change at admission/allocation/release
            self._tables_dev = self.adapter.to_device(self.cache.tables)
            self._tables_version = self.cache.version

    def step(self):
        """One scheduler iteration (expire -> backfill -> decode ->
        retire).  Returns True when any work was done."""
        with self._lock:
            now = time.perf_counter()
            for i, slot in enumerate(self._slots):
                if slot is not None and slot.req.expired(now):
                    req = slot.req
                    self._slots[i] = None
                    self.cache.release(i)
                    self._evict(req, "decoding")
            self._admit(now)
            self._ensure_blocks()
            active = [i for i, s in enumerate(self._slots) if s is not None]
            if active:
                tokens = np.zeros((self.max_batch,), np.int32)
                for i in active:
                    tokens[i] = self._slots[i].last_token
                self._upload_tables()
                # the dispatch runs under self._lock: released, a finished
                # slot could be backfilled mid-dispatch and this step's
                # tokens credited to the wrong request
                nxt = self.adapter.decode(tokens, self._tables_dev,
                                          self.cache.ctx_len)
                now = time.perf_counter()
                for i in active:
                    slot = self._slots[i]
                    self.cache.advance(i)
                    tok = int(nxt[i])
                    slot.last_token = tok
                    self._emit(slot.req, tok, now)
                    if self._req_finished(slot.req):
                        self._finish(i)
            return bool(active) or bool(self._queue)

    # -- driving ------------------------------------------------------------

    def drain(self, max_steps=100000):
        """Run the scheduler until queue and slots are empty (the
        synchronous mode tests and benchmarks use)."""
        for _ in range(max_steps):
            if not self.step():
                with self._lock:
                    idle = not self._queue \
                        and all(s is None for s in self._slots)
                if idle:
                    return
        raise MXNetError("serving drain did not converge "
                         f"within {max_steps} steps")

    def generate(self, prompts, max_new_tokens=32, deadline_s=None):
        """Submit a batch and run synchronously to completion; returns
        each prompt's generated tokens (EOS included when emitted)."""
        handles = [self.submit(p, max_new_tokens, deadline_s)
                   for p in prompts]
        self.drain()
        return [h.result(timeout=1.0) for h in handles]

    def start(self):
        """Serve from a background daemon thread (``submit`` from any
        thread, ``ResultHandle.result`` to wait)."""
        with self._lock:
            if self._stopped:
                raise MXNetError("engine stopped: stop() is terminal")
            if self._running:
                return
            self._running = True
            self._thread = threading.Thread(
                target=self._serve_loop, daemon=True, name="mx-serving")
            self._thread.start()

    def _serve_loop(self):
        while True:
            with self._lock:
                if not self._running:
                    return
            if not self.step():
                time.sleep(0.001)

    def stop(self):
        """TERMINAL shutdown: stop the background loop and fail every
        pending request promptly.  Later submit()s return failed handles."""
        with self._lock:
            self._running = False
            t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=10)
        with self._lock:
            self._stopped = True
            pending = list(self._queue)
            self._queue.clear()
            for i, slot in enumerate(self._slots):
                if slot is not None:
                    self._slots[i] = None
                    self.cache.release(i)
                    pending.append(slot.req)
            for req in pending:
                req.error = ServingError(
                    f"request {req.rid} abandoned: engine stopped "
                    "before it completed")
                req.finish_t = time.perf_counter()
                req.done.set()
