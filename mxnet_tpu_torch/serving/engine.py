"""Continuous-batching serving engine (Orca iteration-level scheduling) —
the port of ``mxnet_tpu/serving/engine.py``.

One ``ServingEngine`` owns a model adapter (``serving.models``), a paged
KV cache (``serving.cache``) and an async request queue.  Every iteration
of :meth:`step`:

1. fails queued/running requests past their SLA deadline
   (``RequestDeadlineExceeded``);
2. backfills free decode slots from the queue (``policy="continuous"``;
   ``policy="static"`` admits a fresh batch only once every slot drained);
3. runs ONE fixed-shape ``(B_max, 1)`` decode for every slot (inactive
   slots ride along pointed at the scratch block) and retires sequences
   that emitted EOS or their token budget — or, with a draft model,
   ``spec_k`` draft steps and ONE ``(B_max, spec_k + 1)`` verify whose
   accept-longest-prefix rule keeps the output equal to greedy decoding
   (where the verify accepts every draft, the draft then writes the K/V of
   its last proposal, which the reference leaves stale: ROADMAP C.7).

With ``prefix_cache=True`` an admission maps the cached full blocks of its
prompt and prefills only the tail (copy-on-write before a shared block is
written).

When the block pool runs dry mid-decode the scheduler preempts the
youngest recompute-capable sequence (vLLM's recompute policy: its blocks
are freed, the request re-queues at the FRONT and later re-prefills
prompt + generated-so-far); adapters that cannot recompute (the
encoder-decoder) get worst-case block reservations at admission instead.

Blocking waits on results ride ``resilience.Deadline``: a wedged or dead
engine thread surfaces as ``KVStoreTimeoutError`` instead of a hang.  The
SLO counters, gauges and histograms and the request span tree go to the
port's ``telemetry``.
"""

from __future__ import annotations

import collections
import itertools
import threading
import time

from .. import config
from .. import telemetry as _tel
from ..analysis.runtime import tracked as _tracked
from ..telemetry import tracer as _ttrace
from ..base import MXNetError
from ..resilience import Deadline, ResilienceError
from .cache import CacheOOMError, PagedKVCache
from .models import make_adapter

import numpy as np

__all__ = ["ServingEngine", "Request", "ResultHandle", "ServingError",
           "RequestDeadlineExceeded"]


class ServingError(MXNetError):
    """Base for serving-layer failures attached to a request."""


class RequestDeadlineExceeded(ResilienceError):
    """A request blew its SLA deadline (queued or mid-decode) and was
    evicted — the serving twin of the resilience Deadline policy."""


# -- telemetry SLOs ---------------------------------------------------------

_M_ADMITTED = _tel.counter(
    "mxnet_serving_requests_admitted_total",
    "Requests admitted into a decode slot (re-admissions after "
    "preemption included).")
_M_COMPLETED = _tel.counter(
    "mxnet_serving_requests_completed_total",
    "Requests that finished with EOS or their max_new_tokens budget.")
_M_EVICTED = _tel.counter(
    "mxnet_serving_requests_evicted_total",
    "Requests failed by SLA deadline (queued or running).")
_M_PREEMPTED = _tel.counter(
    "mxnet_serving_requests_preempted_total",
    "Running sequences preempted (blocks freed, requeued for recompute) "
    "to relieve block-pool pressure.")
_M_REJECTED = _tel.counter(
    "mxnet_serving_requests_rejected_total",
    "Requests rejected as unservable: submit-time misfits (too long for "
    "the cache/prefill shape) and admission-time reservations exceeding "
    "the whole pool.")
_M_TOKENS = _tel.counter(
    "mxnet_serving_tokens_total", "Generated tokens emitted to callers.")
_M_STEPS = _tel.counter(
    "mxnet_serving_decode_steps_total",
    "Fixed-shape (B_max, 1) decode dispatches.")
_M_PREFILLS = _tel.counter(
    "mxnet_serving_prefills_total", "Prefill dispatches (one per admission).")
_M_POSITIONS = _tel.counter(
    "mxnet_serving_token_positions_total",
    "Token positions computed by the model (padding included): B_max per "
    "decode step + prefill_tokens per prefill.  FLOPs accounting: "
    "multiply by the adapter's flops_per_position.")
_G_QUEUE = _tel.gauge(
    "mxnet_serving_queue_depth", "Requests waiting for a decode slot.")
_G_ACTIVE = _tel.gauge(
    "mxnet_serving_active_slots", "Decode slots currently serving.")
_G_FREE_BLOCKS = _tel.gauge(
    "mxnet_serving_free_blocks", "KV pool blocks on the free list.")
_M_PREFILL_POS = _tel.counter(
    "mxnet_serving_prefill_positions_total",
    "Token positions computed by PREFILL dispatches only (the full "
    "padded shape cold, just the tail chunks on a prefix-cache hit) — "
    "the numerator of the shared-prompt prefill-flops gate.")
_M_PREFIX_HITS = _tel.counter(
    "mxnet_serving_prefix_hits_total",
    "Admissions that mapped >= 1 cached prefix block instead of "
    "re-prefilling it (MXNET_SERVING_PREFIX_CACHE).")
_M_PREFIX_TOKENS = _tel.counter(
    "mxnet_serving_prefix_hit_tokens_total",
    "Prompt token positions served from shared prefix blocks.")
_M_PREFIX_EVICT = _tel.counter(
    "mxnet_serving_prefix_evictions_total",
    "Refcount-0 cached prefix blocks evicted (LRU) to satisfy "
    "allocations under pool pressure.")
_M_PREFIX_COW = _tel.counter(
    "mxnet_serving_prefix_cow_total",
    "Copy-on-write block duplications (a slot about to write a block "
    "other sequences still map).")
_G_CACHED_BLOCKS = _tel.gauge(
    "mxnet_serving_prefix_cached_blocks",
    "Refcount-0 blocks currently retained for prefix reuse "
    "(evictable).")
_M_DRAFT_STEPS = _tel.counter(
    "mxnet_serving_draft_steps_total",
    "Draft-model single-token dispatches (speculative decoding).")
_M_DRAFT_POS = _tel.counter(
    "mxnet_serving_draft_positions_total",
    "Token positions computed by the DRAFT model (its prefills and "
    "speculation steps) — FLOPs accounting: multiply by the draft "
    "adapter's flops_per_position.")
_H_ACCEPTED = _tel.histogram(
    "mxnet_serving_accepted_draft_tokens",
    "Draft tokens accepted per verify dispatch (emitted tokens minus "
    "the target-sampled one) — the speculative-decoding acceptance "
    "profile.", buckets=(0, 1, 2, 3, 4, 6, 8, 12, 16))
_H_TTFT = _tel.histogram(
    "mxnet_serving_ttft_seconds", "Submit -> first generated token.")
_H_TPOT = _tel.histogram(
    "mxnet_serving_tpot_seconds", "Inter-token interval per sequence.")
_H_E2E = _tel.histogram(
    "mxnet_serving_e2e_seconds", "Submit -> request completed.")
_H_QWAIT = _tel.histogram(
    "mxnet_serving_queue_wait_seconds", "Submit -> (re-)admission.")

_rid = itertools.count()


class Request:
    """One generation request moving through the engine."""

    __slots__ = ("rid", "prompt", "max_new_tokens", "deadline_s",
                 "submit_t", "queued_t", "outputs", "error", "done",
                 "first_token_t", "last_emit_t", "finish_t", "preempts")

    def __init__(self, prompt, max_new_tokens, deadline_s):
        self.rid = next(_rid)
        self.prompt = [int(t) for t in prompt]
        self.max_new_tokens = int(max_new_tokens)
        self.deadline_s = deadline_s
        self.submit_t = time.perf_counter()
        self.queued_t = self.submit_t
        self.outputs = []
        self.error = None
        self.done = threading.Event()
        self.first_token_t = None
        self.last_emit_t = None
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
        """Per-request SLO sample (seconds): ttft, e2e, tokens, preempts —
        what a benchmark aggregates into p50/p99.  ``finish_t`` is the
        absolute completion timestamp (time.perf_counter clock) for
        sustained-throughput accounting."""
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

    def wait(self, timeout_s=None):
        """Plain bounded wait for the terminal state — True when the
        request finished (either way).  Unlike :meth:`result` this
        spawns no Deadline worker thread, which is what lets a replica
        worker park one waiter per in-flight request without doubling
        its thread count (the GIL churn is measurable at serving
        rates)."""
        return self._req.done.wait(timeout_s)

    def result(self, timeout=None):
        """Block for the generated tokens.  The wait itself is bounded by
        ``resilience.Deadline`` (default ``MXNET_KVSTORE_TIMEOUT_S``): if
        the engine thread died, the caller gets KVStoreTimeoutError
        instead of hanging forever.  Request-level failures (SLA
        eviction, rejection) re-raise here."""
        if not self._req.done.is_set():
            Deadline(timeout_s=timeout, site="serving.result").call(
                self._req.done.wait)
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
    """Paged-KV continuous-batching server for one zoo model.

    ``policy='continuous'`` backfills slots every iteration (the serving
    default); ``policy='static'`` admits a fresh batch only once every
    slot has drained (the baseline a benchmark compares against).  The
    model's device is the engine's device.
    """

    def __init__(self, model, eos_id=None, bos_id=None, max_batch=None,
                 block_tokens=None, max_seq=None, num_blocks=None,
                 prefill_tokens=None, policy="continuous",
                 prefix_cache=None, draft_model=None, spec_k=None):
        if policy not in ("continuous", "static"):
            raise MXNetError(f"policy {policy!r}: want continuous|static")
        self.policy = policy
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
            self.adapter = make_adapter(model, eos_id=eos_id, bos_id=bos_id,
                                        prefill_tokens=prefill_tokens,
                                        max_batch=self.max_batch)
        self.eos_id = self.adapter.eos_id
        limit = getattr(self.adapter, "max_positions", None)
        if limit is not None and max_seq > limit:
            raise MXNetError(
                f"max_seq {max_seq} exceeds the model's positional table "
                f"({limit} rows): decode positions past it would index "
                f"out of it — lower MXNET_SERVING_MAX_SEQ or "
                f"build the model with max_length >= {max_seq}")
        if prefix_cache is None:
            prefix_cache = bool(config.get_int(
                "MXNET_SERVING_PREFIX_CACHE", 0))
        self._prefix_on = bool(prefix_cache)
        if self._prefix_on and not self.adapter.supports_prefix_cache:
            raise MXNetError(
                "prefix caching needs an adapter whose prompt K/V lives "
                "in the pages (decoder-only llama); the encoder-decoder "
                "adapter caches the source OUTSIDE the paged pool — "
                "unset MXNET_SERVING_PREFIX_CACHE for this model")
        self.cache = PagedKVCache(self.max_batch, mbs, self.block_tokens,
                                  num_blocks, prefix_cache=self._prefix_on)
        self.adapter.make_pools(num_blocks, self.block_tokens)
        # speculative decoding: a small same-family draft model proposes
        # spec_k greedy tokens per iteration; ONE multi-token target
        # dispatch verifies them (accept-longest-prefix + target-token
        # fallback = bit-identical to plain greedy decode)
        self._spec = None
        self._spec_k = int(spec_k if spec_k is not None else
                           config.get_int("MXNET_SERVING_SPEC_K", 3))
        if draft_model is not None:
            if self._spec_k < 1:
                raise MXNetError("MXNET_SERVING_SPEC_K must be >= 1")
            if not hasattr(self.adapter, "decode_multi"):
                raise MXNetError(
                    "speculative decoding needs a multi-token verify "
                    "path (decoder-only llama adapter)")
            if hasattr(draft_model, "decode") \
                    and hasattr(draft_model, "prefill"):
                draft = draft_model
            else:
                draft = make_adapter(draft_model, eos_id=eos_id,
                                     bos_id=bos_id,
                                     prefill_tokens=prefill_tokens,
                                     max_batch=self.max_batch)
            if not getattr(draft, "supports_prefix_cache", False):
                raise MXNetError("draft model must be a decoder-only "
                                 "(llama-family) zoo model")
            dw = getattr(draft, "weights", None)
            tw = getattr(self.adapter, "weights", None)
            if dw is not None and tw is not None \
                    and dw.embed.shape[0] != tw.embed.shape[0]:
                raise MXNetError(
                    f"draft vocab {dw.embed.shape[0]} != target vocab "
                    f"{tw.embed.shape[0]}: draft proposals could never "
                    "be verified token-for-token")
            draft.make_pools(num_blocks, self.block_tokens)
            self._spec = draft
        self._adapters = [self.adapter] + \
            ([self._spec] if self._spec is not None else [])
        # prefix-counter sync marks (cache mutates its own tallies; the
        # scheduler folds the deltas into telemetry once per iteration)
        self._seen_evictions = 0
        self._seen_cow = 0
        self._seen_hits = 0
        self._seen_hit_tokens = 0
        self.default_sla_s = config.get_float("MXNET_SERVING_SLA_S", 0.0)
        self._lock = _tracked(threading.Lock(),  # queue + slots + cache
                              "ServingEngine._lock")
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
            # a non-positive remaining budget (a router forwarding an
            # already-blown deadline) fails at submit — queueing it would
            # only burn a scheduler sweep before the same eviction.  The
            # async 'b' still opens the span tree so _evict's 'e' has a
            # matching begin
            _ttrace.async_event(
                "request", "serving.request", "b", req.rid,
                prompt_tokens=len(req.prompt),
                max_new_tokens=req.max_new_tokens)
            self._evict(req, "queued")
            return ResultHandle(req)
        total = self.adapter.cache_positions(len(req.prompt),
                                             req.max_new_tokens)
        if len(req.prompt) > self.adapter.prefill_tokens \
                or total > self.max_seq:
            _M_REJECTED.inc()
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
            # request span tree: one async 'b'..'e' pair keyed
            # by rid threads queue -> prefill -> decode steps -> finish
            # through the trace; _admit_one/_emit/_finish add the interior
            # markers and the prefill/decode spans carry rid args.  The
            # 'b' is emitted BEFORE the queue append (still under the
            # lock): once appended, a background scheduler thread could
            # admit and emit interior events ahead of the begin
            _ttrace.async_event(
                "request", "serving.request", "b", req.rid,
                prompt_tokens=len(req.prompt),
                max_new_tokens=req.max_new_tokens)
            self._queue.append(req)
            _G_QUEUE.set(len(self._queue))
        return ResultHandle(req)

    def load(self):
        """One ATOMIC (queue_depth, active_slots, free_blocks) snapshot
        under the scheduler lock — what a replica RPC ack ships to the
        router for least-loaded dispatch.  The three gauges are also set
        together at the end of :meth:`step`, but between iterations only
        this read is guaranteed consistent (a gauge-by-gauge read can
        straddle an admission)."""
        with self._lock:
            return (len(self._queue),
                    sum(s is not None for s in self._slots),
                    self.cache.free_blocks)

    @property
    def free_slots(self):
        """Decode slots not currently serving (derived from load())."""
        q, active, _free = self.load()
        return self.max_batch - active

    # -- scheduling core ----------------------------------------------------

    def _finish(self, slot_idx, error=None):
        slot = self._slots[slot_idx]
        self._slots[slot_idx] = None  # graftcheck: ignore[GC04] — helper only called from step()/_admit with self._lock held
        self.cache.release(slot_idx)
        req = slot.req
        req.error = error
        now = time.perf_counter()
        req.finish_t = now
        if error is None:
            _M_COMPLETED.inc()
            _H_E2E.observe(now - req.submit_t)
        req.done.set()
        _ttrace.async_event(
            "request", "serving.request", "e", req.rid,
            tokens=len(req.outputs),
            error=type(error).__name__ if error else None)

    def _evict(self, req, where):
        req.error = RequestDeadlineExceeded(
            f"request {req.rid} exceeded its {req.deadline_s:g}s SLA "
            f"deadline while {where} (MXNET_SERVING_SLA_S)")
        req.finish_t = time.perf_counter()
        _M_EVICTED.inc()
        req.done.set()
        _ttrace.async_event("request", "serving.request", "e", req.rid,
                            tokens=len(req.outputs), error="sla_" + where)

    def _preempt(self, slot_idx):
        """Free a running sequence's blocks and requeue it (front) for
        recompute — prompt + generated-so-far re-prefills later."""
        slot = self._slots[slot_idx]
        self._slots[slot_idx] = None  # graftcheck: ignore[GC04] — helper only called from step() with self._lock held
        self.cache.release(slot_idx)
        slot.req.preempts += 1
        slot.req.queued_t = time.perf_counter()
        # the preemption round-trip (queue wait + re-prefill) is NOT an
        # inter-token interval: without this the first post-readmission
        # emit would observe it into the TPOT histogram
        slot.req.last_emit_t = None
        self._queue.appendleft(slot.req)
        _M_PREEMPTED.inc()
        _ttrace.async_event("preempted", "serving.request", "n",
                            slot.req.rid)

    def _recompute_prompt(self, req):
        return req.prompt + req.outputs

    def _admissible(self, req):
        """Blocks to reserve at admission: optimistic (prompt only) when
        the adapter can recompute after preemption, worst case (whole
        token budget) when it cannot."""
        if self.adapter.supports_recompute:
            return max(len(self._recompute_prompt(req)), 1)
        return max(req.max_new_tokens - len(req.outputs), 1)

    def _emit(self, req, token, now):
        req.outputs.append(int(token))
        _M_TOKENS.inc()
        if req.first_token_t is None:
            req.first_token_t = now
            _H_TTFT.observe(now - req.submit_t)
            _ttrace.async_event("first_token", "serving.request", "n",
                                req.rid)
        elif req.last_emit_t is not None:
            _H_TPOT.observe(now - req.last_emit_t)
        req.last_emit_t = now

    def _req_finished(self, req):
        return (req.outputs and req.outputs[-1] == self.eos_id) \
            or len(req.outputs) >= req.max_new_tokens

    def _admit_one(self, req, slot_idx):
        """Prefill one request into a free slot.  Raises CacheOOMError
        with nothing mutated if the pool can't cover the reservation.

        With prefix caching on, full blocks of the prompt found in the
        index map straight into the slot's table and only the tail
        re-prefills (fixed block-sized chunks through the multi-token
        paged path); when the index covers the WHOLE prompt, the last
        token re-scores through a one-block chunk whose write triggers
        copy-on-write if another sequence still maps that block."""
        now = time.perf_counter()
        if self.adapter.supports_recompute:
            prompt = self._recompute_prompt(req)
        else:
            prompt = req.prompt
        hit0 = self.cache.prefix_hit_tokens
        if self._prefix_on:
            self.cache.admit(slot_idx, self._admissible(req), prompt)
        else:
            self.cache.admit(slot_idx, self._admissible(req))
        shared = self.cache.prefix_hit_tokens - hit0
        _H_QWAIT.observe(now - req.queued_t)
        _ttrace.async_event("admitted", "serving.request", "n", req.rid,
                            slot=slot_idx)
        try:
            with _tel.span("serving.prefill", "serving", rid=req.rid,
                           shared_tokens=shared):
                if shared:
                    # a fully-covered prompt still needs its last
                    # position's logits for the first generated token
                    tail = shared if shared < len(prompt) \
                        else len(prompt) - 1
                    for src, dst in self.cache.prepare_write(slot_idx,
                                                             tail):
                        for ad in self._adapters:
                            ad.copy_block(dst, src)
                    row = self.cache.tables[slot_idx]
                    first, pos = self.adapter.prefill_tail(
                        slot_idx, prompt, tail, row)
                    _M_POSITIONS.inc(pos)
                    _M_PREFILL_POS.inc(pos)
                    if self._spec is not None:
                        _t, dpos = self._spec.prefill_tail(
                            slot_idx, prompt, tail, row)
                        _M_DRAFT_POS.inc(dpos)
                else:
                    first = self.adapter.prefill(
                        slot_idx, prompt, self.cache.tables[slot_idx])
                    _M_POSITIONS.inc(self.adapter.prefill_tokens)
                    _M_PREFILL_POS.inc(self.adapter.prefill_tokens)
                    if self._spec is not None:
                        self._spec.prefill(slot_idx, prompt,
                                           self.cache.tables[slot_idx])
                        _M_DRAFT_POS.inc(self._spec.prefill_tokens)
        except Exception:
            # the blocks claimed above must not leak with the slot empty —
            # a poisoned slot would crash every later admission into it
            self.cache.release(slot_idx)
            raise
        self.cache.register_prefix(slot_idx, prompt)
        _M_PREFILLS.inc()
        _M_ADMITTED.inc()
        if self.adapter.first_token_from_prefill:
            # prompt tokens (incl. recomputed generations) now sit in
            # the pages; the new token decodes next iteration
            self.cache.ctx_len[slot_idx] = len(prompt)
            self._emit(req, first, time.perf_counter())
            last = first
        else:
            self.cache.ctx_len[slot_idx] = 0
            last = self.adapter.bos_id
        self._slots[slot_idx] = _Slot(req, last, now)  # graftcheck: ignore[GC04] — helper only called from _admit under step()'s self._lock
        if self._req_finished(req):
            self._finish(slot_idx)

    def _admit(self, now):
        # SLA sweep of the WHOLE queue first — a dead queued request must
        # unblock its caller this iteration even when admission is gated
        # (static policy mid-batch, pool pressure)
        expired = [r for r in self._queue if r.expired(now)]
        for req in expired:
            self._queue.remove(req)
            self._evict(req, "queued")
        free = [i for i, s in enumerate(self._slots) if s is None]
        if self.policy == "static" and len(free) < self.max_batch:
            return
        while self._queue and free:
            req = self._queue.popleft()
            if req.expired(time.perf_counter()):
                # the sweep above used one `now`, but each admission in
                # this loop burns a prefill — a request whose deadline
                # lapsed while earlier admissions ran must fail HERE,
                # not pay a prefill and get evicted next iteration
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
                _M_REJECTED.inc()
                req.done.set()
                continue
            except Exception as exc:  # noqa: BLE001 — adapter failure
                # prefill failed (device error, adapter bug): fail THIS
                # request and keep serving the rest; blocks were released
                # by _admit_one
                req.error = exc
                req.finish_t = time.perf_counter()
                req.done.set()
                continue
            free.pop(0)

    def _ensure_blocks(self, now, want=None):
        """Every active slot's next write position gets a block (``want``
        = per-slot position count, e.g. the speculative chunk width);
        pool pressure preempts the youngest recompute-capable slot."""
        del now
        for i in range(self.max_batch):
            while self._slots[i] is not None:
                try:
                    self.cache.ensure_capacity(
                        i, 1 if want is None else int(want[i]))
                    break
                except CacheOOMError as oom:
                    victims = sorted(
                        (j for j, s in enumerate(self._slots)
                         if s is not None
                         and self.adapter.supports_recompute
                         and len(self._recompute_prompt(s.req))
                         <= self.adapter.prefill_tokens),
                        key=lambda j: self._slots[j].admitted_t)
                    if not victims:
                        self._finish(i, error=oom)
                        break
                    self._preempt(victims[-1])
                    # if i preempted itself the outer while exits below

    def _upload_tables(self):
        if self._tables_version != self.cache.version:
            # tables only change at admission/allocation/release —
            # the steady-state iteration skips this upload
            self._tables_dev = self.adapter.to_device(self.cache.tables)
            self._tables_version = self.cache.version

    def _spec_budgets(self):
        """Per-slot speculative chunk width: how many positions this
        iteration may write/emit — the verify width capped by the
        request's remaining token budget (a slot on its last token runs
        a 1-valid-column verify, exactly the plain decode)."""
        want = np.zeros((self.max_batch,), np.int32)
        for i, slot in enumerate(self._slots):
            if slot is not None:
                want[i] = min(self._spec_k + 1,
                              slot.req.max_new_tokens
                              - len(slot.req.outputs))
        return want

    def _spec_step(self, active, n_valid):
        """One speculative iteration (lock held): spec_k draft-model
        single-token steps propose greedy continuations, ONE (B, K)
        target verify scores every column, and accept-longest-prefix +
        the target's own token keeps output bit-identical to plain
        greedy decode."""
        B, K = self.max_batch, self._spec_k + 1
        tokens = np.zeros((B, K), np.int32)
        for i in active:
            tokens[i, 0] = self._slots[i].last_token
        self._upload_tables()
        ctx = self.cache.ctx_len
        cur = tokens[:, 0].copy()
        for j in range(K - 1):
            # draft writes its own pools at ctx+j; over-budget columns
            # route to scratch (valid mask) so speculation can never
            # scribble past a slot's reserved blocks
            cur = np.asarray(self._spec.decode(
                cur, self._tables_dev, ctx + j,
                valid=(j < n_valid)), np.int32)
            tokens[:, j + 1] = cur
            _M_DRAFT_STEPS.inc()
            _M_DRAFT_POS.inc(B)
        sp = _tel.span("serving.decode_step", "serving",
                       batch=len(active), spec_k=K - 1)
        if sp is not _tel.NULL_SPAN:
            sp.set(rids=[self._slots[i].req.rid for i in active])
        with sp:
            g = self.adapter.decode_multi(tokens, self._tables_dev, ctx,
                                          n_valid)
        _M_STEPS.inc()
        _M_POSITIONS.inc(B * K)
        now = time.perf_counter()
        last_pos = ctx + (K - 1)      # d_k's position, before advancing
        catch_up = np.zeros((B,), bool)
        for i in active:
            slot = self._slots[i]
            if slot is None:
                continue              # preempted under pressure
            nv = int(n_valid[i])
            # column j's argmax is the target's next token after
            # consuming (t0, d1..dj); drafts are accepted while they
            # match it, then the target's own token closes the run
            emitted = [int(g[i, 0])]
            j = 0
            while j + 1 < nv and int(tokens[i, j + 1]) == emitted[-1]:
                j += 1
                emitted.append(int(g[i, j]))
            catch_up[i] = j == K - 1
            for e, tok in enumerate(emitted):
                if tok == self.eos_id:
                    emitted = emitted[:e + 1]
                    break
            _H_ACCEPTED.observe(len(emitted) - 1)
            self.cache.advance(i, len(emitted))
            slot.last_token = emitted[-1]
            for tok in emitted:
                self._emit(slot.req, tok, now)
            if self._req_finished(slot.req):
                self._finish(i)
                catch_up[i] = False
        if catch_up.any():
            # the draft proposed d_k without consuming it; where the target
            # accepted every draft, d_k's position is now part of the
            # sequence, so the draft writes its K/V there (other rows go to
            # scratch) — else its next steps read a stale position.  The
            # reference skips this write (ROADMAP C.7)
            self._spec.decode(tokens[:, K - 1], self._tables_dev, last_pos,
                              valid=catch_up)
            _M_DRAFT_STEPS.inc()
            _M_DRAFT_POS.inc(B)

    def _sync_prefix_counters(self):
        """Fold the cache's own tallies into telemetry (once per
        iteration — the cache stays import-light and telemetry free)."""
        c = self.cache
        if c.evictions != self._seen_evictions:
            _M_PREFIX_EVICT.inc(c.evictions - self._seen_evictions)
            self._seen_evictions = c.evictions
        if c.cow_copies != self._seen_cow:
            _M_PREFIX_COW.inc(c.cow_copies - self._seen_cow)
            self._seen_cow = c.cow_copies
        if c.prefix_hits != self._seen_hits:
            _M_PREFIX_HITS.inc(c.prefix_hits - self._seen_hits)
            self._seen_hits = c.prefix_hits
        if c.prefix_hit_tokens != self._seen_hit_tokens:
            _M_PREFIX_TOKENS.inc(
                c.prefix_hit_tokens - self._seen_hit_tokens)
            self._seen_hit_tokens = c.prefix_hit_tokens
        _G_CACHED_BLOCKS.set(c.cached_blocks)

    def step(self):
        """One scheduler iteration (expire → backfill → decode → retire).
        Returns True when any work was done — the background loop idles
        briefly on False."""
        with self._lock:
            now = time.perf_counter()
            # SLA check on running sequences first: no compute for the dead
            for i, slot in enumerate(self._slots):
                if slot is not None and slot.req.expired(now):
                    req = slot.req
                    self._slots[i] = None
                    self.cache.release(i)
                    self._evict(req, "decoding")
            self._admit(now)
            want = None if self._spec is None else self._spec_budgets()
            self._ensure_blocks(now, want)
            active = [i for i, s in enumerate(self._slots) if s is not None]
            did_work = bool(active)
            if active and self._spec is not None:
                # the dispatches run under self._lock for the same
                # reason as the plain decode below
                self._spec_step(active, want)
            elif active:
                tokens = np.zeros((self.max_batch,), np.int32)
                for i in active:
                    tokens[i] = self._slots[i].last_token
                self._upload_tables()
                # the dispatch runs under self._lock on purpose: released,
                # a finished slot could be backfilled mid-dispatch and this
                # step's tokens credited to the wrong request (lock-free
                # needs per-slot generation tags; submit() waiting out one
                # decode step is the accepted cost)
                sp = _tel.span("serving.decode_step", "serving",
                               batch=len(active))
                if sp is not _tel.NULL_SPAN:
                    # rid linkage: which requests this iteration decoded
                    sp.set(rids=[self._slots[i].req.rid for i in active])
                with sp:
                    nxt = self.adapter.decode(tokens, self._tables_dev,
                                              self.cache.ctx_len)
                _M_STEPS.inc()
                _M_POSITIONS.inc(self.max_batch)
                now = time.perf_counter()
                for i in active:
                    slot = self._slots[i]
                    if slot is None:
                        continue          # preempted under pressure
                    self.cache.advance(i)
                    tok = int(nxt[i])
                    slot.last_token = tok
                    self._emit(slot.req, tok, now)
                    if self._req_finished(slot.req):
                        self._finish(i)
            _G_QUEUE.set(len(self._queue))
            _G_ACTIVE.set(sum(s is not None for s in self._slots))
            _G_FREE_BLOCKS.set(self.cache.free_blocks)
            if self._prefix_on:
                self._sync_prefix_counters()
            return did_work or bool(self._queue)

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
        """Serve from a background daemon thread (the async mode:
        ``submit`` from any thread, ``ResultHandle.result`` to wait)."""
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
        """TERMINAL shutdown: stop the background loop and FAIL every
        pending request — an abandoned handle must error promptly, not
        sit on the full resilience-Deadline timeout waiting for a loop
        that is gone.  Later submit()s return already-failed handles."""
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
                _ttrace.async_event("request", "serving.request", "e",
                                    req.rid, tokens=len(req.outputs),
                                    error="stopped")
            _G_QUEUE.set(0)
            _G_ACTIVE.set(0)
            _G_FREE_BLOCKS.set(self.cache.free_blocks)
            if self._prefix_on:
                self._sync_prefix_counters()
