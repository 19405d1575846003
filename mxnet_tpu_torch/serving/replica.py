"""Replica worker — one ``ServingEngine`` behind a line-framed socket RPC;
the port of ``mxnet_tpu/serving/replica.py``.

The router (``serving.router``) supervises N of these as subprocesses.
Each worker:

- binds a localhost TCP socket and publishes ``{pid, port}`` to an atomic
  port file in the tier workdir (``replica-<i>.json``) — which is how a
  RESTARTED router finds and re-adopts a live replica (stdio pipes die
  with the parent; a socket survives it);
- beats the ``resilience.heartbeat`` file protocol (the router injects
  ``MXNET_ELASTIC_HEARTBEAT_DIR`` + ``MXNET_DIST_RANK``), walking
  ``spawned → bringup → running → done`` so staleness is the router's
  hang signal;
- serves one connection at a time (the router is the only client); a
  dropped connection loops back to ``accept`` so a successor router can
  reconnect.

Protocol (one JSON object per ``\\n``-terminated line, UTF-8):

    router -> replica:
      {"op": "submit", "rid": str, "prompt": [int], "max_new_tokens": N,
       "deadline_s": float|null}
      {"op": "submit_batch", "reqs": [{...submit fields...}]}
      {"op": "cancel", "rid": str}          # hedge loser
      {"op": "ping"}                        # load refresh
      {"op": "shutdown"}                    # graceful drain end

    replica -> router:
      {"type": "hello", "pid", "index", "slots", "load": [q, a, f]}
      {"type": "accepted", "rid" | "rids", "load"}
      {"type": "ack", "rid", "ok": true, "tokens": [...], "load"}
      {"type": "ack", "rid", "ok": false, "error": cls, "message", "load"}
      {"type": "pong", "load"}

``load`` is the engine's ATOMIC ``(queue_depth, active_slots,
free_blocks)`` snapshot — the least-loaded dispatch signal, shipped on
every ack.

Exactly-once discipline: completed replies are kept in a bounded
``done`` cache keyed by the ROUTER's rid, so a resubmitted rid answers
from the cache instead of recomputing, and a rid still in flight
re-attaches instead of double-submitting.  The ``serving.reply`` chaos
site fires after a result is computed but BEFORE its ack is written:
kind 'exit' there is the death window a router retry must cover without
the client ever seeing duplicate tokens.

The RPC half is engine-agnostic: anything with ``submit(prompt,
max_new_tokens, deadline_s) -> handle`` / ``load()`` / ``stop()`` serves
(the router tests drive it with a stub engine).  The CLI below builds a
zoo llama on the card from ``--seed`` — every replica of one seed holds
the same weights bit for bit — or on the CPU with ``--device cpu``.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import queue as _queue
import socket
import sys
import threading

from .. import config
from ..telemetry import tracer as _ttrace
from ..base import MXNetError
from ..resilience import chaos as _chaos
from ..resilience import heartbeat as _hb

__all__ = ["ReplicaServer", "port_file_path", "read_port_file",
           "build_llama", "main"]

HOST = "127.0.0.1"
DONE_CACHE = 256          # completed replies kept for rid dedup


def port_file_path(workdir, index):
    return os.path.join(workdir, f"replica-{int(index):04d}.json")


def read_port_file(workdir, index):
    """Parse a replica's published ``{pid, port, index}`` record, or None
    (absent / torn — atomic renames make torn rare)."""
    try:
        with open(port_file_path(workdir, index)) as f:
            rec = json.load(f)
    except (OSError, ValueError):
        return None
    return rec if isinstance(rec, dict) and "port" in rec else None


class _Pending:
    __slots__ = ("handle", "cancelled")

    def __init__(self, handle):
        self.handle = handle
        self.cancelled = False


class ReplicaServer:
    """Serve one engine over the line-framed RPC above."""

    def __init__(self, engine, workdir, index):
        self._engine = engine
        self._workdir = os.path.abspath(workdir)
        self._index = int(index)
        self._lsock = None
        self._conn = None            # current router connection (_wlock)
        self._lock = threading.Lock()       # pending/done maps + _stop
        self._wlock = threading.Lock()      # connection swap + line writes
        self._pending = {}                  # rid -> _Pending
        self._done = collections.OrderedDict()   # rid -> cached ack
        self._load_at = 0.0                 # _load TTL cache
        self._load_val = [0, 0, 0]
        self._outq = _queue.SimpleQueue()   # replies -> sender thread
        self._sender = None
        self._stop = False

    def attach_engine(self, engine):
        """Late-bind the engine (the CLI binds the socket first so the
        port file exists while the model still builds)."""
        self._engine = engine

    # -- wire ---------------------------------------------------------------

    def _load(self):
        """Engine load triple for acks, cached ~5ms: engine.load() takes
        the scheduler lock, and a submit/ack burst taking it per line
        convoys with the decode loop's long lock holds.  The cache races
        benignly across reader/waiter threads — load is advisory, and a
        5ms-stale triple is fresher than the router's ping fallback."""
        import time as _time
        now = _time.monotonic()
        if now - self._load_at > 0.005:
            try:
                self._load_val = list(self._engine.load())
            except Exception:  # noqa: BLE001 — load is advisory
                pass
            self._load_at = now      # the same benign race
        return list(self._load_val)

    def _send(self, obj):
        """Queue one reply for the sender thread.  Waiter/reader threads
        do NO wire work — the json+syscall cost on a completion burst
        otherwise interleaves with the scheduler thread's GIL windows
        between decode dispatches (measured as inter-step gaps).  A
        reply that finds no live router connection is dropped; the done
        cache answers the successor's resubmit."""
        self._outq.put(obj)
        return True

    def _sender_loop(self):
        """Drain the reply queue onto the current connection — batches a
        burst into one sendall, serializes writes without a lock convoy."""
        while True:
            obj = self._outq.get()
            if obj is None:
                return
            batch = [obj]
            try:
                while True:
                    nxt = self._outq.get_nowait()
                    if nxt is None:
                        return
                    batch.append(nxt)
            except _queue.Empty:
                pass
            data = "".join(json.dumps(o) + "\n" for o in batch).encode()
            with self._wlock:
                conn = self._conn
                if conn is None:
                    continue
                try:
                    conn.sendall(data)
                except OSError:
                    self._conn = None

    def bind(self):
        """Listen on an ephemeral localhost port and publish the port
        file (write-then-rename: a router never reads a torn record)."""
        self._lsock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._lsock.bind((HOST, 0))
        self._lsock.listen(4)
        port = self._lsock.getsockname()[1]
        os.makedirs(self._workdir, exist_ok=True)
        path = port_file_path(self._workdir, self._index)
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump({"pid": os.getpid(), "port": port,
                       "index": self._index}, f)
        os.replace(tmp, path)
        return port

    # -- request lifecycle --------------------------------------------------

    def _waiter(self, rid, handle):
        """Block for one request's result and ack it (one daemon thread
        per in-flight request; bounded by the router's admission
        control).  The engine's own Deadline bounds the wait, so a dead
        scheduler thread becomes an error ack, not a leaked thread."""
        try:
            # wait() + drained result(): no Deadline worker thread per
            # request (handle.wait exists for exactly this caller)
            if hasattr(handle, "wait"):
                handle.wait(config.get_float(
                    "MXNET_KVSTORE_TIMEOUT_S", 300.0))
            tokens = handle.result(timeout=5.0)
            reply = {"type": "ack", "rid": rid, "ok": True,
                     "tokens": [int(t) for t in tokens]}
        except Exception as exc:  # noqa: BLE001 — shipped to the router
            reply = {"type": "ack", "rid": rid, "ok": False,
                     "error": type(exc).__name__,
                     "message": str(exc)[:300]}
        with self._lock:
            p = self._pending.pop(rid, None)
            cancelled = p is not None and p.cancelled
            if not cancelled:
                self._done[rid] = reply
                while len(self._done) > DONE_CACHE:
                    self._done.popitem(last=False)
        if cancelled:
            return            # hedge loser: computed, deliberately unacked
        # the dedup-on-retry window: the result exists, the ack does not.
        # kind 'exit' here is the replica death a router resubmission must
        # make invisible (the survivor recomputes token-identically)
        if _chaos._ACTIVE:
            _chaos.hit("serving.reply", rid=rid)
        _ttrace.async_event("replica_reply", "router.request", "n", rid,
                            replica=self._index, ok=reply["ok"])
        self._send(dict(reply, load=self._load()))

    def _submit_one(self, rec):
        """Admit one submit record.  Returns a CACHED final ack when the
        rid already completed (restarted-router resubmit: recomputing
        would be wasted prefill, acking different content would break
        exactly-once), else None — a rid already in flight re-attaches
        (the waiter acks to whichever connection is current).  The
        accepted ack is the caller's job (batched)."""
        rid = str(rec["rid"])
        with self._lock:
            cached = self._done.get(rid)
            pending = rid in self._pending
        if cached is not None:
            return cached
        if pending:
            return None
        _ttrace.async_event("replica_accept", "router.request", "n",
                            rid, replica=self._index)
        handle = self._engine.submit(
            list(rec.get("prompt") or []),
            max_new_tokens=int(rec.get("max_new_tokens", 32)),
            deadline_s=rec.get("deadline_s"))
        with self._lock:
            self._pending[rid] = _Pending(handle)
        threading.Thread(target=self._waiter, args=(rid, handle),
                         daemon=True,
                         name=f"mx-replica-wait-{rid}").start()
        return None

    def _handle(self, msg):
        """Dispatch one parsed request line.  Returns False to end the
        accept loop (shutdown)."""
        op = msg.get("op")
        if op == "submit":
            cached = self._submit_one(msg)
            if cached is not None:
                self._send(dict(cached, load=self._load()))
            else:
                self._send({"type": "accepted", "rid": msg.get("rid"),
                            "load": self._load()})
        elif op == "submit_batch":
            reqs = msg.get("reqs") or []
            for rec in reqs:
                cached = self._submit_one(rec)
                if cached is not None:
                    self._send(dict(cached, load=self._load()))
            self._send({"type": "accepted",
                        "rids": [r.get("rid") for r in reqs],
                        "load": self._load()})
        elif op == "cancel":
            rid = str(msg.get("rid"))
            with self._lock:
                p = self._pending.get(rid)
                if p is not None:
                    p.cancelled = True
                self._done.pop(rid, None)
            _ttrace.async_event("replica_cancel", "router.request", "n",
                                rid, replica=self._index)
            # cancels are rare (hedge losers) — an append-only log line
            # makes "the loser was really cancelled" externally checkable
            try:
                with open(os.path.join(
                        self._workdir,
                        f"cancels-{self._index:04d}.log"), "a") as f:
                    f.write(rid + "\n")
            except OSError:
                pass
        elif op == "ping":
            self._send({"type": "pong", "load": self._load()})
        elif op == "shutdown":
            self._send({"type": "bye"})
            return False
        return True

    def _serve_conn(self, conn):
        """One router connection: hello, then request lines until EOF or
        shutdown.  Returns False when the worker should exit."""
        conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        with self._wlock:
            self._conn = conn
        self._send({"type": "hello", "pid": os.getpid(),
                    "index": self._index,
                    "slots": getattr(self._engine, "max_batch", None),
                    "load": self._load()})
        keep = True
        try:
            with conn.makefile("r", encoding="utf-8") as rfile:
                for line in rfile:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        msg = json.loads(line)
                    except ValueError:
                        continue      # torn line from a dying router
                    keep = self._handle(msg)
                    if not keep:
                        break
        except OSError:
            pass
        with self._wlock:
            if self._conn is conn:
                self._conn = None
        try:
            conn.close()
        except OSError:
            pass
        return keep

    def run(self):
        """Accept loop: one router at a time; a dropped router loops back
        to accept so its restarted successor can re-adopt this replica."""
        if self._lsock is None:
            self.bind()
        self._sender = threading.Thread(target=self._sender_loop,
                                        daemon=True,
                                        name="mx-replica-send")
        self._sender.start()
        while True:
            with self._lock:
                if self._stop:
                    break
            try:
                conn, _addr = self._lsock.accept()
            except OSError:
                break
            if not self._serve_conn(conn):
                break
        self.close()

    def close(self):
        with self._lock:
            self._stop = True
        self._outq.put(None)        # sender sentinel
        # races only with accept(), whose OSError is the intended wakeup
        sock, self._lsock = self._lsock, None
        if sock is not None:
            try:
                sock.close()
            except OSError:
                pass
        try:
            self._engine.stop()
        except Exception:  # noqa: BLE001 — shutdown is best-effort
            pass


# -- CLI (the real-model worker the router spawns) ---------------------------

def build_llama(name, vocab, seed, device="gpu"):
    """The zoo llama ``name`` a replica serves: Normal(0.05) weights drawn
    from ``seed`` on ``device`` ("gpu": the card; "cpu"), no gradient
    buffers.  Callers that hold a replica's tokens against an in-process
    engine build its model with this too."""
    import mxnet_tpu_torch as mx
    from ..gluon.model_zoo import llama
    ctx = mx.cpu() if device == "cpu" else mx.gpu(0)
    net = llama.llama_model(name, vocab_size=vocab, prefix="llm_")
    net.collect_params().setattr("grad_req", "null")
    mx.random.seed(seed)
    net.initialize(mx.initializer.Normal(0.05), ctx=ctx)
    return net


def _build_engine(args):
    """Deterministic llama build: every replica spawned with the same
    (model, vocab, seed, device) holds bit-identical weights, which is
    what makes a retried request's re-prefill on a survivor
    token-identical.  The weights are drawn on ``--device`` (the card by
    default) from ``--seed``.  The draft model (speculative decoding,
    ``--draft`` / ``MXNET_SERVING_DRAFT``) builds the same way from its
    own zoo config name — same seed, same vocab."""
    import torch
    from .engine import ServingEngine

    if args.device == "cpu":
        torch.set_num_threads(1)      # N replicas share the host's cores
    net = build_llama(args.model, args.vocab, args.seed, args.device)
    draft = build_llama(args.draft, args.vocab, args.seed, args.device) \
        if args.draft else None
    eng = ServingEngine(
        net, eos_id=args.eos, max_batch=args.max_batch,
        block_tokens=args.block_tokens, max_seq=args.max_seq,
        prefill_tokens=args.prefill_tokens,
        prefix_cache=args.prefix_cache, draft_model=draft,
        spec_k=args.spec_k)
    eng.start()
    return eng


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="serving replica worker (spawned by serving.router)")
    ap.add_argument("--workdir",
                    default=config.get("MXNET_ROUTER_DIR"))
    ap.add_argument("--index", type=int,
                    default=config.get_int("MXNET_ROUTER_INDEX", 0))
    ap.add_argument("--model", default="llama_tiny")
    ap.add_argument("--vocab", type=int, default=101)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--eos", type=int, default=-1)
    ap.add_argument("--device", choices=("gpu", "cpu"), default="gpu",
                    help="where the model lives: the card (default) or "
                         "the host on one torch thread (tests)")
    ap.add_argument("--max-batch", type=int, default=None)
    ap.add_argument("--block-tokens", type=int, default=None)
    ap.add_argument("--max-seq", type=int, default=None)
    ap.add_argument("--prefill-tokens", type=int, default=None)
    ap.add_argument("--draft", default=config.get("MXNET_SERVING_DRAFT"),
                    help="draft-model zoo config for speculative decoding "
                         "(MXNET_SERVING_DRAFT; unset = off)")
    ap.add_argument("--spec-k", type=int, default=None,
                    help="draft tokens per iteration (MXNET_SERVING_SPEC_K)")
    ap.add_argument("--prefix-cache", type=int,
                    default=config.get_int("MXNET_SERVING_PREFIX_CACHE", 0),
                    help="1 arms paged-KV prefix caching "
                         "(MXNET_SERVING_PREFIX_CACHE)")
    args = ap.parse_args(argv)
    if not args.workdir:
        raise MXNetError("replica worker needs --workdir "
                         "(or MXNET_ROUTER_DIR in the env)")
    # the scheduler thread re-acquires the GIL after every dispatch; a 1 ms
    # switch interval bounds the handoff to the reader thread
    sys.setswitchinterval(0.001)
    # the reference also tags its telemetry shard with this rank; the
    # aggregation plane is not ported yet (ROADMAP A.11)
    _ttrace.get_tracer().set_process_label(
        f"mxnet_tpu_torch replica {args.index}")
    _hb.start()
    _hb.set_phase("bringup")
    # bind + publish the port file BEFORE the (slow) model build: a
    # router can then connect — and a RESTARTED router re-adopt — a
    # still-building replica; early submits wait in the socket buffer
    # until the accept loop starts below
    srv = ReplicaServer(None, args.workdir, args.index)
    srv.bind()
    try:
        srv.attach_engine(_build_engine(args))
    except Exception as exc:  # noqa: BLE001 — surfaced to the router
        _hb.mark_failed(exc)
        raise
    _hb.set_phase("running")
    srv.run()
    _hb.mark_done()
    return 0


if __name__ == "__main__":
    sys.exit(main())
