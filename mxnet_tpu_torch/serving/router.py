"""Fault-tolerant serving router — N engine replicas behind one front
door; the port of ``mxnet_tpu/serving/router.py``.

One ``Router`` spawns and supervises N ``serving.replica`` worker
subprocesses (each a ``ServingEngine`` behind a line-framed localhost
socket RPC with a ``resilience.heartbeat`` file) and makes replica
failure invisible to callers:

Dispatch
    Least-loaded: every replica ack ships the engine's atomic
    ``(queue_depth, active_slots, free_blocks)`` triple, and idle replicas
    are pinged every ``MXNET_ROUTER_PING_S`` so the view stays fresh.
    Ties break by a rotating index (deterministic tests), except that a
    request whose prompt-prefix hash (``MXNET_ROUTER_AFFINITY_TOKENS``)
    was recently served prefers that replica — the tier-level half of
    prefix caching.

Admission
    Outstanding requests (queued + dispatched, unfinished) are bounded
    by ``MXNET_ROUTER_QUEUE``; submits beyond it raise
    :class:`RouterOverloaded` immediately (``mxnet_router_shed_total``).

Deadlines
    ``submit(deadline_s=)`` propagates: the REMAINING budget is
    forwarded on every (re-)dispatch, a request that expires while
    queued fails without burning a prefill, and ``RouterHandle.result``
    is ``Deadline``-bounded so a dead tier surfaces as an error, never a
    hang.

Failure
    A dead replica (exit, heartbeat staleness past
    ``MXNET_ROUTER_HANG_S`` → SIGKILL, socket EOF) has its in-flight
    requests transparently resubmitted to survivors — exactly-once for
    the client because greedy decode re-prefilled on an identically
    seeded twin is token-identical, and replica-side rid dedup answers
    resubmits of already-computed results from a cache.  The replica is
    respawned with the Retry policy's backoff under the
    ``MXNET_ROUTER_MAX_RESPAWNS`` budget.

Hedging
    ``MXNET_ROUTER_HEDGE_S > 0`` duplicates a straggling dispatch to a
    second replica; first completion wins, the loser gets a cancel.

Drain
    :meth:`drain` stops dispatch to one replica, lets its in-flight
    requests finish, shuts it down cleanly, and respawns it — the
    rolling-restart primitive.

Survive
    Accepted requests and replica pids are journaled to ``router.json``
    (write-then-rename) BEFORE the actions they describe; a router killed
    at any point — including the ``router.dispatch`` chaos window between
    journaling and sending — can be restarted on the same workdir,
    re-adopt live replicas through their published port files, and
    re-dispatch the journal so every accepted request still resolves
    (:meth:`recovered`).

The router counts ``mxnet_router_{dispatched,retries,hedges,shed,
replica_deaths,respawns}_total``, per-replica health gauges, and an async
span tree per request (cat ``router.request``) that the replica workers'
accept/reply markers link into.
"""

from __future__ import annotations

import collections
import json
import os
import signal
import socket
import subprocess
import threading
import time

from .. import config
from .. import telemetry as _tel
from ..telemetry import tracer as _ttrace
from ..base import MXNetError
from ..resilience import chaos as _chaos
from ..resilience import heartbeat as _hb
from ..resilience.controller import _pid_alive, _pid_matches
from ..resilience.policies import Deadline, Retry
from .engine import RequestDeadlineExceeded, ServingError
from .replica import port_file_path, read_port_file

__all__ = ["Router", "RouterHandle", "RouterOverloaded",
           "ReplicaDeadError", "STATE_FILE"]

STATE_FILE = "router.json"
STATE_VERSION = 1
# bound on the prefix-affinity map (prefix-hash -> last replica): beyond
# it the least-recently-dispatched prefixes age out — a stale or evicted
# entry only costs one cold prefill on another replica, never correctness
AFFINITY_MAP = 512


class RouterOverloaded(ServingError):
    """Admission control shed this request: the router's bounded queue
    (MXNET_ROUTER_QUEUE) is full.  Raised synchronously at submit — an
    overloaded tier fails fast, it never hangs."""


class ReplicaDeadError(ServingError):
    """Every dispatch of this request died with the retry budget
    (MXNET_ROUTER_MAX_RETRIES) spent."""


_M_DISPATCHED = _tel.counter(
    "mxnet_router_dispatched_total",
    "Requests dispatched to a replica (retries and hedges included).")
_M_RETRIES = _tel.counter(
    "mxnet_router_retries_total",
    "Requests resubmitted to a survivor after their replica died.")
_M_HEDGES = _tel.counter(
    "mxnet_router_hedges_total",
    "Straggling requests duplicated to a second replica "
    "(MXNET_ROUTER_HEDGE_S).")
_M_SHEDS = _tel.counter(
    "mxnet_router_shed_total",
    "Submits rejected with RouterOverloaded by admission control "
    "(MXNET_ROUTER_QUEUE).")
_M_DEATHS = _tel.counter(
    "mxnet_router_replica_deaths_total",
    "Replica deaths observed (exits, socket EOF, heartbeat hangs).")
_M_RESPAWNS = _tel.counter(
    "mxnet_router_respawns_total",
    "Replica respawns (crash recovery and rolling-restart drains).")
_G_QUEUE = _tel.gauge(
    "mxnet_router_queue_depth",
    "Requests waiting in the router for dispatch.")
_G_OUTSTANDING = _tel.gauge(
    "mxnet_router_outstanding",
    "Accepted, unfinished requests (queued + dispatched) — the quantity "
    "MXNET_ROUTER_QUEUE bounds.")


def _g_up(index):
    return _tel.gauge(
        "mxnet_router_replica_up",
        "1 while this replica is connected and dispatchable, else 0.",
        labels={"replica": str(index)})


def _g_load(index):
    return _tel.gauge(
        "mxnet_router_replica_load",
        "Last-known queue_depth + active_slots of this replica (the "
        "least-loaded dispatch key).",
        labels={"replica": str(index)})


class _Req:
    """One client request moving through the router."""

    __slots__ = ("rid", "tag", "prompt", "max_new_tokens", "deadline_s",
                 "submit_wall", "submit_t", "done", "tokens", "error",
                 "dispatches", "retries", "hedged", "finish_t",
                 "last_dispatch_t", "affinity")

    def __init__(self, rid, tag, prompt, max_new_tokens, deadline_s,
                 submit_wall=None):
        self.rid = str(rid)
        self.tag = tag if tag is not None else str(rid)
        self.prompt = [int(t) for t in prompt]
        self.max_new_tokens = int(max_new_tokens)
        self.deadline_s = deadline_s
        self.submit_wall = time.time() if submit_wall is None \
            else float(submit_wall)
        self.submit_t = time.perf_counter()
        self.done = threading.Event()
        self.tokens = None
        self.error = None
        self.dispatches = set()      # replica indices currently running it
        self.retries = 0
        self.hedged = False
        self.finish_t = None
        self.last_dispatch_t = None
        self.affinity = None         # prompt-prefix hash (router sets it)

    def remaining_s(self):
        """Remaining deadline budget (None = unbounded) measured on the
        WALL clock from the original submit, so it survives a router
        restart."""
        if self.deadline_s is None:
            return None
        return float(self.deadline_s) - (time.time() - self.submit_wall)

    def journal_record(self):
        return {"tag": self.tag, "prompt": self.prompt,
                "max_new_tokens": self.max_new_tokens,
                "deadline_s": self.deadline_s,
                "submit_wall": self.submit_wall}


class RouterHandle:
    """Caller-side view of a routed request (the router twin of the
    engine's ResultHandle)."""

    def __init__(self, req):
        self._req = req

    @property
    def rid(self):
        return self._req.rid

    @property
    def tag(self):
        return self._req.tag

    def ready(self):
        return self._req.done.is_set()

    def stats(self):
        req = self._req
        return {
            "e2e_s": (None if req.finish_t is None
                      else req.finish_t - req.submit_t),
            "finish_t": req.finish_t,
            "tokens": 0 if req.tokens is None else len(req.tokens),
            "retries": req.retries,
            "hedged": req.hedged,
        }

    def result(self, timeout=None):
        """Block for the tokens; Deadline-bounded so a dead tier raises
        instead of hanging.  Request-level failures re-raise here."""
        if not self._req.done.is_set():
            Deadline(timeout_s=timeout, site="router.result").call(
                self._req.done.wait)
        if self._req.error is not None:
            raise self._req.error
        return list(self._req.tokens)


class _Replica:
    """Router-side view of one replica subprocess."""

    # states: starting (spawned, not yet connected), up, draining (no
    # new dispatch), stopping (planned shutdown sent), down
    __slots__ = ("index", "proc", "pid", "sock", "wlock", "state",
                 "load", "last_seen", "last_ping", "inflight", "respawns",
                 "next_respawn_t", "spawn_t", "adopted", "slots")

    def __init__(self, index):
        self.index = int(index)
        self.proc = None
        self.pid = None
        self.sock = None
        self.wlock = threading.Lock()
        self.state = "down"
        self.load = (0, 0, 0)
        self.last_seen = 0.0
        self.last_ping = 0.0
        self.inflight = {}
        self.respawns = 0
        self.next_respawn_t = 0.0
        self.spawn_t = 0.0
        self.adopted = False
        self.slots = None

    def load_key(self):
        """Pending WORK estimate, not request count: the router knows
        every in-flight request's token budget, and weighting by it is
        what keeps a mixed workload's long generations from clustering
        on one replica (the reference measured count-balanced dispatch
        halving its scale-out ratio that way).  The replica's
        reported (queue+active) covers only requests this router did
        NOT place there (an adopted replica finishing a dead router's
        work) — the max(0, ...) keeps our own dispatches from double
        counting while their accepted-acks race back."""
        own = sum(req.max_new_tokens for req in self.inflight.values())
        foreign = max(0, self.load[0] + self.load[1]
                      - len(self.inflight))
        return own + 8 * foreign


class Router:
    """Spawn, dispatch, retry, hedge, shed, drain, survive (module
    docstring has the story).

    ``command`` is the replica argv (the same for every replica; identity
    arrives via injected env: ``MXNET_ROUTER_INDEX``/``MXNET_DIST_RANK``,
    the tier workdir, and the heartbeat dir).  ``workdir`` owns the state
    journal, port files, heartbeats, per-replica logs, telemetry shards,
    and flight-recorder dumps.
    """

    def __init__(self, command, nreplicas, workdir, *, queue_max=None,
                 hedge_s=None, max_retries=None, max_respawns=None,
                 hang_s=None, ping_s=None, grace_s=3.0,
                 spawn_timeout_s=240.0, env_extra=None,
                 env_per_replica=None, poll_s=0.05,
                 affinity_tokens=None):
        if not command:
            raise MXNetError("router needs a replica worker command")
        self._command = [str(c) for c in command]
        self._n = int(nreplicas)
        if self._n < 1:
            raise MXNetError(f"nreplicas must be >= 1, got {nreplicas}")
        self._workdir = os.path.abspath(workdir)
        self._queue_max = queue_max if queue_max is not None \
            else config.get_int("MXNET_ROUTER_QUEUE", 64)
        self._hedge_s = hedge_s if hedge_s is not None \
            else config.get_float("MXNET_ROUTER_HEDGE_S", 0.0)
        self._max_retries = max_retries if max_retries is not None \
            else config.get_int("MXNET_ROUTER_MAX_RETRIES", 2)
        self._max_respawns = max_respawns if max_respawns is not None \
            else config.get_int("MXNET_ROUTER_MAX_RESPAWNS", 8)
        self._hang_s = hang_s if hang_s is not None \
            else config.get_float("MXNET_ROUTER_HANG_S", 20.0)
        self._ping_s = ping_s if ping_s is not None \
            else config.get_float("MXNET_ROUTER_PING_S", 1.0)
        self._grace_s = float(grace_s)
        self._spawn_timeout_s = float(spawn_timeout_s)
        self._env_extra = dict(env_extra or {})
        self._env_per_replica = {int(k): dict(v) for k, v in
                                 (env_per_replica or {}).items()}
        self._poll_s = float(poll_s)
        # prefix-affinity dispatch hint: least-loaded TIES prefer the
        # replica that last served the same prompt-prefix hash, so a
        # shared-system-prompt workload actually lands on the replica
        # whose paged-KV prefix cache holds those blocks
        self._affinity_tokens = affinity_tokens if affinity_tokens \
            is not None else config.get_int(
                "MXNET_ROUTER_AFFINITY_TOKENS", 16)
        self._affinity = collections.OrderedDict()  # hash -> replica idx
        self._backoff = Retry(site="router.respawn")

        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._queue = []                 # _Req waiting for dispatch
        self._requests = {}              # rid -> _Req, every unfinished
        self._recovered = {}             # tag -> RouterHandle (restart)
        self._replicas = [_Replica(i) for i in range(self._n)]
        self._rr = 0                     # rotating dispatch tie-break
        self._rid_n = 0
        self._rid_salt = f"{os.getpid():x}{int(time.time()) & 0xffff:x}"
        self._journal_dirty = False
        self._stopping = False
        self._started = False
        self._threads = []

    # -- paths / journal ----------------------------------------------------

    @property
    def workdir(self):
        return self._workdir

    def _state_path(self):
        return os.path.join(self._workdir, STATE_FILE)

    def _hb_dir(self):
        return os.path.join(self._workdir, "hb")

    def _log_path(self, index):
        return os.path.join(self._workdir, "logs",
                            f"replica-{index}.log")

    def _save_state(self, phase):
        """Write-then-rename journal commit (the manifest discipline):
        called with self._lock HELD — every mutation it records is
        already visible to the writer."""
        st = {
            "version": STATE_VERSION,
            "phase": phase,
            "command": self._command,
            "nreplicas": self._n,
            "replicas": [{"index": r.index, "pid": r.pid,
                          "respawns": r.respawns}
                         for r in self._replicas],
            "requests": {req.rid: req.journal_record()
                         for req in self._requests.values()},
        }
        os.makedirs(self._workdir, exist_ok=True)
        path = self._state_path()
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(st, f)
        os.replace(tmp, path)
        self._journal_dirty = False

    def _load_state(self):
        try:
            with open(self._state_path()) as f:
                st = json.load(f)
        except (OSError, ValueError):
            return None
        return st if isinstance(st, dict) and "phase" in st else None

    # -- lifecycle ----------------------------------------------------------

    def start(self):
        """Spawn the tier — or, when a previous router's journal exists
        on this workdir, re-adopt its live replicas and re-dispatch its
        unfinished requests (available via :meth:`recovered`)."""
        if self._started:
            return self
        self._started = True
        os.makedirs(self._workdir, exist_ok=True)
        os.makedirs(os.path.join(self._workdir, "logs"), exist_ok=True)
        # the router is its own telemetry rank: one past the replicas
        _tel.aggregate.set_rank(self._n)
        _ttrace.get_tracer().set_process_label("mxnet_tpu_torch router")
        st = self._load_state()
        with self._lock:
            if st is not None and st.get("phase") == "running":
                self._recover(st)
            else:
                for rep in self._replicas:
                    self._spawn_replica(rep)
            self._save_state("running")
        for fn, name in ((self._dispatch_loop, "mx-router-dispatch"),
                         (self._monitor_loop, "mx-router-monitor")):
            t = threading.Thread(target=fn, daemon=True, name=name)
            t.start()
            self._threads.append(t)
        return self

    def _recover(self, st):
        """Re-adopt a dead router's tier (lock held).  Live recorded
        replicas reconnect through their port files; dead ones respawn;
        journaled unfinished requests re-queue with their ORIGINAL rids
        so replica-side dedup answers already-computed ones from cache."""
        _tel.instant("router.recover", "router",
                     requests=len(st.get("requests") or {}))
        for rec in st.get("replicas") or []:
            idx = int(rec.get("index", -1))
            if not (0 <= idx < self._n):
                continue
            rep = self._replicas[idx]
            rep.respawns = int(rec.get("respawns", 0))
            pid = rec.get("pid")
            port_rec = read_port_file(self._workdir, idx)
            if pid and port_rec and int(port_rec.get("pid", -1)) == int(pid) \
                    and _pid_alive(pid) and _pid_matches(pid, self._workdir):
                rep.pid = int(pid)
                rep.adopted = True
                rep.state = "starting"      # monitor connects it
                rep.spawn_t = time.time()
            else:
                # a live recorded pid we CANNOT adopt (no matching port
                # file) must die before its replacement spawns — two
                # replicas fighting over one index would clobber the
                # port file and leak the loser forever
                if pid and _pid_alive(pid) \
                        and _pid_matches(pid, self._workdir):
                    try:
                        os.kill(int(pid), signal.SIGKILL)
                    except OSError:
                        pass
                self._spawn_replica(rep)
        for rid, rec in (st.get("requests") or {}).items():
            req = _Req(rid, rec.get("tag"), rec.get("prompt") or [],
                       rec.get("max_new_tokens", 32),
                       rec.get("deadline_s"),
                       submit_wall=rec.get("submit_wall"))
            req.affinity = self._affinity_key(req.prompt)
            self._requests[req.rid] = req
            self._queue.append(req)
            self._recovered[req.tag] = RouterHandle(req)
            # re-open the span tree under the ORIGINAL rid: the dead
            # router's shard (same rank) is superseded by this process's
            # in the latest-per-rank merge, so without a fresh 'b' the
            # recovered request's retry/reply markers would dangle
            _ttrace.async_event("request", "router.request", "b",
                                req.rid, recovered=True,
                                prompt_tokens=len(req.prompt),
                                max_new_tokens=req.max_new_tokens)
        self._cond.notify_all()

    def recovered(self):
        """{tag: RouterHandle} for requests re-adopted from a previous
        router's journal (tag defaults to the rid)."""
        with self._lock:
            return dict(self._recovered)

    def _replica_env(self, rep):
        env = dict(os.environ)
        # replicas run with cwd=workdir (the pid-reuse guard keys on it);
        # an uninstalled source tree must still resolve `-m
        # mxnet_tpu_torch.serving.replica`, so the package root rides
        # PYTHONPATH
        root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        pkg_root = os.path.dirname(root)
        pp = env.get("PYTHONPATH")
        env["PYTHONPATH"] = pkg_root if not pp \
            else os.pathsep.join([pkg_root, pp])
        env["MXNET_TELEMETRY"] = "1"
        env.update(self._env_extra)
        env.update(self._env_per_replica.get(rep.index, {}))
        env["MXNET_ROUTER_DIR"] = self._workdir
        env["MXNET_ROUTER_INDEX"] = str(rep.index)
        env["MXNET_DIST_RANK"] = str(rep.index)
        env["MXNET_ELASTIC_HEARTBEAT_DIR"] = self._hb_dir()
        return env

    def _spawn_attempt(self, rep):
        """One spawn try: the ``router.replica_spawn`` chaos site fires
        first (transient faults here are absorbed by the Retry wrap in
        :meth:`_spawn_replica`); a stale port file is removed so the
        monitor can't adopt a corpse's port."""
        if _chaos._ACTIVE:
            _chaos.hit("router.replica_spawn", replica=rep.index)
        try:
            os.remove(port_file_path(self._workdir, rep.index))
        except OSError:
            pass
        log = self._log_path(rep.index)
        os.makedirs(os.path.dirname(log), exist_ok=True)
        with open(log, "ab") as lf:
            return subprocess.Popen(
                self._command, env=self._replica_env(rep),
                stdout=lf, stderr=subprocess.STDOUT, cwd=self._workdir)

    def _spawn_replica(self, rep):
        """Spawn (or respawn) one replica subprocess (lock held)."""
        rep.proc = Retry(site="router.replica_spawn").call(
            self._spawn_attempt, rep)
        rep.pid = rep.proc.pid
        rep.adopted = False
        rep.state = "starting"
        rep.spawn_t = time.time()
        rep.load = (0, 0, 0)
        _g_up(rep.index).set(0)
        _tel.instant("router.replica_spawn", "router", replica=rep.index,
                     pid=rep.pid)

    # -- submission / shedding ----------------------------------------------

    def submit(self, prompt, max_new_tokens=32, deadline_s=None,
               tag=None):
        """Queue one request; returns a :class:`RouterHandle`.  Raises
        :class:`RouterOverloaded` synchronously when the admission bound
        is hit — shed traffic fails fast, it never hangs."""
        if not self._started:
            raise MXNetError("router not started: call start() first")
        if deadline_s is not None:
            deadline_s = float(deadline_s)
        with self._lock:
            if self._stopping:
                raise ServingError("router stopped")
            if len(self._requests) >= self._queue_max:
                _M_SHEDS.inc()
                _tel.instant("router.shed", "router",
                             outstanding=len(self._requests))
                raise RouterOverloaded(
                    f"router queue full ({len(self._requests)} >= "
                    f"{self._queue_max} outstanding, MXNET_ROUTER_QUEUE) "
                    "— request shed")
            self._rid_n += 1
            req = _Req(f"{self._rid_salt}-{self._rid_n}", tag, prompt,
                       max_new_tokens, deadline_s)
            req.affinity = self._affinity_key(req.prompt)
            _ttrace.async_event("request", "router.request", "b", req.rid,
                                prompt_tokens=len(req.prompt),
                                max_new_tokens=req.max_new_tokens)
            self._requests[req.rid] = req
            self._queue.append(req)
            # accepted == journaled-before-dispatch: the DISPATCHER
            # flushes the journal before sending any unjournaled
            # request (one write covers a whole submit burst), so a
            # router death at any point still leaves every dispatched
            # request recoverable — while a 32-request burst pays 1-2
            # journal writes instead of 32 O(n) rewrites
            self._journal_dirty = True
            _G_QUEUE.set(len(self._queue))
            _G_OUTSTANDING.set(len(self._requests))
            self._cond.notify_all()
        return RouterHandle(req)

    # -- resolution ---------------------------------------------------------

    def _finish_req(self, req, tokens=None, error=None):
        """Resolve a request (lock held).  First completion wins; the
        journal entry is dropped lazily (a stale entry only costs a
        recovered recompute, never correctness)."""
        if req.done.is_set():
            return
        req.tokens = tokens
        req.error = error
        req.finish_t = time.perf_counter()
        req.done.set()
        self._requests.pop(req.rid, None)
        self._journal_dirty = True
        _G_OUTSTANDING.set(len(self._requests))
        _ttrace.async_event(
            "request", "router.request", "e", req.rid,
            tokens=0 if tokens is None else len(tokens),
            error=type(error).__name__ if error else None)

    def _map_error(self, error_cls, message):
        if error_cls == "RequestDeadlineExceeded":
            return RequestDeadlineExceeded(message)
        return ServingError(f"replica failed request: {error_cls}: "
                            f"{message}")

    def _on_ack(self, rep, msg):
        rid = str(msg.get("rid"))
        losers = []
        with self._lock:
            req = rep.inflight.pop(rid, None)
            if req is None:
                return                      # cancelled / stale
            req.dispatches.discard(rep.index)
            if req.done.is_set():
                return
            if msg.get("ok"):
                self._finish_req(req, tokens=[int(t) for t in
                                              msg.get("tokens") or []])
            else:
                self._finish_req(req, error=self._map_error(
                    msg.get("error"), msg.get("message")))
            losers = [self._replicas[i] for i in list(req.dispatches)]
            for lrep in losers:
                lrep.inflight.pop(rid, None)
            req.dispatches.clear()
        for lrep in losers:                 # hedge losers: cancel compute
            self._send_to(lrep, {"op": "cancel", "rid": rid})

    # -- wire ---------------------------------------------------------------

    def _send_to(self, rep, obj):
        """One line to one replica; a failed send reports the replica
        down (socket writes serialize on the replica's own lock, never
        under the router lock — a wedged peer must not stall dispatch)."""
        data = (json.dumps(obj) + "\n").encode()
        with rep.wlock:
            sock = rep.sock
            if sock is None:
                return False
            try:
                sock.sendall(data)
                return True
            except OSError:
                pass
        self._on_replica_down(rep, "send")
        return False

    def _connect_replica(self, rep):
        """Try to connect a 'starting' replica through its port file.
        Returns True once the socket is up and the reader thread runs."""
        port_rec = read_port_file(self._workdir, rep.index)
        if port_rec is None or (rep.pid is not None
                                and int(port_rec.get("pid", -1)) != rep.pid):
            return False
        try:
            sock = socket.create_connection(
                ("127.0.0.1", int(port_rec["port"])), timeout=5.0)
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        except OSError:
            return False
        with self._lock:
            if rep.state != "starting":
                try:
                    sock.close()
                except OSError:
                    pass
                return False
            with rep.wlock:
                rep.sock = sock
            rep.state = "up"
            rep.last_seen = time.monotonic()
            _g_up(rep.index).set(1)
            self._cond.notify_all()
        t = threading.Thread(target=self._reader_loop, args=(rep, sock),
                             daemon=True,
                             name=f"mx-router-read-{rep.index}")
        t.start()
        _tel.instant("router.replica_up", "router", replica=rep.index,
                     pid=rep.pid, adopted=rep.adopted)
        return True

    def _reader_loop(self, rep, sock):
        try:
            with sock.makefile("r", encoding="utf-8") as rfile:
                for line in rfile:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        msg = json.loads(line)
                    except ValueError:
                        continue
                    typ = msg.get("type")
                    load = msg.get("load")
                    with self._lock:
                        rep.last_seen = time.monotonic()
                        if isinstance(load, (list, tuple)) \
                                and len(load) == 3:
                            rep.load = tuple(int(v) for v in load)
                            _g_load(rep.index).set(rep.load[0]
                                                   + rep.load[1])
                        if typ == "hello":
                            rep.slots = msg.get("slots")
                    if typ == "ack":
                        self._on_ack(rep, msg)
        except OSError:
            pass
        # EOF: the replica died or was restarted under us
        if rep.sock is sock:
            self._on_replica_down(rep, "eof")

    # -- failure handling ---------------------------------------------------

    def _on_replica_down(self, rep, why):
        """Mark a replica dead and transparently resubmit its in-flight
        requests to survivors (exactly-once: a request whose hedge twin
        is still running is left alone; retries re-enter at the FRONT of
        the queue so recovered work jumps fresh arrivals)."""
        with self._lock:
            if rep.state in ("down",):
                return
            planned = rep.state == "stopping"
            rep.state = "down"
            with rep.wlock:
                sock, rep.sock = rep.sock, None
            _g_up(rep.index).set(0)
            if not planned:
                _M_DEATHS.inc()
                rep.next_respawn_t = time.monotonic() \
                    + self._backoff.backoff_delay(rep.respawns - 1)
            else:
                # planned shutdown (drain/stop): the monitor must NOT
                # auto-respawn — drain(restart=True) spawns explicitly,
                # drain(restart=False) means out-of-service on purpose
                rep.next_respawn_t = float("inf")
            inflight = list(rep.inflight.items())
            rep.inflight.clear()
            for rid, req in inflight:
                req.dispatches.discard(rep.index)
                if req.done.is_set():
                    continue
                if req.dispatches:
                    continue              # hedge twin still running
                if req.retries < self._max_retries:
                    req.retries += 1
                    _M_RETRIES.inc()
                    _ttrace.async_event("retry", "router.request", "n",
                                        rid, dead_replica=rep.index)
                    self._queue.insert(0, req)
                else:
                    self._finish_req(req, error=ReplicaDeadError(
                        f"request {rid}: every dispatch died "
                        f"({req.retries} retries spent, "
                        "MXNET_ROUTER_MAX_RETRIES)"))
            _G_QUEUE.set(len(self._queue))
            self._journal_dirty = True
            self._cond.notify_all()
            _tel.instant("router.replica_down", "router",
                         replica=rep.index, why=why, planned=planned,
                         resubmitted=len(inflight))
        if sock is not None:
            try:
                sock.close()
            except OSError:
                pass

    # -- dispatch -----------------------------------------------------------

    def _affinity_key(self, prompt):
        """Prompt-prefix hash for affinity dispatch (first
        MXNET_ROUTER_AFFINITY_TOKENS tokens; None = hint disabled).  A
        hash collision costs at worst one sub-optimal pick."""
        if self._affinity_tokens <= 0 or not prompt:
            return None
        return hash(tuple(prompt[:self._affinity_tokens]))

    def _pick_replica(self, req=None):
        """Least-loaded up replica (lock held), or None.  Ties break on
        a ROTATING index (still deterministic): a fixed lowest-index
        tie-break sends every 4th request of a striped workload to the
        same replica.  PREFIX AFFINITY overrides the rotation (never
        the load ranking): among equally-loaded replicas, the one that
        last served this prompt-prefix hash wins, so a shared-system-
        prompt stream actually hits the per-replica paged-KV prefix
        cache instead of striping across the tier; a dead or busier
        remembered replica falls back to the plain tie-break."""
        live = [r for r in self._replicas if r.state == "up"]
        if not live:
            return None
        rr = self._rr
        self._rr += 1
        best = min(live, key=lambda r: (r.load_key(),
                                        (r.index - rr) % self._n))
        key = None if req is None else req.affinity
        if key is not None:
            want = self._affinity.get(key)
            if want is not None and want != best.index:
                cand = self._replicas[want]
                if cand.state == "up" \
                        and cand.load_key() == best.load_key():
                    best = cand
            self._affinity[key] = best.index
            self._affinity.move_to_end(key)
            while len(self._affinity) > AFFINITY_MAP:
                self._affinity.popitem(last=False)
        return best

    def _record_dispatch(self, req, rep, kind):
        """Record one dispatch (journal-first) and return its wire
        message.  Recording happens under the lock BEFORE any send so a
        send-failure path (replica down) already sees the request
        in-flight and resubmits it; the write-ahead journal is flushed
        first so no request is ever on the wire without being
        recoverable.  Returns None when the request resolved meanwhile,
        False when the replica stopped being dispatchable between pick
        and record (the caller requeues — recording into a replica
        whose down-handler already ran would strand the request in a
        dead inflight map until the result deadline)."""
        remaining = req.remaining_s()
        with self._lock:
            if req.done.is_set():
                return None
            if rep.state != "up":
                return False
            if self._journal_dirty:
                self._save_state("running")
            rep.inflight[req.rid] = req
            req.dispatches.add(rep.index)
            req.last_dispatch_t = time.monotonic()
        _M_DISPATCHED.inc()
        _ttrace.async_event(kind, "router.request", "n", req.rid,
                            replica=rep.index)
        # the router-death crash window: the request is journaled and
        # recorded in-flight, the send has not happened
        if _chaos._ACTIVE:
            _chaos.hit("router.dispatch", rid=req.rid, replica=rep.index)
        return {"rid": req.rid, "prompt": req.prompt,
                "max_new_tokens": req.max_new_tokens,
                "deadline_s": remaining}

    def _requeue_front(self, req):
        with self._lock:
            if not req.done.is_set():
                self._queue.insert(0, req)
                _G_QUEUE.set(len(self._queue))
                self._cond.notify_all()

    def _dispatch_one(self, req, rep, kind, requeue_on_stale=True):
        msg = self._record_dispatch(req, rep, kind)
        if msg is False:
            if requeue_on_stale:
                self._requeue_front(req)
            else:
                # stale hedge target: the primary dispatch still runs —
                # just let a later scan pick a live twin
                with self._lock:
                    req.hedged = False
        elif msg is not None:
            self._send_to(rep, dict(msg, op="submit"))

    def _dispatch_loop(self):
        while True:
            groups = {}          # replica -> [wire msg] (one send each:
            #                      a burst costs the replica ONE json
            #                      parse + ONE accepted ack, keeping the
            #                      reader off the scheduler's GIL)
            with self._lock:
                while not self._queue and not self._stopping:
                    self._cond.wait(self._poll_s)
                if self._stopping:
                    return
                batch, self._queue = self._queue, []
                _G_QUEUE.set(0)
            stalled = []
            for i, req in enumerate(batch):
                if req.done.is_set():
                    continue
                remaining = req.remaining_s()
                if remaining is not None and remaining <= 0:
                    with self._lock:
                        self._finish_req(
                            req, error=RequestDeadlineExceeded(
                                f"request {req.rid} blew its "
                                f"{req.deadline_s:g}s deadline before "
                                "dispatch"))
                    continue
                with self._lock:
                    rep = self._pick_replica(req)
                if rep is None:
                    stalled = batch[i:]
                    break
                msg = self._record_dispatch(req, rep, "dispatched")
                if msg is False:
                    self._requeue_front(req)
                elif msg is not None:
                    groups.setdefault(rep, []).append(msg)
            for rep, msgs in groups.items():
                if len(msgs) == 1:
                    self._send_to(rep, dict(msgs[0], op="submit"))
                else:
                    self._send_to(rep, {"op": "submit_batch",
                                        "reqs": msgs})
            if stalled:
                # no replica up (all dead/respawning): park and wait
                with self._lock:
                    self._queue = stalled + self._queue
                    _G_QUEUE.set(len(self._queue))
                    self._cond.wait(self._poll_s)

    # -- monitor ------------------------------------------------------------

    def _check_heartbeats(self, now_mono):
        """SIGKILL replicas whose heartbeat file went stale (a wedged
        replica holds its in-flight requests hostage; the socket stays
        open so EOF alone cannot catch it)."""
        if self._hang_s <= 0:
            return
        beats = _hb.read_all(self._hb_dir())
        now_wall = time.time()
        for rep in self._replicas:
            if rep.state not in ("up",):
                continue
            hb = beats.get(rep.index)
            last_wall = hb.get("time", rep.spawn_t) if hb else rep.spawn_t
            fresh_sock = now_mono - rep.last_seen <= self._hang_s
            if now_wall - last_wall > self._hang_s and not fresh_sock:
                _tel.instant("router.replica_hang", "router",
                             replica=rep.index,
                             age_s=round(now_wall - last_wall, 3))
                if rep.pid:
                    try:
                        os.kill(rep.pid, signal.SIGKILL)
                    except OSError:
                        pass
                self._on_replica_down(rep, "hang")

    def _monitor_loop(self):
        while True:
            with self._lock:
                if self._stopping:
                    return
                reps = list(self._replicas)
                dirty = self._journal_dirty
                if dirty:
                    self._save_state("running")
            now = time.monotonic()
            for rep in reps:
                state = rep.state
                if state in ("up", "starting", "draining", "stopping") \
                        and rep.proc is not None:
                    if rep.proc.poll() is not None:
                        self._on_replica_down(rep, "exit")
                        continue
                elif state in ("up", "starting", "draining") \
                        and rep.adopted:
                    if not (_pid_alive(rep.pid)
                            and _pid_matches(rep.pid, self._workdir)):
                        self._on_replica_down(rep, "adopted-exit")
                        continue
                if state == "starting":
                    if not self._connect_replica(rep) \
                            and time.time() - rep.spawn_t \
                            > self._spawn_timeout_s:
                        if rep.pid:
                            try:
                                os.kill(rep.pid, signal.SIGKILL)
                            except OSError:
                                pass
                        self._on_replica_down(rep, "spawn-timeout")
                elif state == "up" and now - rep.last_ping > self._ping_s:
                    rep.last_ping = now
                    self._send_to(rep, {"op": "ping"})
            self._check_heartbeats(now)
            self._respawn_dead(now)
            if self._hedge_s > 0:
                self._hedge_scan(now)
            self._sweep_queued_deadlines()
            time.sleep(self._poll_s)

    def _respawn_dead(self, now_mono):
        with self._lock:
            if self._stopping:
                return
            for rep in self._replicas:
                if rep.state != "down":
                    continue
                if rep.respawns >= self._max_respawns:
                    continue              # budget spent: permanently down
                if now_mono < rep.next_respawn_t:
                    continue
                rep.respawns += 1
                _M_RESPAWNS.inc()
                self._spawn_replica(rep)
                self._save_state("running")
            if all(r.state == "down"
                   and r.respawns >= self._max_respawns
                   for r in self._replicas):
                # the whole tier is permanently dead: outstanding
                # requests must fail NOW, not sit out their result
                # deadlines waiting for replicas that will never return
                dead = list(self._requests.values())
                self._queue.clear()
                for req in dead:
                    self._finish_req(req, error=ReplicaDeadError(
                        f"request {req.rid}: every replica is down with "
                        "the respawn budget (MXNET_ROUTER_MAX_RESPAWNS) "
                        "spent"))
                if dead:
                    _G_QUEUE.set(0)

    def _hedge_scan(self, now_mono):
        """Duplicate straggling single-dispatch requests to a second
        replica (first completion wins; the loser gets a cancel)."""
        todo = []
        with self._lock:
            for rep in self._replicas:
                if rep.state != "up":
                    continue
                for req in list(rep.inflight.values()):
                    if req.hedged or req.done.is_set() \
                            or len(req.dispatches) != 1 \
                            or req.last_dispatch_t is None \
                            or now_mono - req.last_dispatch_t \
                            < self._hedge_s:
                        continue
                    others = [r for r in self._replicas
                              if r.state == "up" and r is not rep]
                    if not others:
                        continue
                    req.hedged = True
                    _M_HEDGES.inc()
                    todo.append((req, min(others, key=_Replica.load_key)))
        for req, rep in todo:
            _ttrace.async_event("hedge", "router.request", "n", req.rid,
                                replica=rep.index)
            self._dispatch_one(req, rep, "hedge_dispatch",
                               requeue_on_stale=False)

    def _sweep_queued_deadlines(self):
        """Fail queued requests whose deadline lapsed while every
        replica was down — the dispatcher only checks at pop time."""
        with self._lock:
            expired = [r for r in self._queue
                       if (rem := r.remaining_s()) is not None
                       and rem <= 0]
            for req in expired:
                self._queue.remove(req)
                self._finish_req(req, error=RequestDeadlineExceeded(
                    f"request {req.rid} blew its {req.deadline_s:g}s "
                    "deadline waiting for a replica"))
            if expired:
                _G_QUEUE.set(len(self._queue))

    # -- drain (rolling restart) --------------------------------------------

    def drain(self, index, restart=True, timeout_s=60.0):
        """Gracefully drain one replica: stop dispatching to it, let its
        in-flight requests finish, shut it down cleanly, and (by
        default) respawn it — the rolling-restart primitive.  Returns
        True when the drain completed inside ``timeout_s``."""
        rep = self._replicas[int(index)]
        with self._lock:
            if rep.state != "up":
                raise MXNetError(
                    f"replica {index} is {rep.state}, not up")
            rep.state = "draining"
            pid0 = rep.pid
        _tel.instant("router.drain", "router", replica=rep.index,
                     restart=restart)
        deadline = time.monotonic() + timeout_s
        clean = True
        while True:
            with self._lock:
                idle = not rep.inflight
            if idle:
                break
            if time.monotonic() > deadline:
                clean = False
                break
            time.sleep(self._poll_s)
        with self._lock:
            if rep.state != "draining" or rep.pid != pid0:
                # the replica CRASHED mid-drain and its in-flight work
                # was already resubmitted; killing rep.pid now could hit
                # a fresh replacement — the restart goal is moot
                return False
            rep.state = "stopping"
            proc0 = rep.proc
        self._send_to(rep, {"op": "shutdown"})
        t0 = time.monotonic()
        while proc0 is not None and proc0.poll() is None \
                and time.monotonic() - t0 < self._grace_s:
            time.sleep(self._poll_s)
        if pid0 and (proc0 is None or proc0.poll() is None):
            try:
                os.kill(pid0, signal.SIGKILL)
            except OSError:
                pass
        self._on_replica_down(rep, "drain")
        if restart:
            with self._lock:
                if rep.state == "down":
                    # a planned rolling restart is free: it neither
                    # burns the respawn budget nor waits crash backoff
                    _M_RESPAWNS.inc()
                    rep.next_respawn_t = 0.0
                    self._spawn_replica(rep)
                    self._save_state("running")
        return clean

    # -- shutdown -----------------------------------------------------------

    def stop(self, shutdown_replicas=True):
        """Stop the tier.  Pending handles fail promptly (never hang on
        a loop that is gone); replicas get a clean shutdown, then
        SIGKILL after the grace period."""
        with self._lock:
            if self._stopping:
                return
            self._stopping = True
            pending = list(self._requests.values())
            self._queue.clear()
            for req in pending:
                self._finish_req(req, error=ServingError(
                    f"request {req.rid} abandoned: router stopped"))
            self._save_state("stopped")
            self._cond.notify_all()
            reps = list(self._replicas)
        for t in self._threads:
            t.join(timeout=5)
        if shutdown_replicas:
            for rep in reps:
                if rep.state in ("up", "draining"):
                    self._send_to(rep, {"op": "shutdown"})
            deadline = time.monotonic() + self._grace_s
            for rep in reps:
                while rep.proc is not None and rep.proc.poll() is None \
                        and time.monotonic() < deadline:
                    time.sleep(0.02)
                if rep.pid and (rep.proc.poll() is None
                                if rep.proc is not None
                                else _pid_alive(rep.pid)
                                and _pid_matches(rep.pid, self._workdir)):
                    try:
                        os.kill(rep.pid, signal.SIGKILL)
                    except OSError:
                        pass
                if rep.proc is not None:
                    try:
                        rep.proc.wait(timeout=5)
                    except Exception:  # noqa: BLE001 — reap best-effort
                        pass
        for rep in reps:
            with rep.wlock:
                sock, rep.sock = rep.sock, None
            if sock is not None:
                try:
                    sock.close()
                except OSError:
                    pass

    def wait_up(self, count=None, timeout_s=60.0):
        """Block until ``count`` replicas (default: all) are connected —
        what benchmarks and tie-break-sensitive callers use so dispatch
        starts against the whole tier, not whichever replica compiled
        first.  Returns the up-count reached."""
        want = self._n if count is None else int(count)
        deadline = time.monotonic() + float(timeout_s)
        while True:
            with self._lock:
                up = sum(1 for r in self._replicas if r.state == "up")
            if up >= want or time.monotonic() > deadline:
                return up
            time.sleep(self._poll_s)

    # -- introspection ------------------------------------------------------

    def replica_status(self):
        """[{index, state, pid, load, respawns, inflight}] — the tier's
        health view."""
        with self._lock:
            return [{"index": r.index, "state": r.state, "pid": r.pid,
                     "load": list(r.load), "respawns": r.respawns,
                     "adopted": r.adopted,
                     "inflight": len(r.inflight)}
                    for r in self._replicas]
