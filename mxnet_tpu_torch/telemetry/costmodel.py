"""The cost ledger — the port's counterpart of
``mxnet_tpu/telemetry/costmodel.py``.

The reference asks XLA for each executable's cost (``cost_analysis``:
flops and bytes accessed; ``memory_analysis``: peak bytes).  The port has
no compiler to ask, so it counts the work of one eager call instead:

- **FLOPs**: ``torch.utils.flop_counter.FlopCounterMode`` (matmuls,
  convolutions and attention at 2 FLOPs a multiply-add; elementwise work
  is not counted, as XLA's HLO cost model leaves it small).  The flash
  kernels launch through ``ctypes`` and are invisible to it, so while a
  call is analysed their wrappers route through two ``torch.library``
  custom ops (``<package>::flash_fwd`` and ``flash_bwd``, defined in
  ``kernels/flash_attention.py``) whose FLOP formulas are registered with
  ``register_flop_formula`` (:func:`flash_flops`): the forward is
  4·B·H·Lq·Lk·D, halved when causal with Lq = Lk, and the backward twice
  the forward (the algorithm's FLOPs; the recompute of P is not
  credited).  A custom op is one dispatch to a ``TorchDispatchMode``, so
  the count is the same whether the kernel or its plain twin ran and the
  twin's own matmuls are not counted on top.
- **Bytes accessed**: a ``TorchDispatchMode`` that adds up the tensor
  arguments and outputs of every aten op that is not a view (``view``,
  ``expand``, ``t``..., and ``_unsafe_view``, which aliases), the same
  unfused per-op sum as XLA's ``bytes accessed`` (a flash call moves q,
  k, v, o and lse forward, and q, k, v, o, lse, dO, dq, dk and dv
  backward, with the segment ids when there are any).
- **Peak bytes**: the rise of ``torch.cuda.max_memory_allocated`` over the
  analysed call (the peak statistics are reset for it); 0 on the CPU.
- **Compile seconds**: the seconds a ``TrainStep`` capture took; 0 for the
  eager entries.

What an entry stands for (the reference's executables):

- ``parallel.TrainStep``: each (data, label) signature, analysed on the
  eager warm-up step before its capture, never under capture and never on
  a replay;
- ``op:<name>``: each (op, shapes, dtypes, attributes) that
  ``ops.registry.invoke`` dispatches while the ledger is armed;
- ``optimizer_fusion.<kind>``: each parameter signature of the fused
  optimizer's ``update_multi``;
- ``serving.llama_prefill``, ``serving.llama_decode``,
  ``serving.llama_multi``, ``serving.llama_copy_block``,
  ``serving.tf_encode``, ``serving.tf_decode``: each input signature of
  the serving entries.

``calls(site)`` counts every armed call of a site, replays included.  A
site called inside another site's analysed call (an op dispatched by the
forward of an analysed step) makes no entry of its own there: its work is
in the outer entry.
Disarmed, a site costs one module-flag read.  The analysed call runs the
op-by-op Python dispatch of both modes and synchronises the card before
and after it; every later call of that signature runs as it would
unarmed.

:func:`roofline` and :func:`lane_summary` turn an entry and a measured
step time into analytic MFU and a roofline verdict against the card's
peaks (:func:`peak_flops`, :func:`peak_hbm_bytes_per_s`): NVIDIA's
datasheet figures for the H100 SXM and PCIe cards, the CPU's nominal
5e11 FLOP/s and 5e10 B/s, ``MXNET_PEAK_FLOPS`` / ``MXNET_PEAK_HBM_GBS``
over either.  The f32 peak is the card's own (TF32 is off in the port),
not a fraction of the bf16 one.  An unknown CUDA card raises.
:func:`estimate_memory` needs the sharding rule packs and raises
(ROADMAP A.9).
"""

from __future__ import annotations

import threading
import time
import weakref

from .. import config
from ..base import MXNetError
from . import metrics as _metrics

__all__ = [
    "LEDGER", "CostLedger", "Site", "arm", "disarm", "armed", "wrap",
    "add_rearm_hook", "arm_from_env", "counting", "flash_flops",
    "measure", "signature", "peak_flops", "peak_hbm_bytes_per_s",
    "roofline", "lane_summary", "estimate_memory", "report_text",
    "summarize_entries", "site_table_lines",
]

_ARMED = False
_lock = threading.Lock()
_REARM_HOOKS: list = []
_TLS = threading.local()

# peak table: NVIDIA datasheet figures, device-name substring ->
# (bf16/fp16 dense FLOP/s, f32 FLOP/s, memory B/s); the CPU row is nominal
# so that roofline verdicts stay meaningful there (override with knobs)
_CPU_PEAK_FLOPS = 5e11
_CPU_PEAK_BYTES_PER_S = 5e10
_CUDA_PEAKS = (
    ("H100 PCIe", (756e12, 51.2e12, 2.0e12)),
    ("H100 80GB HBM3", (989.4e12, 66.9e12, 3.35e12)),
    ("H100 SXM", (989.4e12, 66.9e12, 3.35e12)),
)
_HALF = ("bfloat16", "bf16", "float16", "fp16", "half")

_M_EXECUTABLES = _metrics.counter(
    "mxnet_costmodel_executables_total",
    "Executables recorded into the cost ledger (one per (site, input "
    "signature) build while armed).")
_M_ANALYSIS_ERRORS = _metrics.counter(
    "mxnet_costmodel_analysis_errors_total",
    "Ledger AOT analyses that failed (entry records the error string).")
_M_COMPILE_SECONDS = _metrics.histogram(
    "mxnet_costmodel_compile_seconds",
    "Measured trace+lower+compile seconds per recorded executable.",
    buckets=(0.01, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0,
             60.0, 120.0, 300.0, 600.0))


def armed():
    """True while the ledger records (knob MXNET_COSTMODEL or arm())."""
    return _ARMED


def add_rearm_hook(fn):
    """Register a callback run on every arm()/disarm() that changes the
    state (for owners of caches built under one mode)."""
    with _lock:
        if fn not in _REARM_HOOKS:
            _REARM_HOOKS.append(fn)


def _run_rearm_hooks():
    with _lock:
        hooks = list(_REARM_HOOKS)
    for fn in hooks:
        try:
            fn()
        except Exception:  # noqa: BLE001 - a cache clear must not sink arming
            pass


def arm():
    """Start recording; returns the previous armed state."""
    global _ARMED
    prev, _ARMED = _ARMED, True
    if not prev:
        _run_rearm_hooks()
    return prev


def disarm():
    global _ARMED
    prev, _ARMED = _ARMED, False
    if prev:
        _run_rearm_hooks()
    return prev


def arm_from_env():
    if config.get_int("MXNET_COSTMODEL", 0):
        arm()


def counting():
    """True on a thread whose call is being analysed: the flash wrappers
    then go through their custom ops so the counters see them."""
    return getattr(_TLS, "active", False)


def flash_flops(q_shape, k_shape, causal=False, backward=False):
    """FLOPs of one flash attention call: 4·B·H·Lq·Lk·D forward (QK^T and
    PV), halved when causal with Lq = Lk; the backward twice that."""
    B, H, Lq, D = (int(d) for d in q_shape)
    Lk = int(k_shape[2])
    f = 4 * B * H * Lq * Lk * D
    if causal and Lq == Lk:
        f //= 2
    return 2 * f if backward else f


# -- counting one call ---------------------------------------------------------

def _tensors(obj, out):
    import torch
    if isinstance(obj, torch.Tensor):
        out.append(obj)
    elif isinstance(obj, (list, tuple)):
        for x in obj:
            _tensors(x, out)
    elif isinstance(obj, dict):
        for x in obj.values():
            _tensors(x, out)
    else:
        data = getattr(obj, "_data", None)
        if isinstance(data, torch.Tensor):
            out.append(data)
    return out


def _nbytes(obj):
    return sum(t.numel() * t.element_size() for t in _tensors(obj, []))


def _bytes_mode():
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode
    # views by behaviour whose schemas do not say so (matmul's reshape of
    # its output)
    aliasing = (torch.ops.aten._unsafe_view,)

    class _BytesMode(TorchDispatchMode):
        """Adds up each non-view aten op's tensor arguments and outputs."""

        def __init__(self):
            super().__init__()
            self.bytes = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            out = func(*args, **kwargs)
            if not (getattr(func, "is_view", False)
                    or getattr(func, "overloadpacket", None) in aliasing):
                self.bytes += _nbytes(args) + _nbytes(kwargs) + _nbytes(out)
            return out

    return _BytesMode()


def signature(obj):
    """A hashable description of a call's arguments: each tensor's shape,
    dtype and device type, the type of everything else."""
    import torch
    if isinstance(obj, torch.Tensor):
        return ("T", tuple(obj.shape), str(obj.dtype), obj.device.type)
    if type(obj) in (list, tuple):
        return (type(obj).__name__,) + tuple(signature(x) for x in obj)
    if type(obj) is dict:
        return tuple((k, signature(v)) for k, v in obj.items())
    data = getattr(obj, "_data", None)
    if isinstance(data, torch.Tensor):
        return signature(data)
    return type(obj).__name__


def measure(fn, *args, **kwargs):
    """Run ``fn(*args, **kwargs)`` once under the counters; returns
    ``(output, {"flops", "bytes_accessed", "peak_bytes"})``."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode
    dev = next((t.device for t in _tensors((args, kwargs), [])
                if t.is_cuda), None)
    base = 0
    if dev is not None:
        torch.cuda.synchronize(dev)
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    flop_mode = FlopCounterMode(display=False)
    bytes_mode = _bytes_mode()
    prev, _TLS.active = counting(), True
    try:
        with flop_mode, bytes_mode:
            out = fn(*args, **kwargs)
    finally:
        _TLS.active = prev
    peak = 0
    if dev is not None:
        torch.cuda.synchronize(dev)
        peak = max(0, torch.cuda.max_memory_allocated(dev) - base)
    return out, {"flops": float(flop_mode.get_total_flops()),
                 "bytes_accessed": float(bytes_mode.bytes),
                 "peak_bytes": int(peak)}


# -- the ledger ----------------------------------------------------------------

def _capturing():
    import torch
    return torch.cuda.is_initialized() and \
        torch.cuda.is_current_stream_capturing()


class CostLedger:
    """Thread-safe per-signature cost records and per-site call counts
    (each :class:`Site` bumps its own int; the ledger sums them on
    read)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._entries: list = []
        self._sites: list = []          # weakrefs to Site objects

    def _register(self, site):
        with self._lock:
            self._sites.append(weakref.ref(site))
            if len(self._sites) % 512 == 0:
                self._sites[:] = [r for r in self._sites if r() is not None]

    def _call_counts(self):
        with self._lock:
            refs = list(self._sites)
        out: dict = {}
        for r in refs:
            s = r()
            if s is not None and s._calls:
                out[s.site] = out.get(s.site, 0) + s._calls
        return out

    def record(self, site, stats=None, compile_s=0.0, error=None):
        """Append one entry (``stats`` from :func:`measure`)."""
        entry = {"site": site, "compile_s": float(compile_s),
                 "time": time.time()}
        if error is not None:
            entry["error"] = f"{type(error).__name__}: {error}"[:300]
            _M_ANALYSIS_ERRORS.inc()
        else:
            entry.update(stats)
        with self._lock:
            entry["index"] = sum(1 for e in self._entries
                                 if e["site"] == site)
            self._entries.append(entry)
        _M_EXECUTABLES.inc()
        if compile_s:
            _M_COMPILE_SECONDS.observe(compile_s)
        return entry

    def set_compile_seconds(self, entry, seconds):
        """The capture that followed an entry's analysis took
        ``seconds``."""
        with self._lock:
            entry["compile_s"] = float(seconds)
        _M_COMPILE_SECONDS.observe(seconds)

    def analyze(self, site, fn, args, kwargs=None, compile_s=0.0):
        """Run ``fn`` once under the counters and record its entry;
        returns ``(output, entry)``.  An error of the call is recorded as
        an ``error`` entry and raised."""
        t0 = time.perf_counter()
        try:
            out, stats = measure(fn, *args, **(kwargs or {}))
        except Exception as e:
            self.record(site, error=e)
            raise
        stats["analysis_s"] = round(time.perf_counter() - t0, 4)
        return out, self.record(site, stats, compile_s)

    # -- reading --------------------------------------------------------------

    def entries(self, site=None):
        with self._lock:
            ents = list(self._entries)
        if site is None:
            return ents
        return [e for e in ents if e["site"] == site]

    def calls(self, site):
        return self._call_counts().get(site, 0)

    def site_summary(self):
        """{site: {executables, calls, compile_s, flops, bytes_accessed,
        peak_bytes, errors}}, flops and bytes from each site's largest
        entry."""
        with self._lock:
            ents = list(self._entries)
        return summarize_entries(ents, self._call_counts())

    def snapshot(self):
        """JSON-serializable ledger state (the telemetry snapshot and
        /ledger.json)."""
        with self._lock:
            ents = [dict(e) for e in self._entries]
        return {"entries": ents, "calls": self._call_counts()}

    def clear(self):
        """Drop the entries and zero the call counts; each site analyses
        its next call of any signature again."""
        with self._lock:
            self._entries.clear()
            live = []
            for r in self._sites:
                s = r()
                if s is not None:
                    s._calls = 0
                    s._seen.clear()
                    live.append(r)
            self._sites[:] = live


def summarize_entries(entries, calls=None):
    """Per-site roll-up of raw ledger entry dicts."""
    calls = calls or {}
    out: dict = {}
    for e in entries:
        s = out.setdefault(e["site"], {
            "executables": 0, "calls": calls.get(e["site"], 0),
            "compile_s": 0.0, "flops": 0.0, "bytes_accessed": 0.0,
            "peak_bytes": 0, "errors": 0})
        s["executables"] += 1
        s["compile_s"] += e.get("compile_s", 0.0)
        if e.get("error"):
            s["errors"] += 1
            continue
        if (e.get("flops") or 0.0) >= s["flops"]:
            s["flops"] = e.get("flops") or 0.0
            s["bytes_accessed"] = e.get("bytes_accessed") or 0.0
        s["peak_bytes"] = max(s["peak_bytes"], e.get("peak_bytes", 0) or 0)
    return out


LEDGER = CostLedger()


class Site:
    """One instrumented call site: while armed, counts its calls and
    analyses the first call of each new signature (:meth:`call`)."""

    __slots__ = ("site", "_calls", "_seen", "__weakref__")

    def __init__(self, site):
        self.site = site
        self._calls = 0
        self._seen = set()
        LEDGER._register(self)

    def admit(self, key):
        """Count one armed call; True when it is to be analysed: its key
        is new and it runs neither inside another site's analysed call
        (whose entry holds its work) nor inside a CUDA graph capture
        (which may not synchronise); a later call records such a key."""
        self._calls += 1
        if key in self._seen or counting() or _capturing():
            return False
        self._seen.add(key)
        return True

    def call(self, fn, args, kwargs=None, key=None):
        """``fn(*args, **kwargs)``; armed, counted and, when
        :meth:`admit`, analysed (``key`` default: the arguments'
        :func:`signature`)."""
        kwargs = kwargs or {}
        if not _ARMED or not self.admit(
                signature((args, kwargs)) if key is None else key):
            return fn(*args, **kwargs)
        return LEDGER.analyze(self.site, fn, args, kwargs)[0]


class _Wrapped:
    __slots__ = ("_fn", "_site")

    def __init__(self, fn, site):
        self._fn, self._site = fn, Site(site)

    def __call__(self, *args, **kwargs):
        if not _ARMED:
            return self._fn(*args, **kwargs)
        return self._site.call(self._fn, args, kwargs)


def wrap(fn, site):
    """``fn`` as a :class:`Site` under ``site``: one flag read disarmed."""
    return _Wrapped(fn, site)


# -- analytic MFU + roofline -----------------------------------------------------

def _device_kind():
    import torch
    if not torch.cuda.is_available():
        return "", True
    return torch.cuda.get_device_name(0), False


def _cuda_peaks():
    kind, _ = _device_kind()
    for sub, peaks in _CUDA_PEAKS:
        if sub in kind:
            return peaks
    raise MXNetError(
        f"costmodel: no peak figures for the card {kind!r}; set "
        "MXNET_PEAK_FLOPS (FLOP/s) and MXNET_PEAK_HBM_GBS (GB/s)")


def peak_flops(dtype="bfloat16"):
    """Per-card peak FLOP/s for MFU: MXNET_PEAK_FLOPS wins; else the
    card's dense bf16/fp16 figure for half dtypes and its f32 figure for
    the others; the CPU's nominal 5e11."""
    v = config.get_float("MXNET_PEAK_FLOPS", 0.0)
    if v > 0:
        return v
    if _device_kind()[1]:
        return _CPU_PEAK_FLOPS
    half, f32, _bw = _cuda_peaks()
    return half if str(dtype).replace("torch.", "") in _HALF else f32


def peak_hbm_bytes_per_s():
    """Per-card memory bandwidth (B/s) for the roofline ridge:
    MXNET_PEAK_HBM_GBS (GB/s) wins; else the device table."""
    v = config.get_float("MXNET_PEAK_HBM_GBS", 0.0)
    if v > 0:
        return v * 1e9
    if _device_kind()[1]:
        return _CPU_PEAK_BYTES_PER_S
    return _cuda_peaks()[2]


def roofline(flops, bytes_accessed, seconds=None, dtype="bfloat16"):
    """The roofline read on one program: arithmetic intensity against the
    machine ridge, the MFU bound it implies, and (given a measured time)
    the analytic MFU achieved."""
    pf = peak_flops(dtype)
    pb = peak_hbm_bytes_per_s()
    ai = float(flops) / max(float(bytes_accessed), 1.0)
    ridge = pf / pb
    out = {
        "flops": float(flops),
        "bytes_accessed": float(bytes_accessed),
        "arithmetic_intensity": round(ai, 3),
        "ridge_flops_per_byte": round(ridge, 3),
        "verdict": "compute-bound" if ai >= ridge else "memory-bound",
        "roofline_mfu_bound": round(min(1.0, ai / ridge), 4),
        "peak_flops": pf,
        "peak_hbm_bytes_per_s": pb,
    }
    if seconds:
        out["analytic_mfu"] = round(float(flops) / (float(seconds) * pf), 4)
        out["flops_per_s"] = float(flops) / float(seconds)
    return out


def lane_summary(site="parallel.TrainStep", step_seconds=None,
                 dtype="bfloat16"):
    """The cost block of one lane: the site's largest entry rooflined
    against the card's peaks, with its peak bytes and the capture
    seconds.  ``step_seconds`` is the measured time of one step."""
    ents = [e for e in LEDGER.entries(site) if not e.get("error")]
    if not ents:
        return {"error": f"no cost-ledger entries for site {site!r} "
                         "(costmodel not armed?)"}
    e = max(ents, key=lambda x: x.get("flops") or 0.0)
    out = roofline(e.get("flops") or 0.0, e.get("bytes_accessed") or 0.0,
                   seconds=step_seconds, dtype=dtype)
    out["peak_hbm_bytes"] = e.get("peak_bytes", 0)
    out["compile_s"] = round(sum(x.get("compile_s", 0.0) for x in ents), 3)
    out["executables"] = len(ents)
    return out


def site_table_lines(summary):
    """Formatted per-site table rows from a :func:`summarize_entries`
    dict."""
    lines = [f"  {'site':<28} {'exec':>5} {'calls':>7} "
             f"{'compile_s':>10} {'gflops':>10} {'AI':>7} "
             f"{'peak_hbm_mb':>12} {'verdict':<14}"]
    for site in sorted(summary):
        s = summary[site]
        rl = roofline(s["flops"], s["bytes_accessed"])
        lines.append(
            f"  {site:<28} {s['executables']:>5} {s['calls']:>7} "
            f"{s['compile_s']:>10.3f} {s['flops'] / 1e9:>10.3f} "
            f"{rl['arithmetic_intensity']:>7.1f} "
            f"{s['peak_bytes'] / 1e6:>12.2f} {rl['verdict']:<14}")
        if s["errors"]:
            lines.append(f"    ({s['errors']} analysis error(s) — see "
                         "LEDGER.entries())")
    return lines


def report_text():
    """Human-readable per-site ledger table (telemetry.report(cost=True))."""
    summ = LEDGER.site_summary()
    lines = [f"cost ledger ({len(summ)} site(s), "
             f"{sum(s['executables'] for s in summ.values())} "
             f"executable(s)):"]
    if not summ:
        lines.append("  (empty — arm with MXNET_COSTMODEL=1 or "
                     "telemetry.costmodel.arm())")
        return "\n".join(lines)
    lines.extend(site_table_lines(summ))
    return "\n".join(lines)


def estimate_memory(*args, **kwargs):  # noqa: ARG001
    """The reference's fits-per-shape estimator reads the sharding rule
    packs, which are not ported (ROADMAP A.9)."""
    raise MXNetError("costmodel.estimate_memory needs the sharding rule "
                     "packs of sharding.py, which the port does not have "
                     "yet (ROADMAP A.9)")
