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
:func:`matmul_tile` and :func:`link_bytes_per_s` are the auto-sharder's
hardware terms (``autoshard.planner``): the matmul tile width below which
a split dimension wastes the card's tiles, and the card-to-card link's
bytes a second in one direction.  On the CPU they are the reference's
(128 lanes, the memory rate over 10), so a plan made on the CPU is the
reference's byte for byte.

:func:`estimate_memory` is the reference's analytic per-device memory of
one training step under a rule pack and mesh, term for term.
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
    "matmul_tile", "link_bytes_per_s",
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
# the planner's terms: the matmul tile width, and the link's bytes/s a
# direction from NVIDIA's datasheets (NVLink 4 on the SXM card, PCIe 5 x16
# on the PCIe card).  The tile: chip_smoke.py's "shard" phase times one
# bf16 GEMM (8192 x 4096) @ (4096 x d); on an H100 80GB HBM3 at 700 W its
# efficiency against the bf16 peak was 0.079, 0.155, 0.301, 0.535, 0.719
# at d = 32, 64, 128, 256, 512: proportional to d up to 256, then rising
# more slowly, so a split below 256 wastes the card's tiles
_CPU_TILE = 128
_CPU_LINK_FRACTION = 10.0
_CUDA_TILE = 256
_CUDA_LINKS = (
    ("H100 PCIe", 64e9),
    ("H100 80GB HBM3", 450e9),
    ("H100 SXM", 450e9),
)

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


def matmul_tile():
    """The width of the card's matmul tile (the planner's efficiency
    term); the reference's 128 lanes on the CPU."""
    return _CPU_TILE if _device_kind()[1] else _CUDA_TILE


def link_bytes_per_s():
    """Bytes/s a direction of the link between two cards (the planner's
    collective term); the memory rate over 10 on the CPU, as the
    reference's interconnect term."""
    if _device_kind()[1]:
        return peak_hbm_bytes_per_s() / _CPU_LINK_FRACTION
    kind, _ = _device_kind()
    for sub, rate in _CUDA_LINKS:
        if sub in kind:
            return rate
    raise MXNetError(f"costmodel: no link figure for the card {kind!r}")


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


# -- fits-per-shape: analytic per-device memory ---------------------------

def _mesh_axis_sizes(mesh_shape):
    """{'dp': 2, 'tp': 2, ...} from a dict, a DeviceMesh, or a
    (shape, axis_names) pair."""
    if hasattr(mesh_shape, "axis_names"):      # parallel.DeviceMesh
        return dict(zip(tuple(mesh_shape.axis_names),
                        tuple(mesh_shape.shape)))
    if isinstance(mesh_shape, dict):
        return {str(k): int(v) for k, v in mesh_shape.items()}
    shape, names = mesh_shape
    return dict(zip(names, (int(s) for s in shape)))


def _sharded_numel(shape, spec, axes):
    """Element count of one param's per-device shard under ``spec`` —
    resolve_spec's exact degradation semantics (missing axes drop out,
    indivisible dims stay whole)."""
    n = 1
    spec = tuple(spec or ())
    for d, dim in enumerate(shape):
        div = 1
        if d < len(spec):
            entry = spec[d]
            entry = entry if isinstance(entry, (tuple, list)) \
                else (entry,) if entry is not None else ()
            for a in entry:
                div *= axes.get(a, 1)
        n *= dim // div if (div > 1 and dim % div == 0) else dim
    return n


def _param_table(model_cfg):
    """{name: (shape, itemsize)} from a Block, ParameterDict, or dict of
    shapes/arrays."""
    import numpy as _np
    if hasattr(model_cfg, "collect_params"):
        model_cfg = model_cfg.collect_params()
    out = {}
    for name, leaf in dict(model_cfg.items()).items():
        shape = tuple(leaf) if isinstance(leaf, (tuple, list)) \
            else tuple(leaf.shape)
        dt = getattr(leaf, "dtype", None)
        size = getattr(dt, "itemsize", None)    # a torch dtype has one
        out[name] = (shape, 4 if dt is None else
                     size if isinstance(size, int) else _np.dtype(dt).itemsize)
    return out


_EMBED_PAT = ("tok_", "word_", "embed", "position_")


def _drop_axes(spec, drop):
    """``spec`` with every axis in ``drop`` removed (per-dim entries keep
    their remaining axes)."""
    out = []
    for entry in tuple(spec or ()):
        entry = entry if isinstance(entry, (tuple, list)) \
            else (entry,) if entry is not None else ()
        kept = tuple(a for a in entry if a not in drop)
        out.append(kept if len(kept) > 1 else (kept[0] if kept else None))
    return tuple(out)


def _state_itemsize(itemsize, multi_precision):
    """Bytes of one optimizer-state element (Adam's m or v, momentum):
    on a card the port's multi-precision optimizers keep it in f32 beside
    the f32 master; on the host the reference's term, the weight's own
    width, so that the host's estimates and plans are the reference's."""
    if multi_precision and itemsize < 4 and not _device_kind()[1]:
        return 4
    return itemsize


def estimate_memory(model_cfg, mesh_shape, rule_pack, batch, seq=None,
                    optimizer="adam", multi_precision=False,
                    data_axes=("dp", "sp"), vocab=None,
                    n_micro=1, remat=False, fsdp_axes=("fsdp",)):
    """Analytic per-device HBM (bytes) for ONE fused training step.

    Parameters
    ----------
    model_cfg : a gluon Block (post-init), ParameterDict, or
        ``{name: shape|array}`` dict — the named param tree the rule pack
        matches against.
    mesh_shape : ``{'dp': 2, 'tp': 2, 'sp': 2}``, a DeviceMesh, or a
        ``(shape, axis_names)`` pair.
    rule_pack : pack name (``'llama'``/``'llama_fsdp'``/``'bert'``/...),
        an ordered ``(regex, spec)`` rule list, or None (fully
        replicated).
    batch : GLOBAL batch size (samples).
    seq : tokens per sample (token models; None => 1, feature models).
    optimizer : 'adam' (m+v state) or 'sgd' (momentum assumed on).
    multi_precision : half-precision weights keep fp32 masters (and,
        on a card, fp32 optimizer state: ``_state_itemsize``).
    data_axes : mesh axes the token batch shards over (data_spec) —
        include the fsdp axis for ZeRO-3 layouts (the batch rides it).
    vocab : LM-head width for the logits term; inferred from the widest
        embedding-named param when None.
    n_micro : gradient-accumulation microbatches per step (TrainStep
        ``n_micro``): live activations/logits divide by it, but a full
        gradient ACCUMULATOR joins the working set (and under fsdp the
        per-microbatch gradients live gathered inside the scan before
        their reduce-scatter — both measured on the llama lane).
    remat : TrainStep ``remat`` — saved activations halve (checkpointed
        segment stores inputs; backward recomputes with roughly half the
        residual set live); the planner treats remat as the last lever.
    fsdp_axes : axes with gather-on-use semantics (params sharded along
        them are all-gathered right before each matmul).

    Returns a breakdown dict whose ``total_bytes`` is the estimated
    steady-state peak for a donated step: live arguments (params +
    optimizer state + batch) plus the backward working set (gradients +
    saved activations + the fp32 logits head + the fsdp gather
    working set).  On the host the terms are the reference's, byte for
    byte (its calibration was against its own compiler's peaks); on a
    card multi-precision state counts in f32, as the port keeps it
    (``_state_itemsize``); ``chip_smoke.py``'s
    "shard" phase prints the estimate beside each shard's measured
    parameter and state bytes and the card's peak.
    """
    axes = _mesh_axis_sizes(mesh_shape)
    table = _param_table(model_cfg)
    if rule_pack is None:
        specs = {name: () for name in table}
    else:
        from .. import sharding as _sh
        rules = _sh.rule_pack(rule_pack) if isinstance(rule_pack, str) \
            else rule_pack
        specs = _sh.match_partition_rules(
            rules, {n: shape for n, (shape, _i) in table.items()})

    if optimizer == "adam":
        n_state = 2
    elif optimizer in ("sgd", "sgd_mom"):
        n_state = 1
    else:
        raise ValueError(f"estimate_memory: unknown optimizer "
                         f"{optimizer!r} (adam|sgd)")
    n_micro = max(1, int(n_micro))

    tokens = int(batch) * int(seq or 1)
    data_div = 1
    for a in data_axes:
        data_div *= axes.get(a, 1)
    tokens_dev = max(1, tokens // data_div)
    # only one microbatch's activations are live at a time
    tokens_act = max(1, tokens_dev // n_micro)

    params_b = state_b = 0
    act_elems = 0.0
    gathered_b = 0          # full-along-fsdp bytes of gather-on-use params
    inferred_vocab = 0
    seen_inputs = set()
    fsdp_drop = frozenset(fsdp_axes)
    for name, (shape, itemsize) in table.items():
        spec = specs.get(name, ())
        numel = _sharded_numel(shape, spec, axes)
        params_b += numel * itemsize
        state_b += numel * _state_itemsize(itemsize, multi_precision) \
            * n_state
        if multi_precision and itemsize < 4:
            state_b += numel * 4
        nofsdp_spec = _drop_axes(spec, fsdp_drop)
        gathered = _sharded_numel(shape, nofsdp_spec, axes)
        if gathered != numel:
            # actually fsdp-sharded (divisible, axis present): the
            # all-gather before use materializes the full-along-fsdp
            # weight (still divided by any tp axes it carries)
            gathered_b += gathered * itemsize
        is_embed = any(p in name for p in _EMBED_PAT)
        if is_embed and len(shape) == 2:
            inferred_vocab = max(inferred_vocab, shape[0])
        if len(shape) == 2 and not is_embed:
            # every matmul's backward saves its input activation
            # (tokens × in_features, sharded when the weight is
            # row-parallel) and hands a same-shaped output cotangent
            # through (tokens × out_features, sharded when
            # column-parallel): count the saved input plus the layer
            # output that the residual stream keeps live.  Matmuls in
            # one layer reading the SAME activation (q/k/v, gate/up)
            # save it ONCE — dedup by (layer prefix, sharded width).
            # Activation widths use the NON-fsdp sharding: the matmul
            # runs on the gathered weight, so activations shard only
            # over tp-style axes.
            out_f = _sharded_numel((shape[0],), nofsdp_spec[:1], axes)
            in_f = _sharded_numel((shape[1],), nofsdp_spec[1:2], axes) \
                if len(nofsdp_spec) > 1 else shape[1]
            layer_key = name.rsplit("_", 2)[0]
            if (layer_key, in_f) not in seen_inputs:
                seen_inputs.add((layer_key, in_f))
                act_elems += tokens_act * in_f
            act_elems += tokens_act * out_f

    # fp32 logits head: softmax_cross_entropy upcasts and saves both the
    # logits and their softmax for backward
    v = int(vocab) if vocab else inferred_vocab
    logits_b = 2 * tokens_act * v * 4 if v else 0
    # gradients live as temps through backward + the fused update; a
    # microbatched step additionally carries the accumulator, and under
    # fsdp the in-scan per-microbatch gradients are FULL along fsdp
    # until their reduce-scatter (measured: llama dp×fsdp micro lane)
    grads_b = params_b
    if n_micro > 1:
        grads_b += gathered_b if gathered_b else params_b
    acts_b = int(act_elems) * 4     # residuals saved in compute precision
    if remat:
        acts_b //= 2
    # gather-on-use working set: roughly half the gathered weight bytes
    # live at the peak while the scheduler can overlap gathers with
    # frees (measured 195.4KB vs 197.6KB predicted on the llama
    # dp2×fsdp4 lane) — but once the live ACTIVATION set outgrows that
    # half, XLA holds the full gathered set (measured crossover on the
    # batch-32 dp4×fsdp2 lane: half-model 14% under, full-model 3%
    # over).  Inside a microbatch scan gathers can't overlap frees
    # across the scan boundary at all, so the full set always counts
    # there (fsdp micro2 lane: within 1.5% with this, 17% under
    # without).
    if n_micro > 1:
        gather_b = gathered_b
    else:
        gather_b = min(gathered_b, max(gathered_b // 2, acts_b))
    batch_b = 2 * tokens_dev * 4    # data + label, int32 tokens
    total = (params_b + state_b + grads_b + batch_b + acts_b + logits_b
             + gather_b)
    return {
        "params_bytes": int(params_b),
        "opt_state_bytes": int(state_b),
        "grads_bytes": int(grads_b),
        "batch_bytes": int(batch_b),
        "activation_bytes": int(acts_b),
        "logits_bytes": int(logits_b),
        "fsdp_gather_bytes": int(gather_b),
        # the UN-clamped full-along-fsdp weight bytes: what one step's
        # all-gathers actually move per microbatch (the residency-
        # clamped fsdp_gather_bytes above is a PEAK-MEMORY quantity and
        # must not be used for communication accounting)
        "fsdp_gathered_bytes": int(gathered_b),
        "total_bytes": int(total),
        "tokens_per_device": tokens_dev,
        "n_micro": n_micro,
        "remat": bool(remat),
        "mesh": dict(axes),
    }
