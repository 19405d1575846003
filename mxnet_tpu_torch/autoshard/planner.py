"""The analytic layout planner — the port of
``mxnet_tpu/autoshard/planner.py``.

Given a model's named parameter tree, a global batch and a per-device
memory budget, the planner enumerates candidate layouts —

    mesh shapes  ×  rule packs  ×  microbatch counts  ×  remat policy

— scores each with ``costmodel.estimate_memory`` (does it fit the
budget?) and an analytic roofline step-time model (which fitter is
fastest?), and emits a :class:`Plan` that ``parallel.TrainStep(plan=)``
consumes.  The search, the ranking and the ``plan.json`` format are the
reference's: the same inputs give the same plan, and on the CPU a
byte-identical ``plan.json``, so a plan file written by either package
loads in the other.

Layout vocabulary (one candidate = one point in this grid):

- **mesh shape** — every factorization of ``n_devices`` over the axes
  (dp, fsdp, tp, sp).  ``sp`` candidates require a known ``seq``
  divisible by the axis; the batch must divide by ``dp*fsdp``
  (per-microbatch, so ``batch % (n_micro * dp * fsdp) == 0``).
- **rule pack** — chosen by the axes present: no model-parallel axis ⇒
  replicated (None), tp/sp only ⇒ the family's megatron pack
  (``llama``...), any fsdp ⇒ the family's ZeRO-3 pack
  (``llama_fsdp``..., which also carries the tp dims).
- **data_spec** — dim0 over ``('dp', 'fsdp')`` (whichever present),
  dim1 (tokens) over ``sp`` when the mesh carries it.
- **n_micro** — 1, 2, 4, ... up to MXNET_AUTOSHARD_MAX_MICRO.
- **remat** — tried last, so a remat'd candidate wins only when nothing
  else fits.

"Fastest among fitters": fitters order by the crossover doctrine first
— no remat before remat, fewer model-parallel ways before more, fewer
microbatches before more — and the analytic step-time model decides
within a class: per-device flops at 6·P·tokens (plus the remat recompute
third and the microbatch weight re-reads), memory traffic from the
estimate's live set, collective bytes from ring-allreduce /
gather-scatter formulas, against ``costmodel.peak_flops()`` (of the
parameters' dtype: the card's bf16 peak for a bf16 model) /
``peak_hbm_bytes_per_s()``.  The hardware terms come from the cost
model's device table: a split dimension below ``costmodel.matmul_tile()``
(the TPU's 128 MXU lanes in the reference; the card's GEMM tile here)
pays proportionally, and collectives move at
``costmodel.link_bytes_per_s()`` (the reference's memory rate / 10 on
the CPU; the card's link a direction, a datasheet figure, on the card).
The model ranks layouts; it does not promise wall-clock.
"""

from __future__ import annotations

import json

from ..base import MXNetError
from .. import config as _config
from .. import telemetry as _tel
from ..telemetry import costmodel as _cm
from ..telemetry import tracer as _ttrace

__all__ = ["Plan", "plan", "enumerate_candidates", "load_plan",
           "infer_family", "zoo_shapes", "PLAN_VERSION"]

PLAN_VERSION = 1

_M_CANDIDATES = _tel.counter(
    "mxnet_autoshard_candidates_total",
    "Layout candidates the planner enumerated and scored.")
_M_FITS = _tel.counter(
    "mxnet_autoshard_fits_total",
    "Candidates whose estimated per-device HBM fit the budget.")
_M_PLANS = _tel.counter(
    "mxnet_autoshard_plans_total",
    "Plans emitted (one per successful plan() call).")
_M_NO_FIT = _tel.counter(
    "mxnet_autoshard_no_fit_total",
    "plan() calls where NO candidate fit the budget.")

# axis enumeration order == mesh axis order convention (outermost dp,
# ICI-local model axes inner) — the scaling-playbook order DeviceMesh
# documents
_AXES = ("dp", "fsdp", "tp", "sp")

_FAMILIES = ("llama", "bert", "transformer")

# family fingerprints over param names (most specific first): llama's
# gate/up pair, the MT transformer's fused self/cross projections,
# BERT's fused qkv
_FAMILY_PAT = (
    ("llama", ("gate_weight", "q_weight")),
    ("transformer", ("self_qkv_weight", "cross_kv_weight")),
    ("bert", ("attn_qkv_weight", "ffn1_weight")),
)


def infer_family(names):
    """'llama' | 'bert' | 'transformer' | None from param names."""
    names = list(names)
    for fam, pats in _FAMILY_PAT:
        if all(any(n.endswith(p) for n in names) for p in pats):
            return fam
    return None


def zoo_shapes(model, vocab=32000):
    """``(shapes, family)`` — the param-SHAPE table for a zoo config
    name, matching the real models' rule-relevant param naming, so
    layouts for e.g. ``llama3_8b`` plan without building any weights
    (a hand-rolled table could drift from the zoo's naming)."""
    from ..gluon.model_zoo.llama import LLAMA_CONFIGS
    if model in LLAMA_CONFIGS:
        L, U, H, A, KV = LLAMA_CONFIGS[model]
        hd = U // A
        shapes = {"model_tok_weight": (vocab, U)}
        for i in range(L):
            p = f"model_layer{i}_"
            shapes.update({
                p + "attn_norm_weight": (U,), p + "q_weight": (U, U),
                p + "k_weight": (hd * KV, U),
                p + "v_weight": (hd * KV, U),
                p + "o_weight": (U, U), p + "mlp_norm_weight": (U,),
                p + "gate_weight": (H, U), p + "up_weight": (H, U),
                p + "down_weight": (U, H),
            })
        shapes["model_final_norm_weight"] = (U,)
        shapes["model_lm_head_weight"] = (vocab, U)
        return shapes, "llama"
    from ..gluon.model_zoo.bert import BERT_CONFIGS
    if model in BERT_CONFIGS:
        L, U, H, _A = BERT_CONFIGS[model][:4]
        shapes = {"bert_word_weight": (vocab, U),
                  "bert_position_weight": (512, U)}
        for i in range(L):
            p = f"bert_layer{i}_"
            shapes.update({
                p + "attn_qkv_weight": (3 * U, U),
                p + "attn_qkv_bias": (3 * U,),
                p + "attn_proj_weight": (U, U),
                p + "ffn1_weight": (H, U), p + "ffn1_bias": (H,),
                p + "ffn2_weight": (U, H),
            })
        shapes["bert_decoder_weight"] = (vocab, U)
        return shapes, "bert"
    raise MXNetError(
        f"autoshard.zoo_shapes: unknown zoo model {model!r} (known: "
        "llama_*/bert_* configs)")


def _divisor_splits(n, k):
    """All k-tuples of positive ints whose product is n, sorted."""
    if k == 1:
        return [(n,)]
    out = []
    for d in range(1, n + 1):
        if n % d == 0:
            out.extend((d,) + rest for rest in _divisor_splits(n // d,
                                                              k - 1))
    return sorted(out)


def _pack_for(family, fsdp, tp, sp):
    """Rule-pack name for the model-parallel axes present (None =
    replicate)."""
    if family is None or (fsdp == 1 and tp == 1 and sp == 1):
        return None
    if fsdp > 1:
        return f"{family}_fsdp"
    return family


def _data_spec_for(dp, fsdp, sp):
    """dim0 over (dp, fsdp), dim1 (tokens) over sp when present."""
    batch_axes = tuple(a for a, s in (("dp", dp), ("fsdp", fsdp))
                       if s > 1)
    d0 = batch_axes if len(batch_axes) != 1 else batch_axes[0]
    if sp > 1:
        return (d0 if batch_axes else None, "sp")
    return (d0,) if batch_axes else ()


def _data_axes_for(dp, fsdp, sp):
    return tuple(a for a, s in (("dp", dp), ("fsdp", fsdp), ("sp", sp))
                 if s > 1)


def _matmul_param_elems(table):
    """Total elements of rank>=2 params (the flops carriers)."""
    return sum(_numel(shape) for shape, _i in table.values()
               if len(shape) >= 2)


def _numel(shape):
    n = 1
    for s in shape:
        n *= s
    return n


def _micro_ladder(max_micro):
    n, out = 1, []
    while n <= max_micro:
        out.append(n)
        n *= 2
    return out


def _matmul_efficiency(table, specs, axes, fsdp_drop):
    """Compute-efficiency factor in (0, 1] for a candidate layout: a
    model-parallel split that shrinks a matmul's per-device dim below
    the matmul tile (``costmodel.matmul_tile()``) pays proportionally
    (the classic reason fsdp outranks deep tp at moderate width —
    gather-on-use keeps FULL tiles, so fsdp axes don't count against the
    dims here)."""
    tile = _cm.matmul_tile()
    eff = 1.0
    for name, (shape, _i) in table.items():
        spec = specs.get(name, ())
        if len(shape) < 2:
            continue
        nofsdp = _cm._drop_axes(spec, fsdp_drop)
        for d, dim in enumerate(shape):
            div = 1
            if d < len(nofsdp):
                entry = nofsdp[d]
                entry = entry if isinstance(entry, (tuple, list)) \
                    else (entry,) if entry is not None else ()
                for a in entry:
                    div *= axes.get(a, 1)
            if div > 1 and dim % div == 0:
                sharded = dim // div
                full_eff = min(1.0, dim / tile)
                eff = min(eff, min(1.0, sharded / tile) / full_eff)
    return eff


def _matmul_dtype(table):
    """The dtype the matmuls run in: half where every rank>=2 parameter
    is 2 bytes wide (bf16/fp16), else f32 (its peak is the card's; the
    CPU's nominal peak is one figure for every dtype)."""
    sizes = {i for shape, i in table.values() if len(shape) >= 2}
    return "bfloat16" if sizes == {2} else "float32"


def _step_time_s(cand, est, matmul_elems, tokens, eff=1.0,
                 dtype="float32"):
    """Analytic per-step seconds for ranking (see module docstring)."""
    n_dev = cand["n_devices"]
    flops = 6.0 * matmul_elems * tokens
    if cand["remat"]:
        flops *= 4.0 / 3.0          # the recompute forward
    compute_s = (flops / n_dev) / _cm.peak_flops(dtype=dtype) \
        / max(eff, 1e-3)
    # HBM traffic per device: the live set streams ~once per step, and
    # every EXTRA microbatch re-reads the (sharded) weights
    traffic = est["total_bytes"] \
        + (cand["n_micro"] - 1) * est["params_bytes"]
    hbm_s = traffic / _cm.peak_hbm_bytes_per_s()
    link = _cm.link_bytes_per_s()
    comm = 0.0
    dp, fsdp, tp = cand["mesh"].get("dp", 1), cand["mesh"].get("fsdp", 1), \
        cand["mesh"].get("tp", 1)
    if dp > 1:
        # ring allreduce of the (model-sharded) gradients over dp
        comm += 2.0 * est["params_bytes"] * (dp - 1) / dp
    if fsdp > 1:
        # per-microbatch collectives: forward all-gather + backward
        # re-gather + gradient reduce-scatter, each moving the FULL
        # gathered weight bytes regardless of how much of them coexists
        # in memory (fsdp_gather_bytes is the residency-clamped PEAK
        # quantity — wrong for comm accounting)
        comm += 3.0 * est["fsdp_gathered_bytes"] * cand["n_micro"] \
            * (fsdp - 1) / fsdp
    if tp > 1:
        # per-layer activation collectives ~ one live activation set
        comm += 2.0 * est["activation_bytes"] * (tp - 1) / tp
    return max(compute_s, hbm_s) + comm / link


def enumerate_candidates(model_cfg, n_devices, global_batch, seq=None,
                         family=None, optimizer="adam",
                         multi_precision=False, max_micro=None,
                         allow_remat=True):
    """Score every candidate layout; returns the sorted candidate list
    (best first) WITHOUT committing to a plan.  Each candidate dict
    carries mesh/pack/data_spec/n_micro/remat, the full memory estimate,
    and the analytic step-time score."""
    table = _cm._param_table(model_cfg)
    names = list(table)
    if family is None:
        family = infer_family(names)
    if family is not None and family not in _FAMILIES:
        raise MXNetError(
            f"autoshard: unknown model family {family!r}; options "
            f"{_FAMILIES} (or None for replicated-only planning)")
    if max_micro is None:
        max_micro = max(1, _config.get_int("MXNET_AUTOSHARD_MAX_MICRO", 8))
    tokens = int(global_batch) * int(seq or 1)
    matmul_elems = _matmul_param_elems(table)
    dtype = _matmul_dtype(table)

    from .. import sharding as _sh
    _spec_cache = {}

    def _specs_for(pack):
        if pack not in _spec_cache:
            if pack is None:
                _spec_cache[pack] = {n: () for n in table}
            else:
                _spec_cache[pack] = _sh.match_partition_rules(
                    _sh.rule_pack(pack),
                    {n: s for n, (s, _i) in table.items()})
        return _spec_cache[pack]

    cands = []
    for dp, fsdp, tp, sp in _divisor_splits(int(n_devices), len(_AXES)):
        if sp > 1 and (seq is None or seq % sp):
            continue        # sp shards the token dim; needs a known seq
        pack = _pack_for(family, fsdp, tp, sp)
        if pack is None and (fsdp > 1 or tp > 1 or sp > 1):
            continue        # no family: model-parallel axes undrivable
        for n_micro in _micro_ladder(max_micro):
            if int(global_batch) % (n_micro * dp * fsdp):
                continue    # each microbatch must shard the batch dim
            for remat in ((False, True) if allow_remat else (False,)):
                mesh = {a: s for a, s in zip(_AXES, (dp, fsdp, tp, sp))
                        if s > 1}
                mesh.setdefault("dp", dp)
                cand = {
                    "mesh": mesh,
                    "n_devices": int(n_devices),
                    "rule_pack": pack,
                    "data_spec": _data_spec_for(dp, fsdp, sp),
                    "n_micro": n_micro,
                    "remat": remat,
                }
                est = _cm.estimate_memory(
                    model_cfg, mesh, pack, batch=global_batch, seq=seq,
                    optimizer=optimizer, multi_precision=multi_precision,
                    data_axes=_data_axes_for(dp, fsdp, sp),
                    n_micro=n_micro, remat=remat)
                eff = _matmul_efficiency(table, _specs_for(pack), mesh,
                                         frozenset(("fsdp",)))
                cand["estimate"] = est
                cand["matmul_eff"] = round(eff, 4)
                cand["step_time_s"] = _step_time_s(
                    cand, est, matmul_elems, tokens, eff=eff, dtype=dtype)
                cands.append(cand)
    if _ttrace._ENABLED:
        _M_CANDIDATES.inc(len(cands))
    # deterministic total order — the crossover DOCTRINE, not raw model
    # seconds: collective latency per layer is exactly what a
    # hardware-free byte model cannot see, so layouts rank first by how
    # little model parallelism they spend (no remat before remat, fewer
    # model-parallel ways, fewer microbatches — dp-only stays fastest
    # until memory forces the crossover), and the analytic step time
    # decides WITHIN a class (fsdp vs tp vs sp at the same ways, mesh
    # splits of the same axes), with the mesh shape as the final total
    # tie-break.
    def _order(c):
        m = c["mesh"]
        mp_ways = m.get("fsdp", 1) * m.get("tp", 1) * m.get("sp", 1)
        return (c["remat"], mp_ways, c["n_micro"],
                round(c["step_time_s"], 12), sorted(m.items()))
    cands.sort(key=_order)
    return cands, family


class Plan:
    """One chosen layout: everything ``parallel.TrainStep`` needs.

    ``TrainStep(net, loss_fn, opt, plan=plan)`` builds the mesh from
    ``mesh_axes``/``mesh_sizes``, resolves ``rule_pack`` through
    ``sharding.rule_pack``, and takes ``data_spec``/``n_micro``/``remat``
    as its defaults.  ``save()``/``load_plan()`` round-trip the
    deterministic ``plan.json`` artifact (sorted keys, no timestamps —
    the same inputs produce byte-identical files)."""

    def __init__(self, mesh_axes, mesh_sizes, rule_pack, data_spec,
                 n_micro, remat, estimate, step_time_s, inputs,
                 search=None):
        self.mesh_axes = tuple(mesh_axes)
        self.mesh_sizes = tuple(int(s) for s in mesh_sizes)
        self.rule_pack = rule_pack
        self.data_spec = _untuple_spec(data_spec)
        self.n_micro = int(n_micro)
        self.remat = bool(remat)
        self.estimate = dict(estimate)
        self.step_time_s = float(step_time_s)
        self.inputs = dict(inputs)
        self.search = dict(search or {})

    # -- TrainStep consumption ----------------------------------------------
    def build_mesh(self, devices=None):
        """The plan's mesh over ``devices`` (default: every visible card,
        one shard each, as ``parallel.DeviceMesh``)."""
        from .. import parallel
        return parallel.DeviceMesh(shape=self.mesh_sizes,
                                   axis_names=self.mesh_axes,
                                   devices=devices)

    def rules(self):
        if self.rule_pack is None:
            return None
        from .. import sharding as _sh
        return _sh.rule_pack(self.rule_pack)

    @property
    def mesh_shape(self):
        return dict(zip(self.mesh_axes, self.mesh_sizes))

    # -- serialization -------------------------------------------------------
    def to_dict(self):
        return {
            "version": PLAN_VERSION,
            "mesh": {"axes": list(self.mesh_axes),
                     "shape": list(self.mesh_sizes)},
            "rule_pack": self.rule_pack,
            "data_spec": _spec_to_json(self.data_spec),
            "n_micro": self.n_micro,
            "remat": self.remat,
            "estimate": self.estimate,
            "step_time_s": round(self.step_time_s, 9),
            "inputs": self.inputs,
            "search": self.search,
        }

    def to_json(self):
        return json.dumps(self.to_dict(), indent=2, sort_keys=True) + "\n"

    def save(self, path):
        with open(path, "w") as f:
            f.write(self.to_json())
        return path

    @classmethod
    def from_dict(cls, d):
        if d.get("version") != PLAN_VERSION:
            raise MXNetError(
                f"plan.json version {d.get('version')!r} != "
                f"{PLAN_VERSION} (regenerate it with autoshard.plan)")
        return cls(d["mesh"]["axes"], d["mesh"]["shape"], d["rule_pack"],
                   _spec_from_json(d["data_spec"]), d["n_micro"],
                   d["remat"], d["estimate"], d["step_time_s"],
                   d.get("inputs", {}), d.get("search", {}))

    def __repr__(self):
        dims = "x".join(f"{a}{s}" for a, s in
                        zip(self.mesh_axes, self.mesh_sizes))
        return (f"Plan({dims}, pack={self.rule_pack}, "
                f"data_spec={self.data_spec}, n_micro={self.n_micro}, "
                f"remat={self.remat}, "
                f"est={self.estimate.get('total_bytes', 0) / 1e6:.1f}MB)")


def _untuple_spec(spec):
    if spec is None:
        return None
    return tuple(tuple(e) if isinstance(e, list) else e for e in spec)


def _spec_to_json(spec):
    if spec is None:
        return None
    return [list(e) if isinstance(e, tuple) else e for e in spec]


def _spec_from_json(spec):
    return None if spec is None else _untuple_spec(tuple(spec))


def load_plan(path):
    """Read a ``plan.json`` back into a :class:`Plan`."""
    with open(path) as f:
        return Plan.from_dict(json.load(f))


def plan(model_cfg, global_batch, n_devices=None, seq=None,
         hbm_budget_bytes=None, family=None, optimizer="adam",
         multi_precision=False, max_micro=None, allow_remat=True,
         keep_candidates=3, candidates=None):
    """Pick the fastest layout that fits ``hbm_budget_bytes`` per device.

    ``model_cfg`` is a Block (post-init), ParameterDict, or
    ``{name: shape}`` dict; ``hbm_budget_bytes`` None means the knob
    ``MXNET_AUTOSHARD_HBM_GB`` (0/unset ⇒ unbounded: the planner ranks
    purely on speed).  ``candidates`` reuses a scored
    ``(cands, family)`` pair from :func:`enumerate_candidates` — a
    caller that already swept the grid for display must not pay for,
    or double-count in telemetry, a second sweep.  Raises when NOTHING
    fits — with the best near-miss in the message.  Returns a :class:`Plan`.  ``n_devices`` defaults to the
    visible cards (1 on the host)."""
    if n_devices is None:
        import torch
        n_devices = torch.cuda.device_count() or 1
    if hbm_budget_bytes is None:
        gb = _config.get_float("MXNET_AUTOSHARD_HBM_GB", 0.0)
        hbm_budget_bytes = int(gb * 2 ** 30) if gb > 0 else None
    if candidates is not None:
        cands, family = candidates
    else:
        cands, family = enumerate_candidates(
            model_cfg, n_devices, global_batch, seq=seq, family=family,
            optimizer=optimizer, multi_precision=multi_precision,
            max_micro=max_micro, allow_remat=allow_remat)
    if not cands:
        raise MXNetError(
            f"autoshard: no layout candidates for n_devices={n_devices} "
            f"batch={global_batch} (batch must divide by dp*fsdp*n_micro)")
    fits = [c for c in cands
            if hbm_budget_bytes is None
            or c["estimate"]["total_bytes"] <= hbm_budget_bytes]
    enabled = _ttrace._ENABLED
    if enabled:
        _M_FITS.inc(len(fits))
    if not fits:
        if enabled:
            _M_NO_FIT.inc()
        best = min(cands, key=lambda c: c["estimate"]["total_bytes"])
        raise MXNetError(
            f"autoshard: NO layout fits {hbm_budget_bytes} bytes/device "
            f"for batch {global_batch} on {n_devices} devices; closest "
            f"is {best['mesh']} n_micro={best['n_micro']} "
            f"remat={best['remat']} at "
            f"{best['estimate']['total_bytes']} bytes")
    chosen = fits[0]
    if enabled:
        _M_PLANS.inc()
    mesh = chosen["mesh"]
    axes = tuple(a for a in _AXES if a in mesh)
    runners = [{
        "mesh": c["mesh"], "rule_pack": c["rule_pack"],
        "n_micro": c["n_micro"], "remat": c["remat"],
        "total_bytes": c["estimate"]["total_bytes"],
        "step_time_s": round(c["step_time_s"], 9),
    } for c in fits[:keep_candidates]]
    return Plan(
        mesh_axes=axes,
        mesh_sizes=tuple(mesh[a] for a in axes),
        rule_pack=chosen["rule_pack"],
        data_spec=chosen["data_spec"],
        n_micro=chosen["n_micro"],
        remat=chosen["remat"],
        estimate=chosen["estimate"],
        step_time_s=chosen["step_time_s"],
        inputs={
            "n_devices": int(n_devices),
            "global_batch": int(global_batch),
            "seq": None if seq is None else int(seq),
            "hbm_budget_bytes": hbm_budget_bytes,
            "family": family,
            "optimizer": optimizer,
            "multi_precision": bool(multi_precision),
        },
        search={
            "considered": len(cands),
            "fitting": len(fits),
            "top": runners,
        })
