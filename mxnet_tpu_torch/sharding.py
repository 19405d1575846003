"""Declarative partition rules over named parameter trees — the port of
``mxnet_tpu/sharding.py``.

Models declare a layout: an ordered list of ``(regex, spec)`` rules over
their Gluon parameter names, each spec a mesh axis (or tuple of axes, or
None) per dimension.  ``match_partition_rules`` maps a net to specs (first
``re.search`` match wins, scalars never split, unmatched parameters
replicate or raise); ``apply_rules`` stores them as ``Parameter.sharding``;
``resolve_spec`` turns a spec into the port's ``parallel.Placement`` on a
mesh, dropping axes the mesh lacks and dimensions their axes do not
divide, so one rule set runs on any mesh.  The zoo packs (``llama_rules``,
``bert_rules``, ``transformer_rules`` and their ``*_fsdp`` ZeRO-3 forms)
are the reference's, name for name.

Consumers: ``parallel.TrainStep(partition_rules=...)`` places each
parameter (and its optimizer state) by its resolved Placement, storing a
split parameter as one tensor per slice (``gluon.Parameter``);
``gluon.Trainer`` skips the local reduction of parameters flagged
``mesh_reduced``; ``checkpoint`` gathers split parameters on save and
scatters them on restore.  The counters are the reference's:
``mxnet_sharding_resolved_params_total`` and ``..._fallback_...`` count
each placement resolved while telemetry is on,
``..._skipped_allreduce_total`` the Trainer's skips.
"""

from __future__ import annotations

import re

from .base import MXNetError
from . import telemetry as _tel
from .telemetry import tracer as _ttrace

__all__ = ["LOGICAL_AXES", "match_partition_rules", "apply_rules",
           "resolve_spec", "rule_pack", "llama_rules", "bert_rules",
           "transformer_rules", "llama_fsdp_rules", "bert_fsdp_rules",
           "transformer_fsdp_rules", "DEFAULT_TAIL", "FSDP_TAIL",
           "mark_mesh_reduced"]

# The logical-axis vocabulary rules may name.  Convention (the scaling
# playbook): outermost axis = data parallel (DCN-friendly), inner axes =
# tensor/sequence parallel (ICI-local).
LOGICAL_AXES = {
    "dp": "data parallel — batch dim; grads psum over it",
    "tp": "tensor (megatron) parallel — matmul in/out-feature dims",
    "sp": "sequence/context parallel — the sequence dim of activations",
    "pp": "pipeline parallel — layer/stage dim (pipeline.gpipe)",
    "ep": "expert parallel — the expert dim of MoE stacks",
    "mp": "generic model parallel — coarse table splits (examples)",
    "fsdp": "fully-sharded data parallel — param shards gathered at use",
}

_M_RESOLVED = _tel.counter(
    "mxnet_sharding_resolved_params_total",
    "Params whose partition rule resolved to a sharded NamedSharding.")
_M_FALLBACK = _tel.counter(
    "mxnet_sharding_fallback_params_total",
    "Params that fell back to replication (no rule matched, mesh lacked "
    "the axis, or a dim was not divisible by its mesh axes).")
_M_SKIPPED_ALLREDUCE = _tel.counter(
    "mxnet_sharding_skipped_allreduce_total",
    "Params gluon.Trainer skipped in the kvstore allreduce because the "
    "mesh computation already reduced their gradients (mesh_reduced).")


def _axes_of(entry):
    """The axis names inside one PartitionSpec entry (str | tuple | None)."""
    if entry is None:
        return ()
    if isinstance(entry, (tuple, list)):
        return tuple(entry)
    return (entry,)


def _check_rules(rules):
    """Compile patterns and validate specs against LOGICAL_AXES once."""
    compiled = []
    for i, (pattern, spec) in enumerate(rules):
        try:
            pat = re.compile(pattern)
        except re.error as exc:
            raise MXNetError(
                f"partition rule {i} has an invalid regex "
                f"{pattern!r}: {exc}") from exc
        spec = tuple(spec)
        for entry in spec:
            for axis in _axes_of(entry):
                if axis not in LOGICAL_AXES:
                    raise MXNetError(
                        f"partition rule {pattern!r} names unknown logical "
                        f"axis {axis!r}; vocabulary: "
                        f"{sorted(LOGICAL_AXES)}")
        compiled.append((pat, spec))
    return compiled


def _named_leaves(params):
    """name -> shape-bearing leaf, from a net, ParameterDict, or dict."""
    if hasattr(params, "collect_params"):
        params = params.collect_params()
    if hasattr(params, "items"):
        return dict(params.items())
    raise MXNetError(
        "match_partition_rules wants a Block, ParameterDict, or "
        f"name->param dict; got {type(params).__name__}")


def _shape_of(name, leaf):
    if isinstance(leaf, (tuple, list)):
        return tuple(leaf)
    shape = getattr(leaf, "shape", None)
    if shape is None:
        raise MXNetError(
            f"param {name!r} has no resolved shape (deferred init?) — run "
            "a forward pass before matching partition rules")
    return tuple(shape)


def match_partition_rules(rules, params, on_unmatched="replicate"):
    """Map a named param tree to partition specs, first match wins.

    ``rules`` is an ordered list of ``(regex, spec)`` where ``spec`` is a
    per-dim tuple of logical axis names (or ``None``, or a tuple of axes
    for a dim sharded over several).  ``params`` is a Block,
    ParameterDict, or ``name -> leaf`` dict (leaves need ``.shape``; a
    plain shape tuple also works).  Returns ``{name: spec}``.

    Semantics (the fmengine recipe):
     - scalar leaves (ndim 0 or one element) are never partitioned;
     - the FIRST rule whose regex ``re.search``-matches the name wins;
     - a matched spec longer than the leaf's rank is a layout bug and
       raises;
     - unmatched params replicate (``spec ()``, bit-identical to the
       dense run) — or raise when ``on_unmatched='error'``.
    """
    if on_unmatched not in ("replicate", "error"):
        raise MXNetError(
            f"on_unmatched must be 'replicate' or 'error', "
            f"got {on_unmatched!r}")
    compiled = _check_rules(rules)
    out = {}
    unmatched = []
    for name, leaf in _named_leaves(params).items():
        shape = _shape_of(name, leaf)
        size = 1
        for s in shape:
            size *= s
        if len(shape) == 0 or size == 1:
            out[name] = ()          # never partition scalars
            continue
        for pat, spec in compiled:
            if pat.search(name) is not None:
                if len(spec) > len(shape):
                    raise MXNetError(
                        f"partition rule {pat.pattern!r} has spec {spec} "
                        f"of rank {len(spec)} but param {name!r} has "
                        f"shape {shape}")
                out[name] = spec
                break
        else:
            unmatched.append(name)
            out[name] = ()
    if unmatched and on_unmatched == "error":
        raise MXNetError(
            f"no partition rule matched params {sorted(unmatched)} "
            "(on_unmatched='error')")
    return out


def resolve_spec(spec, mesh, shape=None):
    """Logical spec -> the ``parallel.Placement`` it takes on ``mesh``.

    Degradation (counted in ``mxnet_sharding_fallback_params_total``):
    axes the mesh doesn't carry drop to unsharded, and — when ``shape``
    is given — a dim not divisible by the product of its mesh axis sizes
    drops to unsharded, so the same rule set runs bit-identically on
    meshes too small (or shapes too ragged) to shard.  Returns the
    placement and whether anything actually sharded.
    """
    resolved = []
    for d, entry in enumerate(tuple(spec or ())):
        axes = tuple(a for a in _axes_of(entry) if a in mesh.axis_names)
        if axes and shape is not None:
            n = 1
            for a in axes:
                n *= mesh.axis_size(a)
            if shape[d] % n != 0:
                axes = ()       # indivisible dim: degrade to unsharded
        if not axes:
            resolved.append(None)
        elif len(axes) == 1:
            resolved.append(axes[0])
        else:
            resolved.append(axes)
    sharded = any(a is not None for a in resolved)
    if _ttrace._ENABLED:
        (_M_RESOLVED if sharded else _M_FALLBACK).inc()
    if not sharded:
        return mesh.replicated(), False
    return mesh.sharded(*resolved), True


def apply_rules(net_or_params, rules, on_unmatched="replicate",
                mesh_reduced=None):
    """Match ``rules`` and store each spec as ``Parameter.sharding``.

    The hints are consumed by ``parallel.TrainStep`` (and anything else
    reading ``Parameter.sharding``); empty specs clear the hint.  When
    ``mesh_reduced`` is not None every parameter's ``mesh_reduced`` flag
    is set to it (see :func:`mark_mesh_reduced`).  Returns the
    ``{name: spec}`` mapping.
    """
    leaves = _named_leaves(net_or_params)
    specs = match_partition_rules(rules, leaves, on_unmatched=on_unmatched)
    for name, p in leaves.items():
        p.sharding = specs[name] or None
        if mesh_reduced is not None:
            p.mesh_reduced = bool(mesh_reduced)
    return specs


def mark_mesh_reduced(net_or_params, value=True):
    """Flag params whose gradients a mesh computation already reduces.

    A step over a mesh (``parallel.TrainStep``) comes back with
    gradients already summed over the data shards.  A local/device
    kvstore reduction over the same devices would double-count, so
    ``gluon.Trainer`` skips flagged params in its allreduce (non-dist
    stores only; cross-process reduction is still the dist store's job).
    Gate: ``MXNET_SHARDING_SKIP_ALLREDUCE``.
    """
    for _, p in _named_leaves(net_or_params).items():
        p.mesh_reduced = bool(value)


# --------------------------------------------------------------------------
# rule packs for the zoo (megatron layouts over Gluon's flat param names)
# --------------------------------------------------------------------------

def DEFAULT_TAIL(tp="tp"):
    """Embedding / layernorm / bias defaults shared by the packs.

    Vocab-dim sharding for embedding tables (column-parallel output
    embeddings), replication for norm scales and biases — append AFTER
    model-specific rules so first-match-wins keeps the specific layout.
    """
    return [
        (r"(tok|word|embed)[a-z0-9]*_weight$", (tp, None)),
        (r"(gamma|beta)$", ()),
        (r"norm_weight$", ()),
        (r"_bias$", ()),
    ]


def llama_rules(tp="tp"):
    """Megatron TP layout for the llama GQA decoder (model_zoo.llama).

    Column-parallel (out-features): q/k/v, gate, up, lm_head; GQA k/v
    shard their ``hd * kv_heads`` dim the same way.  Row-parallel
    (in-features): o_proj, down.  ``tok_weight`` must precede the
    ``k_weight$`` search (first-match-wins is the guard: 'tok_weight'
    ends with 'k_weight' too), which DEFAULT_TAIL's embedding rule and
    its position here make explicit.
    """
    return [
        (r"tok_weight$", (tp, None)),
        (r"(q|k|v|gate|up|lm_head)_weight$", (tp, None)),
        (r"(o|down)_weight$", (None, tp)),
    ] + DEFAULT_TAIL(tp)


def bert_rules(tp="tp"):
    """Megatron TP layout for the BERT encoder (model_zoo.bert):
    qkv + ffn1 column-parallel, attn proj + ffn2 row-parallel,
    word/decoder tables vocab-sharded, everything else replicated."""
    return [
        (r"(attn_qkv|ffn1)_weight$", (tp, None)),
        (r"(attn_proj|ffn2)_weight$", (None, tp)),
        (r"decoder_weight$", (tp, None)),
        (r"position_weight$", ()),
    ] + DEFAULT_TAIL(tp)


def transformer_rules(tp="tp"):
    """Megatron TP layout for the MT transformer (model_zoo.transformer):
    fused self/cross qkv + ffn1 column-parallel, output projections +
    ffn2 row-parallel, embeddings vocab-sharded via the tail."""
    return [
        (r"(attn_qkv|self_qkv|cross_q|cross_kv|ffn1)_weight$", (tp, None)),
        (r"(attn_proj|self_proj|cross_proj|ffn2)_weight$", (None, tp)),
    ] + DEFAULT_TAIL(tp)


# --------------------------------------------------------------------------
# fsdp (ZeRO-3) rule packs
# --------------------------------------------------------------------------
#
# fsdp shards PARAMETERS along the data axis (ZeRO-3): every matmul
# weight stores only 1/|fsdp| of its elements per shard and each data
# shard gathers it right before use (autograd sums the gradient back into
# each slice), so weight + adam-state memory divides by the fsdp axis
# size while the math stays the dense math.  Optimizer state rides the
# owner param's layout exactly as with tp (TrainStep places it with its
# slice), so m/v shard for free.  Composition contract with tp on the SAME mesh: the tp axis
# keeps the megatron dim it owns and fsdp takes the OTHER matmul dim —
# one rule set covers dp-only, +fsdp, and +tp+fsdp meshes because
# resolve_spec degrades any axis the mesh doesn't carry.
#
# Norm scales and biases stay replicated (FSDP_TAIL): they are O(d) while
# the win is the O(d^2) matmuls, and sharding them would make every
# norm a gather for bytes that round to zero.

def FSDP_TAIL(fsdp="fsdp", tp="tp"):
    """Embedding / norm / bias tail for the fsdp packs: embedding tables
    shard vocab over tp AND fsdp (both dims huge), norms/biases
    replicate."""
    return [
        (r"(tok|word|embed)[a-z0-9]*_weight$", ((tp, fsdp), None)),
        (r"(gamma|beta)$", ()),
        (r"norm_weight$", ()),
        (r"_bias$", ()),
    ]


def llama_fsdp_rules(fsdp="fsdp", tp="tp"):
    """ZeRO-3 layout for the llama GQA decoder, composable with tp.

    Column-parallel weights (out, in) keep tp on dim0 and shard dim1
    over fsdp; row-parallel (o/down) the mirror.  On a mesh without tp
    the specs degrade to pure fsdp sharding; without fsdp they degrade
    to llama_rules' tp layout; with neither, full replication — the
    one-rule-set-per-model contract."""
    return [
        (r"tok_weight$", ((tp, fsdp), None)),
        (r"(q|k|v|gate|up|lm_head)_weight$", (tp, fsdp)),
        (r"(o|down)_weight$", (fsdp, tp)),
    ] + FSDP_TAIL(fsdp, tp)


def bert_fsdp_rules(fsdp="fsdp", tp="tp"):
    """ZeRO-3 layout for the BERT encoder (bert_rules + fsdp on the
    non-tp matmul dim)."""
    return [
        (r"(attn_qkv|ffn1)_weight$", (tp, fsdp)),
        (r"(attn_proj|ffn2)_weight$", (fsdp, tp)),
        (r"decoder_weight$", (tp, fsdp)),
        (r"position_weight$", ()),
    ] + FSDP_TAIL(fsdp, tp)


def transformer_fsdp_rules(fsdp="fsdp", tp="tp"):
    """ZeRO-3 layout for the MT transformer (transformer_rules + fsdp
    on the non-tp matmul dim)."""
    return [
        (r"(attn_qkv|self_qkv|cross_q|cross_kv|ffn1)_weight$",
         (tp, fsdp)),
        (r"(attn_proj|self_proj|cross_proj|ffn2)_weight$", (fsdp, tp)),
    ] + FSDP_TAIL(fsdp, tp)


_RULE_PACKS = {
    "llama": llama_rules,
    "bert": bert_rules,
    "transformer": transformer_rules,
}

_FSDP_PACKS = {
    "llama_fsdp": llama_fsdp_rules,
    "bert_fsdp": bert_fsdp_rules,
    "transformer_fsdp": transformer_fsdp_rules,
}


def rule_pack(name, tp="tp", fsdp="fsdp"):
    """A named zoo rule pack: ``rule_pack('llama')``,
    ``rule_pack('llama_fsdp')`` etc."""
    if name in _RULE_PACKS:
        return _RULE_PACKS[name](tp=tp)
    if name in _FSDP_PACKS:
        return _FSDP_PACKS[name](fsdp=fsdp, tp=tp)
    raise MXNetError(
        f"unknown rule pack {name!r}; options "
        f"{sorted(_RULE_PACKS) + sorted(_FSDP_PACKS)}")
