"""The auto-sharder (``autoshard``) and ``costmodel.estimate_memory``
against the reference, and ``TrainStep(plan=)`` training a small zoo
llama under the plan the reference's OOM-avoidance recipe picks.

On the host the planner's hardware terms are the reference's (a 128-wide
tile, the memory rate over 10 for links), so estimates are equal byte for
byte, ``plan.to_json()`` equal to the reference's, and a ``plan.json``
written by either package loads in the other.  The plan-driven step runs
on a mesh of 8 ``cpu(0)`` shards; its losses are held to the unsharded
step's 2e-4 relative (the reference's own bound for the same recipe,
``tests/test_autoshard.py``).
"""

import json

import numpy as np
import pytest
import torch

from mxnet_tpu import autoshard as jautoshard
from mxnet_tpu.telemetry import costmodel as jcm

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import autoshard, parallel
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.gluon.model_zoo import llama as tllama
from mxnet_tpu_torch.ops.nn import softmax_cross_entropy
from mxnet_tpu_torch.telemetry import costmodel as tcm


def _shapes(model="llama_small", vocab=64):
    got, fam = autoshard.zoo_shapes(model, vocab=vocab)
    want, jfam = jautoshard.zoo_shapes(model, vocab=vocab)
    assert got == want and fam == jfam
    return got


# the reference test's estimate cases, and the tp / sp / sgd corners
_EST_CASES = [
    ({"dp": 2, "fsdp": 4}, "llama_fsdp", dict(data_axes=("dp", "fsdp"))),
    ({"dp": 8}, None, dict(data_axes=("dp",))),
    ({"dp": 2, "fsdp": 4}, "llama_fsdp",
     dict(data_axes=("dp", "fsdp"), n_micro=2)),
    ({"dp": 8}, None, dict(data_axes=("dp",), remat=True)),
    ({"dp": 2, "tp": 2, "sp": 2}, "llama", dict()),
    ({"dp": 4, "tp": 2}, "llama", dict(optimizer="sgd",
                                       multi_precision=True)),
]


@pytest.mark.parametrize("mesh,pack,kw", _EST_CASES)
def test_estimate_memory_equals_reference(mesh, pack, kw):
    shapes = _shapes()
    assert tcm.estimate_memory(shapes, mesh, pack, batch=16, seq=16, **kw) \
        == jcm.estimate_memory(shapes, mesh, pack, batch=16, seq=16, **kw)


def test_estimate_memory_corners_equal_reference():
    cases = [(({"w_q_weight": (7, 5)}, {"fsdp": 4},
               [(r".*", ("fsdp", None))]), dict(batch=4, data_axes=())),
             ((_shapes("bert_3_128_2", 100), {"dp": 2, "tp": 2}, "bert"),
              dict(batch=8, seq=32)),
             ((_shapes("llama_tiny"), parallel.DeviceMesh(
                 (2, 4), ("dp", "tp"), devices=[mx.cpu(0)] * 8), "llama"),
              dict(batch=4, seq=8))]
    for (table, mesh, pack), kw in cases:
        jmesh = mesh if isinstance(mesh, dict) else \
            dict(zip(mesh.axis_names, mesh.shape))
        assert tcm.estimate_memory(table, mesh, pack, **kw) == \
            jcm.estimate_memory(table, jmesh, pack, **kw)
    with pytest.raises(ValueError, match="unknown optimizer"):
        tcm.estimate_memory({"w": (4, 4)}, {"dp": 1}, None, batch=1,
                            optimizer="lamb")


@pytest.mark.parametrize("kw", [
    dict(global_batch=16, n_devices=8, seq=16),
    dict(global_batch=16, n_devices=8, seq=16, hbm_budget_bytes=20 << 20),
    dict(global_batch=16, n_devices=8, seq=16, hbm_budget_bytes=60 << 20),
    dict(global_batch=4, n_devices=4, seq=6, max_micro=2),
])
def test_plan_json_equals_reference_and_files_cross(tmp_path, kw):
    shapes = _shapes()
    p = autoshard.plan(shapes, **kw)
    q = jautoshard.plan(shapes, **kw)
    assert p.to_json() == q.to_json()
    assert repr(p) == repr(q)
    p.save(tmp_path / "port.json")
    q.save(tmp_path / "ref.json")
    assert jautoshard.load_plan(tmp_path / "port.json").to_json() == \
        autoshard.load_plan(tmp_path / "ref.json").to_json() == p.to_json()
    cands, fam = autoshard.enumerate_candidates(shapes, kw["n_devices"],
                                                kw["global_batch"],
                                                seq=kw["seq"])
    jcands, jfam = jautoshard.enumerate_candidates(
        shapes, kw["n_devices"], kw["global_batch"], seq=kw["seq"])
    assert fam == jfam and [
        (c["mesh"], c["rule_pack"], c["n_micro"], c["remat"],
         c["step_time_s"]) for c in cands] == [
        (c["mesh"], c["rule_pack"], c["n_micro"], c["remat"],
         c["step_time_s"]) for c in jcands]


def test_plan_errors_and_families_match_reference(tmp_path):
    shapes = _shapes()
    for mod, err in ((autoshard, MXNetError),
                     (jautoshard, __import__("mxnet_tpu").base.MXNetError)):
        with pytest.raises(err, match="NO layout fits"):
            mod.plan(shapes, global_batch=16, n_devices=8, seq=16,
                     hbm_budget_bytes=1000)
    d = autoshard.plan(shapes, global_batch=16, n_devices=8).to_dict()
    d["version"] = 999
    (tmp_path / "bad.json").write_text(json.dumps(d))
    with pytest.raises(MXNetError, match="version"):
        autoshard.load_plan(tmp_path / "bad.json")
    for names in (shapes, ["b_attn_qkv_weight", "b_ffn1_weight"],
                  ["x_self_qkv_weight", "x_cross_kv_weight"], ["w", "b"]):
        assert autoshard.infer_family(names) == \
            jautoshard.infer_family(names)


def test_card_terms_come_from_the_device_table(monkeypatch):
    """On the card the tile and link terms are the table's (the H100
    SXM's NVLink 4 a direction, the PCIe card's PCIe 5 x16), not the
    reference's TPU terms; an unknown card raises."""
    for kind, link in (("NVIDIA H100 80GB HBM3", 450e9),
                       ("NVIDIA H100 PCIe", 64e9)):
        monkeypatch.setattr(tcm, "_device_kind", lambda k=kind: (k, False))
        assert tcm.link_bytes_per_s() == link
        assert tcm.matmul_tile() == tcm._CUDA_TILE
    monkeypatch.setattr(tcm, "_device_kind",
                        lambda: ("NVIDIA A100-SXM4-80GB", False))
    with pytest.raises(MXNetError, match="no link figure"):
        tcm.link_bytes_per_s()


def _bf16_shapes(model="llama_small", vocab=64):
    """The zoo shapes as bf16 tensors without storage."""
    return {k: torch.empty(v, dtype=torch.bfloat16, device="meta")
            for k, v in _shapes(model, vocab).items()}


def test_card_counts_multi_precision_state_in_f32(monkeypatch):
    """Multi-precision Adam keeps m and v in f32 beside the f32 master:
    on the card the estimate counts 3 f32 words a bf16 element (the
    reference's 2 bf16 + 1 f32 on the host, as the host must for its
    plans); without multi-precision the two agree."""
    shapes = _bf16_shapes()
    kw = dict(batch=16, seq=16, data_axes=("dp", "fsdp"))
    mesh = {"dp": 2, "fsdp": 4}
    host = tcm.estimate_memory(shapes, mesh, "llama_fsdp",
                               multi_precision=True, **kw)
    monkeypatch.setattr(tcm, "_device_kind",
                        lambda: ("NVIDIA H100 80GB HBM3", False))
    card = tcm.estimate_memory(shapes, mesh, "llama_fsdp",
                               multi_precision=True, **kw)
    params_elems = host["params_bytes"] // 2
    assert host["opt_state_bytes"] == params_elems * (2 * 2 + 4)
    assert card["opt_state_bytes"] == params_elems * (2 * 4 + 4)
    assert card["total_bytes"] - host["total_bytes"] == 4 * params_elems
    plain = tcm.estimate_memory(shapes, mesh, "llama_fsdp", **kw)
    assert plain["opt_state_bytes"] == params_elems * 2 * 2
    monkeypatch.undo()
    assert tcm.estimate_memory(shapes, mesh, "llama_fsdp", **kw) == plain


@pytest.mark.parametrize("half", [True, False])
def test_compute_term_takes_the_parameters_dtype(monkeypatch, half):
    """The planner's compute term divides by the peak of the dtype the
    matmuls run in: the card's bf16 peak for a bf16 model, f32 for an
    f32 one."""
    seen = set()
    peak = tcm.peak_flops

    def spy(dtype="bfloat16"):
        seen.add(dtype)
        return peak(dtype)
    monkeypatch.setattr(tcm, "peak_flops", spy)
    shapes = _bf16_shapes() if half else _shapes()
    cands = autoshard.enumerate_candidates(shapes, 8, 16, seq=16)
    assert cands and seen == {"bfloat16" if half else "float32"}


def _llama_loss(out, labels):
    return softmax_cross_entropy(out.reshape(-1, out.shape[-1]).float(),
                                 labels.reshape(-1)) / labels.numel()


def test_plan_trains_the_llama_it_was_made_for():
    """The reference's OOM-avoidance recipe: a budget of 0.4 x the dp-only
    estimate forces an fsdp layout; TrainStep(plan=) trains under it, the
    llama's matrices stored in slices, with the unsharded step's
    losses."""
    vocab, seq, batch = 64, 16, 16
    r = np.random.RandomState(23)
    toks = torch.tensor(r.randint(0, vocab, (batch, seq)), dtype=torch.int32)
    labs = torch.roll(toks, -1, dims=1)

    def build():
        mx.random.seed(29)
        net = tllama.llama_model("llama_small", vocab_size=vocab)
        net.initialize(mx.init.Normal(0.05), ctx=mx.cpu())
        return net

    probe = build()
    with torch.no_grad():
        probe(toks[:1])
    dp_est = tcm.estimate_memory(probe, {"dp": 8}, None, batch=batch,
                                 seq=seq, data_axes=("dp",))["total_bytes"]
    plan = autoshard.plan(probe, global_batch=batch, seq=seq, n_devices=8,
                          hbm_budget_bytes=int(dp_est * 0.4))
    assert "fsdp" in plan.mesh_axes

    def run(use_plan):
        net = build()
        step = parallel.TrainStep(net, _llama_loss, "adam",
                                  optimizer_params={"learning_rate": 1e-3},
                                  plan=use_plan)
        return net, step, [float(step(toks, labs)) for _ in range(2)]

    _, _, dense = run(None)
    net, step, got = run(plan)
    np.testing.assert_allclose(got, dense, rtol=2e-4)
    assert step.mesh.shape == plan.mesh_sizes
    q = next(p for n, p in net.collect_params().items()
             if n.endswith("layer0_q_weight"))
    assert q._slices is not None and len(q._slices.tensors()) > 1
