"""Partition rules (``sharding``), the sharded ``TrainStep``, the
Trainer's ``mesh_reduced`` skip and the gather-on-save checkpoint, held
against the reference on the same nets, weights and batches.

The port's meshes are ``DeviceMesh`` over ``cpu(0)`` shards (a shard is a
Context; several may name one device); the reference's over the
conftest's 8 forced host devices.  Tolerances (float32): losses 2e-5
relative (the reference's own rules-against-replicated bound,
``tests/test_sharding.py``); final weights against the reference's 1e-5
of max |w| (three Adam steps at 1e-2 from gradients summed in another
order move them 2e-7 apart), a resumed run against the uninterrupted one
1e-6 relative + 1e-7 absolute (the reference's checkpoint bound); specs,
placements and counters exactly.
"""

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import gluon as jgluon
from mxnet_tpu import parallel as jparallel
from mxnet_tpu import sharding as jsharding
from mxnet_tpu.gluon.model_zoo import bert as jbert
from mxnet_tpu.gluon.model_zoo import llama as jllama
from mxnet_tpu.gluon.model_zoo import transformer as jtransformer

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import gluon, parallel, sharding
from mxnet_tpu_torch import telemetry as tel
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.gluon import nn
from mxnet_tpu_torch.gluon.model_zoo import bert as tbert
from mxnet_tpu_torch.gluon.model_zoo import llama as tllama
from mxnet_tpu_torch.gluon.model_zoo import transformer as ttransformer
from mxnet_tpu_torch.telemetry import REGISTRY


@pytest.fixture(autouse=True)
def _restore_state():
    saved = parallel.current_mesh(), jparallel.current_mesh()
    yield
    parallel.set_mesh(saved[0])
    jparallel.set_mesh(saved[1])
    tel.disable()


def _mesh(shape, axes):
    return parallel.DeviceMesh(shape, axes,
                               devices=[mx.cpu(0)] * int(np.prod(shape)))


def _jmesh(shape, axes):
    import jax
    return jparallel.DeviceMesh(shape, axes,
                                devices=jax.devices()[:int(np.prod(shape))])


# -- the packs over the zoo nets ---------------------------------------------

def _zoo_nets():
    """(port, reference) parameter dicts of the llama, BERT and MT
    transformer built alike, keyed by name less the net's prefix."""
    out = {}
    port = tllama.llama_model("llama_tiny", vocab_size=64, prefix="llm_")
    ref = jllama.llama_model("llama_tiny", vocab_size=64, prefix="llm_")
    out["llama"] = (port, ref, "llm_", "llm_")
    port = tbert.bert_model("bert_3_128_2", vocab_size=100, max_length=16,
                            dropout=0.0, device="cpu")
    ref = jbert.bert_model("bert_3_128_2", vocab_size=100, max_length=16,
                           dropout=0.0)
    out["bert"] = (port, ref, port.prefix, ref.prefix)
    kw = dict(vocab_size=50, num_layers=1, units=16, hidden_size=32,
              num_heads=2, max_length=8, dropout=0.0, prefix="tfm_")
    out["transformer"] = (ttransformer.TransformerModel(**kw),
                          jtransformer.TransformerModel(**kw), "tfm_",
                          "tfm_")
    return out


@pytest.fixture(scope="module")
def zoo():
    nets = _zoo_nets()
    for _, ref, _, _ in nets.values():
        ref.initialize(jmx.initializer.Zero())
    return {k: ({n[len(pp):]: p for n, p in port.collect_params().items()},
                {n[len(rp):]: p for n, p in ref.collect_params().items()})
            for k, (port, ref, pp, rp) in nets.items()}


@pytest.mark.parametrize("pack", ["llama", "bert", "transformer",
                                  "llama_fsdp", "bert_fsdp",
                                  "transformer_fsdp"])
def test_packs_match_reference_on_the_zoo_nets(zoo, pack):
    port, ref = zoo[pack.split("_")[0]]
    assert sorted(port) == sorted(ref)
    got = sharding.match_partition_rules(sharding.rule_pack(pack), port)
    want = jsharding.match_partition_rules(jsharding.rule_pack(pack), ref)
    assert got == want
    assert any(s for s in got.values())
    # under on_unmatched="error" both cover the tree or both name the
    # same strays (BERT's pooler)
    errors = []
    for mod, rules, leaves in ((sharding, sharding.rule_pack(pack), port),
                               (jsharding, jsharding.rule_pack(pack), ref)):
        try:
            mod.match_partition_rules(rules, leaves, on_unmatched="error")
            errors.append(None)
        except Exception as e:  # noqa: BLE001 (either package's error)
            errors.append(str(e))
    assert errors[0] == errors[1]


def test_rule_errors_match_reference():
    cases = [([(r".*", ("bogus",))], {"w": (4,)}),
             ([(r"(", ())], {"w": (4,)}),
             ([(r"w", ("tp", None, None))], {"w": (4, 4)}),
             ([(r"q", ("tp",))], {"stray": (4, 4)})]
    for rules, leaves in cases:
        with pytest.raises(MXNetError) as got:
            sharding.match_partition_rules(rules, leaves,
                                           on_unmatched="error")
        with pytest.raises(jmx.base.MXNetError) as want:
            jsharding.match_partition_rules(rules, leaves,
                                            on_unmatched="error")
        assert str(got.value) == str(want.value)
    assert sharding.match_partition_rules(
        [(r".*", ("tp",))], {"s": (), "one": (1,), "v": (8,)}) == \
        {"s": (), "one": (), "v": ("tp",)}


@pytest.mark.parametrize("spec,shape", [
    (("tp", None), (8, 6)), (("tp", None), (7, 6)), (("sp", "tp"), (8, 6)),
    ((("dp", "tp"), None), (16, 2)), ((("dp", "tp"), None), (12, 2)),
    (("tp", "fsdp"), (16, 16)), ((), (4, 4)), ((None, "dp"), (3, 8))])
def test_resolve_spec_degrades_as_the_reference(spec, shape):
    mesh, jmesh = _mesh((4, 2), ("dp", "tp")), _jmesh((4, 2), ("dp", "tp"))
    pl, did = sharding.resolve_spec(spec, mesh, shape=shape)
    jsh, jdid = jsharding.resolve_spec(spec, jmesh, shape=shape)
    assert did == jdid
    assert pl.mesh is mesh and pl.spec == tuple(jsh.spec)


# -- the sharded TrainStep on the reference's MLP ----------------------------

class _MLP(gluon.HybridBlock):
    def __init__(self, **kw):
        super().__init__(**kw)
        with self.name_scope():
            self.fc1 = nn.Dense(16, flatten=False, in_units=8, prefix="fc1_")
            self.fc2 = nn.Dense(4, flatten=False, in_units=16, prefix="fc2_")

    def hybrid_forward(self, F, x):
        return self.fc2(F.relu(self.fc1(x)))


class _JMLP(jgluon.HybridBlock):
    def __init__(self, **kw):
        super().__init__(**kw)
        with self.name_scope():
            self.fc1 = jgluon.nn.Dense(16, flatten=False, in_units=8,
                                       prefix="fc1_")
            self.fc2 = jgluon.nn.Dense(4, flatten=False, in_units=16,
                                       prefix="fc2_")

    def hybrid_forward(self, F, x):
        return self.fc2(F.relu(self.fc1(x)))


_MLP_RULES = [(r"fc1_weight$", ("tp", None)),
              (r"fc2_weight$", (None, "tp")),
              (r"fc1_bias$", ("tp",))]


def _weights(seed=3):
    r = np.random.RandomState(seed)
    return {"mlp_fc1_weight": r.randn(16, 8).astype(np.float32) * 0.4,
            "mlp_fc1_bias": r.randn(16).astype(np.float32) * 0.1,
            "mlp_fc2_weight": r.randn(4, 16).astype(np.float32) * 0.4,
            "mlp_fc2_bias": r.randn(4).astype(np.float32) * 0.1}


def _batch(n=8):
    r = np.random.RandomState(0)
    return (r.randn(n, 8).astype(np.float32),
            r.randn(n, 4).astype(np.float32))


def _port_mlp(mesh=None, rules=None, steps=3, **kw):
    net = _MLP(prefix="mlp_")
    for k, p in net.collect_params().items():
        p.set_data(torch.tensor(_weights()[k]))
    step = parallel.TrainStep(net, lambda o, l: gluon.loss.L2Loss()(o, l),
                              mx.optimizer.Adam(learning_rate=1e-2),
                              mesh=mesh, partition_rules=rules, **kw)
    x, y = (torch.tensor(a) for a in _batch())
    return net, step, [float(step(x, y)) for _ in range(steps)]


@pytest.fixture(scope="module")
def reference_mlp():
    net = _JMLP(prefix="mlp_")
    net.initialize(jmx.initializer.Zero())
    for k, p in net.collect_params().items():
        p.set_data(jmx.nd.array(_weights()[k]))
    step = jparallel.TrainStep(
        net, lambda o, l: jgluon.loss.L2Loss()(o, l),
        jmx.optimizer.Adam(learning_rate=1e-2),
        mesh=_jmesh((4, 2), ("dp", "tp")), donate=False,
        partition_rules=_MLP_RULES)
    x, y = (jmx.nd.array(a) for a in _batch())
    losses = [float(step(x, y).asnumpy()) for _ in range(3)]
    return losses, {k: p.data().asnumpy()
                    for k, p in net.collect_params().items()}


def test_mlp_rules_match_reference(reference_mlp):
    want, final = reference_mlp
    net, step, got = _port_mlp(_mesh((4, 2), ("dp", "tp")), _MLP_RULES)
    np.testing.assert_allclose(got, want, rtol=2e-5)
    _, _, dense = _port_mlp()
    np.testing.assert_allclose(got, dense, rtol=2e-5)
    for k, p in net.collect_params().items():
        np.testing.assert_allclose(p.data().asnumpy(), final[k], rtol=0,
                                   atol=1e-5 * np.abs(final[k]).max(),
                                   err_msg=k)
    # each slice and its Adam state: the rows / columns of one tp shard
    params = net.collect_params()
    shapes = {"mlp_fc1_weight": (8, 8), "mlp_fc2_weight": (4, 8),
              "mlp_fc1_bias": (8,)}
    states = {id(t): s for t, s in zip(step._params, step._states)}
    for name, shape in shapes.items():
        slices = params[name]._slices.tensors()
        assert [tuple(t.shape) for t in slices] == [shape, shape]
        for t in slices:
            assert [tuple(s.shape) for s in parallel._flat(states[id(t)],
                                                           [])] == [shape] * 2
    assert params["mlp_fc2_bias"]._slices is None


def test_rules_are_authoritative_and_hints_apply_without_them():
    """Under rules a stale Parameter.sharding hint does not split an
    unmatched parameter; without rules the hint splits where the mesh
    carries its axis (the reference's _param_sharding)."""
    mesh = _mesh((4, 2), ("dp", "tp"))
    net = _MLP(prefix="mlp_")
    for k, p in net.collect_params().items():
        p.set_data(torch.tensor(_weights()[k]))
    net.collect_params()["mlp_fc2_weight"].sharding = ("tp", None)
    step = parallel.TrainStep(net, lambda o, l: gluon.loss.L2Loss()(o, l),
                              "adam", mesh=mesh,
                              partition_rules=[(r"fc1_weight$", ("tp", None))])
    x, y = (torch.tensor(a) for a in _batch())
    step(x, y)
    params = net.collect_params()
    assert params["mlp_fc2_weight"]._slices is None
    assert params["mlp_fc1_weight"]._slices is not None
    hinted = parallel.TrainStep(net, lambda o, l: gluon.loss.L2Loss()(o, l),
                                "adam", mesh=mesh)
    hinted(x, y)
    assert params["mlp_fc2_weight"]._slices is not None
    assert params["mlp_fc1_weight"]._slices is None    # its hint is None


def test_coverage_counters_count_each_param_once():
    deltas = []
    for pkg_run in ("port", "ref"):
        names = ("mxnet_sharding_resolved_params_total",
                 "mxnet_sharding_fallback_params_total")
        if pkg_run == "port":
            reg, on, off = REGISTRY, tel.enable, tel.disable
        else:
            from mxnet_tpu import telemetry as jtel
            reg, on, off = jtel.REGISTRY, jtel.enable, jtel.disable
        on()
        try:
            before = [reg.get(n).value for n in names]
            if pkg_run == "port":
                _port_mlp(_mesh((4, 2), ("dp", "tp")), _MLP_RULES, steps=2)
            else:
                net = _JMLP(prefix="mlp_")
                net.initialize(jmx.initializer.Zero())
                step = jparallel.TrainStep(
                    net, lambda o, l: jgluon.loss.L2Loss()(o, l), "adam",
                    mesh=_jmesh((4, 2), ("dp", "tp")), donate=False,
                    partition_rules=_MLP_RULES)
                x, y = (jmx.nd.array(a) for a in _batch())
                step(x, y)
                step(x, y)
            deltas.append([reg.get(n).value - b
                           for n, b in zip(names, before)])
        finally:
            off()
    assert deltas[0] == deltas[1] == [3, 1]


@pytest.mark.parametrize("mesh_shape,axes,rules,data_spec", [
    ((2, 2, 2), ("dp", "fsdp", "tp"), [(r"weight$", ("tp", "fsdp"))],
     (("dp", "fsdp"),)),
    ((2, 2, 2), ("dp", "tp", "sp"), None, (("dp", "sp"),)),
    ((8,), ("dp",), None, ()),
])
def test_generic_placements_are_the_dense_step(mesh_shape, axes, rules,
                                               data_spec):
    """fsdp (ZeRO-3: each data shard gathers at use), a batch over a tuple
    of axes, and data_spec=() (one shard, the batch whole) all give the
    unsharded step's losses."""
    _, _, got = _port_mlp(_mesh(mesh_shape, axes), rules,
                          data_spec=data_spec)
    _, _, dense = _port_mlp()
    np.testing.assert_allclose(got, dense, rtol=2e-5)


def test_layouts_the_step_cannot_realise_raise():
    mesh = _mesh((2, 4), ("dp", "sp"))
    x, y = (torch.tensor(a) for a in _batch())
    net = _MLP(prefix="mlp_")
    net.initialize(mx.init.Xavier(), ctx=mx.cpu())
    step = parallel.TrainStep(net, lambda o, l: gluon.loss.L2Loss()(o, l),
                              "sgd", mesh=mesh, data_spec=("dp", "sp"))
    with pytest.raises(MXNetError, match="axis 'sp'.*attn_impl"):
        step(x, y)
    step = parallel.TrainStep(net, lambda o, l: gluon.loss.L2Loss()(o, l),
                              "sgd", mesh=_mesh((8,), ("dp",)))
    with pytest.raises(MXNetError, match="batch of 6 does not split"):
        step(x[:6], y[:6])
    with pytest.raises(MXNetError, match="LAMB"):
        parallel.TrainStep(net, lambda o, l: gluon.loss.L2Loss()(o, l),
                           "lamb", mesh=_mesh((4, 2), ("dp", "tp")),
                           partition_rules=_MLP_RULES)(x, y)
    with pytest.raises(MXNetError, match="autoshard.Plan"):
        parallel.TrainStep(net, None, "sgd", plan=object())


def test_split_parameter_gathers_scatters_and_unslices():
    net, _, _ = _port_mlp(_mesh((4, 2), ("dp", "tp")), _MLP_RULES, steps=1)
    w = net.collect_params()["mlp_fc1_weight"]
    whole = w.data().asnumpy()
    assert w.data().shape == (16, 8) and w._data._data.device.type == "meta"
    with pytest.raises(MXNetError, match="stored in slices"):
        w.grad()
    # an eager forward outside the step reads the gathered value
    x = torch.tensor(_batch()[0])
    with torch.no_grad():
        out = net(x)
    w.set_data(whole + 1)
    np.testing.assert_array_equal(w.data().asnumpy(), whole + 1)
    w.set_data(whole)
    # a later unsharded step gathers every parameter back
    step = parallel.TrainStep(net, lambda o, l: gluon.loss.L2Loss()(o, l),
                              "sgd")
    step(x, torch.tensor(_batch()[1]))
    assert all(p._slices is None for p in net.collect_params().values())
    assert out.shape == (8, 4)


# -- Trainer and checkpoint -----------------------------------------------------

def _two_ctx_net():
    ctxs = [mx.cpu(0), mx.cpu(1)]
    net = _MLP(prefix="mlp_")
    net.initialize(mx.init.Xavier(), ctx=ctxs)
    return net, ctxs


def _set_grads(net, ctxs):
    for p in net.collect_params().values():
        for i, g in enumerate(p.list_grad()):
            g[:] = mx.nd.ones(p.shape, ctx=ctxs[i]) * (i + 1)


@pytest.mark.parametrize("knob", ["1", "0"])
def test_trainer_skips_mesh_reduced_params(monkeypatch, knob):
    monkeypatch.setenv("MXNET_SHARDING_SKIP_ALLREDUCE", knob)
    net, ctxs = _two_ctx_net()
    params = net.collect_params()
    marked = params["mlp_fc1_weight"]
    marked.mesh_reduced = True
    tr = gluon.Trainer(params, "sgd", {"learning_rate": 0.1},
                       kvstore="device")
    _set_grads(net, ctxs)
    tel.enable()
    before = REGISTRY.get("mxnet_sharding_skipped_allreduce_total").value
    tr.allreduce_grads()
    skipped = REGISTRY.get("mxnet_sharding_skipped_allreduce_total").value \
        - before
    want = [1.0, 2.0] if knob == "1" else [3.0, 3.0]
    for g, v in zip(marked.list_grad(), want):
        np.testing.assert_allclose(g.asnumpy(), v)
    for g in params["mlp_fc2_weight"].list_grad():
        np.testing.assert_allclose(g.asnumpy(), 3.0)
    assert skipped == (1 if knob == "1" else 0)


def test_trainer_update_on_kvstore_rejects_mesh_reduced_and_helper():
    net, ctxs = _two_ctx_net()
    params = net.collect_params()
    params["mlp_fc1_weight"].mesh_reduced = True
    tr = gluon.Trainer(params, "sgd", {"learning_rate": 0.1},
                       kvstore="device", update_on_kvstore=True)
    _set_grads(net, ctxs)
    with pytest.raises(MXNetError, match="mesh_reduced"):
        tr.step(1)
    sharding.mark_mesh_reduced(net)
    assert all(p.mesh_reduced for p in params.values())
    sharding.mark_mesh_reduced(net, False)
    assert not any(p.mesh_reduced for p in params.values())
    specs = sharding.apply_rules(net, _MLP_RULES, mesh_reduced=True)
    assert params["mlp_fc1_weight"].sharding == ("tp", None) == \
        specs["mlp_fc1_weight"] and params["mlp_fc2_bias"].sharding is None
    assert all(p.mesh_reduced for p in params.values())


def test_checkpoint_gathers_on_save_and_restores_into_slices(tmp_path,
                                                             monkeypatch):
    mesh = _mesh((4, 2), ("dp", "tp"))
    net_r, _, _ = _port_mlp(mesh, _MLP_RULES, steps=4)
    ref = {k: p.data().asnumpy() for k, p in net_r.collect_params().items()}
    net_a, step_a, _ = _port_mlp(mesh, _MLP_RULES, steps=2)
    mgr = mx.checkpoint.CheckpointManager(str(tmp_path / "ck"))
    assert mgr.save(2, net=net_a)
    saved = {k: p.data().asnumpy() for k, p in net_a.collect_params().items()}
    # a fresh net already split by its step takes the file into its slices
    net_b, _, _ = _port_mlp(mesh, _MLP_RULES, steps=1)
    assert mgr.restore(net=net_b)[0] == 2
    for k, p in net_b.collect_params().items():
        assert np.array_equal(p.data().asnumpy(), saved[k]), k
    mgr.restore(net=net_a)
    x, y = (torch.tensor(a) for a in _batch())
    for _ in range(2):
        step_a(x, y)
    for k, p in net_a.collect_params().items():
        np.testing.assert_allclose(p.data().asnumpy(), ref[k], rtol=1e-6,
                                   atol=1e-7, err_msg=k)
    monkeypatch.setenv("MXNET_CHECKPOINT_SHARDED", "1")
    with pytest.raises(MXNetError, match="MXNET_CHECKPOINT_SHARDED"):
        mgr.save(3, net=net_a)


@pytest.mark.parametrize("pack", ["bert", "bert_fsdp"])
def test_bert_packs_gather_at_use_with_the_dense_losses(pack):
    """BERT's fused attn_qkv rows mix q, k and v in a contiguous chunk,
    so a sharded step stores them split and gathers them at use: the
    losses are the unsharded step's."""
    toks = np.random.RandomState(2).randint(0, 100, (4, 16)).astype(np.int64)

    def run(mesh, rules):
        net = tbert.bert_model("bert_3_128_2", vocab_size=100, max_length=16,
                               dropout=0.0, device="cpu",
                               generator=torch.Generator().manual_seed(5))
        tbert.apply_tp_shardings(net)

        def loss(out, labels):
            logits = out[2] if isinstance(out, (tuple, list)) else out
            return torch.nn.functional.cross_entropy(
                logits.reshape(-1, logits.shape[-1]).float(),
                labels.reshape(-1))
        step = parallel.TrainStep(net, loss, "adam", mesh=mesh,
                                  partition_rules=rules)
        t = torch.tensor(toks)
        return net, [float(step(t, t)) for _ in range(2)]

    axes = ("dp", "tp") if pack == "bert" else ("dp", "fsdp")
    net, got = run(_mesh((2, 2), axes), sharding.rule_pack(pack))
    _, dense = run(None, None)
    np.testing.assert_allclose(got, dense, rtol=2e-5)
    qkv = next(p for n, p in net.collect_params().items()
               if n.endswith("layer0_attn_qkv_weight"))
    assert qkv._slices is not None and len(qkv._slices.tensors()) == 2
