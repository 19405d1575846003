"""Tensor parallelism of the zoo llama: ``TrainStep(partition_rules=
sharding.rule_pack("llama"))`` on a dp 2 x tp 2 mesh of host shards,
held against the reference's step under the same rules and against the
port's unsharded step, from the same weights and batch.

The llama is ``llama_tiny`` (2 layers, 64 units, 4 heads, 2 kv heads,
vocab 64, f32), its weights the reference net's, carried across by
``convert.llama_from_gluon``.  The port's mesh is ``DeviceMesh((2, 2),
("dp", "tp"))`` over 4 ``cpu(0)`` shards; the reference's over 4 of the
conftest's forced host devices.  Tolerances (float32): the losses 2e-5
relative to the reference's and to the unsharded step's (the data shards'
mean and the tp shards' partial sums add in another order than one dense
product; the reference's own rules-against-replicated bound is 2e-5,
``tests/test_sharding.py``); the final weights 1e-4 of max |w| absolute
(Adam turns a gradient that differs in its last bits, where m/sqrt(v) is
ill-conditioned, into a step that differs by up to a fraction of the rate:
at rate 1e-2 a few entries in 10^4 moved 3e-5 apart, so the steps run at
1e-3).
"""

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import parallel as jparallel
from mxnet_tpu import sharding as jsharding
from mxnet_tpu.gluon.model_zoo import llama as jllama

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import convert, parallel, sharding
from mxnet_tpu_torch.gluon.model_zoo import llama as tllama
from mxnet_tpu_torch.ops.nn import softmax_cross_entropy

VOCAB, SEQ, BATCH, STEPS = 64, 16, 4, 3


@pytest.fixture(autouse=True)
def _restore_meshes():
    saved = parallel.current_mesh(), jparallel.current_mesh()
    yield
    parallel.set_mesh(saved[0])
    jparallel.set_mesh(saved[1])


def _weights(seed=11):
    """Reference parameter name -> numpy array (Normal(0.05), norms 1)."""
    net = jllama.llama_model("llama_tiny", vocab_size=VOCAB, prefix="llm_")
    net.initialize(jmx.initializer.Zero())
    net(jmx.nd.array(np.zeros((1, 4), np.int32)))
    r = np.random.RandomState(seed)
    out = {}
    for k, p in net.collect_params().items():
        w = r.normal(0.0, 0.05, p.shape).astype(np.float32)
        if k.endswith("norm_weight"):
            w[...] = 1.0
        out[k] = w
    return out


def _batch():
    r = np.random.RandomState(13)
    toks = r.randint(0, VOCAB, (BATCH, SEQ)).astype(np.int32)
    return toks, np.roll(toks, -1, axis=1).astype(np.int32)


def _torch_loss(out, labels):
    return softmax_cross_entropy(out.reshape(-1, out.shape[-1]).float(),
                                 labels.reshape(-1)) / labels.numel()


def _jax_loss(out, labels):
    return jmx.nd.softmax_cross_entropy(
        out.reshape((-1, out.shape[-1])), labels.reshape((-1,))) / labels.size


def _port_mesh(shape, axes):
    n = int(np.prod(shape))
    return parallel.DeviceMesh(shape, axes, devices=[mx.cpu(0)] * n)


def _port_run(weights, mesh=None, rules=None, steps=STEPS, **kw):
    net = convert.llama_from_gluon(weights, device="cpu")
    step = parallel.TrainStep(net, _torch_loss, "adam",
                              optimizer_params={"learning_rate": 1e-3},
                              mesh=mesh, partition_rules=rules, **kw)
    toks, labs = _batch()
    losses = [float(step(torch.tensor(toks), torch.tensor(labs)))
              for _ in range(steps)]
    return net, step, losses


@pytest.fixture(scope="module")
def reference_run():
    """The reference's losses and final weights under llama_rules on its
    dp 2 x tp 2 mesh."""
    import jax
    weights = _weights()
    net = jllama.llama_model("llama_tiny", vocab_size=VOCAB, prefix="llm_")
    net.initialize(jmx.initializer.Zero())
    net(jmx.nd.array(np.zeros((1, 4), np.int32)))
    for k, p in net.collect_params().items():
        p.set_data(jmx.nd.array(weights[k]))
    mesh = jparallel.DeviceMesh((2, 2), ("dp", "tp"),
                                devices=jax.devices()[:4])
    step = jparallel.TrainStep(net, _jax_loss,
                               jmx.optimizer.Adam(learning_rate=1e-3),
                               mesh=mesh, donate=False,
                               partition_rules=jsharding.rule_pack("llama"))
    toks, labs = _batch()
    losses = [float(step(jmx.nd.array(toks), jmx.nd.array(labs)).asnumpy())
              for _ in range(STEPS)]
    final = {k: p.data().asnumpy() for k, p in net.collect_params().items()}
    return weights, losses, final


def test_tp_llama_matches_reference_and_unsharded(reference_run):
    weights, want, final = reference_run
    before = dict(tllama.TP_COUNTS)
    net, step, got = _port_run(weights, _port_mesh((2, 2), ("dp", "tp")),
                               sharding.rule_pack("llama"))
    # each of the 2 blocks took the tp path in each of 2 data shards a
    # step (the CPU runs the body eagerly every call)
    assert tllama.TP_COUNTS["split"] - before["split"] == 2 * 2 * STEPS
    assert tllama.TP_COUNTS["gathered"] == before["gathered"]
    _, _, dense = _port_run(weights)
    np.testing.assert_allclose(got, want, rtol=2e-5)
    np.testing.assert_allclose(got, dense, rtol=2e-5)
    assert got[-1] < got[0]
    for k, p in net.collect_params().items():
        w = p.data().asnumpy()
        assert w.shape == final[k].shape
        np.testing.assert_allclose(w, final[k], rtol=0,
                                   atol=1e-4 * np.abs(final[k]).max(),
                                   err_msg=k)


def test_tp_llama_slices_and_state_shapes(reference_run):
    """Column-parallel weights split by rows, row-parallel by columns, the
    token table by vocabulary rows; each slice's Adam state has its
    shape; norms stay whole."""
    weights, _, _ = reference_run
    net, step, _ = _port_run(weights, _port_mesh((2, 2), ("dp", "tp")),
                             sharding.rule_pack("llama"), steps=1)
    params = net.collect_params()
    want = {"llm_layer0_q_weight": (32, 64), "llm_layer0_k_weight": (16, 64),
            "llm_layer0_o_weight": (64, 32), "llm_layer1_down_weight":
            (64, 86), "llm_tok_weight": (32, 64), "llm_lm_head_weight":
            (32, 64)}
    for name, shape in want.items():
        slices = params[name]._slices.tensors()
        assert [tuple(t.shape) for t in slices] == [shape, shape], name
    assert params["llm_layer0_attn_norm_weight"]._slices is None
    states = {id(t): s for t, s in zip(step._params, step._states)}
    for t in params["llm_layer0_q_weight"]._slices.tensors():
        assert [tuple(x.shape) for x in parallel._flat(states[id(t)], [])] \
            == [(32, 64), (32, 64)]
    # the whole value gathers; writing it scatters into the slices
    q = params["llm_layer0_q_weight"]
    whole = q.data().asnumpy()
    q.set_data(whole * 2)
    np.testing.assert_array_equal(q.data().asnumpy(), whole * 2)


def test_tp_of_four_with_two_kv_heads_gathers_at_use(reference_run):
    """tp 4 does not divide the 2 kv heads: the blocks gather their
    weights at use (counted) and the losses stay the dense step's."""
    weights, _, _ = reference_run
    before = dict(tllama.TP_COUNTS)
    _, _, got = _port_run(weights, _port_mesh((1, 4), ("dp", "tp")),
                          sharding.rule_pack("llama"), steps=2)
    assert tllama.TP_COUNTS["gathered"] - before["gathered"] == 2 * 2
    assert tllama.TP_COUNTS["split"] == before["split"]
    _, _, dense = _port_run(weights, steps=2)
    np.testing.assert_allclose(got, dense, rtol=2e-5)


def test_tp_llama_with_remat_and_microbatches(reference_run):
    """n_micro and remat compose per data shard: the losses are the
    plain sharded step's."""
    weights, want, _ = reference_run
    _, _, got = _port_run(weights, _port_mesh((2, 2), ("dp", "tp")),
                          sharding.rule_pack("llama"), n_micro=2,
                          remat=True)
    np.testing.assert_allclose(got, want, rtol=2e-5)


def test_apply_tp_shardings_sets_the_packs_hints():
    weights = _weights()
    port = tllama.apply_tp_shardings(convert.llama_from_gluon(
        weights, device="cpu"))
    ref = jllama.llama_model("llama_tiny", vocab_size=VOCAB, prefix="llm_")
    ref.initialize(jmx.initializer.Zero())
    ref(jmx.nd.array(np.zeros((1, 4), np.int32)))
    jllama.apply_tp_shardings(ref)
    assert {k: p.sharding for k, p in port.collect_params().items()} == \
        {k: p.sharding for k, p in ref.collect_params().items()}


def test_tp_axis_takes_the_rules_name(reference_run):
    """The pack's tp axis named "mp" (``rule_pack("llama", tp="mp")``):
    the blocks compute per mp shard as they do over "tp", and the losses
    are the reference's under the "tp" pack."""
    weights, want, _ = reference_run
    before = dict(tllama.TP_COUNTS)
    _, _, got = _port_run(weights, _port_mesh((2, 2), ("dp", "mp")),
                          sharding.rule_pack("llama", tp="mp"))
    assert tllama.TP_COUNTS["split"] - before["split"] == 2 * 2 * STEPS
    assert tllama.TP_COUNTS["gathered"] == before["gathered"]
    np.testing.assert_allclose(got, want, rtol=2e-5)


def test_weights_split_otherwise_gather_at_use_counted(reference_run):
    """A model axis that splits the q projection alone (no Megatron
    pattern): each block gathers its weights at use, counted, and the
    losses stay the dense step's."""
    weights, _, _ = reference_run
    before = dict(tllama.TP_COUNTS)
    _, _, got = _port_run(weights, _port_mesh((2, 2), ("dp", "tp")),
                          [(r"q_weight$", ("tp", None)), (r".*", ())],
                          steps=2)
    assert tllama.TP_COUNTS["gathered"] - before["gathered"] == 2 * 2 * 2
    assert tllama.TP_COUNTS["split"] == before["split"]
    _, _, dense = _port_run(weights, steps=2)
    np.testing.assert_allclose(got, dense, rtol=2e-5)
