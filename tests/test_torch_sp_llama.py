"""The sequence-parallel llama: ``contrib.sp_att_qkv``, the zoo llama with
``attn_impl="ring"`` and ``"ulysses"``, and ``TrainStep`` over a dp x sp
mesh, held against the reference on the same weights.

The port's mesh is ``DeviceMesh((2, 4), ("dp", "sp"))`` over 8 host
Contexts of one process; the reference's over the 8 forced host devices
(``tests/conftest.py``).  The forward is held against the reference's
fused forward, which the reference's own test holds equal to its sp
forward (``tests/test_llama.py:109-141``, rtol 2e-4): its sp forward
cannot run within a test's 10 s here (eagerly each ``shard_map`` call
takes 10-50 s; hybridized, its ``device_put`` at
``kernels/ring_attention.py:164`` meets the cached op's one-device key
and raises).  Tolerances (float32): ``sp_att_qkv`` against
``masked_att_qkv`` 1e-5 relative (the reference's own bound); logits 2e-5
absolute (they are O(1): ``test_torch_llama.py``'s bound); the first
``TrainStep`` loss against the reference's fused one 2e-4 relative (the
reference's own sp-against-fused bound, ``tests/test_llama.py:141``).
"""

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import parallel as jparallel
from mxnet_tpu.gluon.model_zoo import llama as jllama

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import convert, parallel
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.gluon.model_zoo import llama as tllama
from mxnet_tpu_torch.ops.nn import softmax_cross_entropy

VOCAB, SEQ, BATCH = 64, 16, 4


@pytest.fixture(autouse=True)
def _restore_meshes():
    saved = parallel.current_mesh(), jparallel.current_mesh()
    yield
    parallel.set_mesh(saved[0])
    jparallel.set_mesh(saved[1])


def _meshes():
    return (parallel.DeviceMesh((2, 4), ("dp", "sp"),
                                devices=[mx.cpu(i) for i in range(8)]),
            jparallel.DeviceMesh((2, 4), ("dp", "sp")))


def _weights(seed=7):
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


def _jax_net(weights, impl):
    net = jllama.llama_model("llama_tiny", vocab_size=VOCAB, prefix="llm_",
                             attn_impl=impl)
    net.initialize(jmx.initializer.Zero())
    net(jmx.nd.array(np.zeros((1, 4), np.int32)))
    for k, p in net.collect_params().items():
        p.set_data(jmx.nd.array(weights[k]))
    return net


def _port_net(weights, impl):
    net = tllama.llama_model("llama_tiny", vocab_size=VOCAB, prefix="llm_",
                             attn_impl=impl)
    return convert.load_by_name(net, weights, device="cpu")


def _batch():
    r = np.random.RandomState(7)
    toks = r.randint(0, VOCAB, (BATCH, SEQ)).astype(np.int32)
    return toks, np.roll(toks, -1, axis=1).astype(np.int32)


def test_sp_att_qkv_without_a_mesh_is_masked_att_qkv():
    """No current mesh (or one without the axis): the local attention,
    equal to ``masked_att_qkv`` with every position valid, as the
    reference's."""
    r = np.random.RandomState(3)
    B, H, L, D = 2, 4, 16, 8
    q = r.randn(B, H, L, D).astype(np.float32)
    k = r.randn(B, H // 2, L, D).astype(np.float32)
    v = r.randn(B, H // 2, L, D).astype(np.float32)
    vl = np.full((B,), L, np.float32)
    want = jmx.nd.contrib.sp_att_qkv(
        *map(jmx.nd.array, (q, k, v)), impl="ring", axis="sp",
        num_kv_groups=2, causal=True).asnumpy()
    with mx.cpu():
        t = [mx.nd.array(x) for x in (q, k, v)]
        parallel.set_mesh(None)
        got = mx.nd.contrib.sp_att_qkv(*t, impl="ring", axis="sp",
                                       num_kv_groups=2, causal=True)
        ref = mx.nd.contrib.masked_att_qkv(*t, mx.nd.array(vl),
                                           num_kv_groups=2, causal=True)
        parallel.make_mesh((8,), ("dp",), devices=[mx.cpu(i)
                                                   for i in range(8)])
        no_axis = mx.nd.contrib.sp_att_qkv(*t, impl="ulysses", axis="sp",
                                           num_kv_groups=2, causal=True)
    np.testing.assert_allclose(got.asnumpy(), ref.asnumpy(), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(got.asnumpy(), want, rtol=1e-5, atol=1e-6)
    assert np.array_equal(no_axis.asnumpy(), got.asnumpy())


@pytest.mark.parametrize("impl", ["ring", "ulysses"])
def test_sp_att_qkv_over_the_mesh(impl):
    """With the mesh current the op runs the sequence-parallel kernel,
    its output on the caller's device, equal to the local attention."""
    mesh, _ = _meshes()
    r = np.random.RandomState(4)
    q, k, v = (r.randn(2, 4, 16, 8).astype(np.float32) for _ in range(3))
    with mx.cpu(3):
        t = [mx.nd.array(x) for x in (q, k, v)]
        parallel.set_mesh(mesh)
        got = mx.nd.contrib.sp_att_qkv(*t, impl=impl, causal=True)
        parallel.set_mesh(None)
        local = mx.nd.contrib.sp_att_qkv(*t, impl=impl, causal=True)
    assert got.ctx == local.ctx and got._data.device == torch.device("cpu")
    np.testing.assert_allclose(got.asnumpy(), local.asnumpy(), rtol=1e-5,
                               atol=1e-6)


@pytest.fixture(scope="module")
def fused_logits():
    jnet = _jax_net(_weights(), "fused")
    jnet.hybridize()
    return jnet(jmx.nd.array(_batch()[0])).asnumpy()


@pytest.mark.parametrize("impl", ["ring", "ulysses"])
def test_sp_llama_forward_matches_reference(fused_logits, impl):
    mesh, _ = _meshes()
    weights = _weights()
    toks, _ = _batch()
    want = fused_logits
    port = _port_net(weights, impl)
    parallel.set_mesh(mesh)
    with torch.no_grad():
        got = port(torch.tensor(toks)).numpy()
    assert got.shape == want.shape == (BATCH, SEQ, VOCAB)
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-5)


def _jax_loss(out, labels):
    return jmx.nd.softmax_cross_entropy(
        out.reshape((-1, out.shape[-1])), labels.reshape((-1,))) / labels.size


def _torch_loss(out, labels):
    return softmax_cross_entropy(out.reshape(-1, out.shape[-1]).float(),
                                 labels.reshape(-1)) / labels.numel()


@pytest.fixture(scope="module")
def fused_loss():
    """The reference's first TrainStep loss of the fused llama."""
    import jax
    weights = _weights()
    toks, labs = _batch()
    one = jparallel.DeviceMesh(shape=(1,), devices=jax.devices()[:1])
    step = jparallel.TrainStep(_jax_net(weights, "fused"), _jax_loss,
                               jmx.optimizer.Adam(learning_rate=1e-3),
                               mesh=one)
    return float(step(jmx.nd.array(toks), jmx.nd.array(labs)).asnumpy())


@pytest.mark.parametrize("impl", ["ring", "ulysses"])
def test_sp_train_step_matches_reference_fused_loss(fused_loss, impl):
    mesh, _ = _meshes()
    toks, labs = _batch()
    parallel.set_mesh(mesh)
    step = parallel.TrainStep(_port_net(_weights(), impl), _torch_loss,
                              "adam", optimizer_params={"learning_rate": 1e-3},
                              mesh=mesh, donate=False,
                              data_spec=("dp", "sp"))
    losses = step.run(toks, labs, steps=2).tolist()
    np.testing.assert_allclose(losses[0], fused_loss, rtol=2e-4)
    assert losses[1] < losses[0] and all(np.isfinite(losses))


def test_train_step_mesh_checks():
    """Shards on one device run; axes a data_spec names must be the
    mesh's; a mesh over distinct devices waits for the sharding slice."""
    mesh, _ = _meshes()
    net = torch.nn.Linear(2, 2)
    step = parallel.TrainStep(net, _torch_loss, "sgd", mesh=mesh)
    assert step.mesh is mesh
    with pytest.raises(MXNetError, match="names axis 'tp'"):
        parallel.TrainStep(net, _torch_loss, "sgd", mesh=mesh,
                           data_spec=("dp", "tp"))
    two = parallel.DeviceMesh((2,), ("dp",), devices=[mx.cpu(0), mx.gpu(0)])
    with pytest.raises(MXNetError, match="sharding slice"):
        parallel.TrainStep(net, _torch_loss, "sgd", mesh=two)
    cards = parallel.DeviceMesh((2,), ("dp",), devices=[mx.gpu(0)] * 2)
    step = parallel.TrainStep(net, _torch_loss, "sgd", mesh=cards)
    with pytest.raises(MXNetError, match="the net on cpu"):
        step(torch.ones(2, 2), torch.ones(2, 2))
