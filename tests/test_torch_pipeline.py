"""GPipe (``pipeline.gpipe``, ``pipeline_apply``, ``stack_blocks``,
``PipelinedBlock``) against the sequential stack and the reference's
schedule on the same parameters and inputs.

The port's meshes are ``DeviceMesh`` over ``cpu(0)`` shards (pp 4, and
dp 2 x pp 4); the reference's over the conftest's forced host devices.
Tolerances (float32): outputs 1e-5 (the reference's own bound against its
sequential stack), gradients 1e-4 relative + 1e-5 absolute (its bound);
the reference's pipelined output against the port's 1e-5.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import mxnet_tpu as jmx
from mxnet_tpu import pipeline as jpl
from mxnet_tpu.parallel import DeviceMesh as JMesh

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import pipeline as pl
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.gluon import nn
from mxnet_tpu_torch.parallel import DeviceMesh


def _mesh(shape, axes):
    return DeviceMesh(shape, axes, devices=[mx.cpu(0)] * int(np.prod(shape)))


def _stage(params, x):
    return torch.tanh(x @ params["w"] + params["b"])


def _jstage(params, x):
    return jnp.tanh(jnp.dot(x, params["w"]) + params["b"])


def _params(S, d, seed=0):
    rng = np.random.RandomState(seed)
    return {"w": rng.randn(S, d, d).astype(np.float32) * 0.3,
            "b": rng.randn(S, d).astype(np.float32) * 0.1}


def _leaves(params):
    return {k: torch.tensor(v, requires_grad=True) for k, v in params.items()}


def _sequential(params, x):
    for s in range(params["w"].shape[0]):
        x = _stage({k: v[s] for k, v in params.items()}, x)
    return x


@pytest.mark.parametrize("mesh_shape,data_axis", [((4,), None),
                                                  ((2, 4), "dp")])
def test_gpipe_forward_and_grads_match_sequential_and_reference(
        mesh_shape, data_axis):
    S, M, B, d = 4, 4, 16, 8
    axes = ("pp",) if data_axis is None else ("dp", "pp")
    params = _params(S, d, seed=5)
    x = np.random.RandomState(4).randn(B, d).astype(np.float32)
    fn = pl.gpipe(_stage, S, M, _mesh(mesh_shape, axes), data_axis=data_axis)
    leaves, xt = _leaves(params), torch.tensor(x, requires_grad=True)
    out = fn(leaves, xt)
    grads = torch.autograd.grad((out ** 2).sum(), [*leaves.values(), xt])
    seq_leaves, xs = _leaves(params), torch.tensor(x, requires_grad=True)
    want = _sequential(seq_leaves, xs)
    seq_grads = torch.autograd.grad((want ** 2).sum(),
                                    [*seq_leaves.values(), xs])
    np.testing.assert_allclose(out.detach().numpy(), want.detach().numpy(),
                               rtol=1e-5, atol=1e-5)
    for g, h in zip(grads, seq_grads):
        np.testing.assert_allclose(g.numpy(), h.numpy(), rtol=1e-4,
                                   atol=1e-5)
    jmesh = JMesh(shape=mesh_shape, axis_names=axes,
                  devices=jax.devices()[:int(np.prod(mesh_shape))])
    jfn = jpl.gpipe(_jstage, S, M, jmesh, axis="pp", data_axis=data_axis)
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    ref = np.asarray(jfn(jparams, x))
    np.testing.assert_allclose(out.detach().numpy(), ref, rtol=1e-5,
                               atol=1e-5)
    jg = jax.grad(lambda p: jnp.sum(jfn(p, x) ** 2))(jparams)
    for g, k in zip(grads, params):
        np.testing.assert_allclose(g.numpy(), np.asarray(jg[k]), rtol=1e-4,
                                   atol=1e-5)


def test_gpipe_runs_only_the_valid_stage_calls():
    """S x M stage calls, in the reference's tick order (stage order
    within a tick)."""
    S, M = 3, 4
    calls = []

    def stage(params, x):
        calls.append((int(params["id"]), int(x[0, 0])))
        return x + 1

    x = torch.zeros(8, 1)
    x[:, 0] = torch.arange(8) // 2 * 10        # microbatch m starts at 10m
    out = pl.gpipe(stage, S, M, _mesh((S,), ("pp",)))(
        {"id": torch.arange(S)}, x)
    want = [(s, 10 * (t - s) + s) for t in range(S + M - 1)
            for s in range(S) if 0 <= t - s < M]
    assert calls == want and len(calls) == S * M
    np.testing.assert_array_equal(out.numpy(), x.numpy() + S)


def test_gpipe_checks_match_reference():
    mesh = _mesh((2, 4), ("dp", "pp"))
    with pytest.raises(MXNetError, match="need n_stages=3"):
        pl.gpipe(_stage, 3, 2, mesh)
    fn = pl.gpipe(_stage, 4, 4, mesh, data_axis="dp")
    params = _leaves(_params(4, 2))
    jmesh = JMesh(shape=(2, 4), axis_names=("dp", "pp"),
                  devices=jax.devices()[:8])
    jfn = jpl.gpipe(_jstage, 4, 4, jmesh, axis="pp", data_axis="dp")
    for b in (12, 7):
        with pytest.raises(MXNetError) as got:
            fn(params, torch.zeros(b, 2))
        with pytest.raises(jmx.base.MXNetError) as want:
            jfn({k: jnp.asarray(v.detach().numpy())
                 for k, v in params.items()}, np.zeros((b, 2), np.float32))
        assert str(got.value) == str(want.value)


def test_pipeline_apply_single_stage():
    params = _params(1, 4)
    x = np.random.RandomState(0).randn(4, 4).astype(np.float32)
    out = pl.pipeline_apply(_stage, _leaves(params), torch.tensor(x),
                            _mesh((1,), ("pp",)), n_microbatches=2)
    want = _sequential(_leaves(params), torch.tensor(x))
    np.testing.assert_allclose(out.detach().numpy(), want.detach().numpy(),
                               rtol=1e-5, atol=1e-5)


def _blocks(pkg, S, d):
    out = []
    for i in range(S):
        blk = pkg.gluon.nn.HybridSequential(prefix=f"stage{i}_")
        with blk.name_scope():
            blk.add(pkg.gluon.nn.Dense(d, activation="tanh", flatten=False,
                                       in_units=d, prefix="fc_"))
        blk.initialize(pkg.init.Zero(), **(
            {"ctx": pkg.cpu()} if pkg is mx else {}))
        rng = np.random.RandomState(10 + i)
        for p in blk.collect_params().values():
            p.set_data(rng.randn(*p.shape).astype(np.float32) * 0.4)
        out.append(blk)
    return out


def test_pipelined_block_matches_blocks_and_reference():
    """stack_blocks + PipelinedBlock against the blocks run in turn and
    against the reference's PipelinedBlock; the slices' gradients are
    each block's."""
    S, B, d = 4, 8, 8
    x = np.random.RandomState(7).randn(B, d).astype(np.float32)
    blocks = _blocks(mx, S, d)
    piped = pl.PipelinedBlock(blocks, _mesh((S,), ("pp",)), n_microbatches=4)
    xt = torch.tensor(x)
    out = piped(mx.nd.array(x, ctx=mx.cpu()))
    assert isinstance(out, mx.nd.NDArray) and out.shape == (B, d)
    assert [t.shape for t in piped.stacked["stage0_fc_weight"]] == \
        [torch.Size([d, d])] * S
    grads = torch.autograd.grad(out._data.sum(),
                                piped.stacked["stage0_fc_weight"])
    ref = xt
    leaves = []
    for blk in blocks:
        w = blk.collect_params()
        leaves.append(next(p for k, p in w.items() if k.endswith("weight"))
                      .data()._data)
        with mx.autograd.train_mode():
            ref = blk(ref)
    ref_grads = torch.autograd.grad(ref.sum(), leaves)
    np.testing.assert_allclose(out.asnumpy(), ref.detach().numpy(),
                               rtol=1e-5, atol=1e-5)
    for g, h in zip(grads, ref_grads):
        np.testing.assert_allclose(g.numpy(), h.numpy(), rtol=1e-4,
                                   atol=1e-5)
    jblocks = _blocks(jmx, S, d)
    jpiped = jpl.PipelinedBlock(jblocks, JMesh(
        shape=(S,), axis_names=("pp",), devices=jax.devices()[:S]),
        n_microbatches=4)
    np.testing.assert_allclose(out.asnumpy(),
                               jpiped(jmx.nd.array(x)).asnumpy(),
                               rtol=1e-5, atol=1e-5)
