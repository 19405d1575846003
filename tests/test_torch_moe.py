"""The port's ``gluon.contrib.SparseMoE`` and ``gluon.contrib.nn`` layers
held against the JAX package's on the CPU, on the same weights (numpy
draws set by name).

SparseMoE: k = 1 (Switch: the raw router probability) and k = 2 (GShard:
normalized over the chosen experts), at a capacity that drops tokens;
outputs and the Switch aux loss 1e-5 of max |ref|, the gradients of every
parameter and of the input 1e-4 of max |ref| (three einsums sum in another
order), the per-expert slot counts exactly.  gluon.contrib.nn: outputs
1e-6 absolute.
"""

import threading

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.gluon.contrib import SparseMoE
from mxnet_tpu_torch.ops import sweep

PKGS = (jmx, mx)
OUT_TOL, GRAD_TOL = 1e-5, 1e-4


@pytest.fixture(autouse=True)
def _on_cpu():
    with mx.cpu():
        yield


def _in_thread(fn):
    """fn() in a fresh thread: the prefix counters start at 0."""
    out = []
    t = threading.Thread(target=lambda: out.append(fn()))
    t.start()
    t.join()
    return out[0]


def _moe(pkg, k, cf, act, params=None):
    def build():
        net = pkg.gluon.contrib.SparseMoE(8, 12, 4, num_experts_per_token=k,
                                          capacity_factor=cf, activation=act)
        net.initialize(ctx=pkg.cpu())
        return net
    net = _in_thread(build)
    rng = np.random.RandomState(5)
    params = {n: (rng.randn(*p.shape) * 0.5).astype(np.float32)
              for n, p in net.collect_params().items()}
    for n, p in net.collect_params().items():
        p.set_data(pkg.nd.array(params[n], ctx=pkg.cpu()))
    return net


def _run(pkg, net, x, hybrid):
    if hybrid:
        net.hybridize()
    xs = pkg.nd.array(x, ctx=pkg.cpu())
    xs.attach_grad()
    head = np.random.RandomState(2).randn(*x.shape).astype(np.float32)
    with pkg.autograd.record():
        y, aux = net(xs)
        loss = (y * pkg.nd.array(head, ctx=pkg.cpu())).sum() + 3.0 * aux
    loss.backward()
    grads = {n.split("_", 1)[1]: p.grad().asnumpy()
             for n, p in net.collect_params().items()}
    return y.asnumpy(), float(aux.asnumpy()), xs.grad.asnumpy(), grads


@pytest.mark.parametrize("k,cf,act,hybrid", [
    (1, 1.0, "gelu", False), (1, 0.5, "relu", True),
    (2, 1.25, "gelu", True), (2, 0.5, "silu", False)])
def test_sparse_moe_matches_reference(k, cf, act, hybrid):
    x = np.random.RandomState(1).randn(2, 6, 8).astype(np.float32)
    res = [_run(pkg, _moe(pkg, k, cf, act), x, hybrid) for pkg in PKGS]
    (y, aux, gx, gp), (wy, waux, wgx, wgp) = res[1], res[0]
    assert y.shape == x.shape
    assert sweep.rel_err(y, wy) <= OUT_TOL
    assert abs(aux - waux) <= OUT_TOL * abs(waux)
    assert sweep.rel_err(gx, wgx) <= GRAD_TOL
    assert sorted(gp) == sorted(wgp)
    for n in gp:
        assert sweep.rel_err(gp[n], wgp[n]) <= GRAD_TOL, n
    # the router learns through the gates
    assert np.abs(gp["gate_weight"]).sum() > 0


def test_capacity_drops_tokens():
    """12 tokens, 4 experts, k 1, factor 0.5: 2 slots an expert, so tokens
    past an expert's second claim contribute nothing."""
    net = _moe(mx, 1, 0.5, "relu")
    assert net.capacity(12) == 2
    x = torch.tensor(np.random.RandomState(1).randn(12, 8)
                     .astype(np.float32))
    params = {n.split("_", 1)[1]: p.data()._data
              for n, p in net.collect_params().items()}
    with torch.no_grad():
        y, _ = net(x)
        choice = torch.softmax(x @ params["gate_weight"], -1).argmax(-1)
    seen = {}
    for i, e in enumerate(choice.tolist()):
        seen[e] = seen.get(e, 0) + 1
        if seen[e] > 2:
            assert torch.all(y[i] == 0), i
    assert any(v > 2 for v in seen.values())


def test_sharding_hints_are_recorded():
    net = _moe(mx, 2, 1.25, "gelu")
    hints = {n.split("_", 1)[1]: p.sharding
             for n, p in net.collect_params().items()}
    assert hints["expert_w1"] == ("ep", None, None)
    assert hints["expert_b2"] == ("ep", None)
    assert hints["gate_weight"] is None
    with pytest.raises(MXNetError):
        SparseMoE(8, 12, 2, num_experts_per_token=3)


@pytest.mark.parametrize("hybrid", [False, True])
def test_concurrent_and_identity(hybrid):
    x = np.random.RandomState(3).randn(2, 5).astype(np.float32)
    outs = []
    for pkg in PKGS:
        def build():
            net = pkg.gluon.contrib.nn.HybridConcurrent(axis=1)
            net.add(pkg.gluon.nn.Dense(3, in_units=5),
                    pkg.gluon.contrib.nn.Identity(),
                    pkg.gluon.nn.Dense(2, in_units=5))
            net.initialize(ctx=pkg.cpu())
            return net
        net = _in_thread(build)
        rng = np.random.RandomState(4)
        for p in net.collect_params().values():
            p.set_data(pkg.nd.array(rng.randn(*p.shape).astype(np.float32),
                                    ctx=pkg.cpu()))
        if hybrid:
            net.hybridize()
        outs.append(net(pkg.nd.array(x, ctx=pkg.cpu())).asnumpy())
    assert outs[1].shape == (2, 10)
    np.testing.assert_allclose(outs[1][:, 3:8], x, rtol=0, atol=0)
    np.testing.assert_allclose(outs[1], outs[0], rtol=0, atol=1e-6)
    assert mx.gluon.contrib.Concurrent is mx.gluon.contrib.HybridConcurrent


def test_sync_batchnorm_is_batchnorm_on_one_device():
    x = mx.nd.array(np.random.RandomState(6).randn(4, 3, 5, 5)
                    .astype(np.float32))
    sync = mx.gluon.contrib.nn.SyncBatchNorm(num_devices=1, in_channels=3)
    plain = mx.gluon.nn.BatchNorm(in_channels=3)
    for net in (sync, plain):
        net.initialize(ctx=mx.cpu())
    assert sync._num_devices == 1 and sync._axis == 1
    with mx.autograd.record():
        a, b = sync(x), plain(x)
    np.testing.assert_array_equal(a.asnumpy(), b.asnumpy())
    np.testing.assert_array_equal(sync.running_mean.data().asnumpy(),
                                  plain.running_mean.data().asnumpy())
