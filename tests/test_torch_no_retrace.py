"""``analysis.no_retrace`` and ``compile_count`` on the port, on the CPU:
a steady state builds nothing (the dynamic half of graftcheck GC02).

The port counts a build at each per-signature cache miss
(``analysis/runtime.py``): a ``TrainStep`` signature (on the host its
first call; on the card its capture), a bucket plan of the fused kvstore,
a ``PipelinedBlock``'s stacked stages, a fused optimizer signature.  These
mirror the reference's ``test_graftcheck.py::test_trainer_steady_state_no_retrace``,
``test_optimizer_fusion.py`` (its steady pushpull) and
``test_serving.py::test_no_retrace_mixed_lengths``; each stands on the
port's own behaviour."""

import numpy as np
import pytest
import torch

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import autograd, gluon, nd, parallel
from mxnet_tpu_torch.analysis import runtime
from mxnet_tpu_torch.analysis.runtime import RetraceError, no_retrace
from mxnet_tpu_torch.gluon import nn
from mxnet_tpu_torch.ops import nn as ops_nn


@pytest.fixture(autouse=True)
def _on_host():
    with mx.cpu():
        yield


def _mlp():
    net = nn.HybridSequential()
    with net.name_scope():
        net.add(nn.Dense(16, activation="relu", in_units=8))
        net.add(nn.Dense(4, in_units=16))
    net.initialize(mx.init.Normal(0.1), ctx=mx.cpu())
    return net


def _loss(out, label):
    return ops_nn.softmax_cross_entropy(out, label) / label.numel()


def test_trainstep_steady_state_builds_nothing():
    step = parallel.TrainStep(_mlp(), _loss, "adam",
                              optimizer_params={"learning_rate": 1e-2})
    r = np.random.RandomState(0)
    x = torch.tensor(r.randn(6, 8).astype(np.float32))
    y = torch.tensor(r.randint(0, 4, (6,)))
    before = runtime.build_counts().get("parallel.TrainStep", 0)
    step(x, y)                              # the signature's build
    assert runtime.build_counts()["parallel.TrainStep"] == before + 1
    with no_retrace():
        losses = [float(step(x, y)) for _ in range(3)]
    assert losses[-1] < losses[0]
    # a new batch shape is a new signature: the guard fires and names it
    with pytest.raises(RetraceError, match="parallel.TrainStep"):
        with no_retrace():
            step(x[:3], y[:3])
    with no_retrace(allow=1):
        step(x[:2], y[:2])
    with no_retrace():
        step(x[:2], y[:2])


def test_gluon_trainer_steady_state_builds_nothing():
    net = _mlp()
    x = nd.array(np.random.RandomState(1).randn(8, 8).astype(np.float32))
    y = nd.array(np.random.RandomState(2).randn(8, 4).astype(np.float32))
    lossf = gluon.loss.L2Loss()
    tr = gluon.Trainer(net.collect_params(), "sgd",
                       {"learning_rate": 0.01})

    def one():
        with autograd.record():
            loss = lossf(net(x), y).mean()
        loss.backward()
        tr.step(1)

    for _ in range(2):
        one()
    with no_retrace():
        one()


def test_fused_pushpull_steady_state_builds_nothing():
    kv = mx.kv.create("local")
    shapes = [(16, 4), (4,), (4, 16), (16,)]
    keys = [f"w{i}" for i in range(len(shapes))]
    r = np.random.RandomState(3)
    grads, outs = [], []
    for k, s in zip(keys, shapes):
        kv.init(k, nd.zeros(s))
        grads.append([nd.array(r.randn(*s).astype(np.float32))
                      for _ in range(2)])
        outs.append(nd.zeros(s))
    before = runtime.build_counts().get("kvstore.fusion", 0)
    kv.pushpull_list(keys, grads, outs)         # the plan's build
    assert runtime.build_counts()["kvstore.fusion"] == before + 1
    with no_retrace():
        for _ in range(3):
            kv.pushpull_list(keys, grads, outs)
    np.testing.assert_array_equal(
        outs[0].asnumpy(), grads[0][0].asnumpy() + grads[0][1].asnumpy())
    # another set of keys is another plan
    with pytest.raises(RetraceError, match="kvstore.fusion"):
        with no_retrace():
            kv.pushpull_list(keys[:2], grads[:2], outs[:2])


def test_serving_mixed_lengths_build_nothing():
    from mxnet_tpu_torch import serving
    from mxnet_tpu_torch.gluon.model_zoo import llama
    net = llama.llama_model("llama_tiny", vocab_size=61, prefix="llm_")
    mx.random.seed(5)
    net.initialize(mx.init.Normal(0.05), ctx=mx.cpu())
    eng = serving.ServingEngine(net, eos_id=-1, max_batch=4, block_tokens=4,
                                max_seq=64, prefill_tokens=16)
    eng.generate([[5, 6, 7], [8, 9, 10, 11, 12]], max_new_tokens=6)
    with no_retrace():
        outs = eng.generate(
            [[1], [2, 3], [4, 5, 6, 7], [9] * 11, [10, 11], [12] * 7],
            max_new_tokens=9)
    assert len(outs) == 6 and all(len(o) == 9 for o in outs)


def test_pipeline_builds_once():
    from mxnet_tpu_torch.pipeline import PipelinedBlock
    blocks = []
    for _ in range(2):
        b = nn.Dense(8, in_units=8)
        b.initialize(mx.init.Normal(0.1), ctx=mx.cpu())
        blocks.append(b)
    mesh = parallel.DeviceMesh((2,), ("pp",), devices=[mx.cpu(0)] * 2)
    pipe = PipelinedBlock(blocks, mesh, n_microbatches=2)
    x = nd.array(np.random.RandomState(4).randn(4, 8).astype(np.float32))
    with pytest.raises(RetraceError, match="pipeline.PipelinedBlock"):
        with no_retrace():
            pipe(x)
    with no_retrace():
        y = pipe(x)
    assert y.shape == (4, 8)


def test_compile_count_is_monotonic_and_by_site():
    n0, sites0 = runtime.compile_count(), runtime.build_counts()
    runtime.note_build("test.site")
    assert runtime.compile_count() == n0 + 1
    assert runtime.build_counts()["test.site"] \
        == sites0.get("test.site", 0) + 1


def test_dense_attention_builds_its_constants_on_the_device():
    """The attention paths below the flash floor run inside captured
    steps (the perf gate's bert_headline lane, seq 32).  A tensor made
    from a Python number (``aten.lift_fresh``) is a host copy on the
    card, which a CUDA graph capture refuses: they build theirs with a
    fill kernel."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from mxnet_tpu_torch.ops import contrib

    class Ops(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.names = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.names.append(str(func))
            return func(*args, **(kwargs or {}))

    r = np.random.RandomState(6)
    q, k, v = (torch.tensor(r.randn(2, 2, 16, 8).astype(np.float32))
               for _ in range(3))
    seg = torch.ones(2, 16, dtype=torch.int32)
    qkv = torch.tensor(r.randn(16, 2, 48).astype(np.float32))
    with Ops() as ops:
        contrib._dense_sdpa(q, k, v, seg, True, 0.5)
        contrib._dense_sdpa_cross(q, k, v, seg, 0.5, causal=True)
        contrib.masked_selfatt(qkv, None, heads=2, causal=True)
        contrib._div_sqrt_dim(q)
        contrib._inv_sqrt(8, q)
    assert "aten.full.default" in ops.names
    assert "aten.lift_fresh.default" not in ops.names
