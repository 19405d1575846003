"""The port's training path held against the JAX package's, f32 on the CPU:
MXNet's Adam update, the first step's gradients, and ``TrainStep`` loss
trajectories, on the same weights (carried across with ``convert``) and
the same batches.

The BERT and the llama are the port's Gluon Blocks (``TrainStep`` takes
them through ``collect_params()``; the padded case wraps the BERT in a
plain ``nn.Module``).

Tolerances: Adam weights 1e-6 relative (the same formula, other rounding
of the folded scalars); gradients 1e-4 of each parameter's max |grad| (the
two frameworks sum matmuls and softmax reductions in another order, and
the port's seq-256 attention is flash where the JAX CPU path is dense);
TrainStep losses 1e-4 relative, as the training oracle on the card.
"""

import ml_dtypes
import numpy as np
import pytest

import jax
import mxnet_tpu as mx
from mxnet_tpu import autograd, parallel as jparallel
from mxnet_tpu.gluon.block import Block
from mxnet_tpu.gluon.model_zoo import bert as jbert, llama as jllama
import torch

from mxnet_tpu_torch import convert, optimizer as topt, parallel
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops.nn import softmax_cross_entropy

L = 256
VOCAB = {"bert": 97, "llama": 101}
CASES = ["bert", "bert_padded", "llama"]
VALID = np.array([190, 256], np.int32)


class _WithLength(Block):
    """The JAX BERT with a fixed ``valid_length`` (TrainStep passes the
    tokens only)."""

    def __init__(self, net, valid_length):
        super().__init__()
        self.inner = net
        self.valid_length = mx.nd.array(valid_length)

    def forward(self, x):
        return self.inner(x, self.valid_length)


class _TorchWithLength(torch.nn.Module):
    def __init__(self, net, valid_length):
        super().__init__()
        self.inner = net
        self.valid_length = torch.tensor(valid_length)

    def forward(self, x):
        return self.inner(x, self.valid_length)


def _logits(out):
    return out[2] if isinstance(out, tuple) else out


def _jax_loss(out, labels):
    logits = _logits(out)
    return mx.nd.softmax_cross_entropy(
        logits.reshape((-1, logits.shape[-1])).astype("float32"),
        labels.reshape((-1,))) / labels.size


def _torch_loss(out, labels):
    logits = _logits(out)
    return softmax_cross_entropy(
        logits.reshape(-1, logits.shape[-1]).float(),
        labels.reshape(-1)) / labels.numel()


def _torch_names(port, gluon_params):
    """Torch parameter name -> Gluon name, for a port model holding the
    Gluon parameters ``gluon_params`` (name -> Parameter)."""
    by_tensor = {id(p.data()._data): name
                 for name, p in gluon_params.items()}
    return {t: by_tensor[id(p)] for t, p in port.named_parameters()}


def _build(case, seed=3):
    """(JAX net, port net, port name -> Gluon name) on the same weights."""
    if case.startswith("bert"):
        net = jbert.bert_model("bert_3_128_2", vocab_size=VOCAB["bert"],
                               max_length=L, dropout=0.0, prefix="bert_")
    else:
        net = jllama.llama_model("llama_tiny", vocab_size=VOCAB["llama"],
                                 prefix="llm_")
    # weights from numpy (Zero() then set_data is cheaper than tracing a
    # Normal draw per shape), by the initializer's by-name policy
    net.initialize(mx.initializer.Zero())
    r = np.random.RandomState(seed)
    params = {}
    for k, p in net.collect_params().items():
        w = r.normal(0.0, 0.02, p.shape).astype(np.float32)
        if k.endswith(("bias", "beta")):
            w[...] = 0.0
        elif k.endswith(("gamma", "norm_weight")):
            w[...] = 1.0
        p.set_data(mx.nd.array(w))
        params[k] = w
    if case.startswith("bert"):
        port = convert.bert_from_gluon(params, "bert_", "bert_3_128_2",
                                       device="cpu")
    else:
        port = convert.llama_from_gluon(params, "llm_", "llama_tiny",
                                        device="cpu")
    gluon_params = port.collect_params()
    if case == "bert_padded":
        net, port = _WithLength(net, VALID), _TorchWithLength(port, VALID)
    return net, port, _torch_names(port, gluon_params)


def _batches(case, steps):
    r = np.random.RandomState(17)
    v = VOCAB[case.split("_")[0]]
    return (r.randint(0, v, (steps, 2, L)).astype(np.int32),
            r.randint(0, v, (steps, 2, L)).astype(np.int32))


@pytest.fixture(scope="module")
def built():
    """JAX/port pairs by case, built on first use and shared by the
    gradient tests (which do not change the weights)."""
    cache = {}

    def get(case):
        if case not in cache:
            cache[case] = _build(case)
        return cache[case]
    return get


@pytest.mark.parametrize("mp", [False, True], ids=["f32", "bf16_mp"])
def test_adam_matches_jax(mp):
    kw = dict(learning_rate=0.01, wd=0.1, rescale_grad=0.5,
              clip_gradient=0.3, multi_precision=mp)
    jopt, topt_ = mx.optimizer.Adam(**kw), topt.create("adam", **kw)
    for o in (jopt, topt_):
        o.set_lr_mult({1: 0.5})
    r = np.random.RandomState(0)
    w0 = [r.randn(64, 3).astype(np.float32), r.randn(7).astype(np.float32)]
    if mp:
        w0 = [w.astype(ml_dtypes.bfloat16) for w in w0]
    jw = [mx.nd.array(w) for w in w0]
    tw = [torch.tensor(np.asarray(w, np.float32)).to(
        torch.bfloat16 if mp else torch.float32) for w in w0]
    jst = [jopt.create_state_multi_precision(i, w) for i, w in enumerate(jw)]
    tst = [topt_.create_state_multi_precision(i, w) for i, w in enumerate(tw)]
    for _ in range(4):
        for i in range(2):
            g = r.randn(*w0[i].shape).astype(np.float32)
            jg = mx.nd.array(g.astype(ml_dtypes.bfloat16) if mp else g)
            jopt.update_multi_precision(i, jw[i], jg, jst[i])
            topt_.update_multi_precision(i, tw[i], torch.tensor(g).to(
                tw[i].dtype), tst[i])
        for i in range(2):
            want = np.asarray(jw[i].asnumpy(), np.float32)
            np.testing.assert_allclose(tw[i].float().numpy(), want,
                                       rtol=1e-6 if not mp else 8e-3,
                                       atol=1e-7)
            if mp:   # the f32 masters, and m and v
                for j, t in zip((jst[i][0], *jst[i][1]),
                                (tst[i][0], *tst[i][1])):
                    np.testing.assert_allclose(t.numpy(), j.asnumpy(),
                                               rtol=1e-6, atol=1e-7)
    assert topt_.num_update == jopt.num_update == 4


def test_adam_treats_a_missing_gradient_as_zero():
    """The reference zero-fills gradients the loss does not reach, so with
    weight decay an unreached parameter still moves."""
    opt = topt.create("adam", learning_rate=0.1, wd=0.5)
    w = torch.ones(4)
    st = opt.create_state_multi_precision(0, w)
    opt.update_multi([0], [w], [None], [st])
    assert torch.all(w < 1.0)


@pytest.mark.parametrize("case", CASES)
def test_first_step_gradients_match_jax(built, case):
    jnet, port, to_gluon = built(case)
    toks, labs = (b[0] for b in _batches(case, 1))
    with autograd.record():
        loss = _jax_loss(jnet(mx.nd.array(toks)), mx.nd.array(labs))
    loss.backward()
    jgrads = {k: p.grad().asnumpy()
              for k, p in jnet.collect_params().items()}
    port.zero_grad(set_to_none=True)
    tloss = _torch_loss(port(torch.tensor(toks)), torch.tensor(labs))
    tloss.backward()
    np.testing.assert_allclose(float(tloss.detach()), float(loss.asnumpy()),
                               rtol=1e-5)
    for name, p in port.named_parameters():
        want = jgrads[to_gluon[name]]
        got = np.zeros_like(want) if p.grad is None else p.grad.numpy()
        scale = max(np.abs(want).max(), 1e-12)
        assert np.abs(got - want).max() <= 1e-4 * scale, name


@pytest.mark.parametrize("case", CASES)
def test_trainstep_losses_match_jax(case):
    jnet, port, to_gluon = _build(case, seed=4)
    toks, labs = _batches(case, 3)
    kw = dict(learning_rate=1e-3, wd=0.01)
    mesh = jparallel.DeviceMesh(shape=(1,), devices=jax.devices()[:1])
    jstep = jparallel.TrainStep(jnet, _jax_loss, mx.optimizer.Adam(**kw),
                                mesh=mesh)
    tstep = parallel.TrainStep(port, _torch_loss, "adam", optimizer_params=kw)
    want = [float(jstep(t, l).asnumpy()) for t, l in zip(toks, labs)]
    got = tstep.run(toks, labs).tolist()
    np.testing.assert_allclose(got, want, rtol=1e-4)
    # every trainable parameter moved as in the reference, the BERT pooler
    # (which the loss does not reach) by weight decay alone
    jparams = jnet.collect_params()
    for name, p in port.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(),
                                   jparams[to_gluon[name]].data().asnumpy(),
                                   rtol=0, atol=2e-5, err_msg=name)


@pytest.mark.parametrize("kw,match", [
    (dict(n_micro=0), "n_micro"),
    (dict(mesh=parallel.DeviceMesh((2, 2), ("dp", "sp"), devices=[
        "cpu", "cpu", "cuda:0", "cuda:0"])), "more than one device"),
    (dict(partition_rules=[("x", ())]), "partition_rules"),
    (dict(data_spec=("tp",)), "data_spec"), (dict(plan=object()), "plan"),
    (dict(mesh=["cpu", "cuda:0"]), "more than one device")])
def test_trainstep_refuses_what_is_not_ported(kw, match):
    """A mesh over distinct devices, sharding rules and plans wait for
    the sharding slice; a data_spec axis the (default one-device) mesh
    lacks raises as in the reference.  Meshes whose shards share the
    net's device run (``tests/test_torch_sp_llama.py``)."""
    with pytest.raises(MXNetError, match=match):
        parallel.TrainStep(torch.nn.Linear(2, 2), _torch_loss, "adam", **kw)
