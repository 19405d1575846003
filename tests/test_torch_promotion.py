"""Mixed float inputs (ROADMAP C.12-13) held against the JAX package on the
CPU: every name of ``sweep.sweep_ops()`` that takes a float input runs on
the sweep's inputs with its first float input cast to bfloat16, through
both packages' ``ops.registry.invoke``, once plainly and once under
``amp.init()`` in both.  The output dtypes must be the reference's (jnp's
promotion: bfloat16 with float32 gives float32), and the values agree
within ``TOL_BF16`` of max |ref|; where the reference raises (jax's
convolutions want equal dtypes), the port raises too.  On the values: the
bfloat16 input is the same in both, but a chain of bfloat16 arithmetic rounds at other points in XLA than in
torch (2^-8 a rounding; 2e-2 allows five).  The ops that the registry
promotes (``Op.promote``) compute in float32 from the same rounded input in
both packages, so their float32 outputs are held to the sweep's own
``TOL``, but for ``ROUND_FIRST``: the reference normalizes, or scales q,
in bfloat16 before it meets a float32 input, and the port promotes first
(its values differ by about one bfloat16 rounding).

Where the port differs on purpose (ROADMAP C.7): the ``*_update`` ops keep
the weight's dtype (MXNet writes into ``out`` in its own dtype; the
reference widens it), and ``ctc_loss`` returns the data's dtype (the
reference's optax gives float64).
"""

import numpy as np
import pytest

import mxnet_tpu as jmx
from mxnet_tpu import amp as jamp
import torch

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import amp as tamp
from mxnet_tpu_torch.ops import registry, sweep

TOL_BF16 = 2e-2

ROUND_FIRST = {"LayerNorm", "GroupNorm", "InstanceNorm",
               "contrib.masked_att_qkv", "contrib.masked_encdec_att",
               "contrib.multihead_attention", "contrib.sp_att_qkv"}

OPS = [n for n in sweep.sweep_ops()
       if any(a.dtype.kind == "f" for a in sweep.op_inputs(n)[0])]


@pytest.fixture(autouse=True)
def _cpu_and_amp_off():
    with mx.cpu():
        try:
            yield
        finally:
            tamp.off()
            jamp.off()


def _run(pkg, name, ctx):
    """``name``'s outputs with its first float input in bfloat16:
    [(dtype name, float64 values)]."""
    arrays, attrs = sweep.op_inputs(name)
    reg = pkg.ops.registry
    ins = [pkg.nd.array(a, ctx=ctx, dtype=a.dtype) for a in arrays]
    first = next(i for i, a in enumerate(arrays) if a.dtype.kind == "f")
    ins[first] = ins[first].astype("bfloat16")
    out = reg.invoke(reg.get(name), ins, dict(attrs), ctx=ctx)
    outs = out if isinstance(out, list) else [out]
    return [(np.dtype(o.dtype).name if "bfloat16" not in str(o.dtype)
             else "bfloat16",
             o.astype("float32").asnumpy().astype(np.float64))
            for o in outs]


def _port_dtypes(name, want):
    """The dtypes the port returns where it differs from the reference on
    purpose (ROADMAP C.7)."""
    if name.endswith("_update") or name == "lamb_update_phase2":
        # the weight keeps its dtype; the states are float32 in both
        return ["bfloat16"] + want[1:]
    if name == "ctc_loss":
        return ["bfloat16"]
    return want


@pytest.mark.parametrize("amp", [False, True], ids=["plain", "amp"])
@pytest.mark.parametrize("name", OPS)
def test_bf16_first_input_matches_reference(name, amp):
    if amp:
        jamp.init()
        tamp.init()
    try:
        want = _run(jmx, name, jmx.cpu())
    except Exception:                                   # noqa: BLE001
        # jax refuses mixed inputs here (lax.conv wants equal dtypes):
        # so does the port
        with pytest.raises(Exception):
            _run(mx, name, mx.cpu())
        return
    got = _run(mx, name, mx.cpu())
    assert [d for d, _ in got] == _port_dtypes(name, [d for d, _ in want]), \
        name
    arrays = sweep.op_inputs(name)[0]
    err, _ = sweep.close(name, [v for _, v in got], [v for _, v in want],
                         arrays, tol=TOL_BF16)
    strict = registry.get(name).promote is not None \
        and name not in ROUND_FIRST
    tol = sweep.TOL[sweep.tol_class(name)] if strict and all(
        d == "float32" for d, _ in want) else TOL_BF16
    assert err <= tol, f"{name}: outputs differ by {err:.3g} > {tol}"


PROMOTED = ["FullyConnected", "dot", "batch_dot", "matmul", "einsum",
            "linalg.gemm", "linalg.gemm2", "linalg.trmm", "linalg.solve",
            "linalg.trsm", "contrib.masked_att_qkv",
            "contrib.masked_encdec_att", "contrib.multihead_attention",
            "contrib.multihead_attention_qk",
            "contrib.multihead_attention_valatt",
            "contrib.interleaved_matmul_encdec_qk",
            "contrib.interleaved_matmul_encdec_valatt",
            "contrib.interleaved_matmul_selfatt_valatt",
            "contrib.DeformableConvolution", "RNN", "LayerNorm",
            "GroupNorm", "InstanceNorm", "contrib.PSROIPooling",
            "contrib.allclose"]


def test_promotion_is_an_attribute_of_the_registered_ops():
    """C.12's ops promote at dispatch, ``index_add``/``index_copy`` write
    in their destination's dtype, and the ops whose CPU kernel lacks
    bfloat16 compute there in float32; no ``*_update`` op promotes."""
    for name in PROMOTED:
        assert registry.get(name).promote == "common", name
    for name in ("index_add", "index_copy"):
        assert registry.get(name).promote == "first", name
    for name in ("RNN", "ctc_loss", "linalg.potri", "linalg.trsm"):
        assert registry.get(name).host_f32, name
    for name in registry.list_ops():
        if "update" in name:
            assert registry.get(name).promote is None, name


def test_allclose_compares_in_the_promoted_dtype():
    """C.13: bfloat16(1.001) is 1.0, which is not close to float32 1.001
    at rtol 1e-5 (the port rounded ``b`` to ``a``'s dtype and said 1)."""
    for pkg, ctx in ((jmx, jmx.cpu()), (mx, mx.cpu())):
        a = pkg.nd.array([1.001], ctx=ctx).astype("bfloat16")
        b = pkg.nd.array([1.001], ctx=ctx)
        assert float(pkg.nd.contrib.allclose(a, b).asnumpy()) == 0.0
        assert float(pkg.nd.contrib.allclose(
            a, b.astype("bfloat16")).asnumpy()) == 1.0


def test_sgd_update_keeps_the_weight_bfloat16():
    """ROADMAP C.7: ``nd.sgd_update(w_bf16, g_f32, lr=0.1, out=w)`` leaves
    ``w`` bfloat16, with the value of the float32 update rounded once."""
    r = np.random.RandomState(0)
    w0, g0 = r.randn(4, 5).astype(np.float32), r.randn(4, 5) \
        .astype(np.float32)
    w = mx.nd.array(w0).astype("bfloat16")
    g = mx.nd.array(g0)
    mx.nd.sgd_update(w, g, lr=0.1, wd=0.0, out=w)
    assert w.dtype == torch.bfloat16
    wb = torch.tensor(w0).bfloat16().float()
    want = (wb - 0.1 * torch.tensor(g0)).bfloat16()
    assert torch.equal(w._data, want)


def test_mixed_fully_connected_gradients_keep_each_inputs_dtype():
    """The gradient of a promoted op reaches each input in its own dtype
    (the cast is differentiated), and equals the reference's."""
    r = np.random.RandomState(0)
    x0 = r.randn(3, 8).astype(np.float32)
    w0 = r.randn(4, 8).astype(np.float32)
    grads = {}
    for pkg, ctx in ((jmx, jmx.cpu()), (mx, mx.cpu())):
        x = pkg.nd.array(x0, ctx=ctx).astype("bfloat16")
        w = pkg.nd.array(w0, ctx=ctx)
        x.attach_grad()
        w.attach_grad()
        with pkg.autograd.record():
            y = pkg.nd.FullyConnected(x, w, num_hidden=4, no_bias=True)
            loss = (y * y).sum()
        loss.backward()
        assert "float32" in str(y.dtype)
        assert "bfloat16" in str(x.grad.dtype)
        grads[pkg] = (x.grad.astype("float32").asnumpy(), w.grad.asnumpy())
    for g, w in zip(grads[mx], grads[jmx]):
        assert sweep.rel_err(g, w) <= TOL_BF16
