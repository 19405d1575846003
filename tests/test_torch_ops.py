"""The port's operator registry held against the JAX package's, on the
CPU: the port twin of ``tests/test_op_sweep.py``'s three tiers over every
op the port registers (each once; the samplers are in
``test_torch_random.py``), on the inputs of ``mxnet_tpu_torch.ops.sweep``:

 1. ``test_matches_reference``: the op on the same float32 numpy inputs
    through both packages; outputs (with their dtypes) and the gradients of
    sum(out * w) agree within ``sweep.TOL`` of max |ref| (1e-5 elementwise,
    1e-4 for reductions, products, linear algebra and attention, which sum
    in another order), and the decompositions by their invariants
    (reconstruction and orthogonality to 1e-4 of |A|, values 1e-4);
 2. ``test_numpy_oracle``: an op named like a numpy function, without
    attributes, against numpy (rtol 2e-5, atol 2e-6, as the reference's);
 3. ``test_numeric_gradient``: a directional finite-difference check of
    each differentiable op in float64 (relative 5e-3, as the reference's),
    apart from ``FD_SKIP``.

Beside them the coverage meta-tests: the reference's registry less the
port's is exactly ``UNPORTED``, and every alias of the reference's table
resolves to the op its target names.
"""

import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from mxnet_tpu_torch.ops import registry, sweep

OPS = sweep.sweep_ops()

# the reference ops the port does not register yet, each with the ROADMAP
# item that ports it
UNPORTED = {
    "contrib.sp_att_qkv": "A.9",
    **{n: "A.10" for n in (
        "contrib.quantize_v2", "contrib.dequantize", "contrib.requantize",
        "contrib.quantized_dot", "contrib.quantized_fully_connected",
        "contrib.quantized_conv", "_sparse_dot_csr", "_sparse_retain_values",
        "_square_sum_rs", "contrib.getnnz")},
}

ALIASES = {
    "SequenceMask": "sequence_mask", "SequenceLast": "sequence_last",
    "SequenceReverse": "sequence_reverse", "SwapAxis": "swapaxes",
    "MakeLoss": "make_loss", "BlockGrad": "stop_gradient", "Pad": "pad",
    "Cast": "cast", "Reshape": "reshape", "Flatten": "flatten",
    "Concat": "concat", "Softmax": "SoftmaxOutput",
    "SliceChannel": "slice_channel", "ElementWiseSum": "add_n",
    "l2_normalization": "L2Normalization",
    "logical_xor": "broadcast_logical_xor",
    "contrib.boolean_mask": "boolean_mask",
}


@pytest.fixture(autouse=True)
def _on_cpu():
    with mx.cpu():
        yield


def test_unported_names_are_exactly_the_assigned_ones():
    """The reference's operator names (``np.*``, the ``mx.np`` layer that
    importing ``mxnet_tpu.numpy`` registers, is ROADMAP A.10's) less the
    port's."""
    from mxnet_tpu.ops import registry as jreg
    reference = {n for n in jreg.list_ops() if not n.startswith("np.")}
    missing = reference - set(registry.list_ops())
    assert missing == set(UNPORTED)
    assert not set(registry.list_ops()) - reference
    assert len(reference) == 339 and len(registry.list_ops()) == 328


def test_aliases_resolve_to_their_targets():
    from mxnet_tpu.ops import _ALIASES as jaliases
    assert jaliases == ALIASES
    for alias, target in ALIASES.items():
        assert registry.get(alias) is registry.get(target), alias


def test_every_swept_op_is_registered_once():
    assert len(OPS) == len(set(OPS))
    assert not set(OPS) & sweep.SAMPLERS
    for name in OPS:
        arrays, attrs = sweep.op_inputs(name)
        assert isinstance(attrs, dict) and all(
            isinstance(a, np.ndarray) for a in arrays), name


# ops whose output dtype is the reference's fault, with the port's dtype:
# the values are still compared
DTYPE_DIFFERS = {
    # optax.ctc_loss promotes float32 logits to float64 under JAX's x64;
    # MXNet's ctc_loss keeps the data's dtype
    "ctc_loss": np.float32,
}


@pytest.mark.parametrize("name", OPS)
def test_matches_reference(name):
    arrays, attrs = sweep.op_inputs(name)
    got, got_g = sweep.run(mx, name, arrays, attrs, mx.cpu())
    want, want_g = sweep.run(jmx, name, arrays, attrs, jmx.cpu())
    if name in DTYPE_DIFFERS:
        assert [g.dtype for g in got] == [DTYPE_DIFFERS[name]] * len(got)
    else:
        assert [g.dtype for g in got] == [w.dtype for w in want], name
    err, tol = sweep.close(name, got, want, arrays)
    assert err <= tol, f"{name}: outputs differ by {err:.3g} > {tol}"
    assert len(got_g) == len(want_g), name
    for g, w in zip(got_g, want_g):
        e = sweep.rel_err(g, w)
        assert e <= sweep.TOL["reduction"], \
            f"{name}: gradients differ by {e:.3g}"


_NUMPY_ORACLE_SKIP = {
    "clip": "takes a_min/a_max attributes, not positional arguments",
}


@pytest.mark.parametrize("name", [
    n for n in OPS if callable(getattr(np, n, None))])
def test_numpy_oracle(name):
    if name in _NUMPY_ORACLE_SKIP:
        pytest.skip(_NUMPY_ORACLE_SKIP[name])
    arrays, attrs = sweep.op_inputs(name)
    if attrs:
        pytest.skip("an op with attributes: no 1:1 numpy call")
    try:
        want = np.asarray(getattr(np, name)(*arrays))
    except TypeError:
        pytest.skip("numpy's function of that name takes other arguments")
    got = registry.invoke(registry.get(name),
                          [mx.nd.array(a, dtype=a.dtype) for a in arrays])
    got = (got[0] if isinstance(got, list) else got).asnumpy()
    assert got.size == want.size, name
    np.testing.assert_allclose(got.reshape(want.shape), want, rtol=2e-5,
                               atol=2e-6, err_msg=name)


# ops whose directional finite difference says nothing, with the reason
FD_SKIP = {
    "sign": "piecewise constant", "floor": "piecewise constant",
    "ceil": "piecewise constant", "round": "piecewise constant",
    "rint": "piecewise constant", "fix": "piecewise constant",
    "trunc": "piecewise constant",
    "abs": "kink at 0", "relu": "kink at 0", "clip": "kinks at the bounds",
    "hard_sigmoid": "kinks", "LeakyReLU": "kink at 0",
    "BatchNormWithReLU": "relu kink at 0 after the normalization",
    "smooth_l1": "kink at |x| = 1 / scalar^2",
    "topk": "selection", "sort": "permutation", "max": "selection",
    "min": "selection",
    "broadcast_mod": "kinks at multiples",
    "broadcast_maximum": "kink where the operands meet",
    "broadcast_minimum": "kink where the operands meet",
    "_mod_scalar": "kinks at multiples",
    "_maximum_scalar": "kink at the scalar",
    "_minimum_scalar": "kink at the scalar",
    "BlockGrad": "gradient zero by definition, not d(forward)/dx",
    "contrib.gradient_multiplier": "gradient scaled by definition, not "
                                   "d(forward)/dx",
    "Softmax": "loss head: backward p - onehot(label)",
    "SVMOutput": "loss head: backward the hinge gradient",
    "LinearRegressionOutput": "loss head: backward out - label",
    "MAERegressionOutput": "loss head: backward sign(out - label)",
    "LogisticRegressionOutput": "loss head: backward sigmoid - label",
    "softmax_cross_entropy": "the label input is an integer selector",
    "center_loss": "loss head with a center update: the centers take no "
                   "gradient by definition",
    "where": "the condition input is a selector",
    "nansum": "a NaN input makes every finite difference NaN",
    "nanprod": "a NaN input makes every finite difference NaN",
    "contrib.fft": "computes in float32 whatever the input (the "
                   "reference's layout contract): float64 FD precision lost",
    "contrib.ifft": "float32 inside, as contrib.fft",
    "contrib.hawkes_ll": "marks and valid_length are selectors; the state "
                         "output carries no loss gradient",
    "linalg.tensorinv": "FD through an inverse amplifies eps by cond^2",
    "linalg.gelqf": "QR-based; the reference defines no gradient",
    "gamma": "FD overflow on the sign switch (cos(pi x)) of the formula",
    "Cast": "float16 output: FD precision lost",
    "amp_cast": "float16 output: FD precision lost",
    "amp_multicast": "dtype harmonizer; a float16 input",
    "Dropout": "identity outside training; stochastic inside",
    "SequenceReverse": "time steps are selectors",
    "BatchNorm": "record() normalizes with the batch statistics, the "
                 "finite differences outside it with the moving ones",
    "contrib.masked_att_qkv": "float32 softmax core: float64 FD "
                              "precision lost (gradients held against the "
                              "reference in test_matches_reference)",
    "contrib.masked_encdec_att": "float32 softmax core, as masked_att_qkv",
    "contrib.masked_selfatt": "float32 softmax core, as masked_att_qkv",
    "contrib.multihead_attention": "float32 softmax core, as "
                                   "masked_att_qkv",
}

# ops whose trailing float inputs are selectors: the FD checks the first
# (the ROI poolings' rois carry the batch index and pixel-snapped bin
# edges, whose gradient is 0 by definition)
FD_DATA_INPUT_ONLY = {"SequenceLast", "SequenceMask", "pick",
                      "contrib.count_sketch", "ROIPooling",
                      "contrib.PSROIPooling"}


@pytest.mark.parametrize("name", [
    n for n in OPS if registry.get(n).differentiable and n not in FD_SKIP
    and "update" not in n])
def test_numeric_gradient(name):
    arrays, attrs = sweep.op_inputs(name)
    float_idx = [i for i, a in enumerate(arrays) if a.dtype.kind == "f"]
    if name in FD_DATA_INPUT_ONLY:
        float_idx = float_idx[:1]
    if not float_idx:
        pytest.skip("no float input")
    op = registry.get(name)

    def f(*xs):
        out = registry.invoke(op, list(xs), dict(attrs))
        out = out[0] if isinstance(out, list) else out
        return out.astype("float64").sum()

    ins = [mx.nd.array(a.astype(np.float64)) if i in float_idx
           else mx.nd.array(a, dtype=a.dtype) for i, a in enumerate(arrays)]
    for i in float_idx:
        ins[i].attach_grad()
    with mx.autograd.record():
        y = f(*ins)
    y.backward()
    eps = 1e-5
    r = np.random.RandomState(1)
    for i in float_idx:
        d = r.randn(*ins[i].shape)
        d /= max(np.linalg.norm(d), 1e-12)
        base = ins[i].asnumpy()
        args_p = [mx.nd.array(base + eps * d) if j == i else ins[j]
                  for j in range(len(ins))]
        args_m = [mx.nd.array(base - eps * d) if j == i else ins[j]
                  for j in range(len(ins))]
        fd = (float(f(*args_p).asnumpy()) - float(f(*args_m).asnumpy())) \
            / (2 * eps)
        an = float((ins[i].grad.asnumpy() * d).sum())
        denom = max(abs(fd), abs(an), 1e-6)
        assert abs(fd - an) / denom < 5e-3, \
            f"{name} input {i}: directional grad {an} vs FD {fd}"


def test_new_ops_in_a_hybridized_block():
    """The new namespaces and the ops that take their device from dispatch
    (creation ops, samplers) run through a hybridized block's ``F`` as
    through ``mx.nd``."""
    class Net(mx.gluon.HybridBlock):
        def hybrid_forward(self, F, x):
            y = F.linalg.gemm2(x, x, transpose_b=True, alpha=0.5)
            y = F.squeeze(F.expand_dims(y, axis=0)) + F.eye(N=4)
            noise = F.random.uniform(low=0.0, high=1.0, shape=(4, 4))
            return F.BlockGrad(y) + 0.0 * noise + F.contrib.quadratic(
                F.Concat(x, x, dim=0)[:4, :4], a=1.0)

    x = mx.nd.array(np.random.RandomState(0).randn(4, 4).astype(np.float32))
    net = Net()
    want = net(x).asnumpy()
    net.hybridize()
    np.testing.assert_allclose(net(x).asnumpy(), want, rtol=1e-6)
