"""``gluon.SymbolBlock`` of the port held against the JAX package's on the
CPU: a checkpoint that the reference's ``Module`` wrote, served by the
port's ``SymbolBlock.imports`` (and the other way round), equal to the
writer's ``predict``; a rebind when the batch changes; the reference's
error for an unbound label; the callable path; a graph without
parameters; the encoder's internal head with ``valid_length``; and the
bf16 serving path (``amp.init`` + ``amp.convert_model``).

Tolerances: float32 outputs within rtol 1e-4, atol 1e-5; bfloat16
outputs within 2e-2 of max |f32| (bf16 keeps 8 bits).
"""

import os

import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from mxnet_tpu_torch.base import MXNetError

from _torch_sym_nets import NETS, encoder, inputs, mlp

RTOL, ATOL = 1e-4, 1e-5


@pytest.fixture(autouse=True)
def _on_cpu():
    with mx.cpu():
        yield


def _close(got, want, what, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol, err_msg=what)


def _train_and_save(pkg, tmp_path):
    """A small MLP trained by ``pkg``'s Module and checkpointed; returns
    (prefix, the writer's predictions on ``probe``, probe)."""
    rng = np.random.RandomState(0)
    xs = rng.randn(64, 10).astype(np.float32)
    ys = rng.randint(0, 4, (64,)).astype(np.float32)
    vals = inputs(mlp(mx), NETS["mlp"][1], seed=1)
    mod = pkg.mod.Module(mlp(pkg), context=pkg.cpu())
    it = pkg.io.NDArrayIter(xs, ys, batch_size=16,
                            label_name="softmax_label")
    mod.fit(it, num_epoch=2, optimizer_params=(("learning_rate", 0.1),
                                                ("rescale_grad", 1 / 16)),
            arg_params={k: pkg.nd.array(v) for k, v in vals.items()
                        if k.startswith("fc")})
    prefix = os.path.join(str(tmp_path), f"small_{pkg.__name__}")
    mod.save_checkpoint(prefix, 2)
    probe = xs[:8]
    ref = mod.predict(pkg.io.NDArrayIter(probe, batch_size=8))[0].asnumpy()
    return prefix, ref, probe


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_imports_a_checkpoint_and_rebinds(tmp_path, writer):
    src, dst = (jmx, mx) if writer == "reference" else (mx, jmx)
    prefix, ref, probe = _train_and_save(src, tmp_path)
    loaded = dst.sym.load(f"{prefix}-symbol.json")
    infer = dst.sym.softmax(loaded.get_internals()["fc2_output"])
    blk = dst.gluon.SymbolBlock.imports(infer, ["data"],
                                        f"{prefix}-0002.params")
    _close(blk(dst.nd.array(probe)).asnumpy(), ref, "imports")
    _close(blk(dst.nd.array(probe[:4])).asnumpy(), ref[:4], "rebind")


def test_unbound_label_raises_the_references_error(tmp_path):
    prefix, _, probe = _train_and_save(jmx, tmp_path)
    msgs = []
    for pkg, err in ((jmx, jmx.MXNetError), (mx, MXNetError)):
        blk = pkg.gluon.SymbolBlock.imports(f"{prefix}-symbol.json",
                                            ["data"],
                                            f"{prefix}-0002.params")
        with pytest.raises(err, match="softmax_label") as got:
            blk(pkg.nd.array(probe))
        msgs.append(str(got.value))
    assert msgs[1] == msgs[0]
    with pytest.raises(MXNetError, match="positionally"):
        blk(data=mx.nd.array(probe))


def test_callable_and_parameterless_graph(tmp_path):
    blk = mx.gluon.SymbolBlock(lambda a: a * 2)
    np.testing.assert_array_equal(blk(mx.nd.ones((2, 2))).asnumpy(),
                                  np.full((2, 2), 2.0, np.float32))
    with mx.name.NameManager():
        y = mx.sym.FullyConnected(mx.sym.Variable("data"), num_hidden=2,
                                  name="fc")
    path = os.path.join(str(tmp_path), "g-symbol.json")
    y.save(path)
    out = mx.gluon.SymbolBlock.imports(path, "data")(mx.nd.ones((3, 4)))
    assert out.shape == (3, 2)
    np.testing.assert_array_equal(out.asnumpy(), np.zeros((3, 2)))


def _encoder_checkpoint(tmp_path):
    """The one-layer encoder's seeded parameters saved by the reference as
    a checkpoint; returns (prefix, data, valid_length)."""
    shapes = NETS["encoder"][1]
    js = encoder(jmx)
    vals = inputs(js, shapes, seed=9)
    prefix = os.path.join(str(tmp_path), "enc")
    jmx.model.save_checkpoint(
        prefix, 1, js,
        {k: jmx.nd.array(v) for k, v in vals.items() if k not in shapes},
        {})
    return prefix, vals["data"], vals["valid_length"]


def _serve(pkg, prefix, data, vl, bf16=False):
    """The checkpoint's head served through ``pkg``'s SymbolBlock (bf16:
    the port only, under ``amp.init`` after ``convert_model``)."""
    sym, arg, aux = pkg.model.load_checkpoint(prefix, 1)
    if bf16:
        pkg.amp.init()
        sym, arg, aux = pkg.amp.convert_model(sym, arg, aux)
    head = sym.get_internals()["head_output"]
    path = prefix + ("-bf16" if bf16 else "") + f"-{pkg.__name__}"
    pkg.model.save_checkpoint(path, 1, head, arg, aux)
    blk = pkg.gluon.SymbolBlock.imports(head, ["data", "valid_length"],
                                        f"{path}-0001.params",
                                        ctx=pkg.cpu())
    try:
        out = blk(pkg.nd.array(data), pkg.nd.array(vl))
        return out.astype("float32").asnumpy(), blk
    finally:
        if bf16:
            pkg.amp.off()


def test_encoder_head_with_valid_length(tmp_path):
    prefix, data, vl = _encoder_checkpoint(tmp_path)
    want, _ = _serve(jmx, prefix, data, vl)
    got, blk = _serve(mx, prefix, data, vl)
    assert got.shape == (2, 256, 50)
    _close(got, want, "encoder head")
    small = blk(mx.nd.array(data[:1]), mx.nd.array(vl[:1])).asnumpy()
    _close(small, want[:1], "rebind at batch 1")


def test_bf16_serving_through_convert_model(tmp_path):
    prefix, data, vl = _encoder_checkpoint(tmp_path)
    f32, _ = _serve(mx, prefix, data, vl)
    got, blk = _serve(mx, prefix, data, vl, bf16=True)
    ex = blk._sb_executor
    assert str(ex.arg_dict["l0_qkv_weight"].dtype) == "torch.bfloat16"
    assert str(ex.arg_dict["l0_ln1_gamma"].dtype) == "float32"
    scale = np.abs(f32).max()
    _close(got, f32, "bf16 vs f32", rtol=0, atol=2e-2 * scale)
