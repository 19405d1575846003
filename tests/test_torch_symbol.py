"""``mx.sym`` of the port held against the JAX package's on the CPU: graphs
built alike in both packages (``_torch_sym_nets.py``) list the same
arguments, outputs and auxiliary states, infer the same shapes and write
the same json, which loads in the other package; auto-names under
``NameManager``, ``Prefix`` and ``AttrScope``; the executor's outputs,
gradients (``grad_req`` write and add) and BatchNorm's moving statistics
for an MLP, a conv/BatchNorm net and a one-layer ``masked_selfatt``
encoder at L = 256; the control flow of ``mx.sym.contrib``;
``mx.viz.print_summary``; ``amp.convert_model``; and ``library.load``
reaching ``mx.sym``.

Tolerances: outputs and gradients within rtol 1e-4, atol 1e-5 (float32
sums in another order; the encoder's attention runs the flash kernel's
plain version here, the reference its dense path); shapes, names, json
and printed text equal.
"""

import contextlib
import importlib.util
import io
import json
import os

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops import registry

from _torch_sym_nets import NETS, inputs

RTOL, ATOL = 1e-4, 1e-5


@pytest.fixture(autouse=True)
def _on_cpu():
    with mx.cpu():
        yield


def _pair(net):
    build, shapes = NETS[net]
    return build(jmx), build(mx), shapes


def _bind(pkg, sym, shapes, vals, grad_req="write"):
    ex = sym.simple_bind(pkg.cpu(), grad_req=grad_req, **shapes)
    for name, v in vals.items():
        d = ex.arg_dict if name in ex.arg_dict else ex.aux_dict
        d[name][:] = pkg.nd.array(v)
    return ex


def _close(got, want, what):
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL, err_msg=what)


# -- graphs, shapes and json ----------------------------------------------------

@pytest.mark.parametrize("net", sorted(NETS))
def test_lists_shapes_and_json_match(net):
    js, ts, shapes = _pair(net)
    assert ts.list_arguments() == js.list_arguments()
    assert ts.list_outputs() == js.list_outputs()
    assert ts.list_auxiliary_states() == js.list_auxiliary_states()
    assert ts.list_inputs() == js.list_inputs()
    assert ts.infer_shape(**shapes) == js.infer_shape(**shapes)
    assert json.loads(ts.tojson()) == json.loads(js.tojson())


@pytest.mark.parametrize("direction", ["port_to_reference",
                                       "reference_to_port"])
@pytest.mark.parametrize("net", ["bn", "encoder"])
def test_json_crosses_between_packages(tmp_path, net, direction):
    js, ts, shapes = _pair(net)
    path = str(tmp_path / "g-symbol.json")
    (ts if direction == "port_to_reference" else js).save(path)
    loaded = (jmx if direction == "port_to_reference" else mx).sym.load(path)
    src = js if direction == "port_to_reference" else ts
    assert loaded.list_arguments() == src.list_arguments()
    assert loaded.list_auxiliary_states() == src.list_auxiliary_states()
    assert loaded.infer_shape(**shapes) == src.infer_shape(**shapes)
    assert json.loads(loaded.tojson()) == json.loads(src.tojson())


def test_infer_shape_unknown_and_value_dependent():
    for pkg in (jmx, mx):
        a, b = pkg.sym.var("a"), pkg.sym.var("b")
        assert (a + b).infer_shape(a=(2, 3)) == (None, None, None)
    jm = jmx.sym.contrib.boolean_mask(jmx.sym.var("a"), jmx.sym.var("b"),
                                      name="bm")
    tm = mx.sym.contrib.boolean_mask(mx.sym.var("a"), mx.sym.var("b"),
                                     name="bm")
    for m, err in ((jm, jmx.MXNetError), (tm, MXNetError)):
        with pytest.raises(err, match="infer_shape failed at node 'bm'"):
            m.infer_shape(a=(4, 2), b=(4,))


def test_infer_shape_on_meta_asks_for_no_kernel(monkeypatch):
    from mxnet_tpu_torch.ops import contrib
    calls = []
    for name in ("flash_attention", "flash_attention_plain"):
        monkeypatch.setattr(contrib, name,
                            lambda *a, **k: calls.append(a) or 1 / 0)
    ts = NETS["encoder"][0](mx, units=64, heads=1)
    args, outs, _ = ts.infer_shape(**NETS["encoder"][1])
    assert outs == [(2, 256, 50)] and not calls


def test_infer_shape_goes_through_the_registrys_dispatch(monkeypatch):
    """Shape inference runs each node through the registry's dispatch on
    meta tensors, so amp's cast hook sees every op, as at the executor's
    dispatch."""
    ts = NETS["encoder"][0](mx, units=64, heads=1)
    seen = []
    hook = mx.amp._cast_hook
    monkeypatch.setattr(mx.amp, "_cast_hook", lambda name, tensors: (
        seen.append((name, {t.device.type for t in tensors}))
        or hook(name, tensors)))
    mx.amp.init()
    try:
        ts.infer_shape(**NETS["encoder"][1])
    finally:
        mx.amp.off()
    assert [n for n, _ in seen] == [s._op.name for s in ts._walk()
                                    if s._is_op()]
    assert set().union(*(d for _, d in seen)) == {"meta"}


def test_infer_type_gives_every_aux_state_a_type():
    """ROADMAP C.7: the reference's infer_type returns no aux types."""
    js, ts, _ = _pair("bn")
    jt = js.infer_type(data="float32")
    tt = ts.infer_type(data="float32")
    assert tt[:2] == jt[:2] and jt[2] == []
    assert tt[2] == ["float32"] * len(ts.list_auxiliary_states())
    assert ts.infer_type() == (
        [np.float32] * len(ts.list_arguments()), [np.float32],
        [np.float32] * 2)


# -- names ---------------------------------------------------------------------

def _named(pkg):
    sym = pkg.sym
    with pkg.name.NameManager():
        x = sym.var("x")
        a = sym.FullyConnected(x, num_hidden=3)
        b = sym.FullyConnected(a, num_hidden=3)
        c = sym.relu(b) * 2 + sym.dot(b, b)
        with pkg.name.Prefix("blk_"):
            d = sym.FullyConnected(c, num_hidden=2)
            e = sym.tanh(d)
        with pkg.AttrScope(__ctx_group__="dev1", __lr_mult__="0.5"):
            w = sym.var("w")
            f = sym.FullyConnected(e, w, num_hidden=2, no_bias=True)
            with pkg.AttrScope(__wd_mult__="0"):
                g = sym.sigmoid(f, attr={"__lr_mult__": "2"})
        return sym.Group(c, g)


def test_auto_names_and_attributes_match():
    jg, tg = _named(jmx), _named(mx)
    assert tg.list_arguments() == jg.list_arguments()
    assert tg.list_outputs() == jg.list_outputs()
    assert "fullyconnected0_weight" in tg.list_arguments()
    assert "blk_fullyconnected0_bias" in tg.list_arguments()
    for name in ("w", "fullyconnected2", "sigmoid0", "blk_tanh0"):
        t = next(s for s in tg._walk() if s.name == name)
        j = next(s for s in jg._walk() if s.name == name)
        assert t.list_attr() == j.list_attr(), name
    w = next(s for s in tg._walk() if s.name == "w")
    assert w.list_attr() == {"__ctx_group__": "dev1", "__lr_mult__": "0.5"}
    assert tg.get_internals()["sigmoid0_output"].attr("__lr_mult__") == "2"
    assert json.loads(tg.tojson()) == json.loads(jg.tojson())
    with pytest.raises(ValueError, match="dunder"):
        mx.AttrScope(lr_mult="1")


def test_symbol_surface_matches():
    outs = []
    for pkg in (jmx, mx):
        sym = pkg.sym
        with pkg.name.NameManager():
            a, b = sym.var("a"), sym.var("b")
            s = (a + b) * 3 - a / 2
            s = (2 - s) ** 2 + (-a)
            g = sym.Group(s, sym.sum(a), sym.zeros((2, 2)) + sym.ones((2, 2)))
            kids = s.get_children()
            outs.append((g.list_outputs(), g.num_outputs,
                         kids.list_outputs(), g[1].name,
                         s.get_internals().list_outputs(),
                         [o.asnumpy() for o in g.eval(
                             a=pkg.nd.array([[1., 2.], [3., 4.]]),
                             b=pkg.nd.array([[.5, .5], [1., 2.]]))]))
    j, t = outs
    assert t[:5] == j[:5]
    for got, want in zip(t[5], j[5]):
        _close(got, want, "eval")


def test_optimize_for_backends():
    ts = NETS["mlp"][0](mx)
    for name in ("default", "TPU", "xla"):
        assert ts.optimize_for(name) is ts
    with pytest.raises(MXNetError, match="A.10"):
        ts.optimize_for("INT8")
    with pytest.raises(MXNetError, match="not registered"):
        ts.optimize_for("TensorRT")
    mx.sym.register_backend("torch_test_drop_head")(
        lambda s, args, aux, **kw: s.get_internals()["fc2_output"])
    try:
        assert ts.optimize_for("torch_test_drop_head").name == "fc2"
    finally:
        del mx.symbol.symbol._BACKEND_REGISTRY["torch_test_drop_head"]


# -- the executor -----------------------------------------------------------------

@pytest.mark.parametrize("net", sorted(NETS))
def test_executor_forward_backward_and_aux(net):
    js, ts, shapes = _pair(net)
    vals = inputs(ts, shapes)
    jex, tex = _bind(jmx, js, shapes, vals), _bind(mx, ts, shapes, vals)
    # the encoder's predict mode runs in test_torch_symbol_block.py (each
    # mode is a compile of its own in the reference)
    for train in (True,) if net == "encoder" else (True, False):
        jo = [o.asnumpy() for o in jex.forward(is_train=train)]
        to = [o.asnumpy() for o in tex.forward(is_train=train)]
        for got, want in zip(to, jo):
            _close(got, want, f"output train={train}")
        for name in ts.list_auxiliary_states():
            _close(tex.aux_dict[name].asnumpy(), jex.aux_dict[name].asnumpy(),
                   name)
        if train:
            jex.backward()
            tex.backward()
            for name in ts.list_arguments():
                _close(tex.grad_dict[name].asnumpy(),
                       jex.grad_dict[name].asnumpy(), f"grad {name}")
    if net == "bn":
        moved = tex.aux_dict["bn1_moving_mean"].asnumpy()
        assert not np.allclose(moved, vals["bn1_moving_mean"])


def test_grad_req_add_and_head_gradients():
    outs = []
    for pkg in (jmx, mx):
        with pkg.name.NameManager():
            x, w = pkg.sym.var("x"), pkg.sym.var("w")
            y = pkg.sym.tanh(pkg.sym.dot(x, w))
        vals = {"x": np.linspace(-1, 1, 6, dtype=np.float32).reshape(2, 3),
                "w": np.linspace(.5, -.5, 12, dtype=np.float32).reshape(3, 4)}
        ex = _bind(pkg, y, {"x": (2, 3), "w": (3, 4)}, vals, grad_req="add")
        head = pkg.nd.array(np.arange(8, dtype=np.float32).reshape(2, 4))
        for _ in range(2):
            ex.forward(is_train=True)
            ex.backward(head)
        ex.backward(head)           # again on the same forward
        outs.append([ex.grad_dict[n].asnumpy() for n in ("x", "w")])
    for got, want in zip(*reversed(outs)):
        _close(got, want, "grad_req add")
    ex = _bind(mx, y, {"x": (2, 3), "w": (3, 4)}, vals)
    with pytest.raises(MXNetError, match="forward"):
        ex.backward()


def test_backward_without_retaining_the_graph():
    """``retain_graph=False`` frees the recorded graph: the same gradients,
    and a second backward asks for a forward; by default the graph stays
    for another backward, as the reference allows."""
    with mx.name.NameManager():
        x, w = mx.sym.var("x"), mx.sym.var("w")
        y = mx.sym.tanh(mx.sym.dot(x, w))
    vals = {"x": np.linspace(-1, 1, 6, dtype=np.float32).reshape(2, 3),
            "w": np.linspace(.5, -.5, 12, dtype=np.float32).reshape(3, 4)}
    ex = _bind(mx, y, {"x": (2, 3), "w": (3, 4)}, vals)
    head = mx.nd.array(np.arange(8, dtype=np.float32).reshape(2, 4))
    ex.forward(is_train=True)
    ex.backward(head)
    ex.backward(head)
    kept = [ex.grad_dict[n].asnumpy() for n in ("x", "w")]
    ex.forward(is_train=True)
    ex.backward(head, retain_graph=False)
    for name, want in zip(("x", "w"), kept):
        np.testing.assert_array_equal(ex.grad_dict[name].asnumpy(), want)
    with pytest.raises(MXNetError, match="forward"):
        ex.backward(head)


def test_eval_runs_on_the_asked_context():
    """numpy inputs go to ``ctx`` and the outputs stay there: a labelled
    host context, else the first NDArray input's, and the card when asked
    for it (refused when there is none, not run on the host)."""
    a = np.array([[1., -2.], [3., .5]], np.float32)
    b = np.array([[.5, .5], [-1., 2.]], np.float32)
    outs = []
    for pkg in (jmx, mx):
        with pkg.name.NameManager():
            y = pkg.sym.tanh(pkg.sym.var("a") * pkg.sym.var("b") + 1)
        outs.append(y.eval(ctx=pkg.cpu(), a=a, b=b)[0].asnumpy())
    _close(outs[1], outs[0], "eval of numpy inputs")
    (out,) = y.eval(ctx=mx.cpu(1), a=a, b=b)
    assert out.ctx == mx.cpu(1)
    _close(out.asnumpy(), outs[0], "eval on cpu(1)")
    (out,) = y.eval(a=mx.nd.array(a, ctx=mx.cpu(1)), b=b)
    assert out.ctx == mx.cpu(1)
    if torch.cuda.is_available():
        (out,) = y.eval(ctx=mx.gpu(0), a=a, b=b)
        assert out._data.device.type == "cuda"
        _close(out.asnumpy(), outs[0], "eval on the card")
    else:
        with pytest.raises(MXNetError, match="no CUDA device"):
            y.eval(ctx=mx.gpu(0), a=a, b=b)


def test_bind_copy_params_and_reshape():
    js, ts, shapes = _pair("mlp")
    vals = inputs(ts, shapes)
    for pkg, s in ((jmx, js), (mx, ts)):
        ex = s.bind(pkg.cpu(), {k: pkg.nd.array(v) for k, v in vals.items()})
        ex.forward()
        with pytest.raises(type(pkg.MXNetError("x")), match="missing"):
            s.bind(pkg.cpu(), {"data": pkg.nd.array(vals["data"])})
    t = ts.simple_bind(mx.cpu(), **shapes)
    t.copy_params_from({k: mx.nd.array(v) for k, v in vals.items()
                        if k.startswith("fc")})
    small = t.reshape(data=(2, 10), softmax_label=(2,))
    assert small.arg_dict["data"].shape == (2, 10)
    assert small.arg_dict["fc1_weight"] is t.arg_dict["fc1_weight"]
    small.forward(data=mx.nd.array(vals["data"][:2]))
    j = js.simple_bind(jmx.cpu(), data=(2, 10), softmax_label=(2,))
    for k, v in vals.items():
        if k.startswith("fc"):
            j.arg_dict[k][:] = jmx.nd.array(v)
    j.forward(data=jmx.nd.array(vals["data"][:2]))
    _close(small.outputs[0].asnumpy(), j.outputs[0].asnumpy(), "reshape")


def test_dropout_trains_and_predicts():
    with mx.name.NameManager():
        y = mx.sym.Dropout(mx.sym.var("x"), p=0.5)
    ex = y.simple_bind(mx.cpu(), x=(64, 64))
    ex.arg_dict["x"][:] = 1.0
    mx.random.seed(3)
    a = ex.forward(is_train=True)[0].asnumpy()
    mx.random.seed(3)
    b = ex.forward(is_train=True)[0].asnumpy()
    assert np.array_equal(a, b) and set(np.unique(a)) == {0.0, 2.0}
    assert np.array_equal(ex.forward(is_train=False)[0].asnumpy(),
                          np.ones((64, 64), np.float32))


def test_executor_follows_amp_on_and_off():
    with mx.name.NameManager():
        y = mx.sym.FullyConnected(mx.sym.var("x"), num_hidden=3, name="fc")
    ex = y.simple_bind(mx.cpu(), x=(2, 4))
    dtypes = [ex.forward()[0]._data.dtype]
    mx.amp.init()
    try:
        dtypes.append(ex.forward()[0]._data.dtype)
    finally:
        mx.amp.off()
    dtypes.append(ex.forward()[0]._data.dtype)
    assert dtypes == [torch.float32, torch.bfloat16, torch.float32]


# -- control flow -------------------------------------------------------------------

def _reference_control_flow():
    """The reference's ``symbol/contrib.py`` functions, which its generated
    ``mx.sym.contrib`` namespace hides (ROADMAP C.7)."""
    path = os.path.join(os.path.dirname(jmx.__file__), "symbol",
                        "contrib.py")
    spec = importlib.util.spec_from_file_location(
        "mxnet_tpu.symbol._control_flow", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _flow(name, lib, x, s):
    if name == "foreach":
        outs, st = lib.foreach(lambda xi, si: (xi * si, si + xi), x, s)
        return outs.sum() + (st * 2).sum()
    if name == "while_loop":
        outs, vs = lib.while_loop(lambda i, v: i < 3,
                                  lambda i, v: (v * v, [i + 1, v * 0.5 + x]),
                                  [s, x], max_iterations=5)
        return outs[0].sum() + vs[1].sum()
    out = lib.cond(lambda: s > 0.5, lambda: x * 3, lambda: x * x)
    return out.sum()


@pytest.mark.parametrize("name", ["foreach", "while_loop", "cond"])
def test_control_flow_values_and_gradients(name):
    import jax
    import jax.numpy as jnp
    from mxnet_tpu.ndarray.ndarray import NDArray as JND
    ref = _reference_control_flow()
    x0 = np.linspace(-1, 1, 6, dtype=np.float32).reshape(3, 2)
    s0 = np.float32(0.7) if name != "foreach" else \
        np.array([1.0, 0.5], np.float32)
    if name == "while_loop":
        s0 = np.float32(0)

    def jax_loss(x, s):
        return _flow(name, ref, JND._from_data(x), JND._from_data(s))._data

    want = jax_loss(jnp.asarray(x0), jnp.asarray(s0))
    want_g = jax.grad(jax_loss)(jnp.asarray(x0), jnp.asarray(s0))
    x = mx.nd.array(x0)
    x.attach_grad()
    with mx.autograd.record():
        got = _flow(name, mx.sym.contrib, x, mx.nd.array(np.asarray(s0)))
    got.backward()
    _close(got.asnumpy(), np.asarray(want), name)
    _close(x.grad.asnumpy(), np.asarray(want_g), f"{name} gradient")


def test_foreach_over_a_list_of_arrays():
    ref = _reference_control_flow()
    a = np.arange(6, dtype=np.float32).reshape(3, 2)
    b = np.ones((3, 2), np.float32)

    def body(xs, s):
        return xs[0] * xs[1] + s, s + xs[0]

    got = []
    for lib, pkg in ((ref, jmx), (mx.sym.contrib, mx)):
        out, st = lib.foreach(body, [pkg.nd.array(a), pkg.nd.array(b)],
                              pkg.nd.array(np.zeros(2, np.float32)))
        got.append((out.asnumpy(), st.asnumpy()))
    for g, w in zip(got[1], got[0]):
        _close(g, w, "foreach over a list")


def test_sym_contrib_holds_control_flow_and_ops():
    """ROADMAP C.7: in the reference the generated namespace hides the
    control flow."""
    assert callable(mx.sym.contrib.foreach)
    assert callable(mx.sym.contrib.masked_selfatt)
    assert not hasattr(jmx.sym.contrib, "foreach")
    assert hasattr(mx.sym, "linalg") and hasattr(mx.sym.random, "uniform")


# -- print_summary, plot_network, convert_model, library ------------------------------

@pytest.mark.parametrize("net", sorted(NETS))
def test_print_summary_text_and_count(net):
    js, ts, shapes = _pair(net)
    shape = {k: v for k, v in shapes.items() if k != "softmax_label"}
    texts = []
    for pkg, s in ((jmx, js), (mx, ts)):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            n = pkg.viz.print_summary(s, shape=dict(shape, **(
                {"softmax_label": shapes["softmax_label"]})))
        texts.append((buf.getvalue(), n))
    assert texts[1] == texts[0]
    assert texts[1][1] > 0


def test_plot_network_needs_graphviz():
    try:
        import graphviz  # noqa: F401
    except ImportError:
        with pytest.raises(MXNetError, match="graphviz"):
            mx.viz.plot_network(NETS["mlp"][0](mx))
    else:
        assert mx.viz.plot_network(NETS["mlp"][0](mx)) is not None


def test_convert_model_dtypes_match():
    js, ts, shapes = _pair("bn")
    vals = inputs(ts, shapes)
    args = [n for n in ts.list_arguments() if n not in shapes]
    auxs = ts.list_auxiliary_states()
    got = mx.amp.convert_model(
        ts, {n: mx.nd.array(vals[n]) for n in args},
        {n: mx.nd.array(vals[n]) for n in auxs},
        excluded_sym_names=["fc_bias"])
    want = jmx.amp.convert_model(
        js, {n: jmx.nd.array(vals[n]) for n in args},
        {n: jmx.nd.array(vals[n]) for n in auxs},
        excluded_sym_names=["fc_bias"])
    assert got[0] is ts
    for g, w in zip(got[1:], want[1:]):
        assert sorted(g) == sorted(w)
        for k in g:
            assert str(g[k].dtype).replace("torch.", "") == \
                np.dtype(w[k].dtype).name, k
    assert got[1]["c1_weight"]._data.dtype == torch.bfloat16
    assert got[1]["bn1_gamma"]._data.dtype == torch.float32
    assert got[1]["fc_bias"]._data.dtype == torch.float32


def test_library_load_reaches_sym(tmp_path):
    lib = tmp_path / "symops.py"
    lib.write_text("from mxnet_tpu_torch.ops.registry import register\n"
                   "@register('torch_sym_lib_twice')\n"
                   "def _twice(x):\n"
                   "    return x * 2\n")
    try:
        assert mx.library.load(str(lib), verbose=False) == \
            ["torch_sym_lib_twice"]
        s = mx.sym.torch_sym_lib_twice(mx.sym.var("x"))
        assert s.name == "torch_sym_lib_twice0" or s.name.startswith(
            "torch_sym_lib_twice")
        (out,) = s.eval(x=mx.nd.array([1.0, 2.0]))
        np.testing.assert_array_equal(out.asnumpy(), [2.0, 4.0])
    finally:
        registry._REGISTRY.pop("torch_sym_lib_twice", None)
        mx.library._LOADED.pop(str(lib), None)
        for ns in (mx.nd, mx.sym):
            if hasattr(ns, "torch_sym_lib_twice"):
                delattr(ns, "torch_sym_lib_twice")
