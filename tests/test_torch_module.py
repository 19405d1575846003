"""``mx.mod`` of the port held against the JAX package's on the CPU:
``Module.fit``/``score``/``predict`` from the same ``arg_params`` with
``shuffle=False`` under SGD and Adam (parameters and scores after the
steps), the one-layer ``masked_selfatt`` encoder's steps, several
contexts (``cpu(0)``, ``cpu(1)``) against one, ``BucketingModule``,
checkpoints written by one package and read by the other, and
``FeedForward``.  The reference's ``Module`` passes ``optimizer_params``
as given; these parity tests pass ``rescale_grad`` explicitly, and the
port's MXNet default (``1 / batch_size``, ROADMAP C.7) has a test of its
own, as do the other departures pinned below.

Tolerances: parameters, outputs and scores within rtol 1e-4, atol 1e-5
(float32 sums in another order, carried through a few updates).
"""

import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from mxnet_tpu_torch.base import MXNetError

from _torch_sym_nets import NETS, bn_net, encoder, inputs, mlp

RTOL, ATOL = 1e-4, 1e-5


@pytest.fixture(autouse=True)
def _on_cpu():
    with mx.cpu():
        yield


def _close(got, want, what):
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL, err_msg=what)


def _toy(n=40, d=10, k=4, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, d).astype(np.float32)
    W = rng.randn(d, k).astype(np.float32)
    return X, (X @ W).argmax(axis=1).astype(np.float32)


def _params(sym, shapes, seed=1):
    vals = inputs(sym, shapes, seed)
    names = [n for n in sym.list_arguments() if n not in shapes]
    return ({n: vals[n] for n in names},
            {n: vals[n] for n in sym.list_auxiliary_states()})


def _nd(pkg, d):
    return {k: pkg.nd.array(v) for k, v in d.items()}


def _fit(pkg, build, X, y, arg, aux, optimizer, opt_params, epochs=2,
         batch=10, context=None, **kw):
    it = pkg.io.NDArrayIter(X, y, batch_size=batch, shuffle=False,
                            label_name="softmax_label")
    mod = pkg.mod.Module(build(pkg), data_names=("data",),
                         label_names=("softmax_label",),
                         context=context or pkg.cpu())
    mod.fit(it, num_epoch=epochs, optimizer=optimizer,
            optimizer_params=opt_params, arg_params=_nd(pkg, arg),
            aux_params=_nd(pkg, aux), **kw)
    return mod, it


def _params_of(mod):
    arg, aux = mod.get_params()
    return {k: v.asnumpy() for k, v in {**arg, **aux}.items()}


@pytest.mark.parametrize("optimizer,lr", [("sgd", 0.5), ("adam", 0.01)])
@pytest.mark.parametrize("net", ["mlp", "bn"])
def test_fit_score_predict_match(net, optimizer, lr):
    build, shapes = NETS[net]
    shp = shapes["data"]
    rng = np.random.RandomState(2)
    X = rng.randn(4 * shp[0], *shp[1:]).astype(np.float32)
    y = rng.randint(0, 3, 4 * shp[0]).astype(np.float32)
    arg, aux = _params(build(mx), shapes)
    opt = (("learning_rate", lr), ("rescale_grad", 1.0 / shp[0]))
    jm, jit = _fit(jmx, build, X, y, arg, aux, optimizer, opt,
                   batch=shp[0])
    tm, tit = _fit(mx, build, X, y, arg, aux, optimizer, opt, batch=shp[0])
    want, got = _params_of(jm), _params_of(tm)
    assert sorted(got) == sorted(want)
    for k in want:
        _close(got[k], want[k], k)
    for metric in ("acc", "ce"):
        (jn, jv), = jm.score(jit, metric)
        (tn, tv), = tm.score(tit, metric)
        assert tn == jn
        _close(tv, jv, metric)
    _close(tm.predict(tit)[0].asnumpy(), jm.predict(jit)[0].asnumpy(),
           "predict")


def _encoder_steps(pkg, context, steps=2):
    """The one-layer encoder's Module after ``steps`` SGD steps on one
    batch (its outputs those of the last step's forward).  SGD, not Adam:
    the gradient of the key bias is rounding noise (softmax ignores a
    shift shared by a row's scores), which Adam would scale up to whole
    steps."""
    shapes = NETS["encoder"][1]
    vals = inputs(encoder(mx), shapes, seed=4)
    arg, aux = _params(encoder(mx), shapes, seed=5)
    mod = pkg.mod.Module(encoder(pkg), data_names=("data", "valid_length"),
                         label_names=("softmax_label",), context=context)
    mod.bind(data_shapes=[("data", shapes["data"]),
                          ("valid_length", shapes["valid_length"])],
             label_shapes=[("softmax_label", shapes["softmax_label"])])
    mod.init_params(arg_params=_nd(pkg, arg), aux_params=_nd(pkg, aux))
    mod.init_optimizer(optimizer="sgd", optimizer_params=(
        ("learning_rate", 0.05), ("momentum", 0.9), ("rescale_grad", 0.5)))
    batch = pkg.io.DataBatch(
        data=[pkg.nd.array(vals["data"]),
              pkg.nd.array(vals["valid_length"])],
        label=[pkg.nd.array(vals["softmax_label"])])
    for _ in range(steps):
        mod.forward_backward(batch)
        mod.update()
    return mod


def test_encoder_module_steps_match():
    jm, tm = _encoder_steps(jmx, jmx.cpu()), _encoder_steps(mx, mx.cpu())
    _close(tm.get_outputs()[0].asnumpy(), jm.get_outputs()[0].asnumpy(),
           "outputs")
    want, got = _params_of(jm), _params_of(tm)
    for k in want:
        _close(got[k], want[k], k)


def test_default_rescale_grad_is_one_over_the_batch():
    """ROADMAP C.7: with no ``rescale_grad``, the port's Module averages
    the summed head's gradient over the batch as MXNet 1.x does; the
    reference does not."""
    X, y = _toy()
    arg, aux = _params(mlp(mx), NETS["mlp"][1])
    sgd = (("learning_rate", 0.5),)
    tm, _ = _fit(mx, mlp, X, y, arg, aux, "sgd", sgd, epochs=1)
    jm, _ = _fit(jmx, mlp, X, y, arg, aux, "sgd",
                 sgd + (("rescale_grad", 0.1),), epochs=1)
    jraw, _ = _fit(jmx, mlp, X, y, arg, aux, "sgd", sgd, epochs=1)
    assert tm._optimizer.rescale_grad == 0.1
    got, want, raw = _params_of(tm), _params_of(jm), _params_of(jraw)
    for k in want:
        _close(got[k], want[k], k)
    assert not np.allclose(got["fc1_weight"], raw["fc1_weight"], atol=1e-3)


def test_predict_drops_the_padded_rows():
    """ROADMAP C.7: the reference keeps the rows an iterator padded its
    last batch with."""
    X, y = _toy(n=25)
    arg, aux = _params(mlp(mx), NETS["mlp"][1])
    opt = (("learning_rate", 0.1), ("rescale_grad", 0.1))
    tm, tit = _fit(mx, mlp, X, y, arg, aux, "sgd", opt, epochs=1)
    jm, jit = _fit(jmx, mlp, X, y, arg, aux, "sgd", opt, epochs=1)
    got, want = tm.predict(tit)[0].asnumpy(), jm.predict(jit)[0].asnumpy()
    assert got.shape == (25, 4) and want.shape == (30, 4)
    _close(got, want[:25], "predict")


def test_forward_backward_input_grads_and_outputs():
    X, y = _toy(n=20)
    arg, aux = _params(mlp(mx), NETS["mlp"][1])
    grads = []
    for pkg in (jmx, mx):
        it = pkg.io.NDArrayIter(X, y, batch_size=20,
                                label_name="softmax_label")
        mod = pkg.mod.Module(mlp(pkg), context=pkg.cpu())
        mod.bind(data_shapes=it.provide_data, label_shapes=it.provide_label,
                 inputs_need_grad=True)
        mod.init_params(arg_params=_nd(pkg, arg))
        mod.forward_backward(next(iter(it)))
        assert mod.output_shapes == [("softmax_output", (20, 4))]
        grads.append((mod.get_input_grads()[0].asnumpy(),
                      mod.get_outputs()[0].asnumpy()))
    for got, want in zip(grads[1], grads[0]):
        _close(got, want, "input grads / outputs")


# -- several contexts ------------------------------------------------------------

def test_multi_context_matches_one_context():
    build, shapes = NETS["mlp"]
    shp = shapes["data"]
    rng = np.random.RandomState(3)
    X = rng.randn(2 * shp[0], *shp[1:]).astype(np.float32)
    y = rng.randint(0, 3, 2 * shp[0]).astype(np.float32)
    arg, aux = _params(build(mx), shapes)
    opt = (("learning_rate", 0.05), ("rescale_grad", 1.0 / shp[0]))
    one, _ = _fit(mx, build, X, y, arg, aux, "sgd", opt, batch=shp[0])
    ref, _ = _fit(jmx, build, X, y, arg, aux, "sgd", opt, batch=shp[0])
    two, it = _fit(mx, build, X, y, arg, aux, "sgd", opt, batch=shp[0],
                   context=[mx.cpu(0), mx.cpu(1)])
    assert len(two._execs) == 2
    assert two._execs[1].arg_dict["fc1_weight"].ctx == mx.cpu(1)
    a, b, r = _params_of(one), _params_of(two), _params_of(ref)
    for k in a:
        _close(b[k], a[k], k)
        _close(b[k], r[k], k)
    it.reset()
    two.forward(next(iter(it)), is_train=False)
    assert two.get_outputs()[0].shape[0] == shp[0]
    assert len(two.get_outputs(merge_multi_context=False)[0]) == 2
    with pytest.raises(MXNetError, match="divide"):
        mx.mod.Module(build(mx), context=[mx.cpu(0), mx.cpu(1)]).bind(
            data_shapes=[("data", (shp[0] + 1,) + shp[1:])],
            label_shapes=[("softmax_label", (shp[0] + 1,))])


def test_multi_context_encoder_matches_one_context():
    one = _encoder_steps(mx, mx.cpu())
    two = _encoder_steps(mx, [mx.cpu(0), mx.cpu(1)])
    _close(two.get_outputs()[0].asnumpy(), one.get_outputs()[0].asnumpy(),
           "outputs")
    a, b = _params_of(one), _params_of(two)
    for k in a:
        _close(b[k], a[k], k)


def test_multi_context_averages_batchnorm_statistics():
    with mx.name.NameManager():
        net = mx.sym.BatchNorm(mx.sym.var("data"), name="bn",
                               fix_gamma=False)
        net = mx.sym.SoftmaxOutput(mx.sym.FullyConnected(
            net, num_hidden=2, name="fc"), name="softmax")
    mod = mx.mod.Module(net, context=[mx.cpu(0), mx.cpu(1)])
    mod.bind(data_shapes=[("data", (8, 3))],
             label_shapes=[("softmax_label", (8,))])
    mod.init_params(initializer=mx.initializer.Uniform(0.1))
    mod.init_optimizer(optimizer="sgd")
    X = np.concatenate([np.zeros((4, 3), np.float32),
                        np.full((4, 3), 10.0, np.float32)])
    mod.forward(mx.io.DataBatch(data=[mx.nd.array(X)],
                                label=[mx.nd.zeros((8,))]), is_train=True)
    mod.backward()
    mod.update()
    mean = mod._exec.aux_dict["bn_moving_mean"].asnumpy()
    np.testing.assert_allclose(mean, np.full(3, 0.5, np.float32), rtol=1e-6)
    np.testing.assert_array_equal(
        mod._execs[1].aux_dict["bn_moving_mean"].asnumpy(), mean)


# -- BucketingModule ---------------------------------------------------------------

def _sym_gen(pkg):
    def gen(key):
        with pkg.name.NameManager():
            data = pkg.sym.var("data")
            net = pkg.sym.FullyConnected(data, num_hidden=6, flatten=False,
                                         name="fc1")
            net = pkg.sym.sum(pkg.sym.tanh(net), axis=1)
            net = pkg.sym.FullyConnected(net, num_hidden=3, name="fc2")
            return pkg.sym.SoftmaxOutput(net, name="softmax"), ("data",), \
                ("softmax_label",)
    return gen


def _bucket_run(pkg, optimizer, opt_params, arg):
    mod = pkg.mod.BucketingModule(_sym_gen(pkg), default_bucket_key=8,
                                  context=pkg.cpu())
    mod.bind(data_shapes=[("data", (4, 8, 5))],
             label_shapes=[("softmax_label", (4,))])
    mod.init_params(arg_params=_nd(pkg, arg))
    mod.init_optimizer(optimizer=optimizer, optimizer_params=opt_params)
    rng = np.random.RandomState(6)
    outs = []
    for key in (8, 4, 8, 4):
        x = rng.randn(4, key, 5).astype(np.float32)
        y = rng.randint(0, 3, 4).astype(np.float32)
        batch = pkg.io.DataBatch(
            data=[pkg.nd.array(x)], label=[pkg.nd.array(y)],
            provide_data=[pkg.io.DataDesc("data", x.shape)],
            provide_label=[pkg.io.DataDesc("softmax_label", y.shape)])
        batch.bucket_key = key
        mod.forward(batch, is_train=True)
        mod.backward()
        mod.update()
        outs.append(mod.get_outputs()[0].asnumpy())
    arg_out, _ = mod.get_params()
    return outs, {k: v.asnumpy() for k, v in arg_out.items()}


def _bucket_params():
    rng = np.random.RandomState(7)
    return {"fc1_weight": 0.3 * rng.randn(6, 5), "fc1_bias": np.zeros(6),
            "fc2_weight": 0.3 * rng.randn(3, 6), "fc2_bias": np.zeros(3)}


def test_bucketing_module_matches_reference():
    arg = {k: v.astype(np.float32) for k, v in _bucket_params().items()}
    opt = (("learning_rate", 0.2), ("rescale_grad", 0.25))
    j_outs, j_arg = _bucket_run(jmx, "sgd", opt, arg)
    t_outs, t_arg = _bucket_run(mx, "sgd", opt, arg)
    for got, want in zip(t_outs, j_outs):
        _close(got, want, "bucket outputs")
    for k in j_arg:
        _close(t_arg[k], j_arg[k], k)


def test_bucketing_shares_one_optimizer_state():
    """ROADMAP C.7: MXNet's buckets borrow one optimizer; the reference
    gives each bucket its own Adam moments."""
    arg = {k: v.astype(np.float32) for k, v in _bucket_params().items()}
    mod = mx.mod.BucketingModule(_sym_gen(mx), default_bucket_key=8)
    mod.bind(data_shapes=[("data", (4, 8, 5))],
             label_shapes=[("softmax_label", (4,))])
    mod.init_params(arg_params=_nd(mx, arg))
    mod.init_optimizer(optimizer="adam",
                       optimizer_params=(("learning_rate", 0.01),))
    x = mx.nd.array(np.ones((4, 4, 5), np.float32))
    batch = mx.io.DataBatch(
        data=[x], label=[mx.nd.zeros((4,))],
        provide_data=[mx.io.DataDesc("data", (4, 4, 5))],
        provide_label=[mx.io.DataDesc("softmax_label", (4,))])
    batch.bucket_key = 4
    mod.forward(batch)
    assert mod._buckets[4]._updater is mod._buckets[8]._updater
    assert mod._buckets[4]._optimizer.rescale_grad == 0.25


def test_buckets_bind_over_the_default_buckets_arrays():
    """Every bucket's parameters, gradients and auxiliary states are the
    default bucket's arrays (MXNet's ``shared_module``): a step in one
    bucket is the other's parameters with no copy at the switch."""
    arg = {k: v.astype(np.float32) for k, v in _bucket_params().items()}
    mod = mx.mod.BucketingModule(_sym_gen(mx), default_bucket_key=8)
    mod.bind(data_shapes=[("data", (4, 8, 5))],
             label_shapes=[("softmax_label", (4,))])
    mod.init_params(arg_params=_nd(mx, arg))
    mod.init_optimizer(optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.5),))
    x = np.random.RandomState(2).randn(4, 4, 5).astype(np.float32)
    batch = mx.io.DataBatch(
        data=[mx.nd.array(x)], label=[mx.nd.array([0., 1., 2., 0.])],
        provide_data=[mx.io.DataDesc("data", x.shape)],
        provide_label=[mx.io.DataDesc("softmax_label", (4,))])
    batch.bucket_key = 4
    mod.forward(batch)
    mod.backward()
    mod.update()
    small, big = mod._buckets[4]._exec, mod._buckets[8]._exec
    for name in arg:
        assert small.arg_dict[name] is big.arg_dict[name], name
        assert small.grad_dict[name] is big.grad_dict[name], name
    assert small.arg_dict["data"] is not big.arg_dict["data"]
    stepped = big.arg_dict["fc1_weight"].asnumpy()
    assert not np.array_equal(stepped, arg["fc1_weight"])
    assert mod._buckets[4]._param_index == mod._buckets[8]._param_index


def test_module_backward_frees_each_steps_graph():
    """``Module`` runs one backward a step, so each executor lets its
    recorded graph go as the backward walks it."""
    X, y = _toy()
    arg, aux = _params(mlp(mx), {"data": (10, 10), "softmax_label": (10,)})
    mod = mx.mod.Module(mlp(mx), context=[mx.cpu(0), mx.cpu(1)])
    mod.bind(data_shapes=[("data", (10, 10))],
             label_shapes=[("softmax_label", (10,))])
    mod.init_params(arg_params=_nd(mx, arg), aux_params=_nd(mx, aux))
    batch = mx.io.DataBatch(data=[mx.nd.array(X[:10])],
                            label=[mx.nd.array(y[:10])])
    mod.forward_backward(batch)
    assert all(e._recorded is None for e in mod._execs)
    assert all(np.abs(e.grad_dict["fc1_weight"].asnumpy()).sum() > 0
               for e in mod._execs)
    with pytest.raises(MXNetError, match="forward"):
        mod.backward()


# -- checkpoints and FeedForward -----------------------------------------------------

@pytest.mark.parametrize("direction", ["port_to_reference",
                                       "reference_to_port"])
def test_checkpoint_crosses_between_packages(tmp_path, direction):
    X, y = _toy()
    arg, aux = _params(bn_net(mx), NETS["bn"][1])
    Xi = np.random.RandomState(8).randn(8, 2, 6, 6).astype(np.float32)
    yi = np.zeros(8, np.float32)
    opt = (("learning_rate", 0.1), ("rescale_grad", 0.25))
    src, dst = (mx, jmx) if direction == "port_to_reference" else (jmx, mx)
    mod, it = _fit(src, bn_net, Xi, yi, arg, aux, "sgd", opt, epochs=1,
                   batch=4)
    prefix = str(tmp_path / "bn")
    mod.save_checkpoint(prefix, 3)
    sym, a, x = dst.model.load_checkpoint(prefix, 3)
    assert sorted(a) == sorted(mod.get_params()[0])
    assert sorted(x) == ["bn1_moving_mean", "bn1_moving_var"]
    other = dst.mod.Module(sym, context=dst.cpu())
    dit = dst.io.NDArrayIter(Xi, yi, batch_size=4,
                             label_name="softmax_label")
    other.bind(data_shapes=dit.provide_data, label_shapes=dit.provide_label,
               for_training=False)
    other.init_params(arg_params=a, aux_params=x)
    _close(other.predict(dit)[0].asnumpy(), mod.predict(it)[0].asnumpy(),
           "predict after load")


def test_module_load_restores_params_and_optimizer_states(tmp_path):
    """ROADMAP C.7: the reference's Module.load keeps the parameters it
    read unused and never reads the ``.states`` file."""
    X, y = _toy()
    arg, aux = _params(mlp(mx), NETS["mlp"][1])
    opt = (("learning_rate", 0.01), ("rescale_grad", 0.1))
    mod, it = _fit(mx, mlp, X, y, arg, aux, "adam", opt, epochs=1)
    prefix = str(tmp_path / "mlp")
    mod.save_checkpoint(prefix, 1, save_optimizer_states=True)
    cont, _ = _fit(mx, mlp, X, y, arg, aux, "adam", opt, epochs=1)
    cont.fit(it, num_epoch=2, begin_epoch=1, optimizer="adam",
             optimizer_params=opt)
    back = mx.mod.Module.load(prefix, 1, load_optimizer_states=True)
    back.fit(it, num_epoch=2, begin_epoch=1, optimizer="adam",
             optimizer_params=opt)
    got, want = _params_of(back), _params_of(cont)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_feedforward_is_a_module_veneer(tmp_path):
    X, y = _toy()
    arg, _ = _params(mlp(mx), NETS["mlp"][1])
    it = mx.io.NDArrayIter(X, y, batch_size=10, label_name="softmax_label")
    ff = mx.model.FeedForward(mlp(mx), ctx=mx.cpu(), num_epoch=2,
                              optimizer="sgd",
                              arg_params=_nd(mx, arg))
    ff.fit(it)
    mod, _ = _fit(mx, mlp, X, y, arg, {}, "sgd",
                  (("learning_rate", 0.01),))
    _close(ff.predict(it)[0].asnumpy(), mod.predict(it)[0].asnumpy(), "ff")
    ff.save(str(tmp_path / "ff"), 2)
    back = mx.model.FeedForward.load(str(tmp_path / "ff"), 2, ctx=mx.cpu())
    assert sorted(back.arg_params) == sorted(arg)
