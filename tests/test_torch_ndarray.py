"""The port's ``mx.nd`` held against the JAX package's, on the CPU: each
case runs the same code, on the same numpy inputs made from a seed, through
``mxnet_tpu`` and ``mxnet_tpu_torch`` (``with mx.cpu():``) and compares the
results.  Mirrors ``tests/test_ndarray.py``.

Tolerances: elementwise, shape and index ops and save/load exact (rtol 0,
atol 0); reductions and products, which sum in another order, atol 1e-6
(inputs in [-1, 1], at most 60 terms).
"""

import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx

PKGS = (jmx, mx)


@pytest.fixture(autouse=True)
def _on_cpu():
    with mx.cpu():
        yield


def _both(fn, atol=0.0):
    """fn(package) on both packages; results (numpy or scalars, or lists
    of them) must agree within ``atol``, and are returned."""
    jax_out, port_out = fn(jmx), fn(mx)
    if not isinstance(jax_out, (list, tuple)):
        jax_out, port_out = [jax_out], [port_out]
    assert len(jax_out) == len(port_out)
    for j, p in zip(jax_out, port_out):
        np.testing.assert_allclose(np.asarray(p), np.asarray(j), rtol=0,
                                   atol=atol)
    return port_out


def _rand(seed, *shape):
    return np.random.RandomState(seed).uniform(-1, 1, shape) \
        .astype(np.float32)


def test_creation():
    out = _both(lambda m: [m.nd.array([[1, 2], [3, 4]]).asnumpy(),
                           m.nd.zeros((3, 4)).asnumpy(),
                           m.nd.ones((3, 4)).asnumpy(),
                           m.nd.full((2, 2), 7).asnumpy(),
                           m.nd.arange(0, 10, 2).asnumpy()])
    assert [o.dtype for o in out] == [np.float32] * 5


def test_python_float_default_dtype():
    for m in PKGS:
        assert m.nd.array([1.5, 2.5]).dtype == np.float32


@pytest.mark.parametrize("op", ["add", "sub", "mul", "div", "pow", "radd",
                                "rsub", "rdiv", "neg", "abs"])
def test_arithmetic(op):
    x, y = _rand(0, 3, 4), _rand(1, 3, 4) + 2.0
    f = {"add": lambda a, b: a + b, "sub": lambda a, b: a - b,
         "mul": lambda a, b: a * b, "div": lambda a, b: b / a,
         "pow": lambda a, b: a ** 2, "radd": lambda a, b: 2 + a,
         "rsub": lambda a, b: 2 - a, "rdiv": lambda a, b: 2 / b,
         "neg": lambda a, b: -a, "abs": lambda a, b: abs(-a)}[op]
    _both(lambda m: f(m.nd.array(x), m.nd.array(y)).asnumpy())


def test_comparison():
    a, b = np.array([1., 2., 3.]), np.array([3., 2., 1.])
    out = _both(lambda m: [(m.nd.array(a) == m.nd.array(b)).asnumpy(),
                           (m.nd.array(a) < m.nd.array(b)).asnumpy(),
                           (m.nd.array(a) >= m.nd.array(b)).asnumpy(),
                           (m.nd.array(a) > 2).asnumpy()])
    np.testing.assert_array_equal(out[0], [0, 1, 0])


def test_inplace_ops():
    def run(m):
        a = m.nd.array([1., 2., 3.])
        seen = []
        for f in (lambda a: a.__iadd__(1), lambda a: a.__imul__(2),
                  lambda a: a.__itruediv__(4), lambda a: a.__isub__(0.5)):
            f(a)
            seen.append(a.asnumpy())
        return seen
    _both(run)


def test_setitem():
    def run(m):
        a = m.nd.zeros((3, 4))
        a[:] = 2
        a[1] = 5
        a[0, 1:3] = 7
        a[2] = np.array([1, 2, 3, 4])
        return a.asnumpy()
    _both(run)


def test_view_aliasing():
    """Basic-index views and reshapes share storage both ways."""
    def run(m):
        a = m.nd.array(np.arange(12).reshape(3, 4).astype("float32"))
        v = a[1]
        a[1] = 99.0
        first = v.asnumpy()
        v[:] = 7.0
        r = a.reshape(4, 3)
        r[0, 0] = -1.0
        return [first, a.asnumpy()]
    out = _both(run)
    assert out[1][0, 0] == -1.0 and (out[1][1] == 7.0).all()


def test_advanced_indexing_copies():
    def run(m):
        a = m.nd.array(np.arange(6).astype("float32"))
        c = a[np.array([0, 2, 4])]
        got = c.asnumpy()
        c[:] = 9
        return [got, a.asnumpy()]
    out = _both(run)
    assert out[1][0] == 0


@pytest.mark.parametrize("shape", [(-1,), (0, -1), (-2,), (-3, 4),
                                   (2, -4, -1, 3, 4), (4, 0, -1)])
def test_reshape_special_codes(shape):
    x = _rand(2, 2, 3, 4)
    _both(lambda m: m.nd.array(x).reshape(shape).asnumpy())


@pytest.mark.parametrize("case", ["all", "mean1", "max02", "keep",
                                  "exclude", "min"])
def test_reductions(case):
    x = _rand(3, 3, 4, 5)
    f = {"all": lambda m, a: a.sum(),
         "mean1": lambda m, a: a.mean(axis=1),
         "max02": lambda m, a: a.max(axis=(0, 2)),
         "keep": lambda m, a: m.nd.sum(a, axis=1, keepdims=True),
         "exclude": lambda m, a: m.nd.sum(a, axis=1, exclude=True),
         "min": lambda m, a: a.min(axis=2)}[case]
    _both(lambda m: f(m, m.nd.array(x)).asnumpy(), atol=1e-6)


def test_dot():
    x, y = _rand(4, 4, 5), _rand(5, 5, 3)
    bx, by = _rand(6, 2, 4, 5), _rand(7, 2, 5, 3)
    _both(lambda m: [
        m.nd.dot(m.nd.array(x), m.nd.array(y)).asnumpy(),
        m.nd.dot(m.nd.array(x), m.nd.array(y.T), transpose_b=True).asnumpy(),
        m.nd.dot(m.nd.array(x.T), m.nd.array(y), transpose_a=True).asnumpy(),
        m.nd.batch_dot(m.nd.array(bx), m.nd.array(by)).asnumpy(),
        m.nd.batch_dot(m.nd.array(bx), m.nd.array(by.transpose(0, 2, 1)),
                       transpose_b=True).asnumpy()], atol=1e-6)


def test_shape_ops():
    x = np.arange(24).reshape(2, 3, 4).astype("float32")
    _both(lambda m: [
        m.nd.array(x).transpose().asnumpy(),
        m.nd.array(x).transpose((1, 0, 2)).asnumpy(),
        m.nd.array(x).swapaxes(0, 2).asnumpy(),
        m.nd.array(x).expand_dims(1).asnumpy(),
        m.nd.concat(m.nd.array(x), m.nd.array(x), dim=1).asnumpy(),
        m.nd.stack(m.nd.array(x), m.nd.array(x), axis=0).asnumpy(),
        m.nd.flip(m.nd.array(x), axis=2).asnumpy(),
        m.nd.tile(m.nd.array(x), reps=(1, 2, 1)).asnumpy(),
        m.nd.reshape_like(m.nd.array(x), m.nd.zeros((4, 6))).asnumpy()])


def test_slice_ops():
    x = np.arange(24).reshape(4, 6).astype("float32")
    _both(lambda m: [
        m.nd.array(x).slice([1, 2], [3, 5]).asnumpy(),
        m.nd.array(x).slice_axis(1, 2, 4).asnumpy(),
        m.nd.slice_axis(m.nd.array(x), axis=0, begin=-2, end=None).asnumpy(),
        m.nd.split(m.nd.array(x), num_outputs=2, axis=0)[1].asnumpy()])


def test_take_pick_onehot():
    x = _rand(8, 4, 5)
    _both(lambda m: [
        m.nd.array(x).take(m.nd.array(np.array([0, 2])), axis=0).asnumpy(),
        m.nd.array(x).take(m.nd.array(np.array([7, -1])), axis=1).asnumpy(),
        m.nd.array(x).pick(m.nd.array(np.array([1, 0, 3, 2])),
                           axis=1).asnumpy(),
        m.nd.pick(m.nd.array(x), m.nd.array(np.array([0, 4, 1, 2, 3])),
                  axis=0, keepdims=True).asnumpy(),
        m.nd.one_hot(m.nd.array(np.array([0, 2])), depth=4).asnumpy(),
        m.nd.Embedding(m.nd.array(np.array([[3, 1], [0, 3]])), m.nd.array(x),
                       input_dim=4, output_dim=5).asnumpy()])


def test_ordering():
    x = _rand(9, 3, 6)
    _both(lambda m: [
        m.nd.array(x).sort(axis=1).asnumpy(),
        m.nd.array(x).argsort(axis=1).asnumpy(),
        m.nd.array(x).topk(k=2, ret_typ="value", axis=1).asnumpy(),
        m.nd.array(x).argmax(axis=1).asnumpy()])


def test_astype_copy():
    for m in PKGS:
        a = m.nd.array([1.5, 2.5])
        b = a.astype(np.int32)
        assert b.dtype == np.int32
        np.testing.assert_array_equal(b.asnumpy(), [1, 2])
        assert a.astype(np.float32, copy=False) is a


def test_scalar_conversions():
    for m in PKGS:
        a = m.nd.array([3.5])
        assert float(a) == 3.5 and int(a) == 3
        assert a.asscalar() == pytest.approx(3.5)
        with pytest.raises(m.MXNetError):
            m.nd.array([1.0, 2.0]).asscalar()


def test_save_load_roundtrip(tmp_path):
    """``tests/test_ndarray.py::test_save_load_roundtrip`` through both
    packages: a dict and a list, each package reading its own file."""
    r = np.random.RandomState(3)
    w, b = r.randn(3, 4).astype("float32"), r.randn(4).astype("float32")
    for m in PKGS:
        fname = str(tmp_path / f"{m.__name__}.params")
        m.nd.save(fname, {"w": m.nd.array(w), "b": m.nd.array(b)})
        loaded = m.nd.load(fname)
        assert set(loaded) == {"w", "b"}
        np.testing.assert_array_equal(loaded["w"].asnumpy(), w)
        m.nd.save(fname, [m.nd.array([1.0]), m.nd.array([2.0, 3.0])])
        back = m.nd.load(fname)
        assert isinstance(back, list) and len(back) == 2
        np.testing.assert_array_equal(back[1].asnumpy(), [2.0, 3.0])


def test_wait_and_context():
    a = mx.nd.ones((2, 2))
    a.wait_to_read()
    assert a.ctx == mx.cpu(0) and a.ctx.device_type == "cpu"
    assert a.as_in_context(mx.cpu(0)) is a
    assert a.copyto(mx.cpu()) is not a
    mx.nd.waitall()


def test_iter_len():
    x = np.arange(6).reshape(3, 2).astype("float32")
    out = _both(lambda m: [r.asnumpy() for r in m.nd.array(x)]
                + [np.array(len(m.nd.array(x)))])
    assert len(out) == 4


def test_zeros_like_ones_like():
    x = _rand(10, 2, 3)
    _both(lambda m: [m.nd.zeros_like(m.nd.array(x)).asnumpy(),
                     m.nd.ones_like(m.nd.array(x)).asnumpy()])


def test_inplace_alias_visibility():
    """``a += b`` writes the same storage: aliases and views see it."""
    def run(m):
        a = m.nd.array([1.0, 1.0])
        alias = a
        a += 1
        first = alias.asnumpy()
        v = a[0:2]
        a += 1
        return [first, v.asnumpy()]
    _both(run)


def test_array_preserves_float64():
    src = np.array([1.0, 2.0], dtype=np.float64)
    for m in PKGS:
        assert m.nd.array(src).dtype == np.float64
        assert m.nd.array([1.0, 2.0]).dtype == np.float32
    _both(lambda m: m.nd.array(src).asnumpy())


@pytest.mark.parametrize("name", ["exp", "log", "sqrt", "tanh", "sigmoid",
                                  "relu", "square", "gelu"])
def test_unary_ops(name):
    x = np.abs(_rand(11, 4, 6)) + 0.1
    _both(lambda m: getattr(m.nd, name)(m.nd.array(x)).asnumpy(), atol=1e-6)


def test_array_without_a_card_raises():
    """With no ``ctx`` and no ``with`` scope the context is the card (a
    fresh thread has no scope): with none present the array is refused,
    not made on the host."""
    import threading
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default context exists")
    seen = {}

    def run():
        seen["ctx"] = mx.current_context()
        for make in (lambda: mx.nd.array(np.ones(3)),
                     lambda: mx.nd.zeros((2,))):
            try:
                make()
            except mx.MXNetError as e:
                seen.setdefault("errors", []).append(str(e))
    t = threading.Thread(target=run)
    t.start()
    t.join(timeout=60)
    assert not t.is_alive()
    assert seen["ctx"] == mx.gpu(0)
    assert len(seen.get("errors", [])) == 2
    assert all("no CUDA device" in e for e in seen["errors"])


# -- negative steps, one_hot, flip and Embedding out of range ----------------

@pytest.mark.parametrize("key", [
    (slice(None, None, -1),),
    (slice(None), slice(None, None, -2)),
    (slice(3, 0, -2), 1),
    (Ellipsis, slice(-1, None, -3)),
    (None, slice(None, None, -1), slice(1, 4)),
])
def test_negative_step_read(key):
    x = _rand(21, 4, 5)
    _both(lambda m: m.nd.array(x)[key].asnumpy())


@pytest.mark.parametrize("key,value", [
    ((slice(None, None, -1),), 0.0),
    ((slice(None), slice(None, None, -2)), "row"),
    ((slice(3, 0, -2),), "block"),
])
def test_negative_step_write_reaches_the_base(key, value):
    x = _rand(22, 4, 5)

    def run(m):
        a = m.nd.array(x)
        view = a[1:]                      # an alias sees the write
        shape = np.empty((4, 5))[key].shape
        v = {"row": np.arange(shape[-1], dtype=np.float32),
             "block": np.arange(np.prod(shape), dtype=np.float32)
             .reshape(shape)}.get(value, value)
        a[key] = m.nd.array(v) if isinstance(v, np.ndarray) else v
        return [a.asnumpy(), view.asnumpy()]
    out = _both(run)
    want = x.copy()
    want[key] = {"row": np.arange(3), "block": np.arange(10).reshape(2, 5)
                 }.get(value, value)
    np.testing.assert_array_equal(out[0], want)


def test_positive_step_slice_still_writes_through():
    a = mx.nd.array(_rand(23, 4, 5))
    view = a[::2, 1:]
    view[:] = 7.0
    assert (a.asnumpy()[::2, 1:] == 7.0).all()


def test_slice_op_negative_step():
    x = _rand(24, 4, 5)
    _both(lambda m: [
        m.nd.slice(m.nd.array(x), begin=(None,), end=(None,),
                   step=(-1,)).asnumpy(),
        m.nd.slice(m.nd.array(x), begin=(3, 4), end=(0, None),
                   step=(-2, -3)).asnumpy()])


def test_one_hot_out_of_range_rows_are_off():
    out = _both(lambda m: m.nd.one_hot(
        m.nd.array(np.array([0, 3, -1, 5], np.float32)), depth=4,
        on_value=2.0, off_value=-1.0).asnumpy())
    np.testing.assert_array_equal(out[0][2:], -np.ones((2, 4)))


def test_flip_without_axis_reverses_every_axis():
    x = np.arange(12, dtype=np.float32).reshape(3, 4)
    out = _both(lambda m: [m.nd.flip(m.nd.array(x)).asnumpy(),
                           m.nd.reverse(m.nd.array(x)).asnumpy(),
                           m.nd.array(x).flip(axis=None).asnumpy()])
    np.testing.assert_array_equal(out[0], x[::-1, ::-1])


def test_embedding_clips_out_of_range_indices():
    """In-range rows agree with the reference; an index past either end
    reads the nearest row (the reference's rows there are NaN)."""
    w = _rand(25, 5, 3)
    idx = np.array([0, 4, -2, 7, 2], np.float32)

    def run(m):
        return m.nd.Embedding(m.nd.array(idx), m.nd.array(w), input_dim=5,
                              output_dim=3).asnumpy()
    got, ref = run(mx), run(jmx)
    inside = (idx >= 0) & (idx < 5)
    np.testing.assert_array_equal(got[inside], ref[inside])
    np.testing.assert_array_equal(got[~inside], w[[0, 4]])


# -- the methods and functions this slice adds -------------------------------

def test_new_methods():
    x = np.abs(_rand(26, 2, 1, 3)) + 0.5
    _both(lambda m: [
        m.nd.array(x).squeeze().asnumpy(),
        m.nd.array(x).squeeze(axis=1).asnumpy(),
        m.nd.array(x).broadcast_to((2, 4, 3)).asnumpy(),
        m.nd.array(x).broadcast_like(m.nd.zeros((2, 2, 3))).asnumpy(),
        m.nd.array(x).tile((1, 2, 1)).asnumpy(),
        m.nd.array(x).repeat(2, axis=2).asnumpy(),
        m.nd.array(x).flip(axis=2).asnumpy(),
        m.nd.array(x).prod(axis=2).asnumpy(),
        m.nd.array(x).norm().asnumpy(),
        m.nd.array(x).norm(ord=1, axis=[0, 2]).asnumpy()], atol=1e-6)


def test_from_numpy_from_dlpack_waitall():
    import torch
    a = np.arange(6, dtype=np.float32).reshape(2, 3)
    b = mx.nd.from_numpy(a)
    a[0, 0] = 9.0                         # a copy, as the reference's
    assert b.asnumpy()[0, 0] == 0.0
    t = torch.arange(4.0)
    c = mx.nd.from_dlpack(torch.utils.dlpack.to_dlpack(t))
    t[0] = 5.0                            # no copy: the same memory
    assert c.asnumpy()[0] == 5.0
    d = mx.nd.from_dlpack(mx.nd.array(a).to_dlpack_for_read())
    np.testing.assert_array_equal(d.asnumpy(), a)
    mx.waitall()
    mx.nd.waitall()
    assert mx.num_gpus() == torch.cuda.device_count()


def test_generated_namespaces():
    for m in PKGS:
        assert callable(m.nd.random.uniform) and callable(m.nd.random_uniform)
        assert callable(m.nd.linalg.gemm2) and callable(m.nd.linalg_gemm2)
        assert callable(m.nd.contrib.masked_encdec_att)
        assert callable(m.random.randn) and callable(m.random.shuffle)
