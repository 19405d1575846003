"""``mx.np`` where torch's defaults differ from numpy's, the ROADMAP C.7
departures, ``np.random``, ``vectorize``, the copy-returning writers, and
``mx.np`` inside hybridized blocks and under the registry's hooks, on the
CPU, the port held against numpy and the JAX package.

Values agree with numpy at rtol 1e-5 / atol 1e-6 (float32 sums in another
order) and with the reference at the same tolerance where it accepts the
call (``REF_REJECTS`` lists the calls its ``jnp`` refuses); each C.7
departure is pinned: the port float32, the reference float64.
"""

import numpy as onp
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx

tnp, jnp_ = mx.np, jmx.np
F = onp.float32


@pytest.fixture(autouse=True)
def _on_cpu():
    """On the host, with the port's generators put back as they were: a
    test here reseeds and draws, which would move the unseeded draws of
    tests that run after it in the same process."""
    from mxnet_tpu_torch import random as mxr
    gens = dict(mxr._generators())
    seed = mxr._state.seed
    states = {ctx: g.get_state() for ctx, g in gens.items()}
    with mx.cpu():
        yield
    now = mxr._generators()
    now.clear()
    mxr._state.seed = seed
    for ctx, g in gens.items():
        g.set_state(states[ctx])
        now[ctx] = g


def _val(r):
    return r.asnumpy() if hasattr(r, "asnumpy") else onp.asarray(r)


def _ar(*v, dtype=F):
    return onp.array(v, dtype)


A5 = onp.arange(5, dtype=F)
A6 = onp.arange(6, dtype=F).reshape(2, 3)
A10 = onp.arange(10, dtype=F)

# label -> (call through a module m and an array maker, numpy's answer)
TORCH_DIFFERS = {
    "median_even_count": (lambda m, a: m.median(a(_ar(4, 1, 3, 2))), 2.5),
    "std_population": (lambda m, a: m.std(a(_ar(1, 2, 4))),
                       onp.std(_ar(1, 2, 4))),
    "var_population": (lambda m, a: m.var(a(_ar(1, 2, 4)), axis=0),
                       onp.var(_ar(1, 2, 4))),
    "argsort_stable": (lambda m, a: m.argsort(a(_ar(2, 1, 2, 1, 0, 2))),
                       onp.argsort(_ar(2, 1, 2, 1, 0, 2), kind="stable")),
    "sort_stable_axis0": (lambda m, a: m.sort(a(A6[::-1]), axis=0),
                          onp.sort(A6[::-1], axis=0)),
    "unique_nan_once": (lambda m, a: m.unique(a(_ar(3, 1, 3, onp.nan,
                                                   onp.nan))),
                        onp.unique(_ar(3, 1, 3, onp.nan, onp.nan))),
    "mod_signs_float": (lambda m, a: m.mod(a(_ar(-7, 7, -7, 7)),
                                           a(_ar(3, -3, -3, 3))),
                        onp.mod(_ar(-7, 7, -7, 7), _ar(3, -3, -3, 3))),
    "remainder_signs_int": (lambda m, a: m.remainder(
        a(_ar(-7, 7, -7, 7, dtype=onp.int32)),
        a(_ar(3, -3, -3, 3, dtype=onp.int32))),
        onp.remainder(_ar(-7, 7, -7, 7, dtype=onp.int32),
                      _ar(3, -3, -3, 3, dtype=onp.int32))),
    "fmod_signs": (lambda m, a: m.fmod(a(_ar(-7, 7)), 3.0),
                   onp.fmod(_ar(-7, 7), F(3))),
    "round_half_even": (lambda m, a: m.round(a(_ar(0.5, 1.5, 2.5, -0.5,
                                                  -1.5))),
                        onp.round(_ar(0.5, 1.5, 2.5, -0.5, -1.5))),
    "around_decimals": (lambda m, a: m.around(a(_ar(0.125, 1.2345, -2.675,
                                                    12.5)), 2),
                        onp.around(_ar(0.125, 1.2345, -2.675, 12.5), 2)),
    "around_int_negative_decimals": (
        lambda m, a: m.around(a(_ar(15, 25, -35, 144, dtype=onp.int64)), -1),
        onp.around(_ar(15, 25, -35, 144, dtype=onp.int64), -1)),
    "pad_symmetric": (lambda m, a: m.pad(a(A5), (3, 6), mode="symmetric"),
                      onp.pad(A5, (3, 6), mode="symmetric")),
    "pad_wrap": (lambda m, a: m.pad(a(A5), (3, 7), mode="wrap"),
                 onp.pad(A5, (3, 7), mode="wrap")),
    "pad_reflect": (lambda m, a: m.pad(a(A5), (6, 6), mode="reflect"),
                    onp.pad(A5, (6, 6), mode="reflect")),
    "pad_edge_2d": (lambda m, a: m.pad(a(A6), ((1, 2), (2, 1)), mode="edge"),
                    onp.pad(A6, ((1, 2), (2, 1)), mode="edge")),
    "pad_mean": (lambda m, a: m.pad(a(A6), ((1, 2), (2, 1)), mode="mean"),
                 onp.pad(A6, ((1, 2), (2, 1)), mode="mean")),
    "pad_maximum": (lambda m, a: m.pad(a(A6), ((1, 2), (2, 1)),
                                       mode="maximum"),
                    onp.pad(A6, ((1, 2), (2, 1)), mode="maximum")),
    "pad_linear_ramp": (lambda m, a: m.pad(a(A6), ((1, 2), (2, 1)),
                                           mode="linear_ramp"),
                        onp.pad(A6, ((1, 2), (2, 1)), mode="linear_ramp")),
    "convolve_full": (lambda m, a: m.convolve(a(_ar(1, 2)), a(A5)),
                      onp.convolve(_ar(1, 2), A5)),
    "convolve_same": (lambda m, a: m.convolve(a(_ar(1, 2, 3, 4)),
                                              a(onp.arange(7, dtype=F)),
                                              mode="same"),
                      onp.convolve(_ar(1, 2, 3, 4), onp.arange(7, dtype=F),
                                   mode="same")),
    "convolve_valid": (lambda m, a: m.convolve(a(A5), a(_ar(1, 2, 0.5)),
                                               mode="valid"),
                       onp.convolve(A5, _ar(1, 2, 0.5), mode="valid")),
    "correlate_same_short_first": (
        lambda m, a: m.correlate(a(_ar(1, 2)), a(A5), mode="same"),
        onp.correlate(_ar(1, 2), A5, mode="same")),
    "correlate_same_even": (
        lambda m, a: m.correlate(a(onp.arange(6, dtype=F)),
                                 a(_ar(1, 2, 3, 4)), mode="same"),
        onp.correlate(onp.arange(6, dtype=F), _ar(1, 2, 3, 4), mode="same")),
    "correlate_valid_short_first": (
        lambda m, a: m.correlate(a(_ar(1, 2, 3)), a(onp.arange(6, dtype=F))),
        onp.correlate(_ar(1, 2, 3), onp.arange(6, dtype=F))),
    "hanning_symmetric": (lambda m, a: m.hanning(8), onp.hanning(8)),
    "blackman_symmetric": (lambda m, a: m.blackman(6), onp.blackman(6)),
    "window_of_one": (lambda m, a: m.hamming(1), onp.hamming(1)),
    "kaiser": (lambda m, a: m.kaiser(8, 5.0), onp.kaiser(8, 5.0)),
    "percentile_lower": (lambda m, a: m.percentile(a(A10), a(_ar(25, 50, 90)),
                                                   method="lower"),
                         onp.percentile(A10, [25, 50, 90], method="lower")),
    "percentile_nearest": (lambda m, a: m.percentile(
        a(A10), a(_ar(25, 55, 95)), method="nearest"),
        onp.percentile(A10, [25, 55, 95], method="nearest")),
    "percentile_midpoint": (lambda m, a: m.percentile(
        a(A10), a(_ar(25, 55, 95)), method="midpoint"),
        onp.percentile(A10, [25, 55, 95], method="midpoint")),
    "quantile_higher": (lambda m, a: m.quantile(a(A10), 0.33,
                                                method="higher"),
                        onp.quantile(A10, 0.33, method="higher")),
    "quantile_keepdims": (lambda m, a: m.quantile(a(A6), 0.4, axis=1,
                                                  keepdims=True),
                          onp.quantile(A6, 0.4, axis=1, keepdims=True)),
    "argmax_first_of_ties": (lambda m, a: m.argmax(a(_ar([1, 3, 3],
                                                         [2, 2, 0])), axis=1),
                             onp.argmax(_ar([1, 3, 3], [2, 2, 0]), axis=1)),
    "argmin_first_of_ties": (lambda m, a: m.argmin(a(_ar(1, 0, 0, 1))), 1),
    "cumsum_int32_keeps_int32": (lambda m, a: m.cumsum(
        a(_ar(1, 2, 3, dtype=onp.int32))),
        onp.cumsum(_ar(1, 2, 3, dtype=onp.int32))),
    "cumsum_bool_int64": (lambda m, a: m.cumsum(a(_ar(True, False, True,
                                                      dtype=bool))),
                          onp.cumsum(_ar(True, False, True, dtype=bool))),
    "sum_int32_int64": (lambda m, a: m.sum(a(_ar(1, 2, 3, dtype=onp.int32))),
                        onp.sum(_ar(1, 2, 3, dtype=onp.int32))),
    "sum_bool_int64": (lambda m, a: m.sum(a(_ar(True, True, dtype=bool))),
                       onp.int64(2)),
    "clip_lower_none": (lambda m, a: m.clip(a(A5), None, 2.5),
                        onp.clip(A5, None, 2.5)),
    "clip_upper_none": (lambda m, a: m.clip(a(A5), 1.5, None),
                        onp.clip(A5, 1.5, None)),
    "interp_left_right": (lambda m, a: m.interp(
        a(_ar(-5, 0.5, 9)), a(_ar(0, 1, 2)), a(_ar(1, 3, 2)), left=-1.0,
        right=7.0),
        onp.interp(_ar(-5, 0.5, 9), _ar(0, 1, 2), _ar(1, 3, 2), left=-1.0,
                   right=7.0)),
    "interp_period": (lambda m, a: m.interp(
        a(_ar(-180, -170, -185, 185, -10, -5, 0, 365)),
        a(_ar(190, -190, 350, -350)), a(_ar(5, 10, 3, 4)), period=360),
        onp.interp(_ar(-180, -170, -185, 185, -10, -5, 0, 365),
                   _ar(190, -190, 350, -350), _ar(5, 10, 3, 4), period=360)),
    "unwrap": (lambda m, a: m.unwrap(a(_ar(0, 0.78, 5.49, 6.28))),
               onp.unwrap(_ar(0, 0.78, 5.49, 6.28))),
    "gradient_coordinates": (lambda m, a: m.gradient(
        a(_ar(1, 2, 4, 7, 11)), a(_ar(0, 1, 1.5, 3.5, 4))),
        onp.gradient(_ar(1, 2, 4, 7, 11), _ar(0, 1, 1.5, 3.5, 4))),
    "gradient_edge_order_2": (lambda m, a: m.gradient(
        a(_ar(1, 2, 4, 7, 11)), 2.0, edge_order=2),
        onp.gradient(_ar(1, 2, 4, 7, 11), 2.0, edge_order=2)),
    "gradient_edge_order_2_coordinates": (lambda m, a: m.gradient(
        a(_ar(1, 2, 4, 7, 11)), a(_ar(0, 1, 1.5, 3.5, 4)), edge_order=2),
        onp.gradient(_ar(1, 2, 4, 7, 11), _ar(0, 1, 1.5, 3.5, 4),
                     edge_order=2)),
    "select_default": (lambda m, a: m.select(
        [a(onp.arange(6) < 3), a(onp.arange(6) > 4)],
        [a(onp.arange(6, dtype=F)), a(onp.arange(6, dtype=F) ** 2)], 42.0),
        onp.select([onp.arange(6) < 3, onp.arange(6) > 4],
                   [onp.arange(6, dtype=F), onp.arange(6, dtype=F) ** 2],
                   F(42))),
    "packbits_little": (lambda m, a: m.packbits(
        a(_ar([1, 0, 1], [0, 1, 1], dtype=onp.uint8)), axis=1,
        bitorder="little"),
        onp.packbits(_ar([1, 0, 1], [0, 1, 1], dtype=onp.uint8), axis=1,
                     bitorder="little")),
    "unpackbits_count": (lambda m, a: m.unpackbits(
        a(_ar([2], [7], dtype=onp.uint8)), axis=1, count=-3),
        onp.unpackbits(_ar([2], [7], dtype=onp.uint8), axis=1, count=-3)),
    "lexsort": (lambda m, a: m.lexsort((a(_ar(1, 5, 1, 4, 3, 4, 4)),
                                        a(_ar(9, 4, 0, 4, 0, 2, 1)))),
                onp.lexsort((_ar(1, 5, 1, 4, 3, 4, 4),
                             _ar(9, 4, 0, 4, 0, 2, 1)))),
    "histogram_weights": (lambda m, a: m.histogram(
        a(_ar(1, 2, 1)), bins=a(_ar(0, 1, 2, 3)),
        weights=a(_ar(0.5, 2, 1)))[0],
        onp.histogram(_ar(1, 2, 1), bins=[0, 1, 2, 3],
                      weights=_ar(0.5, 2, 1))[0]),
    "histogram_density": (lambda m, a: m.histogram(
        a(_ar(1, 2, 1, 2.5)), bins=3, density=True)[0],
        onp.histogram(_ar(1, 2, 1, 2.5), bins=3, density=True)[0]),
    "digitize_decreasing_bins": (lambda m, a: m.digitize(
        a(_ar(0.5, 1.5, 2.5, 3.0)), a(_ar(3, 2, 1))),
        onp.digitize(_ar(0.5, 1.5, 2.5, 3.0), _ar(3, 2, 1))),
    "partition_kth_in_place": (lambda m, a: m.partition(
        a(_ar(3, 4, 2, 1)), 2)[2], 3.0),
    "insert_sequence": (lambda m, a: m.insert(a(A6), onp.array([0, 2, 2]),
                                              9.0, axis=1),
                        onp.insert(A6, [0, 2, 2], 9.0, axis=1)),
    "delete_slice": (lambda m, a: m.delete(a(A10), slice(1, 8, 3)),
                     onp.delete(A10, slice(1, 8, 3))),
    "subtract_bool_int": (lambda m, a: m.subtract(a(_ar(True, False,
                                                        dtype=bool)),
                                                  a(_ar(1, 2,
                                                        dtype=onp.int32))),
                          onp.subtract(_ar(True, False, dtype=bool),
                                       _ar(1, 2, dtype=onp.int32))),
}

# the reference's jnp refuses these calls (an integer round to negative
# decimals; a slice as positions; gradient's edge_order; an array of bin
# edges); the port is held to numpy alone
REF_REJECTS = {"around_int_negative_decimals", "delete_slice",
               "gradient_edge_order_2", "gradient_edge_order_2_coordinates",
               "histogram_weights"}


@pytest.mark.parametrize("label", sorted(TORCH_DIFFERS))
def test_where_torch_differs_from_numpy(label):
    fn, want = TORCH_DIFFERS[label]
    got = _val(fn(tnp, tnp.array))
    want = onp.asarray(want)
    assert got.shape == want.shape
    onp.testing.assert_allclose(onp.asarray(got, onp.float64),
                                onp.asarray(want, onp.float64), rtol=1e-5,
                                atol=1e-6)
    if want.dtype.kind in "biu" and label != "partition_kth_in_place":
        assert got.dtype.kind == want.dtype.kind
    if label not in REF_REJECTS:
        ref = _val(fn(jnp_, jnp_.array))
        onp.testing.assert_allclose(onp.asarray(got, onp.float64),
                                    onp.asarray(ref, onp.float64), rtol=1e-5,
                                    atol=1e-6)
        assert got.dtype == ref.dtype or (
            got.dtype == onp.float32 and ref.dtype == onp.float64
            and label in ("hanning_symmetric", "blackman_symmetric",
                          "window_of_one", "kaiser")), (got.dtype, ref.dtype)


def test_quantile_past_torch_quantile_input_limit():
    """``torch.quantile`` refuses inputs over 2**24 elements; the port
    sorts instead."""
    x = onp.random.RandomState(0).rand((1 << 24) + 3).astype(F)
    got = tnp.median(tnp.array(x)).asnumpy()
    onp.testing.assert_allclose(got, onp.median(x), rtol=1e-6)


# -- C.7: float32 where the reference's float64 comes from its x64 default -----

DEPARTURES = {
    "zeros": lambda m: m.zeros((2,)),
    "ones": lambda m: m.ones((2,)),
    "full_float": lambda m: m.full((2,), 1.5),
    "empty": lambda m: m.empty((2,)),
    "eye": lambda m: m.eye(2),
    "identity": lambda m: m.identity(2),
    "arange_float": lambda m: m.arange(5.0),
    "linspace": lambda m: m.linspace(0, 1, 3),
    "logspace": lambda m: m.logspace(0, 1, 3),
    "geomspace": lambda m: m.geomspace(1, 8, 4),
    "hanning": lambda m: m.hanning(4),
    "kaiser": lambda m: m.kaiser(4, 2.0),
    "fromfunction": lambda m: m.fromfunction(lambda i, j: i + j, (2, 2)),
    "fftfreq": lambda m: m.fft.fftfreq(4),
    "rfftfreq": lambda m: m.fft.rfftfreq(4),
    "true_divide_int64": lambda m: m.divide(m.array([1, 2]), m.array([2, 2])),
    "mean_int64": lambda m: m.mean(m.array([1, 2, 4])),
    "std_int64": lambda m: m.std(m.array([1, 2, 4])),
    "var_int64": lambda m: m.var(m.array([1, 2, 4])),
    "sqrt_int64": lambda m: m.sqrt(m.array([1, 2, 4])),
    "interp_int64": lambda m: m.interp(m.array([1, 2]), m.array([0, 3]),
                                       m.array([0, 6])),
    "histogram_edges_int64": lambda m: m.histogram(m.array([1, 2, 5]),
                                                   bins=2)[1],
}


@pytest.mark.parametrize("label", sorted(DEPARTURES))
def test_float32_where_the_reference_has_x64_float64(label):
    got = DEPARTURES[label](tnp).asnumpy()
    ref = DEPARTURES[label](jnp_).asnumpy()
    assert got.dtype == onp.float32 and ref.dtype == onp.float64
    onp.testing.assert_allclose(got, ref, rtol=1e-6)


def test_python_ints_stay_int64_and_floats_float32():
    for m in (tnp, jnp_):
        assert m.array([1, 2]).dtype == onp.int64
        assert m.array([1.0, 2]).dtype == onp.float32
        assert m.array(onp.array([1.0])).dtype == onp.float64
        assert m.full((2,), 3).dtype == onp.int64
        assert m.arange(3).dtype == onp.int64


def test_as_np_ndarray_is_the_array_itself():
    """nd and np share one type: the port returns the array; the
    reference's raises ``AttributeError`` (ROADMAP C.7)."""
    a = mx.nd.array(onp.ones(3, F))
    assert a.as_np_ndarray() is a
    assert isinstance(a, tnp.ndarray)
    with pytest.raises(AttributeError):
        jmx.nd.array(onp.ones(3, F)).as_np_ndarray()


def test_host_valued_functions_take_arrays():
    """The shape, dtype and kind helpers answer with host values."""
    a = tnp.array(A6)
    assert tnp.ndim(a) == 2 and tnp.size(a) == 6 and tnp.shape(a) == (2, 3)
    assert tnp.size(a, 1) == 3
    assert tnp.iscomplexobj(a) is False and tnp.isrealobj(a) is True
    assert tnp.iscomplexobj(tnp.fft.fft(a)) is True
    assert tnp.isscalar(3.0) and not tnp.isscalar(a)
    assert tnp.result_type(a, 1.5) == onp.float32
    assert tnp.result_type("int32", "int8") == onp.int32
    assert tnp.can_cast("int32", "int64") and not tnp.can_cast("float64",
                                                               "int32")


# -- the copy-returning writers ---------------------------------------------------

WRITERS = {
    "put": (lambda m, a: m.put(a, m.array(onp.array([0, 2])),
                               m.array(_ar(9, 8))),
            lambda x: (onp.put(x, [0, 2], [9, 8]), x)[1]),
    "place": (lambda m, a: m.place(a, a > 2, m.array(_ar(5, 6))),
              lambda x: (onp.place(x, x > 2, [5, 6]), x)[1]),
    "fill_diagonal": (lambda m, a: m.fill_diagonal(a, 7.0),
                      lambda x: (onp.fill_diagonal(x, 7.0), x)[1]),
    "put_along_axis": (lambda m, a: m.put_along_axis(
        a, m.array(onp.array([[1], [0], [2]])), 9.0, 1, inplace=False),
        lambda x: (onp.put_along_axis(x, onp.array([[1], [0], [2]]), 9.0,
                                      1), x)[1]),
}


@pytest.mark.parametrize("label", sorted(WRITERS))
def test_writers_return_the_updated_copy(label):
    fn, ref_fn = WRITERS[label]
    x = onp.arange(9, dtype=F).reshape(3, 3)
    want = ref_fn(x.copy())
    for m in (tnp, jnp_):
        a = m.array(x)
        got = fn(m, a).asnumpy()
        onp.testing.assert_array_equal(got, want)
        onp.testing.assert_array_equal(a.asnumpy(), x)


def test_block_unwraps_nested_lists():
    a, b = onp.ones((2, 2), F), onp.zeros((2, 3), F)
    want = onp.block([[a, b], [b[:, :2], a[:, :1].repeat(3, 1)]])
    for m in (tnp, jnp_):
        got = m.block([[m.array(a), m.array(b)],
                       [m.array(b[:, :2]), m.array(a[:, :1].repeat(3, 1))]])
        onp.testing.assert_array_equal(got.asnumpy(), want)


def test_mask_indices_and_fromiter():
    for m in (tnp, jnp_):
        got = m.mask_indices(3, m.triu)
        for g, w in zip(got, onp.mask_indices(3, onp.triu)):
            onp.testing.assert_array_equal(g.asnumpy(), w)
        onp.testing.assert_array_equal(
            m.fromiter((float(i) for i in range(4)), dtype="float32").asnumpy(),
            onp.arange(4, dtype=F))


# -- vectorize ----------------------------------------------------------------------

def test_vectorize_maps_over_broadcast_elements():
    """The reference's case, an excluded argument, and a tuple result:
    ``pyfunc`` sees 0-d tensors through ``torch.vmap``."""
    x = onp.random.RandomState(81).randn(4, 5).astype(F)
    f = tnp.vectorize(lambda a, b: a * b + 1.0)
    onp.testing.assert_allclose(f(tnp.array(x), tnp.array(x)).asnumpy(),
                                x * x + 1.0, rtol=1e-6)
    g = tnp.vectorize(lambda a, s: a * s, excluded={1})
    onp.testing.assert_allclose(g(tnp.array(x[0]), 3.0).asnumpy(),
                                x[0] * 3.0, rtol=1e-6)
    h = tnp.vectorize(lambda a, b: (a + b, a - b))
    s, d = h(tnp.array(x[:1]), tnp.array(x[:, :1]))
    assert s.shape == (4, 5)
    onp.testing.assert_allclose(d.asnumpy(), x[:1] - x[:, :1], rtol=1e-6)
    ref = jnp_.vectorize(lambda a, b: a * b + 1.0)(jnp_.array(x),
                                                   jnp_.array(x))
    onp.testing.assert_allclose(ref.asnumpy(), x * x + 1.0, rtol=1e-6)


# -- np.random --------------------------------------------------------------------

def test_random_shapes_dtypes_ranges_and_moments():
    """As the reference's tests hold it: the stream is the port's own."""
    r = tnp.random
    mx.random.seed(7)
    u = r.uniform(0, 1, size=(20000,)).asnumpy()
    assert u.dtype == onp.float32 and 0.48 < u.mean() < 0.52
    assert u.min() >= 0 and u.max() <= 1
    g = r.normal(2.0, 3.0, size=(20000,)).asnumpy()
    assert abs(g.mean() - 2.0) < 0.1 and abs(g.std() - 3.0) < 0.1
    ri = r.randint(0, 10, size=(5000,)).asnumpy()
    assert ri.dtype == onp.int64 and set(onp.unique(ri)) <= set(range(10))
    assert r.randint(5, size=(3, 2)).shape == (3, 2)
    assert r.rand(2, 3).shape == (2, 3) and r.randn(4).shape == (4,)
    c = r.choice(5, size=(1000,)).asnumpy()
    assert set(onp.unique(c)) <= set(range(5))
    p = r.choice(tnp.array(_ar(10, 20, 30)), size=(2000,),
                 p=_ar(0.0, 0.5, 0.5)).asnumpy()
    assert set(onp.unique(p)) <= {20.0, 30.0}
    perm = r.choice(6, size=6, replace=False).asnumpy()
    assert sorted(perm.tolist()) == list(range(6))
    x = tnp.arange(10)
    r.shuffle(x)
    assert sorted(x.asnumpy().tolist()) == list(range(10))


def test_random_seed_repeats_the_draws():
    tnp.random.seed(42)
    a = tnp.random.normal(size=(5,)).asnumpy()
    mx.random.seed(42)
    b = tnp.random.normal(size=(5,)).asnumpy()
    onp.testing.assert_array_equal(a, b)
    mx.random.seed(43)
    assert not onp.array_equal(a, tnp.random.normal(size=(5,)).asnumpy())


def test_creation_and_random_follow_the_context():
    with mx.cpu(1):
        z = tnp.zeros((2,))
    assert z.context == mx.cpu(1)
    assert tnp.ones((2,), ctx=mx.cpu_pinned()).context == mx.cpu_pinned()
    assert tnp.random.uniform(size=(2,), ctx=mx.cpu(2)).context == mx.cpu(2)


# -- hybridized blocks and the registry's hooks ------------------------------------

def _np_block(m):
    class Head(m.gluon.HybridBlock):
        def hybrid_forward(self, F, x, labels):
            logp = m.npx.log_softmax(m.np.astype(x, "float32"), axis=-1)
            picked = m.np.take_along_axis(
                logp, m.np.expand_dims(labels, -1), axis=-1)
            return m.np.negative(m.np.mean(m.np.tanh(picked) + picked))
    return Head()


@pytest.mark.parametrize("hybridize", [False, True],
                         ids=["imperative", "hybridized"])
def test_np_in_a_hybrid_block_matches_reference(hybridize):
    """A block written in ``mx.np``/``npx``: outputs and input gradients
    equal the reference's, hybridized (the port's ``F`` path hands the np
    functions bare tensors) and not."""
    r = onp.random.RandomState(3)
    x = r.randn(2, 5, 7).astype(F)
    lab = r.randint(0, 7, (2, 5))
    outs = []
    for pkg in (jmx, mx):
        blk = _np_block(pkg)
        if hybridize:
            blk.hybridize()
        xa = pkg.np.array(x)
        xa.attach_grad()
        with pkg.autograd.record():
            y = blk(xa, pkg.np.array(lab))
        y.backward()
        outs.append((y.asnumpy(), xa.grad.asnumpy()))
    (jy, jg), (ty, tg) = outs
    onp.testing.assert_allclose(ty, jy, rtol=1e-6)
    onp.testing.assert_allclose(tg, jg, rtol=1e-5, atol=1e-7)


def test_hooks_see_np_ops():
    """amp's cast hook and the monitors see ``np.*`` dispatches, on the
    NDArray path and the bare-tensor path alike."""
    from mxnet_tpu_torch.ops import registry
    seen_cast, seen_mon = [], []

    def cast(name, tensors):
        seen_cast.append(name)
        return tensors

    def mon(name, outs):
        seen_mon.append(name)
    registry.set_dispatch_cast_hook(cast)
    registry.add_monitor_hook(mon)
    try:
        a = tnp.array(A6)
        tnp.tanh(a)
        tnp.sum(a._data)
    finally:
        registry.set_dispatch_cast_hook(None)
        registry.remove_monitor_hook(mon)
    assert "np.tanh" in seen_cast and "np.sum" in seen_cast
    assert seen_mon == ["np.tanh"]


def test_tensor_path_returns_tensors():
    import torch
    t = torch.arange(6.0).reshape(2, 3)
    out = tnp.split(t, 3, axis=1)
    assert isinstance(out, list) and all(isinstance(o, torch.Tensor)
                                         for o in out)
    assert isinstance(tnp.nonzero(t > 2), tuple)
    assert isinstance(tnp.nonzero(tnp.array(A6) > 2), tuple)


# -- linear algebra where torch's CUDA path differs from numpy's ---------------------

def test_lstsq_rank_deficient_gives_numpys_four_outputs():
    """torch's CUDA lstsq (``gels``) assumes full rank and returns neither
    residuals, rank nor singular values; the port's SVD gives numpy's
    four outputs, the minimum-norm solution at deficient rank."""
    r = onp.random.RandomState(5)
    a = r.randn(6, 3)
    deficient = onp.concatenate([a[:, :2], a[:, :1] + a[:, 1:2]], 1)
    b = r.randn(6)
    for A in (a, deficient):
        got = [v.asnumpy() for v in tnp.linalg.lstsq(tnp.array(A),
                                                      tnp.array(b))]
        want = onp.linalg.lstsq(A, b, rcond=None)
        onp.testing.assert_allclose(got[0], want[0], rtol=1e-10)
        assert got[1].shape == want[1].shape
        onp.testing.assert_allclose(got[1], want[1], rtol=1e-10)
        assert int(got[2]) == want[2]
        onp.testing.assert_allclose(got[3], want[3], rtol=1e-10,
                                    atol=1e-14 * want[3].max())


def test_rank_pinv_cond_use_numpys_tolerances():
    """In float64, where numpy computes: numpy's values.  In float32 a
    rank-deficient pinv cuts at max(M, N) x eps as the reference's does
    (numpy's 1e-15 would keep float32 round-off as a singular value)."""
    r = onp.random.RandomState(6)
    a = r.randn(5, 3)
    m = onp.concatenate([a, a[:, :1] * 2], 1)            # rank 3 of 4
    t = tnp.array(m)
    assert int(tnp.linalg.matrix_rank(t).asnumpy()) == \
        onp.linalg.matrix_rank(m) == 3
    onp.testing.assert_allclose(tnp.linalg.pinv(t).asnumpy(),
                                onp.linalg.pinv(m), rtol=1e-8, atol=1e-12)
    m32 = m.astype(F)
    onp.testing.assert_allclose(tnp.linalg.pinv(tnp.array(m32)).asnumpy(),
                                jnp_.linalg.pinv(jnp_.array(m32)).asnumpy(),
                                rtol=1e-3, atol=1e-5)
    sq = a[:3] + 3 * onp.eye(3)
    for p in (None, 1, 2, -2, "fro", onp.inf):
        onp.testing.assert_allclose(
            tnp.linalg.cond(tnp.array(sq), p).asnumpy(),
            onp.linalg.cond(sq, p), rtol=1e-10)


def test_registry_invoke_of_an_np_op_runs_on_the_current_context(
        monkeypatch):
    """``mx.ops.invoke`` of a creation op with no inputs makes its array on
    the current context, as ``mx.np`` does: under ``with mx.gpu():`` the
    card, which here stands as torch's ``meta`` device."""
    import torch
    from mxnet_tpu_torch import context as mctx
    resolve = mctx.resolve_device

    def card_as_meta(ctx=None):
        c = ctx if ctx is not None else mctx.current_context()
        if isinstance(c, mctx.Context) and c.device_type == "gpu":
            return torch.device("meta")
        return resolve(ctx)

    monkeypatch.setattr(mctx, "resolve_device", card_as_meta)
    with mx.gpu():
        for name, attrs in [("zeros", {"shape": (2, 3)}),
                            ("ones", {"shape": (4,)}),
                            ("arange", {"start": 5}),
                            ("eye", {"N": 3}), ("hanning", {"M": 4})]:
            out = mx.ops.invoke("np." + name, [], attrs)
            assert out._data.device.type == "meta", name
    # on the host, an array op through the registry equals mx.np's call
    x = tnp.array(A6)
    got = mx.ops.invoke("np.append", [x], {"values": [[7.0, 8.0, 9.0]],
                                           "axis": 0})
    want = jnp_.append(jnp_.array(A6), jnp_.array([[7.0, 8.0, 9.0]],
                                                   dtype=F), axis=0)
    onp.testing.assert_array_equal(got.asnumpy(), want.asnumpy())
    onp.testing.assert_array_equal(
        got.asnumpy(), tnp.append(x, [[7.0, 8.0, 9.0]], axis=0).asnumpy())
    parts = mx.ops.invoke("np.split", [tnp.arange(6)],
                          {"indices_or_sections": 3})
    assert [p.asnumpy().tolist() for p in parts] == [[0, 1], [2, 3], [4, 5]]


def test_mx_np_runs_the_registered_op(monkeypatch):
    """``mx.np.<name>`` and ``mx.ops.invoke("np.<name>")`` run one callable;
    a name whose answer is a host value refuses the registry."""
    op = mx.ops.get("np.add")
    calls = []
    impl = op.fn.impl

    def spy(*args, **kwargs):
        calls.append(len(args))
        return impl(*args, **kwargs)

    monkeypatch.setattr(op.fn, "impl", spy)
    tnp.add(tnp.array(A5), 1.0)
    mx.ops.invoke("np.add", [tnp.array(A5), tnp.array(A5)])
    assert calls == [2, 2]
    with pytest.raises(mx.base.MXNetError, match="host value"):
        mx.ops.invoke("np.shape", [tnp.array(A5)])
    assert tnp.shape(tnp.array(A6)) == (2, 3)


SINGULAR = onp.array([[1.0, 2.0], [2.0, 4.0]], F)
INDEFINITE = onp.array([[1.0, 2.0], [2.0, 1.0]], F)


@pytest.mark.parametrize("name,args", [
    ("inv", (SINGULAR,)),
    ("solve", (SINGULAR, onp.ones(2, F))),
    ("cholesky", (INDEFINITE,)),
    ("cholesky", (SINGULAR,)),
], ids=["inv", "solve", "cholesky_indefinite", "cholesky_singular"])
def test_linalg_of_a_singular_matrix_matches_reference(name, args):
    """jnp raises nothing on a singular or indefinite matrix: inf/nan come
    back, and so they do from the port (no LAPACK info is checked)."""
    got = getattr(tnp.linalg, name)(*[tnp.array(a) for a in args])
    want = getattr(jnp_.linalg, name)(*[jnp_.array(a) for a in args])
    onp.testing.assert_array_equal(got.asnumpy(), want.asnumpy())
    assert got.dtype == want.dtype


@pytest.mark.parametrize("axes", [None, (0, 1)])
def test_tensorsolve_and_tensorinv_match_reference(axes):
    r = onp.random.RandomState(3)
    a = r.randn(2, 3, 6).astype(F) if axes else r.randn(6, 2, 3).astype(F)
    b = r.randn(6).astype(F)
    got = tnp.linalg.tensorsolve(tnp.array(a), tnp.array(b), axes=axes)
    want = jnp_.linalg.tensorsolve(jnp_.array(a), jnp_.array(b), axes=axes)
    onp.testing.assert_allclose(got.asnumpy(), want.asnumpy(), rtol=1e-4,
                                atol=1e-5)
    a = r.randn(2, 3, 6).astype(F)
    got = tnp.linalg.tensorinv(tnp.array(a), ind=2)
    want = jnp_.linalg.tensorinv(jnp_.array(a), ind=2)
    assert got.shape == want.shape
    onp.testing.assert_allclose(got.asnumpy(), want.asnumpy(), rtol=1e-4,
                                atol=1e-5)


def test_random_number_parameters_are_fills(monkeypatch):
    """A Python number given as ``low``/``high``/``loc``/``scale`` becomes
    a device fill, never a copy from the host."""
    import torch

    def no_copy(*args, **kwargs):
        raise AssertionError("a host copy of a Python number")

    monkeypatch.setattr(torch, "as_tensor", no_copy)
    u = tnp.random.uniform(-1.0, 2, size=(1000,))
    z = tnp.random.normal(0.5, onp.float32(2.0), size=(1000,))
    assert u.dtype == onp.float32 and z.dtype == onp.float32
    v = u.asnumpy()
    assert v.min() >= -1.0 and v.max() < 2.0
    assert abs(float(z.asnumpy().mean()) - 0.5) < 0.3
