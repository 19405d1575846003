"""The port's device mesh and eager collectives (``parallel.py``) against
the reference's on the 8 forced host devices (``tests/conftest.py``).

The port's shards are host Contexts ``cpu(0)`` ... ``cpu(7)`` in one
process, the reference's the 8 host devices.  Errors match the
reference's messages; sums and concatenations of small integers are
exact, so outputs are compared for equality (tolerance 0).
"""

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import parallel as jparallel

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import parallel
from mxnet_tpu_torch.base import MXNetError

N = 8


@pytest.fixture(autouse=True)
def _no_current_mesh():
    saved = parallel.current_mesh(), jparallel.current_mesh()
    yield
    parallel.set_mesh(saved[0])
    jparallel.set_mesh(saved[1])


def _ctxs(n=N):
    return [mx.cpu(i) for i in range(n)]


def _jctxs(n=N):
    return jparallel.data_parallel_ctxs()[:n]


def _message(fn):
    try:
        fn()
    except Exception as e:          # noqa: BLE001 - the message is compared
        return str(e)
    raise AssertionError("no error")


@pytest.mark.parametrize("kw", [
    dict(shape=(3,), axis_names=("dp",)),
    dict(shape=(2, 4), axis_names=("dp",)),
    dict(shape=(2, 2, 2), axis_names=("dp", "sp"))])
def test_mesh_errors_match_reference(kw):
    import jax
    with pytest.raises(MXNetError):
        parallel.DeviceMesh(devices=_ctxs(), **kw)
    assert _message(lambda: parallel.DeviceMesh(devices=_ctxs(), **kw)) == \
        _message(lambda: jparallel.DeviceMesh(devices=jax.devices()[:N],
                                              **kw))


def test_spec_axis_size_ctxs_and_repr():
    import jax
    mesh = parallel.DeviceMesh((2, 4), ("dp", "sp"), devices=_ctxs())
    ref = jparallel.DeviceMesh((2, 4), ("dp", "sp"),
                               devices=jax.devices()[:N])
    assert repr(mesh) == repr(ref) == "DeviceMesh(dp=2, sp=4)"
    assert (mesh.size, mesh.axis_size("dp"), mesh.axis_size("sp")) == \
        (ref.size, ref.axis_size("dp"), ref.axis_size("sp")) == (8, 2, 4)
    assert [str(c) for c in mesh.ctxs()] == [str(c) for c in ref.ctxs()]
    assert mesh.devices == [torch.device("cpu")] * N
    for spec in [("dp",), (None, "sp"), (("dp", "sp"),), ()]:
        placed = mesh.sharded(*spec)
        assert isinstance(placed, parallel.Placement)
        assert placed.mesh is mesh
        assert placed.spec == tuple(ref.spec(*spec))
    assert mesh.replicated().spec == tuple(ref.replicated().spec) == ()
    for bad in [("tp",), (None, ("dp", "tp"))]:
        with pytest.raises(MXNetError):
            mesh.spec(*bad)
        assert _message(lambda: mesh.sharded(*bad)) == \
            _message(lambda: ref.sharded(*bad))
    assert mesh.axis_devices("sp") == [torch.device("cpu")] * 4
    with pytest.raises(MXNetError, match="no axis 'tp'"):
        mesh.axis_devices("tp")


def test_mesh_of_one_card_and_defaults():
    """Shards may repeat one card; the default mesh is every visible card
    (the host here); make_mesh makes its mesh current."""
    mesh = parallel.DeviceMesh((2, 4), ("dp", "sp"), devices=[mx.gpu(0)] * 8)
    assert mesh.devices == [torch.device("cuda", 0)] * 8
    assert mesh.axis_devices("sp") == [torch.device("cuda", 0)] * 4
    mixed = parallel.DeviceMesh(devices=[torch.device("cpu"), "cpu"])
    assert [str(c) for c in mixed.ctxs()] == ["cpu(0)", "cpu(0)"]
    assert parallel.data_parallel_ctxs() == [mx.cpu(0)]
    assert parallel.DeviceMesh().ctxs() == [mx.cpu(0)]
    assert parallel.current_mesh() is None
    made = parallel.make_mesh((8,), ("sp",), devices=_ctxs())
    assert parallel.current_mesh() is made
    assert parallel.set_mesh(None) is None and parallel.current_mesh() is None


def _pair(values, jvalues, fn, jfn):
    got = fn([mx.nd.array(v, ctx=c) for v, c in zip(values, _ctxs())])
    want = jfn([jmx.nd.array(v, ctx=c) for v, c in zip(jvalues, _jctxs())])
    return got, want


@pytest.mark.parametrize("op", ["sum", "mean"])
def test_allreduce_matches_reference(op):
    vals = [np.full((2, 2), float(i), np.float32) for i in range(N)]
    mesh = parallel.DeviceMesh(devices=_ctxs())
    got, want = _pair(vals, vals,
                      lambda v: parallel.allreduce(v, mesh=mesh, op=op),
                      lambda v: jparallel.allreduce(
                          v, mesh=jparallel.DeviceMesh(), op=op))
    assert len(got) == len(want) == N
    for g, w, c in zip(got, want, _ctxs()):
        assert g.ctx == c and g.dtype == w.dtype
        np.testing.assert_array_equal(g.asnumpy(), w.asnumpy())
    with pytest.raises(MXNetError, match="'sum' or 'mean'"):
        parallel.allreduce(got, mesh=mesh, op="max")


def test_allreduce_subset_of_mesh():
    """Fewer values than the current mesh's shards: exactly those are
    reduced, and the current mesh stays."""
    mesh = parallel.make_mesh(devices=_ctxs())
    jparallel.make_mesh()
    vals = [np.full((2,), float(i + 1), np.float32) for i in range(4)]
    got = parallel.allreduce([mx.nd.array(v, ctx=c)
                              for v, c in zip(vals, _ctxs(4))])
    want = jparallel.allreduce([jmx.nd.array(v, ctx=c)
                                for v, c in zip(vals, _jctxs(4))])
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.asnumpy(), w.asnumpy())
        np.testing.assert_array_equal(g.asnumpy(), 10.0)
    assert parallel.current_mesh() is mesh and mesh.size == N


def test_allgather_matches_reference():
    vals = [np.full((2, 3), float(i), np.float32) for i in range(4)]
    got = parallel.allgather([mx.nd.array(v, ctx=c)
                              for v, c in zip(vals, _ctxs(4))])
    want = jparallel.allgather([jmx.nd.array(v, ctx=c)
                                for v, c in zip(vals, _jctxs(4))])
    assert len(got) == 4
    for g, w, c in zip(got, want, _ctxs(4)):
        assert g.shape == w.shape == (8, 3) and g.ctx == c
        np.testing.assert_array_equal(g.asnumpy(), w.asnumpy())
    one = [mx.nd.array(vals[0], ctx=mx.cpu())]
    assert parallel.allgather(one) == one and parallel.allreduce(one) == one


def test_collectives_of_bare_tensors():
    """Tensors (not NDArrays) are accepted; the results are NDArrays on
    each tensor's device, and on one device they share the result."""
    ts = [torch.full((3,), float(i)) for i in range(3)]
    out = parallel.allreduce(ts)
    assert [str(o.ctx) for o in out] == ["cpu(0)"] * 3
    np.testing.assert_array_equal(out[0].asnumpy(), 3.0)
    assert out[0]._data is out[1]._data
