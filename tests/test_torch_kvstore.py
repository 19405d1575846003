"""The port's kvstore (``mx.kv``, ``KVStoreLocal``, ``fusion``), Parameters
on several contexts, ``gluon.utils`` and the Trainer over replicas, held
against the JAX package's, on the CPU.

Several contexts are host contexts ``cpu(0)``, ``cpu(1)``, ... as in the
reference's own tests (its suite runs JAX with 8 host devices; torch has
one host device, and an NDArray remembers which host context it was put
on).  Tolerances: reductions bit for bit (``tree_sum`` adds in one fixed
order in both packages); Trainer weights after 3 steps 1e-5 of each
tensor's max |ref| (the replicas' forward and backward are torch's and
XLA's CPU matmuls); a states file carried across, then one more step,
1e-5 likewise.
"""

import threading

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import mxnet_tpu as jmx
from mxnet_tpu.kvstore import fusion as jfusion
import mxnet_tpu_torch as mx
from mxnet_tpu_torch.kvstore import fusion

TOL = 1e-5


@pytest.fixture(autouse=True)
def _on_cpu():
    with mx.cpu():
        yield


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _spread(rng, n, shape=(257,)):
    """Replica values of very different magnitudes: the association of
    their adds shows in the last bits."""
    return [(rng.standard_normal(shape) * 10.0 ** rng.integers(-4, 5))
            .astype(np.float32) for _ in range(n)]


# -- tree_sum and the buckets -------------------------------------------------

@pytest.mark.parametrize("n", [1, 2, 3, 4, 5])
def test_tree_sum_bit_identical_to_the_reference(n):
    vals = _spread(np.random.default_rng(n), n)
    want = np.asarray(jfusion.tree_sum([jnp.asarray(v) for v in vals]))
    got = fusion.tree_sum([torch.from_numpy(v) for v in vals]).numpy()
    assert got.tobytes() == want.tobytes()
    # the bucket path (one foreach add per tree level) adds the same way
    b = fusion.GradBucketer(1 << 20).plan((((257,), torch.float32, n),))[0]
    (bucketed,) = fusion.GradBucketer.reduce_bucket(
        b, [torch.from_numpy(v) for v in vals])
    assert bucketed.numpy().tobytes() == want.tobytes()


def test_bucket_plan_matches_reference():
    keys = [((1000,), "float32", 2), ((3000,), "float32", 2),
            ((10,), "float16", 2), ((500,), "float32", 3),
            ((5000,), "float32", 2)]
    want = jfusion.GradBucketer(16 * 1024).plan(tuple(keys))
    got = fusion.GradBucketer(16 * 1024).plan(tuple(
        (s, getattr(torch, d), n) for s, d, n in keys))
    assert [list(b.positions) for b in got] == \
        [list(b.positions) for b in want]
    assert [b.nbytes for b in got] == [b.nbytes for b in want]


# -- KVStoreLocal -------------------------------------------------------------

def test_create_names():
    for name in ("local", "device", "nccl", "local_update_cpu",
                 "local_allreduce_cpu", "local_allreduce_device"):
        kv = mx.kv.create(name)
        assert isinstance(kv, mx.kv.KVStoreLocal) and kv.type == name
        assert (kv.rank, kv.num_workers) == (0, 1)
    # the distributed names (tests/test_torch_dist_kvstore.py): the dist
    # store, dist_async and horovod raise as in the reference
    for name in ("dist_sync", "dist_device_sync"):
        assert isinstance(mx.kv.create(name), mx.kv.KVStoreDistTPUSync)
    for name in ("dist_async", "horovod"):
        with pytest.raises(mx.MXNetError, match="unsupported|not available"):
            mx.kv.create(name)
    with pytest.raises(mx.MXNetError, match="unknown"):
        mx.kv.create("rocket")


def test_plugin_backend_registers_by_class_name():
    @mx.kv.KVStoreBase.register
    class TestPortStore(mx.kv.KVStoreBase):
        @property
        def type(self):
            return "testportstore"

    assert isinstance(mx.kv.create("TestPortStore"), TestPortStore)
    assert mx.kv.KVStoreBase.registered("testportstore") is TestPortStore


def _stores(n, shape=(3, 4), seed=0):
    """The same init and pushed replica values in both packages, the port's
    on cpu(0..n-1)."""
    rng = np.random.default_rng(seed)
    init = rng.standard_normal(shape).astype(np.float32)
    vals = _spread(rng, n, shape)
    out = {}
    for m in (jmx, mx):
        kv = m.kv.create("local")
        kv.init(3, m.nd.array(init, ctx=m.cpu(0)))
        out[m] = (kv, [m.nd.array(v, ctx=m.cpu(i))
                       for i, v in enumerate(vals)])
    return out


def test_push_pull_over_four_contexts_matches_reference():
    stores = _stores(4)
    res = {}
    for m, (kv, vals) in stores.items():
        kv.push(3, vals)
        outs = [m.nd.zeros((3, 4), ctx=m.cpu(i)) for i in range(4)]
        kv.pull(3, out=outs)
        res[m] = [o.asnumpy() for o in outs]
        if m is mx:
            assert [o.ctx for o in outs] == [mx.cpu(i) for i in range(4)]
    for a, b in zip(res[mx], res[jmx]):
        assert a.tobytes() == b.tobytes()


def test_pushpull_and_pushpull_list_match_reference_bit_for_bit():
    rng = np.random.default_rng(7)
    shapes = [(4,), (3, 5), (7,), (2, 2)]
    reps = [[_spread(rng, 1, s)[0] for _ in range(4)] for s in shapes]
    res = {}
    for m in (jmx, mx):
        for mb in (0, 25):
            kv = m.kv.create("local")
            kv.set_bucket_size(mb)
            vals = [[m.nd.array(v, ctx=m.cpu(i)) for i, v in enumerate(r)]
                    for r in reps]
            for k, s in enumerate(shapes):
                kv.init(k, m.nd.zeros(s))
            kv.pushpull_list(list(range(4)), vals, vals)
            res[(m, mb)] = [[x.asnumpy().tobytes() for x in v] for v in vals]
        kv = m.kv.create("local")
        kv.init("w", m.nd.zeros((3, 5)))
        vals = [m.nd.array(v, ctx=m.cpu(i)) for i, v in enumerate(reps[1])]
        kv.pushpull("w", vals, out=vals)
        res[(m, "one")] = [x.asnumpy().tobytes() for x in vals]
    assert res[(mx, 25)] == res[(mx, 0)] == res[(jmx, 25)] == res[(jmx, 0)]
    assert res[(mx, "one")] == res[(jmx, "one")] == res[(mx, 25)][1]


@pytest.mark.parametrize("name", ["sgd", "adam"])
def test_store_with_an_optimizer_matches_reference(name):
    stores = _stores(4, seed=3)
    res = {}
    for m, (kv, vals) in stores.items():
        kv.set_optimizer(m.optimizer.create(name, learning_rate=0.1,
                                            momentum=0.9) if name == "sgd"
                         else m.optimizer.create(name, learning_rate=0.1))
        outs = [m.nd.zeros((3, 4), ctx=m.cpu(i)) for i in range(4)]
        for _ in range(2):
            kv.push(3, vals)
            kv.pull(3, out=outs)
        res[m] = [o.asnumpy() for o in outs]
    for a, b in zip(res[mx], res[jmx]):
        assert _rel(a, b) <= 1e-6


def test_init_twice_and_unknown_key_raise():
    kv = mx.kv.create("local")
    kv.init("a", mx.nd.ones((2,)))
    with pytest.raises(mx.MXNetError):
        kv.init("a", mx.nd.ones((2,)))
    with pytest.raises(mx.MXNetError):
        kv.push("b", mx.nd.ones((2,)))
    # row_sparse keys are ported (tests/test_torch_sparse.py); a dense
    # output and a pull without row ids raise
    with pytest.raises(mx.MXNetError, match="RowSparseNDArray"):
        kv.row_sparse_pull("a", out=mx.nd.ones((2,)), row_ids=mx.nd.ones(1))
    with pytest.raises(mx.MXNetError, match="row_ids"):
        kv.row_sparse_pull("a", out=mx.nd.ones((2,)))
    with pytest.raises(mx.MXNetError):
        kv.save_optimizer_states("x")


# -- Parameters on several contexts and gluon.utils ---------------------------

def test_parameter_on_several_contexts():
    for m in (jmx, mx):
        ctxs = [m.cpu(i) for i in range(3)]
        p = m.gluon.Parameter("w", shape=(2, 3))
        p.initialize(init=m.init.Uniform(), ctx=ctxs)
        assert p.list_ctx() == ctxs
        data = [d.asnumpy() for d in p.list_data()]
        assert all(np.array_equal(d, data[0]) for d in data)
        assert p.data(ctxs[2]) is p.list_data()[2]
        assert p.grad(ctxs[1]) is p.list_grad()[1]
        p.set_data(m.nd.ones((2, 3)))
        assert all(d.asnumpy().sum() == 6 for d in p.list_data())
        with pytest.raises(m.MXNetError):
            p.data(m.cpu(5))
        p.reset_ctx([m.cpu(0), m.cpu(4)])
        assert p.list_ctx() == [m.cpu(0), m.cpu(4)]
        assert p.data(m.cpu(4)).asnumpy().sum() == 6
    # each replica is its own leaf, and the first is registered with torch
    t0, t1 = (d._data for d in p.list_data())
    assert isinstance(t0, torch.nn.Parameter) and t0 is not t1
    assert p.list_data()[1].ctx == mx.cpu(4)


def test_split_and_load_and_clip_global_norm_match_reference():
    x = np.random.RandomState(0).randn(10, 3).astype(np.float32)
    arrays = [np.random.RandomState(i).randn(4, 5).astype(np.float32)
              for i in range(3)]
    got = {}
    for m in (jmx, mx):
        parts = m.gluon.utils.split_and_load(
            x, [m.cpu(i) for i in range(3)], even_split=False)
        assert [p.ctx for p in parts] == [m.cpu(i) for i in range(3)]
        with pytest.raises(m.MXNetError):
            m.gluon.utils.split_data(m.nd.array(x), 3)
        nds = [m.nd.array(a) for a in arrays]
        norm = m.gluon.utils.clip_global_norm(nds, 1.0)
        got[m] = ([p.asnumpy() for p in parts], norm,
                  [a.asnumpy() for a in nds])
    for a, b in zip(got[mx][0], got[jmx][0]):
        assert np.array_equal(a, b)
    assert abs(got[mx][1] - got[jmx][1]) <= 1e-6 * got[jmx][1]
    for a, b in zip(got[mx][2], got[jmx][2]):
        assert _rel(a, b) <= 1e-6


# -- the Trainer over replicas ------------------------------------------------

def _fresh(build):
    out = {}
    t = threading.Thread(target=lambda: out.setdefault("v", build()))
    t.start()
    t.join(timeout=120)
    assert not t.is_alive()
    return out["v"]


def _net(m, n_ctx, seed=1, hybridize=False):
    def build():
        net = m.gluon.nn.HybridSequential(prefix="net_")
        with net.name_scope():
            net.add(m.gluon.nn.Dense(16, activation="relu", in_units=10),
                    m.gluon.nn.Dense(4, in_units=16))
        return net
    net = _fresh(build)
    net.initialize(m.init.Zero(), ctx=[m.cpu(i) for i in range(n_ctx)])
    r = np.random.RandomState(seed)
    for p in net.collect_params().values():
        p.set_data(m.nd.array(r.randn(*p.shape).astype(np.float32) * 0.3))
    if hybridize:
        net.hybridize()
    return net


def _steps(m, net, trainer, n_ctx, steps, seed=2):
    r = np.random.RandomState(seed)
    lossf = m.gluon.loss.SoftmaxCrossEntropyLoss()
    ctxs = [m.cpu(i) for i in range(n_ctx)]
    for _ in range(steps):
        x = r.randn(8, 10).astype(np.float32)
        y = r.randint(0, 4, (8,)).astype(np.float32)
        xs = m.gluon.utils.split_and_load(x, ctxs)
        ys = m.gluon.utils.split_and_load(y, ctxs)
        with m.autograd.record():
            losses = [lossf(net(a), b) for a, b in zip(xs, ys)]
        for L in losses:
            L.backward()
        trainer.step(8)


def _weights(net):
    return {k: [d.asnumpy() for d in p.list_data()]
            for k, p in net.collect_params().items()}


OPTS = {"sgd": {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-3},
        "adam": {"learning_rate": 0.01},
        "lamb": {"learning_rate": 0.01, "wd": 0.01}}


@pytest.mark.parametrize("name", sorted(OPTS))
@pytest.mark.parametrize("on_kv", [False, True], ids=["trainer", "store"])
@pytest.mark.parametrize("hybridize", [False, True])
def test_trainer_over_two_contexts_matches_reference(name, on_kv,
                                                     hybridize):
    got = {}
    for m in (jmx, mx):
        net = _net(m, 2, hybridize=hybridize)
        tr = m.gluon.Trainer(net.collect_params(), name, dict(OPTS[name]),
                             kvstore="local", update_on_kvstore=on_kv)
        _steps(m, net, tr, 2, 3)
        got[m] = _weights(net)
        assert tr._update_on_kvstore is on_kv
    for k in got[jmx]:
        want = got[jmx][k]
        assert np.array_equal(want[0], want[1]), k       # replicas agree
        for d in got[mx][k]:
            assert _rel(d, want[0]) <= TOL, k


def test_update_on_kvstore_true_and_false_agree():
    got = []
    for on_kv in (False, True):
        net = _net(mx, 2)
        tr = mx.gluon.Trainer(net.collect_params(), "nag",
                              {"learning_rate": 0.05, "momentum": 0.9},
                              kvstore="local", update_on_kvstore=on_kv)
        _steps(mx, net, tr, 2, 3)
        got.append(_weights(net))
    for k in got[0]:
        for a, b in zip(got[0][k], got[1][k]):
            assert _rel(a, b) <= 1e-6, k


def test_one_replica_skips_the_store_as_the_reference():
    for m in (jmx, mx):
        net = _net(m, 1)
        tr = m.gluon.Trainer(net.collect_params(), "sgd", kvstore="local")
        _steps(m, net, tr, 1, 1)
        assert tr._kvstore is None
        tr = m.gluon.Trainer(net.collect_params(), "sgd",
                             kvstore=m.kv.create("local"))
        _steps(m, net, tr, 1, 1)
        assert tr._kvstore is not None


def test_trainer_refusals_match_reference():
    for m in (jmx, mx):
        net = _net(m, 1)
        tr = m.gluon.Trainer(net.collect_params(), "sgd", kvstore="local",
                             update_on_kvstore=True)
        for call in (tr.allreduce_grads, lambda: tr.update(1)):
            with pytest.raises(m.MXNetError):
                call()
        tr = m.gluon.Trainer(net.collect_params(), "sgd", kvstore=None,
                             update_on_kvstore=True)
        with pytest.raises(m.MXNetError):
            tr.step(1)


@pytest.mark.parametrize("name", ["sgd", "adam", "lamb", "rmsprop"])
@pytest.mark.parametrize("on_kv", [False, True], ids=["trainer", "store"])
@pytest.mark.parametrize("direction", ["port_to_reference",
                                       "reference_to_port"])
def test_states_files_cross_between_packages(tmp_path, name, on_kv,
                                             direction):
    """Train 2 steps in one package, save_states; load them into the other
    package's Trainer on the same weights; one more step on each side
    agrees."""
    src, dst = (mx, jmx) if direction == "port_to_reference" else (jmx, mx)
    kw = dict(OPTS.get(name, {"learning_rate": 0.01, "centered": True}))
    f = str(tmp_path / "t.states")
    a = _net(src, 1)
    ta = src.gluon.Trainer(a.collect_params(), name, dict(kw),
                           kvstore="local", update_on_kvstore=on_kv)
    _steps(src, a, ta, 1, 2)
    ta.save_states(f)
    b = _net(dst, 1)
    for k, p in b.collect_params().items():
        p.set_data(dst.nd.array(a.collect_params()[k].data().asnumpy()))
    tb = dst.gluon.Trainer(b.collect_params(), name, dict(kw),
                           kvstore="local", update_on_kvstore=on_kv)
    tb.load_states(f)
    assert tb._optimizer.num_update == 2
    _steps(src, a, ta, 1, 1, seed=5)
    _steps(dst, b, tb, 1, 1, seed=5)
    wa, wb = _weights(a), _weights(b)
    for k in wa:
        assert _rel(wb[k][0], wa[k][0]) <= TOL, k


def test_save_load_states_round_trip_bit_for_bit(tmp_path):
    """Save after 2 steps, load into a fresh Trainer on the same weights:
    the next 2 steps are the same bits as without the round trip."""
    f = str(tmp_path / "s.states")
    out = []
    for reload in (False, True):
        net = _net(mx, 1)
        net.cast("bfloat16")
        tr = mx.gluon.Trainer(net.collect_params(), "lamb",
                              {"learning_rate": 0.01,
                               "multi_precision": True})
        x = mx.nd.array(np.random.RandomState(0).randn(4, 10)).astype(
            "bfloat16")
        for i in range(4):
            with mx.autograd.record():
                L = net(x).astype("float32").sum()
            L.backward()
            tr.step(4)
            if i == 1 and reload:
                tr.save_states(f)
                tr = mx.gluon.Trainer(net.collect_params(), "lamb",
                                      {"learning_rate": 0.01,
                                       "multi_precision": True})
                tr.load_states(f)
        out.append([p.data()._data.clone()
                    for p in net.collect_params().values()])
    assert all(torch.equal(a, b) for a, b in zip(*out))
