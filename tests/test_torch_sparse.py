"""Sparse storage of the port held against the JAX package on the CPU:
``ndarray/sparse.py`` (row_sparse and CSR arrays), the ops of
``ops/sparse_ops.py`` with their gradients, ``kvstore/sparse_ps.py``
(``SparsePS``), ``KVStoreLocal.row_sparse_pull``, ``LibSVMIter``,
``Embedding(sparse_grad=True)`` under ``gluon.Trainer`` and
``test_utils.rand_ndarray``'s sparse types; the reference's
``tests/test_sparse_ops.py`` and the ``tests/test_sparse_ps.py`` cases
that need no ``dist`` kvstore, each against the reference itself.

Tolerances: values and gradients 1e-5 of max |ref| (float32 sums in
another order); indices, CSR structure, LibSVM batches and every table a
store holds without an optimizer bit for bit; optimizer steps on the
store 1e-6 relative.
"""

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu.kvstore.sparse_ps import SparsePS as JSparsePS
from mxnet_tpu.ndarray import sparse as jsparse
import mxnet_tpu_torch as mx
from mxnet_tpu_torch.kvstore.sparse_ps import SparsePS
from mxnet_tpu_torch.ndarray import sparse
from mxnet_tpu_torch.ops import sweep

TOL = 1e-5


@pytest.fixture(autouse=True)
def _on_cpu():
    with mx.cpu():
        yield


def _close(got, want, what=""):
    assert np.asarray(got).shape == np.asarray(want).shape, what
    assert sweep.rel_err(got, want) <= TOL, what


def _rand_csr(r, m, n, density=0.3):
    d = r.randn(m, n).astype(np.float32)
    d[r.rand(m, n) > density] = 0.0
    return d


def _sp(pkg):
    return sparse if pkg is mx else jsparse


# -- arrays and their storage ---------------------------------------------------

def test_csr_matrix_and_row_sparse_match_reference():
    r = np.random.RandomState(0)
    d = _rand_csr(r, 6, 9)
    rows = r.randn(8, 4).astype(np.float32)
    rows[[1, 3, 5, 6]] = 0.0
    for pkg in (jmx, mx):
        csr = _sp(pkg).csr_matrix(d)
        rsp = _sp(pkg).row_sparse_array(rows)
        got = (csr.data.asnumpy(), csr.indptr.asnumpy(),
               csr.indices.asnumpy(), csr.tostype("default").asnumpy(),
               rsp.indices.asnumpy(), rsp.data.asnumpy(),
               rsp.tostype("default").asnumpy(), csr.stype, rsp.stype,
               csr.shape, rsp.shape)
        if pkg is jmx:
            want = got
    for g, w in zip(got, want):
        if isinstance(g, np.ndarray):
            assert g.dtype == w.dtype and np.array_equal(g, w)
        else:
            assert g == w
    assert np.array_equal(want[3], d) and np.array_equal(want[6], rows)


def test_cast_storage_and_tostype_round_trip():
    r = np.random.RandomState(1)
    d = _rand_csr(r, 5, 7, 0.4)
    d[2] = 0.0
    for pkg in (jmx, mx):
        a = pkg.nd.array(d)
        csr = _sp(pkg).cast_storage(a, "csr")
        rsp = a.tostype("row_sparse")
        assert csr.stype == "csr" and rsp.stype == "row_sparse"
        assert np.array_equal(csr.asnumpy(), d)
        assert np.array_equal(rsp.tostype("default").asnumpy(), d)
        assert rsp.indices.asnumpy().tolist() == [0, 1, 3, 4]
        z = _sp(pkg).zeros("row_sparse", (4, 3))
        assert z.asnumpy().shape == (4, 3) and not z.asnumpy().any()
        zc = _sp(pkg).zeros("csr", (4, 3))
        assert zc.indptr.asnumpy().tolist() == [0] * 5
    with pytest.raises(mx.MXNetError):
        sparse.cast_storage(mx.nd.array(d), "coo")


def test_csr_dot_forward_matches_reference():
    r = np.random.RandomState(0)
    d = _rand_csr(r, 6, 9)
    rhs = r.randn(9, 4).astype(np.float32)
    rhs_t = r.randn(6, 3).astype(np.float32)
    outs = {}
    for pkg in (jmx, mx):
        csr = _sp(pkg).csr_matrix(d)
        outs[pkg] = (_sp(pkg).dot(csr, pkg.nd.array(rhs)).asnumpy(),
                     _sp(pkg).dot(csr, pkg.nd.array(rhs_t),
                                  transpose_a=True).asnumpy())
    for g, w, want in zip(outs[mx], outs[jmx], (d @ rhs, d.T @ rhs_t)):
        _close(g, w)
        np.testing.assert_allclose(g, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("transpose_a", [False, True])
def test_csr_dot_grads(transpose_a):
    """d/drhs and d/ddata of sum(dot(csr, rhs) * w) through the recorded
    tape, against the reference's and against the dense formulas."""
    r = np.random.RandomState(2)
    d = _rand_csr(r, 5, 7)
    rhs = r.randn(5 if transpose_a else 7, 3).astype(np.float32)
    w = r.randn(7 if transpose_a else 5, 3).astype(np.float32)
    res = {}
    for pkg in (jmx, mx):
        csr = _sp(pkg).csr_matrix(d)
        x = pkg.nd.array(rhs)
        x.attach_grad()
        csr.data.attach_grad()
        with pkg.autograd.record():
            out = _sp(pkg).dot(csr, x, transpose_a=transpose_a)
            loss = (out * pkg.nd.array(w)).sum()
        loss.backward()
        res[pkg] = (out.asnumpy(), x.grad.asnumpy(),
                    csr.data.grad.asnumpy())
    for g, wnt in zip(res[mx], res[jmx]):
        _close(g, wnt)
    rows, cols = np.nonzero(d)
    if transpose_a:
        want_rhs = d @ w
        want_data = np.einsum("kj,kj->k", rhs[rows], w[cols])
    else:
        want_rhs = d.T @ w
        want_data = np.einsum("kj,kj->k", rhs[cols], w[rows])
    np.testing.assert_allclose(res[mx][1], want_rhs, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(res[mx][2], want_data, rtol=1e-5, atol=1e-5)


def test_square_sum_axes_and_grad():
    r = np.random.RandomState(3)
    dense = r.randn(8, 4).astype(np.float32)
    dense[[1, 3, 5, 6]] = 0.0
    res = {}
    for pkg in (jmx, mx):
        rsp = _sp(pkg).row_sparse_array(dense)
        sq = [_sp(pkg).square_sum(rsp).asnumpy(),
              _sp(pkg).square_sum(rsp, axis=1).asnumpy(),
              _sp(pkg).square_sum(rsp, axis=0).asnumpy(),
              _sp(pkg).square_sum(rsp, axis=1, keepdims=True).asnumpy()]
        rsp.data.attach_grad()
        with pkg.autograd.record():
            loss = _sp(pkg).square_sum(rsp)
        loss.backward()
        res[pkg] = sq + [rsp.data.grad.asnumpy()]
    for g, w in zip(res[mx], res[jmx]):
        _close(g, w)
    np.testing.assert_allclose(res[mx][1], (dense ** 2).sum(1), rtol=1e-5)
    np.testing.assert_allclose(res[mx][4], 2 * dense[[0, 2, 4, 7]],
                               rtol=1e-5)


def test_sparse_retain_and_masking_kernel():
    dense = np.zeros((6, 3), np.float32)
    dense[[0, 2, 4]] = np.arange(9, dtype=np.float32).reshape(3, 3) + 1
    res = {}
    for pkg in (jmx, mx):
        rsp = _sp(pkg).row_sparse_array(dense)
        kept = _sp(pkg).sparse_retain(rsp, pkg.nd.array(np.array([2, 5])))
        masked = pkg.nd._sparse_retain_values(
            rsp.data, rsp.indices, pkg.nd.array(np.array([2, 5])))
        via_method = rsp.retain(pkg.nd.array(np.array([0, 4])))
        res[pkg] = (kept.tostype("default").asnumpy(),
                    kept.indices.asnumpy(), masked.asnumpy(),
                    via_method.indices.asnumpy())
    for g, w in zip(res[mx], res[jmx]):
        assert np.array_equal(g, w)
    want = np.zeros_like(dense)
    want[2] = dense[2]
    assert np.array_equal(res[mx][0], want)


def test_sparse_retain_grad_flows_to_values():
    dense = np.zeros((6, 3), np.float32)
    dense[[0, 2, 4]] = np.arange(9, dtype=np.float32).reshape(3, 3) + 1
    res = {}
    for pkg in (jmx, mx):
        rsp = _sp(pkg).row_sparse_array(dense)
        rsp.data.attach_grad()
        with pkg.autograd.record():
            kept = _sp(pkg).sparse_retain(rsp, pkg.nd.array(np.array([2, 5])))
            loss = (kept.data * kept.data).sum()
        loss.backward()
        res[pkg] = rsp.data.grad.asnumpy()
    want = np.zeros_like(dense[[0, 2, 4]])
    want[1] = 2 * dense[2]
    assert np.array_equal(res[mx], res[jmx])
    assert np.array_equal(res[mx], want)


def test_getnnz_matches_reference():
    d = _rand_csr(np.random.RandomState(4), 5, 6)
    for axis in (None, 0, 1):
        got = mx.nd.contrib.getnnz(mx.nd.array(d), axis=axis).asnumpy()
        want = jmx.nd.contrib.getnnz(jmx.nd.array(d), axis=axis).asnumpy()
        assert got.dtype == want.dtype and np.array_equal(got, want)


# -- Embedding(sparse_grad=True), Parameter.grad(stype=), the Trainer ---------

def test_embedding_sparse_grad_rowsparse_view():
    """The gradient's row_sparse view holds exactly the touched rows, and
    both packages' agree (the reference's
    ``test_embedding_sparse_grad_rowsparse_view``)."""
    vocab, dim = 20, 4
    table = np.random.RandomState(5).randn(vocab, dim).astype(np.float32)
    tokens = np.array([[3, 7, 3], [11, 7, 19]], np.float32)
    res = {}
    for pkg in (jmx, mx):
        emb = pkg.gluon.nn.Embedding(vocab, dim, sparse_grad=True)
        emb.initialize(pkg.init.Zero())
        emb.weight.set_data(pkg.nd.array(table))
        w = emb.weight
        assert w.grad_stype == "row_sparse"
        with pkg.autograd.record():
            out = emb(pkg.nd.array(tokens))
            loss = (out * out).sum()
        loss.backward()
        g = w.grad()
        assert type(g).__name__ == "RowSparseNDArray"
        res[pkg] = (g.indices.asnumpy(), g.data.asnumpy(),
                    w.grad(stype="default").asnumpy())
    touched = sorted(set(tokens.astype(np.int64).ravel()))
    assert res[mx][0].tolist() == touched == res[jmx][0].tolist()
    for g, w in zip(res[mx][1:], res[jmx][1:]):
        _close(g, w)
    dense = np.zeros_like(table)
    dense[touched] = res[mx][1]
    np.testing.assert_array_equal(dense, res[mx][2])


@pytest.mark.parametrize("fused", ["1", "0"])
def test_trainer_steps_a_sparse_embedding_per_key(fused, monkeypatch):
    """A Trainer over an Embedding(sparse_grad=True) and a Dense: the
    sparse parameter takes the per-key path beside the fused update, and
    three SGD-momentum steps equal the reference's."""
    monkeypatch.setenv("MXNET_OPTIMIZER_FUSED", fused)
    r = np.random.RandomState(6)
    table = r.randn(30, 8).astype(np.float32)
    wd = r.randn(2, 8).astype(np.float32)
    toks = [r.randint(0, 30, (4, 5)).astype(np.float32) for _ in range(3)]
    res = {}
    for pkg in (jmx, mx):
        emb = pkg.gluon.nn.Embedding(30, 8, sparse_grad=True)
        head = pkg.gluon.nn.Dense(2, in_units=8, flatten=False)
        for blk, val in ((emb, [table]), (head, [wd, np.zeros(2, np.float32)])):
            blk.initialize(pkg.init.Zero())
            for p, v in zip(blk.collect_params().values(), val):
                p.set_data(pkg.nd.array(v))
        params = emb.collect_params()
        params.update(head.collect_params())
        tr = pkg.gluon.Trainer(params, "sgd", {"learning_rate": 0.1,
                                               "momentum": 0.9})
        losses = []
        for t in toks:
            with pkg.autograd.record():
                loss = (head(emb(pkg.nd.array(t))) ** 2).mean()
            loss.backward()
            tr.step(4)
            losses.append(float(loss.asnumpy()))
        res[pkg] = (losses, emb.weight.data().asnumpy(),
                    head.weight.data().asnumpy())
    np.testing.assert_allclose(res[mx][0], res[jmx][0], rtol=1e-6)
    for g, w in zip(res[mx][1:], res[jmx][1:]):
        _close(g, w)


# -- the local kvstore's row_sparse keys ----------------------------------------

def _rsp(pkg, values, rows, shape):
    return _sp(pkg).RowSparseNDArray(
        pkg.nd.array(np.asarray(values, np.float32)),
        pkg.nd.array(np.asarray(rows, np.int64)), shape)


def test_local_row_sparse_pull_and_merge():
    res = {}
    dense = np.arange(12, dtype=np.float32).reshape(6, 2)
    for pkg in (jmx, mx):
        kv = pkg.kv.create("local")
        kv.init("d", pkg.nd.array(dense))
        outs = [_sp(pkg).cast_storage(pkg.nd.zeros((6, 2)), "row_sparse")
                for _ in range(2)]
        kv.row_sparse_pull("d", out=outs, row_ids=[pkg.nd.array([4, 1]),
                                                   pkg.nd.array([5])])
        kv.init("e", _sp(pkg).cast_storage(pkg.nd.zeros((6, 2)),
                                           "row_sparse"))
        kv.push("e", [_rsp(pkg, [[1, 1], [5, 5]], [2, 4], (6, 2)),
                      _rsp(pkg, [[2, 2]], [2], (6, 2))])
        pulled = pkg.nd.zeros((6, 2))
        kv.pull("e", pulled)
        res[pkg] = [o.indices.asnumpy() for o in outs] + \
            [o.data.asnumpy() for o in outs] + [pulled.asnumpy()]
    for g, w in zip(res[mx], res[jmx]):
        assert np.array_equal(g, w)
    assert res[mx][0].tolist() == [1, 4]
    assert res[mx][4][2].tolist() == [3.0, 3.0]
    with pytest.raises(mx.MXNetError, match="row_ids"):
        mx.kv.create("local").row_sparse_pull("d", out=outs[0])


# -- SparsePS (the reference's test_sparse_ps.py cases without dist) ----------

def _ps(pkg):
    return SparsePS() if pkg is mx else JSparsePS()


def test_ps_init_push_pull_exact():
    res = {}
    for pkg in (jmx, mx):
        ps = _ps(pkg)
        ps.init("emb", pkg.nd.zeros((10, 2)))
        ps.push("emb", _rsp(pkg, [[1, 1], [2, 2]], [3, 7], (10, 2)))
        out = ps.row_sparse_pull("emb", pkg.nd.array([3, 7, 5]))
        res[pkg] = (out.indices.asnumpy(), out.data.asnumpy(),
                    ps.pull_dense("emb").asnumpy(), ps.keys(),
                    tuple(ps.shape("emb")))
    for g, w in zip(res[mx], res[jmx]):
        assert np.array_equal(g, w) if isinstance(g, np.ndarray) else g == w
    assert res[mx][0].tolist() == [3, 5, 7]
    assert res[mx][2][3].tolist() == [1.0, 1.0]


def test_ps_duplicate_rows_aggregate():
    for pkg in (jmx, mx):
        ps = _ps(pkg)
        ps.init("t", pkg.nd.zeros((6, 1)))
        ps.push("t", _rsp(pkg, [[1], [2], [4]], [2, 2, 5], (6, 1)))
        dense = ps.pull_dense("t").asnumpy()
        assert dense[2, 0] == 3.0 and dense[5, 0] == 4.0


def _ps_run(pkg, opt_fn, table, pushes):
    ps = _ps(pkg)
    ps.init("w", pkg.nd.array(table))
    ps.set_optimizer(opt_fn(pkg))
    out = []
    for vals, rows in pushes:
        ps.push("w", _rsp(pkg, vals, rows, table.shape))
        out.append(ps.pull_dense("w").asnumpy())
    return ps, out


@pytest.mark.parametrize("opt", ["sgd", "sgd_momentum", "adagrad", "adam"])
def test_ps_lazy_server_side_optimizers(opt):
    """Only the touched rows advance, duplicates merged first, state kept
    a row across pushes; each push equals the reference's."""
    def opt_fn(pkg):
        o = pkg.optimizer
        return {"sgd": lambda: o.SGD(learning_rate=0.5, rescale_grad=1.0),
                "sgd_momentum": lambda: o.SGD(learning_rate=0.5,
                                              momentum=0.9,
                                              rescale_grad=1.0),
                "adagrad": lambda: o.AdaGrad(learning_rate=1.0, eps=1e-8),
                "adam": lambda: o.Adam(learning_rate=0.1)}[opt]()
    r = np.random.RandomState(7)
    table = r.randn(8, 2).astype(np.float32)
    pushes = [(r.randn(3, 2).astype(np.float32), [1, 5, 1]),
              (r.randn(2, 2).astype(np.float32), [5, 6]),
              (r.randn(1, 2).astype(np.float32), [1])]
    _, got = _ps_run(mx, opt_fn, table, pushes)
    _, want = _ps_run(jmx, opt_fn, table, pushes)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-7)
    untouched = [0, 2, 3, 4, 7]
    assert np.array_equal(got[-1][untouched], table[untouched])
    if opt == "sgd":
        merged = pushes[0][0][0] + pushes[0][0][2]
        np.testing.assert_allclose(got[0][1], table[1] - 0.5 * merged,
                                   rtol=1e-6)


def test_ps_server_side_adagrad_state_per_row():
    ps, out = _ps_run(mx, lambda pkg: pkg.optimizer.AdaGrad(
        learning_rate=1.0, eps=1e-8), np.zeros((4, 1), np.float32),
        [([[1.0]], [2]), ([[1.0]], [2])])
    after1, after2 = out[0][2, 0], out[1][2, 0]
    np.testing.assert_allclose(after1, -1.0, rtol=1e-4)
    assert 0.1 < abs(after2 - after1) < 1.0
    assert out[1][0, 0] == 0.0
    assert float(ps._tables["w"].state_leaves[0][2, 0]) == 2.0


def test_ps_multi_precision_master_weights_init_from_rows():
    """First touch starts a bfloat16 table's float32 master at the row's
    values: 2.0 - 0.25 * 1 = 1.75 (a zero master would give -0.25)."""
    ps = SparsePS()
    ps.init("w", mx.nd.array(np.full((4, 2), 2.0, np.float32),
                             dtype="bfloat16"))
    ps.set_optimizer(mx.optimizer.SGD(learning_rate=0.25, rescale_grad=1.0,
                                      multi_precision=True))
    ps.push("w", sparse.RowSparseNDArray(
        mx.nd.array(np.ones((1, 2), np.float32), dtype="bfloat16"),
        mx.nd.array([1]), (4, 2)))
    tbl = ps._tables["w"]
    assert tbl.value.dtype == torch.bfloat16
    assert tbl.state_leaves[0].dtype == torch.float32
    dense = ps.pull_dense("w").asnumpy()
    np.testing.assert_allclose(dense[1], 1.75)
    np.testing.assert_allclose(dense[0], 2.0)
    np.testing.assert_allclose(tbl.state_leaves[0][1].numpy(), 1.75)


def test_ps_set_optimizer_resets_state():
    res = {}
    for pkg in (jmx, mx):
        ps = _ps(pkg)
        ps.init("w", pkg.nd.zeros((3, 1)))
        ps.set_optimizer(pkg.optimizer.SGD(learning_rate=1.0, momentum=0.9,
                                           rescale_grad=1.0))
        g = _rsp(pkg, [[1.0]], [0], (3, 1))
        ps.push("w", g)
        ps.push("w", g)
        ps.set_optimizer(pkg.optimizer.AdaGrad(learning_rate=1.0, eps=1e-8))
        ps.push("w", g)
        res[pkg] = (np.asarray(ps._tables["w"].state_leaves[0][0],
                               np.float32), ps.pull_dense("w").asnumpy())
    np.testing.assert_allclose(res[mx][0], 1.0, rtol=1e-6)
    for g, w in zip(res[mx], res[jmx]):
        np.testing.assert_allclose(g, w, rtol=1e-6)


def test_ps_errors():
    for pkg in (jmx, mx):
        ps = _ps(pkg)
        with pytest.raises(pkg.MXNetError, match="not initialized"):
            ps.push("nope", _rsp(pkg, [[1]], [0], (2, 1)))
        ps.init("k", pkg.nd.zeros((2, 1)))
        with pytest.raises(pkg.MXNetError, match="already"):
            ps.init("k", pkg.nd.zeros((2, 1)))


def test_ps_pull_lands_on_the_current_context():
    ps = SparsePS()
    ps.init("w", mx.nd.ones((5, 3)))
    with mx.cpu(1):
        out = ps.row_sparse_pull("w", mx.nd.array([4, 0, 4]))
        dense = ps.pull_dense("w")
    assert out.ctx == mx.cpu(1) and out.data.ctx == mx.cpu(1)
    assert dense.ctx == mx.cpu(1)
    assert out.indices.asnumpy().tolist() == [0, 4]


# -- LibSVMIter and rand_ndarray ---------------------------------------------------

def _write_libsvm(path, r, n, width):
    lines = []
    for i in range(n):
        k = r.randint(1, 6)
        idx = r.randint(0, width + 3, k)          # a few past the width
        if i % 4 == 1:
            idx = np.concatenate([idx, idx[:1]])  # an index twice
        vals = np.round(r.randn(len(idx)), 3)
        if i % 5 == 2:
            vals[0] = 0.0                          # a stored zero
        lines.append(" ".join([str(r.randint(0, 2))] + [
            f"{a}:{b}" for a, b in zip(idx, vals)]))
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n\n")


@pytest.mark.parametrize("batch,parts", [(4, 1), (3, 2)])
def test_libsvm_iter_batches_equal_reference(tmp_path, batch, parts):
    path = str(tmp_path / "d.libsvm")
    _write_libsvm(path, np.random.RandomState(8), 10, 12)
    res = {}
    for pkg in (jmx, mx):
        per_part = []
        for part in range(parts):
            it = pkg.io.LibSVMIter(data_libsvm=path, data_shape=(12,),
                                   batch_size=batch, part_index=part,
                                   num_parts=parts)
            got = []
            for epoch in range(2):
                it.reset()
                for b in it:
                    csr = b.data[0]
                    got.append((csr.stype, csr.shape, csr.data.asnumpy(),
                                csr.indices.asnumpy(), csr.indptr.asnumpy(),
                                b.label[0].asnumpy(), b.pad))
            per_part.append(got)
        res[pkg] = per_part
    for tp, jp in zip(res[mx], res[jmx]):
        assert len(tp) == len(jp) > 0
        for g, w in zip(tp, jp):
            for a, b in zip(g, w):
                if isinstance(a, np.ndarray):
                    assert a.dtype == b.dtype and np.array_equal(a, b)
                else:
                    assert a == b


def test_rand_ndarray_sparse_matches_reference():
    tu = mx.test_utils
    for stype in ("csr", "row_sparse"):
        for density in (None, 0.3):
            np.random.seed(3)
            got = tu.rand_ndarray((6, 5), stype, density=density)
            np.random.seed(3)
            want = jmx.test_utils.rand_ndarray((6, 5), stype,
                                               density=density)
            assert got.stype == stype == want.stype
            assert np.array_equal(got.asnumpy(), want.asnumpy())
            assert np.array_equal(got.indices.asnumpy(),
                                  want.indices.asnumpy())
    with pytest.raises(mx.MXNetError, match="stype"):
        tu.rand_ndarray((2, 2), "coo")


# -- ROADMAP C.17: departures of the port, pinned ---------------------------

@pytest.mark.parametrize("stype", ["row_sparse", "csr"])
def test_sparse_zeros_is_float32(stype):
    """MXNet's default dtype; the reference's is float64, from ``np.zeros``
    under its x64 mode (ROADMAP C.7)."""
    z = sparse.zeros(stype, (4, 3))
    assert z.dtype == np.float32 and z.asnumpy().dtype == np.float32
    assert z.data.dtype == np.float32
    assert jsparse.zeros(stype, (4, 3)).dtype == np.float64
    assert sparse.zeros(stype, (4, 3), dtype="float16").dtype == np.float16


def test_row_id_past_the_shape_raises_naming_it():
    """The reference drops such a row silently (ROADMAP C.7)."""
    data = np.ones((2, 2), np.float32)
    with pytest.raises(mx.MXNetError, match="row id 7"):
        sparse.row_sparse_array((data, [1, 7]), shape=(4, 2))
    ok = sparse.row_sparse_array((data, [1, 3]), shape=(4, 2))
    want = jsparse.row_sparse_array((data, [1, 3]), shape=(4, 2))
    assert np.array_equal(ok.asnumpy(), want.asnumpy())


def test_getnnz_of_a_csr_counts_its_stored_entries():
    """MXNet's ``contrib.getnnz`` is defined on CSR arrays: the stored
    entries, explicit zeros included, in all (``axis=None``), per row (the
    ``indptr`` differences) or per column; the reference's raises on a CSR
    (ROADMAP C.7).  A dense input keeps the count of its non-zeros."""
    d = np.array([[1, 0, 2], [0, 0, 0], [0, 3, 0]], np.float32)
    data = np.array([1, 0, 2, 3], np.float32)       # an explicit zero
    csr = sparse.csr_matrix((data, [0, 1, 2, 1], [0, 3, 3, 4]), shape=(3, 3))
    assert int(mx.nd.contrib.getnnz(csr).asnumpy()) == 4
    assert mx.nd.contrib.getnnz(csr, axis=1).asnumpy().tolist() == [3, 0, 1]
    assert mx.nd.contrib.getnnz(csr, axis=0).asnumpy().tolist() == [1, 2, 1]
    assert mx.nd.contrib.getnnz(csr, axis=1).dtype == np.int64
    dense = mx.nd.contrib.getnnz(mx.nd.array(d), axis=1).asnumpy()
    want = jmx.nd.contrib.getnnz(jmx.nd.array(d), axis=1).asnumpy()
    assert dense.tolist() == want.tolist() == [2, 0, 1]
    with pytest.raises(TypeError):
        jmx.nd.contrib.getnnz(jsparse.csr_matrix(d))
