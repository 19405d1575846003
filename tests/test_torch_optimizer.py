"""The port's lr_scheduler, optimizers, ``Updater`` and ``nd.*_update`` ops
held against the JAX package's, on the CPU.

The same numpy inputs (from a seeded RandomState) go through both
packages.  Tolerances: schedules 1e-12 (the same Python float
arithmetic); f32 weights and states 1e-6 of each tensor's max |ref| (the
same formula, other rounding of folded scalars and another order of a
norm's sum); bf16 weights under ``multi_precision`` within one bf16 ulp
(2^-7 relative: the f32 masters agree to 1e-6, and a master near a
rounding boundary may round either way), their masters 1e-6; the ops
1e-6; ``TrainStep`` against the Gluon loop 1e-5 relative per loss (the
same update on the same gradients; the two paths sum the loss apart).
"""

import ml_dtypes
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import parallel

TOL = 1e-6


@pytest.fixture(autouse=True)
def _on_cpu():
    with mx.cpu():
        yield


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


# -- lr_scheduler -------------------------------------------------------------

SCHEDULERS = {
    "factor": lambda m: m.lr_scheduler.FactorScheduler(
        step=7, factor=0.5, stop_factor_lr=1e-3, base_lr=0.1,
        warmup_steps=5, warmup_begin_lr=0.01),
    "factor_constant_warmup": lambda m: m.lr_scheduler.FactorScheduler(
        step=3, factor=0.9, base_lr=0.2, warmup_steps=4,
        warmup_begin_lr=0.05, warmup_mode="constant"),
    "multifactor": lambda m: m.lr_scheduler.MultiFactorScheduler(
        step=[6, 8, 30], factor=0.1, base_lr=0.025, warmup_steps=3),
    "poly": lambda m: m.lr_scheduler.PolyScheduler(
        max_update=40, base_lr=1e-4, pwr=1, warmup_steps=2),
    "poly_final": lambda m: m.lr_scheduler.PolyScheduler(
        max_update=25, base_lr=0.3, pwr=2, final_lr=0.01),
    "cosine": lambda m: m.lr_scheduler.CosineScheduler(
        max_update=45, base_lr=0.5, final_lr=0.05, warmup_steps=5,
        warmup_begin_lr=0.1),
}


@pytest.mark.parametrize("name", sorted(SCHEDULERS))
def test_lr_scheduler_matches_reference(name):
    j, t = SCHEDULERS[name](jmx), SCHEDULERS[name](mx)
    want = [j(n) for n in range(51)]
    got = [t(n) for n in range(51)]
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-15)


def test_lr_scheduler_rejects_what_the_reference_rejects():
    for m in (jmx, mx):
        with pytest.raises(m.MXNetError):
            m.lr_scheduler.FactorScheduler(step=0)
        with pytest.raises(m.MXNetError):
            m.lr_scheduler.MultiFactorScheduler(step=[5, 3])
        with pytest.raises(m.MXNetError):
            m.lr_scheduler.LRScheduler(warmup_mode="cubic")


# -- the optimizers -----------------------------------------------------------

NAMES = {0: "fc0_weight", 1: "fc0_bias", 2: "bn0_gamma"}
SHAPES = [(6, 5), (6,), (6,)]

OPTIMIZERS = {
    "sgd": ("sgd", {}),
    "sgd_momentum": ("sgd", {"momentum": 0.9}),
    "nag": ("nag", {}),
    "nag_momentum": ("nag", {"momentum": 0.9}),
    "adam": ("adam", {"beta1": 0.8}),
    "adamw": ("adamw", {"eta": 0.7}),
    "lars": ("lars", {"momentum": 0.9, "eta": 0.01}),
    "rmsprop": ("rmsprop", {"gamma1": 0.8, "clip_weights": 2.0}),
    "rmsprop_centered": ("rmsprop", {"centered": True, "gamma2": 0.7}),
    "ftrl": ("ftrl", {"lamda1": 0.002, "beta": 0.5}),
    "signum": ("signum", {"momentum": 0.8, "wd_lh": 0.01}),
    "signsgd": ("signum", {"momentum": 0.0}),
    "lamb": ("lamb", {"lower_bound": 0.1, "upper_bound": 5.0}),
    "lamb_no_bias_correction": ("lamb", {"bias_correction": False}),
    "adagrad": ("adagrad", {"eps": 1e-6}),
    "adadelta": ("adadelta", {"rho": 0.8}),
}


def _make(m, case, mp):
    name, kw = OPTIMIZERS[case]
    sched = m.lr_scheduler.MultiFactorScheduler(step=[2, 4], factor=0.5,
                                                base_lr=0.1, warmup_steps=1)
    opt = m.optimizer.create(
        name, learning_rate=0.05, wd=0.01, clip_gradient=0.8,
        rescale_grad=0.5, lr_scheduler=sched, param_idx2name=NAMES,
        multi_precision=mp, **kw)
    opt.set_lr_mult({1: 0.5, "bn0_gamma": 2.0})
    opt.set_wd_mult({"fc0_bias": 0.0, 2: 3.0})
    return opt


def _flat_state(st):
    if st is None:
        return []
    if isinstance(st, (list, tuple)):
        return [x for s in st for x in _flat_state(s)]
    return [st]


def _run_both(case, mp, steps=5):
    """``steps`` updates of 3 parameters: the reference one parameter at a
    time, the port all three in one ``update_multi``."""
    r = np.random.RandomState(sorted(OPTIMIZERS).index(case))
    w0 = [r.randn(*s).astype(np.float32) for s in SHAPES]
    grads = [[r.randn(*s).astype(np.float32) * 2 for s in SHAPES]
             for _ in range(steps)]
    half = (lambda a: a.astype(ml_dtypes.bfloat16)) if mp else (lambda a: a)
    jopt, topt = _make(jmx, case, mp), _make(mx, case, mp)
    jw = [jmx.nd.array(half(w)) for w in w0]
    tw = [torch.tensor(w).to(torch.bfloat16 if mp else torch.float32)
          for w in w0]
    jst = [jopt.create_state_multi_precision(i, w) for i, w in enumerate(jw)]
    tst = [topt.create_state_multi_precision(i, w) for i, w in enumerate(tw)]
    lrs = []
    for g in grads:
        for i in range(3):
            jopt.update_multi_precision(i, jw[i], jmx.nd.array(half(g[i])),
                                        jst[i])
        topt.update_multi([0, 1, 2], tw, [torch.tensor(half(x).astype(
            np.float32)).to(tw[0].dtype) for x in g], tst)
        lrs.append((jopt._get_lr(0), topt._get_lr(0)))
    assert jopt.num_update == topt.num_update == steps
    return jw, tw, jst, tst, lrs


@pytest.mark.parametrize("case", sorted(OPTIMIZERS))
def test_optimizer_matches_reference_f32(case):
    jw, tw, jst, tst, lrs = _run_both(case, mp=False)
    for i in range(3):
        assert _rel(tw[i].numpy(), jw[i].asnumpy()) <= TOL, (case, i)
        for t, j in zip(_flat_state(tst[i]), _flat_state(jst[i])):
            assert _rel(t.numpy(), j.asnumpy()) <= TOL, (case, i)
    # the schedule moved the rate (warmup, then the two factors)
    assert [a for a, _ in lrs] == [b for _, b in lrs]
    assert len({round(a, 12) for a, _ in lrs}) >= 3


@pytest.mark.parametrize("case", sorted(OPTIMIZERS))
def test_optimizer_matches_reference_bf16_multi_precision(case):
    jw, tw, jst, tst, _ = _run_both(case, mp=True)
    for i in range(3):
        assert tw[i].dtype == torch.bfloat16
        want = np.asarray(jw[i].asnumpy(), np.float32)
        np.testing.assert_allclose(tw[i].float().numpy(), want,
                                   rtol=2.0 ** -7, atol=1e-6)
        assert tst[i][0].dtype == torch.float32      # the f32 master
        for t, j in zip(_flat_state(tst[i]), _flat_state(jst[i])):
            assert _rel(t.numpy(), np.asarray(j.asnumpy(), np.float32)) \
                <= TOL, (case, i)


def test_update_counts_are_per_index_and_num_update_their_max():
    """With several indices the schedule reads the largest count, not the
    number of update calls (``_update_count``)."""
    for m in (jmx, mx):
        opt = m.optimizer.create("sgd", learning_rate=1.0,
                                 begin_num_update=3)
        for i in (0, 0, 1, 0):
            opt._update_count(i)
        assert opt._index_update_count == {0: 6, 1: 4}
        assert opt.num_update == 6


def test_lars_skips_the_trust_ratio_by_parameter_name():
    """bias, gamma and beta take plain momentum SGD: LARS moves them as
    SGD does, and a weight differently."""
    r = np.random.RandomState(3)
    w, g = r.randn(4, 3).astype(np.float32), r.randn(4, 3).astype(np.float32)
    out = {}
    for name in ("fc_weight", "fc_bias", "bn_gamma", "bn_beta"):
        lars = mx.optimizer.create("lars", learning_rate=0.1, momentum=0.9,
                                   param_idx2name={0: name})
        sgd = mx.optimizer.create("sgd", learning_rate=0.1, momentum=0.9)
        a, b = torch.tensor(w), torch.tensor(w)
        lars.update_multi([0], [a], [torch.tensor(g)],
                          [lars.create_state(0, a)])
        sgd.update_multi([0], [b], [torch.tensor(g)],
                         [sgd.create_state(0, b)])
        out[name] = torch.equal(a, b)
    assert out == {"fc_weight": False, "fc_bias": True, "bn_gamma": True,
                   "bn_beta": True}


def test_registry_names_and_aliases():
    for m in (jmx, mx):
        for name in ("sgd", "nag", "adam", "adamw", "lars", "rmsprop",
                     "ftrl", "signum", "lamb", "adagrad", "adadelta"):
            assert type(m.optimizer.create(name)).__name__.lower() == name
        assert isinstance(m.optimizer.create("RMSProp"),
                          m.optimizer.RMSProp)
        assert isinstance(m.optimizer.create("AdaGrad"),
                          m.optimizer.AdaGrad)
        assert m.optimizer.SignSGD is m.optimizer.Signum
        with pytest.raises(m.MXNetError):
            m.optimizer.create("nadamax")
    opt = mx.optimizer.Adam()
    assert mx.optimizer.create(opt) is opt
    assert isinstance(mx.optimizer.get_updater(opt), mx.optimizer.Updater)


def test_scheduled_rate_cannot_be_set():
    for m in (jmx, mx):
        opt = m.optimizer.create(
            "sgd", lr_scheduler=m.lr_scheduler.FactorScheduler(2, 0.5))
        with pytest.raises(m.MXNetError):
            opt.set_learning_rate(0.1)
        assert opt.learning_rate == 0.01       # base_lr = learning_rate


def test_updater_states_cross_between_packages():
    """An Updater's ``get_states`` bytes load into the other package's
    Updater, counts included, and the next update agrees."""
    r = np.random.RandomState(5)
    w, g = r.randn(5, 4).astype(np.float32), r.randn(5, 4).astype(np.float32)
    for src, dst in ((jmx, mx), (mx, jmx)):
        a = src.optimizer.get_updater(src.optimizer.create(
            "lamb", learning_rate=0.01))
        wa = src.nd.array(w)
        for _ in range(2):
            a(0, src.nd.array(g), wa)
        b = dst.optimizer.get_updater(dst.optimizer.create(
            "lamb", learning_rate=0.01))
        b.set_states(a.get_states())
        assert b.optimizer.num_update == 2
        wb = dst.nd.array(wa.asnumpy())
        a(0, src.nd.array(g), wa)
        b(0, dst.nd.array(g), wb)
        assert _rel(wb.asnumpy(), wa.asnumpy()) <= TOL


# -- the nd.*_update ops ------------------------------------------------------

def _op_cases():
    r = np.random.RandomState(11)

    def a(*shape, pos=False):
        x = r.randn(*shape).astype(np.float32)
        return np.abs(x) + 0.5 if pos else x

    S = (4, 5)
    w, g, s1, s2 = a(*S), a(*S) * 3, a(*S) * 0.1, a(*S, pos=True)
    common = dict(wd=0.02, rescale_grad=0.5, clip_gradient=1.0)
    w16 = [a(3, 2).astype(np.float16), a(4).astype(np.float16)]
    g16 = [a(3, 2).astype(np.float16), a(4).astype(np.float16)]
    m2 = [a(3, 2), a(4)]
    lrs, wds = np.array([0.1, 0.05], np.float32), \
        np.array([0.0, 0.01], np.float32)
    return {
        "sgd_update": ([w, g], dict(lr=0.1, **common)),
        "sgd_mom_update": ([w, g, s1], dict(lr=0.1, momentum=0.9, **common)),
        "nag_mom_update": ([w, g, s1], dict(lr=0.1, momentum=0.9, **common)),
        "adam_update": ([w, g, s1, s2], dict(lr=0.01, beta1=0.8, **common)),
        "adamw_update": ([w, g, s1, s2], dict(lr=0.01, eta=0.5, **common)),
        "rmsprop_update": ([w, g, s2], dict(lr=0.01, gamma1=0.8,
                                            clip_weights=1.5, **common)),
        "rmspropalex_update": ([w, g, s2, s1, s1 * 2],
                               dict(lr=0.01, gamma1=0.8, gamma2=0.7,
                                    **common)),
        "ftrl_update": ([w, g, s1, s2], dict(lr=0.1, lamda1=0.05, beta=0.7,
                                             **common)),
        "signsgd_update": ([w, g], dict(lr=0.1, **common)),
        "signum_update": ([w, g, s1], dict(lr=0.1, momentum=0.8, wd_lh=0.01,
                                           **common)),
        "lamb_update_phase1": ([w, g, s1, s2], dict(t=3, beta1=0.8,
                                                    **common)),
        "lamb_update_phase2": ([w, g, np.array([2.0], np.float32),
                                np.array([3.0], np.float32)],
                               dict(lr=0.1, lower_bound=2.5,
                                    upper_bound=10.0)),
        "lamb_full_update": ([w, g, s1, s2], dict(lr=0.1, t=2,
                                                  upper_bound=1.0, **common)),
        "adagrad_update": ([w, g, s2], dict(lr=0.1, epsilon=1e-6, **common)),
        "adadelta_update": ([w, g, s2, s2 * 0.5], dict(rho=0.8, **common)),
        "lars_update": ([w, g, s1], dict(lr=0.1, momentum=0.9, eta=0.01,
                                         **common)),
        "multi_sgd_update": ([w16[0], g16[0], w16[1], g16[1], lrs, wds],
                             dict(num_weights=2, rescale_grad=0.5,
                                  clip_gradient=1.0)),
        "multi_sgd_mom_update": ([m2[0], a(3, 2), s1[:3, :2], m2[1], a(4),
                                  s1[0, :4], lrs, wds],
                                 dict(num_weights=2, momentum=0.9)),
        "multi_mp_sgd_update": ([w16[0], g16[0], m2[0], w16[1], g16[1],
                                 m2[1], lrs, wds], dict(num_weights=2)),
        "multi_mp_sgd_mom_update": (
            [w16[0], g16[0], s1[:3, :2], m2[0], w16[1], g16[1], s1[0, :4],
             m2[1], lrs, wds], dict(num_weights=2, momentum=0.9)),
    }


OP_CASES = _op_cases()


@pytest.mark.parametrize("op", sorted(OP_CASES))
def test_update_op_matches_reference(op):
    inputs, attrs = OP_CASES[op]
    want = getattr(jmx.nd, op)(*[jmx.nd.array(x) for x in inputs], **attrs)
    got = getattr(mx.nd, op)(*[mx.nd.array(x) for x in inputs], **attrs)
    want = want if isinstance(want, (list, tuple)) else [want]
    got = got if isinstance(got, (list, tuple)) else [got]
    assert len(got) == len(want)
    for t, j in zip(got, want):
        assert np.dtype(t.dtype) == np.dtype(j.dtype), op
        assert _rel(t.asnumpy(), j.asnumpy()) <= TOL, op
    # out=: the same values written into given arrays (the first input,
    # the weight, among them where the reference writes it)
    outs = [mx.nd.zeros(t.shape, dtype=t.dtype) for t in got]
    ins = [mx.nd.array(x) for x in inputs]
    if not op.startswith(("multi", "lamb_update_phase1")):
        outs[0] = ins[0]
    res = getattr(mx.nd, op)(*ins, out=outs if len(outs) > 1 else outs[0],
                             **attrs)
    for o, t in zip(outs, got):
        assert torch.equal(o._data, t._data), op
    assert (res is outs[0]) if len(outs) == 1 else \
        all(x is y for x, y in zip(res, outs))


def test_sgd_update_flow_of_the_verify_skill():
    """``mx.nd.sgd_update(w, w.grad, lr=0.5, out=w)`` after backward: the
    loss falls, as in the reference."""
    r = np.random.RandomState(0)
    a = r.randn(64, 32).astype("float32")
    w0 = r.randn(32, 10).astype("float32") * 0.1
    lbl = r.randint(0, 10, (64,))
    losses = []
    for m in (jmx, mx):
        x, w, y = m.nd.array(a), m.nd.array(w0), m.nd.array(lbl)
        w.attach_grad()
        seen = []
        for _ in range(3):
            with m.autograd.record():
                loss = -m.nd.pick(m.nd.log_softmax(m.nd.dot(x, w)),
                                  y).mean()
            loss.backward()
            m.nd.sgd_update(w, w.grad, lr=0.5, out=w)
            seen.append(float(loss.asnumpy()))
        losses.append(seen)
    np.testing.assert_allclose(losses[1], losses[0], rtol=1e-5)
    assert losses[1][2] < losses[1][0]


# -- TrainStep takes every optimizer ------------------------------------------

def _mlp_pair(seed):
    r = np.random.RandomState(seed)
    nets = []
    for _ in range(2):
        net = mx.gluon.nn.HybridSequential(prefix="mlp_")
        with net.name_scope():
            net.add(mx.gluon.nn.Dense(16, activation="relu", in_units=10),
                    mx.gluon.nn.Dense(4, in_units=16))
        net.initialize(mx.init.Zero())
        nets.append(net)
    for p0, p1 in zip(nets[0].collect_params().values(),
                      nets[1].collect_params().values()):
        w = r.randn(*p0.shape).astype(np.float32) * 0.3
        p0.set_data(w)
        p1.set_data(w)
    return nets


@pytest.mark.parametrize("name,kw", [
    ("lamb", {"learning_rate": 0.01, "wd": 0.01}),
    ("nag", {"learning_rate": 0.05, "momentum": 0.9, "wd": 1e-4})])
@pytest.mark.parametrize("as_object", [False, True])
def test_trainstep_matches_the_gluon_loop(name, kw, as_object):
    r = np.random.RandomState(9)
    xs = r.randn(4, 8, 10).astype(np.float32)
    ys = r.randint(0, 4, (4, 8))
    gnet, snet = _mlp_pair(4)
    lossf = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    tr = mx.gluon.Trainer(gnet.collect_params(), name, dict(kw),
                          kvstore="local")
    want = []
    for x, y in zip(xs, ys):
        with mx.autograd.record():
            L = lossf(gnet(mx.nd.array(x)), mx.nd.array(y)).mean()
        L.backward()
        tr.step(1)
        want.append(float(L.asnumpy()))
    opt = mx.optimizer.create(name, **kw) if as_object else name
    step = parallel.TrainStep(
        snet, lambda out, lab: lossf(out, lab).mean(), opt,
        optimizer_params=None if as_object else dict(kw))
    got = step.run(xs, ys).tolist()
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert want[-1] < want[0]
