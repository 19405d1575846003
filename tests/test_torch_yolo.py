"""The port's YOLOv3 (``gluon.model_zoo.yolo``) held against the JAX
package's on the CPU: DarkNet layers (1, 1, 1, 1, 1) at input 64, the
shapes of the reference's ``tests/test_model_zoo.py`` YOLO test, on
weights carried by name (``convert.load_by_name``).

Tolerances: raw outputs 1e-5 of max |ref| (f32 convolutions sum in
another order), the loss 1e-5 relative, gradients 1e-4 of each
parameter's max |ref|; the target generator's arrays exactly (the same
numpy code); decoded rows: classes and kept rows exactly, scores and
coordinates 1e-5 absolute.
"""

import threading

import numpy as np
import pytest

import mxnet_tpu as jmx
from mxnet_tpu.gluon.model_zoo import yolo as jyolo
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import convert
from mxnet_tpu_torch.gluon.model_zoo import yolo as tyolo
from mxnet_tpu_torch.ops import sweep

CLASSES = 3
LABELS = np.array([[[1, .1, .1, .5, .5], [-1, 0, 0, 0, 0]],
                   [[2, .3, .2, .9, .8], [0, 0, 0, .2, .3]]], np.float32)


@pytest.fixture(autouse=True)
def _on_cpu():
    with mx.cpu():
        yield


def _in_thread(fn):
    out = []
    t = threading.Thread(target=lambda: out.append(fn()))
    t.start()
    t.join()
    return out[0]


def _net(mod):
    return mod.YOLOV3(
        backbone=mod.Darknet(layers=(1, 1, 1, 1, 1),
                             channels=(4, 8, 16, 32, 64, 128)),
        classes=CLASSES, channels=(32, 16, 8))


def _loss_and_grads(pkg, mod, net, x):
    tgt = mod.YOLOV3TargetGenerator(CLASSES, input_size=64)(LABELS)
    targets = [[pkg.nd.array(t) for t in s] for s in tgt]
    with pkg.autograd.record():
        loss = mod.YOLOV3Loss()(pkg.nd, net(pkg.nd.array(x)), targets)
    loss.backward()
    return float(loss.asnumpy()), {n: p.grad().asnumpy()
                                   for n, p in net.collect_params().items()
                                   if p.grad_req != "null"}


@pytest.fixture(scope="module")
def nets():
    """(JAX net, port net, input, the JAX net's predictions, its loss and
    gradients): the reference's side is computed once (its per-op
    compiles dominate), the predictions before the training forward
    moves its BatchNorm statistics."""
    x = np.random.RandomState(0).randn(2, 3, 64, 64).astype(np.float32)
    jnet = _in_thread(lambda: _net(jyolo))
    jnet.initialize(jmx.initializer.Xavier(), ctx=jmx.cpu())
    jnet(jmx.nd.array(x))                        # resolve deferred shapes
    rng = np.random.RandomState(1)
    params = {}
    for name, p in jnet.collect_params().items():
        w = (rng.randn(*p.shape) * 0.1).astype(np.float32)
        if name.endswith(("gamma", "running_var")):
            w = np.abs(w) + 0.5
        p.set_data(jmx.nd.array(w))
        params[name] = w
    tnet = convert.load_by_name(_in_thread(lambda: _net(tyolo)), params,
                                "yolo", device="cpu")
    want = [o.asnumpy() for o in jnet(jmx.nd.array(x))]
    return jnet, tnet, x, want, _loss_and_grads(jmx, jyolo, jnet, x)


def test_names_and_shapes(nets):
    jnet, tnet, x, _, _ = nets
    assert list(tnet.collect_params().keys()) == \
        list(jnet.collect_params().keys())
    outs = tnet(mx.nd.array(x))
    assert [tuple(o.shape) for o in outs] == \
        [(2, 2 * 2 * 3, 8), (2, 4 * 4 * 3, 8), (2, 8 * 8 * 3, 8)]


@pytest.mark.parametrize("hybrid", [False, True])
def test_outputs_match(nets, hybrid):
    _, tnet, x, want, _ = nets
    if hybrid:
        tnet.hybridize()
    got = [o.asnumpy() for o in tnet(mx.nd.array(x))]
    tnet.hybridize(False)
    for g, w in zip(got, want):
        assert sweep.rel_err(g, w) <= 1e-5


def test_target_generator_matches():
    want = jyolo.YOLOV3TargetGenerator(CLASSES, input_size=64)(LABELS)
    got = tyolo.YOLOV3TargetGenerator(CLASSES, input_size=64)(LABELS)
    for gs, ws in zip(got, want):
        for g, w in zip(gs, ws):
            np.testing.assert_array_equal(g, w)
    assert sum(t[4].sum() for t in got) == 3


def test_loss_and_gradients_match(nets):
    _, tnet, x, _, (wl, wg) = nets
    gl, gg = _loss_and_grads(mx, tyolo, tnet, x)
    assert np.isfinite(gl) and abs(gl - wl) <= 1e-5 * abs(wl)
    assert sorted(gg) == sorted(wg)
    for n in gg:
        assert sweep.rel_err(gg[n], wg[n]) <= 1e-4, n


def test_decode_matches(nets):
    """Both decoders on the same raw outputs (the reference net's)."""
    jnet, _, x, _, _ = nets
    raw = [o.asnumpy() for o in jnet(jmx.nd.array(x))]
    for kw in ({"conf_thresh": 0.0, "topk": 5},
               {"conf_thresh": 0.2, "nms_thresh": 0.3, "topk": 40}):
        want = jyolo.yolo3_decode([jmx.nd.array(r) for r in raw],
                                  input_size=64, **kw)
        got = tyolo.yolo3_decode([mx.nd.array(r) for r in raw],
                                 input_size=64, **kw).asnumpy()
        assert got.shape == want.shape == (2, kw["topk"], 6)
        np.testing.assert_array_equal(got[..., 0], want[..., 0])
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_darknet53_and_exports():
    assert set(tyolo.__all__) == set(jyolo.__all__)
    assert tyolo.DEFAULT_ANCHORS == jyolo.DEFAULT_ANCHORS
    net = tyolo.darknet53()
    assert [len(s) - 1 for s in net.stages] == [1, 2, 8, 8, 4]
    det = tyolo.yolo3_darknet53(classes=80)
    assert [h._channels for h in det.heads] == [255] * 3
