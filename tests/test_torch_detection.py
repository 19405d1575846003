"""The port's detection and sampling ops (``ops/vision.py``,
``contrib.box_iou``/``box_nms``) held against the JAX package's on the
CPU, forward and gradient, at small shapes, on the cases where the two
could part: a pooled bin under 4 px, two ground truths with one best
anchor, ties in the hard-negative ranking, a ``scale_height`` resize, taps
on and past the image edge, ``stride2`` not dividing the displacement,
proposals padded by the top roi or by the empty roi, the arguments
``box_nms`` raises on, and an NMS over several blocks of its suppression
matrix.

Each case runs ``ops.sweep.run`` (the op through each package's imperative
API, the gradients of sum(out * w) for a differentiable op) on the same
numpy inputs, made from a seed.  Tolerances: outputs 1e-5 of max |ref|
(1e-4 for the ops that sum: ``sweep.tol_class``), gradients 1e-4 of max
|ref|; class ids, kept rows and target classes exactly.
"""

import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops import contrib, registry, sweep

GRAD_TOL = 1e-4


@pytest.fixture(autouse=True)
def _on_cpu():
    with mx.cpu():
        yield


def _both(name, arrays, attrs):
    got = sweep.run(mx, name, arrays, attrs, mx.cpu())
    want = sweep.run(jmx, name, arrays, attrs, jmx.cpu())
    return got, want


def _check(name, arrays, attrs):
    (got, got_g), (want, want_g) = _both(name, arrays, attrs)
    err, tol = sweep.close(name, got, want, arrays)
    assert err <= tol, f"{name}: outputs differ by {err:.3g} > {tol}"
    assert len(got_g) == len(want_g)
    for g, w in zip(got_g, want_g):
        e = sweep.rel_err(g, w)
        assert e <= GRAD_TOL, f"{name}: gradients differ by {e:.3g}"
    return got, want


R = np.random.RandomState(0)
F32 = np.float32


def _t(*shape):
    return R.randn(*shape).astype(F32)


def _a(*vals, shape):
    return np.array(vals, F32).reshape(shape)


CASES = {
    # sampling: grid points on the edge (+-1) and past it, both modes
    "GridGenerator-affine": ("GridGenerator",
                             [_a(0.9, -0.2, 0.1, 0.3, 1.1, -0.05, 1.0, 0.0,
                                 0.0, 0.0, 1.0, 0.0, shape=(2, 6))],
                             {"transform_type": "affine",
                              "target_shape": (3, 5)}),
    "GridGenerator-warp": ("GridGenerator", [_t(2, 2, 4, 5)],
                           {"transform_type": "warp"}),
    "BilinearSampler-edges": ("BilinearSampler",
                              [_t(1, 2, 4, 5),
                               _a(-1.0, 1.0, -1.2, 1.3, 0.999, -0.5, 0.0,
                                  0.25, 1.0, -1.0, 1.2, -1.3, 0.5, 1.0, 0.3,
                                  -0.7, shape=(1, 2, 2, 4))], {}),
    "SpatialTransformer": ("SpatialTransformer",
                           [_t(2, 3, 6, 7),
                            _a(1.2, 0.1, 0.2, -0.1, 0.8, -0.3, 0.7, 0.0,
                               0.0, 0.0, 0.7, 0.0, shape=(2, 6))],
                           {"target_shape": (5, 4)}),
    # ROI poolings: a bin under 4 px, a bin over 4 px (the snapped grid),
    # a roi on the second image
    "ROIPooling-sub4px": ("ROIPooling",
                          [_t(2, 3, 12, 12),
                           _a(0, 1, 1, 3, 2, 1, 0, 0, 11, 11, 0, 4, 3, 9, 10,
                              shape=(3, 5))],
                          {"pooled_size": (2, 2), "spatial_scale": 1.0}),
    "ROIPooling-scaled": ("ROIPooling",
                          [_t(1, 2, 8, 8), _a(0, 2, 3, 13, 15, shape=(1, 5))],
                          {"pooled_size": (3, 2), "spatial_scale": 0.5}),
    "roi_align-default": ("contrib.roi_align",
                          [_t(2, 2, 9, 9),
                           _a(1, 0.5, 1.5, 7.2, 6.1, 0, 2.2, 0.3, 4.0, 8.5,
                              shape=(2, 5))],
                          {"pooled_size": (3, 2)}),
    "roi_align-aligned": ("contrib.roi_align",
                          [_t(1, 2, 9, 9), _a(0, 0.5, 1.5, 7.2, 6.1,
                                              shape=(1, 5))],
                          {"pooled_size": (2, 2), "sample_ratio": 3,
                           "aligned": True, "spatial_scale": 0.9}),
    "PSROIPooling-groups": ("contrib.PSROIPooling",
                            [_t(2, 3 * 4, 7, 7),
                             _a(0, 0.5, 1, 6, 5.5, 1, 2, 0, 3, 4,
                                shape=(2, 5))],
                            {"output_dim": 3, "pooled_size": 3,
                             "group_size": 2}),
    # correlation: stride2 does not divide the displacement, SAD, kernel 3
    "Correlation-stride2": ("Correlation", [_t(1, 3, 7, 8), _t(1, 3, 7, 8)],
                            {"kernel_size": 1, "max_displacement": 3,
                             "stride2": 2, "pad_size": 3}),
    "Correlation-k3-sad": ("Correlation", [_t(2, 2, 6, 6), _t(2, 2, 6, 6)],
                           {"kernel_size": 3, "max_displacement": 1,
                            "stride1": 2, "pad_size": 2,
                            "is_multiply": False}),
    # deformable: the offsets' gradient, stride and dilation
    "DeformableConvolution": ("contrib.DeformableConvolution",
                              [_t(1, 2, 7, 7), _t(1, 18, 4, 4) * F32(0.4),
                               _t(3, 2, 3, 3), _t(3)],
                              {"kernel": (3, 3), "num_filter": 3,
                               "pad": (1, 1), "stride": (2, 2),
                               "dilate": (1, 1)}),
    "DeformableConvolution-dilate": ("contrib.DeformableConvolution",
                                     [_t(1, 2, 7, 7),
                                      _t(1, 18, 3, 3) * F32(0.6),
                                      _t(2, 2, 3, 3)],
                                     {"kernel": (3, 3), "num_filter": 2,
                                      "dilate": (2, 2), "no_bias": True}),
    # resizing
    "AdaptiveAvgPooling2D": ("contrib.AdaptiveAvgPooling2D",
                             [_t(2, 2, 7, 9)], {"output_size": (4, 5)}),
    "BilinearResize2D-scale": ("contrib.BilinearResize2D", [_t(1, 2, 5, 6)],
                               {"scale_height": 1.7, "scale_width": 0.5}),
    "BilinearResize2D-unaligned": ("contrib.BilinearResize2D",
                                   [_t(1, 2, 5, 6)],
                                   {"height": 8, "width": 1,
                                    "align_corners": False}),
    "BilinearResize2D-degenerate": ("contrib.BilinearResize2D",
                                    [_t(1, 2, 5, 6)],
                                    {"height": 1, "width": 9}),
    # the box ops
    "box_iou-center": ("contrib.box_iou",
                       [np.abs(_t(2, 3, 4)), np.abs(_t(4, 4))],
                       {"format": "center"}),
    "MultiBoxPrior-clip": ("contrib.MultiBoxPrior", [_t(1, 2, 3, 5)],
                           {"sizes": (0.6, 0.3, 0.9),
                            "ratios": (1.0, 2.0, 0.5), "clip": True,
                            "steps": (0.3, 0.2), "offsets": (0.4, 0.6)}),
    "MultiBoxDetection-force": ("contrib.MultiBoxDetection",
                                [R.rand(2, 4, 6).astype(F32),
                                 _t(2, 24) * F32(0.2),
                                 np.sort(R.rand(1, 6, 2, 2), axis=2)
                                 .reshape(1, 6, 4).astype(F32)],
                                {"force_suppress": True, "nms_topk": 9,
                                 "nms_threshold": 0.3, "threshold": 0.2}),
    "MultiProposal-batch": ("contrib.MultiProposal",
                            [R.rand(2, 6, 5, 4).astype(F32),
                             _t(2, 12, 5, 4) * F32(0.2),
                             _a(80, 64, 1.0, 70, 60, 0.8, shape=(2, 3))],
                            {"scales": (4, 8, 16), "ratios": (1.0,),
                             "rpn_pre_nms_top_n": 30,
                             "rpn_post_nms_top_n": 10, "threshold": 0.5,
                             "rpn_min_size": 4, "feature_stride": 8,
                             "output_score": True}),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_matches_reference(case):
    name, arrays, attrs = CASES[case]
    _check(name, arrays, attrs)


def test_seventeen_ops_are_registered():
    names = {"contrib.box_iou", "contrib.box_nms", "BilinearSampler",
             "Correlation", "GridGenerator", "ROIPooling",
             "SpatialTransformer", "contrib.roi_align",
             "contrib.MultiBoxPrior", "contrib.MultiBoxTarget",
             "contrib.MultiBoxDetection", "contrib.PSROIPooling",
             "contrib.DeformableConvolution", "contrib.Proposal",
             "contrib.MultiProposal", "contrib.AdaptiveAvgPooling2D",
             "contrib.BilinearResize2D"}
    assert names <= set(registry.list_ops())
    for n in names:
        assert callable(getattr(mx.nd.contrib, n[8:], None)
                        if n.startswith("contrib.") else getattr(mx.nd, n))


def test_roi_pooling_max_gradient_splits_among_snapped_samples():
    """A 1 x 1 px roi pooled 2 x 2: every sample of every bin snaps to one
    pixel, whose gradient is the sum of the four bins' (1 each), not 1."""
    x = np.arange(2 * 16, dtype=F32).reshape(1, 2, 4, 4)
    rois = _a(0, 1, 2, 1, 2, shape=(1, 5))
    (got, got_g), (want, want_g) = _both("ROIPooling", [x, rois],
                                         {"pooled_size": (2, 2)})
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_allclose(got_g[0], want_g[0], rtol=0, atol=1e-6)
    w = np.random.RandomState(1).standard_normal((1, 2, 2, 2))
    assert got_g[0][0, 0, 2, 1] == pytest.approx(w[0, 0].sum(), rel=1e-5)


def test_multibox_target_later_ground_truth_wins_a_shared_anchor():
    """Two ground truths whose best anchor is the same: the later row
    takes it (the reference's scatter on the CPU); the earlier one is left
    to the threshold rule."""
    anchors = _a(0.1, 0.1, 0.5, 0.5, 0.6, 0.6, 0.9, 0.9, shape=(1, 2, 4))
    label = _a(0, 0.12, 0.1, 0.5, 0.52, 2, 0.1, 0.13, 0.48, 0.5,
               -1, -1, -1, -1, -1, shape=(1, 3, 5))
    cls_pred = np.abs(_t(1, 4, 2))
    (got, _), (want, _) = _both("contrib.MultiBoxTarget",
                                [anchors, label, cls_pred],
                                {"overlap_threshold": 0.95})
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-6)
    assert got[2][0, 0] == 3.0          # class 2 + 1: the later row


def test_multibox_target_hard_negative_ties_rank_by_index():
    """Equal foreground scores among the mining candidates: the stable
    ranking keeps the lower anchor indices, as JAX's sort does."""
    anchors = np.sort(R.rand(1, 12, 2, 2), axis=2).reshape(1, 12, 4) \
        .astype(F32)
    label = _a(1, 0.1, 0.1, 0.4, 0.5, -1, -1, -1, -1, -1, shape=(1, 2, 5))
    cls_pred = np.full((1, 3, 12), 0.25, F32)
    cls_pred[0, 1, 7] = 0.9
    attrs = {"negative_mining_ratio": 2.0, "minimum_negative_samples": 3,
             "overlap_threshold": 0.3, "negative_mining_thresh": 0.6}
    (got, _), (want, _) = _both("contrib.MultiBoxTarget",
                                [anchors, label, cls_pred], attrs)
    np.testing.assert_array_equal(got[2], want[2])
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-6)
    assert (got[2] == 0).sum() >= 3 and (got[2] == -1).any()


def test_box_nms_topk_classes_and_several_blocks(monkeypatch):
    """300 rows, topk 200 cut before the NMS, suppression within a class,
    the suppression matrix split into 64-row blocks: the same kept rows."""
    rng = np.random.RandomState(3)
    xy = rng.rand(2, 300, 2) * 0.8
    wh = rng.rand(2, 300, 2) * 0.3 + 0.05
    data = np.concatenate([rng.randint(0, 3, (2, 300, 1)),
                           rng.permutation(600).reshape(2, 300, 1) / 600.0,
                           xy, xy + wh], -1).astype(F32)
    attrs = {"overlap_thresh": 0.4, "valid_thresh": 0.05, "topk": 200,
             "id_index": 0}
    want = jmx.nd.contrib.box_nms(jmx.nd.array(data), **attrs).asnumpy()
    whole = mx.nd.contrib.box_nms(mx.nd.array(data), **attrs).asnumpy()
    monkeypatch.setattr(contrib, "_NMS_BLOCK_ELEMS", 2 * 200 * 64)
    blocks = mx.nd.contrib.box_nms(mx.nd.array(data), **attrs).asnumpy()
    np.testing.assert_array_equal(whole, want)
    np.testing.assert_array_equal(blocks, want)
    forced = dict(attrs, force_suppress=True)
    np.testing.assert_array_equal(
        mx.nd.contrib.box_nms(mx.nd.array(data), **forced).asnumpy(),
        jmx.nd.contrib.box_nms(jmx.nd.array(data), **forced).asnumpy())


@pytest.mark.parametrize("kwargs", [{"background_id": 0},
                                    {"in_format": "center"},
                                    {"out_format": "center"}])
def test_box_nms_raises_on_what_the_reference_ignores(kwargs):
    data = mx.nd.array(np.abs(_t(1, 4, 6)))
    with pytest.raises(MXNetError, match="ignored by the reference"):
        mx.nd.contrib.box_nms(data, **kwargs)


def test_proposal_pads_with_the_top_roi_and_the_empty_roi():
    """Image 0 keeps 3 of the 6 rois it is asked for, and repeats its top
    roi; image 1's boxes all fall under the minimum size, so it gets
    [1, 0, 0, 15, 15] with score 0."""
    cls = R.rand(2, 2, 3, 1).astype(F32)
    bbox = np.zeros((2, 4, 3, 1), F32)
    bbox[1, 2:] = -5.0                     # exp(-5) * 16 px < the minimum
    info = _a(64, 64, 1.0, 64, 64, 1.0, shape=(2, 3))
    attrs = {"scales": (1,), "ratios": (1.0,), "feature_stride": 16,
             "rpn_pre_nms_top_n": 6, "rpn_post_nms_top_n": 6,
             "rpn_min_size": 4, "threshold": 0.7, "output_score": True}
    (got, _), (want, _) = _both("contrib.Proposal", [cls, bbox, info], attrs)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-5)
    rois = got[0].reshape(2, 6, 5)
    assert (rois[0, 3:] == rois[0, 0]).all()
    np.testing.assert_array_equal(rois[1], np.tile([1, 0, 0, 15, 15], (6, 1)))


def test_raising_options():
    x = mx.nd.array(_t(1, 2, 5, 5))
    rois = mx.nd.array(_a(0, 0, 0, 3, 3, shape=(1, 5)))
    with pytest.raises(MXNetError, match="position_sensitive"):
        mx.nd.contrib.roi_align(x, rois, pooled_size=(2, 2),
                                position_sensitive=True)
    with pytest.raises(MXNetError, match="iou_loss"):
        mx.nd.contrib.Proposal(mx.nd.array(R.rand(1, 2, 2, 2).astype(F32)),
                               mx.nd.array(_t(1, 4, 2, 2)),
                               mx.nd.array(_a(32, 32, 1, shape=(1, 3))),
                               scales=(1,), ratios=(1.0,), iou_loss=True)
    with pytest.raises(MXNetError, match="odd"):
        mx.nd.Correlation(x, x, kernel_size=2)
    with pytest.raises(MXNetError, match="num_group"):
        mx.nd.contrib.DeformableConvolution(
            x, mx.nd.array(_t(1, 18, 3, 3)), mx.nd.array(_t(2, 1, 3, 3)),
            kernel=(3, 3), num_filter=2, num_group=2, no_bias=True)
