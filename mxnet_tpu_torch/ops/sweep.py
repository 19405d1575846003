"""Inputs and a runner for an operator sweep: every operator the port
registers (each once, under its first name) apart from the samplers, with
numpy inputs and attributes at a small size, so one op can run on two
devices, or in two packages, on the same values.

``op_inputs(name)`` gives ``(arrays, attrs)``: float32 arrays made from a
seed, int32 index arrays where the op takes indices, and the attributes
that drive it.  ``run(pkg, name, arrays, attrs, ctx)`` runs the op through
``pkg``'s public imperative API (``pkg.nd.array``, ``pkg.autograd``, the
registry's ``invoke``) and returns its outputs and, for a differentiable
op, the gradients of ``sum(out * w)`` with respect to its float inputs (w
fixed per output shape); ``pkg`` is this package or any package with the
same API.  ``close(name, got, want)`` compares two runs by the op's class:
``TOL`` of max |want| per output, and the decompositions by their
invariants (reconstruction, orthogonality, singular and eigen values), since
their signs and orders are free.
"""

from __future__ import annotations

import numpy as np

from . import registry
from .nn import rnn_infer

__all__ = ["SAMPLERS", "DECOMPOSITIONS", "TOL", "sweep_ops",
           "op_inputs", "tol_class", "run", "close", "rel_err",
           "sampler_cases", "draw_stats"]

SAMPLERS = frozenset(
    [f"random.{n}" for n in ("uniform", "normal", "gamma", "exponential",
                             "poisson", "randint", "negative_binomial",
                             "generalized_negative_binomial", "bernoulli",
                             "multinomial")]
    + [f"sample_{n}" for n in ("uniform", "normal", "gamma", "exponential",
                               "poisson", "multinomial")]
    + ["shuffle", "gumbel_softmax"])
DECOMPOSITIONS = frozenset(["linalg.svd", "linalg.eigh", "linalg.qr",
                            "linalg.gelqf"])
# reductions, products, scans and linear algebra sum in another order on
# another device or library
_SUMMING = frozenset([
    "sum", "mean", "prod", "nansum", "nanprod", "sum_axis", "logsumexp",
    "norm", "moments", "cumsum", "cumprod", "dot", "batch_dot", "matmul",
    "khatri_rao", "einsum", "FullyConnected", "Convolution", "Deconvolution",
    "Pooling", "BatchNorm", "BatchNormWithReLU", "LayerNorm", "GroupNorm",
    "InstanceNorm", "L2Normalization", "LRN", "RNN", "softmax",
    "log_softmax",
    "softmin", "SoftmaxActivation", "Softmax", "softmax_cross_entropy",
    "center_loss", "col2im", "contrib.fft", "contrib.ifft",
    "contrib.count_sketch", "contrib.hawkes_ll", "UpSampling",
    "Correlation", "GridGenerator",
    "scatter_nd", "index_add", "ElementWiseSum", "histogram", "ctc_loss",
    "lamb_full_update", "lamb_update_phase1", "lamb_update_phase2",
    "lars_update", "_sparse_dot_csr", "_square_sum_rs"])
TOL = {"elementwise": 1e-5, "reduction": 1e-4}


def tol_class(name):
    """"decomposition", "reduction" (sums: linalg, contrib attention,
    the ``_SUMMING`` ops) or "elementwise"."""
    if name in DECOMPOSITIONS:
        return "decomposition"
    if name in _SUMMING or name.startswith(("linalg.", "contrib.")) \
            or name == "einsum":
        return "reduction"
    return "elementwise"


def sweep_ops():
    """Every registered op once (the first of its names), samplers apart;
    the ``np.*`` ops of ``mx.np`` are swept by ``numpy/_sweep.py``."""
    seen, names = set(), []
    for n in registry.list_ops():
        op = registry.get(n)
        if id(op) in seen or n in SAMPLERS or n.startswith("np."):
            continue
        seen.add(id(op))
        names.append(n)
    return names


def _spec(r):
    """name -> (arrays, attrs) thunk for every op that is not a plain
    unary, binary or scalar op on the default inputs."""
    f32 = np.float32

    def t(*shape):
        return r.randn(*shape).astype(f32)

    def pos(*shape):
        return (np.abs(r.randn(*shape)) + 0.5).astype(f32)

    def i32(*vals):
        return np.array(vals, np.int32)

    def f(*vals):
        return np.array(vals, f32)

    def z(*shape):
        return np.zeros(shape, f32)

    def q8(*shape):
        return r.randint(-127, 128, shape).astype(np.int8)

    def f0(v):
        return np.array(v, f32)

    def i64(*vals):
        return np.array(vals, np.int64)

    x, g = t(4, 5), t(4, 5) * f32(0.1)
    lab = f(0, 3, 1, 4)
    spd_base = t(4, 4)
    spd = (spd_base @ spd_base.T + 4 * np.eye(4)).astype(f32)
    tril = np.tril(t(4, 4) + 4 * np.eye(4)).astype(f32)
    lens = f(3, 5, 1, 4)
    unit = (r.rand(4, 5) * 1.8 - 0.9).astype(f32)
    ints = np.round(t(4, 5) * 3).astype(f32) + f32(0.25)
    with_nan = pos(4, 5)
    with_nan[1, 2] = np.nan
    specials = pos(4, 5)
    specials[0, 0], specials[1, 1], specials[2, 2] = np.nan, np.inf, -np.inf
    zeroed = t(4, 5)
    zeroed[:, 1] = 0
    bn = [t(2, 3, 4, 4), pos(3), t(3), t(3) * f32(0.1), pos(3)]
    rnn_attrs = {"state_size": 6, "num_layers": 2, "mode": "lstm",
                 "bidirectional": True, "state_outputs": True}
    rnn_size = rnn_infer([(5, 3, 4), None], rnn_attrs)[1][0]
    return {
        "Activation": lambda: ([t(4, 5)], {"act_type": "tanh"}),
        "BatchNorm": lambda: (bn, {"fix_gamma": False}),
        "BatchNormWithReLU": lambda: (bn, {"fix_gamma": False}),
        "Cast": lambda: ([x], {"dtype": "float16"}),
        "Concat": lambda: ([x, t(4, 3)], {"dim": 1}),
        "Convolution": lambda: ([t(2, 3, 6, 6), t(4, 3, 3, 3), t(4)],
                                {"kernel": (3, 3), "num_filter": 4,
                                 "pad": (1, 1)}),
        "Crop": lambda: ([t(1, 2, 6, 6)], {"h_w": (4, 4), "offset": (1, 1)}),
        "Deconvolution": lambda: ([t(2, 3, 4, 4), t(3, 4, 3, 3)],
                                  {"kernel": (3, 3), "num_filter": 4,
                                   "no_bias": True}),
        "Dropout": lambda: ([x], {"p": 0.5, "_training": False}),
        "ElementWiseSum": lambda: ([x, t(4, 5), t(4, 5)], {}),
        "Embedding": lambda: ([i32(0, 4, 2, 2, 1, 3), t(5, 4)],
                              {"input_dim": 5, "output_dim": 4}),
        "Flatten": lambda: ([t(2, 3, 4)], {}),
        "FullyConnected": lambda: ([x, t(3, 5), t(3)], {"num_hidden": 3}),
        "GroupNorm": lambda: ([t(2, 4, 3, 3), pos(4), t(4)],
                              {"num_groups": 2}),
        "InstanceNorm": lambda: ([t(2, 4, 3, 3), pos(4), t(4)], {}),
        "L2Normalization": lambda: ([t(2, 3, 4)], {}),
        "LRN": lambda: ([t(2, 5, 3, 3)], {"nsize": 3}),
        "LayerNorm": lambda: ([x, pos(5), t(5)], {}),
        "LeakyReLU": lambda: ([x], {"act_type": "leaky", "slope": 0.1}),
        "LinearRegressionOutput": lambda: ([x, t(4, 5)], {}),
        "MAERegressionOutput": lambda: ([x, t(4, 5)], {}),
        "LogisticRegressionOutput": lambda: (
            [x, (r.rand(4, 5) > 0.5).astype(f32)], {}),
        "Pad": lambda: ([t(2, 3, 4, 4)], {"mode": "constant",
                                          "pad_width": (0, 0, 0, 0, 1, 1,
                                                        1, 1),
                                          "constant_value": 0.5}),
        "Pooling": lambda: ([t(2, 3, 6, 6)], {"kernel": (2, 2),
                                              "stride": (2, 2),
                                              "pool_type": "avg"}),
        "RNN": lambda: ([t(5, 3, 4), t(rnn_size) * f32(0.3), t(4, 3, 6),
                         t(4, 3, 6)], rnn_attrs),
        "Reshape": lambda: ([x], {"shape": (5, -1)}),
        "SVMOutput": lambda: ([x, lab], {"margin": 1.0}),
        "SequenceLast": lambda: ([t(5, 4, 3), lens],
                                 {"use_sequence_length": True}),
        "SequenceMask": lambda: ([t(5, 4, 3), lens],
                                 {"use_sequence_length": True,
                                  "value": -1.0}),
        "SequenceReverse": lambda: ([t(5, 4, 3), lens],
                                    {"use_sequence_length": True}),
        "SliceChannel": lambda: ([t(4, 6)], {"num_outputs": 2, "axis": 1}),
        "Softmax": lambda: ([x, lab], {}),
        "SoftmaxActivation": lambda: ([t(2, 3, 4)], {"mode": "channel"}),
        "SwapAxis": lambda: ([t(2, 3, 4)], {"dim1": 0, "dim2": 2}),
        "UpSampling": lambda: ([t(1, 2, 3, 3)], {"scale": 2,
                                                 "sample_type": "nearest"}),
        # the detection and sampling ops: boxes in corner form, rois rows
        # [batch, x0, y0, x1, y1] in pixels, sample points inside and
        # across the image edge
        "GridGenerator": lambda: ([f(1.0, 0.1, 0.05, -0.1, 0.9, -0.05)
                                   .reshape(1, 6)],
                                  {"transform_type": "affine",
                                   "target_shape": (4, 5)}),
        "BilinearSampler": lambda: ([t(2, 3, 5, 6),
                                     (r.rand(2, 2, 4, 4) * 2.4 - 1.2)
                                     .astype(f32)], {}),
        "SpatialTransformer": lambda: (
            [t(1, 2, 6, 6), f(1.0, 0.1, 0.0, -0.1, 1.0, 0.0).reshape(1, 6)],
            {"target_shape": (4, 4), "transform_type": "affine",
             "sampler_type": "bilinear"}),
        "ROIPooling": lambda: ([t(2, 3, 8, 8),
                                f(0, 1, 1, 6, 5, 1, 0, 2, 3, 7,
                                  0, 2, 2, 3, 3).reshape(3, 5)],
                               {"pooled_size": (2, 2),
                                "spatial_scale": 1.0}),
        "contrib.roi_align": lambda: ([t(1, 2, 8, 8),
                                      f(0, 1, 1, 5, 5, 0, 2, 0, 7, 6)
                                      .reshape(2, 5)],
                                     {"pooled_size": (2, 2),
                                      "spatial_scale": 1.0}),
        "contrib.PSROIPooling": lambda: ([t(1, 8, 8, 8),
                                          f(0, 1, 1, 6, 6).reshape(1, 5)],
                                         {"output_dim": 2, "pooled_size": 2,
                                          "group_size": 2}),
        "Correlation": lambda: ([t(1, 2, 6, 6), t(1, 2, 6, 6)],
                                {"kernel_size": 1, "max_displacement": 1,
                                 "stride1": 1, "stride2": 1,
                                 "pad_size": 1}),
        "contrib.DeformableConvolution": lambda: (
            [t(1, 2, 6, 6), t(1, 18, 6, 6) * f32(0.3), t(3, 2, 3, 3),
             t(3)], {"kernel": (3, 3), "num_filter": 3, "pad": (1, 1)}),
        "contrib.box_iou": lambda: ([f(0.1, 0.1, 0.5, 0.5, 0.3, 0.3, 0.9,
                                       0.8, 0.0, 0.2, 0.4, 0.9)
                                     .reshape(3, 4),
                                     f(0.2, 0.2, 0.6, 0.6, 0.5, 0.1, 0.8,
                                       0.7).reshape(2, 4)], {}),
        "contrib.box_nms": lambda: ([np.concatenate(
            [r.randint(0, 2, (2, 6, 1)), r.rand(2, 6, 1),
             np.sort(r.rand(2, 6, 2, 2) * [[0.5], [0.5]] + [[0], [0.4]],
                     axis=2).reshape(2, 6, 4)], -1).astype(f32)],
            {"overlap_thresh": 0.3, "valid_thresh": 0.1, "id_index": 0}),
        "contrib.MultiBoxPrior": lambda: ([t(1, 3, 4, 4)],
                                          {"sizes": (0.5, 0.25),
                                           "ratios": (1.0, 2.0)}),
        "contrib.MultiBoxTarget": lambda: (
            [f(0.1, 0.1, 0.4, 0.4, 0.3, 0.3, 0.8, 0.8, 0.5, 0.1, 0.9, 0.6,
               0.0, 0.5, 0.5, 1.0).reshape(1, 4, 4),
             f(0.0, 0.12, 0.12, 0.38, 0.42, 1.0, 0.3, 0.3, 0.8, 0.75,
               -1, -1, -1, -1, -1).reshape(1, 3, 5),
             np.abs(t(1, 3, 4))],
            {"negative_mining_ratio": 3.0}),
        "contrib.MultiBoxDetection": lambda: (
            [r.rand(1, 3, 4).astype(f32), t(1, 16) * f32(0.1),
             f(0.1, 0.1, 0.4, 0.4, 0.3, 0.3, 0.8, 0.8, 0.5, 0.1, 0.9, 0.6,
               0.0, 0.5, 0.5, 1.0).reshape(1, 4, 4)], {}),
        "contrib.Proposal": lambda: (
            [r.rand(1, 8, 4, 4).astype(f32), t(1, 16, 4, 4) * f32(0.1),
             f(64.0, 64.0, 1.0).reshape(1, 3)],
            {"scales": (8, 16), "ratios": (0.5, 1.0),
             "rpn_pre_nms_top_n": 12, "rpn_post_nms_top_n": 4,
             "rpn_min_size": 1}),
        "contrib.MultiProposal": lambda: (
            [r.rand(2, 8, 4, 4).astype(f32), t(2, 16, 4, 4) * f32(0.1),
             f(64.0, 64.0, 1.0, 48.0, 56.0, 1.0).reshape(2, 3)],
            {"scales": (8, 16), "ratios": (0.5, 1.0),
             "rpn_pre_nms_top_n": 12, "rpn_post_nms_top_n": 4,
             "rpn_min_size": 1, "output_score": True}),
        "contrib.AdaptiveAvgPooling2D": lambda: ([t(2, 3, 7, 5)],
                                                 {"output_size": (3, 2)}),
        "contrib.BilinearResize2D": lambda: ([t(2, 3, 4, 5)],
                                             {"height": 7, "width": 3}),
        # int8 quantization: int8 or int32 operands, ranges as 0-d arrays
        "contrib.quantize_v2": lambda: ([x], {}),
        "contrib.dequantize": lambda: ([q8(4, 5), f0(-2.5), f0(1.5)], {}),
        "contrib.requantize": lambda: (
            [r.randint(-60000, 60000, (4, 5)).astype(np.int32), f0(-7.0),
             f0(3.0)], {}),
        "contrib.quantized_dot": lambda: (
            [q8(4, 6), q8(6, 5), f0(-2.0), f0(1.5), f0(-0.5), f0(0.75)], {}),
        "contrib.quantized_fully_connected": lambda: (
            [q8(4, 6), q8(3, 6), f0(-2.0), f0(1.5), f0(-0.5), f0(0.75)],
            {"num_hidden": 3}),
        "contrib.quantized_conv": lambda: (
            [q8(2, 3, 6, 6), q8(4, 3, 3, 3), f0(-2.0), f0(1.5), f0(-0.5),
             f0(0.75)], {"stride": (2, 1), "pad": (1, 1)}),
        "contrib.getnnz": lambda: ([zeroed], {"axis": 1}),
        # sparse storage's components: a 4 x 5 csr (an empty row), 3
        # stored rows of a 6-row row_sparse array
        "_sparse_dot_csr": lambda: ([t(7), i64(0, 2, 3, 3, 7),
                                     i64(0, 4, 1, 0, 2, 3, 4), t(5, 3)],
                                    {}),
        "_square_sum_rs": lambda: ([t(3, 4), i64(0, 2, 5)],
                                   {"num_rows": 6, "axis": 1}),
        "_sparse_retain_values": lambda: ([t(3, 4), i64(0, 2, 5),
                                           i64(2, 5)], {}),
        "_arange": lambda: ([], {"start": 1, "stop": 7, "step": 1.5}),
        "_full": lambda: ([], {"shape": (2, 3), "value": 2.5}),
        "_ones": lambda: ([], {"shape": (2, 3)}),
        "_zeros": lambda: ([], {"shape": (2, 3)}),
        "_slice_basic": lambda: ([x], {"key": ("tuple",
                                               ("slice", None, None, -1),
                                               ("int", 2))}),
        "_power_scalar": lambda: ([pos(4, 5)], {"scalar": 2.0}),
        "adadelta_update": lambda: ([x, g, z(4, 5), z(4, 5)], {}),
        "adagrad_update": lambda: ([x, g, z(4, 5)], {"lr": 0.01}),
        "adam_update": lambda: ([x, g, z(4, 5), pos(4, 5)], {"lr": 0.1}),
        "adamw_update": lambda: ([x, g, z(4, 5), z(4, 5)], {"lr": 0.01}),
        "ftrl_update": lambda: ([x, g, z(4, 5), z(4, 5)], {"lr": 0.01}),
        "lamb_full_update": lambda: ([x, g, z(4, 5), z(4, 5)], {"lr": 0.01}),
        "lamb_update_phase1": lambda: ([x, g, z(4, 5), z(4, 5)], {"t": 1}),
        "lamb_update_phase2": lambda: ([x, g, f(1.0), f(1.0)], {"lr": 0.01}),
        "lars_update": lambda: ([x, g, z(4, 5)], {"lr": 0.01}),
        "multi_mp_sgd_update": lambda: ([x, g, x.copy(), f(0.01), f(0.0)],
                                        {"num_weights": 1}),
        "multi_mp_sgd_mom_update": lambda: (
            [x, g, z(4, 5), x.copy(), f(0.01), f(0.0)], {"num_weights": 1}),
        "multi_sgd_update": lambda: ([x, g, t(4, 5), g, f(0.1, 0.2),
                                      f(0.0, 0.0)], {"num_weights": 2}),
        "multi_sgd_mom_update": lambda: (
            [x, g, z(4, 5), t(4, 5), g, z(4, 5), f(0.1, 0.2), f(0.0, 0.0)],
            {"momentum": 0.9, "num_weights": 2}),
        "nag_mom_update": lambda: ([x, g, z(4, 5)], {"lr": 0.01,
                                                     "momentum": 0.9}),
        "rmsprop_update": lambda: ([x, g, z(4, 5)], {"lr": 0.01}),
        "rmspropalex_update": lambda: ([x, g, z(4, 5), z(4, 5), z(4, 5)],
                                       {"lr": 0.01}),
        "sgd_update": lambda: ([x, g], {"lr": 0.1}),
        "sgd_mom_update": lambda: ([x, g, z(4, 5)], {"lr": 0.1,
                                                     "momentum": 0.9}),
        "signsgd_update": lambda: ([x, g], {"lr": 0.01}),
        "signum_update": lambda: ([x, g, z(4, 5)], {"lr": 0.01}),
        "amp_cast": lambda: ([x], {"dtype": "float16"}),
        "amp_multicast": lambda: ([x, t(4, 5).astype(np.float16)],
                                  {"num_outputs": 2}),
        "arccos": lambda: ([unit], {}),
        "arcsin": lambda: ([unit], {}),
        "arctanh": lambda: ([unit], {}),
        "erfinv": lambda: ([unit], {}),
        "tan": lambda: ([unit], {}),
        "arccosh": lambda: ([pos(4, 5) + f32(1.0)], {}),
        "argmax": lambda: ([x], {"axis": 1}),
        "argmin": lambda: ([x], {"axis": 0, "keepdims": True}),
        "argsort": lambda: ([x], {"axis": 1}),
        "sort": lambda: ([x], {"axis": 1, "is_ascend": False}),
        "topk": lambda: ([x], {"k": 2, "ret_typ": "value"}),
        "batch_dot": lambda: ([t(2, 3, 4), t(2, 4, 5)], {}),
        "batch_take": lambda: ([x, i32(0, 4, 2, 1)], {}),
        "boolean_mask": lambda: ([x, f(1, 0, 1, 1)], {}),
        "broadcast_axis": lambda: ([t(1, 5)], {"axis": 0, "size": 3}),
        "broadcast_like": lambda: ([t(1, 5), t(3, 5)], {}),
        "broadcast_to": lambda: ([t(1, 5)], {"shape": (3, 0)}),
        "broadcast_power": lambda: ([pos(4, 5), t(1, 5)], {}),
        "broadcast_mod": lambda: ([pos(4, 5) * 3, pos(1, 5)], {}),
        "broadcast_floor_div": lambda: ([t(4, 5) * 3, pos(1, 5)], {}),
        "broadcast_logical_and": lambda: ([zeroed, zeroed[::-1].copy()],
                                          {}),
        "broadcast_logical_or": lambda: ([zeroed, zeroed[::-1].copy()], {}),
        "broadcast_logical_xor": lambda: ([zeroed, zeroed[::-1].copy()],
                                          {}),
        "center_loss": lambda: ([x, f(0, 1, 2, 1), t(3, 5)], {}),
        "ceil": lambda: ([ints], {}),
        "clip": lambda: ([x], {"a_min": -0.5, "a_max": 0.5}),
        "col2im": lambda: ([t(1, 18, 16)], {"output_size": (6, 6),
                                            "kernel": (3, 3)}),
        "contrib.allclose": lambda: ([x, x + f32(1e-7)], {}),
        "contrib.arange_like": lambda: ([x], {"start": 1.0, "step": 0.5,
                                              "axis": 1}),
        "contrib.count_sketch": lambda: ([x, f(0, 3, 1, 7, 2),
                                          f(1, -1, 1, 1, -1)],
                                         {"out_dim": 8}),
        "contrib.fft": lambda: ([t(4, 6)], {}),
        "contrib.ifft": lambda: ([t(4, 6)], {}),
        "contrib.gradient_multiplier": lambda: ([x], {"scalar": 0.5}),
        "contrib.hawkes_ll": lambda: (
            [pos(2, 3), np.abs(r.rand(3)).astype(f32) * f32(0.5),
             np.abs(r.rand(3)).astype(f32) + f32(1.0), z(2, 3),
             np.abs(r.rand(2, 4)).astype(f32),
             np.array([[0, 1, 2, 0], [2, 1, 0, 1]], f32), f(4, 3),
             f(5.0, 5.0)], {}),
        "contrib.index_array": lambda: ([t(2, 3)], {}),
        "contrib.interleaved_matmul_selfatt_qk": lambda: (
            [t(4, 2, 24)], {"heads": 2}),
        "contrib.interleaved_matmul_selfatt_valatt": lambda: (
            [t(4, 2, 24), pos(4, 4, 4)], {"heads": 2}),
        "contrib.interleaved_matmul_encdec_qk": lambda: (
            [t(4, 2, 8), t(5, 2, 16)], {"heads": 2}),
        "contrib.interleaved_matmul_encdec_valatt": lambda: (
            [t(5, 2, 16), pos(4, 4, 5)], {"heads": 2}),
        "contrib.masked_att_qkv": lambda: (
            [t(2, 2, 4, 8), t(2, 2, 4, 8), t(2, 2, 4, 8), f(3, 4)],
            {"causal": True}),
        "contrib.sp_att_qkv": lambda: (
            [t(2, 4, 4, 8), t(2, 2, 4, 8), t(2, 2, 4, 8)],
            {"num_kv_groups": 2, "causal": True}),
        "contrib.masked_encdec_att": lambda: (
            [t(4, 2, 8), t(5, 2, 16), f(3, 5)], {"heads": 2}),
        "contrib.masked_selfatt": lambda: ([t(4, 2, 24), f(3, 4)],
                                           {"heads": 2, "causal": True}),
        "contrib.multihead_attention": lambda: (
            [t(4, 2, 8), t(5, 2, 8), t(5, 2, 8), f(3, 5)], {"heads": 2}),
        "contrib.multihead_attention_qk": lambda: (
            [t(4, 2, 8), t(5, 2, 8)], {"heads": 2}),
        "contrib.multihead_attention_valatt": lambda: (
            [pos(4, 4, 5), t(5, 2, 8)], {"heads": 2}),
        "contrib.quadratic": lambda: ([x], {"a": 1.0, "b": -2.0, "c": 0.5}),
        "ctc_loss": lambda: ([t(12, 4, 6), np.array(
            [[1, 2, 2, 0], [3, 0, 0, 0], [5, 4, 3, 2], [1, 1, 1, 0]],
            np.int32)], {"blank_label": "first"}),
        "cumprod": lambda: ([x], {"axis": 1}),
        "cumsum": lambda: ([x], {"axis": 0}),
        "depth_to_space": lambda: ([t(1, 8, 2, 2)], {"block_size": 2}),
        "space_to_depth": lambda: ([t(1, 2, 4, 4)], {"block_size": 2}),
        "diag": lambda: ([x], {"k": 1}),
        "dot": lambda: ([t(3, 4), t(4, 5)], {}),
        "einsum": lambda: ([t(3, 5), t(4, 5)], {"subscripts": "ij,kj->ik"}),
        "expand_dims": lambda: ([x], {"axis": 1}),
        "eye": lambda: ([], {"N": 3, "M": 4, "k": 1}),
        "fix": lambda: ([ints], {}),
        "flip": lambda: ([x], {"axis": 1}),
        "floor": lambda: ([ints], {}),
        "gather_nd": lambda: ([x, np.array([[0, 1, 3], [1, 2, 4]],
                                           np.int32)], {}),
        "histogram": lambda: ([pos(4, 5)], {"bin_cnt": 5,
                                            "range": (0.0, 3.0)}),
        "im2col": lambda: ([t(1, 2, 6, 6)], {"kernel": (3, 3),
                                             "stride": (2, 2),
                                             "pad": (1, 1)}),
        "index_add": lambda: ([x, i32(0, 2), t(2, 5)], {}),
        "index_copy": lambda: ([x, i32(0, 2), t(2, 5)], {}),
        "isfinite": lambda: ([specials], {}),
        "isinf": lambda: ([specials], {}),
        "isnan": lambda: ([specials], {}),
        "khatri_rao": lambda: ([t(3, 4), t(2, 4)], {}),
        "linalg.det": lambda: ([spd], {}),
        "linalg.eigh": lambda: ([spd], {}),
        "linalg.extractdiag": lambda: ([t(2, 4, 4)], {"offset": 1}),
        "linalg.extracttrian": lambda: ([t(4, 4)], {"offset": -1}),
        "linalg.gelqf": lambda: ([t(3, 5)], {}),
        "linalg.gemm": lambda: ([t(3, 4), t(5, 4), t(3, 5)],
                                {"transpose_b": True, "alpha": 2.0,
                                 "beta": 0.5}),
        "linalg.gemm2": lambda: ([t(2, 4, 3), t(2, 4, 5)],
                                 {"transpose_a": True, "alpha": 0.5}),
        "linalg.inverse": lambda: ([spd], {}),
        "linalg.makediag": lambda: ([t(2, 3)], {"offset": -1}),
        "linalg.maketrian": lambda: ([t(10)], {}),
        "linalg.matrix_rank": lambda: ([spd], {}),
        "linalg.norm": lambda: ([t(3, 4)], {"ord": "fro",
                                            "axis": (0, 1)}),
        "linalg.pinv": lambda: ([t(4, 3)], {}),
        "linalg.potrf": lambda: ([spd], {}),
        "linalg.potri": lambda: ([np.linalg.cholesky(spd).astype(f32)], {}),
        "linalg.qr": lambda: ([t(5, 3)], {}),
        "linalg.slogdet": lambda: ([spd], {}),
        "linalg.solve": lambda: ([spd, t(4, 2)], {}),
        "linalg.sumlogdiag": lambda: ([spd], {}),
        "linalg.svd": lambda: ([t(3, 5)], {}),
        "linalg.syrk": lambda: ([t(3, 4)], {"transpose": True,
                                            "alpha": 0.5}),
        "linalg.tensorinv": lambda: (
            [(np.eye(6) + 0.1 * r.randn(6, 6)).reshape(2, 3, 2, 3)
             .astype(f32)], {"ind": 2}),
        "linalg.trmm": lambda: ([tril, t(4, 3)], {"alpha": 2.0}),
        "linalg.trsm": lambda: ([tril, t(3, 4)], {"rightside": True,
                                                  "transpose": True}),
        "linspace": lambda: ([], {"start": 0.0, "stop": 1.0, "num": 7,
                                  "endpoint": False}),
        "log_softmax": lambda: ([x], {"axis": 0}),
        "logical_not": lambda: ([zeroed], {}),
        "logsumexp": lambda: ([x], {"axis": 1}),
        "matmul": lambda: ([t(2, 3, 4), t(4, 5)], {}),
        "max": lambda: ([x], {"axis": 1}),
        "mean": lambda: ([x], {"axis": (0, 1)}),
        "min": lambda: ([x], {"axis": 0, "keepdims": True}),
        "moments": lambda: ([x], {"axes": (1,)}),
        "nanprod": lambda: ([with_nan], {"axis": 1}),
        "nansum": lambda: ([with_nan], {"axis": 0}),
        "norm": lambda: ([x], {"axis": 1}),
        "one_hot": lambda: ([i32(0, 2, 4, 1)], {"depth": 5}),
        "pick": lambda: ([x, f(0, 1, 4, 3)], {"axis": 1}),
        "prod": lambda: ([pos(4, 5)], {"axis": (0,)}),
        "ravel_multi_index": lambda: ([np.array([[0, 1, 3], [2, 3, 4]],
                                                np.int32)],
                                      {"shape": (4, 5)}),
        "repeat": lambda: ([x], {"repeats": 2, "axis": 1}),
        "reshape_like": lambda: ([x, t(5, 4)], {}),
        "rint": lambda: ([ints], {}),
        "round": lambda: ([ints], {}),
        "scatter_nd": lambda: ([t(3), np.array([[0, 1, 3], [1, 2, 4]],
                                               np.int32)],
                               {"shape": (4, 5)}),
        "sign": lambda: ([zeroed], {}),
        "slice": lambda: ([x], {"begin": (3, 0), "end": (None, 5),
                                "step": (-1, 2)}),
        "slice_axis": lambda: ([x], {"axis": 1, "begin": 1, "end": 4}),
        "slice_like": lambda: ([x, t(2, 3)], {"axes": (0, 1)}),
        "smooth_l1": lambda: ([x], {"scalar": 1.0}),
        "softmax": lambda: ([x], {"axis": -1}),
        "softmax_cross_entropy": lambda: ([x, lab], {}),
        "softmin": lambda: ([x], {"axis": 1}),
        "split": lambda: ([t(4, 6)], {"num_outputs": 3, "axis": 1}),
        "split_v2": lambda: ([t(4, 6)], {"indices": (1, 4), "axis": 1}),
        "squeeze": lambda: ([t(4, 1, 5)], {"axis": 1}),
        "stack": lambda: ([x, t(4, 5)], {"axis": 1}),
        "sum": lambda: ([x], {"axis": 1, "exclude": True}),
        "sum_axis": lambda: ([x], {"axis": 0}),
        "take": lambda: ([x, i32(3, 0, 2)], {"axis": 0}),
        "tile": lambda: ([t(2, 3)], {"reps": (2, 2)}),
        "transpose": lambda: ([t(2, 3, 4)], {"axes": (1, 0, 2)}),
        "trunc": lambda: ([ints], {}),
        "unravel_index": lambda: ([i32(5, 11, 19)], {"shape": (4, 5)}),
        "where": lambda: ([(r.rand(4, 5) > 0.5).astype(f32), x, t(4, 5)],
                          {}),
    }


def op_inputs(name, seed=0):
    """(numpy arrays, attrs) that drive op ``name`` (a sweep name)."""
    r = np.random.RandomState(seed)
    spec = _spec(r).get(name)
    if spec is not None:
        return spec()
    x = (np.abs(r.randn(4, 5)) + 0.5).astype(np.float32)
    if name.startswith("_") and name.endswith("_scalar"):
        return [x], {"scalar": 1.5}
    if name.startswith("broadcast_"):
        return [x, (np.abs(r.randn(1, 5)) + 0.5).astype(np.float32)], {}
    return [x], {}


def _head_weight(shape, dtype):
    return np.random.RandomState(1).standard_normal(shape).astype(dtype)


def run(pkg, name, arrays, attrs, ctx, grad=True):
    """``name`` on ``arrays`` (copied onto ``ctx``) through ``pkg``'s
    imperative API.  Returns (outputs, grads) as numpy: the gradient of
    sum(out * w) over the float outputs with respect to each float input
    when the op is differentiable and ``grad`` (else an empty list).  The
    optimizer updates are not differentiated."""
    reg = pkg.ops.registry
    op = reg.get(name)
    ins = [pkg.nd.array(a, ctx=ctx, dtype=a.dtype) for a in arrays]
    floats = [i for i, a in enumerate(arrays) if a.dtype.kind == "f"]
    want_grad = grad and op.differentiable and bool(floats) \
        and "update" not in name
    if want_grad:
        for i in floats:
            ins[i].attach_grad()
        with pkg.autograd.record():
            out = reg.invoke(op, ins, dict(attrs), ctx=ctx)
            outs = out if isinstance(out, list) else [out]
            head = None
            for o in outs:
                if np.dtype(o.dtype).kind != "f":
                    continue
                w = pkg.nd.array(_head_weight(o.shape, o.dtype), ctx=ctx,
                                 dtype=o.dtype)
                term = (o * w).sum()
                head = term if head is None else head + term
        if head is None:
            return [o.asnumpy() for o in outs], []
        head.backward()
        grads = [ins[i].grad.asnumpy() for i in floats]
    else:
        out = reg.invoke(op, ins, dict(attrs), ctx=ctx)
        outs = out if isinstance(out, list) else [out]
        grads = []
    return [o.asnumpy() for o in outs], grads


def rel_err(got, want):
    """max |got - want| over max |want| (NaN matching NaN and equal
    infinities count as equal; a shape mismatch is inf)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    if got.shape != want.shape:
        return np.inf
    both = np.isnan(got) & np.isnan(want)
    same_inf = np.isinf(want) & (got == want)
    ok = both | same_inf
    if ok.all():
        return 0.0
    scale = max(np.abs(want[~ok]).max(initial=0.0), 1e-30)
    return float(np.abs(got[~ok] - want[~ok]).max(initial=0.0) / scale)


def _invariants(name, a, outs):
    """Each factorization's invariants: its reconstruction of ``a`` and
    the orthogonality of its orthogonal factor (residuals over |a|), and
    its values, which are unique (singular values, eigenvalues, |diag R|,
    |diag L|)."""
    a = np.asarray(a, np.float64)
    outs = [np.asarray(o, np.float64) for o in outs]
    if name == "linalg.svd":
        u, s, vt = outs
        rec = (u * s[..., None, :]) @ vt
        orth = u.swapaxes(-1, -2) @ u
        vals = s
    elif name == "linalg.eigh":
        w, v = outs
        rec = v @ (w[..., :, None] * v.swapaxes(-1, -2))
        orth = v.swapaxes(-1, -2) @ v
        vals = w
    elif name == "linalg.qr":
        q, rr = outs
        rec, orth = q @ rr, q.swapaxes(-1, -2) @ q
        vals = np.abs(np.diagonal(rr, axis1=-2, axis2=-1))
    else:                                                  # gelqf
        lo, q = outs
        rec, orth = lo @ q, q @ q.swapaxes(-1, -2)
        vals = np.abs(np.diagonal(lo, axis1=-2, axis2=-1))
    scale = np.abs(a).max()
    return (np.abs(rec - a).max() / scale,
            np.abs(orth - np.eye(orth.shape[-1])).max(), vals)


def close(name, got, want, arrays=None, tol=None):
    """The worst error between two runs' outputs (lists of numpy arrays)
    in the op's class, and the bound it is held to: max |got - want| over
    max |want| per output (NaN matching NaN, equal infinities equal), or
    for a decomposition of ``arrays[0]`` its reconstruction and
    orthogonality residuals and its values' relative error."""
    cls = tol_class(name)
    tol = tol if tol is not None else TOL["reduction" if cls ==
                                          "decomposition" else cls]
    if cls == "decomposition":
        rg, og, vg = _invariants(name, arrays[0], got)
        _, _, vw = _invariants(name, arrays[0], want)
        return max(rg, og, rel_err(vg, vw)), tol
    if len(got) != len(want):
        return np.inf, tol
    return max((rel_err(g, w) for g, w in zip(got, want)), default=0.0), tol


# -- the samplers ---------------------------------------------------------------

def sampler_cases(n):
    """(name, arrays, attrs, dists) for every sampler at ``n`` draws per
    parameter set: ``dists`` names, for each parameter set (row of the
    output), a ``scipy.stats`` distribution as (name, args, kwargs).
    ``gumbel_softmax`` is held by the argmax of its output, a draw of the
    softmax of its logits; ``shuffle`` is apart (a permutation, not a
    distribution)."""
    f32 = np.float32
    probs = np.array([[0.1, 0.2, 0.3, 0.4], [0.5, 0.25, 0.125, 0.125]], f32)
    cat = [("rv_discrete", (), {"values": (np.arange(4), p)}) for p in probs]
    return [
        ("random.uniform", [], {"low": -1.0, "high": 3.0, "shape": (n,)},
         [("uniform", (-1.0, 4.0), {})]),
        ("random.normal", [], {"loc": 1.0, "scale": 2.0, "shape": (n,)},
         [("norm", (1.0, 2.0), {})]),
        ("random.gamma", [], {"alpha": 2.0, "beta": 1.5, "shape": (n,)},
         [("gamma", (2.0,), {"scale": 1.5})]),
        ("random.exponential", [], {"lam": 2.0, "shape": (n,)},
         [("expon", (), {"scale": 0.5})]),
        ("random.poisson", [], {"lam": 3.0, "shape": (n,)},
         [("poisson", (3.0,), {})]),
        ("random.randint", [], {"low": 2, "high": 9, "shape": (n,)},
         [("randint", (2, 9), {})]),
        ("random.negative_binomial", [], {"k": 3, "p": 0.4, "shape": (n,)},
         [("nbinom", (3, 0.4), {})]),
        ("random.generalized_negative_binomial", [],
         {"mu": 2.0, "alpha": 0.5, "shape": (n,)},
         [("nbinom", (2.0, 0.5), {})]),
        ("random.bernoulli", [], {"p": 0.3, "shape": (n,)},
         [("bernoulli", (0.3,), {})]),
        ("sample_uniform", [np.array([0.0, -2.0], f32),
                            np.array([1.0, 2.0], f32)], {"shape": (n,)},
         [("uniform", (0.0, 1.0), {}), ("uniform", (-2.0, 4.0), {})]),
        ("sample_normal", [np.array([0.0, 3.0], f32),
                           np.array([1.0, 0.5], f32)], {"shape": (n,)},
         [("norm", (0.0, 1.0), {}), ("norm", (3.0, 0.5), {})]),
        ("sample_gamma", [np.array([0.5, 4.0], f32),
                          np.array([2.0, 1.0], f32)], {"shape": (n,)},
         [("gamma", (0.5,), {"scale": 2.0}),
          ("gamma", (4.0,), {"scale": 1.0})]),
        ("sample_exponential", [np.array([1.0, 4.0], f32)], {"shape": (n,)},
         [("expon", (), {"scale": 1.0}), ("expon", (), {"scale": 0.25})]),
        ("sample_poisson", [np.array([0.5, 6.0], f32)], {"shape": (n,)},
         [("poisson", (0.5,), {}), ("poisson", (6.0,), {})]),
        ("sample_multinomial", [probs], {"shape": (n,)}, cat),
        ("random.multinomial", [probs], {"shape": (n,)}, cat),
        ("gumbel_softmax", [np.broadcast_to(np.log(probs)[:, None, :],
                                            (2, n, 4)).copy()],
         {"tau": 0.5}, cat),
    ]


def _fit_p(stats, rv, x):
    """The goodness-of-fit p-value: Kolmogorov-Smirnov for a continuous
    distribution; for a discrete one (where KS does not apply: ties)
    Pearson's chi-square over the support's values, those expected fewer
    than 5 times merged into the tails."""
    if not isinstance(getattr(rv, "dist", rv), stats.rv_discrete):
        return float(stats.kstest(x, rv.cdf).pvalue)
    n = x.size
    lo, hi = rv.ppf(1e-12), rv.ppf(1 - 1e-12)
    support = np.arange(max(lo, x.min()), max(hi, x.max()) + 1)
    expected = rv.pmf(support) * n
    observed = np.array([(x == v).sum() for v in support], np.float64)
    keep = expected >= 5
    first, last = np.argmax(keep), len(keep) - np.argmax(keep[::-1]) - 1
    exp_b = np.concatenate([[expected[:first + 1].sum()],
                            expected[first + 1:last],
                            [expected[last:].sum()]])
    obs_b = np.concatenate([[observed[:first + 1].sum()],
                            observed[first + 1:last],
                            [observed[last:].sum()]])
    exp_b *= obs_b.sum() / exp_b.sum()
    return float(stats.chisquare(obs_b, exp_b).pvalue)


def draw_stats(draws, dist):
    """(mean z, variance z, fit p) of 1-D ``draws`` against ``dist`` (a
    (name, args, kwargs) of ``scipy.stats``): the sample mean's and
    variance's distances from the distribution's in standard errors
    (the variance's from its fourth moment), and the goodness-of-fit
    p-value (``_fit_p``)."""
    from scipy import stats
    name, args, kwargs = dist
    rv = getattr(stats, name)(*args, **kwargs)
    x = np.asarray(draws, np.float64).reshape(-1)
    n = x.size
    mean, var, kurt = (float(v) for v in rv.stats(moments="mvk"))
    mean_z = (x.mean() - mean) / np.sqrt(var / n)
    var_z = (x.var() - var) / np.sqrt((kurt + 2.0) * var * var / n)
    return float(mean_z), float(var_z), _fit_p(stats, rv, x)
