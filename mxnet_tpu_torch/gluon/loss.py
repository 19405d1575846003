"""gluon.loss — the port of ``mxnet_tpu/gluon/loss.py``: Loss, L2Loss,
L1Loss, SigmoidBinaryCrossEntropyLoss (SigmoidBCELoss),
SoftmaxCrossEntropyLoss (SoftmaxCELoss), LabelSmoothedCELoss, KLDivLoss,
CTCLoss, HuberLoss, HingeLoss, SquaredHingeLoss, LogisticLoss, TripletLoss
and CosineEmbeddingLoss.  Each returns one loss per sample: the mean over
every axis but ``batch_axis`` (TripletLoss, CosineEmbeddingLoss and
CTCLoss reduce as the reference does).  ``F`` is ``mx.nd`` or, in a
hybridized block, the registry's tensor ops, so the code below calls only
what both have.
"""

from __future__ import annotations

from .block import HybridBlock

__all__ = ["Loss", "L2Loss", "L1Loss", "SigmoidBinaryCrossEntropyLoss",
           "SigmoidBCELoss", "SoftmaxCrossEntropyLoss", "SoftmaxCELoss",
           "KLDivLoss", "CTCLoss", "HuberLoss", "HingeLoss",
           "SquaredHingeLoss", "LogisticLoss", "TripletLoss",
           "CosineEmbeddingLoss", "LabelSmoothedCELoss"]


def _apply_weighting(F, loss, weight=None, sample_weight=None):
    if sample_weight is not None:
        loss = F.broadcast_mul(loss, sample_weight)
    if weight is not None:
        loss = loss * weight
    return loss


def _reshape_like(F, x, y):  # noqa: ARG001
    return x.reshape(y.shape)


class Loss(HybridBlock):
    def __init__(self, weight, batch_axis, **kwargs):
        super().__init__(**kwargs)
        self._weight = weight
        self._batch_axis = batch_axis

    def __repr__(self):
        return (f"{type(self).__name__}(batch_axis={self._batch_axis}, "
                f"w={self._weight})")

    def _mean_over_non_batch(self, F, loss):
        axes = tuple(i for i in range(loss.ndim) if i != self._batch_axis)
        return F.mean(loss, axis=axes) if axes else loss


class L2Loss(Loss):
    def __init__(self, weight=1.0, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        loss = F.square(_reshape_like(F, label, pred) - pred)
        loss = _apply_weighting(F, loss, self._weight / 2, sample_weight)
        return self._mean_over_non_batch(F, loss)


class L1Loss(Loss):
    def __init__(self, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        loss = F.abs(_reshape_like(F, label, pred) - pred)
        loss = _apply_weighting(F, loss, self._weight, sample_weight)
        return self._mean_over_non_batch(F, loss)


class SigmoidBinaryCrossEntropyLoss(Loss):
    def __init__(self, from_sigmoid=False, weight=None, batch_axis=0,
                 **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._from_sigmoid = from_sigmoid

    def hybrid_forward(self, F, pred, label, sample_weight=None,
                       pos_weight=None):
        label = _reshape_like(F, label, pred)
        if not self._from_sigmoid:
            softrelu = F.Activation(-F.abs(pred), act_type="softrelu")
            if pos_weight is None:
                loss = F.relu(pred) - pred * label + softrelu
            else:
                log_weight = 1 + F.broadcast_mul(pos_weight - 1, label)
                loss = pred - pred * label \
                    + log_weight * (softrelu + F.relu(-pred))
        else:
            eps = 1e-12
            if pos_weight is None:
                loss = -(F.log(pred + eps) * label
                         + F.log(1. - pred + eps) * (1. - label))
            else:
                loss = -(F.broadcast_mul(F.log(pred + eps) * label,
                                         pos_weight)
                         + F.log(1. - pred + eps) * (1. - label))
        loss = _apply_weighting(F, loss, self._weight, sample_weight)
        return self._mean_over_non_batch(F, loss)


SigmoidBCELoss = SigmoidBinaryCrossEntropyLoss


class SoftmaxCrossEntropyLoss(Loss):
    """-log softmax(pred)[label] per position, averaged over every axis but
    the batch axis: (B, L, V) logits with (B, L) labels give (B,)."""

    def __init__(self, axis=-1, sparse_label=True, from_logits=False,
                 weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._axis = axis
        self._sparse_label = sparse_label
        self._from_logits = from_logits

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        if not self._from_logits:
            pred = F.log_softmax(pred, axis=self._axis)
        if self._sparse_label:
            loss = -F.pick(pred, label, axis=self._axis, keepdims=True)
        else:
            loss = -F.sum(pred * _reshape_like(F, label, pred),
                          axis=self._axis, keepdims=True)
        loss = _apply_weighting(F, loss, self._weight, sample_weight)
        return self._mean_over_non_batch(F, loss)


SoftmaxCELoss = SoftmaxCrossEntropyLoss


class LabelSmoothedCELoss(Loss):
    """Softmax cross-entropy against labels smoothed by ``smoothing`` over
    the classes, without forming the smoothed distribution:
    (1 - a) * nll + a * mean over classes of -log p.  Positions whose label
    is ``ignore_index`` count zero and leave the mean over the non-batch
    axes."""

    def __init__(self, smoothing=0.1, ignore_index=None, axis=-1,
                 weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._smoothing = smoothing
        self._ignore = ignore_index
        self._axis = axis

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        logp = F.log_softmax(pred, axis=self._axis)
        nll = -F.pick(logp, label, axis=self._axis)
        uniform = -F.mean(logp, axis=self._axis)
        loss = (1.0 - self._smoothing) * nll + self._smoothing * uniform
        if self._ignore is None:
            loss = _apply_weighting(F, loss, self._weight, sample_weight)
            return self._mean_over_non_batch(F, loss)
        axes = tuple(i for i in range(loss.ndim) if i != self._batch_axis)
        valid = F.cast(label != self._ignore, dtype=loss.dtype)
        loss = _apply_weighting(F, loss * valid, self._weight, sample_weight)
        if not axes:
            return loss
        n = F.sum(valid, axis=axes)
        return F.sum(loss, axis=axes) / F.maximum(n, F.ones_like(n))


class KLDivLoss(Loss):
    """label * (log label - pred), pred a log-probability
    (``from_logits``) or logits."""

    def __init__(self, from_logits=True, axis=-1, weight=None, batch_axis=0,
                 **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._from_logits = from_logits
        self._axis = axis

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        if not self._from_logits:
            pred = F.log_softmax(pred, axis=self._axis)
        loss = label * (F.log(label + 1e-12) - pred)
        loss = _apply_weighting(F, loss, self._weight, sample_weight)
        return self._mean_over_non_batch(F, loss)


class CTCLoss(Loss):
    """Connectionist temporal classification through the ``ctc_loss`` op:
    pred (N, T, C) (``layout="NTC"``) or (T, N, C), labels (N, L) or
    (L, N); the blank is class C - 1 (``blank_label="last"``, -1 pads) or
    0 (``"first"``, 0 pads).  One loss per sequence."""

    def __init__(self, layout="NTC", label_layout="NT", weight=None,
                 blank_label="last", **kwargs):
        super().__init__(weight, 0, **kwargs)
        self._layout = layout
        self._label_layout = label_layout
        self._blank_label = blank_label

    def hybrid_forward(self, F, pred, label, pred_lengths=None,
                       label_lengths=None, sample_weight=None):
        if self._layout == "NTC":
            pred = pred.swapaxes(0, 1)
        if self._label_layout == "TN":
            label = label.swapaxes(0, 1)
        if label_lengths is not None and pred_lengths is None:
            # a positional None would be dropped: give every sequence T
            pred_lengths = F.sum(F.ones_like(F.slice_axis(
                pred, axis=2, begin=0, end=1)), axis=(0, 2))
        args = [a for a in (pred_lengths, label_lengths) if a is not None]
        loss = F.ctc_loss(pred, label, *args,
                          use_data_lengths=pred_lengths is not None,
                          use_label_lengths=label_lengths is not None,
                          blank_label=self._blank_label)
        return _apply_weighting(F, loss, self._weight, sample_weight)


class HuberLoss(Loss):
    """Smooth L1: |d| - rho / 2 beyond ``rho``, d^2 / (2 rho) within."""

    def __init__(self, rho=1, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._rho = rho

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        loss = F.abs(_reshape_like(F, label, pred) - pred)
        loss = F.where(loss > self._rho, loss - 0.5 * self._rho,
                       (0.5 / self._rho) * F.square(loss))
        loss = _apply_weighting(F, loss, self._weight, sample_weight)
        return self._mean_over_non_batch(F, loss)


class HingeLoss(Loss):
    """max(0, margin - pred * label), labels in {-1, 1}."""

    def __init__(self, margin=1, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._margin = margin

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        loss = F.relu(self._margin - pred * _reshape_like(F, label, pred))
        loss = _apply_weighting(F, loss, self._weight, sample_weight)
        return self._mean_over_non_batch(F, loss)


class SquaredHingeLoss(Loss):
    """max(0, margin - pred * label)^2, labels in {-1, 1}."""

    def __init__(self, margin=1, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._margin = margin

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        loss = F.square(F.relu(
            self._margin - pred * _reshape_like(F, label, pred)))
        loss = _apply_weighting(F, loss, self._weight, sample_weight)
        return self._mean_over_non_batch(F, loss)


class LogisticLoss(Loss):
    """log(1 + exp(-pred * label)) for ``label_format="signed"`` labels in
    {-1, 1}, the binary cross-entropy of logits for "binary" {0, 1}."""

    def __init__(self, weight=None, batch_axis=0, label_format="signed",
                 **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._label_format = label_format

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        label = _reshape_like(F, label, pred)
        if self._label_format == "signed":
            label = (label + 1.0) / 2.0
        loss = F.relu(pred) - pred * label + \
            F.Activation(-F.abs(pred), act_type="softrelu")
        loss = _apply_weighting(F, loss, self._weight, sample_weight)
        return self._mean_over_non_batch(F, loss)


class TripletLoss(Loss):
    """max(0, |positive - pred|^2 - |negative - pred|^2 + margin), the
    squares summed over every non-batch axis."""

    def __init__(self, margin=1, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._margin = margin

    def hybrid_forward(self, F, pred, positive, negative,
                       sample_weight=None):
        positive = _reshape_like(F, positive, pred)
        negative = _reshape_like(F, negative, pred)
        axes = tuple(range(1, pred.ndim))
        loss = F.sum(F.square(positive - pred) - F.square(negative - pred),
                     axis=axes)
        loss = F.relu(loss + self._margin)
        return _apply_weighting(F, loss, self._weight, sample_weight)


class CosineEmbeddingLoss(Loss):
    """1 - cos(input1, input2) where label is 1, else max(0, cos -
    margin), the cosine over the last axis."""

    def __init__(self, weight=None, batch_axis=0, margin=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._margin = margin

    def hybrid_forward(self, F, input1, input2, label, sample_weight=None):
        input1 = _reshape_like(F, input1, input2)
        num = F.sum(input1 * input2, axis=-1)
        den = F.sqrt(F.sum(F.square(input1), axis=-1)
                     * F.sum(F.square(input2), axis=-1) + 1e-12)
        cos = num / den
        label = label.reshape(cos.shape)
        loss = F.where(label == 1, 1.0 - cos, F.relu(cos - self._margin))
        return _apply_weighting(F, loss, self._weight, sample_weight)
