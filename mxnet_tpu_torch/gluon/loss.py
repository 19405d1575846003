"""gluon.loss — the port of ``mxnet_tpu/gluon/loss.py``'s Loss, L2Loss,
L1Loss, SigmoidBinaryCrossEntropyLoss (SigmoidBCELoss) and
SoftmaxCrossEntropyLoss (SoftmaxCELoss).  Each returns one loss per
sample: the mean over every axis but ``batch_axis``.
"""

from __future__ import annotations

from .block import HybridBlock

__all__ = ["Loss", "L2Loss", "L1Loss", "SigmoidBinaryCrossEntropyLoss",
           "SigmoidBCELoss", "SoftmaxCrossEntropyLoss", "SoftmaxCELoss"]


def _apply_weighting(F, loss, weight=None, sample_weight=None):
    if sample_weight is not None:
        loss = F.broadcast_mul(loss, sample_weight)
    if weight is not None:
        loss = loss * weight
    return loss


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
        loss = F.square(label.reshape(pred.shape) - pred)
        loss = _apply_weighting(F, loss, self._weight / 2, sample_weight)
        return self._mean_over_non_batch(F, loss)


class L1Loss(Loss):
    def __init__(self, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        loss = F.abs(label.reshape(pred.shape) - pred)
        loss = _apply_weighting(F, loss, self._weight, sample_weight)
        return self._mean_over_non_batch(F, loss)


class SigmoidBinaryCrossEntropyLoss(Loss):
    def __init__(self, from_sigmoid=False, weight=None, batch_axis=0,
                 **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._from_sigmoid = from_sigmoid

    def hybrid_forward(self, F, pred, label, sample_weight=None,
                       pos_weight=None):
        label = label.reshape(pred.shape)
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
            loss = -F.sum(pred * label.reshape(pred.shape), axis=self._axis,
                          keepdims=True)
        loss = _apply_weighting(F, loss, self._weight, sample_weight)
        return self._mean_over_non_batch(F, loss)


SoftmaxCELoss = SoftmaxCrossEntropyLoss
