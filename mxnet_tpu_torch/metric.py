"""Evaluation metrics — the port of ``mxnet_tpu/metric.py``: Accuracy,
TopKAccuracy, F1, MCC, MAE, MSE, RMSE, CrossEntropy,
NegativeLogLikelihood, Perplexity, PearsonCorrelation, Loss,
CustomMetric, ``np``, CompositeEvalMetric and the registry
(``mx.metric.create``).

As in the reference, ``update`` reads its inputs through ``asnumpy`` and
sums on the host in numpy: on the card that is one synchronisation and
one copy per input per call, so pass a metric the smallest array that
decides it (``logits.argmax(-1)``, not the logits, for Accuracy).
"""

from __future__ import annotations

import numpy as _np

from .base import MXNetError
from .ndarray.ndarray import NDArray

_REGISTRY = {}


def register(klass):
    _REGISTRY[klass.__name__.lower()] = klass
    return klass


def create(metric, *args, **kwargs):
    if callable(metric):
        return CustomMetric(metric, *args, **kwargs)
    if isinstance(metric, EvalMetric):
        return metric
    if isinstance(metric, list):
        composite = CompositeEvalMetric()
        for m in metric:
            composite.add(create(m, *args, **kwargs))
        return composite
    key = str(metric).lower()
    aliases = {"acc": "accuracy", "ce": "crossentropy", "nll_loss":
               "negativeloglikelihood", "top_k_accuracy": "topkaccuracy",
               "top_k_acc": "topkaccuracy", "pearsonr": "pearsoncorrelation"}
    key = aliases.get(key, key)
    if key not in _REGISTRY:
        raise MXNetError(f"unknown metric {metric!r}; known {sorted(_REGISTRY)}")
    return _REGISTRY[key](*args, **kwargs)


def _as_numpy(x):
    return x.asnumpy() if isinstance(x, NDArray) else _np.asarray(x)


def check_label_shapes(labels, preds, shape=False):
    if not shape:
        if len(labels) != len(preds):
            raise MXNetError(f"label/pred count mismatch: {len(labels)} vs "
                             f"{len(preds)}")


class EvalMetric:
    def __init__(self, name, output_names=None, label_names=None, **kwargs):
        self.name = str(name)
        self.output_names = output_names
        self.label_names = label_names
        self._kwargs = kwargs
        self.reset()

    def reset(self):
        self.num_inst = 0
        self.sum_metric = 0.0
        self.global_num_inst = 0
        self.global_sum_metric = 0.0

    def reset_local(self):
        self.num_inst = 0
        self.sum_metric = 0.0

    def update(self, labels, preds):
        raise NotImplementedError

    def _incr(self, metric, inst):
        self.sum_metric += metric
        self.num_inst += inst
        self.global_sum_metric += metric
        self.global_num_inst += inst

    def get(self):
        if self.num_inst == 0:
            return (self.name, float("nan"))
        return (self.name, self.sum_metric / self.num_inst)

    def get_global(self):
        if self.global_num_inst == 0:
            return (self.name, float("nan"))
        return (self.name, self.global_sum_metric / self.global_num_inst)

    def get_name_value(self):
        name, value = self.get()
        if not isinstance(name, list):
            name = [name]
        if not isinstance(value, list):
            value = [value]
        return list(zip(name, value))

    def update_dict(self, label, pred):
        if self.output_names is not None:
            pred = [pred[n] for n in self.output_names if n in pred]
        else:
            pred = list(pred.values())
        if self.label_names is not None:
            label = [label[n] for n in self.label_names if n in label]
        else:
            label = list(label.values())
        self.update(label, pred)

    def __str__(self):
        return f"EvalMetric: {dict([self.get_name_value()[0]])}"


@register
class Accuracy(EvalMetric):
    def __init__(self, axis=1, name="accuracy", **kwargs):
        super().__init__(name, **kwargs)
        self.axis = axis

    def update(self, labels, preds):
        if isinstance(labels, NDArray):
            labels = [labels]
        if isinstance(preds, NDArray):
            preds = [preds]
        check_label_shapes(labels, preds)
        for label, pred in zip(labels, preds):
            p = _as_numpy(pred)
            l = _as_numpy(label).astype(_np.int64)
            if p.ndim > l.ndim:
                p = _np.argmax(p, axis=self.axis)
            p = p.astype(_np.int64).reshape(-1)
            l = l.reshape(-1)
            self._incr(float((p == l).sum()), len(l))


@register
class TopKAccuracy(EvalMetric):
    def __init__(self, top_k=1, name="top_k_accuracy", **kwargs):
        super().__init__(name, **kwargs)
        self.top_k = top_k
        self.name = f"{name}_{top_k}"

    def update(self, labels, preds):
        if isinstance(labels, NDArray):
            labels = [labels]
        if isinstance(preds, NDArray):
            preds = [preds]
        for label, pred in zip(labels, preds):
            p = _as_numpy(pred)
            l = _as_numpy(label).astype(_np.int64).reshape(-1)
            topk = _np.argsort(-p, axis=-1)[..., :self.top_k].reshape(
                len(l), -1)
            hit = (topk == l[:, None]).any(axis=1)
            self._incr(float(hit.sum()), len(l))


@register
class F1(EvalMetric):
    def __init__(self, name="f1", average="macro", **kwargs):
        super().__init__(name, **kwargs)
        self.average = average
        self._tp = self._fp = self._fn = 0.0

    def reset(self):
        super().reset()
        self._tp = self._fp = self._fn = 0.0

    def update(self, labels, preds):
        if isinstance(labels, NDArray):
            labels = [labels]
        if isinstance(preds, NDArray):
            preds = [preds]
        for label, pred in zip(labels, preds):
            p = _as_numpy(pred)
            l = _as_numpy(label).reshape(-1).astype(_np.int64)
            if p.ndim > 1 and p.shape[-1] > 1:
                p = _np.argmax(p, axis=-1)
            else:
                p = (p.reshape(-1) > 0.5).astype(_np.int64)
            p = p.reshape(-1)
            self._tp += float(((p == 1) & (l == 1)).sum())
            self._fp += float(((p == 1) & (l == 0)).sum())
            self._fn += float(((p == 0) & (l == 1)).sum())
            prec = self._tp / max(self._tp + self._fp, 1e-12)
            rec = self._tp / max(self._tp + self._fn, 1e-12)
            f1 = 2 * prec * rec / max(prec + rec, 1e-12)
            self.sum_metric = f1
            self.num_inst = 1
            self.global_sum_metric = f1
            self.global_num_inst = 1


@register
class MCC(EvalMetric):
    def __init__(self, name="mcc", **kwargs):
        super().__init__(name, **kwargs)
        self._c = _np.zeros((2, 2))

    def reset(self):
        super().reset()
        self._c = _np.zeros((2, 2))

    def update(self, labels, preds):
        if isinstance(labels, NDArray):
            labels = [labels]
        if isinstance(preds, NDArray):
            preds = [preds]
        for label, pred in zip(labels, preds):
            p = _as_numpy(pred)
            l = _as_numpy(label).reshape(-1).astype(_np.int64)
            if p.ndim > 1 and p.shape[-1] > 1:
                p = _np.argmax(p, axis=-1)
            else:
                p = (p.reshape(-1) > 0.5).astype(_np.int64)
            for pi, li in zip(p.reshape(-1), l):
                self._c[int(li), int(pi)] += 1
            tn, fp = self._c[0]
            fn, tp = self._c[1]
            den = _np.sqrt((tp + fp) * (tp + fn) * (tn + fp) * (tn + fn))
            mcc = (tp * tn - fp * fn) / den if den > 0 else 0.0
            self.sum_metric = float(mcc)
            self.num_inst = 1
            self.global_sum_metric = float(mcc)
            self.global_num_inst = 1


@register
class MAE(EvalMetric):
    def __init__(self, name="mae", **kwargs):
        super().__init__(name, **kwargs)

    def update(self, labels, preds):
        if isinstance(labels, NDArray):
            labels = [labels]
        if isinstance(preds, NDArray):
            preds = [preds]
        for label, pred in zip(labels, preds):
            l = _as_numpy(label)
            p = _as_numpy(pred).reshape(l.shape)
            self._incr(float(_np.abs(l - p).mean()) * 1, 1)


@register
class MSE(EvalMetric):
    def __init__(self, name="mse", **kwargs):
        super().__init__(name, **kwargs)

    def update(self, labels, preds):
        if isinstance(labels, NDArray):
            labels = [labels]
        if isinstance(preds, NDArray):
            preds = [preds]
        for label, pred in zip(labels, preds):
            l = _as_numpy(label)
            p = _as_numpy(pred).reshape(l.shape)
            self._incr(float(((l - p) ** 2).mean()), 1)


@register
class RMSE(MSE):
    def __init__(self, name="rmse", **kwargs):
        EvalMetric.__init__(self, name, **kwargs)

    def get(self):
        if self.num_inst == 0:
            return (self.name, float("nan"))
        return (self.name, _np.sqrt(self.sum_metric / self.num_inst))


@register
class CrossEntropy(EvalMetric):
    def __init__(self, eps=1e-12, name="cross-entropy", **kwargs):
        super().__init__(name, **kwargs)
        self.eps = eps

    def update(self, labels, preds):
        if isinstance(labels, NDArray):
            labels = [labels]
        if isinstance(preds, NDArray):
            preds = [preds]
        for label, pred in zip(labels, preds):
            l = _as_numpy(label).reshape(-1).astype(_np.int64)
            p = _as_numpy(pred).reshape(len(l), -1)
            prob = p[_np.arange(len(l)), l]
            self._incr(float(-_np.log(prob + self.eps).sum()), len(l))


@register
class NegativeLogLikelihood(CrossEntropy):
    def __init__(self, eps=1e-12, name="nll-loss", **kwargs):
        EvalMetric.__init__(self, name, **kwargs)
        self.eps = eps


@register
class Perplexity(CrossEntropy):
    def __init__(self, ignore_label=None, axis=-1, name="perplexity",
                 **kwargs):
        EvalMetric.__init__(self, name, **kwargs)
        self.eps = 1e-12
        self.ignore_label = ignore_label
        self.axis = axis

    def update(self, labels, preds):
        if isinstance(labels, NDArray):
            labels = [labels]
        if isinstance(preds, NDArray):
            preds = [preds]
        for label, pred in zip(labels, preds):
            l = _as_numpy(label).reshape(-1).astype(_np.int64)
            p = _as_numpy(pred).reshape(len(l), -1)
            prob = p[_np.arange(len(l)), l]
            if self.ignore_label is not None:
                ignore = (l == self.ignore_label)
                prob = prob[~ignore]
            self._incr(float(-_np.log(prob + self.eps).sum()), len(prob))

    def get(self):
        if self.num_inst == 0:
            return (self.name, float("nan"))
        return (self.name, float(_np.exp(self.sum_metric / self.num_inst)))


@register
class PearsonCorrelation(EvalMetric):
    def __init__(self, name="pearsonr", **kwargs):
        super().__init__(name, **kwargs)
        self._labels = []
        self._preds = []

    def reset(self):
        super().reset()
        self._labels, self._preds = [], []

    def update(self, labels, preds):
        if isinstance(labels, NDArray):
            labels = [labels]
        if isinstance(preds, NDArray):
            preds = [preds]
        for label, pred in zip(labels, preds):
            self._labels.append(_as_numpy(label).reshape(-1))
            self._preds.append(_as_numpy(pred).reshape(-1))
        l = _np.concatenate(self._labels)
        p = _np.concatenate(self._preds)
        r = _np.corrcoef(l, p)[0, 1]
        self.sum_metric = float(r)
        self.num_inst = 1
        self.global_sum_metric = float(r)
        self.global_num_inst = 1


@register
class Loss(EvalMetric):
    def __init__(self, name="loss", **kwargs):
        super().__init__(name, **kwargs)

    def update(self, _, preds):
        if isinstance(preds, NDArray):
            preds = [preds]
        for pred in preds:
            p = _as_numpy(pred)
            self._incr(float(p.sum()), p.size)


class CustomMetric(EvalMetric):
    def __init__(self, feval, name="custom", allow_extra_outputs=False,
                 **kwargs):
        super().__init__(f"custom({name})", **kwargs)
        self._feval = feval
        self._allow_extra_outputs = allow_extra_outputs

    def update(self, labels, preds):
        if isinstance(labels, NDArray):
            labels = [labels]
        if isinstance(preds, NDArray):
            preds = [preds]
        for label, pred in zip(labels, preds):
            l = _as_numpy(label)
            p = _as_numpy(pred)
            res = self._feval(l, p)
            if isinstance(res, tuple):
                m, n = res
                self._incr(float(m), int(n))
            else:
                self._incr(float(res), 1)


def np(numpy_feval, name="custom", allow_extra_outputs=False):
    """Wrap a numpy feval into a metric (reference mx.metric.np)."""
    def feval(label, pred):
        return numpy_feval(label, pred)
    feval.__name__ = getattr(numpy_feval, "__name__", name)
    return CustomMetric(feval, name=feval.__name__,
                        allow_extra_outputs=allow_extra_outputs)


@register
class CompositeEvalMetric(EvalMetric):
    def __init__(self, metrics=None, name="composite", **kwargs):
        super().__init__(name, **kwargs)
        self.metrics = [create(m) for m in (metrics or [])]

    def add(self, metric):
        self.metrics.append(create(metric))

    def get_metric(self, index):
        return self.metrics[index]

    def update(self, labels, preds):
        for m in self.metrics:
            m.update(labels, preds)

    def reset(self):
        for m in getattr(self, "metrics", []):
            m.reset()

    def reset_local(self):
        # the reference resets only the composite's own (unused) sums here
        # and has no global sums at all (its get_global raises); the port
        # delegates both to the member metrics
        for m in self.metrics:
            m.reset_local()

    def _collect(self, which):
        names, values = [], []
        for m in self.metrics:
            name, value = getattr(m, which)()
            names.append(name)
            values.append(value)
        return (names, values)

    def get(self):
        return self._collect("get")

    def get_global(self):
        return self._collect("get_global")
