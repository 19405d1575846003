"""Estimator — the port of ``mxnet_tpu/gluon/contrib/estimator/
estimator.py``: a fit loop over a net, a loss, metrics and a Trainer.

``fit`` drives epochs of record, forward, loss, backward and
``Trainer.step`` with the event-handler protocol (handlers may stop
training by returning True from a hook); the metrics update every batch.
``evaluate`` runs the validation metrics.  Batches are used on the context
the loader puts them on (a DataLoader's: the current context).
"""

from __future__ import annotations

from ....base import MXNetError
from .... import metric as _metric
from ... import Trainer
from ... import loss as _loss
from .event_handler import (BatchBegin, BatchEnd, EpochBegin, EpochEnd,
                            LoggingHandler, StoppingHandler, TrainBegin,
                            TrainEnd)

__all__ = ["Estimator"]


class Estimator:
    def __init__(self, net, loss, train_metrics=None, val_metrics=None,
                 trainer=None, context=None):
        self.net = net
        if not isinstance(loss, _loss.Loss):
            raise MXNetError("loss must be a gluon.loss.Loss")
        self.loss = loss
        self.train_metrics = _as_metrics(train_metrics)
        self.val_metrics = _as_metrics(val_metrics) \
            if val_metrics is not None else \
            [_metric.create(m.name) for m in self.train_metrics] or []
        self.context = context
        self.trainer = trainer if trainer is not None else Trainer(
            net.collect_params(), "adam", {"learning_rate": 1e-3})
        # loss tracked as a metric row like the reference
        self.train_loss_metric = _metric.Loss(
            f"train_{type(loss).__name__.lower()}")
        self.val_loss_metric = _metric.Loss(
            f"val_{type(loss).__name__.lower()}")

    # -- evaluation ----------------------------------------------------------
    def evaluate(self, val_data):
        for m in self.val_metrics:
            m.reset()
        self.val_loss_metric.reset()
        for batch in val_data:
            data, label = _split_batch(batch)
            out = self.net(data)
            l = self.loss(out, label)
            self.val_loss_metric.update(None, l)
            for m in self.val_metrics:
                m.update(label, out)
        return [self.val_loss_metric.get()] + \
            [m.get() for m in self.val_metrics]

    # -- training ------------------------------------------------------------
    def fit(self, train_data, val_data=None, epochs=None, event_handlers=None,
            batches=None):
        from .... import autograd
        if epochs is None and batches is None:
            raise MXNetError("fit needs epochs or batches")
        stopper = StoppingHandler(max_epoch=epochs, max_batch=batches)
        handlers = [stopper] + list(event_handlers or [])
        if not any(isinstance(h, LoggingHandler) for h in handlers):
            handlers.append(LoggingHandler())

        def fire(cls, hook, *args, **kwargs):
            stop = False
            for h in handlers:
                if isinstance(h, cls):
                    if getattr(h, hook)(self, *args, **kwargs):
                        stop = True
            return stop

        fire(TrainBegin, "train_begin")
        stop = False
        while not stop:
            for m in self.train_metrics:
                m.reset()
            self.train_loss_metric.reset()
            fire(EpochBegin, "epoch_begin")
            for batch in train_data:
                fire(BatchBegin, "batch_begin", batch=batch)
                data, label = _split_batch(batch)
                with autograd.record():
                    out = self.net(data)
                    l = self.loss(out, label)
                l.backward()
                bs = data.shape[0]
                self.trainer.step(bs)
                self.train_loss_metric.update(None, l)
                for m in self.train_metrics:
                    m.update(label, out)
                if fire(BatchEnd, "batch_end", batch=batch):
                    stop = True
                    break
            if val_data is not None:
                self.evaluate(val_data)
            if fire(EpochEnd, "epoch_end"):
                stop = True
            if hasattr(train_data, "reset"):
                train_data.reset()
        fire(TrainEnd, "train_end")
        return self


def _as_metrics(metrics):
    if metrics is None:
        return []
    if isinstance(metrics, (_metric.EvalMetric,)):
        return [metrics]
    return [m if isinstance(m, _metric.EvalMetric) else _metric.create(m)
            for m in metrics]


def _split_batch(batch):
    if isinstance(batch, (list, tuple)) and len(batch) >= 2:
        return batch[0], batch[1]
    data = getattr(batch, "data", None)
    label = getattr(batch, "label", None)
    if data is not None and label is not None:
        return data[0], label[0]
    raise MXNetError("batch must be (data, label) or a DataBatch")
