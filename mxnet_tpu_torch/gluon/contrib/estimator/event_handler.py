"""Estimator event handlers — the port of
``mxnet_tpu/gluon/contrib/estimator/event_handler.py``.

Mixin interfaces: TrainBegin/TrainEnd/EpochBegin/EpochEnd/BatchBegin/
BatchEnd — the Estimator calls each handler's hook with itself as
``estimator``.  Stock handlers: StoppingHandler (max epoch/batch),
LoggingHandler (per-interval metric logs), CheckpointHandler (save
params/trainer each epoch, keep best), ValidationHandler (periodic
evaluate), EarlyStoppingHandler (monitor-based stop).
"""

from __future__ import annotations

import logging
import os
import time

import numpy as _np

__all__ = ["TrainBegin", "TrainEnd", "EpochBegin", "EpochEnd", "BatchBegin",
           "BatchEnd", "StoppingHandler", "LoggingHandler",
           "CheckpointHandler", "EarlyStoppingHandler", "ValidationHandler"]


class TrainBegin:
    def train_begin(self, estimator, *args, **kwargs):
        pass


class TrainEnd:
    def train_end(self, estimator, *args, **kwargs):
        pass


class EpochBegin:
    def epoch_begin(self, estimator, *args, **kwargs):
        pass


class EpochEnd:
    def epoch_end(self, estimator, *args, **kwargs):
        pass


class BatchBegin:
    def batch_begin(self, estimator, *args, **kwargs):
        pass


class BatchEnd:
    def batch_end(self, estimator, *args, **kwargs):
        pass


class StoppingHandler(TrainBegin, BatchEnd, EpochEnd):
    """Stop at max_epoch or max_batch (reference StoppingHandler)."""

    def __init__(self, max_epoch=None, max_batch=None):
        self.max_epoch = max_epoch
        self.max_batch = max_batch
        self.current_batch = 0
        self.current_epoch = 0
        self.stop_training = False

    def train_begin(self, estimator, *args, **kwargs):
        self.current_batch = 0
        self.current_epoch = 0

    def batch_end(self, estimator, *args, **kwargs):
        self.current_batch += 1
        if self.max_batch and self.current_batch >= self.max_batch:
            self.stop_training = True
        return self.stop_training

    def epoch_end(self, estimator, *args, **kwargs):
        self.current_epoch += 1
        if self.max_epoch and self.current_epoch >= self.max_epoch:
            self.stop_training = True
        return self.stop_training


class LoggingHandler(TrainBegin, TrainEnd, EpochBegin, EpochEnd, BatchEnd):
    """Log metrics per epoch (and every ``log_interval`` batches)."""

    def __init__(self, log_interval="epoch", metrics=None):
        self.log_interval = log_interval
        self.metrics = metrics
        self.batch_index = 0
        self.current_epoch = 0
        self.processed_samples = 0
        self.logger = logging.getLogger("mxnet_tpu_torch.estimator")

    def train_begin(self, estimator, *args, **kwargs):
        self.train_start = time.time()
        self.logger.info("Training begin")

    def train_end(self, estimator, *args, **kwargs):
        self.logger.info("Training done in %.1fs",
                         time.time() - self.train_start)

    def epoch_begin(self, estimator, *args, **kwargs):
        self.epoch_start = time.time()
        self.batch_index = 0
        self.processed_samples = 0

    def batch_end(self, estimator, batch=None, **kwargs):
        self.batch_index += 1
        if isinstance(self.log_interval, int) and \
                self.batch_index % self.log_interval == 0:
            msg = " ".join(f"{n}={v:.4f}" for n, v in
                           self._metric_values(estimator))
            self.logger.info("epoch %d batch %d %s", self.current_epoch,
                             self.batch_index, msg)

    def epoch_end(self, estimator, *args, **kwargs):
        msg = " ".join(f"{n}={v:.4f}" for n, v in
                       self._metric_values(estimator))
        self.logger.info("[Epoch %d] time %.1fs %s", self.current_epoch,
                         time.time() - self.epoch_start, msg)
        self.current_epoch += 1

    def _metric_values(self, estimator):
        metrics = self.metrics if self.metrics is not None \
            else estimator.train_metrics
        out = []
        for m in metrics:
            n, v = m.get()
            if isinstance(n, (list, tuple)):
                out.extend(zip(n, v))
            else:
                out.append((n, v))
        return out


class CheckpointHandler(TrainBegin, EpochEnd):
    """Save params (+trainer states) each epoch; track the best by a
    monitored metric (reference CheckpointHandler, simplified to the
    epoch cadence)."""

    def __init__(self, model_dir, model_prefix="model", monitor=None,
                 mode="min", save_best=False):
        self.model_dir = model_dir
        self.model_prefix = model_prefix
        self.monitor = monitor
        self.save_best = save_best
        self._cmp = (lambda a, b: a < b) if mode == "min" \
            else (lambda a, b: a > b)
        self.best = None
        self.current_epoch = 0
        os.makedirs(model_dir, exist_ok=True)

    def train_begin(self, estimator, *args, **kwargs):
        self.current_epoch = 0
        self.best = None

    def epoch_end(self, estimator, *args, **kwargs):
        prefix = os.path.join(self.model_dir, self.model_prefix)
        estimator.net.save_parameters(
            f"{prefix}-epoch{self.current_epoch}.params")
        if estimator.trainer is not None:
            estimator.trainer.save_states(
                f"{prefix}-epoch{self.current_epoch}.states")
        if self.save_best and self.monitor is not None:
            _, val = self.monitor.get()
            if self.best is None or self._cmp(val, self.best):
                self.best = val
                estimator.net.save_parameters(f"{prefix}-best.params")
        self.current_epoch += 1


class ValidationHandler(TrainBegin, BatchEnd, EpochEnd):
    """Run evaluation every ``epoch_period`` epochs (reference
    ValidationHandler)."""

    def __init__(self, val_data, eval_fn, epoch_period=1,
                 event_handlers=None):  # noqa: ARG002
        self.val_data = val_data
        self.eval_fn = eval_fn
        self.epoch_period = epoch_period
        self.current_epoch = 0
        # run validation first so monitors (early stop) see fresh values
        self.priority = -1

    def epoch_end(self, estimator, *args, **kwargs):
        self.current_epoch += 1
        if self.epoch_period and \
                self.current_epoch % self.epoch_period == 0:
            self.eval_fn(self.val_data)


class EarlyStoppingHandler(TrainBegin, EpochEnd, TrainEnd):
    """Stop when the monitored metric stops improving (reference
    EarlyStoppingHandler)."""

    def __init__(self, monitor, min_delta=0, patience=0, mode="min",
                 baseline=None):
        self.monitor = monitor
        self.min_delta = abs(min_delta)
        self.patience = patience
        self.baseline = baseline
        self._sign = -1 if mode == "min" else 1
        self.logger = logging.getLogger("mxnet_tpu_torch.estimator")

    def train_begin(self, estimator, *args, **kwargs):
        self.wait = 0
        self.stopped_epoch = None
        self.current_epoch = 0
        self.best = self.baseline if self.baseline is not None else \
            -self._sign * _np.inf

    def epoch_end(self, estimator, *args, **kwargs):
        _, val = self.monitor.get()
        improved = self._sign * (val - self.best) > self.min_delta \
            if _np.isfinite(self.best) else True
        stop = False
        if improved:
            self.best = val
            self.wait = 0
        else:
            self.wait += 1
            if self.wait >= self.patience:
                self.stopped_epoch = self.current_epoch
                stop = True
        self.current_epoch += 1
        return stop

    def train_end(self, estimator, *args, **kwargs):
        if self.stopped_epoch is not None:
            self.logger.info("Early stopping at epoch %d",
                             self.stopped_epoch)
