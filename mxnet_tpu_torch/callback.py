"""Training callbacks — the port of ``mxnet_tpu/callback.py`` (MXNet's
``python/mxnet/callback.py``): ``Speedometer``, ``do_checkpoint``,
``log_train_metric``, ``ProgressBar``.  Each takes a
``model.BatchEndParam`` (or an epoch's arguments) and logs."""

from __future__ import annotations

import logging
import time

__all__ = ["Speedometer", "do_checkpoint", "log_train_metric", "ProgressBar"]


class Speedometer:
    """Log samples a second every ``frequent`` batches; with
    ``auto_reset`` the metric's local state resets after each log."""

    def __init__(self, batch_size, frequent=50, auto_reset=True):
        self.batch_size = batch_size
        self.frequent = frequent
        self.auto_reset = auto_reset
        self.init = False
        self.tic = 0
        self.last_count = 0

    def __call__(self, param):
        count = param.nbatch
        if self.last_count > count:
            self.init = False
        self.last_count = count
        if not self.init:
            self.init = True
            self.tic = time.time()
            return
        if count % self.frequent:
            return
        speed = self.frequent * self.batch_size / (time.time() - self.tic)
        if param.eval_metric is not None:
            name_value = param.eval_metric.get_name_value()
            if self.auto_reset:
                param.eval_metric.reset_local()
            logging.info("Epoch[%d] Batch [%d]\tSpeed: %.2f samples/sec\t%s",
                         param.epoch, count, speed,
                         "\t".join(f"{n}={v:.6f}" for n, v in name_value))
        else:
            logging.info("Iter[%d] Batch [%d]\tSpeed: %.2f samples/sec",
                         param.epoch, count, speed)
        self.tic = time.time()


def do_checkpoint(prefix, period=1):
    """An epoch-end callback that writes ``prefix-%04d.params`` every
    ``period`` epochs (``model.save_checkpoint``)."""
    def _callback(iter_no, sym, arg, aux):
        if (iter_no + 1) % period == 0:
            from .model import save_checkpoint
            save_checkpoint(prefix, iter_no + 1, sym, arg, aux)
    return _callback


def log_train_metric(period, auto_reset=False):
    """A batch-end callback that logs the training metric every
    ``period`` batches."""
    def _callback(param):
        if param.nbatch % period == 0 and param.eval_metric is not None:
            for name, value in param.eval_metric.get_name_value():
                logging.info("Iter[%d] Batch[%d] Train-%s=%f",
                             param.epoch, param.nbatch, name, value)
            if auto_reset:
                param.eval_metric.reset_local()
    return _callback


class ProgressBar:
    """A batch-end callback that logs a bar of ``nbatch / total``."""

    def __init__(self, total, length=80):
        self.bar_len = length
        self.total = total

    def __call__(self, param):
        count = param.nbatch
        filled_len = int(round(self.bar_len * count / float(self.total)))
        percents = int(100.0 * count / self.total)
        prog_bar = "=" * filled_len + "-" * (self.bar_len - filled_len)
        logging.info("[%s] %s%%", prog_bar, percents)
