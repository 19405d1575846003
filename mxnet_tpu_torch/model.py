"""Legacy model helpers — the port of ``mxnet_tpu/model.py`` (MXNet's
``python/mxnet/model.py``): ``BatchEndParam``; ``save_checkpoint`` /
``load_checkpoint``, the ``prefix-symbol.json`` + ``prefix-%04d.params``
pair (``arg:``/``aux:`` keys, written and read by ``nd.save``/``nd.load``
and ``Symbol.save``/``sym.load``), so a checkpoint crosses between the
packages; and ``FeedForward``, the deprecated wrapper, as a thin veneer
over ``mx.mod.Module``.
"""

from __future__ import annotations

from collections import namedtuple

from . import ndarray as nd

__all__ = ["save_checkpoint", "load_checkpoint", "load_params", "FeedForward",
           "BatchEndParam"]

BatchEndParam = namedtuple("BatchEndParams",
                           ["epoch", "nbatch", "eval_metric", "locals"])


def save_checkpoint(prefix, epoch, symbol, arg_params, aux_params,
                    remove_amp_cast=True):  # noqa: ARG001
    """Write ``prefix-%04d.params`` with ``arg:<name>`` and ``aux:<name>``
    entries, and ``prefix-symbol.json`` when a ``symbol`` is given."""
    if symbol is not None:
        symbol.save(f"{prefix}-symbol.json")
    save_dict = {f"arg:{k}": v for k, v in (arg_params or {}).items()}
    save_dict.update({f"aux:{k}": v for k, v in (aux_params or {}).items()})
    nd.save(f"{prefix}-{epoch:04d}.params", save_dict)


def load_params(prefix, epoch, ctx=None):
    """``(arg_params, aux_params)`` from ``prefix-%04d.params`` (a key
    without a prefix counts as ``arg:``)."""
    save_dict = nd.load(f"{prefix}-{epoch:04d}.params", ctx=ctx)
    arg_params, aux_params = {}, {}
    for k, v in save_dict.items():
        tp, name = k.split(":", 1) if ":" in k else ("arg", k)
        (arg_params if tp == "arg" else aux_params)[name] = v
    return arg_params, aux_params


def load_checkpoint(prefix, epoch):
    """``(symbol, arg_params, aux_params)`` of a checkpoint."""
    from . import symbol as sym
    symbol = sym.load(f"{prefix}-symbol.json")
    arg_params, aux_params = load_params(prefix, epoch)
    return symbol, arg_params, aux_params


class FeedForward:
    """MXNet's deprecated training wrapper, kept for scripts: a ``Module``
    over ``symbol``."""

    def __init__(self, symbol, ctx=None, num_epoch=None, optimizer="sgd",
                 initializer=None, arg_params=None, aux_params=None,
                 **kwargs):
        from .module import Module
        self.symbol = symbol
        self._mod = Module(symbol, context=ctx)
        self.num_epoch = num_epoch
        self.optimizer = optimizer
        self.initializer = initializer
        self.arg_params = arg_params
        self.aux_params = aux_params
        self.kwargs = kwargs

    def fit(self, X, y=None, eval_data=None, eval_metric="acc",
            batch_end_callback=None, epoch_end_callback=None,
            **kwargs):  # noqa: ARG002
        self._mod.fit(X, eval_data=eval_data, eval_metric=eval_metric,
                      num_epoch=self.num_epoch or 1,
                      optimizer=self.optimizer,
                      batch_end_callback=batch_end_callback,
                      epoch_end_callback=epoch_end_callback,
                      initializer=self.initializer,
                      arg_params=self.arg_params,
                      aux_params=self.aux_params)

    def predict(self, X, num_batch=None):
        return self._mod.predict(X, num_batch=num_batch)

    @staticmethod
    def load(prefix, epoch, ctx=None, **kwargs):
        symbol, arg_params, aux_params = load_checkpoint(prefix, epoch)
        return FeedForward(symbol, ctx=ctx, arg_params=arg_params,
                           aux_params=aux_params, **kwargs)

    def save(self, prefix, epoch=0):
        arg, aux = self._mod.get_params()
        save_checkpoint(prefix, epoch, self.symbol, arg, aux)
