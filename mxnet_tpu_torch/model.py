"""Legacy model helpers — the port of ``mxnet_tpu/model.py`` (MXNet's
``python/mxnet/model.py``): ``BatchEndParam``, and ``save_checkpoint`` /
``load_params`` over ``prefix-%04d.params`` files of ``arg:``/``aux:``
keys, written and read by ``nd.save``/``nd.load``, so a file crosses
between the packages.

The symbol half (``save_checkpoint`` with a symbol, ``load_checkpoint``,
``FeedForward``) needs ``symbol/`` and ``module/``, not yet ported
(ROADMAP A.10): it raises.
"""

from __future__ import annotations

from collections import namedtuple

from . import ndarray as nd
from .base import MXNetError

__all__ = ["save_checkpoint", "load_checkpoint", "load_params", "FeedForward",
           "BatchEndParam"]

BatchEndParam = namedtuple("BatchEndParams",
                           ["epoch", "nbatch", "eval_metric", "locals"])


def _symbol_not_ported(what):
    return MXNetError(f"{what} needs symbol/ and module/, which are not yet "
                      "ported to mxnet_tpu_torch (ROADMAP A.10)")


def save_checkpoint(prefix, epoch, symbol, arg_params, aux_params,
                    remove_amp_cast=True):  # noqa: ARG001
    """Write ``prefix-%04d.params`` with ``arg:<name>`` and ``aux:<name>``
    entries; a ``symbol`` (``prefix-symbol.json``) raises."""
    if symbol is not None:
        raise _symbol_not_ported("save_checkpoint with a symbol")
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


def load_checkpoint(prefix, epoch):  # noqa: ARG001
    raise _symbol_not_ported("load_checkpoint")


class FeedForward:
    """MXNet's deprecated training wrapper over ``module/``: raises."""

    def __init__(self, *args, **kwargs):  # noqa: ARG002
        raise _symbol_not_ported("FeedForward")
