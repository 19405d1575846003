"""mx.npx — the NumPy-extension namespace (the port of
``mxnet_tpu/numpy_extension/__init__.py``): ``set_np`` / ``reset_np``, the
context names, ``waitall``, ``save`` / ``load``, and the neural-network
ops that NumPy lacks under MXNet's snake_case names (``npx.softmax``,
``npx.batch_norm`` ...), each the registry op of the reference's table.

Each op takes NDArrays (``mx.nd``'s generated function) or, inside a
hybridized block, bare tensors (``registry.tensor_ops``, amp's cast hook
included).
"""

from __future__ import annotations

import sys as _sys

import torch as _torch

from ..base import MXNetError
from ..context import cpu, gpu, num_gpus, current_context  # noqa: F401
from ..ndarray import register as _ndreg
from ..ndarray.ndarray import NDArray
from ..ops import registry as _reg
from ..util import set_np, reset_np, is_np_array, is_np_shape  # noqa: F401

_self = _sys.modules[__name__]

# npx name -> registry op (the reference's table)
_NPX_OPS = {
    "softmax": "softmax",
    "log_softmax": "log_softmax",
    "relu": "relu",
    "sigmoid": "sigmoid",
    "batch_norm": "BatchNorm",
    "layer_norm": "LayerNorm",
    "group_norm": "GroupNorm",
    "instance_norm": "InstanceNorm",
    "fully_connected": "FullyConnected",
    "convolution": "Convolution",
    "deconvolution": "Deconvolution",
    "pooling": "Pooling",
    "activation": "Activation",
    "leaky_relu": "LeakyReLU",
    "dropout": "Dropout",
    "embedding": "Embedding",
    "rnn": "RNN",
    "one_hot": "one_hot",
    "pick": "pick",
    "topk": "topk",
    "gamma": "gamma",
    "sequence_mask": "sequence_mask",
    "reshape_like": "broadcast_like",
    "batch_dot": "batch_dot",
    "gather_nd": "gather_nd",
    "scatter_nd": "scatter_nd",
    "sign": "sign",
    "erf": "erf",
    "erfinv": "erfinv",
    "smooth_l1": "smooth_l1",
    "multinomial": "sample_multinomial",
    "shuffle": "shuffle",
    "arange_like": "contrib.arange_like",
}


def _op_func(npx_name, op_name):
    nd_fn = _ndreg._make_op_func(_reg.get(op_name))

    def fn(*args, **kwargs):
        if any(isinstance(a, _torch.Tensor) for a in args) and not any(
                isinstance(a, NDArray) for a in args):
            f = _reg.tensor_ops
            for part in op_name.split("."):
                f = getattr(f, part)
            return f(*[a for a in args if a is not None], **kwargs)
        return nd_fn(*args, **kwargs)

    fn.__name__ = npx_name
    fn.__doc__ = nd_fn.__doc__
    return fn


for _npx_name, _op_name in _NPX_OPS.items():
    setattr(_self, _npx_name, _op_func(_npx_name, _op_name))
del _npx_name, _op_name


def tpu(device_id=0):  # noqa: ARG001
    """The reference's TPU context: this port runs on CUDA cards
    (``npx.gpu``) and the host (``npx.cpu``)."""
    raise MXNetError("mxnet_tpu_torch has no TPU context: use npx.gpu() or "
                     "npx.cpu()")


def waitall():
    from .. import ndarray as nd
    nd.waitall()


def load(fname):
    from .. import ndarray as nd
    return nd.load(fname)


def save(fname, data):
    from .. import ndarray as nd
    return nd.save(fname, data)
