"""The operators of the port, registered under the reference's names;
importing the package registers them all (``mx.nd.*`` is generated from
the registry), and the reference's alias table
(``mxnet_tpu/ops/__init__.py``) exposes its legacy CamelCase names."""

from . import registry  # noqa: F401
from .registry import register, get, list_ops, invoke  # noqa: F401
from . import elemwise, reduce, matrix, nn, contrib, optimizer_ops  # noqa: F401
from . import random_ops, linalg, vision  # noqa: F401
from . import quantization, sparse_ops  # noqa: F401

# upstream MXNet registers legacy CamelCase names beside the snake_case ones
_ALIASES = {
    "SequenceMask": "sequence_mask",
    "SequenceLast": "sequence_last",
    "SequenceReverse": "sequence_reverse",
    "SwapAxis": "swapaxes",
    "MakeLoss": "make_loss",
    "BlockGrad": "stop_gradient",
    "Pad": "pad",
    "Cast": "cast",
    "Reshape": "reshape",
    "Flatten": "flatten",
    "Concat": "concat",
    "Softmax": "SoftmaxOutput",     # upstream: Softmax is the LOSS head
    "SliceChannel": "slice_channel",
    "ElementWiseSum": "add_n",
    "l2_normalization": "L2Normalization",
    "logical_xor": "broadcast_logical_xor",
    "contrib.boolean_mask": "boolean_mask",
}
for _alias, _target in _ALIASES.items():
    registry.alias(_alias, _target)
