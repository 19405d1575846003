"""gluon.nn — neural network layers (the port of ``mxnet_tpu/gluon/nn/``)."""

from ..block import Block, HybridBlock, SymbolBlock  # noqa: F401
from .basic_layers import *  # noqa: F401,F403
from .activations import *  # noqa: F401,F403
from .conv_layers import *  # noqa: F401,F403
