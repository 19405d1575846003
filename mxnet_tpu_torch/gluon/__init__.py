"""gluon — the imperative/hybrid model API (the port of
``mxnet_tpu/gluon/``): Parameter, Block, HybridBlock, nn, rnn, loss,
Trainer, data, utils, the Estimator (contrib) and the model zoo."""

from .parameter import Parameter, ParameterDict, Constant  # noqa: F401
from .block import Block, HybridBlock, SymbolBlock  # noqa: F401
from .trainer import Trainer  # noqa: F401
from . import nn  # noqa: F401
from . import rnn  # noqa: F401
from . import loss  # noqa: F401
from . import model_zoo  # noqa: F401
from . import data  # noqa: F401
from . import utils  # noqa: F401
from . import contrib  # noqa: F401
