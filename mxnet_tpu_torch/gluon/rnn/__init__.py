"""gluon.rnn — recurrent layers and cells (the port of
``mxnet_tpu/gluon/rnn/``)."""

from .rnn_cell import (RecurrentCell, HybridRecurrentCell, RNNCell, LSTMCell,
                       GRUCell, SequentialRNNCell, HybridSequentialRNNCell,
                       DropoutCell, ZoneoutCell, ResidualCell,
                       BidirectionalCell, ModifierCell)  # noqa: F401
from .rnn_layer import RNN, LSTM, GRU  # noqa: F401
