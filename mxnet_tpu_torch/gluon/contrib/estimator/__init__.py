"""gluon.contrib.estimator — the port of
``mxnet_tpu/gluon/contrib/estimator/``."""

from .estimator import Estimator  # noqa: F401
from .event_handler import (TrainBegin, TrainEnd, EpochBegin, EpochEnd,  # noqa: F401
                            BatchBegin, BatchEnd, StoppingHandler,
                            LoggingHandler, CheckpointHandler,
                            EarlyStoppingHandler, ValidationHandler)
