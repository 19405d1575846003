"""mx.io — the port of ``mxnet_tpu/io``: the DataIter API (``io.io``) and
the shared-memory decode pipeline (``io.pipeline``)."""

from .io import (  # noqa: F401
    DataDesc, DataBatch, DataIter, NDArrayIter, ResizeIter, PrefetchingIter,
    CSVIter, MNISTIter, ImageRecordIter, LibSVMIter,
)
from .pipeline import PooledDecodePipeline  # noqa: F401
