"""``mx.mod`` — the legacy Module API, the port of ``mxnet_tpu/module/``
(MXNet's ``python/mxnet/module/``)."""

from .module import Module, BaseModule  # noqa: F401
from .bucketing_module import BucketingModule  # noqa: F401
