"""``mx.contrib`` — the port of ``mxnet_tpu/contrib/__init__.py`` (MXNet's
``python/mxnet/contrib/``): ``amp`` (``mxnet_tpu_torch.amp``), the
``contrib`` operator namespaces of ``mx.nd`` and ``mx.sym`` as
``ndarray`` and ``symbol``, INT8 post-training ``quantization`` (loaded at
first use), ``text`` and ``svrg``.

``onnx`` and ``tensorrt`` are not part of the port: a model leaves it as
``.params`` files and the reference's symbol json, and the card runs
torch's kernels and the port's own, not a TensorRT engine.
"""

from .. import amp  # noqa: F401 (MXNet spells it mx.contrib.amp)
from ..ndarray import contrib as ndarray  # noqa: F401
from ..symbol import contrib as symbol  # noqa: F401

__all__ = ["amp", "ndarray", "symbol", "quantization", "text", "svrg"]


def __getattr__(name):
    if name == "quantization":
        import importlib
        mod = importlib.import_module(".quantization", __name__)
        globals()["quantization"] = mod
        return mod
    if name in ("onnx", "tensorrt"):
        raise AttributeError(
            f"mx.contrib.{name} is not part of mxnet_tpu_torch: models "
            "leave it as .params files and symbol json (save_parameters, "
            "Symbol.save), and it runs torch's and its own CUDA kernels, "
            "not an exported engine")
    raise AttributeError(
        f"module 'mxnet_tpu_torch.contrib' has no attribute {name!r}")


from . import text  # noqa: F401,E402
from . import svrg  # noqa: F401,E402
