"""mxnet_tpu_torch — the PyTorch/CUDA port of mxnet_tpu, for NVIDIA Hopper.

The JAX package ``mxnet_tpu`` is the reference; this package mirrors its
module names (``kernels.flash_attention``, ``ops.contrib``, ``ops.nn``,
``ops.elemwise``, ``gluon.model_zoo.{llama,bert}``, ``initializer``,
``optimizer``, ``parallel``, ``serving.*``) so each counterpart is easy to
find.  It imports ``torch`` and never ``jax`` or ``mxnet_tpu``.

Slice 1 ports the serving path: the paged-KV continuous-batching engine
over the llama zoo model, with prefill attention on a hand-written CUDA
flash-forward kernel (``kernels/csrc/flash_fwd.cu``).  Slice 2 ports the
training path: ``parallel.TrainStep`` with MXNet's Adam
(``optimizer``), the BERT zoo model and the trainable llama, with
``flash_attention`` a ``torch.autograd.Function`` whose backward runs the
hand-written fused, dq and dkv kernels (``kernels/csrc/flash_bwd.cu``).

Entry points run on the CUDA card by default; pass ``device="cpu"`` to run
on the host (the CPU tests do).  float32 matmuls run in full float32
(TF32 off), mirroring the reference's "highest" matmul precision.
"""

import torch as _torch

__version__ = "0.1.0"

# float32 means float32: the reference pins jax_default_matmul_precision
# to "highest"; the TF32 tensor-core path would keep ~3 decimal digits
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False

from . import config  # noqa: E402,F401
from .base import MXNetError  # noqa: E402,F401
from .context import cpu, gpu, resolve_device  # noqa: E402,F401
from . import initializer, optimizer, parallel  # noqa: E402,F401
