"""mxnet_tpu_torch — the PyTorch/CUDA port of mxnet_tpu, for NVIDIA Hopper.

The JAX package ``mxnet_tpu`` is the reference; this package mirrors its
module names (``kernels.flash_attention``, ``ops.contrib``, ``ops.nn``,
``ops.elemwise``, ``gluon.model_zoo.{llama,bert,vision,yolo}``,
``initializer``,
``optimizer``, ``parallel``, ``serving.*``) so each counterpart is easy to
find.  It imports ``torch`` and never ``jax`` or ``mxnet_tpu``.

Slice 1 ports the serving path: the paged-KV continuous-batching engine
over the llama zoo model, with prefill attention on a hand-written CUDA
flash-forward kernel (``kernels/csrc/flash_fwd.cu``).  Slice 2 ports the
training path: ``parallel.TrainStep`` with MXNet's Adam
(``optimizer``), the BERT zoo model and the trainable llama, with
``flash_attention`` a ``torch.autograd.Function`` whose backward runs the
hand-written fused, dq and dkv kernels (``kernels/csrc/flash_bwd.cu``).
Slice 8 ports MXNet's imperative surface: ``mx.nd`` (NDArray over
``torch.Tensor``, ops generated from ``ops.registry``), ``mx.autograd``
over torch autograd, and ``mx.gluon`` (Parameter, Block/HybridBlock over
``torch.nn.Module``, ``nn``, ``loss``, ``Trainer``), with the zoo BERT a
Gluon HybridBlock.  Slice 9 ports convolution, pooling and BatchNorm (ops
that write back into their inputs), the conv and norm layers, the vision
zoo's ResNets and the ``.params`` files (``nd.save``/``load``,
``save_parameters``/``load_parameters``; ``dmlc_params``).  Then the
training loop around the model: ``gluon.data`` (datasets,
samplers, ``DataLoader`` with worker processes, the array transforms),
``metric``, ``lr_scheduler``, every optimizer of the reference with
``Updater`` and the ``nd.*_update`` ops, the local kvstore (``kv``) with
Parameters on several contexts, ``gluon.utils`` and the Estimator.  Then the rest of ``mx.nd``: the
samplers (``mx.nd.random``, ``mx.random.uniform`` ...), ``mx.nd.linalg``,
the legacy alias names, the remaining elementwise, reduction, matrix and
nn ops, the loss heads, and the contrib attention family
(``masked_encdec_att``, ``multihead_attention``) through the flash kernels.
Then ``gluon.rnn``, the remaining losses and the vision zoo, and the
detection surface: the sampling, ROI, correlation and SSD/RPN ops of
``ops.vision`` and the box ops (NMS on the device), YOLOv3
(``gluon.model_zoo.yolo``), ``gluon.contrib`` (``SparseMoE``,
``Concurrent``, ``Identity``, ``SyncBatchNorm``), and the llama as Gluon
blocks.
Then data input: ``recordio`` (with the RecordIO scanner in C++), an
image codec in the repo (``codec``: baseline JPEG decode and encode in
C++, ``src/image_codec.cc``, and PNG), ``image`` (``imdecode``,
``imresize``, the augmenters, ``ImageIter``, ``ImageDetIter``), ``io``
(``NDArrayIter`` ... ``ImageRecordIter`` with the shared-memory decode
pool) and the vision datasets.
Then the rest of ``parallel.TrainStep`` (microbatching, rematerialisation
through ``gluon.utils.remat_call``, one CUDA graph per step signature),
``amp`` (the reference's cast lists at the dispatch chokepoint) and the
transformer-base MT model (``gluon.model_zoo.transformer``).
Then the training utilities: ``checkpoint`` (step checkpoints and
``auto_resume``), 2-bit gradient compression (``kvstore.compression``),
``optimizer_fusion`` (fused Adam and SGD), ``monitor``, ``callback``,
``model`` (``.params`` checkpoints), ``engine``, ``runtime``,
``test_utils``, ``operator`` (``CustomOp``, ``nd.Custom``) and
``library``; mixed float inputs promote as ``jnp`` does.
Then the rest of serving (the prefix cache, speculative decoding, the
router and its replicas, telemetry and resilience).  Then the symbolic
API: ``mx.sym`` (``Symbol`` graphs over the op registry, evaluated node
by node by an ``Executor`` under torch autograd, shapes inferred on the
``meta`` device, the reference's json), ``mx.mod`` (``Module``,
``BucketingModule``), ``gluon.SymbolBlock``, the symbol checkpoints of
``model``, ``mx.viz``, ``mx.name``, ``mx.AttrScope`` and
``amp.convert_model``.  Then operations: the rest of ``telemetry`` (the
step clock, the cost ledger, the per-op ledger and dispatch hook, the
flight recorder, the scrape endpoint, cross-process aggregation) and
``mx.profiler`` over ``torch.profiler``.  Then ``mx.contrib``: INT8
post-training quantization (``contrib.quantization``, the six int8 ops of
``ops.quantization`` over ``torch._int_mm``, the ``INT8`` pass of
``Symbol.optimize_for``), ``contrib.text`` and ``contrib.svrg``; and sparse
storage (``mx.nd.sparse``: row_sparse and CSR arrays, the sparse ops,
``Embedding(sparse_grad=True)``, ``kvstore.sparse_ps.SparsePS``,
``LibSVMIter``).

Entry points run on the CUDA card by default: the default context is
``mx.gpu(0)``, not the reference's ``mx.cpu(0)``.  Pass ``ctx=mx.cpu()``,
use ``with mx.cpu():`` or ``device="cpu"`` to run on the host (the CPU
tests do); with no card, asking for the default raises ``MXNetError``.
float32 matmuls run in full float32 (TF32 off), mirroring the reference's
"highest" matmul precision.
"""

import torch as _torch

__version__ = "0.1.0"

# float32 means float32: the reference pins jax_default_matmul_precision
# to "highest"; the TF32 tensor-core path would keep ~3 decimal digits
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False

from . import config  # noqa: E402,F401
from .base import MXNetError  # noqa: E402,F401
from .context import (Context, cpu, cpu_pinned, cpu_shared,  # noqa: E402,F401
                      current_context, gpu, num_gpus, resolve_device)
from . import random  # noqa: E402,F401
from . import ndarray  # noqa: E402,F401
from . import ndarray as nd  # noqa: E402,F401
from .ndarray import waitall  # noqa: E402,F401

# the stateful-RNG shorthands: mx.random.seed(s); mx.random.uniform(...)
random.uniform = nd.random.uniform
random.normal = nd.random.normal
random.randn = lambda *shape, **kw: nd.random.normal(shape=shape, **kw)
random.randint = nd.random.randint
random.multinomial = nd.random.multinomial
random.shuffle = nd.shuffle
from . import autograd  # noqa: E402,F401
from . import initializer  # noqa: E402,F401
from . import initializer as init  # noqa: E402,F401
from . import lr_scheduler, metric  # noqa: E402,F401
from . import optimizer, gluon, parallel  # noqa: E402,F401
from . import kvstore  # noqa: E402,F401
from . import kvstore as kv  # noqa: E402,F401
from . import recordio, image, io  # noqa: E402,F401
from . import amp  # noqa: E402,F401
from . import engine, runtime, test_utils  # noqa: E402,F401
from . import monitor, callback, model, checkpoint  # noqa: E402,F401
from . import operator, library, optimizer_fusion  # noqa: E402,F401
from . import telemetry, resilience, profiler  # noqa: E402,F401
from . import name, attribute, visualization  # noqa: E402,F401
from . import visualization as viz  # noqa: E402,F401
from .attribute import AttrScope  # noqa: E402,F401
from . import symbol  # noqa: E402,F401
from . import symbol as sym  # noqa: E402,F401
from . import module  # noqa: E402,F401
from . import module as mod  # noqa: E402,F401
from . import contrib  # noqa: E402,F401
from . import util  # noqa: E402,F401

# modules loaded on first use, as the reference loads them
# (``mxnet_tpu/__init__.py``): the serving engine, the native loader and
# ``mx.np`` stay out of a plain ``import mxnet_tpu_torch``
_LAZY = {"serving": "serving", "native": "native", "numpy": "numpy",
         "np": "numpy", "numpy_extension": "numpy_extension",
         "npx": "numpy_extension", "rtc": "rtc", "sharding": "sharding",
         "pipeline": "pipeline", "autoshard": "autoshard"}


def __getattr__(name):
    target = _LAZY.get(name)
    if target is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib
    mod = importlib.import_module(f".{target}", __name__)
    globals()[name] = mod
    return mod
