"""mx.serving of the port — paged-KV continuous-batching inference.

Three layers, as in ``mxnet_tpu.serving``:

- ``kernels.paged_attention`` (device) — block-pool KV storage with
  per-sequence block tables;
- ``serving.cache`` (host) — the free-list allocator and block-table /
  context-length bookkeeping;
- ``serving.models`` + ``serving.engine`` — fixed-shape prefill (flash
  forward kernel at eligible prompt shapes) and single-token decode for
  the llama zoo model, driven by a continuous-batching scheduler.

Quick start::

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import serving
    from mxnet_tpu_torch.gluon.model_zoo import llama
    net = llama.llama_model("llama_tiny", vocab_size=256)
    net.collect_params().setattr("grad_req", "null")   # no gradient buffers
    net.initialize(mx.init.Normal(0.02), ctx=mx.gpu())
    eng = serving.ServingEngine(net, eos_id=2)
    tokens = eng.generate([[1, 17, 93]], max_new_tokens=32)[0]

Prefix caching, speculative decoding, the encoder-decoder adapter,
telemetry and the replica/router tier are not ported yet.
"""

from __future__ import annotations

from .cache import BlockAllocator, CacheOOMError, PagedKVCache  # noqa: F401
from .engine import (  # noqa: F401
    Request, RequestDeadlineExceeded, ResultHandle, ServingEngine,
    ServingError,
)
from .models import LlamaServingAdapter, make_adapter  # noqa: F401

__all__ = [
    "ServingEngine", "Request", "ResultHandle", "ServingError",
    "RequestDeadlineExceeded", "PagedKVCache", "BlockAllocator",
    "CacheOOMError", "LlamaServingAdapter", "make_adapter",
]
