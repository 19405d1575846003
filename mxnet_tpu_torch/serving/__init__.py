"""mx.serving of the port — paged-KV continuous-batching inference and
the fault-tolerant replica tier.

Layers, as in ``mxnet_tpu.serving``:

- ``kernels.paged_attention`` (device) — block-pool KV storage with
  per-sequence block tables;
- ``serving.cache`` (host) — the free-list allocator, block tables and
  context lengths, and the refcounted prefix index (copy-on-write, LRU
  eviction);
- ``serving.models`` + ``serving.engine`` — fixed-shape prefill (the flash
  forward kernel at eligible prompt shapes) and decode for the llama and
  the MT transformer, driven by a continuous-batching scheduler with
  prefix caching and draft-verify speculative decoding, both giving the
  tokens of plain greedy decoding;
- ``serving.replica`` + ``serving.router`` — N engine subprocesses behind
  one router: least-loaded dispatch with prefix affinity, admission
  shedding, deadline propagation, retry on replica death, hedging,
  drain, and re-adoption after the router itself dies.

Quick start::

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import serving
    from mxnet_tpu_torch.gluon.model_zoo import llama
    net = llama.llama_model("llama_tiny", vocab_size=256)
    net.collect_params().setattr("grad_req", "null")   # no gradient buffers
    net.initialize(mx.init.Normal(0.02), ctx=mx.gpu())
    eng = serving.ServingEngine(net, eos_id=2, prefix_cache=True)
    tokens = eng.generate([[1, 17, 93]], max_new_tokens=32)[0]

Knobs: ``MXNET_SERVING_{BLOCK_TOKENS,MAX_BATCH,MAX_SEQ,NUM_BLOCKS,
PREFILL_TOKENS,SLA_S,PREFIX_CACHE,DRAFT,SPEC_K}`` and ``MXNET_ROUTER_*``
(``config.KNOWN_VARS``).
"""

from __future__ import annotations

from .cache import BlockAllocator, CacheOOMError, PagedKVCache  # noqa: F401
from .engine import (  # noqa: F401
    Request, RequestDeadlineExceeded, ResultHandle, ServingEngine,
    ServingError,
)
from .models import (  # noqa: F401
    LlamaServingAdapter, TransformerServingAdapter, make_adapter,
)
from .replica import ReplicaServer  # noqa: F401
from .router import (  # noqa: F401
    ReplicaDeadError, Router, RouterHandle, RouterOverloaded,
)

__all__ = [
    "ServingEngine", "Request", "ResultHandle", "ServingError",
    "RequestDeadlineExceeded", "PagedKVCache", "BlockAllocator",
    "CacheOOMError", "LlamaServingAdapter", "TransformerServingAdapter",
    "make_adapter",
    "Router", "RouterHandle", "RouterOverloaded", "ReplicaDeadError",
    "ReplicaServer",
]
