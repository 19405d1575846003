"""Hand-written CUDA kernels of the port and their plain PyTorch twins.

``flash_attention`` replaces every Pallas kernel of
``mxnet_tpu/kernels/flash_attention.py``: the forward (``csrc/flash_fwd.cu``)
and, through its ``torch.autograd.Function``, the fused, dq and dkv
backward kernels (``csrc/flash_bwd.cu``).  ``ring_attention`` and
``ulysses`` run sequence-parallel attention over a mesh axis on those
kernels.  ``paged_attention`` is plain tensor code, as it is in the
reference.  Kernels are built at first use
(``_build.py``), never at import.
"""

from .ring_attention import (ring_attention,  # noqa: F401
                             sequence_parallel_attention)
