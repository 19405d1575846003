"""Hand-written CUDA kernels of the port and their plain PyTorch twins.

``flash_attention`` (kernel source ``csrc/flash_fwd.cu``) replaces the
forward Pallas kernels of ``mxnet_tpu/kernels/flash_attention.py``;
``paged_attention`` is plain tensor code, as it is in the reference.
Kernels are built at first use (``_build.py``), never at import.
"""
