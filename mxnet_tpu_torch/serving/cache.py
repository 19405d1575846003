"""Paged KV cache — host-side block bookkeeping for the serving engine.

A copy of ``mxnet_tpu/serving/cache.py`` for the port (the port imports
nothing of the JAX package), without the prefix-cache bookkeeping, which is
not ported yet.  The device half lives in ``kernels.paged_attention``; this
module is the virtual-memory half: a free-list ``BlockAllocator`` and the
per-slot block tables / context lengths the scheduler mutates between
decode iterations.  All of it is plain numpy.

Block 0 is reserved as the scratch block: inactive slots park their whole
table on it and padded prefill positions are routed to it, so freed blocks
can be handed to a new sequence without zeroing.
"""

from __future__ import annotations

import numpy as np

from ..base import MXNetError
from ..kernels.paged_attention import SCRATCH_BLOCK

__all__ = ["CacheOOMError", "BlockAllocator", "PagedKVCache"]


class CacheOOMError(MXNetError):
    """The block pool cannot satisfy an allocation — the scheduler's cue
    to defer admission or preempt a running sequence."""


class BlockAllocator:
    """LIFO free list over pool blocks 1..num_blocks-1 (0 is scratch).

    LIFO keeps recently-freed blocks circulating first and makes reuse
    immediate: a just-freed block is the very next one handed out.
    """

    def __init__(self, num_blocks):
        if num_blocks < 2:
            raise MXNetError("paged pool needs >= 2 blocks "
                             "(block 0 is the scratch block)")
        self.num_blocks = int(num_blocks)
        self._free = list(range(self.num_blocks - 1, SCRATCH_BLOCK, -1))

    @property
    def free_blocks(self):
        return len(self._free)

    def alloc(self, n):
        """Pop ``n`` blocks or raise CacheOOMError (all-or-nothing)."""
        if n > len(self._free):
            raise CacheOOMError(
                f"paged KV cache exhausted: need {n} blocks, "
                f"{len(self._free)} free of {self.num_blocks - 1} "
                "(raise MXNET_SERVING_NUM_BLOCKS or lower the batch)")
        taken = self._free[-n:] if n else []
        del self._free[len(self._free) - n:]
        return taken

    def free(self, blocks):
        for b in blocks:
            if not (SCRATCH_BLOCK < b < self.num_blocks):
                raise MXNetError(f"freeing invalid block {b}")
            if b in self._free:
                raise MXNetError(f"double free of block {b}")
        self._free.extend(blocks)


class PagedKVCache:
    """Block tables + context lengths for ``max_batch`` decode slots.

    The engine uploads ``tables`` (fixed shape) when ``version`` moved and
    passes ``ctx_len`` each iteration.  Device pools are owned by the model
    adapter; this object is device-free.
    """

    def __init__(self, max_batch, max_blocks_per_seq, block_tokens,
                 num_blocks):
        self.max_batch = int(max_batch)
        self.max_blocks_per_seq = int(max_blocks_per_seq)
        self.block_tokens = int(block_tokens)
        self.allocator = BlockAllocator(num_blocks)
        self.tables = np.full((max_batch, max_blocks_per_seq),
                              SCRATCH_BLOCK, np.int32)
        self.ctx_len = np.zeros((max_batch,), np.int32)
        self._owned = [[] for _ in range(max_batch)]   # slot -> blocks
        # bumped on every table mutation: the engine re-uploads the device
        # copy only when this moved
        self.version = 0

    @property
    def free_blocks(self):
        return self.allocator.free_blocks

    def blocks_for(self, n_tokens):
        """Blocks needed to hold ``n_tokens`` cache positions."""
        return -(-int(n_tokens) // self.block_tokens)

    def admit(self, slot, n_tokens):
        """Claim blocks for a sequence entering ``slot`` with ``n_tokens``
        positions about to be written.  All-or-nothing; raises
        CacheOOMError with the slot untouched.  Returns the block list."""
        if self._owned[slot]:
            raise MXNetError(f"slot {slot} already owns blocks")
        need = self.blocks_for(max(int(n_tokens), 1))
        if need > self.max_blocks_per_seq:
            raise CacheOOMError(
                f"sequence needs {need} blocks > max_blocks_per_seq "
                f"{self.max_blocks_per_seq} (MXNET_SERVING_MAX_SEQ)")
        blocks = self.allocator.alloc(need)
        self._owned[slot] = blocks
        row = np.full((self.max_blocks_per_seq,), SCRATCH_BLOCK, np.int32)
        row[:need] = blocks
        self.tables[slot] = row
        self.ctx_len[slot] = 0
        self.version += 1
        return blocks

    def ensure_capacity(self, slot):
        """Guarantee the slot's next write position has a block; allocates
        at block boundaries.  Raises CacheOOMError (slot untouched) when
        the pool is dry — the scheduler then preempts."""
        pos_last = int(self.ctx_len[slot])
        bi_last = pos_last // self.block_tokens
        if bi_last >= self.max_blocks_per_seq:
            raise CacheOOMError(
                f"slot {slot} hit max_blocks_per_seq at position "
                f"{pos_last} (MXNET_SERVING_MAX_SEQ)")
        owned = self._owned[slot]
        grow = bi_last + 1 - len(owned)
        if grow <= 0:
            return
        blocks = self.allocator.alloc(grow)        # all-or-nothing
        for blk in blocks:
            owned.append(blk)
            self.tables[slot, len(owned) - 1] = blk
        self.version += 1

    def advance(self, slot):
        self.ctx_len[slot] += 1

    def release(self, slot):
        """Return the slot's blocks to the pool and park it on scratch."""
        blocks = self._owned[slot]
        self._owned[slot] = []
        if blocks:
            self.allocator.free(blocks)
        self.tables[slot] = SCRATCH_BLOCK
        self.ctx_len[slot] = 0
        self.version += 1
        return blocks
