"""Paged KV cache — host-side block bookkeeping for the serving engine.

The port's own copy of ``mxnet_tpu/serving/cache.py`` (the port imports
nothing of the JAX package).  The device half lives in
``kernels.paged_attention``; this module is the virtual-memory half: a
free-list ``BlockAllocator`` and the per-slot block tables / context
lengths the scheduler mutates between decode iterations.  All of it is
plain numpy.

Block 0 is reserved as the scratch block: inactive slots park their whole
table on it and padded prefill positions are routed to it, so freed blocks
can be handed to a new sequence without zeroing.

Prefix caching (vLLM's automatic prefix caching): with
``prefix_cache=True`` every block is REFCOUNTED and full blocks of a
prompt register in a prefix index keyed by incremental CHAIN keys
``(parent_block, parent_generation, block's own token tuple)``: the parent
entry pins the whole preceding prefix by induction (dict equality on the
tuple — no hash-collision aliasing), and the generation stamp keeps a
recycled parent block id from falsely re-rooting an old chain.  A later
prompt sharing a cached prefix maps those blocks into its table
(refcount++) and only prefills the tail.  Blocks whose refcount drops to 0
while still registered park on an LRU list instead of the free list;
allocation under pressure evicts them LRU-first, so the cache costs
nothing when the pool is needed.  Copy-on-write: before a slot writes into
a block some OTHER owner still maps (refcount > 1), :meth:`prepare_write`
swaps in a private copy — the engine device-copies the contents and the
sharers keep the original.
"""

from __future__ import annotations

import collections

import numpy as np

from ..base import MXNetError
from ..kernels.paged_attention import SCRATCH_BLOCK

__all__ = ["CacheOOMError", "BlockAllocator", "PagedKVCache"]


class CacheOOMError(MXNetError):
    """The block pool cannot satisfy an allocation — the scheduler's cue
    to defer admission or preempt a running sequence."""


class BlockAllocator:
    """LIFO free list over pool blocks 1..num_blocks-1 (0 is scratch).

    LIFO keeps recently-freed (cache-hot) blocks circulating first and
    makes reuse immediate — the block-reuse correctness tests lean on
    that: a just-freed block is the very next one handed out.
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
        """Pop ``n`` blocks or raise CacheOOMError (allocation is
        all-or-nothing so a half-admitted sequence never exists)."""
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

    Owns the allocator and the numpy mirrors of everything the decode
    step consumes; the engine uploads ``tables``/``ctx_len`` (fixed
    shapes) each iteration.  Device pools are owned by the model adapter
    (their layout is per-model); this object is deliberately
    device-free so it unit-tests without torch.
    """

    def __init__(self, max_batch, max_blocks_per_seq, block_tokens,
                 num_blocks, prefix_cache=False):
        self.max_batch = int(max_batch)
        self.max_blocks_per_seq = int(max_blocks_per_seq)
        self.block_tokens = int(block_tokens)
        self.allocator = BlockAllocator(num_blocks)
        # scratch-parked tables: SCRATCH_BLOCK everywhere
        self.tables = np.full((max_batch, max_blocks_per_seq),
                              SCRATCH_BLOCK, np.int32)
        self.ctx_len = np.zeros((max_batch,), np.int32)
        self._owned = [[] for _ in range(max_batch)]   # slot -> blocks
        # bumped on every table mutation: the engine re-uploads the device
        # copy only when this moved (tables change at admission/allocation,
        # not every decode iteration — steady-state skips the transfer)
        self.version = 0
        # -- prefix cache state (all empty / inert when disabled) --------
        self.prefix_cache = bool(prefix_cache)
        self._refcount = {}              # block -> live owner count
        self._prefix = {}                # chain key -> block
        self._block_key = {}             # block -> its index key
        self._block_gen = {}             # block -> registration stamp
        self._gen = 0                    # monotonic registration counter
        self._cached_lru = collections.OrderedDict()   # refcount-0 blocks
        self.evictions = 0               # cached blocks evicted for reuse
        self.prefix_hits = 0             # admissions that shared >=1 block
        self.prefix_hit_tokens = 0       # positions mapped instead of
        #                                  prefilled (engine may recompute
        #                                  the boundary chunk — it counts
        #                                  its own chunk positions)
        self.cow_copies = 0              # copy-on-write block duplications

    @property
    def free_blocks(self):
        return self.allocator.free_blocks

    @property
    def cached_blocks(self):
        """Refcount-0 blocks retained for prefix reuse (evictable)."""
        return len(self._cached_lru)

    def blocks_for(self, n_tokens):
        """Blocks needed to hold ``n_tokens`` cache positions."""
        return -(-int(n_tokens) // self.block_tokens)

    # -- allocation core ----------------------------------------------------

    def _take(self, n):
        """Allocate ``n`` blocks, evicting refcount-0 cached prefix
        blocks LRU-first when the free list runs short.  Raises
        CacheOOMError (nothing mutated beyond evictions, which are
        semantically free) when even eviction cannot cover it."""
        while self.allocator.free_blocks < n and self._cached_lru:
            blk, _ = self._cached_lru.popitem(last=False)
            key = self._block_key.pop(blk)
            del self._prefix[key]
            self._block_gen.pop(blk, None)
            self._refcount.pop(blk, None)
            self.allocator.free([blk])
            self.evictions += 1
        taken = self.allocator.alloc(n)
        if self.prefix_cache:
            for b in taken:
                self._refcount[b] = 1
        return taken

    def _decref(self, blk):
        """Drop one ownership reference.  A block reaching refcount 0
        parks on the cached LRU when the prefix index still maps it,
        else returns to the free list."""
        left = self._refcount[blk] - 1
        if left > 0:
            self._refcount[blk] = left
            return
        del self._refcount[blk]
        if blk in self._block_key:
            self._cached_lru[blk] = True
            self._cached_lru.move_to_end(blk)
        else:
            self.allocator.free([blk])

    def _incref(self, blk):
        if blk in self._refcount:
            self._refcount[blk] += 1
        else:                            # reviving a cached block
            self._refcount[blk] = 1
            self._cached_lru.pop(blk, None)

    # -- prefix index -------------------------------------------------------

    _CHAIN_ROOT = (-1, 0)                # (parent_block, parent_gen) seed

    def _chain_key(self, parent, tokens, i):
        """Index key of chain position ``i``: the parent entry's
        (block, generation) identity + this block's OWN tokens — the
        parent pins the whole preceding prefix by induction, so the key
        is exact in O(block) instead of O(prefix)."""
        T = self.block_tokens
        return (parent[0], parent[1],
                tuple(tokens[i * T:(i + 1) * T]))

    def match_prefix(self, tokens):
        """Longest chain of cached FULL blocks matching ``tokens``'s own
        prefix: returns (blocks, matched_token_count).  Chain keys are
        compared by dict equality, so aliasing two different prefixes is
        impossible.  Read-only (no refcount/LRU mutation)."""
        if not self.prefix_cache:
            return [], 0
        parent = self._CHAIN_ROOT
        blocks = []
        for i in range(len(tokens) // self.block_tokens):
            blk = self._prefix.get(self._chain_key(parent, tokens, i))
            if blk is None:
                break
            blocks.append(blk)
            parent = (blk, self._block_gen[blk])
        return blocks, len(blocks) * self.block_tokens

    def register_prefix(self, slot, tokens):
        """Index every FULL block of a just-prefilled prompt.  First
        writer wins per key (a shared block is already registered under
        the same key — the chain continues through the EXISTING entry,
        so deeper keys always reference index blocks), and index entries
        always point at a block whose T positions hold exactly the
        chained prefix's K/V."""
        if not self.prefix_cache:
            return
        T = self.block_tokens
        owned = self._owned[slot]
        parent = self._CHAIN_ROOT
        for i in range(min(len(tokens) // T, len(owned))):
            key = self._chain_key(parent, tokens, i)
            blk = self._prefix.get(key)
            if blk is None:
                blk = owned[i]
                if blk in self._block_key:
                    # a block carries at most one index identity (e.g. a
                    # COW copy that shadowed its original): stop — deeper
                    # chaining through it would alias two prefixes
                    return
                self._gen += 1
                self._prefix[key] = blk
                self._block_key[blk] = key
                self._block_gen[blk] = self._gen
            parent = (blk, self._block_gen[blk])

    # -- slot lifecycle -----------------------------------------------------

    def admit(self, slot, n_tokens, prompt=None):
        """Claim blocks for a sequence entering ``slot`` with
        ``n_tokens`` positions about to be written (its prompt).
        All-or-nothing; raises CacheOOMError with the slot untouched.

        With ``prompt`` given (and prefix caching on), full blocks of
        the prompt found in the prefix index are MAPPED (refcount++)
        instead of allocated — ``prefix_hit_tokens`` advances by the
        prompt positions they cover (the engine reads the delta).
        Returns the slot's block list (shared blocks lead)."""
        if self._owned[slot]:
            raise MXNetError(f"slot {slot} already owns blocks")
        need = self.blocks_for(max(int(n_tokens), 1))
        if need > self.max_blocks_per_seq:
            raise CacheOOMError(
                f"sequence needs {need} blocks > max_blocks_per_seq "
                f"{self.max_blocks_per_seq} (MXNET_SERVING_MAX_SEQ)")
        shared, shared_tokens = ([], 0) if prompt is None \
            else self.match_prefix(prompt)
        shared = shared[:need]
        shared_tokens = min(shared_tokens, len(shared) * self.block_tokens)
        # pin the match BEFORE allocating: _take's eviction must not be
        # able to free the very blocks we are about to map
        for b in shared:
            self._incref(b)
        try:
            fresh = self._take(need - len(shared))
        except CacheOOMError:
            for b in reversed(shared):
                self._decref(b)
            raise
        blocks = shared + fresh
        self._owned[slot] = blocks
        row = np.full((self.max_blocks_per_seq,), SCRATCH_BLOCK, np.int32)
        row[:need] = blocks
        self.tables[slot] = row
        self.ctx_len[slot] = 0
        self.version += 1
        if shared:
            self.prefix_hits += 1
            self.prefix_hit_tokens += shared_tokens
        return blocks

    def prepare_write(self, slot, from_pos):
        """Copy-on-write sweep before the slot writes positions >=
        ``from_pos``: every owned block from the containing one onward
        that some OTHER owner still maps (refcount > 1) is swapped for a
        fresh private block.  Returns [(src, dst)] pairs the engine must
        device-copy (in order) BEFORE the write.  Blocks this slot owns
        alone are left in place even when the index maps them — the only
        writes routed here re-write the registered prefix's own tokens
        bit-identically (tail chunks verified token-equal by the index
        key), so sole-owner rewrites cannot corrupt a cached prefix."""
        pairs = []
        owned = self._owned[slot]
        for bi in range(int(from_pos) // self.block_tokens, len(owned)):
            blk = owned[bi]
            if self._refcount.get(blk, 1) <= 1:
                continue
            repl = self._take(1)[0]
            self._decref(blk)
            owned[bi] = repl
            self.tables[slot, bi] = repl
            pairs.append((blk, repl))
            self.cow_copies += 1
        if pairs:
            self.version += 1
        return pairs

    def ensure_capacity(self, slot, n=1):
        """Guarantee the slot's next ``n`` write positions
        (``ctx_len[slot] .. ctx_len[slot]+n-1``) have blocks; allocates
        at block boundaries.  Raises CacheOOMError (slot untouched) when
        the pool is dry — the scheduler then preempts."""
        pos_last = int(self.ctx_len[slot]) + max(int(n), 1) - 1
        bi_last = pos_last // self.block_tokens
        if bi_last >= self.max_blocks_per_seq:
            raise CacheOOMError(
                f"slot {slot} hit max_blocks_per_seq at position "
                f"{pos_last} (MXNET_SERVING_MAX_SEQ)")
        owned = self._owned[slot]
        grow = bi_last + 1 - len(owned)
        if grow <= 0:
            return
        blocks = self._take(grow)        # all-or-nothing
        for blk in blocks:
            owned.append(blk)
            self.tables[slot, len(owned) - 1] = blk
        self.version += 1

    def advance(self, slot, n=1):
        self.ctx_len[slot] += n

    def release(self, slot):
        """Drop the slot's ownership of its blocks and park it on
        scratch.  Without prefix caching every block returns to the pool
        immediately; with it, registered blocks whose refcount reaches 0
        stay cached (LRU-evictable) and blocks other slots still share
        stay live."""
        blocks = self._owned[slot]
        self._owned[slot] = []
        if not self.prefix_cache:
            if blocks:
                self.allocator.free(blocks)
        else:
            for blk in blocks:
                self._decref(blk)
        self.tables[slot] = SCRATCH_BLOCK
        self.ctx_len[slot] = 0
        self.version += 1
        return blocks
