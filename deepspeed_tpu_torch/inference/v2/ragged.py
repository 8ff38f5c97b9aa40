"""Ragged batching state: blocked KV allocator, sequence manager, batch builder.

TPU-native redesign of the reference FastGen ragged layer
(ref inference/v2/ragged/: ``BlockedAllocator`` blocked_allocator.py:11,
``BlockedKVCache`` kv_cache.py:40, ``DSSequenceDescriptor``/``DSStateManager``
ragged_manager.py:19, ``RaggedBatchWrapper`` ragged_wrapper.py:31).

Differences forced by XLA (fixed shapes, no host pointers on device):

* The device never sees Python sequence objects — each engine step receives a
  ``RaggedBatch`` of FIXED-shape int32 arrays (token ids, per-token sequence
  slot / position / KV-cache destination, block tables, sequence lengths),
  padded up to (token_budget, max_seqs, max_blocks_per_seq). One executable
  serves every prefill/decode mix — the padding discipline replaces the
  reference's variable-size CUDA launches.
* KV "pages" are rows of one flat device array per layer; the block table is
  data, not pointers, and paged attention is a gather over it.
* Block 0 is reserved as a garbage page: padded tokens scatter their KV
  there and padded table entries point at it, so no masking is needed on the
  write path.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np


class KVCacheExhausted(RuntimeError):
    """Allocation failed for want of free KV pages.

    A typed subclass so the serving layer can tell "preempt someone and
    retry" (this) apart from genuine config errors (plain RuntimeError,
    e.g. a sequence exceeding max_blocks_per_seq)."""


class BlockedAllocator:
    """Refcounted free-list page allocator (ref blocked_allocator.py:11).

    Block 0 is reserved (garbage page for padding); valid handles are
    1..num_blocks-1.  ``free()`` rejects double-frees and out-of-range
    handles — a double-freed page would be handed to two live sequences
    and silently cross-write their KV.

    Pages are **refcounted** so the serving layer's paged prefix cache
    can share read-only KV pages between sequences: ``allocate`` hands a
    page out at refcount 1, ``acquire`` adds an owner, and ``free``
    drops one owner — the page returns to the free list only when the
    LAST owner releases it.  A caller that never shares pages sees the
    pre-refcount semantics unchanged.
    """

    def __init__(self, num_blocks: int):
        if num_blocks < 2:
            raise ValueError("need at least 2 blocks (block 0 is reserved)")
        self._free: List[int] = list(range(num_blocks - 1, 0, -1))
        self._refs: Dict[int, int] = {}        # handle -> owner count
        self.num_blocks = num_blocks

    @property
    def free_blocks(self) -> int:
        return len(self._free)

    def refcount(self, block: int) -> int:
        """Current owner count (0 = on the free list)."""
        return self._refs.get(block, 0)

    def allocate(self, n: int) -> List[int]:
        if n > len(self._free):
            raise KVCacheExhausted(f"KV cache exhausted: want {n} blocks, "
                                   f"have {len(self._free)}")
        out = [self._free.pop() for _ in range(n)]
        for b in out:
            self._refs[b] = 1
        return out

    def _validate(self, blocks: Sequence[int], op: str) -> None:
        # Validate the whole batch before mutating: a partially-applied
        # free()/acquire() would leave the caller unable to retry safely.
        if len(set(blocks)) != len(blocks):
            raise ValueError(f"duplicate handles in {op}(): {list(blocks)}")
        for b in blocks:
            if b == 0:
                raise ValueError("block 0 is reserved")
            if not (0 < b < self.num_blocks):
                raise ValueError(f"block {b} out of range "
                                 f"(1..{self.num_blocks - 1})")
            if b not in self._refs:
                raise ValueError(f"block {b} is not allocated "
                                 f"({op} of a free page"
                                 f"{' — double free?' if op == 'free' else ''})")

    def acquire(self, blocks: Sequence[int]) -> None:
        """Add one owner to each live page (prefix-cache sharing: a
        sequence adopting cached pages, or the cache pinning a donor's
        pages past the donor's flush)."""
        self._validate(blocks, "acquire")
        for b in blocks:
            self._refs[b] += 1

    def free(self, blocks: Sequence[int]) -> None:
        """Drop one owner per handle; pages return to the free list at
        owner count zero."""
        self._validate(blocks, "free")
        for b in blocks:
            self._refs[b] -= 1
            if self._refs[b] == 0:
                del self._refs[b]
                self._free.append(b)


@dataclass
class SequenceDescriptor:
    """Host-side state of one in-flight sequence (ref ragged_manager.py:19)."""
    uid: int
    slot: int                       # row in the device block table
    tokens: List[int] = field(default_factory=list)   # full known token ids
    num_cached: int = 0             # tokens whose KV is already in cache
    blocks: List[int] = field(default_factory=list)

    @property
    def uncached(self) -> int:
        return len(self.tokens) - self.num_cached


class DSStateManager:
    """Tracks live sequences, their slots and KV pages (ref ragged_manager.py).

    ``max_seqs`` bounds concurrent sequences (device block-table rows);
    ``max_blocks_per_seq`` bounds context length per sequence.
    """

    def __init__(self, max_seqs: int, num_blocks: int, block_size: int,
                 max_blocks_per_seq: int):
        self.max_seqs = max_seqs
        self.block_size = block_size
        self.max_blocks_per_seq = max_blocks_per_seq
        self.allocator = BlockedAllocator(num_blocks)
        self._seqs: Dict[int, SequenceDescriptor] = {}
        self._free_slots = list(range(max_seqs - 1, -1, -1))

    def __contains__(self, uid: int) -> bool:
        return uid in self._seqs

    def get(self, uid: int) -> SequenceDescriptor:
        return self._seqs[uid]

    @property
    def n_active(self) -> int:
        return len(self._seqs)

    def open(self, uid: int, tokens: Sequence[int],
             cached_blocks: Sequence[int] = (),
             num_cached: int = 0) -> SequenceDescriptor:
        """Open a sequence, optionally seeded with **pre-owned** KV pages.

        ``cached_blocks`` are prefix-cache pages whose KV already holds
        the first ``num_cached`` tokens (the caller must have ``acquire``d
        one owner per page for this sequence — ownership transfers here,
        and ``flush`` releases it).  ``num_cached`` must be block-aligned
        and strictly smaller than ``len(tokens)`` so at least one token
        remains to prefill (the step that samples needs a real row).
        Adopted pages are never written: the first uncached token lands
        at position ``num_cached``, which block-aligns to a FRESH page.
        """
        if uid in self._seqs:
            raise ValueError(f"uid {uid} already active")
        if not self._free_slots:
            raise RuntimeError("no free sequence slots")
        if num_cached:
            if num_cached % self.block_size != 0:
                raise ValueError(
                    f"uid {uid}: num_cached {num_cached} not aligned to "
                    f"block_size {self.block_size} — a partially-filled "
                    "shared page would be appended into by this sequence")
            if num_cached >= len(tokens):
                raise ValueError(
                    f"uid {uid}: num_cached {num_cached} >= prompt length "
                    f"{len(tokens)}; at least one token must prefill")
            if len(cached_blocks) * self.block_size != num_cached:
                raise ValueError(
                    f"uid {uid}: {len(cached_blocks)} cached blocks cover "
                    f"{len(cached_blocks) * self.block_size} tokens, "
                    f"num_cached says {num_cached}")
        elif cached_blocks:
            raise ValueError(f"uid {uid}: cached_blocks without num_cached")
        seq = SequenceDescriptor(uid=uid, slot=self._free_slots.pop(),
                                 tokens=list(tokens),
                                 num_cached=int(num_cached),
                                 blocks=list(cached_blocks))
        self._seqs[uid] = seq
        return seq

    def extend(self, uid: int, token: int) -> None:
        self._seqs[uid].tokens.append(token)

    def ensure_capacity(self, seq: SequenceDescriptor, upto_tokens: int) -> None:
        """Allocate pages so the first ``upto_tokens`` tokens fit."""
        need = -(-upto_tokens // self.block_size)  # ceil
        if need > self.max_blocks_per_seq:
            raise RuntimeError(
                f"sequence {seq.uid} needs {need} blocks > "
                f"max_blocks_per_seq {self.max_blocks_per_seq}")
        if need > len(seq.blocks):
            seq.blocks.extend(self.allocator.allocate(need - len(seq.blocks)))

    def flush(self, uid: int) -> None:
        """Release a finished sequence (ref ragged_manager flush path)."""
        seq = self._seqs.pop(uid)
        if seq.blocks:
            self.allocator.free(seq.blocks)
        self._free_slots.append(seq.slot)


@dataclass
class RaggedBatch:
    """Fixed-shape device inputs for one engine step
    (ref RaggedBatchWrapper, ragged_wrapper.py:31).

    All arrays are host numpy; the engine ships them to device unchanged
    every step, so shapes never vary and XLA compiles the step once.
    """
    token_ids: np.ndarray       # [T] int32, 0-padded
    token_slot: np.ndarray      # [T] int32; max_seqs = padding slot
    token_pos: np.ndarray       # [T] int32 absolute position in sequence
    token_dest: np.ndarray      # [T] int32 flat KV-cache index (0 = garbage)
    block_tables: np.ndarray    # [max_seqs+1, max_blocks_per_seq] int32
    ctx_lens: np.ndarray        # [max_seqs+1] int32 tokens in cache AFTER step
    logits_idx: np.ndarray      # [max_seqs+1] int32 row in T of final token
    sample_mask: np.ndarray     # [max_seqs+1] bool — sample this slot?
    n_tokens: int               # real (unpadded) token count
    uids_by_slot: Dict[int, int]  # slot → uid for sampled slots


def build_ragged_batch(schedule: "List[tuple]", mgr: DSStateManager,
                       token_budget: int) -> RaggedBatch:
    """Assemble device arrays from (seq, n_new_tokens) work items.

    ``schedule`` holds (SequenceDescriptor, n_tokens) pairs; the last
    scheduled token of a sequence is sampled only if it is the sequence's
    final known token (i.e. the prompt chunk completes the prompt).
    """
    bs = mgr.block_size
    t = token_budget
    pad_slot = mgr.max_seqs
    token_ids = np.zeros((t,), np.int32)
    token_slot = np.full((t,), pad_slot, np.int32)
    token_pos = np.zeros((t,), np.int32)
    token_dest = np.zeros((t,), np.int32)
    block_tables = np.zeros((mgr.max_seqs + 1, mgr.max_blocks_per_seq), np.int32)
    ctx_lens = np.zeros((mgr.max_seqs + 1,), np.int32)
    logits_idx = np.zeros((mgr.max_seqs + 1,), np.int32)
    sample_mask = np.zeros((mgr.max_seqs + 1,), bool)
    uids_by_slot: Dict[int, int] = {}

    total = sum(n_new for _, n_new in schedule)
    if total > t:
        raise RuntimeError(f"schedule ({total} tokens) exceeds budget {t}")

    # Reserve all pages up front so an allocator failure leaves every
    # sequence untouched (no num_cached advance without a KV write).
    for seq, n_new in schedule:
        mgr.ensure_capacity(seq, seq.num_cached + n_new)

    cursor = 0
    for seq, n_new in schedule:
        start = seq.num_cached
        end = start + n_new
        sl = seq.slot
        rows = np.arange(start, end, dtype=np.int32)
        pos_block = rows // bs
        dest = np.asarray(seq.blocks, np.int32)[pos_block] * bs + rows % bs
        token_ids[cursor:cursor + n_new] = seq.tokens[start:end]
        token_slot[cursor:cursor + n_new] = sl
        token_pos[cursor:cursor + n_new] = rows
        token_dest[cursor:cursor + n_new] = dest
        block_tables[sl, :len(seq.blocks)] = seq.blocks
        ctx_lens[sl] = end
        logits_idx[sl] = cursor + n_new - 1
        sample_mask[sl] = (end == len(seq.tokens))
        if sample_mask[sl]:
            uids_by_slot[sl] = seq.uid
        cursor += n_new
        seq.num_cached = end

    return RaggedBatch(token_ids=token_ids, token_slot=token_slot,
                       token_pos=token_pos, token_dest=token_dest,
                       block_tables=block_tables, ctx_lens=ctx_lens,
                       logits_idx=logits_idx, sample_mask=sample_mask,
                       n_tokens=cursor, uids_by_slot=uids_by_slot)
