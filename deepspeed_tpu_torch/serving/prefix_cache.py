"""Paged prefix cache: content-addressed KV pages shared across requests.

System-prompt-heavy traffic — the dominant production shape — re-prefills
the same leading tokens on every request.  This cache keys **token-block-
aligned prompt prefixes** to the KV pages a previous request already
wrote, so a matching prefix is *adopted* (block-table entries point at
the shared pages, prefill starts after them) instead of recomputed.

Correctness rests on three facts:

* **KV is content-addressed.**  A page holds the K/V of tokens
  ``[j·bs, (j+1)·bs)`` computed from the tokens before them; a prefix
  always starts at position 0, so identical token blocks along an
  identical chain produce identical KV (positions included).  Entries
  are therefore keyed by the *chain* of block token-tuples, not by a
  single block's tokens.
* **Shared pages are never written.**  Adoption is block-aligned and
  strictly shorter than the prompt (``DSStateManager.open`` enforces
  both), so the adopting sequence's first KV write lands in a fresh
  page.
* **Refcounts guard frees.**  Every owner — each live sequence sharing
  a page, plus the cache itself — holds one ``BlockedAllocator`` ref;
  a page returns to the free list only at refcount zero, so neither a
  donor's flush, a victim's preemption, nor a cache eviction can free
  a page another live sequence still reads.

Eviction is LRU over **leaf** entries whose page the cache is the sole
owner of (refcount 1 — no live sequence shares it); freeing a leaf may
expose its parent.  Interior entries stay until their subtree drains,
which keeps every cached chain walkable.  The serve loop drives
eviction from the existing ``kv_high_watermark`` admission floor: when
admission (or an engine step) wants pages the free list cannot cover,
cache pages are reclaimed before any live request is preempted.

Zero dependencies (no jax, no numpy): handles and token ids are plain
Python ints, same as the rest of ``serving/``.
"""

from __future__ import annotations

import itertools
import time
from typing import Dict, List, Optional, Sequence, Tuple


class PrefixCacheConfig:
    def __init__(self, d: Optional[dict] = None, **kw):
        d = {**(d or {}), **kw}
        self.enabled = bool(d.get("enabled", False))
        # hard cap on pages the cache may hold (0 = bounded only by the
        # watermark-driven eviction); a cap keeps one giant system prompt
        # from squatting the whole pool on an idle server
        self.max_blocks = int(d.get("max_blocks", 0))
        if self.max_blocks < 0:
            raise ValueError(f"prefix_cache.max_blocks={self.max_blocks}: "
                             "must be >= 0 (0 = unbounded)")
        # prefixes shorter than this many blocks are not worth caching
        # (adoption saves < min_prefix_blocks·block_size prefill tokens)
        self.min_prefix_blocks = int(d.get("min_prefix_blocks", 1))
        if self.min_prefix_blocks < 1:
            raise ValueError(
                f"prefix_cache.min_prefix_blocks={self.min_prefix_blocks}: "
                "must be >= 1")


class _Entry:
    """One cached page: a node in the chain trie."""

    __slots__ = ("block", "parent", "children", "last_used")

    def __init__(self, block: int, parent: Optional["_Entry"]):
        self.block = block
        self.parent = parent
        # block token-tuple -> child entry (the NEXT block of the chain)
        self.children: Dict[Tuple[int, ...], "_Entry"] = {}
        self.last_used = 0


class PrefixCache:
    """Chain-keyed trie of shared KV pages over one engine's allocator.

    Single-threaded by design: every method runs on the serve loop (the
    only thread that touches the engine and its allocator), so no lock
    is needed — same threading contract as ``DSStateManager``.
    """

    def __init__(self, cfg: PrefixCacheConfig, allocator, block_size: int):
        self.cfg = cfg
        self.allocator = allocator
        self.block_size = int(block_size)
        self._root: Dict[Tuple[int, ...], _Entry] = {}
        self._entries: List[_Entry] = []       # flat view for eviction
        # logical LRU clock — deterministic, monotonic, no wall time
        self._clock = itertools.count(1)
        # (monotonic_ts, value) memo for evictable_count: dispatch
        # scoring calls it per replica per routed request, and a full
        # trie walk per call would grow with cache occupancy exactly
        # when the system is busiest
        self._evictable_memo = (-1.0, 0)

    # -- introspection ---------------------------------------------------
    @property
    def cached_blocks(self) -> int:
        return len(self._entries)

    def evictable_count(self, max_age_s: float = 0.05) -> int:
        """Pages eviction could free on demand: every entry whose whole
        subtree the cache solely owns (refcount 1 throughout — no live
        sequence shares any page below it).  ``evict()`` reaches them
        leaf-first across repeated passes, so for dispatch scoring
        (``AdmissionController.evictable_headroom``) they are
        headroom-in-waiting, not occupancy.  A shared page pins its
        ancestors (interior entries stay until their subtree drains)
        but not its fully-cache-owned siblings.  Safe from a non-serve
        thread — it only reads snapshots of the trie and the
        allocator's refcounts.  Results are memoized for ``max_age_s``
        (dispatch scores tolerate a loop-tick of staleness; pass 0 to
        force a fresh walk)."""
        now = time.monotonic()
        ts, value = self._evictable_memo
        if max_age_s > 0 and ts >= 0 and now - ts < max_age_s:
            return value

        def walk(entry: _Entry):
            n = 0
            fully = self.allocator.refcount(entry.block) == 1
            for child in list(entry.children.values()):
                c_n, c_fully = walk(child)
                n += c_n
                fully = fully and c_fully
            return (n + 1, True) if fully else (n, False)

        value = sum(walk(e)[0] for e in list(self._root.values()))
        self._evictable_memo = (now, value)
        return value

    def _chain(self, tokens: Sequence[int], limit_blocks: int):
        """Yield (block_tokens_tuple, entry-or-None) down the trie."""
        bs = self.block_size
        node = self._root
        for j in range(limit_blocks):
            key = tuple(tokens[j * bs:(j + 1) * bs])
            entry = node.get(key)
            yield key, entry
            if entry is None:
                return
            node = entry.children

    # -- serve-loop API --------------------------------------------------
    def adopt(self, tokens: Sequence[int]) -> Tuple[List[int], int]:
        """Acquire the longest cached chain for ``tokens``.

        Returns ``(blocks, n_cached_tokens)``; the caller owns one ref
        per returned page (hand them to ``DSStateManager.open``, or
        ``release`` them if admission is abandoned).  Acquiring FIRST is
        what makes the subsequent admission-pressure eviction safe: an
        adopted page is refcount >= 2 and cannot be reclaimed out from
        under the pending request.  Adoption is capped at
        ``(len(tokens) - 1) // block_size`` full blocks so at least one
        token remains to prefill (the sampling step needs a real row).
        """
        limit = (len(tokens) - 1) // self.block_size
        entries: List[_Entry] = []
        for _key, entry in self._chain(tokens, limit):
            if entry is None:
                break
            entries.append(entry)
        if not entries:
            return [], 0
        now = next(self._clock)
        for e in entries:
            e.last_used = now
        blocks = [e.block for e in entries]
        self.allocator.acquire(blocks)
        return blocks, len(blocks) * self.block_size

    def release(self, blocks: Sequence[int]) -> None:
        """Return adoption refs for a request that was NOT admitted."""
        if blocks:
            self.allocator.free(blocks)

    def insert(self, tokens: Sequence[int], blocks: Sequence[int]) -> int:
        """Register a freshly-prefilled sequence's full prefix blocks.

        ``tokens`` is the prefilled prefix (everything in the sequence at
        admission time); ``blocks`` the sequence's page list.  Only the
        leading ``len(tokens) // block_size`` FULL pages are cacheable —
        a partial last block will be appended into by decode and can
        never be shared.  The cache acquires one ref per newly-inserted
        page (so it outlives the donor); chains that already exist keep
        their existing pages (first writer wins — both hold identical
        KV, and swapping would orphan refs mid-chain).  Returns the
        number of pages newly inserted.
        """
        bs = self.block_size
        n_full = min(len(tokens) // bs, len(blocks))
        if n_full < self.cfg.min_prefix_blocks:
            return 0
        inserted = 0
        now = next(self._clock)
        node = self._root
        parent: Optional[_Entry] = None
        for j in range(n_full):
            key = tuple(tokens[j * bs:(j + 1) * bs])
            entry = node.get(key)
            if entry is None:
                if (self.cfg.max_blocks
                        and len(self._entries) >= self.cfg.max_blocks
                        and self.evict(1) == 0):
                    break  # cap hit and nothing reclaimable: stop here
                entry = _Entry(blocks[j], parent)
                self.allocator.acquire([blocks[j]])
                node[key] = entry
                self._entries.append(entry)
                inserted += 1
            entry.last_used = now
            parent = entry
            node = entry.children
        return inserted

    def evict(self, need_blocks: int) -> int:
        """Free at least ``need_blocks`` pages if possible; returns the
        number actually freed.  Victims are LRU over leaf entries whose
        page has no live-sequence owner (refcount 1: the cache alone);
        freeing a leaf may expose its parent, so the scan repeats until
        satisfied or dry."""
        freed = 0
        while freed < need_blocks:
            victim: Optional[_Entry] = None
            for e in self._entries:
                if e.children or self.allocator.refcount(e.block) != 1:
                    continue
                if victim is None or e.last_used < victim.last_used:
                    victim = e
            if victim is None:
                break
            self._remove(victim)
            freed += 1
        return freed

    def clear(self) -> int:
        """Drop every entry the cache solely owns (server shutdown)."""
        return self.evict(len(self._entries))

    def _remove(self, entry: _Entry) -> None:
        parent_map = (entry.parent.children if entry.parent is not None
                      else self._root)
        for key, e in list(parent_map.items()):
            if e is entry:
                del parent_map[key]
                break
        self._entries.remove(entry)
        self.allocator.free([entry.block])
