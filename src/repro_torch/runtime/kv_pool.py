"""Paged KV cache pool: refcounted host-side block accounting for serving.

The device-side layout is a shared pool of ``num_blocks`` fixed-size KV
blocks per layer (:func:`repro_torch.models.init_paged_cache`); this module owns
the *accounting*: which physical blocks are free, which belong to which
request, how many owners a block has, and whether admission head-room
exists.  It is pure host Python — no jax — so its invariants (no leaks, no
double allocation, refcounts never negative, deterministic order) are
testable under heavy churn without touching a device.

Design points (the vLLM block-manager shape, reduced to essentials):

* **fixed-size blocks** — every block covers ``page_size`` consecutive
  logical token positions of one sequence; a request holding ``n`` tokens
  owns ``ceil(n / page_size)`` blocks, listed in logical order in its
  *block table*.
* **refcounted sharing** — a physical block may appear in several block
  tables at once (prefix sharing) and additionally be pinned by the prefix
  index below.  ``alloc`` hands out blocks at refcount 1; ``incref`` adds
  owners; ``free`` decrements and only a block reaching refcount 0 returns
  to the free list.  A block with refcount > 1 is *shared*: writers must
  copy-on-write (the scheduler plans the copy, the engine executes it
  device-side) before mutating it.
* **prefix index** — a trie over chain-hashes of ``page_size``-aligned
  token blocks (``h_i = hash((h_{i-1}, tokens_i))``) maps full prompt
  blocks to the physical block already holding their KV.  A new request
  whose prompt shares a prefix with a live or recently-retired sequence
  maps those blocks instead of re-prefilling them; the index holds one
  refcount per cached block, so retirement leaves registered blocks
  resident ("recently retired") until the allocator reclaims them LRU
  when the free list runs dry.
* **free-list allocation** — allocation pops from a free stack
  (deterministic: a fresh pool hands out blocks 1, 2, 3, …; freed blocks
  are reused most-recently-freed first).  ``alloc`` is all-or-nothing and
  reclaims idle cached prefix blocks before refusing.
* **copy-free retirement** — finishing (or preempting) a request decrefs
  its blocks; nothing on the device moves.  Stale KV in a reused block is
  overwritten position-by-position by its next owner and is causally
  masked until then.
* **reserved garbage block 0** — never allocated, never refcounted; dead
  decode-batch rows point their whole block table at it so the batched
  decode step has a harmless write target.
"""
from __future__ import annotations

import collections
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from ..obs import recorder as obs
from ..obs.events import PrefixHit

GARBAGE_BLOCK = 0

#: chain-hash seed for "no blocks yet" (position 0 of every sequence).
PREFIX_ROOT = 0


@dataclass
class PoolStats:
    allocs: int = 0                  # successful alloc() calls
    frees: int = 0                   # free() calls
    blocks_allocated: int = 0        # cumulative blocks handed out
    blocks_freed: int = 0            # cumulative blocks returned (refs -> 0)
    alloc_failures: int = 0          # all-or-nothing refusals
    peak_live: int = 0               # high-water mark of live blocks
    prefix_hits: int = 0             # blocks mapped from the prefix index
    prefix_tokens_saved: int = 0     # token positions served from the index
    prefix_misses: int = 0           # match_prefix calls that mapped nothing
    cow_copies: int = 0              # shared blocks duplicated before a write
    cache_evictions: int = 0         # idle cached blocks reclaimed by alloc


@dataclass
class _PrefixEntry:
    """One cached full block: its physical id, exact token content (for
    partial-tail matching), and its parent chain hash (for child cleanup)."""

    block: int
    tokens: Tuple[int, ...]
    prev: int


@dataclass
class PagedKVPool:
    """Refcounted free-list allocator over ``num_blocks`` physical blocks.

    ``num_blocks`` counts physical blocks *including* the reserved garbage
    block 0, matching the leading pool axis of the device cache leaves.
    """

    num_blocks: int
    page_size: int
    stats: PoolStats = field(default_factory=PoolStats)

    def __post_init__(self) -> None:
        if self.num_blocks < 2:
            raise ValueError("pool needs >= 2 blocks (block 0 is reserved)")
        if self.page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {self.page_size}")
        # stack: pop() yields 1, 2, 3, ... on a fresh pool
        self._free: List[int] = list(range(self.num_blocks - 1, 0, -1))
        self._refs: Dict[int, int] = {}
        # prefix index: chain hash -> entry, LRU-ordered (oldest first);
        # _children[prev_hash] lists child hashes for partial-tail matching
        self._index: "collections.OrderedDict[int, _PrefixEntry]" = \
            collections.OrderedDict()
        self._children: Dict[int, List[int]] = {}

    # -- sizing ---------------------------------------------------------------
    @property
    def capacity(self) -> int:
        """Allocatable blocks (excludes the garbage block)."""
        return self.num_blocks - 1

    @property
    def num_free(self) -> int:
        return len(self._free)

    @property
    def num_live(self) -> int:
        return len(self._refs)

    @property
    def _live(self) -> set:
        """Live block set (compat view over the refcount table)."""
        return set(self._refs)

    @property
    def num_reclaimable(self) -> int:
        """Cached prefix blocks held only by the index (refcount 1): the
        allocator can reclaim these, so admission head-room counts them as
        free-in-waiting."""
        return sum(1 for e in self._index.values()
                   if self._refs.get(e.block, 0) == 1)

    def blocks_for(self, tokens: int) -> int:
        """Blocks needed to hold ``tokens`` logical positions."""
        return -(-max(int(tokens), 0) // self.page_size)

    def ref(self, block: int) -> int:
        return self._refs.get(block, 0)

    def is_shared(self, block: int) -> bool:
        """More than one owner (block tables + prefix index): a write must
        copy-on-write first."""
        return self._refs.get(block, 0) > 1

    # -- alloc / free ---------------------------------------------------------
    def alloc(self, n: int) -> Optional[List[int]]:
        """Pop ``n`` blocks at refcount 1, or ``None`` (and nothing changes)
        if the pool cannot satisfy the whole request — callers never hold a
        partial grant they would have to unwind.  Reclaims idle cached
        prefix blocks (LRU) before refusing."""
        if n < 0:
            raise ValueError(f"alloc({n})")
        if n > len(self._free) + self.num_reclaimable:
            self.stats.alloc_failures += 1
            return None
        while len(self._free) < n:
            self._evict_one_cached()
        got = [self._free.pop() for _ in range(n)]
        for b in got:
            self._refs[b] = 1
        self.stats.allocs += 1
        self.stats.blocks_allocated += n
        self.stats.peak_live = max(self.stats.peak_live, len(self._refs))
        return got

    def incref(self, blocks: Iterable[int]) -> None:
        """Add an owner to already-live blocks (prefix mapping, index pin)."""
        for b in blocks:
            if b not in self._refs:
                raise ValueError(f"incref of non-live block {b}")
            self._refs[b] += 1

    def free(self, blocks: List[int]) -> None:
        """Drop one owner per block; blocks reaching refcount 0 return to
        the free list.  Decrefs below zero (double-frees) and frees of the
        garbage block are accounting bugs and raise immediately."""
        for b in blocks:
            r = self._refs.get(b)
            if r is None:
                raise ValueError(f"free of non-live block {b}")
            if r > 1:
                self._refs[b] = r - 1
            else:
                del self._refs[b]
                self._free.append(b)
                self.stats.blocks_freed += 1
        self.stats.frees += 1

    # -- prefix index ---------------------------------------------------------
    @staticmethod
    def chain_hash(prev: int, tokens: Tuple[int, ...]) -> int:
        """Deterministic-in-process chain hash of one full token block
        (int tuples hash value-stably; no str/bytes randomization)."""
        return hash((prev, tokens))

    def register_prefix(self, prev_hash: int, tokens: Sequence[int],
                        block: int) -> int:
        """Index one *full* block of prompt content under its chain hash.

        The index takes a refcount on the block (it stays resident after
        its owner retires) unless the hash is already mapped — first
        registration wins, so identical content always resolves to one
        physical block.  Returns the chain hash (feed it to the next
        ``register_prefix`` call as ``prev_hash``)."""
        toks = tuple(int(t) for t in tokens)
        if len(toks) != self.page_size:
            raise ValueError(
                f"register_prefix needs a full block of {self.page_size} "
                f"tokens, got {len(toks)}")
        h = self.chain_hash(prev_hash, toks)
        if h in self._index:
            self._index.move_to_end(h)
            return h
        if block not in self._refs:
            raise ValueError(f"register_prefix of non-live block {block}")
        self._refs[block] += 1            # the index's own pin
        self._index[h] = _PrefixEntry(block=block, tokens=toks,
                                      prev=prev_hash)
        self._children.setdefault(prev_hash, []).append(h)
        return h

    def match_prefix(self, tokens: Sequence[int], *, commit: bool = True
                     ) -> Tuple[List[int], int, int]:
        """Longest indexed prefix of ``tokens``: full chain-hash blocks,
        then a partial overlap into one child block (CoW territory — the
        mapper's first write into it duplicates the block).

        Returns ``(blocks, matched, chain_hash)``: the physical blocks to
        map (in logical order), how many leading tokens they serve, and the
        chain hash covering the *full* matched blocks (so the caller
        continues registering from there).  ``matched`` is capped at
        ``len(tokens) - 1`` — at least one token always prefills, because
        its logits must seed decode.  ``commit=False`` probes without
        increfing or touching LRU order (admission head-room checks)."""
        toks = [int(t) for t in tokens]
        ps, n = self.page_size, len(toks)
        hashes = [PREFIX_ROOT]
        blocks: List[int] = []
        i = 0
        while (i + 1) * ps <= n:
            h = self.chain_hash(hashes[-1], tuple(toks[i * ps:(i + 1) * ps]))
            ent = self._index.get(h)
            if ent is None:
                break
            blocks.append(ent.block)
            hashes.append(h)
            i += 1
        matched = i * ps
        # partial tail: best token-overlap among the children of the chain
        # head (deterministic: max overlap, first-registered wins ties)
        rem = toks[matched:]
        best_overlap, best_block = 0, None
        if rem:
            for ch in self._children.get(hashes[-1], ()):
                ent = self._index.get(ch)
                if ent is None:
                    continue
                k = 0
                for a, b in zip(ent.tokens, rem):
                    if a != b:
                        break
                    k += 1
                if k > best_overlap:
                    best_overlap, best_block = k, ent.block
        if best_block is not None:
            blocks.append(best_block)
            matched += best_overlap
        if matched >= n:                 # leave >= 1 token to prefill
            matched = n - 1
            blocks = blocks[:self.blocks_for(matched)]
            hashes = hashes[:matched // ps + 1]
        if not blocks:
            if commit:
                self.stats.prefix_misses += 1
            return [], 0, PREFIX_ROOT
        if commit:
            self.incref(blocks)
            for h in hashes[1:]:
                self._index.move_to_end(h)
            self.stats.prefix_hits += len(blocks)
            self.stats.prefix_tokens_saved += matched
            if obs._recorder is not None:     # pool has no tick: use cursor
                obs._recorder.emit(PrefixHit(tick=obs._recorder.tick,
                                             blocks=len(blocks),
                                             tokens=int(matched)))
        return blocks, matched, hashes[min(len(hashes) - 1, matched // ps)]

    def release_prefix_cache(self) -> int:
        """Drop every index entry (decref its pin); blocks still mapped by
        live sequences survive, idle ones return to the free list.  Returns
        the number of entries dropped (tests and benchmarks use this to
        compare against a cold cache)."""
        dropped = 0
        for h in list(self._index):
            self._drop_entry(h)
            dropped += 1
        return dropped

    def _drop_entry(self, h: int) -> None:
        ent = self._index.pop(h)
        kids = self._children.get(ent.prev)
        if kids is not None:
            kids.remove(h)
            if not kids:
                del self._children[ent.prev]
        self.free([ent.block])           # drop the index's pin

    def _evict_one_cached(self) -> None:
        """Reclaim the LRU-oldest cached block nobody maps (refcount 1 =
        index pin only).  Callers guarantee one exists."""
        for h, ent in self._index.items():
            if self._refs.get(ent.block, 0) == 1:
                self._drop_entry(h)
                self.stats.cache_evictions += 1
                return
        raise AssertionError("evict called with no reclaimable cached block")

    # -- invariants -----------------------------------------------------------
    def check_invariants(self, block_tables: Optional[
            Iterable[Sequence[int]]] = None) -> None:
        """Raise if accounting broke: every block is exactly free or live
        (refcount >= 1), block 0 is neither, nothing was minted or lost,
        every indexed block is alive, and — when the caller passes the
        sequences' ``block_tables`` — every table entry is live, disjoint
        from the free list, and its refcount covers its mappers."""
        free = set(self._free)
        if len(free) != len(self._free):
            raise AssertionError("duplicate entries in the free list")
        if free & set(self._refs):
            raise AssertionError("block both free and live")
        if GARBAGE_BLOCK in free or GARBAGE_BLOCK in self._refs:
            raise AssertionError("garbage block 0 entered circulation")
        if any(r < 1 for r in self._refs.values()):
            raise AssertionError("non-positive refcount on a live block")
        if len(free) + len(self._refs) != self.capacity:
            raise AssertionError(
                f"leak: {len(free)} free + {len(self._refs)} live != "
                f"{self.capacity} capacity")
        owners: Dict[int, int] = {}
        for ent in self._index.values():
            if ent.block not in self._refs:
                raise AssertionError(
                    f"indexed block {ent.block} is not live")
            owners[ent.block] = owners.get(ent.block, 0) + 1
        if block_tables is not None:
            for table in block_tables:
                for b in table:
                    if b in free:
                        raise AssertionError(
                            f"block {b} is in a block table AND the free "
                            f"list")
                    if b not in self._refs:
                        raise AssertionError(
                            f"block-table block {b} is not live")
                    owners[b] = owners.get(b, 0) + 1
            for b, n in owners.items():
                if self._refs[b] < n:
                    raise AssertionError(
                        f"block {b}: {n} owners but refcount "
                        f"{self._refs[b]}")
