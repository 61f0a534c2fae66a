"""Block-paged KV-cache pool with free-list allocation and prefix caching.

Ports ``repro/serving/kv_cache.py``: one pool of fixed-size blocks on the
device is shared by all in-flight requests, each of which owns a *block
table* (a list of physical block ids). Logical position ``p`` of a request
lives at ``(table[p // block_size], p % block_size)``.

Block 0 is the reserved *null block*: padded batch rows and padded prompt
positions scatter their (discarded) K/V writes there. The null block never
appears in a live block table.

Prefix caching: every block carries a reference count, and *full* prompt
blocks are registered in a content-hash index keyed by the chained digest
of the tokens they hold (a match on block ``i`` implies blocks ``0..i-1``
matched too). Admission matches the longest cached block-aligned prefix and
shares those blocks instead of recomputing them. ``free()`` is a decref:
blocks whose count reaches zero return to the free list, except registered
blocks, which park in an LRU of evictable cached blocks -- still matchable,
reclaimed oldest first when the free list runs dry. A writer must
``ensure_writable`` a shared block first, which copies it (copy-on-write).

Bookkeeping is host-side Python; only the pool tensors live on the device.
The model updates the pools in place, so the cache keeps one set of pool
tensors for its whole life; the copy-on-write block copy is an in-place
torch index copy.
"""
from __future__ import annotations

import dataclasses
import hashlib
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.config import ModelConfig
from repro_torch.models import lm

NULL_BLOCK = 0

_DIGEST_SEED = b"twell-prefix-cache-v1"


@dataclasses.dataclass(frozen=True)
class AllocationPlan:
    """A validated, not-yet-applied block-table allocation
    (``plan_allocation`` -> ``commit_allocation``)."""

    rid: int
    n_blocks: int
    matched: Tuple[int, ...]        # cached prefix blocks to share (incref)


class PagedKVCache:
    """Device KV pool + host free-list allocator + per-request block tables
    + content-hash prefix cache."""

    def __init__(self, cfg: ModelConfig, num_blocks: int, block_size: int,
                 device=None):
        if num_blocks < 2:
            raise ValueError("need >= 2 blocks (block 0 is the null block)")
        if block_size < 1:
            raise ValueError(f"block_size must be >= 1, got {block_size}")
        self.cfg = cfg
        self.num_blocks = num_blocks
        self.block_size = block_size
        self.pools = lm.init_paged_cache(cfg, num_blocks, block_size,
                                         device=device)
        # LIFO free list: recently-freed blocks are reused first (locality)
        self._free: List[int] = list(range(num_blocks - 1, 0, -1))
        self._tables: Dict[int, List[int]] = {}
        self._ref: List[int] = [0] * num_blocks
        self._hash_to_block: Dict[bytes, int] = {}
        self._block_digest: Dict[int, bytes] = {}
        self._lru: "OrderedDict[int, None]" = OrderedDict()
        self.cow_count = 0               # copy-on-write events (tests/stats)
        self.evict_count = 0             # cached blocks reclaimed under pressure

    # ---- capacity ----------------------------------------------------------

    @property
    def num_free(self) -> int:
        """Blocks on the free list proper (excludes evictable cached ones)."""
        return len(self._free)

    @property
    def num_evictable(self) -> int:
        """Cached (registered, refcount-zero) blocks reclaimable on demand."""
        return len(self._lru)

    @property
    def num_available(self) -> int:
        """Blocks a new allocation could claim: free + evictable cached."""
        return len(self._free) + len(self._lru)

    def blocks_for(self, num_tokens: int) -> int:
        """Blocks needed to hold ``num_tokens`` cache slots."""
        return -(-num_tokens // self.block_size)

    def can_allocate(self, n_blocks: int) -> bool:
        return n_blocks <= self.num_available

    def ref_count(self, block: int) -> int:
        return self._ref[block]

    # ---- prefix hashing ----------------------------------------------------

    def block_digests(self, tokens: Sequence[int]) -> List[bytes]:
        """Chained content digest per *full* block of ``tokens``; digest
        ``i`` covers tokens ``[0, (i+1) * block_size)``."""
        out: List[bytes] = []
        d = _DIGEST_SEED
        bs = self.block_size
        for i in range(len(tokens) // bs):
            chunk = np.asarray(tokens[i * bs:(i + 1) * bs], np.int32)
            d = hashlib.sha256(d + chunk.tobytes()).digest()
            out.append(d)
        return out

    def match_prefix(self, tokens: Sequence[int]) -> List[int]:
        """Block ids of the longest cached block-aligned prefix of ``tokens``
        (read-only: no refcount or LRU mutation)."""
        blocks: List[int] = []
        for d in self.block_digests(tokens):
            blk = self._hash_to_block.get(d)
            if blk is None:
                break
            blocks.append(blk)
        return blocks

    def _available_excluding(self, matched: Sequence[int]) -> int:
        """Blocks claimable for NEW allocation given that ``matched`` blocks
        will be revived out of the LRU (not evicted) rather than consumed."""
        return len(self._free) + len(self._lru) \
            - sum(1 for b in matched if b in self._lru)

    def plan_admission(self, tokens: Sequence[int]) -> Tuple[List[int], int]:
        """(matched cached blocks, blocks available for *new* allocation)."""
        matched = self.match_prefix(tokens)
        return matched, self._available_excluding(matched)

    # ---- allocation --------------------------------------------------------

    def _take_block(self) -> int:
        """Claim one block: free list first, then evict the LRU cached block
        (dropping its hash-index entry -- it is no longer matchable)."""
        if self._free:
            return self._free.pop()
        if self._lru:
            blk, _ = self._lru.popitem(last=False)        # oldest first
            digest = self._block_digest.pop(blk)
            del self._hash_to_block[digest]
            self.evict_count += 1
            return blk
        raise MemoryError("KV pool exhausted (free list and prefix cache "
                          "both empty)")

    def allocate(self, rid: int, n_blocks: int) -> List[int]:
        """Claim ``n_blocks`` fresh for request ``rid``; raises on exhaustion."""
        if rid in self._tables:
            raise ValueError(f"request {rid} already has a block table")
        if not self.can_allocate(n_blocks):
            raise MemoryError(
                f"KV pool exhausted: want {n_blocks}, "
                f"available {self.num_available}")
        blocks = [self._take_block() for _ in range(n_blocks)]
        for blk in blocks:
            self._ref[blk] = 1
        self._tables[rid] = blocks
        return list(blocks)

    def allocate_prefix(self, rid: int, tokens: Sequence[int],
                        n_blocks: int,
                        matched: Optional[List[int]] = None) -> int:
        """Build ``rid``'s table from the longest cached prefix plus fresh
        blocks, ``n_blocks`` total. Returns the number of cached tokens."""
        return self.commit_allocation(
            self.plan_allocation(rid, tokens, n_blocks, matched=matched))

    def plan_allocation(self, rid: int, tokens: Sequence[int],
                        n_blocks: int,
                        matched: Optional[List[int]] = None) \
            -> AllocationPlan:
        """Validate and describe, without mutating anything, the allocation
        ``commit_allocation`` will apply."""
        if rid in self._tables:
            raise ValueError(f"request {rid} already has a block table")
        if matched is None:
            matched = self.match_prefix(tokens)
        avail = self._available_excluding(matched)
        need = n_blocks - len(matched)
        if need < 0:
            raise ValueError(
                f"n_blocks {n_blocks} < matched prefix {len(matched)}")
        if need > avail:
            raise MemoryError(
                f"KV pool exhausted: want {need} new, available {avail}")
        return AllocationPlan(rid=rid, n_blocks=n_blocks,
                              matched=tuple(matched))

    def commit_allocation(self, plan: AllocationPlan) -> int:
        """Apply a fresh ``plan_allocation`` result: share the matched
        blocks (incref; revive from the LRU if evictable) and claim the rest
        fresh. Returns the cached-token count (matched x block_size)."""
        if plan.rid in self._tables:
            raise ValueError(
                f"request {plan.rid} already has a block table")
        table: List[int] = []
        for blk in plan.matched:
            if self._ref[blk] == 0:
                self._lru.pop(blk)                       # revive from LRU
            self._ref[blk] += 1
            table.append(blk)
        for _ in range(plan.n_blocks - len(plan.matched)):
            blk = self._take_block()
            self._ref[blk] = 1
            table.append(blk)
        self._tables[plan.rid] = table
        return len(plan.matched) * self.block_size

    def register_prefix(self, rid: int, tokens: Sequence[int]) -> int:
        """Index ``rid``'s full prompt blocks in the prefix cache (first
        writer wins). Returns the number of newly registered blocks."""
        table = self._tables[rid]
        added = 0
        for i, d in enumerate(self.block_digests(tokens)):
            blk = table[i]
            if d in self._hash_to_block or blk in self._block_digest:
                continue
            self._hash_to_block[d] = blk
            self._block_digest[blk] = d
            added += 1
        return added

    def append_block(self, rid: int) -> int:
        """Grow a request's table by one block (decode crossing a boundary)."""
        blk = self._take_block()
        self._ref[blk] = 1
        self._tables[rid].append(blk)
        return blk

    def _block_copy(self, src: int, dst: int) -> None:
        """Copy one block (all layers, both pools) in place on the device."""
        for pool in self.pools.values():
            pool[:, dst].copy_(pool[:, src])

    def ensure_writable(self, rid: int, block_idx: int) -> Optional[int]:
        """Copy-on-write guard: before writing into table slot ``block_idx``,
        a block shared with another live request (refcount > 1) is replaced
        by a private copy. Returns the new block id when a copy happened,
        else None (sole owner: in-place write is safe)."""
        tbl = self._tables[rid]
        blk = tbl[block_idx]
        if self._ref[blk] <= 1:
            return None
        new = self._take_block()
        self._ref[new] = 1
        self._block_copy(blk, new)
        self._ref[blk] -= 1
        tbl[block_idx] = new
        self.cow_count += 1
        return new

    def _decref(self, blk: int) -> None:
        self._ref[blk] -= 1
        assert self._ref[blk] >= 0, f"negative refcount on block {blk}"
        if self._ref[blk] == 0:
            if blk in self._block_digest:
                self._lru[blk] = None                    # evictable, matchable
                self._lru.move_to_end(blk)
            else:
                self._free.append(blk)

    def free(self, rid: int) -> Tuple[int, int]:
        """Release a request's references (also the preemption primitive).
        Returns ``(parked, freed)``: blocks parked in the evictable LRU vs
        returned to the free list."""
        parked = freed = 0
        for blk in self._tables.pop(rid):
            self._decref(blk)
            if blk in self._lru:
                parked += 1
            elif self._ref[blk] == 0:
                freed += 1
        return parked, freed

    def __contains__(self, rid: int) -> bool:
        """Whether ``rid`` currently owns a block table."""
        return rid in self._tables

    def truncate(self, rid: int, keep_blocks: int) -> int:
        """Shrink a request's table to its first ``keep_blocks`` blocks,
        releasing the tail (speculative rollback: rejected draft tokens leave
        no block-accounting trace). Tail blocks are private scratch past the
        prompt, so a decref sends them straight back to the free list; their
        contents are never read again. Returns the number released."""
        if keep_blocks < 1:
            raise ValueError(f"keep_blocks must be >= 1, got {keep_blocks}")
        tbl = self._tables[rid]
        freed = 0
        while len(tbl) > keep_blocks:
            self._decref(tbl.pop())
            freed += 1
        return freed

    # ---- views -------------------------------------------------------------

    def block_table(self, rid: int) -> List[int]:
        return list(self._tables[rid])

    def table_array(self, rids: Sequence[int], batch: int,
                    width: int) -> np.ndarray:
        """(batch, width) int32 block-table array, padded with the null block
        both across unused table slots and across padded batch rows."""
        out = np.full((batch, width), NULL_BLOCK, np.int32)
        for i, rid in enumerate(rids):
            tbl = self._tables[rid]
            if len(tbl) > width:
                raise ValueError(
                    f"request {rid} table ({len(tbl)}) exceeds width {width}")
            out[i, :len(tbl)] = tbl
        return out

    def check_invariants(self) -> None:
        """Debug/test hook: the refcount partition of the pool.

        Every block in [1, num_blocks) is exactly one of {free, evictable
        cached (LRU), live (referenced by >= 1 table)}; refcounts equal the
        number of table references; the hash index is a bijection onto
        registered blocks, none of which sit on the free list."""
        owned: Dict[int, int] = {}
        for tbl in self._tables.values():
            for b in tbl:
                owned[b] = owned.get(b, 0) + 1
        assert NULL_BLOCK not in owned, "null block leaked into a table"
        assert NULL_BLOCK not in self._free, "null block leaked into free list"
        assert NULL_BLOCK not in self._lru, "null block leaked into the LRU"
        free_set, lru_set = set(self._free), set(self._lru)
        assert len(free_set) == len(self._free), "duplicate free-list entry"
        assert not free_set & lru_set, "block both free and cached"
        assert not (free_set | lru_set) & owned.keys(), \
            "block both free/cached and live"
        combined = sorted(self._free) + sorted(self._lru) + sorted(owned)
        assert sorted(combined) == list(range(1, self.num_blocks)), \
            f"free + LRU + tables do not partition the pool: {sorted(combined)}"
        for b in range(1, self.num_blocks):
            assert self._ref[b] == owned.get(b, 0), \
                f"block {b}: refcount {self._ref[b]} != {owned.get(b, 0)} refs"
        assert set(self._hash_to_block.values()) == set(self._block_digest), \
            "hash index and block-digest map disagree"
        assert len(self._hash_to_block) == len(self._block_digest), \
            "hash index is not a bijection"
        for b in self._lru:
            assert b in self._block_digest, f"LRU block {b} unregistered"
        assert not free_set & self._block_digest.keys(), \
            "registered block leaked onto the free list"
