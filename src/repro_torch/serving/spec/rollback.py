"""KV rollback after speculative verification.

Rejected draft tokens must leave no trace. Values need no work: the verify
pass overwrote every drafted position with exact values, and reads mask
every position at or past the committed length. Blocks do: the draft/verify
step may have appended pool blocks for scratch positions that were then
rejected, and they go back to the free list (and the request's admission
reservation), or the pool leaks until the request finishes.
"""
from __future__ import annotations

from repro_torch.serving.kv_cache import PagedKVCache


def rollback_after_verify(kv: PagedKVCache, rid: int,
                          committed_tokens: int) -> int:
    """Truncate ``rid``'s block table to what ``committed_tokens`` cache
    slots need; tail blocks return to the free list. Returns the number of
    blocks freed (the engine adds them back to the request's reservation,
    keeping ``len(block_table) + reserved_blocks`` at the worst case)."""
    return kv.truncate(rid, kv.blocks_for(max(committed_tokens, 1)))
