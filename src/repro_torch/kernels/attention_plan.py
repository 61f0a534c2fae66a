"""Launch plans of the two Hopper attention kernels: K7
(``csrc/flash_attention.cu``, bf16) and K4 (``csrc/paged_chunk_attention.cu``).

Each plan is a plain function of Python ints (the shapes), and takes no
tensor: planning a launch never reads the card, so a prefill step is not
made to wait on ``seq_lens``. The wrappers pass the plan to the C entry
points, which launch only the configurations they were built for.

K7 (``flash_plan``): a work item is ``FLASH_ROWS`` = 128 query rows of one
(batch, head); items are ordered heaviest first (query tile reversed, the
most keys under the causal mask, then batch x head). The grid is
persistent: one block an SM, at most one a work item, and block i takes
items i, i + grid, i + 2 grid, ... A block walks the key tiles up to its
item's last row. The key tile is 128 keys for head dims up to 64 (padded
to one 64-column panel), 64 for head dims up to 128.

K4 (``chunk_plan``): a block takes 64 of the G*S rows of one (request, kv
head) when G*S <= 64, else 128; the live keys of a row tile are split, in
64-key tiles, over a cluster of ``cluster`` blocks. The cluster size comes
from the block-table width x block size, the most keys a request can hold,
at ``KEYS_PER_SPLIT`` keys a block, capped at the portable cluster size 8.
``chunk_splits`` is the device's split of the live keys among the ranks.
"""
from __future__ import annotations

import dataclasses
from typing import List, Tuple

FLASH_ROWS = 128
CHUNK_KEY_TILE = 64
KEYS_PER_SPLIT = 256
MAX_CLUSTER = 8


def _ints(*xs) -> None:
    for x in xs:
        if type(x) is not int:
            raise TypeError(f"attention plans take Python ints (shapes), got "
                            f"{type(x).__name__}")


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@dataclasses.dataclass(frozen=True)
class FlashPlan:
    hd_pad: int              # head dim of the kernel's tiles (64 or 128)
    key_tile: int            # keys per staged K/V tile
    n_bh: int                # batch x head
    n_q_tiles: int           # 128-row query tiles per (batch, head)
    grid: int                # persistent blocks

    def item(self, w: int) -> Tuple[int, int]:
        """(batch x head, query tile) of work item w: heaviest first."""
        return w % self.n_bh, self.n_q_tiles - 1 - w // self.n_bh

    def block_items(self, i: int) -> List[int]:
        """The work items block i takes, in its order."""
        return list(range(i, self.n_bh * self.n_q_tiles, self.grid))

    def key_tiles(self, q_tile: int, s: int) -> range:
        """The key tiles an item of query tile ``q_tile`` walks."""
        return range(_cdiv(min(s, (q_tile + 1) * FLASH_ROWS), self.key_tile))


def flash_plan(b: int, s: int, h: int, hd: int, sms: int) -> FlashPlan:
    """``sms``: the card's streaming multiprocessors (one block each)."""
    _ints(b, s, h, hd, sms)
    if not (0 < hd <= 128 and min(b, s, h, sms) >= 1):
        raise ValueError(f"flash_plan: unsupported B {b}, S {s}, H {h}, "
                         f"hd {hd}")
    hd_pad, key_tile = (64, 128) if hd <= 64 else (128, 64)
    n = _cdiv(s, FLASH_ROWS)
    return FlashPlan(hd_pad, key_tile, b * h, n, min(sms, b * h * n))


@dataclasses.dataclass(frozen=True)
class ChunkPlan:
    rows: int                # query rows per block (64 or 128)
    row_tiles: int           # blocks along G*S, before the cluster split
    cluster: int             # blocks per cluster, splitting the keys
    grid: Tuple[int, int, int]  # (row tile x cluster, kv head, request)


def chunk_plan(b: int, s: int, h: int, hkv: int, width: int,
               bs: int) -> ChunkPlan:
    _ints(b, s, h, hkv, width, bs)
    if min(b, s, hkv, width, bs) < 1 or h % hkv:
        raise ValueError(f"chunk_plan: unsupported B {b}, S {s}, H {h}, "
                         f"Hkv {hkv}, width {width}, bs {bs}")
    nrows = (h // hkv) * s
    rows = 64 if nrows <= 64 else 128
    cluster = max(1, min(MAX_CLUSTER, _cdiv(width * bs, KEYS_PER_SPLIT)))
    row_tiles = _cdiv(nrows, rows)
    return ChunkPlan(rows, row_tiles, cluster, (row_tiles * cluster, hkv, b))


def chunk_splits(kend: int, cluster: int) -> List[Tuple[int, int]]:
    """[lo, hi) of the keys each rank of a cluster takes when a row tile's
    rows see keys 0 .. kend - 1: whole 64-key tiles, rank r taking tiles
    r*nt/cluster .. (r+1)*nt/cluster - 1 of nt, clipped to kend (a split
    may be empty)."""
    _ints(kend, cluster)
    nt = _cdiv(kend, CHUNK_KEY_TILE)
    out = []
    for r in range(cluster):
        lo = r * nt // cluster * CHUNK_KEY_TILE
        hi = (r + 1) * nt // cluster * CHUNK_KEY_TILE
        out.append((min(lo, kend), min(hi, kend)))
    return out
