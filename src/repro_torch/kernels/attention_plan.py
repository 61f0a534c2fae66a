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

K3 (``decode_plan``, ``csrc/paged_decode_attention.cu``): one warpgroup a
block; the CL blocks of a (request, kv head) form a cluster that splits the
request's live keys, in 64-key tiles, and merges its ranks' partials in the
kernel. CL is the widest cluster (at most the portable 8, at most the
table's 64-key tiles, so that a full table gives every rank a tile) that
keeps all B x Hkv clusters resident at once, under K1's residency model
(``twell_pack.resident_clusters``) with the blocks an SM that the kernel's
shared memory (``decode_smem``: the ring of 3 K/V tiles, which grows with
the head dim, and the block table) and its launch bounds (4) allow. So
B x Hkv x CL blocks fill the card whenever the table has the tiles.
``decode_splits`` is the device's split of a request's seq_len + 1 keys
among the ranks: whole 64-key tiles, as ``chunk_splits``.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import List, Tuple

from repro_torch.kernels import twell_pack as tp

FLASH_ROWS = 128
CHUNK_KEY_TILE = 64
KEYS_PER_SPLIT = 256
MAX_CLUSTER = 8
DECODE_KEY_TILE = 64
DECODE_STAGES = 3              # the ring: 2 tiles in flight past the one used
DECODE_BLOCKS_PER_SM = 4       # the kernel's __launch_bounds__(128, 4)
DECODE_MAX_GROUP = 16          # query heads a kv head


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
        return range(tp.cdiv(min(s, (q_tile + 1) * FLASH_ROWS), self.key_tile))


def flash_plan(b: int, s: int, h: int, hd: int, sms: int) -> FlashPlan:
    """``sms``: the card's streaming multiprocessors (one block each)."""
    tp.check_ints(b, s, h, hd, sms)
    if not (0 < hd <= 128 and min(b, s, h, sms) >= 1):
        raise ValueError(f"flash_plan: unsupported B {b}, S {s}, H {h}, "
                         f"hd {hd}")
    hd_pad, key_tile = (64, 128) if hd <= 64 else (128, 64)
    n = tp.cdiv(s, FLASH_ROWS)
    return FlashPlan(hd_pad, key_tile, b * h, n, min(sms, b * h * n))


@dataclasses.dataclass(frozen=True)
class ChunkPlan:
    rows: int                # query rows per block (64 or 128)
    row_tiles: int           # blocks along G*S, before the cluster split
    cluster: int             # blocks per cluster, splitting the keys
    grid: Tuple[int, int, int]  # (row tile x cluster, kv head, request)


def chunk_plan(b: int, s: int, h: int, hkv: int, width: int,
               bs: int) -> ChunkPlan:
    tp.check_ints(b, s, h, hkv, width, bs)
    if min(b, s, hkv, width, bs) < 1 or h % hkv:
        raise ValueError(f"chunk_plan: unsupported B {b}, S {s}, H {h}, "
                         f"Hkv {hkv}, width {width}, bs {bs}")
    nrows = (h // hkv) * s
    rows = 64 if nrows <= 64 else 128
    cluster = max(1, min(MAX_CLUSTER, tp.cdiv(width * bs, KEYS_PER_SPLIT)))
    row_tiles = tp.cdiv(nrows, rows)
    return ChunkPlan(rows, row_tiles, cluster, (row_tiles * cluster, hkv, b))


def chunk_splits(kend: int, cluster: int) -> List[Tuple[int, int]]:
    """[lo, hi) of the keys each rank of a cluster takes when a row tile's
    rows see keys 0 .. kend - 1: whole 64-key tiles, rank r taking tiles
    r*nt/cluster .. (r+1)*nt/cluster - 1 of nt, clipped to kend (a split
    may be empty)."""
    tp.check_ints(kend, cluster)
    nt = tp.cdiv(kend, CHUNK_KEY_TILE)
    out = []
    for r in range(cluster):
        lo = r * nt // cluster * CHUNK_KEY_TILE
        hi = (r + 1) * nt // cluster * CHUNK_KEY_TILE
        out.append((min(lo, kend), min(hi, kend)))
    return out


@dataclasses.dataclass(frozen=True)
class DecodePlan:
    hd_pad: int              # head dim of the kernel's tiles (64 or 128)
    n: int                   # wgmma N: G rounded up to 8 or 16
    cluster: int             # blocks per cluster, splitting the keys
    smem: int                # dynamic shared memory of a block (bytes)
    per_sm: int              # blocks an SM holds
    grid: Tuple[int, int, int]  # (cluster, kv head, request)

    @property
    def clusters(self) -> int:
        return self.grid[1] * self.grid[2]


def decode_smem(hd_pad: int, n: int, width: int) -> int:
    """K3's dynamic shared memory (``Layout::smem`` of the kernel): 1 KB of
    alignment slack, the ring of K and V tiles (64 keys x hd_pad, bf16),
    Q^T (n rows x hd_pad), P^T hi and lo (n rows x 64 keys), 6n floats of
    reductions and the block table (``width`` ints)."""
    tp.check_ints(hd_pad, n, width)
    panels = hd_pad // 64
    return (1024 + DECODE_STAGES * 2 * panels * DECODE_KEY_TILE * 128 +
            panels * n * 128 + 2 * n * 128 + 4 * 6 * n + 4 * width)


@functools.lru_cache(maxsize=None, typed=True)
def decode_plan(b: int, h: int, hkv: int, hd: int, width: int, bs: int,
                sms: int) -> DecodePlan:
    """``sms``: the card's streaming multiprocessors. Cached: the serving
    path calls it every layer of every decode step with a few shapes."""
    tp.check_ints(b, h, hkv, hd, width, bs, sms)
    if min(b, hkv, width, bs, sms) < 1 or h % hkv or \
            not 0 < h // hkv <= DECODE_MAX_GROUP or not 0 < hd <= 128 or \
            hd % 8:
        raise ValueError(f"decode_plan: unsupported B {b}, H {h}, Hkv {hkv}, "
                         f"hd {hd}, width {width}, bs {bs} (hd % 8 == 0, hd "
                         f"<= 128, H / Hkv <= {DECODE_MAX_GROUP})")
    hd_pad = 64 if hd <= 64 else 128
    n = 8 if h // hkv <= 8 else 16
    smem = decode_smem(hd_pad, n, width)
    per_sm = min(DECODE_BLOCKS_PER_SM, tp.SM_SMEM_BYTES // (smem + 1024))
    if smem > tp.SMEM_BYTES or per_sm < 1:
        raise ValueError(f"decode_plan: a table of {width} pages does not "
                         "fit a block's shared memory")
    tiles = tp.cdiv(width * bs, DECODE_KEY_TILE)
    cluster = max([1] + [
        c for c in range(2, min(MAX_CLUSTER, tiles) + 1)
        if b * hkv <= tp.resident_clusters(c, per_sm, sms)])
    return DecodePlan(hd_pad, n, cluster, smem, per_sm, (cluster, hkv, b))


def decode_splits(seq_len: int, table_keys: int,
                  cluster: int) -> List[Tuple[int, int]]:
    """[lo, hi) of the keys each rank of a cluster takes for a request that
    attends keys 0 .. seq_len (at most the table's ``table_keys``): whole
    64-key tiles, rank r taking tiles r*nt/cluster .. (r+1)*nt/cluster - 1
    of nt, clipped to the live keys (a split may be empty)."""
    tp.check_ints(seq_len, table_keys, cluster)
    return chunk_splits(min(seq_len + 1, table_keys), cluster)
