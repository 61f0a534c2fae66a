"""K2, K5 and K6: the sparse FFN kernels of ``repro/kernels/sparse_ffn.py``.

K2, fused up + down projection from the packed TwELL gate (paper Eq. 3):
``twell_fused_ffn_cuda`` launches ``csrc/twell_fused_ffn.cu``, the Hopper
counterpart of ``twell_fused_ffn_pallas``; ``twell_fused_ffn_plain`` is the
same function in plain PyTorch (``repro/kernels/ref.py:twell_fused_ffn``).
At the serving shapes a row block's union of live gate columns is ~113 of
5632, so K2 moves under 1 MB and does ~0.1 GFLOP: its time is fixed cost
and latency. One launch a call: a cluster of ``ks`` blocks a row block
builds the union of the block's valid slot columns on the card from the
TwELL valid prefixes, computes h_u over it once on swap-AB wgmma with
W_u^T's union rows gathered by cp.async and the K loop split over the
ranks, sums the ranks' f32 partials in rank order through distributed
shared memory, rounds h = h_u * g once to bf16 and multiplies it by the
union's W_d rows into each rank's share of y's columns (wgmma again, f32
accumulators stored as y). ``fused_ffn_plan`` is its launch plan, a plain
function of shapes that reuses K1's residency model; from 32 rows a block
it has the ranks split the union's rows (``split``). It takes K up to
16384 (``FUSED_FFN_MAX_K``, llama3-405b's d_model): past 4096 a rank's
share of K outgrows the ring, which then lands each phase in groups; past
8192 a rank holds up to 16 slices of y, in 8-row blocks.

K5, the gated FFN end to end with (row block x tile) skipping:
``tile_skip_ffn_cuda`` launches ``csrc/tile_skip_ffn.cu``, the Hopper
counterpart of ``tile_skip_ffn_pallas`` with the per-(row, tile) threshold
of ``repro/kernels/ref.py:tile_skip_ffn``; ``tile_skip_ffn_plain`` is the
same function in plain PyTorch. ``tile_skip_plan`` is its launch plan, a
plain function of shapes like K1's ``twell_pack.gate_plan``, whose
residency model it reuses.

K6, the non-gated down projection ``y = unpack(h) @ W_d`` (paper App.
C.2), where the up projection itself produced the TwELL pattern:
``twell_down_proj_cuda`` launches ``csrc/twell_down_proj.cu``, the Hopper
counterpart of ``twell_down_proj_pallas``; ``twell_down_proj_plain`` is the
same function in plain PyTorch (``repro/kernels/ref.py:twell_down_proj``,
float32 out). It is K2's down half without the up product, one launch a
call: a block of a row block's rows builds the union of their valid
columns with K2's code (``csrc/twell_union.cuh``), scatters the packed
values into an h tile by union position, gathers the union's W_d rows for
its own 64-column stages of y by cp.async and multiplies them on swap-AB
wgmma. ``down_proj_plan`` is its launch plan, a plain function of shapes
like ``fused_ffn_plan``; from 32 rows a block the column blocks of a row
block form clusters that share the union's build (``split``).

K2 takes ``W_u`` transposed, ``wu_t`` of shape (N, K): the kernel gathers
W_u by column, and a column of the (K, N) row-major matrix is a strided
walk. The transposed copy is made once when the weights are loaded
(``models.lm.prepare_params``), never per call. K5 reads W_g and W_u as
they are stored, (K, N), through TMA, and W_d (N, K) likewise; K2 and K6
read W_d by rows as it is stored.

Each kernel also has a shape function (``*_shape``), its stand-in on
tensors without data (a dry run): the outputs' shapes, dtypes and device,
and the kernel's work reported to ``build.report_work``.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import List, Optional, Tuple

import torch

from repro_torch.core import twell
from repro_torch.kernels import build
from repro_torch.kernels import twell_pack as tp
from repro_torch.observability import accounting

_FN = None
_TS_FN = None
_DP_FN = None
_TS_ACTS = {"relu": 0, "relu2": 1}


def twell_fused_ffn_plain(x: torch.Tensor, tw: twell.TwellActs,
                          wu_t: torch.Tensor, wd: torch.Tensor
                          ) -> torch.Tensor:
    """Dense-equivalent Eq. 3: ((x @ W_u) * unpack(g)) @ W_d with f32
    accumulation. h = h_u * g is rounded to x.dtype with h_u still in f32,
    as the Pallas kernel rounds (ref.py rounds h_u first; in bf16 at
    paper-0.5b width the two orders differ by more than the bf16
    tolerance); float32 inputs are unaffected."""
    hg = twell.unpack(tw).float()
    hu = torch.matmul(x.float(), wu_t.float().t())
    h = (hu * hg).to(x.dtype)
    return torch.matmul(h.float(), wd.float()).to(x.dtype)


FUSED_FFN_WIDTHS = (8, 16, 32, 64)   # rows a block (wgmma N)
FUSED_FFN_SLICES = (2, 4)            # 128-column slices of y a rank holds
FUSED_FFN_WIDE_SLICES = (6, 8)       # the same past K 4096 (the ring then
#                                      holds less than a rank's stages)
FUSED_FFN_WIDEST_SLICES = (16,)      # the same past K 8192 (8-row blocks)
FUSED_FFN_UC = 128                   # union positions a chunk
FUSED_FFN_UNIT = 128 * 128           # a ring stage: 128 rows x 64 bf16
FUSED_FFN_STAGES = (3, 8)            # ring depth, least and most
FUSED_FFN_ACC = 128                  # accumulator floats a thread, at most
FUSED_FFN_MAX_N = 65535              # columns held as u16 positions
FUSED_FFN_SPLIT_WIDTH = 32           # rows a block from which the ranks
#                                      split the union's rows
FUSED_FFN_MAX_K = tp.MAX_KS * 2 * FUSED_FFN_WIDEST_SLICES[-1] * tp.GATE_BK
_FUSED_FFN_TYPES = (torch.bfloat16, torch.bfloat16, torch.int32, torch.int32,
                    torch.bfloat16, torch.bfloat16)


def fused_ffn_smem(width: int, k_per_rank: int, stages: int, n: int) -> int:
    """Dynamic shared memory of a K2 block (``Layout`` in the kernel): 1 KB
    of alignment slack, the ring, x's tile (``k_per_rank`` 64-deep stages
    of ``width`` rows), the h tile (two 64-position panels), the f32
    partial tile (rows x 132), the union's bitmap, the rank's own bitmap,
    the prefix and the u16 columns, and U with the warps' totals."""
    words = tp.cdiv(n, 32)
    return (1024 + stages * FUSED_FFN_UNIT + k_per_rank * width * 128 +
            2 * width * 128 + width * (FUSED_FFN_UC + 4) * 4 + 12 * words +
            (2 * n + 15) // 16 * 16 + 48)


def fused_ffn_staging(n: int) -> int:
    """Bytes staged over the ring before it starts: the byte map of N (a
    32-column word as 32 bytes)."""
    return 32 * tp.cdiv(n, 32)


def _twell_check(what: str, m: int, k: int, n: int, tile: int, c: int
                 ) -> None:
    """The shapes K2 and K6 are built for (u16 union positions)."""
    if tile not in tp.GATE_TILES or min(m, k, n, c) < 1 or n % tile or \
            tile % c or k % 8 or n > FUSED_FFN_MAX_N:
        raise ValueError(
            f"{what}: unsupported M {m}, K {k}, N {n}, tile {tile}, "
            f"C {c} (needs tile in {tp.GATE_TILES}, N % tile == 0, "
            f"tile % C == 0, K % 8 == 0, N <= {FUSED_FFN_MAX_N})")


@dataclasses.dataclass(frozen=True)
class FusedFfnPlan:
    width: int               # wgmma N of both products: rows a block
    row_blocks: int          # clusters, one a row block
    ks: int                  # blocks a cluster, splitting K's stages
    k_stages: int            # GATE_BK-deep stages of K
    k_per_rank: int          # the most stages a rank takes
    slices: int              # 128-column y slices a rank's accumulators hold
    stages: int              # depth of the cp.async ring
    smem: int                # dynamic shared memory a block
    grid: Tuple[int, int]    # (ks, row blocks)
    split: bool              # the ranks split the union's rows (and OR
    #                          their bitmaps through DSMEM)

    @property
    def blocks(self) -> int:
        return self.grid[0] * self.grid[1]

    def k_splits(self) -> List[Tuple[int, int]]:
        """[lo, hi) of the K stages each rank takes: the reduction range
        of its up partial and its columns of y."""
        return tp.splits(self.k_stages, self.ks)

    @property
    def whole(self) -> bool:
        """The ring holds a phase (a rank's up stages, or its down stages:
        two a slice): each lands at once. Every plan up to K 4096."""
        return self.stages >= 2 * tp.cdiv(self.k_per_rank, 2)

    def up_groups(self, ns: int) -> List[Tuple[int, int]]:
        """[lo, hi) of a rank's ``ns`` up stages landed together: all of
        them, or groups of half the ring (as the kernel's ``g_up``)."""
        g = ns if self.whole else max(1, self.stages // 2)
        return [(lo, min(lo + g, ns)) for lo in range(0, ns, g)]

    def down_groups(self, nsl: int) -> List[Tuple[int, int]]:
        """[lo, hi) of a rank's ``nsl`` slices whose down stages (two a
        slice) land together (as the kernel's ``g_sl``)."""
        g = nsl if self.whole else max(1, self.stages // 4)
        return [(lo, min(lo + g, nsl)) for lo in range(0, nsl, g)]

    def scatter_rows(self, valid: int) -> List[Tuple[int, int]]:
        """[lo, hi) of a block's ``valid`` rows whose h each rank forms."""
        return tp.splits(valid, self.ks)

    @staticmethod
    def chunks(union: int) -> List[Tuple[int, int]]:
        """[lo, hi) of the union's positions a chunk, FUSED_FFN_UC each."""
        return [(lo, min(lo + FUSED_FFN_UC, union))
                for lo in range(0, union, FUSED_FFN_UC)]


@functools.lru_cache(maxsize=None, typed=True)
def fused_ffn_plan(m: int, k: int, n: int, tile: int, c: int, sms: int
                   ) -> FusedFfnPlan:
    """K2's launch plan from shapes and the card's SM count; it never reads
    the pattern. Rows a block: M rounded up to one of FUSED_FFN_WIDTHS (64
    at most: both products' accumulators, (slices + 1) x width / 2 floats
    a thread, stay within FUSED_FFN_ACC). The K stages are split over a
    cluster of ``ks`` blocks a row block, the widest (<= 8, <= the stages)
    that keeps every cluster resident at once at one block an SM
    (``twell_pack.widest_cluster``); wider where a rank's share of y would
    not fit its accumulators. The ring as deep as FUSED_FFN_STAGES and the
    shared memory allow, at least a phase (the rank's stages, rounded up
    to even). Where nothing fits, narrower row blocks. The ranks split the
    union's rows from FUSED_FFN_SPLIT_WIDTH rows a block up. That covers K
    up to 4096 (8 ranks of 8 stages). Only where it finds nothing does a
    rank take FUSED_FFN_WIDE_SLICES (up to 16 stages) with a ring shorter
    than a phase, which then lands in groups (``up_groups``,
    ``down_groups``): K up to 8192; and only where that finds nothing
    FUSED_FFN_WIDEST_SLICES (up to 32 stages; the accumulators then hold 8
    rows a block): K up to FUSED_FFN_MAX_K = 16384, the byte map of N and
    the u16 columns within the shared memory beside them (N up to 53248 at
    K 16384). Cached: the serving path calls it every launch with a few
    shapes."""
    tp.check_ints(m, k, n, tile, c, sms)
    _twell_check("twell_fused_ffn", m, k, n, tile, c)
    if sms < 1:
        raise ValueError(f"fused_ffn_plan: {sms} SMs")
    plan = _fused_ffn_search(m, k, n, sms, FUSED_FFN_SLICES, True) or \
        _fused_ffn_search(m, k, n, sms, FUSED_FFN_WIDE_SLICES, False) or \
        _fused_ffn_search(m, k, n, sms, FUSED_FFN_WIDEST_SLICES, False)
    if plan is None:
        raise ValueError(f"fused_ffn_plan: M {m}, K {k}, N {n}, tile {tile} "
                         "does not fit a block's registers and shared memory"
                         f" (K up to {FUSED_FFN_MAX_K})")
    return plan


def _fused_ffn_search(m: int, k: int, n: int, sms: int,
                      slices: Tuple[int, ...], whole: bool
                      ) -> Optional[FusedFfnPlan]:
    """``fused_ffn_plan``'s search with a rank's slices of y from
    ``slices``; ``whole``: the ring holds at least a phase."""
    k_stages = tp.cdiv(k, tp.GATE_BK)
    top = next(w for w in FUSED_FFN_WIDTHS
               if w >= min(m, FUSED_FFN_WIDTHS[-1]))
    lo_st, hi_st = FUSED_FFN_STAGES
    for width in [w for w in reversed(FUSED_FFN_WIDTHS) if w <= top]:
        row_blocks = tp.cdiv(m, width)
        first = tp.widest_cluster(row_blocks, k_stages, 1, sms)
        for ks in range(first, min(tp.MAX_KS, k_stages) + 1):
            per = tp.cdiv(k_stages, ks)
            sl = next((s for s in slices if 2 * s >= per), None)
            if sl is None or (sl + 1) * width // 2 > FUSED_FFN_ACC:
                continue
            least = max(lo_st, 2 * tp.cdiv(per, 2)) if whole else lo_st
            fit = [st for st in range(least, hi_st + 1)
                   if fused_ffn_smem(width, per, st, n) <= tp.SMEM_BYTES
                   and fused_ffn_staging(n) <= st * FUSED_FFN_UNIT]
            if fit:
                st = fit[-1]
                return FusedFfnPlan(width, row_blocks, ks, k_stages, per, sl,
                                    st, fused_ffn_smem(width, per, st, n),
                                    (ks, row_blocks),
                                    width >= FUSED_FFN_SPLIT_WIDTH and ks > 1)
    return None


def fused_ffn_resident_clusters(k: int, n: int, tile: int,
                                plan: FusedFfnPlan) -> Tuple[int, int]:
    """The CUDA runtime's count of the plan's clusters the current card
    holds at once, and a block's shared memory as the kernel computes it.
    For measuring plans; the kernel path never calls it."""
    fn = build.bind("twell_fused_ffn", "twell_fused_ffn_resident_clusters",
                    [build.I] * 7 + [build.P] * 2)
    held, smem = ctypes.c_int(0), ctypes.c_int(0)
    build.check(fn(k, n, tile, plan.width, plan.slices, plan.ks, plan.stages,
                   ctypes.addressof(held), ctypes.addressof(smem)),
                "twell_fused_ffn_resident_clusters")
    return held.value, smem.value


def twell_fused_ffn_cuda(x: torch.Tensor, tw: twell.TwellActs,
                         wu_t: torch.Tensor, wd: torch.Tensor
                         ) -> torch.Tensor:
    """x (M, K) bf16, packed gate ``tw`` (nnz clipped to T/C), wu_t (N, K)
    bf16, wd (N, K) bf16 on the card, x, wu_t and wd 16-byte aligned ->
    y (M, K) float32. One launch under ``fused_ffn_plan``, or raises."""
    global _FN
    m, k = x.shape
    n = wd.shape[0]
    vals, idx, nnz = tw.values, tw.indices, tw.nnz
    if (x.dtype, vals.dtype, idx.dtype, nnz.dtype, wu_t.dtype,
            wd.dtype) != _FUSED_FFN_TYPES:
        raise TypeError("twell_fused_ffn_cuda takes bfloat16 x/values/"
                        "weights and int32 indices/nnz")
    _twell_check("twell_fused_ffn", m, k, n, tw.tile, tw.compression)
    slots, nt = n // tw.compression, n // tw.tile
    if (*wu_t.shape, *wd.shape, *vals.shape, *idx.shape, *nnz.shape) != \
            (n, k, n, k, m, slots, m, slots, m, nt) or n != tw.n or not (
                x.is_contiguous() and vals.is_contiguous() and
                idx.is_contiguous() and nnz.is_contiguous() and
                wu_t.is_contiguous() and wd.is_contiguous()):
        raise ValueError(
            f"twell_fused_ffn_cuda: inconsistent shapes x {tuple(x.shape)} "
            f"wu_t {tuple(wu_t.shape)} wd {tuple(wd.shape)} values "
            f"{tuple(tw.values.shape)} nnz {tuple(tw.nnz.shape)}, or an "
            "operand not contiguous")
    if x.data_ptr() % 16 or wu_t.data_ptr() % 16 or wd.data_ptr() % 16:
        raise ValueError("twell_fused_ffn_cuda: x, wu_t and wd must be "
                         "16-byte aligned (cp.async)")
    dev = x.device
    if not (x.is_cuda and vals.device == dev and idx.device == dev and
            nnz.device == dev and wu_t.device == dev and wd.device == dev):
        raise ValueError("twell_fused_ffn_cuda: every operand must be on "
                         "x's CUDA device")
    plan = fused_ffn_plan(m, k, n, tw.tile, tw.compression,
                          tp.sm_count(dev))
    y = torch.empty((m, k), dtype=torch.float32, device=dev)
    if _FN is None:
        P, I = build.P, build.I
        _FN = build.bind("twell_fused_ffn", "twell_fused_ffn_bf16",
                         [P] * 7 + [I] * 10 + [P])
    with torch.cuda.device(dev):
        err = _FN(vals.data_ptr(), idx.data_ptr(), nnz.data_ptr(),
                  x.data_ptr(), wu_t.data_ptr(),
                  wd.data_ptr(), y.data_ptr(), m, k, n, tw.tile,
                  tw.compression, plan.width, plan.slices, plan.ks,
                  plan.stages, int(plan.split), build.stream_ptr(x))
    build.check(err, "twell_fused_ffn")
    build.count_launch("twell_fused_ffn")
    return y


def union_capacity(m: int, slots: int, n: int) -> int:
    """The most columns a union of ``m`` rows of ``slots`` TwELL slots can
    hold: every slot a different column, at most N. A dry run's K2 and K6
    work at capacity, since which columns are alive is data."""
    return min(n, m * slots)


def twell_fused_ffn_shape(x: torch.Tensor, tw: twell.TwellActs,
                          wu_t: torch.Tensor, wd: torch.Tensor
                          ) -> torch.Tensor:
    """What ``twell_fused_ffn_cuda`` returns, without a launch: y (M, K)
    float32 on x's device, or its refusal of the shapes
    (``fused_ffn_plan`` at the H100's SM count). For tensors without data. Work
    reported at the union's capacity U = ``union_capacity(M, N/C, N)``:
    the up and down products over U columns, 4 M U K FLOPs; bytes x, the
    packed gate and U rows of W_u^T and of W_d read once, y written
    once."""
    m, k = x.shape
    n = wd.shape[0]
    if (x.dtype, tw.values.dtype, tw.indices.dtype, tw.nnz.dtype,
            wu_t.dtype, wd.dtype) != _FUSED_FFN_TYPES:
        raise TypeError("twell_fused_ffn takes bfloat16 x/values/weights "
                        "and int32 indices/nnz")
    _twell_check("twell_fused_ffn", m, k, n, tw.tile, tw.compression)
    if tuple(wu_t.shape) != (n, k) or tuple(wd.shape) != (n, k):
        raise ValueError(f"twell_fused_ffn: wu_t {tuple(wu_t.shape)} wd "
                         f"{tuple(wd.shape)} for x {tuple(x.shape)}")
    fused_ffn_plan(m, k, n, tw.tile, tw.compression, accounting.H100_SMS)
    u = union_capacity(m, tw.values.shape[1], n)
    y = torch.empty((m, k), dtype=torch.float32, device=x.device)
    build.report_work("twell_fused_ffn", 4 * m * u * k,
                      build.nbytes(x, tw.values, tw.indices, tw.nnz, y) +
                      2 * u * k * wd.element_size())
    return y


def twell_down_proj_plain(vals: torch.Tensor, idx: torch.Tensor,
                          nnz: torch.Tensor, wd: torch.Tensor, tile: int
                          ) -> torch.Tensor:
    """vals/idx (M, N/C), nnz (M, N/T), wd (N, K) -> y (M, K) float32:
    ``unpack(h) @ W_d`` in float32. The unpacked h holds each valid slot
    once, so its cast to float32 is exact, and ``vals`` in W_d's type
    rounds nothing when the Pallas body casts h to it."""
    n = wd.shape[0]
    tw = twell.TwellActs(vals, idx, nnz, None, tile, n // vals.shape[1], n)
    return torch.matmul(twell.unpack(tw).float(), wd.float())


DOWN_PROJ_SLICES = (1, 2, 4)      # 128-column slices of y a block
DOWN_PROJ_H_CHUNKS = (2, 1)       # union chunks the h tile holds, most first
DOWN_PROJ_STAGES = (3, 8)         # ring depth, least and most


def down_proj_smem(width: int, h_chunks: int, stages: int, n: int) -> int:
    """Dynamic shared memory of a K6 block (``Layout`` in the kernel): 1 KB
    of alignment slack, the ring, the h tile (``h_chunks`` chunks of two
    64-position panels of ``width`` rows), the union's bitmap, the rank's
    own bitmap, the prefix and the u16 columns, and U with the warps'
    totals."""
    words = tp.cdiv(n, 32)
    return (1024 + stages * FUSED_FFN_UNIT + h_chunks * 2 * width * 128 +
            12 * words + (2 * n + 15) // 16 * 16 + 48)


@dataclasses.dataclass(frozen=True)
class DownProjPlan:
    width: int               # wgmma N: rows a block
    row_blocks: int          # blocks along M
    col_blocks: int          # blocks a row block, each 2 x slices stages
    ks: int                  # blocks a cluster (dividing col_blocks)
    k_stages: int            # GATE_BK-column stages of y
    slices: int              # 128-column slices of y a block's accumulators
    h_chunks: int            # union chunks the h tile holds
    stages: int              # depth of the cp.async ring
    smem: int                # dynamic shared memory a block

    @property
    def grid(self) -> Tuple[int, int]:
        return self.col_blocks, self.row_blocks

    @property
    def split(self) -> bool:
        """The ranks of a cluster split the union's rows (and OR their
        bitmaps through DSMEM) and the scatter of h (sharing its rows)."""
        return self.ks > 1

    @property
    def blocks(self) -> int:
        return self.col_blocks * self.row_blocks

    @property
    def k_per_block(self) -> int:
        """The most y stages a block takes: two a 128-column slice."""
        return 2 * self.slices

    def k_ranges(self) -> List[Tuple[int, int]]:
        """[lo, hi) of the y stages each column block takes."""
        per = self.k_per_block
        return [(b * per, min((b + 1) * per, self.k_stages))
                for b in range(self.col_blocks)]

    def union_rows(self, valid: int) -> List[Tuple[int, int]]:
        """[lo, hi) of a block's ``valid`` rows each rank of a cluster
        marks in the union: its share with ``split``, else all of them."""
        return tp.splits(valid, self.ks) if self.split else \
            [(0, valid)] * self.ks

    def groups(self, union: int) -> List[List[Tuple[int, int]]]:
        """The union's chunks (``FusedFfnPlan.chunks``) in groups of
        ``h_chunks``: the chunks of h scattered at once."""
        chunks = FusedFfnPlan.chunks(union)
        return [chunks[i:i + self.h_chunks]
                for i in range(0, len(chunks), self.h_chunks)]


@functools.lru_cache(maxsize=None, typed=True)
def down_proj_plan(m: int, k: int, n: int, tile: int, c: int, sms: int
                   ) -> DownProjPlan:
    """K6's launch plan from shapes and the card's SM count; it never reads
    the pattern. Rows a block: M rounded up to one of FUSED_FFN_WIDTHS.
    Slices of y a block: the fewest of DOWN_PROJ_SLICES that keep the grid
    (row blocks x column blocks) to the SMs, so a decode call spreads its
    W_d gathers over as many SMs as the 128-column slices of y; all of
    them fit the accumulators (slices x width / 2 <= FUSED_FFN_ACC). From
    FUSED_FFN_SPLIT_WIDTH rows a block the column blocks of a row block
    form clusters, the widest (<= 8, dividing the column blocks) that keeps
    every cluster resident at once at one block an SM (K1's residency
    model, ``twell_pack.one_wave``), whose ranks split the union's rows;
    below it a block builds its union alone (a cluster would share
    nothing). The h tile as many chunks as DOWN_PROJ_H_CHUNKS and the
    shared memory allow with the least ring, then the ring as deep as
    fits, at least a chunk's stages (2 x slices) and holding the byte map
    of N. Cached: the serving path calls it every launch with a few
    shapes."""
    tp.check_ints(m, k, n, tile, c, sms)
    _twell_check("twell_down_proj", m, k, n, tile, c)
    if sms < 1:
        raise ValueError(f"down_proj_plan: {sms} SMs")
    k_stages = tp.cdiv(k, tp.GATE_BK)
    width = next(w for w in FUSED_FFN_WIDTHS
                 if w >= min(m, FUSED_FFN_WIDTHS[-1]))
    row_blocks = tp.cdiv(m, width)
    slices = next((s for s in DOWN_PROJ_SLICES
                   if row_blocks * tp.cdiv(k_stages, 2 * s) <= sms),
                  DOWN_PROJ_SLICES[-1])
    col_blocks = tp.cdiv(k_stages, 2 * slices)
    ks = 1
    if width >= FUSED_FFN_SPLIT_WIDTH:
        ks = max([1] + [q for q in range(2, tp.MAX_KS + 1)
                        if col_blocks % q == 0 and tp.one_wave(
                            row_blocks * col_blocks // q, q, 1, sms)])
    lo_st, hi_st = DOWN_PROJ_STAGES
    lo_st = max(lo_st, 2 * slices)
    for hc in DOWN_PROJ_H_CHUNKS:
        fit = [st for st in range(lo_st, hi_st + 1)
               if down_proj_smem(width, hc, st, n) <= tp.SMEM_BYTES
               and fused_ffn_staging(n) <= st * FUSED_FFN_UNIT]
        if fit:
            st = fit[-1]
            return DownProjPlan(width, row_blocks, col_blocks, ks, k_stages,
                                slices, hc, st,
                                down_proj_smem(width, hc, st, n))
    raise ValueError(f"down_proj_plan: M {m}, K {k}, N {n}, tile {tile} does "
                     "not fit a block's shared memory")


def down_proj_resident_clusters(k: int, n: int, tile: int,
                                plan: DownProjPlan) -> Tuple[int, int]:
    """The CUDA runtime's count of the plan's clusters the current card
    holds at once, and a block's shared memory as the kernel computes it.
    For measuring plans; the kernel path never calls it."""
    fn = build.bind("twell_down_proj", "twell_down_proj_resident_clusters",
                    [build.I] * 8 + [build.P] * 2)
    held, smem = ctypes.c_int(0), ctypes.c_int(0)
    build.check(fn(k, n, tile, plan.width, plan.slices, plan.ks, plan.stages,
                   plan.h_chunks, ctypes.addressof(held),
                   ctypes.addressof(smem)),
                "twell_down_proj_resident_clusters")
    return held.value, smem.value


def twell_down_proj_cuda(vals: torch.Tensor, idx: torch.Tensor,
                         nnz: torch.Tensor, wd: torch.Tensor, tile: int
                         ) -> torch.Tensor:
    """vals (M, N/C) bf16, idx (M, N/C) int32, nnz (M, N/T) int32 (clipped
    to T/C; the kernel reads no slot at or past it), wd (N, K) bf16 on the
    card, wd 16-byte aligned -> y (M, K) float32. One launch under
    ``down_proj_plan``, or raises."""
    global _DP_FN
    m, slots = vals.shape
    n, k = wd.shape
    ts = (vals, idx, nnz, wd)
    if vals.dtype != torch.bfloat16 or wd.dtype != torch.bfloat16 or \
            idx.dtype != torch.int32 or nnz.dtype != torch.int32:
        raise TypeError("twell_down_proj_cuda takes bfloat16 values and "
                        "W_d and int32 indices/nnz")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("twell_down_proj_cuda: operands must be contiguous")
    nt = n // tile if tile > 0 else 0
    if m < 1 or nt < 1 or n % tile or slots % nt or \
            idx.shape != (m, slots) or nnz.shape != (m, nt):
        raise ValueError(
            f"twell_down_proj_cuda: inconsistent shapes values "
            f"{tuple(vals.shape)} idx {tuple(idx.shape)} nnz "
            f"{tuple(nnz.shape)} wd {tuple(wd.shape)} tile {tile}")
    tc = slots // nt
    _twell_check("twell_down_proj", m, k, n, tile,
                 tile // tc if tc and tile % tc == 0 else 0)
    if wd.data_ptr() % 16:
        raise ValueError("twell_down_proj_cuda: wd must be 16-byte aligned "
                         "(cp.async)")
    if not all(t.is_cuda and t.device == wd.device for t in ts):
        raise ValueError("twell_down_proj_cuda: every operand must be on "
                         "wd's CUDA device")
    plan = down_proj_plan(m, k, n, tile, tile // tc, tp.sm_count(wd.device))
    y = torch.empty((m, k), dtype=torch.float32, device=wd.device)
    if _DP_FN is None:
        P, I = build.P, build.I
        _DP_FN = build.bind("twell_down_proj", "twell_down_proj_bf16",
                            [P] * 5 + [I] * 11 + [P])
    with torch.cuda.device(wd.device):
        err = _DP_FN(vals.data_ptr(), idx.data_ptr(), nnz.data_ptr(),
                     wd.data_ptr(), y.data_ptr(), m, k, n, tile, tile // tc,
                     plan.width, plan.slices, plan.ks, plan.stages,
                     plan.h_chunks, int(plan.split), build.stream_ptr(wd))
    build.check(err, "twell_down_proj")
    build.count_launch("twell_down_proj")
    return y


def twell_down_proj_shape(vals: torch.Tensor, idx: torch.Tensor,
                          nnz: torch.Tensor, wd: torch.Tensor, tile: int
                          ) -> torch.Tensor:
    """What ``twell_down_proj_cuda`` returns, without a launch: y (M, K)
    float32 on W_d's device, or its refusal of the shapes
    (``down_proj_plan`` at the H100's SM count). For tensors without data. Work
    reported at the union's capacity U = ``union_capacity(M, N/C, N)``:
    2 M U K FLOPs; bytes the packed activations and U rows of W_d read
    once, y written once."""
    m, slots = vals.shape
    n, k = wd.shape
    if vals.dtype != torch.bfloat16 or wd.dtype != torch.bfloat16 or \
            idx.dtype != torch.int32 or nnz.dtype != torch.int32:
        raise TypeError("twell_down_proj takes bfloat16 values and W_d and "
                        "int32 indices/nnz")
    nt = n // tile if tile > 0 else 0
    if m < 1 or nt < 1 or n % tile or slots % nt:
        raise ValueError(f"twell_down_proj: values {tuple(vals.shape)} wd "
                         f"{tuple(wd.shape)} tile {tile}")
    tc = slots // nt
    c = tile // tc if tc and tile % tc == 0 else 0
    _twell_check("twell_down_proj", m, k, n, tile, c)
    down_proj_plan(m, k, n, tile, c, accounting.H100_SMS)
    u = union_capacity(m, slots, n)
    y = torch.empty((m, k), dtype=torch.float32, device=wd.device)
    build.report_work("twell_down_proj", 2 * m * u * k,
                      build.nbytes(vals, idx, nnz, y) +
                      u * k * wd.element_size())
    return y


def _check_act(act: str) -> None:
    # the Pallas body treats any act other than "relu" as relu^2; the port
    # names the two it computes and refuses the rest
    if act not in _TS_ACTS:
        raise ValueError(f"tile_skip_ffn: activation {act!r} (relu | relu2)")


def tile_skip_ffn_plain(x: torch.Tensor, wg: torch.Tensor, wu: torch.Tensor,
                        wd: torch.Tensor, tile: int, act: str = "relu",
                        threshold: float = 0.0):
    """Gated FFN with per-(row, tile) dropping: x (M, K), wg/wu (K, N),
    wd (N, K) -> (y (M, K) float32, h (M, N) x.dtype).

    g = act(x @ wg) in f32; row m drops tile j when max|g[m, tile j]| <=
    threshold (threshold > 0 only); h = (x @ wu) * g rounded once to x.dtype
    with both factors in f32, as the Pallas kernel rounds (ref.py rounds
    g and x @ wu first; float32 inputs are unaffected); y = h @ wd in f32.
    Skipping a cell whose g is all zero changes nothing, so this dense form
    is the kernel's function."""
    _check_act(act)
    xf = x.float()
    g = torch.relu(torch.matmul(xf, wg.float()))
    if act == "relu2":
        g = g * g
    if threshold > 0.0:
        m, n = g.shape
        tiles = g.reshape(m, n // tile, tile)
        keep = tiles.abs().amax(dim=-1, keepdim=True) > threshold
        g = torch.where(keep, tiles, torch.zeros_like(tiles)).reshape(m, n)
    h = (torch.matmul(xf, wu.float()) * g).to(x.dtype)
    return torch.matmul(h.float(), wd.float()), h


TILE_SKIP_TILES = tp.GATE_TILES  # T the kernel is built for
TILE_SKIP_COLS = (64, 128)       # columns of y a down block


def _warps(cols: int) -> int:
    """Warps of a K5 block of ``cols`` output columns: one consumer
    warpgroup at 64 columns, two above, and the producer warp."""
    return (1 if cols == 64 else 2) * 4 + 1


def up_smem(tile: int, width: int, stages: int, g_rows: int) -> int:
    """Dynamic shared memory of an up block (``Cfg::up_smem``): 1 KB of
    alignment slack, the ring or the f32 partial tile aliased over it, two
    mbarriers a stage, the block's keep bits and every rank's (4 words
    each) and the ``g_rows`` rows of g a rank keeps beyond one a warp."""
    region = max(stages * tp.stage_bytes(tile, width),
                 width * (tile + 4) * 4)
    return 1024 + region + 16 * stages + 16 + 16 * tp.MAX_KS + \
        g_rows * tile * 4


def down_smem(cols: int, width: int, stages: int, tiles: int) -> int:
    """Dynamic shared memory of a down block (``Cfg::down_smem``): the
    slack, the ring or the partial tile, the mbarriers, a byte a tile."""
    region = max(stages * tp.stage_bytes(cols, width),
                 width * (cols + 4) * 4)
    return 1024 + region + 16 * stages + tp.cdiv(tiles, 16) * 16


@dataclasses.dataclass(frozen=True)
class TileSkipPlan:
    width: int                 # wgmma N: rows a block (M rounded up)
    row_blocks: int            # blocks along M, both kernels
    k_stages: int              # GATE_BK-deep stages of the up K loops
    ks: int                    # up: blocks a cluster splitting them
    stages: int                # up: ring depth
    g_rows: int                # up: g rows a rank keeps in shared memory
    per_sm: int                # up: blocks an SM the plan counts on
    cols: int                  # down: columns of y a block
    ks_down: int               # down: blocks a cluster
    stages_down: int           # down: ring depth
    per_sm_down: int           # down: blocks an SM
    n_stages: int              # down: GATE_BK-deep stages of all of N
    grid: Tuple[int, int]      # up: (tiles x ks, row blocks)
    grid_down: Tuple[int, int]  # down: (column blocks x ks_down, row blocks)

    @property
    def blocks(self) -> int:
        return self.grid[0] * self.grid[1]

    @property
    def blocks_down(self) -> int:
        return self.grid_down[0] * self.grid_down[1]


@functools.lru_cache(maxsize=None, typed=True)
def tile_skip_plan(m: int, k: int, n: int, tile: int, sms: int
                   ) -> TileSkipPlan:
    """K5's launch plan from shapes and the card's SM count, as
    ``twell_pack.gate_plan``: rows a block n = M rounded up to one of
    GATE_WIDTHS (at most 128), for both kernels. Up: the widest cluster
    (<= 8, <= the K stages) with tiles x row blocks x ks <= the SMs and
    every cluster resident at once (``resident_clusters``); a rank keeps
    ceil(rows / ks) rows of g, one a warp in registers and the rest in
    shared memory (``g_rows``), so that at n <= 32 two blocks share an SM
    with a ring of 3. Down: the same rule over column blocks x row blocks,
    taking 64 or 128 columns a block, whichever leaves the shorter chain of
    stages a rank (the most a row block can keep: all N / 64), ties to 64.
    Cached: the serving path calls it every launch with a few shapes."""
    tp.check_ints(m, k, n, tile, sms)
    if tile not in TILE_SKIP_TILES or min(m, k, n, sms) < 1 or n % tile:
        raise ValueError(f"tile_skip_plan: unsupported M {m}, K {k}, N {n}, "
                         f"tile {tile} (tile in {TILE_SKIP_TILES}, "
                         "N % tile == 0)")
    width = next(w for w in tp.GATE_WIDTHS
                 if w >= min(m, tp.GATE_WIDTHS[-1]))
    row_blocks = tp.cdiv(m, width)
    rows = min(m, width)
    k_stages = tp.cdiv(k, tp.GATE_BK)
    tiles = n // tile
    up = None
    base = tiles * row_blocks                        # clusters
    for ks in range(min(tp.MAX_KS, k_stages), 0, -1):
        g_rows = max(0, tp.cdiv(rows, ks) - _warps(tile))
        per_sm, stages = tp.ring_plan(
            lambda st: up_smem(tile, width, st, g_rows), width, k_stages)
        if stages is not None and (
                ks == 1 or tp.one_wave(base, ks, per_sm, sms)):
            up = (ks, stages, g_rows, per_sm)
            break
    n_stages = n // tp.GATE_BK
    down = None
    for cols in TILE_SKIP_COLS:
        base_d = tp.cdiv(k, cols) * row_blocks
        per_sm, stages = tp.ring_plan(
            lambda st: down_smem(cols, width, st, tiles), width, n_stages)
        if stages is None:
            continue
        ks = tp.widest_cluster(base_d, n_stages, per_sm, sms)
        key = (tp.cdiv(n_stages, ks), cols)
        if down is None or key < down[0]:
            down = (key, cols, ks, stages, per_sm)
    if up is None or down is None:
        raise ValueError(f"tile_skip_plan: M {m}, K {k}, N {n}, tile {tile} "
                         "does not fit a block's shared memory")
    ks, stages, g_rows, per_sm = up
    _, cols, ks_d, stages_d, per_sm_d = down
    return TileSkipPlan(width, row_blocks, k_stages, ks, stages, g_rows,
                        per_sm, cols, ks_d, stages_d, per_sm_d, n_stages,
                        (tiles * ks, row_blocks),
                        (tp.cdiv(k, cols) * ks_d, row_blocks))


def tile_skip_resident_clusters(tile: int, plan: TileSkipPlan, n: int
                                ) -> Tuple[int, int, int, int]:
    """The CUDA runtime's count of the plan's clusters the current card
    holds at once, and a block's shared memory as the kernel computes it:
    (up clusters, up bytes, down clusters, down bytes). For measuring
    plans; the kernel path never calls it."""
    fn = build.bind("tile_skip_ffn", "tile_skip_resident_clusters",
                    [build.I] * 6 + [build.P] * 2)
    out = []
    for down, cols, ks, stages, extra in (
            (0, tile, plan.ks, plan.stages, plan.g_rows),
            (1, plan.cols, plan.ks_down, plan.stages_down, n // tile)):
        held, smem = ctypes.c_int(0), ctypes.c_int(0)
        build.check(fn(down, cols, plan.width, ks, stages, extra,
                       ctypes.addressof(held), ctypes.addressof(smem)),
                    "tile_skip_resident_clusters")
        out += [held.value, smem.value]
    return tuple(out)


def tile_skip_ffn_cuda(x: torch.Tensor, wg: torch.Tensor, wu: torch.Tensor,
                       wd: torch.Tensor, tile: int, act: str = "relu",
                       threshold: float = 0.0,
                       cell_active: Optional[torch.Tensor] = None):
    """x (M, K), wg/wu (K, N), wd (N, K) bf16 on the card, 16-byte aligned
    -> (y (M, K) float32, h (M, N) bf16). ``cell_active``, when given, is
    an int32 (ceil(M/32), N/tile) tensor the kernel fills with 1 for every
    (32-row group, tile) cell in which some valid row keeps the tile (its
    max gate above the threshold) and 0 elsewhere. The kernel reads a
    tile's W_u and W_d slices for a row block of the plan only when one of
    the block's groups is flagged."""
    global _TS_FN
    _check_act(act)
    m, k = x.shape
    n = wg.shape[1]
    if wg.shape != (k, n) or wu.shape != (k, n) or wd.shape != (n, k) or \
            m < 1 or k % 8 or tile not in TILE_SKIP_TILES or n % tile or \
            not threshold >= 0:
        raise ValueError(
            f"tile_skip_ffn_cuda: unsupported shapes x {tuple(x.shape)} "
            f"wg {tuple(wg.shape)} wu {tuple(wu.shape)} wd {tuple(wd.shape)} "
            f"tile {tile} threshold {threshold} (needs K % 8 == 0, tile in "
            f"{TILE_SKIP_TILES}, N % tile == 0, threshold >= 0)")
    ts = (x, wg, wu, wd)
    if not all(t.is_cuda and t.device == x.device for t in ts):
        raise ValueError("tile_skip_ffn_cuda: every operand must be on x's "
                         "CUDA device")
    if any(t.dtype != torch.bfloat16 for t in ts):
        raise TypeError("tile_skip_ffn_cuda takes bfloat16 operands")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("tile_skip_ffn_cuda: operands must be contiguous")
    if any(t.data_ptr() % 16 for t in ts):
        raise ValueError("tile_skip_ffn_cuda: operands must be 16-byte "
                         "aligned (TMA)")
    plan = tile_skip_plan(m, k, n, tile, tp.sm_count(x.device))
    rb = -(-m // 32)
    if cell_active is None:
        cell_active = torch.empty((rb, n // tile), dtype=torch.int32,
                                  device=x.device)
    elif cell_active.shape != (rb, n // tile) or \
            cell_active.dtype != torch.int32 or \
            cell_active.device != x.device or \
            not cell_active.is_contiguous():
        raise ValueError("tile_skip_ffn_cuda: cell_active must be a "
                         f"contiguous int32 ({rb}, {n // tile}) tensor on "
                         "x's device")
    y = torch.empty((m, k), dtype=torch.float32, device=x.device)
    h = torch.empty((m, n), dtype=x.dtype, device=x.device)
    if _TS_FN is None:
        P, I, F = build.P, build.I, build.F
        _TS_FN = build.bind("tile_skip_ffn", "tile_skip_ffn_bf16",
                            [P] * 7 + [I] * 5 + [F] + [I] * 7 + [P])
    with torch.cuda.device(x.device):
        err = _TS_FN(x.data_ptr(), wg.data_ptr(), wu.data_ptr(),
                     wd.data_ptr(), y.data_ptr(), h.data_ptr(),
                     cell_active.data_ptr(), m, k, n, tile, _TS_ACTS[act],
                     float(threshold), plan.width, plan.ks, plan.stages,
                     plan.g_rows, plan.cols, plan.ks_down, plan.stages_down,
                     build.stream_ptr(x))
    build.check(err, "tile_skip_ffn")
    build.count_launch("tile_skip_ffn")
    return y, h


def tile_skip_ffn_shape(x: torch.Tensor, wg: torch.Tensor, wu: torch.Tensor,
                        wd: torch.Tensor, tile: int, act: str = "relu",
                        threshold: float = 0.0):
    """What ``tile_skip_ffn_cuda`` returns, without a launch: (y (M, K)
    float32, h (M, N) x.dtype) on x's device, or its refusal of the shapes
    (``tile_skip_plan`` at the H100's SM count). For tensors without data. Work
    reported at capacity, no tile skipped: the gate, up and down products,
    6 M K N FLOPs; bytes x and the three weights read once, y and h
    written once."""
    _check_act(act)
    m, k = x.shape
    n = wg.shape[1]
    if any(t.dtype != torch.bfloat16 for t in (x, wg, wu, wd)):
        raise TypeError("tile_skip_ffn takes bfloat16 operands")
    if wg.shape != (k, n) or wu.shape != (k, n) or wd.shape != (n, k) or \
            k % 8 or tile not in TILE_SKIP_TILES or n % tile or \
            not threshold >= 0:
        raise ValueError(f"tile_skip_ffn: unsupported x {tuple(x.shape)} "
                         f"wg {tuple(wg.shape)} tile {tile}")
    tile_skip_plan(m, k, n, tile, accounting.H100_SMS)
    y = torch.empty((m, k), dtype=torch.float32, device=x.device)
    h = torch.empty((m, n), dtype=x.dtype, device=x.device)
    build.report_work("tile_skip_ffn", 6 * m * k * n,
                      build.nbytes(x, wg, wu, wd, y, h))
    return y, h
