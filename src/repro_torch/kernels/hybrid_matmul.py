"""K8 and K9: the ELL side of the hybrid format's products (paper Sec. 3.5).

K8, ``y = h @ W`` with h in the hybrid format: ``hybrid_to_dense_cuda``
launches ``csrc/hybrid_matmul.cu``, the Hopper counterpart of
``repro/kernels/hybrid_matmul.py:hybrid_to_dense_pallas``;
``hybrid_to_dense_plain`` is the same function in plain PyTorch. For a
bf16 W, K8 is one wgmma kernel: a block of ``H2D_ROWS`` rows builds the
union of its valid slots' columns on the card, scatters its slot values
into a (rows x union) tile in shared memory (f32 values as bf16 hi + lo)
and multiplies it by the union's W rows, gathered, K slice by K slice of
``H2D_KS`` output columns; ``h2d_plan`` is its launch plan. For an f32 W
(the float32 gradient checks) it is a per-row kernel on CUDA cores.

K9, the SDDMM ``vals = (x @ W)[pattern]``: ``dense_to_hybrid_cuda``
launches the same source's K9 kernels, the counterpart of
``dense_to_hybrid_pallas``; ``dense_to_hybrid_plain`` beside it. In bf16
K9 is one wgmma kernel: a block of ``D2H_ROWS`` rows builds the same
union, computes x's rows against that union's W rows in chunks of
``D2H_COLS`` columns on the tensor cores and picks its slots' values;
``d2h_plan`` is its launch plan. In float32 K9 is a per-row kernel on CUDA
cores, which keeps the products exact in f32. Both plans are plain
functions of Python ints: they never read the pattern.

A block's union maps are N-sized up to N 16384 (``NARROW_MAX_N``): 5.25
bytes a column, which past N ~19000 leave no room for a ring. Past 16384
(deepseek-67b's d_ff 22016, llama3-405b's 53248) both plans take the wide
maps (``wide``): the bitmap and its prefix and the union's columns, at
most min(N, 128 E) of them, 0.25 bytes a column of N plus 2 a union
column; the kernel then finds a column's position by a popcount over the
prefix. Every plan up to N 16384 keeps the narrow maps, as before.

Both cover the ELL side only: slot e of row m is valid when
``e < row_nnz[m]`` and ``is_sparse[m]``; a row in the dense backup gives 0
(K8) or all-zero slots (K9), and ``core/hybrid.py`` adds the backup rows'
dense product. Both return float32. The two kernels read W by rows: K8
takes W as (N, K), K9 takes ``wt``, W transposed, also (N, K), so a
pattern column of W is one contiguous row.

``hybrid_to_dense_shape`` and ``dense_to_hybrid_shape`` stand in for the
launches on tensors without data (a dry run): the outputs' shapes, dtypes and
device, and the work at the union's capacity (``build.report_work``).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import List, Optional, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels import twell_pack as tp
from repro_torch.observability import accounting

_H2D = None
_D2H = None
_TYPES = (torch.bfloat16, torch.float32)

D2H_ROWS = 128                 # rows a block: two warpgroups of 64
D2H_COLS = 128                 # union columns a chunk: the kernel's wgmma N
D2H_BK = 64                    # K of a ring stage (one 128-byte panel row)
D2H_STAGES = (4, 5, 6)         # ring depths built, in stages of one chunk;
#                                copies run two fewer stages ahead than
#                                the ring holds, one wgmma group in flight
D2H_STAGE_BYTES = (D2H_ROWS + D2H_COLS) * 128   # x's rows and a chunk's
#                                                  Wt rows, 64 of K each

H2D_ROWS = 128                 # rows a block: two warpgroups of 64
H2D_KS = 128                   # y columns a K slice: the kernel's wgmma N
H2D_US = 64                    # union positions a ring stage (a panel row)
H2D_STAGES = (4, 5, 6)         # ring depths built; copies run two fewer
#                                stages ahead than the ring holds
H2D_STAGE_BYTES = H2D_US * H2D_KS * 2      # a stage: 64 gathered W rows,
#                                            128 y columns, bf16
H2D_PANEL_BYTES = H2D_ROWS * 128           # 64 positions of the h tile
H2D_RESIDENT = 256             # union positions the plan's tile holds
#                                before its ring deepens: a 128-row block's
#                                union at the train phase's pattern is ~216


@dataclasses.dataclass(frozen=True)
class D2hPlan:
    splits: int              # S: blocks a row block; block s takes chunks
    #                          s, s + S, ... of its union
    stages: int              # depth of the cp.async ring
    row_blocks: int
    max_chunks: int          # chunks of the largest union a block can meet,
    #                          min(N, min(M, D2H_ROWS) x E) columns
    smem: int                # dynamic shared memory of a block (bytes)
    wide: bool = False       # the wide union maps (``_union_bytes``)

    @property
    def grid(self) -> Tuple[int, int]:
        return (self.row_blocks, self.splits)

    @property
    def blocks(self) -> int:
        return self.row_blocks * self.splits

    def passes(self, s: int, union: int) -> List[Tuple[int, ...]]:
        """The chunks of a ``union``-column union block ``s`` computes
        (s, s + S, ...), grouped as the kernel's passes over K: two a pass
        while two remain, where the ring holds three stages of two
        chunks (``stages`` >= 5), then one."""
        mine = list(range(s, tp.cdiv(union, D2H_COLS), self.splits))
        pairs = len(mine) // 2 if self.stages * D2H_STAGE_BYTES // (
            D2H_STAGE_BYTES + D2H_COLS * 128) >= 3 else 0
        return ([tuple(mine[2 * i:2 * i + 2]) for i in range(pairs)]
                + [(c,) for c in mine[2 * pairs:]])


MAX_N = 65535                  # columns held as u16 union positions
NARROW_MAX_N = 16384           # the widest N on the N-sized union maps


def union_cap(n: int, e: int) -> int:
    """The most columns a 128-row block's union can hold: min(N, 128 E)."""
    return min(n, D2H_ROWS * e)


def _union_bytes(n: int, e: int = 0) -> int:
    """Shared memory of a 128-row block's union of n columns (``union_bytes``
    of the kernels). ``e`` 0, the narrow maps: its columns and each
    column's position (n 16-bit values each), the bitmap and its prefix
    (an int each per 32 columns), the byte map (32 bytes per 32 columns),
    the rows' valid slot counts and the union's size. ``e`` the ELL width,
    the wide maps: the bitmap and its prefix, the union's columns (u16,
    ``union_cap`` of them rounded up to even), the rows' counts, the
    union's size and the warps' totals."""
    if e:
        return (8 * tp.cdiv(n, 32) + 4 * tp.cdiv(union_cap(n, e), 2)
                + 4 * D2H_ROWS + 48)
    return 4 * n + 40 * tp.cdiv(n, 32) + 4 * D2H_ROWS + 16


def _widest_n(fits) -> int:
    """The largest N <= MAX_N at which ``fits(n)`` holds (monotone: true up
    to some N), 0 if none."""
    lo, hi = 0, MAX_N
    while lo < hi:
        mid = (lo + hi + 1) // 2
        if fits(mid):
            lo = mid
        else:
            hi = mid - 1
    return lo


def d2h_smem(n: int, stages: int, e: int = 0) -> int:
    """K9's dynamic shared memory (``d2h_smem`` of the kernel): 1 KB of
    alignment slack, the ring (``stages`` of 128 rows of x and 128 Wt
    rows, 64 of K each, bf16; the staged f32 accumulators alias it) and
    the union's maps (``e`` > 0: the wide ones at ELL width e)."""
    tp.check_ints(n, stages, e)
    return 1024 + stages * D2H_STAGE_BYTES + _union_bytes(n, e)


def _d2h_stages(n: int, e: int) -> List[int]:
    """The ring depths of D2H_STAGES that fit beside the union maps (``e``
    as ``d2h_smem``'s)."""
    return [st for st in D2H_STAGES if d2h_smem(n, st, e) <= tp.SMEM_BYTES]


@functools.lru_cache(maxsize=None, typed=True)
def d2h_plan(m: int, k: int, n: int, e: int, sms: int) -> D2hPlan:
    """``sms``: the card's streaming multiprocessors. S as many splits as
    keep row blocks x S within one block an SM, at most the chunks of the
    largest union a block can meet, min(N, min(M, D2H_ROWS) x E) columns
    (at M 8192, 64 row blocks: S = 2); the deepest ring that fits the shared
    memory beside the N-sized maps, past NARROW_MAX_N beside the wide maps
    (``wide``). Never reads the pattern: the union is found on the card.
    Raises ValueError when no ring fits beside the maps (too large an N,
    or N past MAX_N); the message states the widest N at this E.
    Cached: a training step calls it twice a layer."""
    tp.check_ints(m, k, n, e, sms)
    if min(m, k, n, e, sms) < 1:
        raise ValueError(f"d2h_plan: unsupported M {m}, K {k}, N {n}, E {e}")
    row_blocks = tp.cdiv(m, D2H_ROWS)
    max_chunks = tp.cdiv(min(n, min(m, D2H_ROWS) * e), D2H_COLS)
    splits = max(1, min(max_chunks, sms // row_blocks))
    wide = n > NARROW_MAX_N
    ue = e if wide else 0
    fit = _d2h_stages(n, ue) if n <= MAX_N else []
    if not fit:
        raise ValueError(
            f"d2h_plan: N {n} is too wide: its maps and a ring of "
            f"{D2H_STAGES[0]} stages take {d2h_smem(n, D2H_STAGES[0], e)} "
            f"bytes of shared memory, over {tp.SMEM_BYTES}, or N is past "
            f"{MAX_N} (at E {e}: N up to "
            f"{_widest_n(lambda nn: bool(_d2h_stages(nn, e)))})")
    return D2hPlan(splits, fit[-1], row_blocks, max_chunks,
                   d2h_smem(n, fit[-1], ue), wide)


@dataclasses.dataclass(frozen=True)
class H2dPlan:
    splits: int              # S: blocks a row block; block s takes K slices
    #                          s, s + S, ... of y's columns
    stages: int              # depth of the cp.async ring
    cols: int                # HC: union positions the h tile holds; a wider
    #                          union goes in chunks of HC, scattered again
    #                          for each K slice
    row_blocks: int
    k_slices: int            # slices of H2D_KS columns of y
    smem: int                # dynamic shared memory of a block (bytes)
    wide: bool = False       # the wide union maps (``_union_bytes``)

    @property
    def grid(self) -> Tuple[int, int]:
        return (self.row_blocks, self.splits)

    @property
    def blocks(self) -> int:
        return self.row_blocks * self.splits

    def slices(self, s: int) -> List[int]:
        """The K slices block ``s`` of a row block computes, in order."""
        return list(range(s, self.k_slices, self.splits))

    def chunks(self, union: int) -> List[Tuple[int, int]]:
        """[lo, hi) union positions of each tile chunk of a ``union``-column
        union, in whole 64-deep stages (the last one past the union is
        zero): one chunk while the union fits the tile, none when empty."""
        end = tp.cdiv(union, H2D_US) * H2D_US
        return [(lo, min(lo + self.cols, end))
                for lo in range(0, end, self.cols)]


def h2d_smem(n: int, stages: int, cols: int, terms: int, e: int = 0) -> int:
    """K8's dynamic shared memory (``h2d_smem`` of the kernel): 1 KB of
    alignment slack, the ring (``stages`` of 64 gathered W rows, 128 y
    columns each, bf16), the h tile (``terms`` bf16 parts -- 2 for f32
    values, hi and lo -- of 128 rows x ``cols`` positions) and the union's
    maps (``e`` > 0: the wide ones at ELL width e)."""
    tp.check_ints(n, stages, cols, terms, e)
    return (1024 + stages * H2D_STAGE_BYTES
            + terms * (cols // H2D_US) * H2D_PANEL_BYTES
            + _union_bytes(n, e))


def _h2d_fit(n: int, terms: int, widest: int, e: int
             ) -> Optional[Tuple[int, int]]:
    """(tile positions, ring depth) of ``h2d_plan`` beside the union maps
    (``e`` as ``h2d_smem``'s), or None where no tile of H2D_US positions
    and ring of H2D_STAGES[0] fit."""
    def fits(cols, stages):
        return h2d_smem(n, stages, cols, terms, e) <= tp.SMEM_BYTES
    cols = min(widest, H2D_RESIDENT)
    while cols > H2D_US and not fits(cols, H2D_STAGES[0]):
        cols -= H2D_US
    if not fits(cols, H2D_STAGES[0]):
        return None
    stages = max(st for st in H2D_STAGES if fits(cols, st))
    while cols + H2D_US <= widest and fits(cols + H2D_US, stages):
        cols += H2D_US
    return cols, stages


@functools.lru_cache(maxsize=None, typed=True)
def h2d_plan(m: int, k: int, n: int, e: int, sms: int,
             terms: int = 1) -> H2dPlan:
    """``sms``: the card's streaming multiprocessors; ``terms``: 1 for bf16
    slot values, 2 for f32 ones (the tile's hi and lo parts). S as many
    splits as keep row blocks x S within one block an SM, at most the K
    slices (at M 8192, 64 row blocks: S = 2). The tile first holds
    ``H2D_RESIDENT`` positions (or the widest union a block can meet,
    min(N, min(M, H2D_ROWS) x E), if fewer), the ring then as deep as fits,
    the tile then as wide as fits; beside the N-sized maps, past
    NARROW_MAX_N beside the wide maps (``wide``). Never reads the pattern:
    the union is found on the card. Raises ValueError when no tile of 64
    positions and ring of 4 fit beside the maps (too large an N, or N past
    MAX_N); the message states the widest N at this E. Cached: a training
    step calls it three times a layer."""
    tp.check_ints(m, k, n, e, sms, terms)
    if min(m, k, n, e, sms) < 1 or terms not in (1, 2):
        raise ValueError(f"h2d_plan: unsupported M {m}, K {k}, N {n}, E {e}, "
                         f"terms {terms}")
    row_blocks = tp.cdiv(m, H2D_ROWS)
    k_slices = tp.cdiv(k, H2D_KS)
    splits = max(1, min(k_slices, sms // row_blocks))
    widest = tp.cdiv(min(n, min(m, H2D_ROWS) * e), H2D_US) * H2D_US
    wide = n > NARROW_MAX_N
    ue = e if wide else 0
    fit = _h2d_fit(n, terms, widest, ue) if n <= MAX_N else None
    if fit is None:
        least = H2D_US, H2D_STAGES[0], terms
        raise ValueError(
            f"h2d_plan: N {n} is too wide: its maps, a tile of {H2D_US} "
            f"positions and a ring of {H2D_STAGES[0]} stages take "
            f"{h2d_smem(n, least[1], least[0], terms, e)} bytes of shared "
            f"memory, over {tp.SMEM_BYTES}, or N is past {MAX_N} (at E {e},"
            f" terms {terms}: N up to "
            f"{_widest_n(lambda nn: h2d_smem(nn, least[1], least[0], terms, e) <= tp.SMEM_BYTES)})")
    cols, stages = fit
    return H2dPlan(splits, stages, cols, row_blocks, k_slices,
                   h2d_smem(n, stages, cols, terms, ue), wide)


def _valid(ell_idx, row_nnz, is_sparse):
    slot = torch.arange(ell_idx.shape[1], device=ell_idx.device)
    return (slot[None, :] < row_nnz[:, None]) & is_sparse[:, None]


def hybrid_to_dense_plain(ell_vals, ell_idx, row_nnz, is_sparse, w):
    """(M, E) slots, w (N, K) -> (M, K) float32: the valid slots scattered
    into an (M, N) float32 matrix, times W in float32."""
    m = ell_vals.shape[0]
    vals = torch.where(_valid(ell_idx, row_nnz, is_sparse),
                       ell_vals.float(), torch.zeros((), device=w.device))
    h = torch.zeros((m, w.shape[0]), dtype=torch.float32, device=w.device)
    h.scatter_add_(1, ell_idx.long(), vals)
    return torch.matmul(h, w.float())


def dense_to_hybrid_plain(x, wt, ell_idx, row_nnz, is_sparse):
    """x (M, K), wt (N, K) -> (M, E) float32: x @ W in float32, read at the
    pattern's columns, 0 on invalid slots."""
    full = torch.matmul(x.float(), wt.float().t())
    vals = torch.gather(full, 1, ell_idx.long())
    return torch.where(_valid(ell_idx, row_nnz, is_sparse), vals,
                       torch.zeros((), device=x.device))


def _check(name, ts, ell_idx, row_nnz, is_sparse, m, e, k):
    dev = ts[0].device
    if not all(t.is_cuda and t.device == dev
               for t in (*ts, ell_idx, row_nnz, is_sparse)):
        raise ValueError(f"{name}: every operand must be on one CUDA device")
    if ell_idx.dtype != torch.int32 or row_nnz.dtype != torch.int32 or \
            is_sparse.dtype != torch.bool:
        raise TypeError(f"{name} takes int32 indices and counts and a bool "
                        "is_sparse")
    if not all(t.is_contiguous() for t in (*ts, ell_idx, row_nnz, is_sparse)):
        raise ValueError(f"{name}: operands must be contiguous")
    if ell_idx.shape != (m, e) or row_nnz.shape != (m,) or \
            is_sparse.shape != (m,) or k % 8 or m < 1 or not 1 <= e <= 1024 \
            or any(t.data_ptr() % 16 for t in ts):
        raise ValueError(
            f"{name}: unsupported shapes (M {m}, E {e}, K {k}; needs "
            "K % 8 == 0, E <= 1024, 16-byte aligned operands)")


def hybrid_to_dense_cuda(ell_vals, ell_idx, row_nnz, is_sparse, w):
    """ell_vals (M, E) bf16 or f32, w (N, K) bf16 or f32 on the card ->
    y (M, K) float32. bf16 W launches the union kernel under ``h2d_plan``
    on the values as they are (f32 ones as bf16 hi + lo); f32 W the per-row
    kernel (the values widened to f32, exactly). Either launches or
    raises."""
    global _H2D
    m, e = ell_vals.shape
    n, k = w.shape
    if ell_vals.dtype not in _TYPES or w.dtype not in _TYPES:
        raise TypeError("hybrid_to_dense_cuda takes bfloat16 or float32 "
                        "values and weights")
    bf16 = w.dtype == torch.bfloat16
    vals = ell_vals if bf16 else ell_vals.float().contiguous()
    _check("hybrid_to_dense_cuda", (vals, w), ell_idx, row_nnz, is_sparse,
           m, e, k)
    vals_bf16 = vals.dtype == torch.bfloat16
    plan = h2d_plan(m, k, n, e, tp.sm_count(w.device),
                    1 if vals_bf16 else 2) if bf16 else None
    y = torch.empty((m, k), dtype=torch.float32, device=w.device)
    if _H2D is None:
        P, I = build.P, build.I
        _H2D = build.bind("hybrid_matmul", "hybrid_to_dense",
                          [P] * 6 + [I] * 11 + [P])
    with torch.cuda.device(w.device):
        err = _H2D(vals.data_ptr(), ell_idx.data_ptr(), row_nnz.data_ptr(),
                   is_sparse.data_ptr(), w.data_ptr(), y.data_ptr(), m, e, k,
                   n, int(bf16), int(vals_bf16),
                   *((plan.splits, plan.stages, plan.cols, int(plan.wide),
                      plan.smem) if bf16 else (0, 0, 0, 0, 0)),
                   build.stream_ptr(w))
    build.check(err, "hybrid_to_dense")
    build.count_launch("hybrid_to_dense")
    return y


def dense_to_hybrid_cuda(x, wt, ell_idx, row_nnz, is_sparse):
    """x (M, K) and wt (N, K), both bf16 or both f32, on the card ->
    vals (M, E) float32 on the pattern of (ell_idx, row_nnz, is_sparse).
    bf16 launches the union kernel under ``d2h_plan``; float32 the per-row
    kernel (f32 products exactly). Either launches or raises."""
    global _D2H
    m, k = x.shape
    n, e = wt.shape[0], ell_idx.shape[1]
    if x.dtype not in _TYPES or wt.dtype != x.dtype:
        raise TypeError("dense_to_hybrid_cuda takes x and wt both bfloat16 "
                        "or both float32")
    _check("dense_to_hybrid_cuda", (x, wt), ell_idx, row_nnz, is_sparse,
           m, e, k)
    if wt.shape[1] != k:
        raise ValueError(f"dense_to_hybrid_cuda: wt {tuple(wt.shape)} does "
                         f"not match x {tuple(x.shape)}")
    bf16 = x.dtype == torch.bfloat16
    plan = d2h_plan(m, k, n, e, tp.sm_count(x.device)) if bf16 else None
    vals = torch.empty((m, e), dtype=torch.float32, device=x.device)
    if _D2H is None:
        P, I = build.P, build.I
        _D2H = build.bind("hybrid_matmul", "dense_to_hybrid",
                          [P, P, P, P, P, P] + [I] * 9 + [P])
    with torch.cuda.device(x.device):
        err = _D2H(x.data_ptr(), wt.data_ptr(), ell_idx.data_ptr(),
                   row_nnz.data_ptr(), is_sparse.data_ptr(), vals.data_ptr(),
                   m, e, k, n, int(bf16),
                   *((plan.splits, plan.stages, int(plan.wide), plan.smem)
                     if bf16 else (0, 0, 0, 0)),
                   build.stream_ptr(x))
    build.check(err, "dense_to_hybrid")
    build.count_launch("dense_to_hybrid")
    return vals


def _block_union(m: int, n: int, e: int) -> int:
    """The most columns the union of a row block (up to 128 rows of E
    slots) can hold: the capacity a dry run reckons K8's and K9's work at,
    since which columns the pattern holds is data."""
    return min(n, min(m, D2H_ROWS) * e)


def _shape_check(name, ts, ell_idx, row_nnz, is_sparse, m, e, k):
    if ell_idx.dtype != torch.int32 or row_nnz.dtype != torch.int32 or \
            is_sparse.dtype != torch.bool:
        raise TypeError(f"{name} takes int32 indices and counts and a bool "
                        "is_sparse")
    if any(t.dtype not in _TYPES for t in ts):
        raise TypeError(f"{name} takes bfloat16 or float32 operands")
    if ell_idx.shape != (m, e) or row_nnz.shape != (m,) or \
            is_sparse.shape != (m,) or k % 8 or m < 1 or not 1 <= e <= 1024:
        raise ValueError(f"{name}: unsupported shapes (M {m}, E {e}, K {k})")


def hybrid_to_dense_shape(ell_vals, ell_idx, row_nnz, is_sparse, w):
    """What ``hybrid_to_dense_cuda`` returns, without a launch: y (M, K)
    float32 on W's device, or its refusal of the shapes (``h2d_plan`` at
    the H100's SM count, bf16 W). For tensors without data. Work reported
    at the union's capacity U = min(N, min(M, 128) E) a row block, the union
    kernel's (bf16 W): 2 M U K FLOPs; the per-row kernel's (f32 W) 2 M E
    K. Bytes: the slots and U rows of W read once, y written once."""
    m, e = ell_vals.shape
    n, k = w.shape
    _shape_check("hybrid_to_dense", (ell_vals, w), ell_idx, row_nnz,
                 is_sparse, m, e, k)
    bf16 = w.dtype == torch.bfloat16
    if bf16:
        h2d_plan(m, k, n, e, accounting.H100_SMS,
                 1 if ell_vals.dtype == torch.bfloat16 else 2)
    u = _block_union(m, n, e)
    y = torch.empty((m, k), dtype=torch.float32, device=w.device)
    build.report_work("hybrid_to_dense", 2 * m * (u if bf16 else e) * k,
                      build.nbytes(ell_vals, ell_idx, row_nnz, is_sparse, y)
                      + u * k * w.element_size())
    return y


def dense_to_hybrid_shape(x, wt, ell_idx, row_nnz, is_sparse):
    """What ``dense_to_hybrid_cuda`` returns, without a launch: vals (M, E)
    float32 on x's device, or its refusal of the shapes (``d2h_plan`` at
    the H100's SM count, bf16). For tensors without data. Work reported at the
    union's capacity U = min(N, min(M, 128) E) a row block, the union
    kernel's (bf16): 2 M U K FLOPs; the per-row kernel's (f32) 2 M E K.
    Bytes: x, the pattern and U rows of W^T read once, vals written
    once."""
    m, k = x.shape
    n, e = wt.shape[0], ell_idx.shape[1]
    _shape_check("dense_to_hybrid", (x, wt), ell_idx, row_nnz, is_sparse,
                 m, e, k)
    if wt.dtype != x.dtype or wt.shape[1] != k:
        raise ValueError(f"dense_to_hybrid: wt {tuple(wt.shape)} "
                         f"{wt.dtype} for x {tuple(x.shape)} {x.dtype}")
    bf16 = x.dtype == torch.bfloat16
    if bf16:
        d2h_plan(m, k, n, e, accounting.H100_SMS)
    u = _block_union(m, n, e)
    vals = torch.empty((m, e), dtype=torch.float32, device=x.device)
    build.report_work("dense_to_hybrid", 2 * m * (u if bf16 else e) * k,
                      build.nbytes(x, ell_idx, row_nnz, is_sparse, vals)
                      + u * k * wt.element_size())
    return vals
