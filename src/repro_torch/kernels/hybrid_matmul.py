"""K8 and K9: the ELL side of the hybrid format's products (paper Sec. 3.5).

K8, ``y = h @ W`` with h in the hybrid format: ``hybrid_to_dense_cuda``
launches ``csrc/hybrid_matmul.cu``, the Hopper counterpart of
``repro/kernels/hybrid_matmul.py:hybrid_to_dense_pallas``;
``hybrid_to_dense_plain`` is the same function in plain PyTorch.

K9, the SDDMM ``vals = (x @ W)[pattern]``: ``dense_to_hybrid_cuda``
launches the same source's K9 kernels, the counterpart of
``dense_to_hybrid_pallas``; ``dense_to_hybrid_plain`` beside it. In bf16
K9 is one wgmma kernel: a block of ``D2H_ROWS`` rows builds the union of its
valid slots' columns on the card, computes x's rows against that union's
W rows in chunks of ``D2H_COLS`` columns on the tensor cores and picks its
slots' values; ``d2h_plan``, a plain function of Python ints, is its launch
plan. In float32 (the float32 gradient checks) K9 is a per-row kernel on
CUDA cores, which keeps the products exact in f32.

Both cover the ELL side only: slot e of row m is valid when
``e < row_nnz[m]`` and ``is_sparse[m]``; a row in the dense backup gives 0
(K8) or all-zero slots (K9), and ``core/hybrid.py`` adds the backup rows'
dense product. Both return float32. The two kernels read W by rows: K8
takes W as (N, K), K9 takes ``wt``, W transposed, also (N, K), so a
pattern column of W is one contiguous row.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import List, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels import twell_pack as tp

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


@dataclasses.dataclass(frozen=True)
class D2hPlan:
    splits: int              # S: blocks a row block; block s takes chunks
    #                          s, s + S, ... of its union
    stages: int              # depth of the cp.async ring
    row_blocks: int
    max_chunks: int          # chunks of the largest union a block can meet,
    #                          min(N, min(M, D2H_ROWS) x E) columns
    smem: int                # dynamic shared memory of a block (bytes)

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


def d2h_smem(n: int, stages: int) -> int:
    """K9's dynamic shared memory (``d2h_smem`` of the kernel): 1 KB of
    alignment slack, the ring (``stages`` of 128 rows of x and 128 Wt
    rows, 64 of K each, bf16; the staged f32 accumulators alias it), the
    union's columns (n ints), the bitmap and its prefix (an int each per
    32 columns), the byte map (32 bytes per 32 columns), the rows' valid
    slot counts and the union's size."""
    tp.check_ints(n, stages)
    words = tp.cdiv(n, 32)
    return (1024 + stages * D2H_STAGE_BYTES + 4 * n + 40 * words
            + 4 * D2H_ROWS + 16)


@functools.lru_cache(maxsize=None, typed=True)
def d2h_plan(m: int, k: int, n: int, e: int, sms: int) -> D2hPlan:
    """``sms``: the card's streaming multiprocessors. S as many splits as
    keep row blocks x S within one block an SM, at most the chunks of the
    largest union a block can meet, min(N, min(M, D2H_ROWS) x E) columns
    (at M 8192, 64 row blocks: S = 2); the deepest ring that fits the shared
    memory beside the N-sized maps. Never reads the pattern: the union is
    found on the card. Raises ValueError when no ring fits beside the maps
    (too large an N). Cached: a training step calls it twice a layer."""
    tp.check_ints(m, k, n, e, sms)
    if min(m, k, n, e, sms) < 1:
        raise ValueError(f"d2h_plan: unsupported M {m}, K {k}, N {n}, E {e}")
    row_blocks = tp.cdiv(m, D2H_ROWS)
    max_chunks = tp.cdiv(min(n, min(m, D2H_ROWS) * e), D2H_COLS)
    splits = max(1, min(max_chunks, sms // row_blocks))
    fit = [st for st in D2H_STAGES if d2h_smem(n, st) <= tp.SMEM_BYTES]
    if not fit:
        raise ValueError(f"d2h_plan: N {n} is too wide: its maps and a ring "
                         f"of {D2H_STAGES[0]} stages take "
                         f"{d2h_smem(n, D2H_STAGES[0])} bytes of shared "
                         f"memory, over {tp.SMEM_BYTES}")
    return D2hPlan(splits, fit[-1], row_blocks, max_chunks,
                   d2h_smem(n, fit[-1]))


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
    """ell_vals (M, E) bf16 or f32 (widened to f32, exactly), w (N, K) bf16
    or f32 on the card -> y (M, K) float32."""
    global _H2D
    m, e = ell_vals.shape
    n, k = w.shape
    if ell_vals.dtype not in _TYPES or w.dtype not in _TYPES:
        raise TypeError("hybrid_to_dense_cuda takes bfloat16 or float32 "
                        "values and weights")
    vals = ell_vals.float().contiguous()
    _check("hybrid_to_dense_cuda", (vals, w), ell_idx, row_nnz, is_sparse,
           m, e, k)
    y = torch.empty((m, k), dtype=torch.float32, device=w.device)
    if _H2D is None:
        P, I = build.P, build.I
        _H2D = build.bind("hybrid_matmul", "hybrid_to_dense",
                          [P, P, P, P, P, P, I, I, I, I, P])
    with torch.cuda.device(w.device):
        err = _H2D(vals.data_ptr(), ell_idx.data_ptr(), row_nnz.data_ptr(),
                   is_sparse.data_ptr(), w.data_ptr(), y.data_ptr(), m, e, k,
                   int(w.dtype == torch.bfloat16), build.stream_ptr(w))
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
                          [P, P, P, P, P, P] + [I] * 8 + [P])
    with torch.cuda.device(x.device):
        err = _D2H(x.data_ptr(), wt.data_ptr(), ell_idx.data_ptr(),
                   row_nnz.data_ptr(), is_sparse.data_ptr(), vals.data_ptr(),
                   m, e, k, n, int(bf16),
                   *((plan.splits, plan.stages, plan.smem) if bf16
                     else (0, 0, 0)),
                   build.stream_ptr(x))
    build.check(err, "dense_to_hybrid")
    build.count_launch("dense_to_hybrid")
    return vals
