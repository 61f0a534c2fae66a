"""K1: gate matmul + activation + TwELL pack (paper Algorithm 1).

``twell_gate_matmul_cuda`` launches ``csrc/twell_pack.cu``, the Hopper
counterpart of ``repro/kernels/twell_pack.py:twell_gate_matmul_pallas``;
``twell_gate_matmul_plain`` is the same function in plain PyTorch
(``repro/kernels/ref.py:twell_gate_matmul``);
``twell_gate_matmul_shape`` stands in for the launch on tensors without
data. All return ``(values, indices, nnz)`` with the exact, unclipped
per-tile ``nnz``: the caller (``kernels/ops.py``) clips it and raises the
overflow flag.

``gate_plan`` is the kernel's launch plan, a plain function of Python ints
(the shapes and the card's SM count) that never reads a tensor. The kernel
computes D^T = W_tile^T x^T on wgmma: a T-column tile of W is wgmma's M
(T/64 slabs of 64), a block's rows of x its N, M rounded up to one of
``GATE_WIDTHS`` (at most 128 rows a block, further row blocks in the grid).
The K loop, in ``GATE_BK``-deep stages, is split over a cluster of ``ks``
blocks (at most 8, the portable cluster size, and no more than the K
stages), as many as keep the grid to one wave: at most one block an SM and
every cluster resident at once (``resident_clusters``). Each rank then
packs its share of the block's rows (``pack_rows``). The ring holds 3
stages where two blocks share an SM (``blocks_per_sm``: decode and verify
widths), else up to ``MAX_STAGES``.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Callable, List, Optional, Tuple

import torch

from repro_torch.core import twell
from repro_torch.core.sparsity import activation
from repro_torch.kernels import build
from repro_torch.observability import accounting

_ACTS = {"relu": 0, "relu2": 1}
_FN = None

GATE_TILES = (64, 128, 256)
GATE_WIDTHS = (8, 16, 32, 64, 128)
GATE_BK = 64
MAX_KS = 8
MIN_STAGES = 3
MAX_STAGES = 4                 # a deeper ring measured no faster
SMEM_BYTES = 232448            # shared memory a block can use (H100)
SM_SMEM_BYTES = 233472         # shared memory of one SM (H100)
PAIR_WIDTH = 32                # the widest block two of which share an SM


def check_ints(*xs) -> None:
    """Launch plans take Python ints (shapes), never tensors."""
    for x in xs:
        if type(x) is not int:
            raise TypeError(f"launch plans take Python ints (shapes), got "
                            f"{type(x).__name__}")


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def splits(count: int, ks: int) -> List[Tuple[int, int]]:
    """[lo, hi) of ``count`` items (K stages, rows) each of ``ks`` ranks
    takes, in rank order; a split may be empty (that rank adds zeros)."""
    return [(r * count // ks, (r + 1) * count // ks) for r in range(ks)]


@functools.lru_cache(maxsize=None)
def sm_count(device: torch.device) -> int:
    """The card's streaming multiprocessors, read once a device: the
    serving path is host-bound and every launch plan needs it."""
    return torch.cuda.get_device_properties(device).multi_processor_count


@dataclasses.dataclass(frozen=True)
class GatePlan:
    width: int               # wgmma N: rows of x a block (M rounded up)
    row_blocks: int          # blocks along M
    ks: int                  # blocks a cluster, splitting the K loop
    stages: int              # depth of the TMA ring
    k_stages: int            # GATE_BK-deep stages of the whole K loop
    grid: Tuple[int, int]    # (tiles x ks, row blocks)

    @property
    def blocks(self) -> int:
        return self.grid[0] * self.grid[1]

    def k_splits(self) -> List[Tuple[int, int]]:
        """[lo, hi) of the K stages each rank of a cluster takes."""
        return splits(self.k_stages, self.ks)

    def pack_rows(self, valid: int) -> List[Tuple[int, int]]:
        """[lo, hi) of a block's ``valid`` rows each rank sums and packs."""
        return splits(valid, self.ks)


def stage_bytes(tile: int, width: int) -> int:
    """One ring stage: the W box (64 columns x 64 k) tile/64 times and the
    x box (64 k x width rows), bf16."""
    return (tile // 64) * GATE_BK * 128 + width * 128


def block_smem(tile: int, width: int, stages: int) -> int:
    """Dynamic shared memory of a block: 1 KB of alignment slack, the ring
    (the f32 partial tile is aliased over it) and two mbarriers a stage."""
    return 1024 + stages * (stage_bytes(tile, width) + 16)


def ring_plan(smem: Callable[[int], int], width: int, cap: int
              ) -> Tuple[int, Optional[int]]:
    """(blocks an SM, ring depth) of a wgmma block of ``width`` rows whose
    dynamic shared memory is ``smem(depth)``: two blocks with a ring of
    MIN_STAGES where two fit one SM's shared memory (each also takes 1 KB
    reserved by the system) at a width whose accumulators leave registers
    for two (the kernels' launch bounds ask for two blocks an SM up to
    PAIR_WIDTH); else one block with a ring as deep as MAX_STAGES, the
    shared memory and ``cap`` (the stages of the loop) allow. Depth None:
    no ring fits. K1's and K5's plans both use it."""
    if width <= PAIR_WIDTH and \
            2 * (smem(MIN_STAGES) + 1024) <= SM_SMEM_BYTES:
        return 2, MIN_STAGES
    fit = [st for st in range(MIN_STAGES, MAX_STAGES + 1)
           if smem(st) <= SMEM_BYTES]
    return 1, (max(MIN_STAGES, min(fit[-1], cap)) if fit else None)


def blocks_per_sm(tile: int, width: int) -> int:
    """K1's blocks an SM at (tile, width), from ``ring_plan``."""
    return ring_plan(lambda st: block_smem(tile, width, st), width,
                     MIN_STAGES)[0]


def resident_clusters(ks: int, per_sm: int, sms: int) -> int:
    """The clusters of ``ks`` blocks the plan counts on holding at once. A
    cluster sits inside one GPC: clusters of 1 or 2 blocks (a TPC is two
    SMs) fill the card, wider ones leave SMs of a GPC over, and the plan
    counts 3/4 of the block slots for them. The CUDA runtime's own count
    (cudaOccupancyMaxActiveClusters, ``gate_resident_clusters``) was 77-91%
    of the slots for clusters of 3-8 on the H100."""
    check_ints(ks, per_sm, sms)
    slots = sms * per_sm
    return slots // ks if ks <= 2 else slots * 3 // (4 * ks)


def one_wave(clusters: int, ks: int, per_sm: int, sms: int) -> bool:
    """Whether ``clusters`` clusters of ``ks`` blocks take at most one
    block an SM and are all resident at once (``resident_clusters``)."""
    return clusters * ks <= sms and \
        clusters <= resident_clusters(ks, per_sm, sms)


def widest_cluster(clusters: int, stages: int, per_sm: int, sms: int) -> int:
    """The widest cluster (at most MAX_KS and ``stages``, the loop's
    stages it splits) that keeps ``clusters`` to ``one_wave``; else 1."""
    return max([1] + [c for c in range(1, min(MAX_KS, stages) + 1)
                      if one_wave(clusters, c, per_sm, sms)])


@functools.lru_cache(maxsize=None, typed=True)
def gate_plan(m: int, k: int, n: int, tile: int, sms: int) -> GatePlan:
    """``sms``: the card's streaming multiprocessors. The cluster is as
    wide as keeps the grid to one block an SM with every cluster resident
    at once (``resident_clusters``): tiles x row blocks x ks <= sms.
    Cached: the serving path is host-bound and calls it every launch with
    a few shapes."""
    check_ints(m, k, n, tile, sms)
    if tile not in GATE_TILES or min(m, k, n, sms) < 1 or n % tile:
        raise ValueError(f"gate_plan: unsupported M {m}, K {k}, N {n}, "
                         f"tile {tile}")
    width = next(w for w in GATE_WIDTHS if w >= min(m, GATE_WIDTHS[-1]))
    row_blocks = cdiv(m, width)
    k_stages = cdiv(k, GATE_BK)
    base = n // tile * row_blocks              # clusters
    per_sm, stages = ring_plan(lambda st: block_smem(tile, width, st), width,
                               k_stages)
    ks = widest_cluster(base, k_stages, per_sm, sms)
    return GatePlan(width, row_blocks, ks, stages, k_stages,
                    (n // tile * ks, row_blocks))


def gate_resident_clusters(tile: int, plan: GatePlan) -> int:
    """The CUDA runtime's count of the plan's clusters the current card
    holds at once (tile 256 only). For measuring plans; the kernel path never calls
    it."""
    fn = build.bind("twell_pack", "twell_gate_resident_clusters",
                    [build.I] * 4 + [build.P])
    held = ctypes.c_int(0)
    build.check(fn(tile, plan.width, plan.ks, plan.stages,
                   ctypes.addressof(held)), "twell_gate_resident_clusters")
    return held.value


def twell_gate_matmul_plain(x: torch.Tensor, w: torch.Tensor, tile: int,
                            compression: int, act: str = "relu"
                            ) -> Tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]:
    """h = act(x @ w) (f32 accumulation, cast to x.dtype), pattern h > 0,
    packed to TwELL; nnz is the exact count per tile."""
    h = activation(act)(torch.matmul(x.float(), w.float())).to(x.dtype)
    mask = h > 0
    tw = twell.pack(h, tile, compression, mask=mask)
    m, n = h.shape
    nnz = mask.reshape(m, n // tile, tile).sum(dim=-1, dtype=torch.int32)
    return tw.values, tw.indices, nnz


def twell_gate_matmul_cuda(x: torch.Tensor, w: torch.Tensor, tile: int,
                           compression: int, act: str = "relu"
                           ) -> Tuple[torch.Tensor, torch.Tensor,
                                      torch.Tensor]:
    """x (M, K) bf16, w (K, N) bf16 on the card -> (values (M, N/C) bf16,
    indices (M, N/C) int32, nnz (M, N/T) int32, exact)."""
    global _FN
    m, k = x.shape
    k2, n = w.shape
    if not (x.is_cuda and w.is_cuda and x.device == w.device):
        raise ValueError("twell_gate_matmul_cuda: x and w must be on one "
                         "CUDA device")
    if x.dtype != torch.bfloat16 or w.dtype != torch.bfloat16:
        raise TypeError(f"twell_gate_matmul_cuda takes bfloat16, got "
                        f"{x.dtype} and {w.dtype}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("twell_gate_matmul_cuda: x and w must be contiguous")
    if x.data_ptr() % 16 or w.data_ptr() % 16:
        raise ValueError("twell_gate_matmul_cuda: x and w must be 16-byte "
                         "aligned (TMA)")
    if k != k2 or k % 8 or n % tile or tile % 64 or tile > 256 or \
            tile % compression or m < 1:
        raise ValueError(
            f"twell_gate_matmul_cuda: unsupported shapes x {tuple(x.shape)} "
            f"w {tuple(w.shape)} tile {tile} C {compression} (needs "
            "K % 8 == 0, tile % 64 == 0, tile <= 256, N % tile == 0)")
    if act not in _ACTS:
        raise ValueError(f"twell_gate_matmul_cuda: activation {act!r}")
    # rows a block, the cluster's K split and the ring depth, from shapes only
    plan = gate_plan(m, k, n, tile, sm_count(x.device))
    slots = n // tile * (tile // compression)
    vals = torch.empty((m, slots), dtype=x.dtype, device=x.device)
    idx = torch.empty((m, slots), dtype=torch.int32, device=x.device)
    nnz = torch.empty((m, n // tile), dtype=torch.int32, device=x.device)
    if _FN is None:
        P, I = build.P, build.I
        _FN = build.bind("twell_pack", "twell_gate_matmul_bf16",
                         [P, P, P, P, P, I, I, I, I, I, I, I, I, I, P])
    with torch.cuda.device(x.device):
        err = _FN(x.data_ptr(), w.data_ptr(), vals.data_ptr(),
                  idx.data_ptr(), nnz.data_ptr(), m, k, n, tile, compression,
                  _ACTS[act], plan.width, plan.ks, plan.stages,
                  build.stream_ptr(x))
    build.check(err, "twell_gate_matmul")
    build.count_launch("twell_gate_matmul")
    return vals, idx, nnz


def twell_gate_matmul_shape(x: torch.Tensor, w: torch.Tensor, tile: int,
                            compression: int, act: str = "relu"
                            ) -> Tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]:
    """What ``twell_gate_matmul_cuda`` returns, without a launch: (values
    (M, N/C) x.dtype, indices (M, N/C) int32, nnz (M, N/T) int32) on x's
    device, or its refusal of the shapes (``gate_plan`` at the H100's SM
    count). For tensors without data (a dry run). Work reported: the whole gate
    product, 2 M K N FLOPs; bytes x and W read once, the three outputs
    written once."""
    m, k = x.shape
    n = w.shape[1]
    if x.dtype != torch.bfloat16 or w.dtype != torch.bfloat16:
        raise TypeError(f"twell_gate_matmul takes bfloat16, got {x.dtype} "
                        f"and {w.dtype}")
    if w.shape[0] != k or tile % compression or act not in _ACTS:
        raise ValueError(f"twell_gate_matmul: unsupported x "
                         f"{tuple(x.shape)} w {tuple(w.shape)} tile {tile} "
                         f"C {compression} act {act!r}")
    gate_plan(m, k, n, tile, accounting.H100_SMS)
    slots = n // tile * (tile // compression)
    vals = torch.empty((m, slots), dtype=x.dtype, device=x.device)
    idx = torch.empty((m, slots), dtype=torch.int32, device=x.device)
    nnz = torch.empty((m, n // tile), dtype=torch.int32, device=x.device)
    build.report_work("twell_gate_matmul", 2 * m * k * n,
                      build.nbytes(x, w, vals, idx, nnz))
    return vals, idx, nnz
