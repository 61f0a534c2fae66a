"""Hybrid sparse format for training (paper Sec. 3.4), as
``repro/core/hybrid.py`` defines it.

Rows (tokens) whose non-zero count fits the narrow ELL width go into
fixed-width ELL arrays, the first ``E`` non-zeros of the row in column
order; rows that overflow go to a pre-allocated dense backup of ``M_d``
rows. All shapes are static, with the overflow-flag contract of App. B.2.1:
when more rows overflow than the backup holds, the excess rows are dropped
and ``overflow`` is set (the flag is ORed into ``ops.HybridOverflowLog``
without a sync).

The two products route their ELL side through ``kernels/ops.py`` (kernels
K8 and K9 on the card) and the dense-backup rows through ``torch.matmul``
(the paper's tensor-core branch of Algorithm 3). ``pack``, ``unpack`` and
``elementwise`` and ``transpose`` are plain torch: no TPU kernel computes
them.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels import ops


class HybridActs(NamedTuple):
    ell_values: torch.Tensor   # (M, E)
    ell_indices: torch.Tensor  # (M, E) int32 column indices (0 where invalid)
    row_nnz: torch.Tensor      # (M,) int32 true per-row counts
    is_dense: torch.Tensor     # (M,) bool: the row lives in the dense backup
    dense_rows: torch.Tensor   # (M_d, N) dense backup
    dense_map: torch.Tensor    # (M_d,) int32 source row ids (-1 = empty)
    overflow: torch.Tensor     # () bool: ran out of backup rows
    n: int

    @property
    def ell_width(self) -> int:
        return self.ell_values.shape[1]


def pack(h: torch.Tensor, ell_width: int, num_dense_rows: int,
         mask: torch.Tensor | None = None) -> HybridActs:
    """Partition the rows of (M, N) ``h`` into narrow ELL + dense backup.
    The ELL slots of a row are its first ``ell_width`` non-zeros in column
    order (the stable compaction of the JAX package's argsort); the backup
    takes the overflowing rows in row order."""
    m, n = h.shape
    dev = h.device
    if mask is None:
        mask = h != 0
    row_nnz = mask.sum(-1, dtype=torch.int32)
    is_dense = row_nnz > ell_width

    # ELL side: slot = rank of the column among the row's non-zeros; slots
    # past the width (and every slot of a dense row) go to a dropped column
    rank = torch.cumsum(mask, dim=-1, dtype=torch.int32) - 1
    keep = mask & (rank < ell_width) & ~is_dense[:, None]
    slot = torch.where(keep, rank, torch.full((), ell_width, device=dev,
                                              dtype=torch.int32)).long()
    cols = torch.arange(n, dtype=torch.int32, device=dev).expand(m, n)
    ell_indices = torch.zeros((m, ell_width + 1), dtype=torch.int32,
                              device=dev).scatter_(1, slot, cols)
    ell_values = torch.zeros((m, ell_width + 1), dtype=h.dtype,
                             device=dev).scatter_(1, slot, h)
    ell_indices = ell_indices[:, :ell_width].contiguous()
    ell_values = ell_values[:, :ell_width].contiguous()

    # dense backup: the overflowing rows, in order, into the backup slots
    slot_id = torch.cumsum(is_dense, dim=0, dtype=torch.int32) - 1
    fits = is_dense & (slot_id < num_dense_rows)
    overflow = (is_dense & (slot_id >= num_dense_rows)).any()
    tgt = torch.where(fits, slot_id,
                      torch.full((), num_dense_rows, device=dev,
                                 dtype=torch.int32)).long()
    src = torch.where(fits, torch.arange(m, dtype=torch.int32, device=dev),
                      torch.full((), -1, device=dev, dtype=torch.int32))
    dense_map = torch.full((num_dense_rows + 1,), -1, dtype=torch.int32,
                           device=dev).scatter_(0, tgt, src)[:num_dense_rows]
    ok = dense_map >= 0
    rows = torch.where(mask, h, torch.zeros((), dtype=h.dtype, device=dev))[
        dense_map.clamp(min=0).long()]
    dense_rows = torch.where(ok[:, None], rows,
                             torch.zeros((), dtype=h.dtype, device=dev))
    ops.HybridOverflowLog.record(overflow, is_dense)
    return HybridActs(ell_values, ell_indices, row_nnz, is_dense,
                      dense_rows, dense_map, overflow, n)


def _slot_valid(hy: HybridActs) -> torch.Tensor:
    slot = torch.arange(hy.ell_width, device=hy.row_nnz.device)
    return (slot[None, :] < hy.row_nnz[:, None]) & ~hy.is_dense[:, None]


def _scatter_rows(y: torch.Tensor, hy: HybridActs, rows: torch.Tensor
                  ) -> torch.Tensor:
    """y with the backup's rows (``rows``, (M_d, ...)) added at their source
    rows; empty backup slots add nothing."""
    ok = hy.dense_map >= 0
    tgt = torch.where(ok, hy.dense_map, torch.full_like(hy.dense_map,
                                                        y.shape[0])).long()
    pad = torch.cat([y, y.new_zeros((1,) + y.shape[1:])])
    return pad.index_add(0, tgt, torch.where(
        ok.view(-1, *([1] * (rows.dim() - 1))), rows.to(y.dtype),
        y.new_zeros(())))[:y.shape[0]]


def unpack(hy: HybridActs) -> torch.Tensor:
    """Scatter hybrid back to dense (M, N)."""
    m = hy.ell_values.shape[0]
    vals = torch.where(_slot_valid(hy), hy.ell_values,
                       torch.zeros_like(hy.ell_values))
    dense = torch.zeros((m, hy.n), dtype=hy.ell_values.dtype,
                        device=vals.device)
    dense.scatter_add_(1, hy.ell_indices.long(), vals)
    return _scatter_rows(dense, hy, hy.dense_rows)


def _dense_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b with every product exact and an f32 sum: bf16 x bf16 in the
    tensor cores' f32 accumulation, anything else in float32."""
    if a.dtype == b.dtype:
        return torch.matmul(a, b)
    return torch.matmul(a.float(), b.float())


def hybrid_to_dense_matmul(hy: HybridActs, w: torch.Tensor) -> torch.Tensor:
    """Algorithm 3: ``y = h @ w`` with h in hybrid format, w (N, K) ->
    (M, K) in w.dtype. ELL rows: kernel K8 (f32); backup rows: a dense
    matmul scattered back by ``dense_map``."""
    y = ops.hybrid_to_dense(hy.ell_values, hy.ell_indices, hy.row_nnz,
                            ~hy.is_dense, w)
    y = _scatter_rows(y, hy, _dense_mm(hy.dense_rows, w).float())
    return y.to(w.dtype)


def dense_to_hybrid_matmul(x: torch.Tensor, wt: torch.Tensor,
                           pattern: HybridActs) -> HybridActs:
    """Listing 5: only the entries of ``x @ W`` that ``pattern`` selects,
    with W given transposed, ``wt`` (N, K). Returns ``pattern`` with its
    values replaced, in wt.dtype: kernel K9 for the ELL side, a dense matmul
    of the backup rows' sources masked to the backup's non-zeros."""
    vals = ops.dense_to_hybrid(x, wt, pattern.ell_indices, pattern.row_nnz,
                               ~pattern.is_dense).to(wt.dtype)
    ok = pattern.dense_map >= 0
    xd = torch.where(ok[:, None], x[pattern.dense_map.clamp(min=0).long()],
                     torch.zeros((), dtype=x.dtype, device=x.device))
    dense_vals = torch.where(pattern.dense_rows != 0,
                             _dense_mm(xd, wt.t()).float(),
                             torch.zeros((), device=x.device))
    return pattern._replace(ell_values=vals,
                            dense_rows=dense_vals.to(wt.dtype))


def transpose(hy: HybridActs, m_rows: int, ell_width: int,
              num_dense_rows: int) -> HybridActs:
    """Listing 7 reference: hybrid -> dense -> transpose -> hybrid, the
    (N, M) transpose packed at ``ell_width`` with ``num_dense_rows`` backup
    rows. ``m_rows`` is the rows of ``hy`` (the signature of
    ``repro/core/hybrid.py:transpose``; the shapes carry it)."""
    del m_rows
    return pack(unpack(hy).t().contiguous(), ell_width, num_dense_rows)


def elementwise(hy: HybridActs, other_vals_ell: torch.Tensor,
                other_dense: torch.Tensor, op) -> HybridActs:
    """Apply an elementwise op on the shared sparsity pattern."""
    return hy._replace(ell_values=op(hy.ell_values, other_vals_ell),
                       dense_rows=op(hy.dense_rows, other_dense))


def memory_bytes(hy: HybridActs) -> int:
    """Static storage cost of the packed representation."""
    return sum(a.numel() * a.element_size()
               for a in (hy.ell_values, hy.ell_indices, hy.row_nnz,
                         hy.is_dense, hy.dense_rows, hy.dense_map))
