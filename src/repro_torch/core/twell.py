"""TwELL — Tile-wise ELLPACK (paper Sec. 3.2), plain PyTorch semantics.

An ``(M, N)`` activation matrix is divided into horizontal 1-D tiles of width
``T``; within each tile the non-zero values and their *global* column indices
are compacted to the start of a ``T/C``-wide slot (compression ratio ``C``).
A per-tile non-zero count ``nnz`` (shape ``(M, N_T)``) completes the format.

These functions are the contract the gate-matmul kernel
(``repro_torch/kernels/csrc/twell_pack.cu``) reproduces, and they match
``repro.core.twell`` exactly: stable in-tile column order, ``nnz`` clipped to
``T/C``, and an overflow flag raised when a tile holds more than ``T/C``
non-zeros (the excess is dropped, paper App. B.2.1).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch


class TwellActs(NamedTuple):
    values: torch.Tensor    # (M, N/C)  packed non-zero values, tile-locally aligned
    indices: torch.Tensor   # (M, N/C)  int32 global column indices (0 where invalid)
    nnz: torch.Tensor       # (M, N_T)  int32 per-tile non-zero counts (clipped to T/C)
    overflow: torch.Tensor  # ()        bool: any tile exceeded T/C slots
    tile: int
    compression: int
    n: int                  # original N

    @property
    def n_tiles(self) -> int:
        return self.n // self.tile

    @property
    def slot_width(self) -> int:
        return self.tile // self.compression


def _tile_base(nt: int, tile: int, device) -> torch.Tensor:
    return (torch.arange(nt, dtype=torch.int32, device=device) * tile)[None, :, None]


def pack(h: torch.Tensor, tile: int, compression: int,
         mask: Optional[torch.Tensor] = None) -> TwellActs:
    """Pack a dense (M, N) matrix into TwELL (Algorithm 1 epilogue semantics)."""
    m, n = h.shape
    assert n % tile == 0, f"N={n} not divisible by tile T={tile}"
    assert tile % compression == 0
    nt, tc = n // tile, tile // compression
    if mask is None:
        mask = h != 0
    ht = h.reshape(m, nt, tile)
    mt = mask.reshape(m, nt, tile)
    # a stable sort moves non-zero positions (key 0) before zeros (key 1),
    # keeping column order inside the tile -- the kernel's ballot order
    order = torch.sort(torch.where(mt, 0, 1).to(torch.int8), dim=-1,
                       stable=True).indices
    first = order[..., :tc]                                      # (M, NT, T/C)
    vals = torch.gather(ht, -1, first)
    taken_valid = torch.gather(mt, -1, first)
    counts = mt.sum(dim=-1, dtype=torch.int32)                   # (M, NT)
    overflow = (counts > tc).any()
    slot = torch.arange(tc, dtype=torch.int32, device=h.device)
    valid = taken_valid & (slot[None, None, :] < counts[..., None])
    vals = torch.where(valid, vals, torch.zeros((), dtype=h.dtype,
                                                device=h.device))
    gidx = first.to(torch.int32) + _tile_base(nt, tile, h.device)
    gidx = torch.where(valid, gidx, torch.zeros_like(gidx))
    return TwellActs(vals.reshape(m, nt * tc), gidx.reshape(m, nt * tc),
                     torch.clamp(counts, max=tc), overflow, tile,
                     compression, n)


def slot_valid(tw: TwellActs) -> torch.Tensor:
    """(M, N/C) bool: slot ``s`` of tile ``t`` holds a value (s < nnz[t])."""
    tc = tw.slot_width
    slot = torch.arange(tw.values.shape[1], dtype=torch.int32,
                        device=tw.values.device) % tc
    return slot[None, :] < torch.repeat_interleave(tw.nnz, tc, dim=-1)


def unpack(tw: TwellActs) -> torch.Tensor:
    """Scatter TwELL back to a dense (M, N) matrix."""
    m = tw.values.shape[0]
    nt, tc = tw.n_tiles, tw.slot_width
    vals = tw.values.reshape(m, nt, tc)
    idx = tw.indices.reshape(m, nt, tc) - _tile_base(nt, tw.tile,
                                                     tw.values.device)
    slot = torch.arange(tc, dtype=torch.int32, device=tw.values.device)
    valid = slot[None, None, :] < tw.nnz[..., None]
    vals = torch.where(valid, vals, torch.zeros_like(vals))
    idx = torch.clamp(idx, 0, tw.tile - 1).long()
    dense = torch.zeros((m, nt, tw.tile), dtype=tw.values.dtype,
                        device=tw.values.device)
    dense.scatter_add_(-1, idx, vals)
    return dense.reshape(m, tw.n)


def nnz_per_row(tw: TwellActs) -> torch.Tensor:
    return tw.nnz.sum(dim=-1)


def fused_ffn_reference(x: torch.Tensor, tw: TwellActs, w_u: torch.Tensor,
                        w_d: torch.Tensor) -> torch.Tensor:
    """Eq. 3 — fused up+down projection from TwELL gate activations.

    y[m,:] = sum_c h_v[m,c] * (x[m,:] . W_u[:, n_c]) * W_d[n_c, :]

    Gathers full weight rows/columns (an (M, N/C, K) tensor); the kernel
    avoids the materialization. Numerically ``(hu * unpack(tw)) @ w_d``.
    """
    vals = torch.where(slot_valid(tw), tw.values,
                       torch.zeros_like(tw.values))
    idx = tw.indices.long()
    wu_cols = w_u.t()[idx]                               # (M, N/C, K)
    hu = torch.einsum("mk,mck->mc", x, wu_cols)          # sparse h_u elements
    contrib = (vals * hu)[..., None] * w_d[idx]          # (M, N/C, K)
    return contrib.sum(dim=1).to(x.dtype)
