"""Public kernel entry points, dispatched by the device of their inputs.

A CPU tensor takes the kernel's plain PyTorch version; a CUDA tensor
launches the hand-written Hopper kernel, or raises. There is no mode
switch and no fallback from a failed build or launch to the plain
version. (The JAX package's ``repro/kernels/ops.py`` picks between its
Pallas kernels and their references by platform and an environment
variable; the port has neither.)

``twell_gate_matmul`` applies the TwELL overflow contract of
``repro/kernels/ops.py:29-40``: the kernel's exact per-tile counts are
clipped to T/C and the overflow flag is raised when any tile exceeded it.
Each call ORs its flag into ``OverflowLog`` (a device flag, read without a
sync until ``OverflowLog.seen()``); the hybrid training format's pack
(``core/hybrid.py``) ORs its backup-overflow flag into ``HybridOverflowLog``
the same way.

``twell_down_proj`` is the non-gated down projection from the packed
activations (K6, float32 in the kernel, returned in W_d's type).
``hybrid_to_dense`` and ``dense_to_hybrid`` are the ELL sides of the hybrid
products (K8, K9; float32 out); ``flash_attention`` is causal attention
with its gradient (K7 forward).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.core import twell
from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import FlashAttention
from repro_torch.kernels.hybrid_matmul import (dense_to_hybrid_cuda,
                                               dense_to_hybrid_plain,
                                               hybrid_to_dense_cuda,
                                               hybrid_to_dense_plain)
from repro_torch.kernels.paged_chunk_attention import (
    paged_chunk_attention_cuda, paged_chunk_attention_plain)
from repro_torch.kernels.paged_decode_attention import (
    paged_decode_attention_cuda, paged_decode_attention_plain)
from repro_torch.kernels.sparse_ffn import (tile_skip_ffn_cuda,
                                            tile_skip_ffn_plain,
                                            twell_down_proj_cuda,
                                            twell_down_proj_plain,
                                            twell_fused_ffn_cuda,
                                            twell_fused_ffn_plain)
from repro_torch.kernels.twell_pack import (twell_gate_matmul_cuda,
                                            twell_gate_matmul_plain)


class OverflowLog:
    """Whether any TwELL gate tile overflowed its T/C slots since the last
    ``reset()``. The flag stays on the device: recording costs no sync."""

    _flag: Optional[torch.Tensor] = None

    @classmethod
    def record(cls, overflow: torch.Tensor) -> None:
        if cls._flag is None or cls._flag.device != overflow.device:
            cls._flag = overflow.clone()
        else:
            cls._flag |= overflow

    @classmethod
    def seen(cls) -> bool:
        return bool(cls._flag) if cls._flag is not None else False

    @classmethod
    def reset(cls) -> None:
        cls._flag = None


class HybridOverflowLog(OverflowLog):
    """Whether any hybrid pack ran out of dense-backup rows (its overflowing
    rows were dropped, App. B.2.1) since the last ``reset()``, and how many
    rows the packs put on each side of the format. Counts and flag stay on
    the device until read."""

    _flag: Optional[torch.Tensor] = None
    _rows: Optional[torch.Tensor] = None     # (ELL rows, backup rows)

    @classmethod
    def record(cls, overflow: torch.Tensor, is_dense: torch.Tensor) -> None:
        super().record(overflow)
        rows = torch.stack([(~is_dense).sum(), is_dense.sum()])
        if cls._rows is None or cls._rows.device != rows.device:
            cls._rows = rows
        else:
            cls._rows += rows

    @classmethod
    def rows(cls) -> Tuple[int, int]:
        """(ELL rows, dense-backup rows) summed over the packs since the
        last ``reset()``; rows dropped by an overflow count as backup."""
        if cls._rows is None:
            return 0, 0
        ell, dense = cls._rows.tolist()
        return ell, dense

    @classmethod
    def reset(cls) -> None:
        cls._flag = None
        cls._rows = None


def launch_counts() -> Dict[str, int]:
    """Kernel launches per kernel since ``reset_launch_counts()``."""
    return dict(build.LAUNCHES)


def reset_launch_counts() -> None:
    build.reset_launches()


def twell_gate_matmul(x, w, tile: int, compression: int, act: str = "relu"
                      ) -> twell.TwellActs:
    fn = twell_gate_matmul_cuda if x.is_cuda else twell_gate_matmul_plain
    vals, idx, nnz = fn(x, w, tile, compression, act)
    tc = tile // compression
    overflow = (nnz > tc).any()
    OverflowLog.record(overflow)
    return twell.TwellActs(vals, idx, torch.clamp(nnz, max=tc), overflow,
                           tile, compression, w.shape[1])


def twell_fused_ffn(x, tw: twell.TwellActs, wu_t, wd):
    """y = Eq. 3 from the packed gate; ``wu_t`` is W_u transposed (N, K)."""
    if x.is_cuda:
        return twell_fused_ffn_cuda(x, tw, wu_t, wd).to(x.dtype)
    return twell_fused_ffn_plain(x, tw, wu_t, wd)


def twell_down_proj(tw: twell.TwellActs, wd):
    """Non-gated y = unpack(h) @ W_d from the packed activations (App.
    C.2), in W_d's type; ``tw.nnz`` is the count ``twell_gate_matmul``
    already clipped to T/C."""
    fn = twell_down_proj_cuda if wd.is_cuda else twell_down_proj_plain
    return fn(tw.values, tw.indices, tw.nnz, wd, tw.tile).to(wd.dtype)


def tile_skip_ffn(x, wg, wu, wd, tile: int, act: str = "relu",
                  threshold: float = 0.0):
    """Gated FFN with (row block x tile) skipping -> (y in x.dtype, h).
    The kernel takes the threshold itself: the JAX package sends
    ``threshold > 0`` to its reference, which computes the same function."""
    fn = tile_skip_ffn_cuda if x.is_cuda else tile_skip_ffn_plain
    y, h = fn(x, wg, wu, wd, tile, act, threshold)
    return y.to(x.dtype), h


def paged_attention_decode(q, kpool, vpool, block_tables, seq_lens):
    fn = paged_decode_attention_cuda if q.is_cuda \
        else paged_decode_attention_plain
    return fn(q, kpool, vpool, block_tables, seq_lens)


def paged_attention_extend(q, kpool, vpool, block_tables, seq_lens, num_new):
    fn = paged_chunk_attention_cuda if q.is_cuda \
        else paged_chunk_attention_plain
    return fn(q, kpool, vpool, block_tables, seq_lens, num_new)


def flash_attention(q, k, v):
    """Causal attention, (B, S, H, hd) each with one H, differentiable."""
    return FlashAttention.apply(q, k, v)


def hybrid_to_dense(ell_vals, ell_idx, row_nnz, is_sparse, w):
    """ELL side of ``h @ w``, w (N, K) -> (M, K) float32."""
    fn = hybrid_to_dense_cuda if w.is_cuda else hybrid_to_dense_plain
    return fn(ell_vals, ell_idx, row_nnz, is_sparse, w)


def dense_to_hybrid(x, wt, ell_idx, row_nnz, is_sparse):
    """ELL side of ``(x @ W)[pattern]`` with W given as wt (N, K) ->
    (M, E) float32."""
    fn = dense_to_hybrid_cuda if x.is_cuda else dense_to_hybrid_plain
    return fn(x, wt, ell_idx, row_nnz, is_sparse)
