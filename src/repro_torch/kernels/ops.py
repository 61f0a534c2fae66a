"""Public kernel entry points, dispatched by the device of their inputs.

A CPU tensor takes the kernel's plain PyTorch version; a CUDA tensor
launches the hand-written Hopper kernel, or raises; a tensor without data
(a meta tensor, the dry run of ``launch/dryrun.py``, or a fake CUDA one)
takes the kernel's shape function, which returns outputs of the kernel's
shapes and dtypes and reports its work, and never reaches a build or a
launch (``build.route``). There is no mode switch and no fallback from a
failed build or launch to the plain version. (The JAX package's
``repro/kernels/ops.py`` picks between its Pallas kernels and their
references by platform and an environment variable; the port has
neither.)

``twell_gate_matmul`` applies the TwELL overflow contract of
``repro/kernels/ops.py:29-40``: the kernel's exact per-tile counts are
clipped to T/C and the overflow flag is raised when any tile exceeded it.
Each call ORs its flag into ``OverflowLog`` (a device flag, read without a
sync until ``OverflowLog.seen()``); the hybrid training format's pack
(``core/hybrid.py``) ORs its backup-overflow flag into ``HybridOverflowLog``
the same way. A flag without data (meta or fake) is not recorded: the
logs outlive the trace.

``twell_down_proj`` is the non-gated down projection from the packed
activations (K6, float32 in the kernel, returned in W_d's type).
``hybrid_to_dense`` and ``dense_to_hybrid`` are the ELL sides of the hybrid
products (K8, K9; float32 out); ``flash_attention`` is causal attention
with its gradient (K7 forward).
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch import device as device_mod
from repro_torch.core import twell
from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import FlashAttention
from repro_torch.kernels.hybrid_matmul import (dense_to_hybrid_cuda,
                                               dense_to_hybrid_plain,
                                               dense_to_hybrid_shape,
                                               hybrid_to_dense_cuda,
                                               hybrid_to_dense_plain,
                                               hybrid_to_dense_shape)
from repro_torch.kernels.paged_chunk_attention import (
    paged_chunk_attention_cuda, paged_chunk_attention_plain,
    paged_chunk_attention_shape)
from repro_torch.kernels.paged_decode_attention import (
    paged_decode_attention_cuda, paged_decode_attention_plain,
    paged_decode_attention_shape)
from repro_torch.kernels.sparse_ffn import (tile_skip_ffn_cuda,
                                            tile_skip_ffn_plain,
                                            tile_skip_ffn_shape,
                                            twell_down_proj_cuda,
                                            twell_down_proj_plain,
                                            twell_down_proj_shape,
                                            twell_fused_ffn_cuda,
                                            twell_fused_ffn_plain,
                                            twell_fused_ffn_shape)
from repro_torch.kernels.twell_pack import (twell_gate_matmul_cuda,
                                            twell_gate_matmul_plain,
                                            twell_gate_matmul_shape)


class OverflowLog:
    """Whether any TwELL gate tile overflowed its T/C slots since the last
    ``reset()``. The flag stays on the device: recording costs no sync.

    One flag a device, made at its first ``record`` and then only updated
    in place: a CUDA graph keeps writing into the tensor it captured, so
    ``reset()`` zeroes the flags and never replaces them. A program's
    eager run before its capture makes the flag (``serving/graphs.py``)."""

    _flags: Dict[torch.device, torch.Tensor] = {}

    @classmethod
    def _flag(cls, device: torch.device) -> torch.Tensor:
        flag = cls._flags.get(device)
        if flag is None:
            flag = cls._flags[device] = torch.zeros((), dtype=torch.bool,
                                                    device=device)
        return flag

    @classmethod
    def record(cls, overflow: torch.Tensor) -> None:
        if device_mod.shape_only(overflow):
            return
        cls._flag(overflow.device).logical_or_(overflow)

    @classmethod
    def seen(cls) -> bool:
        return any(bool(f) for f in cls._flags.values())

    @classmethod
    def reset(cls) -> None:
        for f in cls._flags.values():
            f.zero_()


class HybridOverflowLog(OverflowLog):
    """Whether any hybrid pack ran out of dense-backup rows (its overflowing
    rows were dropped, App. B.2.1) since the last ``reset()``, and how many
    rows the packs put on each side of the format. Counts and flag stay on
    the device until read, updated in place as ``OverflowLog``'s."""

    _flags: Dict[torch.device, torch.Tensor] = {}
    _rows: Dict[torch.device, torch.Tensor] = {}   # (ELL rows, backup rows)

    @classmethod
    def record(cls, overflow: torch.Tensor, is_dense: torch.Tensor) -> None:
        if device_mod.shape_only(overflow):
            return
        super().record(overflow)
        rows = cls._rows.get(is_dense.device)
        if rows is None:
            rows = cls._rows[is_dense.device] = torch.zeros(
                2, dtype=torch.int64, device=is_dense.device)
        rows.add_(torch.stack([(~is_dense).sum(), is_dense.sum()]))

    @classmethod
    def rows(cls) -> Tuple[int, int]:
        """(ELL rows, dense-backup rows) summed over the packs since the
        last ``reset()``; rows dropped by an overflow count as backup."""
        ell = dense = 0
        for r in cls._rows.values():
            e, d = r.tolist()
            ell, dense = ell + e, dense + d
        return ell, dense

    @classmethod
    def reset(cls) -> None:
        super().reset()
        for r in cls._rows.values():
            r.zero_()


def launch_counts() -> Dict[str, int]:
    """Kernel launches per kernel since ``reset_launch_counts()``."""
    return dict(build.LAUNCHES)


def reset_launch_counts() -> None:
    build.reset_launches()


def twell_gate_matmul(x, w, tile: int, compression: int, act: str = "relu"
                      ) -> twell.TwellActs:
    fn = build.route(x, twell_gate_matmul_cuda, twell_gate_matmul_plain,
                     twell_gate_matmul_shape)
    vals, idx, nnz = fn(x, w, tile, compression, act)
    tc = tile // compression
    overflow = (nnz > tc).any()
    OverflowLog.record(overflow)
    return twell.TwellActs(vals, idx, torch.clamp(nnz, max=tc), overflow,
                           tile, compression, w.shape[1])


def twell_fused_ffn(x, tw: twell.TwellActs, wu_t, wd):
    """y = Eq. 3 from the packed gate; ``wu_t`` is W_u transposed (N, K)."""
    fn = build.route(x, twell_fused_ffn_cuda, twell_fused_ffn_plain,
                     twell_fused_ffn_shape)
    return fn(x, tw, wu_t, wd).to(x.dtype)


def twell_down_proj(tw: twell.TwellActs, wd):
    """Non-gated y = unpack(h) @ W_d from the packed activations (App.
    C.2), in W_d's type; ``tw.nnz`` is the count ``twell_gate_matmul``
    already clipped to T/C."""
    fn = build.route(wd, twell_down_proj_cuda, twell_down_proj_plain,
                     twell_down_proj_shape)
    return fn(tw.values, tw.indices, tw.nnz, wd, tw.tile).to(wd.dtype)


def tile_skip_ffn(x, wg, wu, wd, tile: int, act: str = "relu",
                  threshold: float = 0.0):
    """Gated FFN with (row block x tile) skipping -> (y in x.dtype, h).
    The kernel takes the threshold itself: the JAX package sends
    ``threshold > 0`` to its reference, which computes the same function."""
    fn = build.route(x, tile_skip_ffn_cuda, tile_skip_ffn_plain,
                     tile_skip_ffn_shape)
    y, h = fn(x, wg, wu, wd, tile, act, threshold)
    return y.to(x.dtype), h


def paged_attention_decode(q, kpool, vpool, block_tables, seq_lens):
    fn = build.route(q, paged_decode_attention_cuda,
                     paged_decode_attention_plain,
                     paged_decode_attention_shape)
    return fn(q, kpool, vpool, block_tables, seq_lens)


def paged_attention_extend(q, kpool, vpool, block_tables, seq_lens, num_new):
    fn = build.route(q, paged_chunk_attention_cuda,
                     paged_chunk_attention_plain, paged_chunk_attention_shape)
    return fn(q, kpool, vpool, block_tables, seq_lens, num_new)


def flash_attention(q, k, v):
    """Causal attention, (B, S, H, hd) each with one H, differentiable."""
    return FlashAttention.apply(q, k, v)


def hybrid_to_dense(ell_vals, ell_idx, row_nnz, is_sparse, w):
    """ELL side of ``h @ w``, w (N, K) -> (M, K) float32."""
    fn = build.route(w, hybrid_to_dense_cuda, hybrid_to_dense_plain,
                     hybrid_to_dense_shape)
    return fn(ell_vals, ell_idx, row_nnz, is_sparse, w)


def dense_to_hybrid(x, wt, ell_idx, row_nnz, is_sparse):
    """ELL side of ``(x @ W)[pattern]`` with W given as wt (N, K) ->
    (M, E) float32."""
    fn = build.route(x, dense_to_hybrid_cuda, dense_to_hybrid_plain,
                     dense_to_hybrid_shape)
    return fn(x, wt, ell_idx, row_nnz, is_sparse)
