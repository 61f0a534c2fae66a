"""K1: gate matmul + activation + TwELL pack (paper Algorithm 1).

``twell_gate_matmul_cuda`` launches ``csrc/twell_pack.cu``, the Hopper
counterpart of ``repro/kernels/twell_pack.py:twell_gate_matmul_pallas``;
``twell_gate_matmul_plain`` is the same function in plain PyTorch
(``repro/kernels/ref.py:twell_gate_matmul``). Both return
``(values, indices, nnz)`` with the exact, unclipped per-tile ``nnz``: the
caller (``kernels/ops.py``) clips it and raises the overflow flag.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.core import twell
from repro_torch.core.sparsity import activation
from repro_torch.kernels import build

_ACTS = {"relu": 0, "relu2": 1}
_FN = None


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
    if k != k2 or k % 8 or n % tile or tile % 64 or tile > 256 or \
            tile % compression or m < 1:
        raise ValueError(
            f"twell_gate_matmul_cuda: unsupported shapes x {tuple(x.shape)} "
            f"w {tuple(w.shape)} tile {tile} C {compression} (needs "
            "K % 8 == 0, tile % 64 == 0, tile <= 256, N % tile == 0)")
    if act not in _ACTS:
        raise ValueError(f"twell_gate_matmul_cuda: activation {act!r}")
    slots = n // tile * (tile // compression)
    vals = torch.empty((m, slots), dtype=x.dtype, device=x.device)
    idx = torch.empty((m, slots), dtype=torch.int32, device=x.device)
    nnz = torch.empty((m, n // tile), dtype=torch.int32, device=x.device)
    if _FN is None:
        P, I = build.P, build.I
        _FN = build.bind("twell_pack", "twell_gate_matmul_bf16",
                         [P, P, P, P, P, I, I, I, I, I, I, P])
    with torch.cuda.device(x.device):
        err = _FN(x.data_ptr(), w.data_ptr(), vals.data_ptr(),
                  idx.data_ptr(), nnz.data_ptr(), m, k, n, tile, compression,
                  _ACTS[act], build.stream_ptr(x))
    build.check(err, "twell_gate_matmul")
    build.count_launch("twell_gate_matmul")
    return vals, idx, nnz
