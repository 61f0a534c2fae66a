"""K2, K5 and K6: the sparse FFN kernels of ``repro/kernels/sparse_ffn.py``.

K2, fused up + down projection from the packed TwELL gate (paper Eq. 3):
``twell_fused_ffn_cuda`` launches ``csrc/twell_fused_ffn.cu``, the Hopper
counterpart of ``twell_fused_ffn_pallas``; ``twell_fused_ffn_plain`` is the
same function in plain PyTorch (``repro/kernels/ref.py:twell_fused_ffn``).

K5, the gated FFN end to end with (row block x tile) skipping:
``tile_skip_ffn_cuda`` launches ``csrc/tile_skip_ffn.cu``, the Hopper
counterpart of ``tile_skip_ffn_pallas`` with the per-(row, tile) threshold
of ``repro/kernels/ref.py:tile_skip_ffn``; ``tile_skip_ffn_plain`` is the
same function in plain PyTorch.

K6, the non-gated down projection ``y = unpack(h) @ W_d`` (paper App.
C.2), where the up projection itself produced the TwELL pattern:
``twell_down_proj_cuda`` launches ``csrc/twell_down_proj.cu``, the Hopper
counterpart of ``twell_down_proj_pallas``; ``twell_down_proj_plain`` is the
same function in plain PyTorch (``repro/kernels/ref.py:twell_down_proj``,
float32 out).

K2 and K5 take ``W_u`` transposed, ``wu_t`` of shape (N, K): the kernel
reads W_u by column, and a column of the (K, N) row-major matrix is a
strided walk. The transposed copy is made once when the weights are loaded
(``models.lm.prepare_params``), never per call. K6 reads W_d by rows as it
is stored.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import twell
from repro_torch.kernels import build

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


def twell_fused_ffn_cuda(x: torch.Tensor, tw: twell.TwellActs,
                         wu_t: torch.Tensor, wd: torch.Tensor
                         ) -> torch.Tensor:
    """x (M, K) bf16, packed gate ``tw`` (nnz clipped to T/C), wu_t (N, K)
    bf16, wd (N, K) bf16 on the card -> y (M, K) float32."""
    global _FN
    m, k = x.shape
    n = wd.shape[0]
    ts = (x, tw.values, tw.indices, tw.nnz, wu_t, wd)
    if not all(t.is_cuda and t.device == x.device for t in ts):
        raise ValueError("twell_fused_ffn_cuda: every operand must be on "
                         "x's CUDA device")
    if any(t.dtype != torch.bfloat16 for t in (x, tw.values, wu_t, wd)) or \
            tw.indices.dtype != torch.int32 or tw.nnz.dtype != torch.int32:
        raise TypeError("twell_fused_ffn_cuda takes bfloat16 x/values/"
                        "weights and int32 indices/nnz")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("twell_fused_ffn_cuda: operands must be contiguous")
    slots = n // tw.tile * tw.slot_width
    if wu_t.shape != (n, k) or wd.shape != (n, k) or k % 8 or \
            n != tw.n or tw.values.shape != (m, slots) or \
            tw.indices.shape != (m, slots) or \
            tw.nnz.shape != (m, n // tw.tile) or m < 1:
        raise ValueError(
            f"twell_fused_ffn_cuda: inconsistent shapes x {tuple(x.shape)} "
            f"wu_t {tuple(wu_t.shape)} wd {tuple(wd.shape)} values "
            f"{tuple(tw.values.shape)} nnz {tuple(tw.nnz.shape)}")
    y = torch.empty((m, k), dtype=torch.float32, device=x.device)
    if _FN is None:
        P, I = build.P, build.I
        _FN = build.bind("twell_fused_ffn", "twell_fused_ffn_bf16",
                         [P, P, P, P, P, P, P, I, I, I, I, I, P])
    with torch.cuda.device(x.device):
        err = _FN(tw.values.data_ptr(), tw.indices.data_ptr(),
                  tw.nnz.data_ptr(), x.data_ptr(), wu_t.data_ptr(),
                  wd.data_ptr(), y.data_ptr(), m, k, n, tw.tile,
                  tw.compression, build.stream_ptr(x))
    build.check(err, "twell_fused_ffn")
    build.count_launch("twell_fused_ffn")
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


def twell_down_proj_cuda(vals: torch.Tensor, idx: torch.Tensor,
                         nnz: torch.Tensor, wd: torch.Tensor, tile: int
                         ) -> torch.Tensor:
    """vals (M, N/C) bf16, idx (M, N/C) int32, nnz (M, N/T) int32 (clipped
    to T/C; the kernel reads no slot at or past it), wd (N, K) bf16 on the
    card -> y (M, K) float32."""
    global _DP_FN
    m, slots = vals.shape
    n, k = wd.shape
    ts = (vals, idx, nnz, wd)
    if not all(t.is_cuda and t.device == wd.device for t in ts):
        raise ValueError("twell_down_proj_cuda: every operand must be on "
                         "wd's CUDA device")
    if vals.dtype != torch.bfloat16 or wd.dtype != torch.bfloat16 or \
            idx.dtype != torch.int32 or nnz.dtype != torch.int32:
        raise TypeError("twell_down_proj_cuda takes bfloat16 values and "
                        "W_d and int32 indices/nnz")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("twell_down_proj_cuda: operands must be contiguous")
    if m < 1 or tile < 1 or n % tile or k % 8 or slots % (n // tile) or \
            idx.shape != (m, slots) or nnz.shape != (m, n // tile) or \
            wd.data_ptr() % 16:
        raise ValueError(
            f"twell_down_proj_cuda: inconsistent shapes values "
            f"{tuple(vals.shape)} idx {tuple(idx.shape)} nnz "
            f"{tuple(nnz.shape)} wd {tuple(wd.shape)} tile {tile} (needs "
            "N % tile == 0, K % 8 == 0 and a 16-byte aligned wd)")
    y = torch.empty((m, k), dtype=torch.float32, device=wd.device)
    if _DP_FN is None:
        P, I = build.P, build.I
        _DP_FN = build.bind("twell_down_proj", "twell_down_proj_bf16",
                            [P, P, P, P, P, I, I, I, I, P])
    with torch.cuda.device(wd.device):
        err = _DP_FN(vals.data_ptr(), idx.data_ptr(), nnz.data_ptr(),
                     wd.data_ptr(), y.data_ptr(), m, k, n // tile,
                     slots // (n // tile), build.stream_ptr(wd))
    build.check(err, "twell_down_proj")
    build.count_launch("twell_down_proj")
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


def tile_skip_ffn_cuda(x: torch.Tensor, wg: torch.Tensor, wu: torch.Tensor,
                       wd: torch.Tensor, tile: int, act: str = "relu",
                       threshold: float = 0.0,
                       cell_active: Optional[torch.Tensor] = None):
    """x (M, K), wg/wu (K, N), wd (N, K) bf16 on the card -> (y (M, K)
    float32, h (M, N) bf16). ``cell_active``, when given, is an int32
    (ceil(M/32), N/tile) tensor the kernel fills with 1 for every (32-row
    block, tile) cell that ran its W_u/W_d work and 0 for a skipped one."""
    global _TS_FN
    _check_act(act)
    m, k = x.shape
    n = wg.shape[1]
    ts = (x, wg, wu, wd)
    if not all(t.is_cuda and t.device == x.device for t in ts):
        raise ValueError("tile_skip_ffn_cuda: every operand must be on x's "
                         "CUDA device")
    if any(t.dtype != torch.bfloat16 for t in ts):
        raise TypeError("tile_skip_ffn_cuda takes bfloat16 operands")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("tile_skip_ffn_cuda: operands must be contiguous")
    if wg.shape != (k, n) or wu.shape != (k, n) or wd.shape != (n, k) or \
            m < 1 or k % 32 or tile % 32 or not 32 <= tile <= 256 or \
            n % tile or n // tile > 1024 or threshold < 0:
        raise ValueError(
            f"tile_skip_ffn_cuda: unsupported shapes x {tuple(x.shape)} "
            f"wg {tuple(wg.shape)} wu {tuple(wu.shape)} wd {tuple(wd.shape)} "
            f"tile {tile} threshold {threshold} (needs K % 32 == 0, "
            "tile in 32..256 a multiple of 32, N % tile == 0)")
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
                            [P, P, P, P, P, P, P, I, I, I, I, I, F, P])
    with torch.cuda.device(x.device):
        err = _TS_FN(x.data_ptr(), wg.data_ptr(), wu.data_ptr(),
                     wd.data_ptr(), y.data_ptr(), h.data_ptr(),
                     cell_active.data_ptr(), m, k, n, tile, _TS_ACTS[act],
                     float(threshold), build.stream_ptr(x))
    build.check(err, "tile_skip_ffn")
    build.count_launch("tile_skip_ffn")
    return y, h
