"""K2: fused up + down projection from the packed TwELL gate (paper Eq. 3).

``twell_fused_ffn_cuda`` launches ``csrc/twell_fused_ffn.cu``, the Hopper
counterpart of ``repro/kernels/sparse_ffn.py:twell_fused_ffn_pallas``;
``twell_fused_ffn_plain`` is the same function in plain PyTorch
(``repro/kernels/ref.py:twell_fused_ffn``).

Both take ``W_u`` transposed, ``wu_t`` of shape (N, K): the kernel reads
W_u by column, and a column of the (K, N) row-major matrix is a strided
walk. The transposed copy is made once when the weights are loaded
(``models.lm.prepare_params``), never per call.
"""
from __future__ import annotations

import torch

from repro_torch.core import twell
from repro_torch.kernels import build

_FN = None


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
