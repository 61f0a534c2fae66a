"""K8 and K9: the ELL side of the hybrid format's products (paper Sec. 3.5).

K8, ``y = h @ W`` with h in the hybrid format: ``hybrid_to_dense_cuda``
launches ``csrc/hybrid_matmul.cu``, the Hopper counterpart of
``repro/kernels/hybrid_matmul.py:hybrid_to_dense_pallas``;
``hybrid_to_dense_plain`` is the same function in plain PyTorch.

K9, the SDDMM ``vals = (x @ W)[pattern]``: ``dense_to_hybrid_cuda``
launches the same source's second kernel, the counterpart of
``dense_to_hybrid_pallas``; ``dense_to_hybrid_plain`` beside it.

Both cover the ELL side only: slot e of row m is valid when
``e < row_nnz[m]`` and ``is_sparse[m]``; a row in the dense backup gives 0
(K8) or all-zero slots (K9), and ``core/hybrid.py`` adds the backup rows'
dense product. Both return float32. The two kernels read W by rows: K8
takes W as (N, K), K9 takes ``wt``, W transposed, also (N, K), so a
pattern column of W is one contiguous row.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build

_H2D = None
_D2H = None
_TYPES = (torch.bfloat16, torch.float32)


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
    vals (M, E) float32 on the pattern of (ell_idx, row_nnz, is_sparse)."""
    global _D2H
    m, k = x.shape
    e = ell_idx.shape[1]
    if x.dtype not in _TYPES or wt.dtype != x.dtype:
        raise TypeError("dense_to_hybrid_cuda takes x and wt both bfloat16 "
                        "or both float32")
    _check("dense_to_hybrid_cuda", (x, wt), ell_idx, row_nnz, is_sparse,
           m, e, k)
    if wt.shape[1] != k:
        raise ValueError(f"dense_to_hybrid_cuda: wt {tuple(wt.shape)} does "
                         f"not match x {tuple(x.shape)}")
    vals = torch.empty((m, e), dtype=torch.float32, device=x.device)
    if _D2H is None:
        P, I = build.P, build.I
        _D2H = build.bind("hybrid_matmul", "dense_to_hybrid",
                          [P, P, P, P, P, P, I, I, I, I, P])
    with torch.cuda.device(x.device):
        err = _D2H(x.data_ptr(), wt.data_ptr(), ell_idx.data_ptr(),
                   row_nnz.data_ptr(), is_sparse.data_ptr(), vals.data_ptr(),
                   m, e, k, int(x.dtype == torch.bfloat16),
                   build.stream_ptr(x))
    build.check(err, "dense_to_hybrid")
    build.count_launch("dense_to_hybrid")
    return vals
