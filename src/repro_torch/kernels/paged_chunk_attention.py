"""K4: paged chunk-append attention (prefill / chunked prefill).

``paged_chunk_attention_cuda`` launches ``csrc/paged_chunk_attention.cu``,
the Hopper counterpart of
``repro/kernels/paged_chunk_attention.py:paged_chunk_attention_pallas``;
``paged_chunk_attention_plain`` is the same function in plain PyTorch
(``repro/kernels/ref.py:paged_attention_extend``).

q: (B, S, H, hd); the chunk's K/V are already scattered into the pools at
positions ``seq_len .. seq_len + num_new - 1``; row i attends keys
``kpos <= seq_len + i``. Rows at or past ``num_new`` are padding whose
output the caller discards (the two versions may differ there). Returns
(B, S, H, hd) in q.dtype.

``paged_chunk_attention_shape`` stands in for the launch on tensors
without data (a dry run), as K3's does.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import attention_plan, build
from repro_torch.kernels.paged_decode_attention import (gather_pages,
                                                         masked_sdpa)

_FN = None


def paged_chunk_attention_plain(q, kpool, vpool, block_tables, seq_lens,
                                num_new=None):
    del num_new                       # padded rows are garbage either way
    s, h, hd = q.shape[1], q.shape[2], q.shape[3]
    kf = gather_pages(kpool, block_tables, h)
    vf = gather_pages(vpool, block_tables, h)
    pos = seq_lens[:, None] + torch.arange(s, device=q.device)[None, :]
    kpos = torch.arange(kf.shape[1], device=q.device)
    mask = (kpos[None, None, :] <= pos[:, :, None])[:, None]
    return masked_sdpa(q, kf, vf, mask, 1.0 / (hd ** 0.5))


def paged_chunk_attention_cuda(q, kpool, vpool, block_tables, seq_lens,
                               num_new):
    global _FN
    b, s, h, hd = q.shape
    _, bs, hkv, hd2 = kpool.shape
    width = block_tables.shape[1]
    ts = (q, kpool, vpool, block_tables, seq_lens, num_new)
    if not all(t.is_cuda and t.device == q.device for t in ts):
        raise ValueError("paged_chunk_attention_cuda: every operand must be "
                         "on q's CUDA device")
    if any(t.dtype != torch.bfloat16 for t in (q, kpool, vpool)) or \
            any(t.dtype != torch.int32 for t in ts[3:]):
        raise TypeError("paged_chunk_attention_cuda takes bfloat16 q/pools "
                        "and int32 block tables/seq lens/num_new")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("paged_chunk_attention_cuda: operands must be "
                         "contiguous")
    if hd != hd2 or hd > 128 or hd % 8 or vpool.shape != kpool.shape or \
            h % hkv or \
            block_tables.shape[0] != b or seq_lens.shape != (b,) or \
            num_new.shape != (b,) or b < 1 or s < 1 or width < 1 or \
            any(t.data_ptr() % 16 for t in (q, kpool, vpool)):
        raise ValueError(
            f"paged_chunk_attention_cuda: unsupported shapes q "
            f"{tuple(q.shape)} pools {tuple(kpool.shape)} tables "
            f"{tuple(block_tables.shape)} (needs hd % 8 == 0, hd <= 128, "
            "16-byte aligned)")
    # rows per block and the cluster's key split, from shapes only
    plan = attention_plan.chunk_plan(b, s, h, hkv, width, bs)
    out = torch.empty_like(q)
    if _FN is None:
        P, I = build.P, build.I
        _FN = build.bind("paged_chunk_attention", "paged_chunk_attention_bf16",
                         [P, P, P, P, P, P, P, I, I, I, I, I, I, I,
                          build.F, I, I, P])
    with torch.cuda.device(q.device):
        err = _FN(q.data_ptr(), kpool.data_ptr(), vpool.data_ptr(),
                  block_tables.data_ptr(), seq_lens.data_ptr(),
                  num_new.data_ptr(), out.data_ptr(), b, s, h, hkv, hd, bs,
                  width, 1.0 / (hd ** 0.5), plan.rows, plan.cluster,
                  build.stream_ptr(q))
    build.check(err, "paged_chunk_attention")
    build.count_launch("paged_chunk_attention")
    return out


def paged_chunk_attention_shape(q, kpool, vpool, block_tables, seq_lens,
                                num_new):
    """What ``paged_chunk_attention_cuda`` returns, without a launch: an
    output like q, or its refusal of the shapes (``chunk_plan``). For
    tensors without data (a dry run). Work reported at the tables'
    capacity, every row against all W x bs keys (no causal credit): 4 B S H (W bs) hd FLOPs; bytes q, the
    tables, seq_lens, num_new and each row's W x bs keys and values read
    once, the output written once."""
    b, s, h, hd = q.shape
    _, bs, hkv, hd2 = kpool.shape
    width = block_tables.shape[1]
    if any(t.dtype != torch.bfloat16 for t in (q, kpool, vpool)) or \
            any(t.dtype != torch.int32
                for t in (block_tables, seq_lens, num_new)):
        raise TypeError("paged_chunk_attention takes bfloat16 q/pools and "
                        "int32 block tables/seq lens/num_new")
    if hd != hd2 or hd > 128 or hd % 8 or h % hkv or \
            block_tables.shape[0] != b:
        raise ValueError(f"paged_chunk_attention: unsupported shapes q "
                         f"{tuple(q.shape)} pools {tuple(kpool.shape)}")
    attention_plan.chunk_plan(b, s, h, hkv, width, bs)
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    keys = width * bs
    build.report_work("paged_chunk_attention", 4 * b * s * h * keys * hd,
                      build.nbytes(q, block_tables, seq_lens, num_new, out) +
                      2 * b * keys * hkv * hd * kpool.element_size())
    return out
