"""K3: paged decode attention (flash-decoding over block tables).

``paged_decode_attention_cuda`` launches ``csrc/paged_decode_attention.cu``,
the Hopper counterpart of
``repro/kernels/paged_decode_attention.py:paged_decode_attention_pallas``
and of its wrapper's merge of the splits: one launch a call, the keys split
over a thread-block cluster (``attention_plan.decode_plan``), the splits
merged in the kernel, which writes the bf16 output; the wrapper allocates
only that output. ``paged_decode_attention_plain`` is the same function in
plain PyTorch (``repro/kernels/ref.py:paged_attention_decode``).

q: (B, 1, H, hd) roped queries; kpool/vpool: (num_blocks, block_size, Hkv,
hd) with the new token already scattered at position ``seq_len``;
block_tables: (B, W) int32 (0 = null block); seq_lens: (B,) int32 tokens
cached before this step. Returns (B, 1, H, hd) in q.dtype.

``paged_decode_attention_shape`` stands in for the launch on tensors
without data (a dry run): the output's shape, dtype and device, and the
work over every key of the block tables (``build.report_work``).
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import attention_plan, build, twell_pack
from repro_torch.observability import accounting

_FN = None


def repeat_kv(k: torch.Tensor, n_heads: int) -> torch.Tensor:
    """(B, S, Hkv, hd) -> (B, S, H, hd) by group broadcast."""
    b, s, hkv, hd = k.shape
    if hkv == n_heads:
        return k
    return k[:, :, :, None, :].expand(b, s, hkv, n_heads // hkv, hd) \
        .reshape(b, s, n_heads, hd)


def masked_sdpa(q, kf, vf, mask, scale):
    """f32 logits and softmax, -1e30 where ``mask`` is False (no mask:
    None), probabilities cast to q.dtype (``repro/models/layers.py:_sdpa``).
    Over no keys the output is zeros, as JAX's."""
    logits = torch.einsum("bqhd,bkhd->bhqk", q, kf).float() * scale
    if mask is not None:
        logits = torch.where(mask, logits, torch.full((), -1e30,
                                                      device=q.device))
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, vf)


def gather_pages(pool: torch.Tensor, block_tables: torch.Tensor,
                 n_heads: int) -> torch.Tensor:
    """(B, W*bs, H, hd): every table page of ``pool``, KV heads repeated."""
    b = block_tables.shape[0]
    _, _, hkv, hd = pool.shape
    return repeat_kv(pool[block_tables.long()].reshape(b, -1, hkv, hd),
                     n_heads)


def paged_decode_attention_plain(q, kpool, vpool, block_tables, seq_lens):
    h, hd = q.shape[2], q.shape[3]
    kf = gather_pages(kpool, block_tables, h)
    vf = gather_pages(vpool, block_tables, h)
    kpos = torch.arange(kf.shape[1], device=q.device)
    mask = (kpos[None, :] <= seq_lens[:, None])[:, None, None, :]
    return masked_sdpa(q, kf, vf, mask, 1.0 / (hd ** 0.5))


def paged_decode_attention_cuda(q, kpool, vpool, block_tables, seq_lens):
    global _FN
    b, one, h, hd = q.shape
    _, bs, hkv, hd2 = kpool.shape
    width = block_tables.shape[1]
    ts = (q, kpool, vpool, block_tables, seq_lens)
    if not all(t.is_cuda and t.device == q.device for t in ts):
        raise ValueError("paged_decode_attention_cuda: every operand must "
                         "be on q's CUDA device")
    if any(t.dtype != torch.bfloat16 for t in (q, kpool, vpool)) or \
            block_tables.dtype != torch.int32 or \
            seq_lens.dtype != torch.int32:
        raise TypeError("paged_decode_attention_cuda takes bfloat16 q/pools "
                        "and int32 block tables/seq lens")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("paged_decode_attention_cuda: operands must be "
                         "contiguous")
    if one != 1 or hd != hd2 or hd > 128 or hd % 8 or \
            vpool.shape != kpool.shape or \
            h % hkv or h // hkv > 16 or block_tables.shape[0] != b or \
            seq_lens.shape != (b,) or b < 1 or width < 1 or \
            any(t.data_ptr() % 16 for t in (q, kpool, vpool)):
        raise ValueError(
            f"paged_decode_attention_cuda: unsupported shapes q "
            f"{tuple(q.shape)} pools {tuple(kpool.shape)} tables "
            f"{tuple(block_tables.shape)} (needs hd % 8 == 0, hd <= 128, "
            "H/Hkv <= 16, 16-byte aligned)")
    # the cluster's key split, from shapes and the SM count only
    plan = attention_plan.decode_plan(b, h, hkv, hd, width, bs,
                                      twell_pack.sm_count(q.device))
    out = torch.empty_like(q)
    if _FN is None:
        P, I = build.P, build.I
        _FN = build.bind("paged_decode_attention",
                         "paged_decode_attention_bf16",
                         [P, P, P, P, P, P, I, I, I, I, I, I, build.F, I, P])
    with torch.cuda.device(q.device):
        err = _FN(q.data_ptr(), kpool.data_ptr(), vpool.data_ptr(),
                  block_tables.data_ptr(), seq_lens.data_ptr(),
                  out.data_ptr(), b, h, hkv, hd, bs, width,
                  1.0 / (hd ** 0.5), plan.cluster, build.stream_ptr(q))
    build.check(err, "paged_decode_attention")
    build.count_launch("paged_decode_attention")
    return out


def paged_decode_attention_shape(q, kpool, vpool, block_tables, seq_lens):
    """What ``paged_decode_attention_cuda`` returns, without a launch: an
    output like q, or its refusal of the shapes (``decode_plan`` at the
    H100's SM count). For tensors without data. Work reported at the tables'
    capacity, every one of their W x bs keys (seq_lens are data): 4 B H
    (W bs) hd FLOPs; bytes q, the tables, seq_lens and each row's W x bs
    keys and values read once, the output written once."""
    b, one, h, hd = q.shape
    _, bs, hkv, hd2 = kpool.shape
    width = block_tables.shape[1]
    if any(t.dtype != torch.bfloat16 for t in (q, kpool, vpool)) or \
            block_tables.dtype != torch.int32 or \
            seq_lens.dtype != torch.int32:
        raise TypeError("paged_decode_attention takes bfloat16 q/pools and "
                        "int32 block tables/seq lens")
    if one != 1 or hd != hd2 or hd > 128 or hd % 8 or h % hkv or \
            h // hkv > 16 or block_tables.shape[0] != b:
        raise ValueError(f"paged_decode_attention: unsupported shapes q "
                         f"{tuple(q.shape)} pools {tuple(kpool.shape)}")
    attention_plan.decode_plan(b, h, hkv, hd, width, bs, accounting.H100_SMS)
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    keys = width * bs
    build.report_work("paged_decode_attention", 4 * b * h * keys * hd,
                      build.nbytes(q, block_tables, seq_lens, out) +
                      2 * b * keys * hkv * hd * kpool.element_size())
    return out


def decode_resident_clusters(hd: int, g: int, width: int, cluster: int
                             ) -> Tuple[int, int]:
    """(clusters of ``cluster`` blocks the current card holds at once, by
    the CUDA runtime's count, and a block's dynamic shared memory) for the
    kernel form that serves head dim ``hd`` and group ``g`` at a table
    width. For checking ``decode_plan``; the kernel path never calls it."""
    fn = build.bind("paged_decode_attention",
                    "paged_decode_resident_clusters",
                    [build.I] * 4 + [build.P, build.P])
    held, smem = ctypes.c_int(0), ctypes.c_int(0)
    build.check(fn(hd, g, width, cluster, ctypes.addressof(held),
                   ctypes.addressof(smem)), "paged_decode_resident_clusters")
    return held.value, smem.value
