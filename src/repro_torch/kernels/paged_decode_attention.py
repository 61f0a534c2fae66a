"""K3: paged decode attention (flash-decoding over block tables).

``paged_decode_attention_cuda`` launches ``csrc/paged_decode_attention.cu``,
the Hopper counterpart of
``repro/kernels/paged_decode_attention.py:paged_decode_attention_pallas``:
the kernel writes per-split partial softmax states and the merge of the
splits is plain torch, as the JAX wrapper merges outside its kernel.
``paged_decode_attention_plain`` is the same function in plain PyTorch
(``repro/kernels/ref.py:paged_attention_decode``).

q: (B, 1, H, hd) roped queries; kpool/vpool: (num_blocks, block_size, Hkv,
hd) with the new token already scattered at position ``seq_len``;
block_tables: (B, W) int32 (0 = null block); seq_lens: (B,) int32 tokens
cached before this step. Returns (B, 1, H, hd) in q.dtype.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build

NUM_SPLITS = 4
_FN = None


def repeat_kv(k: torch.Tensor, n_heads: int) -> torch.Tensor:
    """(B, S, Hkv, hd) -> (B, S, H, hd) by group broadcast."""
    b, s, hkv, hd = k.shape
    if hkv == n_heads:
        return k
    return k[:, :, :, None, :].expand(b, s, hkv, n_heads // hkv, hd) \
        .reshape(b, s, n_heads, hd)


def masked_sdpa(q, kf, vf, mask, scale):
    """f32 logits and softmax, -1e30 mask, probabilities cast to q.dtype
    (``repro/models/layers.py:_sdpa``)."""
    logits = torch.einsum("bqhd,bkhd->bhqk", q, kf).float() * scale
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


def num_splits(width: int) -> int:
    return max(1, min(NUM_SPLITS, width))


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
            seq_lens.shape != (b,) or b < 1 or width < 1:
        raise ValueError(
            f"paged_decode_attention_cuda: unsupported shapes q "
            f"{tuple(q.shape)} pools {tuple(kpool.shape)} tables "
            f"{tuple(block_tables.shape)} (needs hd % 8 == 0, hd <= 128, "
            "H/Hkv <= 16)")
    g = h // hkv
    ns = num_splits(width)
    o = torch.empty((b, hkv, ns, g, hd), dtype=torch.float32, device=q.device)
    m = torch.empty((b, hkv, ns, g), dtype=torch.float32, device=q.device)
    l = torch.empty_like(m)
    if _FN is None:
        P, I = build.P, build.I
        _FN = build.bind("paged_decode_attention",
                         "paged_decode_attention_bf16",
                         [P, P, P, P, P, P, P, P, I, I, I, I, I, I, I,
                          build.F, P])
    with torch.cuda.device(q.device):
        err = _FN(q.data_ptr(), kpool.data_ptr(), vpool.data_ptr(),
                  block_tables.data_ptr(), seq_lens.data_ptr(), o.data_ptr(),
                  m.data_ptr(), l.data_ptr(), b, h, hkv, hd, bs, width, ns,
                  1.0 / (hd ** 0.5), build.stream_ptr(q))
    build.check(err, "paged_decode_attention")
    build.count_launch("paged_decode_attention")
    # second stage: merge the splits' partial softmaxes; dead splits carry
    # m = -1e30, l = 0 and contribute exactly 0
    m_max = m.max(dim=2, keepdim=True).values
    alpha = torch.exp(m - m_max)
    l_tot = (alpha * l).sum(dim=2)
    out = (alpha[..., None] * o).sum(dim=2) / \
        torch.clamp(l_tot, min=1e-30)[..., None]
    return out.reshape(b, 1, h, hd).to(q.dtype)
