"""K7: causal flash attention for the training forward.

``flash_attention_cuda`` launches ``csrc/flash_attention.cu``, the Hopper
counterpart of ``repro/kernels/flash_attention.py:flash_attention_pallas``;
``flash_attention_plain`` is the same function in plain PyTorch. q, k, v
and the output are (B, S, H, hd) with the same H (the caller repeats K/V
heads first), causal, in q.dtype.

``FlashAttention`` is the differentiable op: its forward is K7 on the card
(the plain version on the CPU); its backward is ``flash_attention_backward``,
explicit PyTorch math that recomputes the probabilities from the saved q
and k. The JAX package has no backward kernel either: XLA differentiates
its jnp attention.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build

_FN = {}
_NEG = -1e30


def _causal_scores(q, k):
    """(B, H, S, S) float32 scores q k^T * scale with the future masked."""
    s, hd = q.shape[1], q.shape[-1]
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * \
        (1.0 / hd ** 0.5)
    pos = torch.arange(s, device=q.device)
    return torch.where(pos[:, None] >= pos[None, :], logits,
                       torch.full((), _NEG, device=q.device))


def flash_attention_plain(q, k, v):
    """Causal attention with an f32 softmax, rounded as the Pallas body
    rounds: the unnormalised probabilities exp(s - max) enter the product
    with v in v.dtype, the row sums stay f32, and acc / l is rounded once
    (``ref.py`` rounds the normalised probabilities instead; in float32 the
    two are the same)."""
    logits = _causal_scores(q, k)
    p = torch.exp(logits - logits.amax(-1, keepdim=True))
    acc = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), v.float())
    l = p.sum(-1).transpose(1, 2)[..., None]                  # (B, S, H, 1)
    return (acc / torch.clamp(l, min=1e-30)).to(q.dtype)


def flash_attention_backward(q, k, v, o, do):
    """Gradients of causal attention, in float32, one batch row at a time
    (the (H, S, S) probabilities of a row are the transient):
    P recomputed from q and k, dV = P^T dO, dP = dO V^T,
    dS = P * (dP - rowsum(dO * O)), dQ = dS K scale, dK = dS^T Q scale.
    Returns (dq, dk, dv) in the inputs' dtypes."""
    scale = 1.0 / q.shape[-1] ** 0.5
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    for b in range(q.shape[0]):
        qb, kb, vb = (t[b:b + 1].float() for t in (q, k, v))
        dob = do[b:b + 1].float()
        p = torch.softmax(_causal_scores(qb, kb), dim=-1)    # (1, H, S, S)
        dv[b] = torch.einsum("bhqk,bqhd->bkhd", p, dob)[0]
        dp = torch.einsum("bqhd,bkhd->bhqk", dob, vb)
        delta = (dob * o[b:b + 1].float()).sum(-1).transpose(1, 2)
        ds = p * (dp - delta[..., None])
        dq[b] = torch.einsum("bhqk,bkhd->bqhd", ds, kb)[0] * scale
        dk[b] = torch.einsum("bhqk,bqhd->bkhd", ds, qb)[0] * scale
    return dq, dk, dv


def flash_attention_cuda(q, k, v):
    """q, k, v (B, S, H, hd) bf16 or float32, contiguous, on the card ->
    (B, S, H, hd) in q.dtype."""
    b, s, h, hd = q.shape
    if not all(t.is_cuda and t.device == q.device for t in (q, k, v)):
        raise ValueError("flash_attention_cuda: q, k and v must be on one "
                         "CUDA device")
    if q.dtype not in (torch.bfloat16, torch.float32) or \
            k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("flash_attention_cuda takes q, k, v all bfloat16 or "
                        "all float32")
    if not all(t.is_contiguous() for t in (q, k, v)):
        raise ValueError("flash_attention_cuda: q, k, v must be contiguous")
    if k.shape != q.shape or v.shape != q.shape or min(b, s, h) < 1 or \
            hd > 128 or (q.dtype == torch.bfloat16 and hd % 8) or \
            any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError(
            f"flash_attention_cuda: unsupported shapes q {tuple(q.shape)} k "
            f"{tuple(k.shape)} v {tuple(v.shape)} (needs equal shapes, "
            "hd <= 128, bf16 hd % 8 == 0, 16-byte aligned)")
    name = "flash_attention_bf16" if q.dtype == torch.bfloat16 \
        else "flash_attention_f32"
    if name not in _FN:
        P, I = build.P, build.I
        _FN[name] = build.bind("flash_attention", name,
                               [P, P, P, P, I, I, I, I, build.F, P])
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        err = _FN[name](q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        out.data_ptr(), b, s, h, hd, 1.0 / hd ** 0.5,
                        build.stream_ptr(q))
    build.check(err, "flash_attention")
    build.count_launch("flash_attention")
    return out


class FlashAttention(torch.autograd.Function):
    """Causal attention: K7 forward on the card, the plain version on the
    CPU; ``flash_attention_backward`` for the gradients. Saves q, k, v and
    the output."""

    @staticmethod
    def forward(ctx, q, k, v):
        fn = flash_attention_cuda if q.is_cuda else flash_attention_plain
        o = fn(q.contiguous(), k.contiguous(), v.contiguous())
        ctx.save_for_backward(q, k, v, o)
        return o

    @staticmethod
    def backward(ctx, do):
        return flash_attention_backward(*ctx.saved_tensors, do)
