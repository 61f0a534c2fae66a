"""Model primitives of the dense family: norms, RoPE, attention,
embeddings. Ports the parts of ``repro/models/layers.py`` that the paged
serving engine and the training forward run, keeping its layouts:
activations (B, S, H, hd), pools (num_blocks, block_size, Hkv, hd),
weights (in, out).
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.kernels import ops

INIT_STD = 0.02


def rmsnorm(x: torch.Tensor, scale=None, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm computed in float32, returned in x.dtype."""
    xf = x.float()
    y = xf * torch.rsqrt(torch.mean(torch.square(xf), dim=-1, keepdim=True)
                         + eps)
    if scale is not None:
        y = y * scale.float()
    return y.to(x.dtype)


def layernorm(x: torch.Tensor, scale=None, bias=None, eps: float = 1e-5
              ) -> torch.Tensor:
    """LayerNorm (biased variance) computed in float32, returned in
    x.dtype; without ``scale`` and ``bias`` it is olmo's non-parametric
    LayerNorm."""
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean(torch.square(xf - mu), dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    if scale is not None:
        y = y * scale.float()
    if bias is not None:
        y = y + bias.float()
    return y.to(x.dtype)


def norm_init(kind: str, d: int, dtype: torch.dtype, device
              ) -> Dict[str, torch.Tensor]:
    """A norm's parameters: ``{}`` for ``nonparametric_ln`` (olmo), a
    ``scale`` of ones for ``rmsnorm``, and a zero ``bias`` beside it for
    ``layernorm``."""
    if kind == "nonparametric_ln":
        return {}
    if kind == "rmsnorm":
        return {"scale": torch.ones((d,), dtype=dtype, device=device)}
    if kind == "layernorm":
        return {"scale": torch.ones((d,), dtype=dtype, device=device),
                "bias": torch.zeros((d,), dtype=dtype, device=device)}
    raise ValueError(kind)


def norm_apply(kind: str, params: Dict[str, torch.Tensor], x: torch.Tensor
               ) -> torch.Tensor:
    if kind == "rmsnorm":
        return rmsnorm(x, params["scale"])
    if kind == "layernorm":
        return layernorm(x, params["scale"], params["bias"])
    if kind == "nonparametric_ln":
        return layernorm(x)
    raise ValueError(kind)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float
         ) -> torch.Tensor:
    """x: (..., S, H, hd); positions broadcastable to (..., S).

    Rotates *interleaved* pairs (x[..., 0::2], x[..., 1::2]) and interleaves
    the result again -- the JAX package's convention, not rotate-half."""
    if theta <= 0:
        return x
    hd = x.shape[-1]
    freqs = 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                          device=x.device) / hd))
    ang = positions[..., None].float() * freqs               # (..., S, hd/2)
    ang = ang[..., None, :]                                  # head axis
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., 0::2].float(), x[..., 1::2].float()
    o1 = x1 * cos - x2 * sin
    o2 = x2 * cos + x1 * sin
    return torch.stack([o1, o2], dim=-1).reshape(x.shape).to(x.dtype)


def attn_init(d_model: int, n_heads: int, n_kv: int, head_dim: int,
              dtype: torch.dtype, generator: torch.Generator,
              device: torch.device) -> Dict[str, torch.Tensor]:
    def r(shape):
        return (INIT_STD * torch.randn(shape, generator=generator,
                                       device=device)).to(dtype)
    return {
        "wq": r((d_model, n_heads * head_dim)),
        "wk": r((d_model, n_kv * head_dim)),
        "wv": r((d_model, n_kv * head_dim)),
        "wo": r((n_heads * head_dim, d_model)),
    }


def repeat_kv(k: torch.Tensor, n_heads: int) -> torch.Tensor:
    """(B, S, Hkv, hd) -> (B, S, H, hd) by group broadcast."""
    b, s, hkv, hd = k.shape
    if hkv == n_heads:
        return k
    return k[:, :, :, None, :].expand(b, s, hkv, n_heads // hkv, hd
                                      ).reshape(b, s, n_heads, hd)


def _paged_attention(q, k, v, cache) -> torch.Tensor:
    """Paged-KV attention for ONE layer; the pools are updated in place.

    cache = {"kpool", "vpool", "block_tables", "seq_lens"[, "num_new"]}:
      kpool/vpool:   (num_blocks, block_size, Hkv, hd) views of the pools
      block_tables:  (B, W) int32 physical block ids (0 = null block)
      seq_lens:      (B,) int32 tokens already cached per request

    decode (S == 1): the new K/V go to position ``seq_len`` of each row,
      then the read covers kpos <= seq_len (kernel K3 on the card). An
      optional cache["write_valid"] (B,) bool sends a row's write to block
      0, offset 0 when False (speculative draft steps past a request's
      budget must leave the pool untouched).
    chunk-append (S > 1, "num_new" given): row i of the chunk goes to
      position seq_len + i; rows at or past num_new (the padded tail) are
      routed to the null block; the read covers the history plus the chunk
      causally (kernel K4 on the card).
    Padded batch rows carry an all-null table: their writes land in the
    null block and their outputs are garbage the engine discards.
    The scatter is plain torch (in place, ``index_put_``), as it is plain
    JAX in the reference.
    """
    kpool, vpool = cache["kpool"], cache["vpool"]
    bt, sl = cache["block_tables"], cache["seq_lens"]
    b, s, hkv, hd = k.shape
    bs = kpool.shape[1]
    if s == 1:
        blk = torch.gather(bt, 1, (sl // bs)[:, None].long())[:, 0].long()
        off = (sl % bs).long()
        if "write_valid" in cache:
            wv = cache["write_valid"]
            blk = torch.where(wv, blk, torch.zeros_like(blk))
            off = torch.where(wv, off, torch.zeros_like(off))
        kpool.index_put_((blk, off), k[:, 0])
        vpool.index_put_((blk, off), v[:, 0])
        return ops.paged_attention_decode(q, kpool, vpool, bt, sl)
    num_new = cache["num_new"]
    idx = torch.arange(s, device=q.device)
    valid = idx[None, :] < num_new[:, None]                       # (B, S)
    pos = sl[:, None] + idx[None, :]                              # (B, S)
    slot = torch.clamp(pos // bs, 0, bt.shape[1] - 1).long()
    zero = torch.zeros((), dtype=torch.long, device=q.device)
    blk = torch.where(valid, torch.gather(bt, 1, slot).long(), zero)
    off = torch.where(valid, (pos % bs).long(), zero)
    kpool.index_put_((blk.reshape(-1), off.reshape(-1)),
                     k.reshape(b * s, hkv, hd))
    vpool.index_put_((blk.reshape(-1), off.reshape(-1)),
                     v.reshape(b * s, hkv, hd))
    return ops.paged_attention_extend(q, kpool, vpool, bt, sl, num_new)


def attention(params: Dict, x: torch.Tensor, cfg, *,
              positions: torch.Tensor, kind: str = "causal",
              cache: Optional[Dict] = None) -> torch.Tensor:
    """Causal self-attention: paged (the serving engine) when ``cache``
    holds pools, else over the sequence itself (the training forward,
    kernel K7 on the card). The windowed and chunked kinds are not ported
    yet."""
    b, s, _ = x.shape
    if kind != "causal":
        raise NotImplementedError(
            f"attention kind {kind!r} is not ported yet (causal only)")
    h, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    q = (x @ params["wq"]).reshape(b, s, h, hd)
    k = (x @ params["wk"]).reshape(b, s, hkv, hd)
    v = (x @ params["wv"]).reshape(b, s, hkv, hd)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    if cache is None:
        out = ops.flash_attention(q, repeat_kv(k, h), repeat_kv(v, h))
    else:
        out = _paged_attention(q, k, v, cache)
    return out.reshape(b, s, h * hd) @ params["wo"]


def embed_init(vocab: int, d_model: int, dtype: torch.dtype,
               generator: torch.Generator, device: torch.device
               ) -> torch.Tensor:
    return (INIT_STD * torch.randn((vocab, d_model), generator=generator,
                                   device=device)).to(dtype)


def embed_lookup(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    return table[tokens.long()]


def lm_logits(x: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    return torch.einsum("bsd,vd->bsv", x, table)
