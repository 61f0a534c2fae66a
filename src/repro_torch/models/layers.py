"""Model primitives: norms, RoPE, attention (causal, sliding-window
``swa``, chunked-local ``local_chunk``, ``cross`` and bidirectional
``bidir``), embeddings. Ports the parts of ``repro/models/layers.py`` that
the paged serving engine, the static loop and the training forward run,
keeping its layouts: activations (B, S, H, hd), pools (num_blocks,
block_size, Hkv, hd), weights (in, out).

``cross`` (the vlm family's gated image layers, whisper's decoder) takes
K and V from ``kv_x`` (the patches, the encoder's output) or, in decode,
from the precomputed ``xk``/``xv`` of the cache, and applies no rope;
``bidir`` (whisper's encoder) is unmasked self-attention. Both are plain
``jnp`` in the JAX package (``_sdpa``, ``_chunked_bidir``), so plain
PyTorch here: float32 logits and softmax, probabilities cast back to the
input dtype.

The windowed kinds' decode departs from the JAX package's on purpose. Its
ring mask ``(kpos < pos + 1) & (kpos > pos - s_cache)``
(``repro/models/layers.py:351``) compares ring slots with absolute
positions, so past the window it masks out the newest keys, the current
token's own among them; its chunked cache is written at slot ``pos``
(``:343``) and never restarts at a chunk boundary. Here decode follows the
training forward (``_banded``) at every position: a ring of the newest
``window`` positions for ``swa``, a cache that restarts at each chunk for
``local_chunk``.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.distributed import collectives
from repro_torch.kernels import ops
from repro_torch.kernels.paged_decode_attention import masked_sdpa

INIT_STD = 0.02
ATTN_KINDS = ("causal", "swa", "local_chunk", "cross", "bidir")


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


def _cache_slot(kind: str, cfg, pos: int, s_cache: int) -> Tuple[int, int]:
    """(the slot the new K/V of position ``pos`` go to, the last slot the
    read covers) in a static cache of ``s_cache`` slots. ``causal``: slot
    ``pos``, the read over slots <= pos. ``swa``: a ring of
    min(cache_len, window) slots, slot pos % s_cache; every slot up to
    ``pos`` holds one of the newest s_cache positions (once the ring has
    wrapped, all of them), which are the window's. ``local_chunk``: slot
    pos % attn_chunk; the read covers the slots of the current chunk only,
    those written since its start (the later ones hold the last chunk's
    keys)."""
    if kind == "swa":
        return pos % s_cache, pos
    if kind == "local_chunk":
        r = pos % cfg.attn_chunk
        return r, r
    return pos, pos


def _cache_attention(q, k, v, cache, n_heads: int, kind: str, cfg
                     ) -> torch.Tensor:
    """Decode against the monolithic cache of ONE layer, updated in place:
    cache = {"k", "v": (B, S_cache, Hkv, hd), "pos": tokens cached}; the
    new K/V go to ``_cache_slot``'s slot and the read covers the slots up
    to its last. The keys were roped at their absolute positions, so the
    slots' order does not matter. Plain masked attention, as the JAX
    package computes it in jnp outside any Pallas kernel
    (``repro/models/layers.py:339-356``), with the windowed kinds' ring
    and chunk masks following the forward's band (see the module
    docstring)."""
    ck, cv, pos = cache["k"], cache["v"], int(cache["pos"])
    slot, last = _cache_slot(kind, cfg, pos, ck.shape[1])
    ck[:, slot:slot + 1] = k
    cv[:, slot:slot + 1] = v
    kpos = torch.arange(ck.shape[1], device=q.device)
    mask = (kpos <= last)[None, None, None, :]
    return masked_sdpa(q, repeat_kv(ck, n_heads), repeat_kv(cv, n_heads),
                       mask, 1.0 / (q.shape[-1] ** 0.5))


def _banded(q, k, v, scale: float, band_chunk: int, lookback: int,
            window: int = 0) -> torch.Tensor:
    """Exact banded causal attention (``repro/models/layers.py:165-195``):
    query chunk i attends KV chunks [i - lookback, i]. lookback 0 is
    chunked-local attention (llama4); lookback 1 with band_chunk = W and a
    window mask is sliding-window attention (mixtral). q, k, v (B, S, H,
    hd) with S a multiple of band_chunk; logits in float32, masked with
    -1e30, probabilities rounded to q.dtype, as JAX's. Plain PyTorch (JAX's
    is jnp, outside any Pallas kernel), one query chunk at a time so that
    one chunk's (B, H, C, span) logits are alive at once."""
    b, s, h, hd = q.shape
    c = band_chunk
    nq = s // c
    if nq * c != s:
        raise ValueError(f"_banded: S {s} is not a multiple of the band "
                         f"chunk {c}")
    pad = lookback * c
    span = (lookback + 1) * c
    kp = torch.nn.functional.pad(k, (0, 0, 0, 0, pad, 0))
    vp = torch.nn.functional.pad(v, (0, 0, 0, 0, pad, 0))
    # positions relative to the chunk's start: the band's mask is the same
    # for every chunk but the first, whose lookback is padding
    qpos = torch.arange(c, device=q.device)[:, None]
    kpos = torch.arange(span, device=q.device)[None, :] - pad
    band = qpos >= kpos
    if window:
        band = band & (qpos - kpos < window)
    outs = []
    for i in range(nq):
        kb, vb = kp[:, i * c:i * c + span], vp[:, i * c:i * c + span]
        logits = torch.einsum("bqhd,bkhd->bhqk", q[:, i * c:(i + 1) * c],
                              kb).float() * scale
        mask = band & (kpos + i * c >= 0)
        logits = torch.where(mask, logits, torch.full((), -1e30,
                                                      device=q.device))
        probs = torch.softmax(logits, dim=-1).to(q.dtype)
        outs.append(torch.einsum("bhqk,bkhd->bqhd", probs, vb))
    return torch.cat(outs, dim=1)


def _chunked_bidir(q, k, v, scale: float, q_chunk: int, kv_chunk: int
                   ) -> torch.Tensor:
    """Non-causal attention in query chunks of ``q_chunk`` against key
    chunks of ``kv_chunk`` with an online softmax
    (``repro/models/layers.py:413-446``): float32 running max, sum and
    accumulator, each chunk's probabilities cast to q.dtype before the
    product with V; S a multiple of q_chunk, Sk of kv_chunk."""
    b, s, h, hd = q.shape
    sk = k.shape[1]
    if s % q_chunk or sk % kv_chunk:
        raise ValueError(f"_chunked_bidir: S {s} / {sk} is not a multiple "
                         f"of the chunks {q_chunk} / {kv_chunk}")
    outs = []
    for i in range(0, s, q_chunk):
        qq = q[:, i:i + q_chunk]
        m = torch.full((b, h, q_chunk), float("-inf"), device=q.device)
        l = torch.zeros((b, h, q_chunk), device=q.device)
        acc = torch.zeros((b, h, q_chunk, hd), device=q.device)
        for j in range(0, sk, kv_chunk):
            kk, vv = k[:, j:j + kv_chunk], v[:, j:j + kv_chunk]
            logit = torch.einsum("bqhd,bkhd->bhqk", qq, kk).float() * scale
            m_new = torch.maximum(m, logit.amax(-1))
            p = torch.exp(logit - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bhqk,bkhd->bhqd", p.to(q.dtype), vv).float()
            m = m_new
        out = (acc / torch.clamp(l, min=1e-30)[..., None]).to(q.dtype)
        outs.append(out.transpose(1, 2))
    return torch.cat(outs, dim=1)


def attention(params: Dict, x: torch.Tensor, cfg, *,
              positions: torch.Tensor, kind: str = "causal",
              kv_x: Optional[torch.Tensor] = None,
              cache: Optional[Dict] = None, q_chunk: int = 1024,
              kv_chunk: int = 1024, group=None) -> torch.Tensor:
    """Attention of ``kind`` (``ATTN_KINDS``). Self-attention kinds:
    paged (the serving engine, causal only) when ``cache`` holds pools;
    one decode token against the monolithic cache (the static reference
    loop) when it holds ``k``/``v``/``pos``; else over the sequence itself
    (the training forward): kernel K7 on the card for causal, and for a
    window or chunk that covers the sequence (the band degenerates to
    causal, as JAX's ``attention`` routes it); ``_banded`` otherwise;
    ``bidir`` unmasked, ``_chunked_bidir`` past S 2048. ``cross``: Q from
    x, K and V from ``kv_x``, or from the cache's ``xk``/``xv`` (B, Sk,
    Hkv, hd) when it holds them; no rope, unmasked.

    Under tensor parallelism (``group``, a ``sharding.ModelGroup``) the
    weights are this rank's heads: ``wq``/``wk``/``wv`` its columns,
    ``wo`` its rows. The head counts come from their shapes, and the
    output projection's partial sums are reduced over the ranks.

    A training group (``ModelGroup.train``, the training forward on a
    mesh) splits as ``param_spec`` does: ``wq`` and ``wo`` by heads where
    the heads divide the model axis (else the whole attention runs on
    every rank, without a collective), ``wk``/``wv`` by KV heads where
    those divide too; KV heads kept whole are computed on every rank and
    each takes its query heads' share. x enters through ``copy_in``, as
    do whole ``wk``/``wv`` (their gradient is each rank's share), and the
    output leaves through ``reduce_out``."""
    b, s, _ = x.shape
    if kind not in ATTN_KINDS:
        raise NotImplementedError(
            f"attention kind {kind!r} is not ported (one of {ATTN_KINDS})")
    hd = cfg.resolved_head_dim
    h, hkv = params["wq"].shape[-1] // hd, params["wk"].shape[-1] // hd
    wk, wv = params["wk"], params["wv"]
    train = group is not None and group.train
    if train:
        if cache is not None or kind in ("cross", "bidir"):
            raise NotImplementedError(
                "the training forward on a mesh runs self-attention only")
        if h == cfg.num_heads:          # heads whole on every rank
            group = None
        else:
            x = collectives.copy_in(x, group)
            if hkv == cfg.num_kv_heads:
                wk = collectives.copy_in(wk, group)
                wv = collectives.copy_in(wv, group)
    scale = 1.0 / hd ** 0.5
    q = (x @ params["wq"]).reshape(b, s, h, hd)
    if kind == "cross":
        if cache is not None and "xk" in cache:
            k, v = cache["xk"], cache["xv"]
        else:
            k = (kv_x @ params["wk"]).reshape(b, kv_x.shape[1], hkv, hd)
            v = (kv_x @ params["wv"]).reshape(b, kv_x.shape[1], hkv, hd)
        out = masked_sdpa(q, repeat_kv(k, h), repeat_kv(v, h), None, scale)
        return collectives.all_reduce(out.reshape(b, s, h * hd)
                                      @ params["wo"], group)
    k = (x @ wk).reshape(b, s, hkv, hd)
    v = (x @ wv).reshape(b, s, hkv, hd)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    if cache is None:
        if kind == "swa" and cfg.window >= s or \
                kind == "local_chunk" and cfg.attn_chunk >= s:
            kind = "causal"
        if train and group is not None and hkv == cfg.num_kv_heads:
            # whole KV heads: this rank's query heads' share of them
            kf = repeat_kv(k, cfg.num_heads).narrow(2, group.rank * h, h)
            vf = repeat_kv(v, cfg.num_heads).narrow(2, group.rank * h, h)
        else:
            kf, vf = repeat_kv(k, h), repeat_kv(v, h)
        if kind == "causal":
            out = ops.flash_attention(q, kf, vf)
        elif kind == "bidir":
            out = _chunked_bidir(q, kf, vf, scale, q_chunk, kv_chunk) \
                if s > 2048 else masked_sdpa(q, kf, vf, None, scale)
        elif kind == "local_chunk":
            out = _banded(q, kf, vf, scale, cfg.attn_chunk, 0)
        else:
            out = _banded(q, kf, vf, scale, cfg.window, 1,
                          window=cfg.window)
    elif "kpool" in cache:
        if kind != "causal":
            raise NotImplementedError(
                "paged KV serving does not support windowed/chunked "
                "attention")
        out = _paged_attention(q, k, v, cache)
    else:
        out = _cache_attention(q, k, v, cache, h, kind, cfg)
    out = out.reshape(b, s, h * hd) @ params["wo"]
    if train:
        return collectives.reduce_out(out, group)
    return collectives.all_reduce(out, group)


def embed_init(vocab: int, d_model: int, dtype: torch.dtype,
               generator: torch.Generator, device: torch.device
               ) -> torch.Tensor:
    return (INIT_STD * torch.randn((vocab, d_model), generator=generator,
                                   device=device)).to(dtype)


def embed_lookup(table: torch.Tensor, tokens: torch.Tensor, group=None
                 ) -> torch.Tensor:
    """The tokens' rows of ``table``. Under tensor parallelism the table is
    this rank's block of vocab rows: each rank looks up the tokens it
    holds, zeroes the others, and the sum over the ranks is the lookup
    (``reduce_out`` under a training group)."""
    if group is None:
        return table[tokens.long()]
    rows = table.shape[0]
    local = tokens.long() - group.rank * rows
    hit = (local >= 0) & (local < rows)
    out = torch.where(hit[..., None], table[local.clamp(0, rows - 1)],
                      torch.zeros((), dtype=table.dtype, device=table.device))
    if group.train:
        return collectives.reduce_out(out, group)
    return collectives.all_reduce(out, group)


def lm_logits(x: torch.Tensor, table: torch.Tensor, group=None
              ) -> torch.Tensor:
    """x @ table^T. Under tensor parallelism the table is this rank's block
    of vocab rows: its logits columns are gathered over the ranks in rank
    order, so every rank holds the whole row (JAX's replicated logits).
    Under a training group x enters through ``copy_in`` and the gather's
    backward keeps this rank's columns (``gather_last``)."""
    if group is not None and group.train:
        return collectives.gather_last(torch.einsum(
            "bsd,vd->bsv", collectives.copy_in(x, group), table), group)
    return collectives.all_gather_last(torch.einsum("bsd,vd->bsv", x, table),
                                       group)
