"""Mamba2 (SSD) block of the zamba2 hybrid architecture (ports
``repro/models/mamba2.py``).

The training forward is the chunked SSD (state space duality) form: within
a chunk an attention-like product with a decay kernel, across chunks a
recurrent state carried in float32. The JAX package scans the chunks; here
they run as a Python loop. Decode is one recurrent state update a token.
Both are plain PyTorch, as the reference is plain ``jnp`` (no Pallas
kernel): the products stay ``torch.matmul``/``einsum``.

The paper's FFN sparsity does not apply inside Mamba2 (it has no (M, N)
post-activation hidden layer); the block is ported without it.

Parameters keep the JAX leaves and dtypes: ``a_log``, ``d_skip`` and
``dt_bias`` are float32 in a bfloat16 model, ``in_proj``, ``conv_w``,
``norm_scale`` and ``out_proj`` take the parameter dtype. The decode
cache's ``state`` is float32, its ``conv`` window the model's dtype.

``F.softplus`` returns x itself above its threshold 20, where JAX's
``softplus`` (log(1 + e^x)) differs from x by under e^-20.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.layers import INIT_STD, rmsnorm


def mamba2_dims(cfg):
    d_inner = cfg.ssm_expand * cfg.d_model
    n_heads = d_inner // cfg.ssm_head_dim
    return d_inner, n_heads, cfg.ssm_state


def mamba2_init(cfg, dtype: torch.dtype, generator: torch.Generator,
                device: torch.device) -> Dict[str, torch.Tensor]:
    d = cfg.d_model
    d_inner, n_heads, d_state = mamba2_dims(cfg)

    def r(shape):
        return (INIT_STD * torch.randn(shape, generator=generator,
                                       device=device)).to(dtype)
    # in_proj -> [z (gate), x, B, C, dt]
    d_in_proj = 2 * d_inner + 2 * d_state + n_heads
    heads = torch.arange(1, n_heads + 1, dtype=torch.float32, device=device)
    return {
        "in_proj": r((d, d_in_proj)),
        "conv_w": r((cfg.ssm_conv_width, d_inner + 2 * d_state)),
        "a_log": torch.log(heads),
        "d_skip": torch.ones((n_heads,), dtype=torch.float32, device=device),
        "dt_bias": torch.zeros((n_heads,), dtype=torch.float32,
                               device=device),
        "norm_scale": torch.ones((d_inner,), dtype=dtype, device=device),
        "out_proj": r((d_inner, d)),
    }


def _split_proj(cfg, proj):
    d_inner, n_heads, d_state = mamba2_dims(cfg)
    return torch.split(proj, [d_inner, d_inner, d_state, d_state, n_heads],
                       dim=-1)


def _conv_step(conv_w, window):
    """Depthwise causal conv over a (B, W, C) window -> (B, C)."""
    return torch.einsum("bwc,wc->bc", window, conv_w)


def _chunk_step(state, xc, bc, cc, dac, dtc, tri):
    """One chunk of the SSD form: state (B, H, hd, N) float32; xc (B, C, H,
    hd), bc and cc (B, C, N), dac and dtc (B, C, H). Returns (the state
    after the chunk, y (B, C, H, hd))."""
    cum = torch.cumsum(dac, dim=1)                               # (B, C, H)
    # within-chunk (causal "attention" with a decay kernel)
    decay = cum[:, :, None, :] - cum[:, None, :, :]              # (B,Cq,Ck,H)
    # mask BEFORE exp: a future entry's decay is >= 0 and would overflow,
    # and inf * 0 in the backward of a mask after exp gives NaN
    kern = torch.exp(torch.where(tri[None, :, :, None], decay,
                                 torch.full((), -1e30, device=decay.device)))
    qk = torch.einsum("bqn,bkn->bqk", cc, bc)                    # (B, Cq, Ck)
    w_attn = qk[:, :, :, None] * kern * dtc[:, None, :, :]      # (B,Cq,Ck,H)
    y_intra = torch.einsum("bqkh,bkhd->bqhd", w_attn, xc)
    # contribution of the carried-in state
    y_state = torch.einsum("bqn,bhdn,bqh->bqhd", cc, state, torch.exp(cum))
    # the state handed to the next chunk
    decay_to_end = torch.exp(cum[:, -1:, :] - cum)               # (B, C, H)
    state = state * torch.exp(cum[:, -1])[:, :, None, None] + torch.einsum(
        "bkn,bkhd,bkh->bhdn", bc, xc, decay_to_end * dtc)
    return state, y_intra + y_state


def mamba2_apply(params, x: torch.Tensor, cfg, chunk: int = 256
                 ) -> torch.Tensor:
    """Training/prefill forward. x: (B, S, D) -> (B, S, D). S is padded to
    a multiple of ``chunk``; the padding's outputs are dropped."""
    b, s, d = x.shape
    d_inner, n_heads, d_state = mamba2_dims(cfg)
    hd = cfg.ssm_head_dim
    z, xs, bmat, cmat, dt = _split_proj(cfg, x @ params["in_proj"])
    # causal depthwise conv on [x, B, C]
    xbc = torch.cat([xs, bmat, cmat], dim=-1)
    w = params["conv_w"].to(xbc.dtype)
    width = cfg.ssm_conv_width
    pad = F.pad(xbc, (0, 0, width - 1, 0))
    conv = sum(pad[:, i:i + s] * w[i] for i in range(width))
    conv = F.silu(conv)
    xs, bmat, cmat = torch.split(conv, [d_inner, d_state, d_state], dim=-1)

    dt = F.softplus(dt.float() + params["dt_bias"])             # (B, S, H)
    a = -torch.exp(params["a_log"])                              # (H,)
    da = dt * a                                                  # log-decay
    xh = xs.reshape(b, s, n_heads, hd)

    padlen = (-s) % chunk
    if padlen:
        def padded(t):
            return F.pad(t, (0,) * (2 * (t.dim() - 2)) + (0, padlen))
        xh_p, bmat, cmat, da, dt = map(padded, (xh, bmat, cmat, da, dt))
    else:
        xh_p = xh
    xf, bf, cf = xh_p.float(), bmat.float(), cmat.float()
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                device=x.device))
    state = torch.zeros((b, n_heads, hd, d_state), dtype=torch.float32,
                        device=x.device)
    ys = []
    for c0 in range(0, s + padlen, chunk):
        sl = slice(c0, c0 + chunk)
        state, yc = _chunk_step(state, xf[:, sl], bf[:, sl], cf[:, sl],
                                da[:, sl], dt[:, sl], tri)
        ys.append(yc)
    y = torch.cat(ys, dim=1)[:, :s]
    y = y + xh.float() * params["d_skip"][None, None, :, None]
    y = y.reshape(b, s, d_inner).to(x.dtype)
    y = rmsnorm(y, params["norm_scale"]) * F.silu(z)
    return y @ params["out_proj"]


def mamba2_cache_init(cfg, batch: int, dtype: torch.dtype,
                      device: torch.device) -> Dict[str, torch.Tensor]:
    d_inner, n_heads, d_state = mamba2_dims(cfg)
    return {
        "state": torch.zeros((batch, n_heads, cfg.ssm_head_dim, d_state),
                             dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, cfg.ssm_conv_width - 1,
                             d_inner + 2 * d_state), dtype=dtype,
                            device=device),
    }


def mamba2_decode(params, x: torch.Tensor, cfg, cache: Dict
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Single-token decode. x: (B, 1, D) -> ((B, 1, D), the new cache
    {"state", "conv"}; the given one is left as it was)."""
    b = x.shape[0]
    d_inner, n_heads, d_state = mamba2_dims(cfg)
    hd = cfg.ssm_head_dim
    z, xs, bmat, cmat, dt = _split_proj(cfg, x[:, 0] @ params["in_proj"])
    xbc = torch.cat([xs, bmat, cmat], dim=-1)                    # (B, C_in)
    window = torch.cat([cache["conv"], xbc[:, None]], dim=1)
    conv = F.silu(_conv_step(params["conv_w"].to(xbc.dtype), window))
    new_conv = window[:, 1:]
    xs, bmat, cmat = torch.split(conv, [d_inner, d_state, d_state], dim=-1)
    dt = F.softplus(dt.float() + params["dt_bias"])             # (B, H)
    a = -torch.exp(params["a_log"])
    decay = torch.exp(dt * a)                                    # (B, H)
    xh = xs.reshape(b, n_heads, hd).float()
    state = cache["state"] * decay[:, :, None, None] + torch.einsum(
        "bn,bhd,bh->bhdn", bmat.float(), xh, dt)
    y = torch.einsum("bn,bhdn->bhd", cmat.float(), state)
    y = y + xh * params["d_skip"][None, :, None]
    y = y.reshape(b, d_inner).to(x.dtype)
    y = rmsnorm(y, params["norm_scale"]) * F.silu(z)
    return (y @ params["out_proj"])[:, None], {"state": state,
                                               "conv": new_conv}
