"""RWKV-6 (Finch) block: attention-free time mix with data-dependent decay
plus the channel-mix FFN (ports ``repro/models/rwkv6.py``).
[arXiv:2404.05892]

The channel mix is a non-gated SparseFFN with squared-ReLU activations,
the setting of the paper's non-gated TwELL path: it runs through
``core/sparse_ffn.apply`` with ``activation="relu2"`` (on the card K1 +
K6 under ``gather``, K8/K9 under ``hybrid``).

The WKV recurrence takes the JAX package's two paths and its rule between
them: the chunked form (``_wkv_chunked``, a chunk of tokens as products
and one state update) when ``rwkv_chunk`` is set, divides S and is below
it, else the per-token scan (always at decode, S = 1). The two agree only
to about 5e-4 at strong decays (the clips below), so the port must pick
the path JAX picks. Both are plain PyTorch, as the reference is plain
``jnp`` (no Pallas kernel); the chunks and tokens run as Python loops.

Parameters keep the JAX leaves and dtypes: ``u`` and ``w0`` are float32,
``mix`` and the projections take the parameter dtype.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core import sparse_ffn
from repro_torch.models.layers import INIT_STD


def rwkv_dims(cfg):
    n_heads = cfg.d_model // cfg.rwkv_head_dim
    return n_heads, cfg.rwkv_head_dim


def timemix_init(cfg, dtype: torch.dtype, generator: torch.Generator,
                 device: torch.device) -> Dict[str, torch.Tensor]:
    d = cfg.d_model
    lora = 64

    def r(shape):
        return (INIT_STD * torch.randn(shape, generator=generator,
                                       device=device)).to(dtype)
    p = {"mix": torch.full((5, d), 0.5, device=device).to(dtype)}
    for name in ("wr", "wk", "wv", "wg", "wo"):
        p[name] = r((d, d))
    p["w0"] = torch.full((d,), -6.0, dtype=torch.float32, device=device)
    p["wa"], p["wb"] = r((d, lora)), r((lora, d))
    p["u"] = r((d,)).float()               # bonus ("first token")
    return p


def _token_shift(x: torch.Tensor, prev: Optional[torch.Tensor] = None
                 ) -> torch.Tensor:
    """x_{t-1} feature mix; prev: (B, D) carried state for decode."""
    if prev is None:
        return F.pad(x, (0, 0, 1, 0))[:, :-1]
    return torch.cat([prev[:, None], x[:, :-1]], dim=1)


def _wkv_scan(r, k, v, w, u, wkv):
    """The per-token WKV recurrence. r, k, v, w (B, S, H, hd) float32, u
    (H, hd), wkv (B, H, hd, hd) -> (the final state, out (B, S, H, hd))."""
    outs = []
    for t in range(r.shape[1]):
        rt, kt, vt, wt = r[:, t], k[:, t], v[:, t], w[:, t]
        kv = torch.einsum("bhk,bhv->bhkv", kt, vt)
        outs.append(torch.einsum("bhk,bhkv->bhv", rt,
                                 wkv + u[None][..., None] * kv))
        wkv = wkv * wt[..., None] + kv
    return wkv, torch.stack(outs, dim=1)


def _wkv_chunked(r, k, v, w, u, wkv0, chunk: int):
    """Chunked WKV: within a chunk the per-channel-decay linear attention
    factorizes,

      att[i, j] = sum_c r_i[c] e^{lc_{i-1}[c]} * k_j[c] e^{-lc_j[c]},  j < i

    (lc the cumulative log decay), so a chunk of C tokens runs as products
    plus one state update. r, k, v, w (B, S, H, hd) float32; returns
    (state (B, H, hd, hd), out (B, S, H * hd)). The clips (w to [1e-12, 1],
    the exponents to 30 in magnitude) are the JAX package's."""
    b, s, h, hd = r.shape
    nc = s // chunk

    def to_c(t):                                   # (nc, B, H, C, hd)
        return t.reshape(b, nc, chunk, h, hd).permute(1, 0, 3, 2, 4)

    rc, kc, vc, wc = map(to_c, (r, k, v, w))
    lw = torch.log(torch.clamp(wc, 1e-12, 1.0))    # log decay, <= 0
    lc = torch.cumsum(lw, dim=3)
    lend = lc[:, :, :, -1:, :]
    r_dec = rc * torch.exp(torch.clamp(lc - lw, -30, 0))   # r_i e^{lc_{i-1}}
    k_inv = kc * torch.exp(torch.clamp(-lc, 0, 30))        # k_j e^{-lc_j}
    k_end = kc * torch.exp(torch.clamp(lend - lc, -30, 0))
    dec_all = torch.exp(torch.clamp(lend[:, :, :, 0, :], -30, 0))
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                device=r.device), diagonal=-1)
    zero = torch.zeros((), device=r.device)
    state, outs = wkv0, []
    for i in range(nc):
        rd, ki, ke, vc_, rc_, kc_ = (r_dec[i], k_inv[i], k_end[i], vc[i],
                                     rc[i], kc[i])
        att = torch.einsum("bhid,bhjd->bhij", rd, ki)      # strict lower part
        att = torch.where(tri[None, None], att, zero)
        y_intra = torch.einsum("bhij,bhjd->bhid", att, vc_)
        # the current token's bonus (u)
        y_u = torch.einsum("bhid,bhid->bhi", rc_,
                           u[None, :, None, :] * kc_)[..., None] * vc_
        # the carried state: r_i e^{lc_{i-1}} . S_in
        y_state = torch.einsum("bhid,bhdv->bhiv", rd, state)
        # S_out = S_in e^{lc_last} + sum_j (k_j e^{lc_last - lc_j}) v_j
        state = state * dec_all[i][..., None] + torch.einsum(
            "bhjd,bhjv->bhdv", ke, vc_)
        outs.append(y_intra + y_u + y_state)
    out = torch.stack(outs).permute(1, 0, 3, 2, 4).reshape(b, s, h * hd)
    return state, out


def timemix_apply(params, x: torch.Tensor, cfg, state=None
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x: (B, S, D). state: {"wkv": (B, H, hd, hd), "shift": (B, D)} or
    None. Returns (y, {"wkv", "shift"}): the state after the last token."""
    b, s, d = x.shape
    h, hd = rwkv_dims(cfg)
    prev = None if state is None else state["shift"]
    xs = _token_shift(x, prev)
    mix = params["mix"]
    xr, xk, xv, xw, xg = [x + (xs - x) * mix[i] for i in range(5)]
    r = (xr @ params["wr"]).reshape(b, s, h, hd)
    k = (xk @ params["wk"]).reshape(b, s, h, hd)
    v = (xv @ params["wv"]).reshape(b, s, h, hd)
    g = F.silu(xg @ params["wg"])
    # data-dependent decay (Finch): w_t = exp(-exp(w0 + tanh(x wa) wb))
    dd = params["w0"] + (torch.tanh(xw.float() @ params["wa"].float())
                         @ params["wb"].float())
    w = torch.exp(-torch.exp(dd)).reshape(b, s, h, hd)           # in (0, 1)
    u = params["u"].reshape(h, hd)
    wkv0 = torch.zeros((b, h, hd, hd), dtype=torch.float32,
                       device=x.device) if state is None else state["wkv"]
    chunk = getattr(cfg, "rwkv_chunk", 0) or 0
    if chunk and s % chunk == 0 and s > chunk:
        wkv, out = _wkv_chunked(r.float(), k.float(), v.float(), w.float(),
                                u, wkv0, chunk)
    else:
        wkv, out = _wkv_scan(r.float(), k.float(), v.float(), w.float(), u,
                             wkv0)
    y = out.reshape(b, s, d).to(x.dtype)
    # a norm per head without scale (rms per head stands for RWKV's
    # GroupNorm, as in the JAX package)
    yh = y.reshape(b, s, h, hd).float()
    yh = yh * torch.rsqrt(torch.mean(torch.square(yh), dim=-1, keepdim=True)
                          + 1e-6)
    y = yh.reshape(b, s, d).to(x.dtype) * g
    return y @ params["wo"], {"wkv": wkv, "shift": x[:, -1]}


def channelmix_init(cfg, dtype: torch.dtype, generator: torch.Generator,
                    device: torch.device) -> Dict[str, torch.Tensor]:
    p = sparse_ffn.init(cfg.d_model, cfg.d_ff, False, dtype, generator,
                        device)
    p["mix"] = torch.full((1, cfg.d_model), 0.5, device=device).to(dtype)
    return p


def channelmix_apply(params, x: torch.Tensor, cfg, scfg, state=None,
                     collect_aux=False):
    """The channel mix: token-shifted non-gated SparseFFN (relu^2) ->
    (y, {"shift"}, aux); ``collect_aux`` as ``sparse_ffn.apply``'s."""
    prev = None if state is None else state["shift"]
    xs = _token_shift(x, prev)
    xk = x + (xs - x) * params["mix"][0]
    ffn_params = {"wu": params["wu"], "wd": params["wd"]}
    y, aux = sparse_ffn.apply(ffn_params, xk, scfg, False,
                              collect_aux=collect_aux)
    return y, {"shift": x[:, -1]}, aux
