"""Dense-family LM for training and paged serving (ports ``forward``,
``loss_fn`` and the paged entry points of ``repro/models/lm.py``).

Public API:
  init(cfg, device=None, seed=0)             -> params
  prepare_params(params)                     -> params (+ derived weights)
  trainable(params)                          -> params (- derived weights)
  forward(params, batch, cfg)                -> (logits, aux)  [training]
  loss_fn(params, batch, cfg, l1_coeff=None) -> (loss, (metrics, aux))
  init_paged_cache(cfg, num_blocks, block_size, device=None) -> pools
  paged_prefill(params, pools, block_tables, tokens, num_new, cfg, ...)
  paged_decode_step(params, pools, block_tables, seq_lens, tokens, cfg, ...)
  paged_verify(params, pools, block_tables, start_lens, num_new, tokens, cfg)

Parameters keep the JAX pytree: ``embed``, ``final_ln``, ``blocks`` with
every per-layer leaf stacked on a leading L axis, so ``bridge.py`` maps one
onto the other leaf for leaf. The layer stack is a Python loop (the JAX
package scans); the training forward unbinds the stacked leaves once, so
autograd sums each layer's gradient into one slice, not into a zero tensor
the size of the whole stack per layer. ``remat`` (the JAX package's
recomputation of layer activations in the backward) is not ported: the
training forward keeps every layer's activations. The KV pools are
updated in place; the paged entry points return them anyway, in the JAX
package's ``(logits, pools)`` shape.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch import device as device_mod
from repro_torch.config import ModelConfig
from repro_torch.core import sparse_ffn
from repro_torch.models.layers import (attention, attn_init, embed_init,
                                       embed_lookup, lm_logits, norm_apply,
                                       norm_init)

_NORMS = ("rmsnorm", "layernorm", "nonparametric_ln")


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family != "dense" or cfg.norm not in _NORMS:
        raise NotImplementedError(
            f"the port serves the dense family with a norm of {_NORMS}; got "
            f"family {cfg.family!r}, norm {cfg.norm!r}")


def init(cfg: ModelConfig, device=None, seed: int = 0) -> Dict[str, Any]:
    """Random parameters (normal, std 0.02) from a ``torch.Generator``
    seeded with ``seed`` on ``device`` (default: the card)."""
    _check_family(cfg)
    dev = device_mod.resolve(device)
    dtype = device_mod.torch_dtype(cfg.param_dtype)
    gen = torch.Generator(device=dev).manual_seed(seed)
    d, L = cfg.d_model, cfg.num_layers

    layers = []
    for _ in range(L):
        layers.append({
            "ln1": norm_init(cfg.norm, d, dtype, dev),
            "ln2": norm_init(cfg.norm, d, dtype, dev),
            "attn": attn_init(d, cfg.num_heads, cfg.num_kv_heads,
                              cfg.resolved_head_dim, dtype, gen, dev),
            "ffn": sparse_ffn.init(d, cfg.d_ff, cfg.gated, dtype, gen, dev),
        })
    blocks = {name: {k: torch.stack([p[name][k] for p in layers])
                     for k in layers[0][name]}
              for name in ("ln1", "ln2", "attn", "ffn")}
    params: Dict[str, Any] = {
        "embed": embed_init(cfg.padded_vocab, d, dtype, gen, dev),
        "final_ln": norm_init(cfg.norm, d, dtype, dev),
        "blocks": blocks,
    }
    if not cfg.tied_embeddings:
        params["lm_head"] = embed_init(cfg.padded_vocab, d, dtype, gen, dev)
    return prepare_params(params)


def prepare_params(params: Dict[str, Any]) -> Dict[str, Any]:
    """Add the weights derived once at load time: for a gated FFN (one with
    ``wg``), ``blocks.ffn.wu_t``, W_u transposed to (L, N, K), which the
    TwELL fused kernel (K2), its only reader, takes by row; a non-gated FFN
    gets none. Idempotent."""
    ffn = params["blocks"]["ffn"]
    if "wg" in ffn and "wu_t" not in ffn:
        ffn["wu_t"] = ffn["wu"].transpose(-1, -2).contiguous()
    return params


def trainable(params: Dict[str, Any]) -> Dict[str, Any]:
    """The parameters an optimizer updates: the tree without the derived
    ``blocks.ffn.wu_t`` (re-derive it with ``prepare_params`` before
    serving trained weights)."""
    ffn = {k: v for k, v in params["blocks"]["ffn"].items() if k != "wu_t"}
    return {**params, "blocks": {**params["blocks"], "ffn": ffn}}


def params_to(params, device) -> Dict[str, Any]:
    """The same parameter tree with every tensor on ``device``."""
    if isinstance(params, dict):
        return {k: params_to(v, device) for k, v in params.items()}
    return params.to(device)


def _layer(tree, l: int):
    if isinstance(tree, dict):
        return {k: _layer(v, l) for k, v in tree.items()}
    return tree[l]


def init_paged_cache(cfg: ModelConfig, num_blocks: int, block_size: int,
                     device=None) -> Dict[str, torch.Tensor]:
    """Block-paged KV pools, (L, num_blocks, block_size, Hkv, hd) each;
    block 0 is the null block (see serving/kv_cache.py)."""
    _check_family(cfg)
    if cfg.window or cfg.attn_chunk:
        raise NotImplementedError(
            "paged KV serving does not support windowed/chunked attention yet")
    dev = device_mod.resolve(device)
    dtype = device_mod.torch_dtype(cfg.param_dtype)
    shape = (cfg.num_layers, num_blocks, block_size, cfg.num_kv_heads,
             cfg.resolved_head_dim)
    return {"kpool": torch.zeros(shape, dtype=dtype, device=dev),
            "vpool": torch.zeros(shape, dtype=dtype, device=dev)}


def _block_apply(p, x, cfg, positions, cache, collect_aux, kind="causal"):
    a = attention(p["attn"], norm_apply(cfg.norm, p["ln1"], x), cfg,
                  positions=positions, kind=kind, cache=cache)
    x = x + a
    y, aux = sparse_ffn.apply(p["ffn"], norm_apply(cfg.norm, p["ln2"], x),
                              cfg.sparsity, cfg.gated,
                              collect_aux=collect_aux)
    return x + y, aux


def _paged_scan(params, x, pools, cfg, positions, block_tables, seq_lens,
                num_new=None, write_valid=None, last_rows=None,
                collect_aux=False):
    probes = []
    for l in range(cfg.num_layers):
        cache = {"kpool": pools["kpool"][l], "vpool": pools["vpool"][l],
                 "block_tables": block_tables, "seq_lens": seq_lens}
        if num_new is not None:
            cache["num_new"] = num_new
        if write_valid is not None:
            cache["write_valid"] = write_valid
        x, aux = _block_apply(_layer(params["blocks"], l), x, cfg, positions,
                              cache, collect_aux)
        if collect_aux:
            probes.append(aux)
    if last_rows is not None:
        # keep only each row's last valid hidden state before the O(V) head
        x = x[torch.arange(x.shape[0], device=x.device), last_rows.long()
              ][:, None]
    x = norm_apply(cfg.norm, params["final_ln"], x)
    head = params["embed"] if cfg.tied_embeddings else params["lm_head"]
    logits = lm_logits(x, head)
    if collect_aux:
        aux_stack = {k: torch.stack([a[k] for a in probes])
                     for k in ("nnz_mean", "tile_frac")}
        aux_stack["ffn_present"] = torch.ones(cfg.num_layers,
                                              device=x.device)
        return logits, aux_stack, pools
    return logits, pools


def _attn_kind(cfg) -> str:
    if cfg.window:
        return "swa"
    if cfg.attn_chunk:
        return "local_chunk"
    return "causal"


def _unstack(tree, n: int):
    """Stacked (L, ...) leaves -> a list of L per-layer trees (views)."""
    if isinstance(tree, dict):
        per = {k: _unstack(v, n) for k, v in tree.items()}
        return [{k: per[k][l] for k in per} for l in range(n)]
    return list(torch.unbind(tree))


def forward(params: Dict, batch: Dict, cfg: ModelConfig):
    """Training forward of the dense family: tokens (B, S) -> (logits
    (B, S, V), aux), aux stacked per layer as the JAX package stacks it
    (``l1``, ``nnz_mean``, ``nnz_max``, ``neuron_active``, ``tile_frac``,
    ``ffn_present`` = 1, ``moe_balance`` = 0)."""
    _check_family(cfg)
    tokens = batch["tokens"]
    x = embed_lookup(params["embed"], tokens)
    positions = torch.arange(tokens.shape[1], device=x.device)
    kind = _attn_kind(cfg)
    auxs = []
    for p in _unstack(params["blocks"], cfg.num_layers):
        x, aux = _block_apply(p, x, cfg, positions, None, True, kind=kind)
        aux["ffn_present"] = torch.ones((), device=x.device)
        aux["moe_balance"] = torch.zeros((), device=x.device)
        auxs.append(aux)
    aux = {k: torch.stack([a[k] for a in auxs]) for k in auxs[0]}
    x = norm_apply(cfg.norm, params["final_ln"], x)
    head = params["embed"] if cfg.tied_embeddings else params["lm_head"]
    return lm_logits(x, head), aux


def loss_fn(params: Dict, batch: Dict, cfg: ModelConfig, l1_coeff=None,
            moe_balance_coeff: float = 0.01):
    """Cross-entropy (f32 logsumexp) + Eq. 2 L1 regularization (the mean
    over FFN-bearing layers) -> (loss, (metrics, aux))."""
    logits, aux = forward(params, batch, cfg)
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    gold = torch.gather(lf, -1, batch["labels"].long()[..., None])[..., 0]
    ce = (lse - gold).mean()
    mask = aux["ffn_present"]
    denom = torch.clamp(mask.sum(), min=1)
    l1_mean = (aux["l1"] * mask).sum() / denom
    coeff = cfg.sparsity.l1_coeff if l1_coeff is None else l1_coeff
    bal = (aux["moe_balance"] * mask).sum() / denom
    loss = ce + coeff * l1_mean + moe_balance_coeff * bal
    metrics = {"ce": ce, "l1": l1_mean,
               "nnz_mean": (aux["nnz_mean"] * mask).sum() / denom,
               "nnz_max": aux["nnz_max"].max(), "moe_balance": bal,
               "loss": loss}
    return loss, (metrics, aux)


def paged_prefill(params: Dict, pools: Dict, block_tables: torch.Tensor,
                  tokens: torch.Tensor, num_new: torch.Tensor,
                  cfg: ModelConfig, start_lens: Optional[torch.Tensor] = None,
                  last_only: bool = False, collect_aux: bool = False):
    """Prefill a prompt chunk into the paged pools, appending to any cached
    history. tokens: (B, C) right-padded chunk; num_new: (B,) valid chunk
    lengths; start_lens: (B,) tokens already cached (None = 0); all int32.

    Returns (logits, pools): (B, C, V) logits (rows past num_new are
    garbage), or with ``last_only`` each row's last valid position only,
    (B, 1, V). ``collect_aux`` adds a per-layer sparsity probe
    ``{"nnz_mean", "tile_frac", "ffn_present"}`` (L,) in the middle."""
    x = embed_lookup(params["embed"], tokens)
    if start_lens is None:
        start_lens = torch.zeros_like(num_new)
    positions = start_lens[:, None] + \
        torch.arange(tokens.shape[1], device=tokens.device)[None, :]
    last_rows = torch.clamp(num_new - 1, 0, tokens.shape[1] - 1) \
        if last_only else None
    return _paged_scan(params, x, pools, cfg, positions, block_tables,
                       start_lens, num_new=num_new, last_rows=last_rows,
                       collect_aux=collect_aux)


def paged_decode_step(params: Dict, pools: Dict, block_tables: torch.Tensor,
                      seq_lens: torch.Tensor, tokens: torch.Tensor,
                      cfg: ModelConfig,
                      write_valid: Optional[torch.Tensor] = None,
                      collect_aux: bool = False):
    """Continuous-batching decode: one token per request. tokens: (B, 1);
    seq_lens: (B,) cached lengths (the new token is written there);
    ``write_valid`` (B,) bool sends a row's KV write to the null block when
    False (speculative draft steps past a request's budget). Returns
    (logits (B, 1, V), pools). Padded rows (all-null table, seq_len 0)
    produce garbage logits."""
    x = embed_lookup(params["embed"], tokens)
    positions = seq_lens[:, None]
    return _paged_scan(params, x, pools, cfg, positions, block_tables,
                       seq_lens, write_valid=write_valid,
                       collect_aux=collect_aux)


def paged_verify(params: Dict, pools: Dict, block_tables: torch.Tensor,
                 start_lens: torch.Tensor, num_new: torch.Tensor,
                 tokens: torch.Tensor, cfg: ModelConfig):
    """Speculative verify: score a drafted chunk in one batched pass.

    tokens (B, S): per request the last committed token followed by its
    drafts (right-padded); start_lens (B,) cached lengths; num_new (B,)
    valid chunk lengths. Writes exact K/V over whatever the draft left and
    returns (logits (B, S, V), pools); row j scores the token after
    position start + j. This is the chunk-append regime, so it delegates to
    ``paged_prefill`` and the two cannot drift apart."""
    return paged_prefill(params, pools, block_tables, tokens, num_new, cfg,
                         start_lens=start_lens)
