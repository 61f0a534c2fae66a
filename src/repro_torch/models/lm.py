"""LM of the dense, MoE, hybrid (zamba2), ssm (rwkv6), vlm (llama-3.2
vision) and audio (whisper) families for training and serving (ports
``forward``, ``loss_fn``, the paged entry points, the cross-attention
caches and the static decode of ``repro/models/lm.py``).

Public API:
  init(cfg, device=None, seed=0)             -> params
  prepare_params(params)                     -> params (+ derived weights)
  trainable(params)                          -> params (- derived weights)
  forward(params, batch, cfg, collect_aux=True, mesh=None)
                                             -> (logits, aux) [training]
  loss_fn(params, batch, cfg, l1_coeff=None, mesh=None)
                                             -> (loss, (metrics, aux))
  train_specs(cfg, mesh)                     -> the trainable tree's specs
  init_paged_cache(cfg, num_blocks, block_size, device=None, kv_heads=None)
                                             -> pools
  paged_prefill(params, pools, block_tables, tokens, num_new, cfg, ...)
  paged_decode_step(params, pools, block_tables, seq_lens, tokens, cfg, ...)
  paged_verify(params, pools, block_tables, start_lens, num_new, tokens, cfg)
  init_cache(cfg, batch, cache_len, device=None, enc_len=0, num_patches=0)
                                             -> cache  [static loop]
  encode_frames(params, frames, cfg)         -> (B, S_a, D)  [audio]
  prefill_cross_cache(params, cache, batch, cfg) -> cache  [audio, vlm]
  decode_step(params, cache, tokens, cfg)    -> (logits, cache)

Parameters keep the JAX pytree: ``embed``, ``final_ln``, ``blocks`` with
every per-layer leaf stacked on a leading L axis (a MoE block's ``moe``:
``router`` (L, D, E) and ``experts`` with (L, E, ...) leaves, in place of
``ffn``; a hybrid layer's ``ln`` and ``mamba``, with the one shared
transformer block unstacked in ``shared_attn``; an ssm layer's ``ln1``,
``ln2``, time mix ``tm`` and channel mix ``cm``); the vlm family's
``blocks.selfs`` with (nb, cross_every - 1, ...) leaves and
``blocks.cross``, the tanh-gated cross-attention block of each of the nb
super-blocks, with (nb, ...) leaves (its gates ``gate_attn`` and
``gate_ffn`` (nb,)); the audio family's ``enc_blocks`` (encoder_layers,
...), ``dec_blocks`` (L, ...) with the cross-attention ``lnx`` and
``xattn``, ``enc_ln`` and the stub front end's ``frontend_proj`` (D, D),
so ``bridge.py`` maps one onto the other leaf for leaf. The
layer stack is a Python loop (the JAX package scans); the training
forward unbinds the stacked leaves once, so autograd sums each layer's
gradient into one slice, not into a zero tensor the size of the whole
stack per layer. The training forward runs its layers
through ``stacked_layers``, which applies ``cfg.remat`` as the JAX
package's ``stacked_scan`` does (``none``, ``full``, ``dots``, ``2level``);
the paged serving entry points run no backward and ignore it. The KV pools
are updated in place; the paged entry points return them anyway, in the JAX
package's ``(logits, pools)`` shape. ``collect_aux`` on a paged entry
point asks the FFN for the serving probe only (``nnz_mean``, ``tile_frac``;
``sparse_ffn.PROBE``), never for training's L1 statistics.

``init_cache`` / ``decode_step`` are the monolithic-cache decode of the
static reference loop (``launch/serve.py:generate``): one (L, B, S, Hkv,
hd) cache per K and V, one token a call; a window's cache is a ring of
min(S, window) slots and a local chunk's one of min(S, attn_chunk) that
restarts at each chunk (``layers._cache_slot``); the hybrid and ssm
families carry their recurrent states (``init_cache``); the vlm and
audio families' cross-attention K/V (``xk``, ``xv``) are computed once by
``prefill_cross_cache``, from the patches or from the encoder's output
(``encode_frames``). The paged entry points take the dense and MoE
families without a window or chunk, as the JAX package's engine does.

On a training mesh (``mesh``, a ``sharding.Mesh``; the dense and moe
families) ``forward`` and ``loss_fn`` take this rank's shards of the
trainable tree, cut by ``train_specs`` (``make_param_specs(...,
fsdp=True)``), and the whole batch, of which each cuts its rows by
``sharding.batch_spec``. Each layer's ``data``-sharded leaves are
gathered inside the layer loop (``collectives.fsdp_gather``), so the
step holds one gathered layer at a time, under remat too (the gather is
recomputed); a leaf whose layer dim FSDP chose comes from the rank that
holds the layer (``collectives.from_owner``). The model axis is passed
down as a training ``ModelGroup`` (``Mesh.model``); the aux and the
metrics are the global ones (``ce`` and ``nnz_mean`` meaned over dp,
``nnz_max`` maxed), while the loss each rank differentiates is its rows'
cross-entropy plus the global L1 and balance terms (whose dp means have
the identity backward): its gradient meaned over the dp ranks is the
gradient of JAX's loss.

Recomputation runs a layer's forward again in the backward, kernels
included, so they count again in ``ops.launch_counts()`` and every hybrid
pack again in ``ops.HybridOverflowLog.rows()``: once more a layer under
``full`` and ``dots``; under ``2level`` once more for the last layer of
each group and twice more for the others (a group's recomputation stops
once it has rebuilt the inputs its inner checkpoints saved).
"""
from __future__ import annotations

import functools
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.utils import checkpoint as ckpt

from repro_torch import device as device_mod
from repro_torch.config import ModelConfig
from repro_torch.core import sparse_ffn
from repro_torch.distributed import collectives, sharding
from repro_torch.models import mamba2, moe, rwkv6
from repro_torch.models.layers import (attention, attn_init, embed_init,
                                       embed_lookup, lm_logits, norm_apply,
                                       norm_init)

_NORMS = ("rmsnorm", "layernorm", "nonparametric_ln")
FAMILIES = ("dense", "moe", "hybrid", "ssm", "vlm", "audio")


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family not in FAMILIES or cfg.norm not in _NORMS:
        raise NotImplementedError(
            f"the port serves the families {FAMILIES} with a norm of "
            f"{_NORMS}; got family {cfg.family!r}, norm {cfg.norm!r}")


def _stack(trees):
    """Per-layer trees -> one tree with every leaf stacked on a leading
    axis."""
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def _block_init(cfg: ModelConfig, dtype, gen, dev, use_moe: bool = False,
                cross: bool = False):
    """A transformer block: norms, attention and the FFN (or MoE); a
    ``cross`` block (vlm) also its scalar gates ``gate_attn`` and
    ``gate_ffn``, zero (tanh(0) = 0: the block starts as the identity)."""
    d = cfg.d_model
    p = {"ln1": norm_init(cfg.norm, d, dtype, dev),
         "ln2": norm_init(cfg.norm, d, dtype, dev),
         "attn": attn_init(d, cfg.num_heads, cfg.num_kv_heads,
                           cfg.resolved_head_dim, dtype, gen, dev)}
    if use_moe:
        p["moe"] = moe.moe_init(d, cfg.d_ff, cfg.num_experts, cfg.gated,
                                dtype, gen, dev)
    else:
        p["ffn"] = sparse_ffn.init(d, cfg.d_ff, cfg.gated, dtype, gen, dev)
    if cross:
        p["gate_attn"] = torch.zeros((), dtype=dtype, device=dev)
        p["gate_ffn"] = torch.zeros((), dtype=dtype, device=dev)
    return p


def _layer_init(cfg: ModelConfig, dtype, gen, dev):
    """One layer of the stack: a transformer block (dense, moe), a norm and
    a Mamba2 block (hybrid), or the RWKV-6 time and channel mixes (ssm)."""
    d = cfg.d_model
    if cfg.family == "hybrid":
        return {"ln": norm_init(cfg.norm, d, dtype, dev),
                "mamba": mamba2.mamba2_init(cfg, dtype, gen, dev)}
    if cfg.family == "ssm":
        return {"ln1": norm_init(cfg.norm, d, dtype, dev),
                "ln2": norm_init(cfg.norm, d, dtype, dev),
                "tm": rwkv6.timemix_init(cfg, dtype, gen, dev),
                "cm": rwkv6.channelmix_init(cfg, dtype, gen, dev)}
    return _block_init(cfg, dtype, gen, dev, use_moe=cfg.family == "moe")


def _stacks_init(cfg: ModelConfig, dtype, gen, dev) -> Dict[str, Any]:
    """The stacked layers: ``blocks`` (L, ...), or the vlm family's
    super-blocks (``blocks.selfs`` (nb, cross_every - 1, ...),
    ``blocks.cross`` (nb, ...)), or the audio family's encoder and decoder
    stacks with ``enc_ln`` and ``frontend_proj``."""
    d, L = cfg.d_model, cfg.num_layers
    if cfg.family == "vlm":
        per = cfg.cross_every
        return {"blocks": {
            "selfs": _stack([_stack([_block_init(cfg, dtype, gen, dev)
                                     for _ in range(per - 1)])
                             for _ in range(L // per)]),
            "cross": _stack([_block_init(cfg, dtype, gen, dev, cross=True)
                             for _ in range(L // per)])}}
    if cfg.family == "audio":
        def dec_init():
            p = _block_init(cfg, dtype, gen, dev)
            p["lnx"] = norm_init(cfg.norm, d, dtype, dev)
            p["xattn"] = attn_init(d, cfg.num_heads, cfg.num_kv_heads,
                                   cfg.resolved_head_dim, dtype, gen, dev)
            return p
        return {"enc_blocks": _stack([_block_init(cfg, dtype, gen, dev)
                                      for _ in range(cfg.encoder_layers)]),
                "dec_blocks": _stack([dec_init() for _ in range(L)]),
                "enc_ln": norm_init(cfg.norm, d, dtype, dev),
                # the stub front end: frames arrive as embeddings
                "frontend_proj": (0.02 * torch.randn(
                    (d, d), generator=gen, device=dev)).to(dtype)}
    return {"blocks": _stack([_layer_init(cfg, dtype, gen, dev)
                              for _ in range(L)])}


def init(cfg: ModelConfig, device=None, seed: int = 0) -> Dict[str, Any]:
    """Random parameters (normal, std 0.02) from a ``torch.Generator``
    seeded with ``seed`` on ``device`` (default: the card). On the meta
    device (``device.SHAPE_ONLY``, a dry run) nothing is drawn: the leaves
    have the shapes and dtypes and no data."""
    _check_family(cfg)
    dev = device_mod.resolve(device)
    dtype = device_mod.torch_dtype(cfg.param_dtype)
    gen = None if dev.type == "meta" else \
        torch.Generator(device=dev).manual_seed(seed)
    d = cfg.d_model

    params: Dict[str, Any] = _stacks_init(cfg, dtype, gen, dev)
    if cfg.family == "hybrid":
        params["shared_attn"] = _block_init(cfg, dtype, gen, dev)
    params.update({
        "embed": embed_init(cfg.padded_vocab, d, dtype, gen, dev),
        "final_ln": norm_init(cfg.norm, d, dtype, dev),
    })
    if not cfg.tied_embeddings:
        params["lm_head"] = embed_init(cfg.padded_vocab, d, dtype, gen, dev)
    return prepare_params(params)


def _ffn_trees(params: Dict[str, Any]) -> List[Dict[str, torch.Tensor]]:
    """Every FFN's weights: ``blocks.ffn`` (L, ...) leaves, a MoE block's
    ``blocks.moe.experts`` (L, E, ...), the hybrid family's shared block's
    ``shared_attn.ffn`` (no L axis), the ssm family's channel mix
    ``blocks.cm`` (its ``mix`` beside ``wu`` and ``wd``), the vlm family's
    ``blocks.selfs.ffn`` and ``blocks.cross.ffn``, or the audio family's
    ``enc_blocks.ffn`` and ``dec_blocks.ffn``."""
    if "shared_attn" in params:
        return [params["shared_attn"]["ffn"]]
    if "enc_blocks" in params:
        return [params["enc_blocks"]["ffn"], params["dec_blocks"]["ffn"]]
    blocks = params["blocks"]
    if "selfs" in blocks:
        return [blocks["selfs"]["ffn"], blocks["cross"]["ffn"]]
    if "moe" in blocks:
        return [blocks["moe"]["experts"]]
    return [blocks["cm"] if "cm" in blocks else blocks["ffn"]]


def prepare_params(params: Dict[str, Any]) -> Dict[str, Any]:
    """Add the weights derived once at load time: for a gated FFN (one with
    ``wg``), ``wu_t`` beside it, W_u transposed to (..., N, K), which the
    TwELL fused kernel (K2), its only reader, takes by row (``blocks.ffn``,
    every expert's in ``blocks.moe.experts``, ``shared_attn.ffn``, or the
    vlm family's self and cross blocks'); a non-gated FFN gets none.
    Idempotent."""
    for ffn in _ffn_trees(params):
        if "wg" in ffn and "wu_t" not in ffn:
            ffn["wu_t"] = ffn["wu"].transpose(-1, -2).contiguous()
    return params


def trainable(params: Dict[str, Any]) -> Dict[str, Any]:
    """The parameters an optimizer updates: the tree without the derived
    ``wu_t`` (re-derive it with ``prepare_params`` before serving trained
    weights)."""
    if not isinstance(params, dict):
        return params
    return {k: trainable(v) for k, v in params.items() if k != "wu_t"}


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
                     device=None, kv_heads: Optional[int] = None
                     ) -> Dict[str, torch.Tensor]:
    """Block-paged KV pools, (L, num_blocks, block_size, Hkv, hd) each;
    block 0 is the null block (see serving/kv_cache.py). ``kv_heads``:
    the heads a pool holds (a rank's share under tensor parallelism;
    default all). The dense and MoE families only, as the JAX package's
    engine."""
    _check_family(cfg)
    if cfg.family not in ("dense", "moe"):
        raise NotImplementedError(
            f"paged KV serving supports dense/moe families, got {cfg.family}")
    if cfg.window or cfg.attn_chunk:
        raise NotImplementedError(
            "paged KV serving does not support windowed/chunked attention yet")
    dev = device_mod.resolve(device)
    dtype = device_mod.torch_dtype(cfg.param_dtype)
    shape = (cfg.num_layers, num_blocks, block_size,
             cfg.num_kv_heads if kv_heads is None else kv_heads,
             cfg.resolved_head_dim)
    return {"kpool": torch.zeros(shape, dtype=dtype, device=dev),
            "vpool": torch.zeros(shape, dtype=dtype, device=dev)}


def _gated(gate: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """tanh(gate) * y, the tanh in float32 and cast to y's dtype (the vlm
    cross block's gates, JAX ``lm.py:101-102``, ``:110-111``)."""
    return torch.tanh(gate.float()).to(y.dtype) * y


def _block_apply(p, x, cfg, positions, cache, collect_aux, kind="causal",
                 kv_x=None, group=None, mesh=None, batch_rows=0):
    a = attention(p["attn"], norm_apply(cfg.norm, p["ln1"], x), cfg,
                  positions=positions, kind=kind, kv_x=kv_x, cache=cache,
                  group=group)
    if "gate_attn" in p:
        a = _gated(p["gate_attn"], a)
    x = x + a
    h = norm_apply(cfg.norm, p["ln2"], x)
    if "moe" in p:
        y, aux = moe.moe_apply(p["moe"], h, cfg, cfg.sparsity, cfg.gated,
                               collect_aux=collect_aux, mesh=mesh,
                               batch_rows=batch_rows)
        if aux is not None:
            aux.pop("moe_drop_frac", None)
    elif mesh is not None:
        # FFN columns split only where d_ff divides the model axis
        split = group if p["ffn"]["wd"].shape[-2] != cfg.d_ff else None
        y, aux = sparse_ffn.apply(p["ffn"], h, cfg.sparsity, cfg.gated,
                                  collect_aux=collect_aux, group=split,
                                  dp=mesh.dp)
    else:
        y, aux = sparse_ffn.apply(p["ffn"], h, cfg.sparsity, cfg.gated,
                                  collect_aux=collect_aux, group=group)
    if "gate_ffn" in p:
        y = _gated(p["gate_ffn"], y)
    return x + y, aux


def _paged_scan(params, x, pools, cfg, positions, block_tables, seq_lens,
                num_new=None, write_valid=None, last_rows=None,
                collect_aux=False, group=None):
    probes = []
    for l in range(cfg.num_layers):
        cache = {"kpool": pools["kpool"][l], "vpool": pools["vpool"][l],
                 "block_tables": block_tables, "seq_lens": seq_lens}
        if num_new is not None:
            cache["num_new"] = num_new
        if write_valid is not None:
            cache["write_valid"] = write_valid
        x, aux = _block_apply(_layer(params["blocks"], l), x, cfg, positions,
                              cache,
                              sparse_ffn.PROBE if collect_aux else False,
                              group=group)
        if collect_aux:
            probes.append(aux)
    if last_rows is not None:
        # keep only each row's last valid hidden state before the O(V) head
        x = x[torch.arange(x.shape[0], device=x.device), last_rows.long()
              ][:, None]
    x = norm_apply(cfg.norm, params["final_ln"], x)
    head = params["embed"] if cfg.tied_embeddings else params["lm_head"]
    logits = lm_logits(x, head, group)
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


REMAT_MODES = ("none", "full", "dots", "2level")

# the matrix products without batch dimensions, which ``dots`` keeps (JAX's
# dots_with_no_batch_dims_saveable); bmm and the hand-written kernels
# (K7-K9, launched outside the dispatcher) are recomputed
_SAVED_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    if op in _SAVED_DOTS:
        return ckpt.CheckpointPolicy.MUST_SAVE
    return ckpt.CheckpointPolicy.PREFER_RECOMPUTE


def _checkpointed(fn, context_fn=None):
    """fn recomputed in the backward from its inputs (non-reentrant, with
    the default determinism check: a recomputed saved tensor whose shape,
    dtype or device differs raises)."""
    kw = {} if context_fn is None else {"context_fn": context_fn}

    def run(*args):
        return ckpt.checkpoint(fn, *args, use_reentrant=False, **kw)
    return run


def _maybe_remat(fn, cfg: ModelConfig):
    if cfg.remat == "none":
        return fn
    if cfg.remat == "dots":
        return _checkpointed(fn, functools.partial(
            ckpt.create_selective_checkpoint_contexts, _dots_policy))
    return _checkpointed(fn)


def _split_depth(l: int) -> Tuple[int, int]:
    """Pick (g_out, g_in) with g_out*g_in == l minimizing stored+transient."""
    best = (l, 1)
    for g_in in range(1, l + 1):
        if l % g_in == 0:
            g_out = l // g_in
            if g_out + g_in < best[0] + best[1]:
                best = (g_out, g_in)
    return best


def stacked_layers(body, x, layers, cfg: ModelConfig):
    """Run ``body(x, p) -> (x, aux)`` over the per-layer trees ``layers``
    under ``cfg.remat``, as the JAX package's ``stacked_scan``: ``none``
    keeps every activation, ``full`` keeps each layer's input and
    recomputes the layer in the backward, ``dots`` keeps the outputs of
    the matrix products without batch dimensions as well, ``2level``
    checkpoints ``_split_depth(L)`` groups and each layer inside them (the
    ``full`` path below 4 layers). Returns (x, aux stacked per layer)."""
    if cfg.remat not in REMAT_MODES:
        raise ValueError(f"unknown remat {cfg.remat!r}; one of {REMAT_MODES}")
    auxs = []
    if cfg.remat != "2level" or len(layers) < 4:
        step = _maybe_remat(body, cfg)
        for p in layers:
            x, aux = step(x, p)
            auxs.append(aux)
    else:
        g_out, g_in = _split_depth(len(layers))
        inner = _checkpointed(body)

        def group(xc, ps):
            out = []
            for p in ps:
                xc, aux = inner(xc, p)
                out.append(aux)
            return xc, out
        outer = _checkpointed(group)
        for g in range(g_out):
            x, out = outer(x, layers[g * g_in:(g + 1) * g_in])
            auxs += out
    return x, _stack_aux(auxs)


def _mark(aux: Optional[Dict], device) -> Optional[Dict]:
    """A block's FFN aux as the stack keeps it: ``ffn_present`` 1 and a
    ``moe_balance`` (0 outside a MoE block); None stays None."""
    if aux is None:
        return None
    aux["ffn_present"] = torch.ones((), device=device)
    aux.setdefault("moe_balance", torch.zeros((), device=device))
    return aux


def _zero_aux(cfg: ModelConfig, device) -> Dict[str, torch.Tensor]:
    """The aux of a hybrid layer without the shared block (JAX's
    ``_zero_aux``): ``ffn_present`` 0, so ``loss_fn`` averages over the
    shared block's applications only."""
    zero = torch.zeros((), device=device)
    return {"l1": zero, "nnz_mean": zero,
            "nnz_max": torch.zeros((), dtype=torch.int32, device=device),
            "neuron_active": torch.zeros((cfg.d_ff,), dtype=torch.bool,
                                         device=device),
            "tile_frac": zero, "ffn_present": zero, "moe_balance": zero}


def _has_shared_attn(cfg: ModelConfig, layer: int) -> bool:
    """Whether the hybrid family's shared block runs after ``layer``."""
    every = cfg.shared_attn_every
    return layer % every == every - 1


MESH_FAMILIES = ("dense", "moe")


@functools.lru_cache(maxsize=None)
def train_specs(cfg: ModelConfig, mesh) -> Dict[str, Any]:
    """The trainable tree's specs on ``mesh``: JAX's
    ``make_param_specs(..., fsdp=True)`` over the shapes of ``init``
    (AdamW's ``m`` and ``v`` take the same)."""
    return sharding.make_param_specs(
        trainable(init(cfg, device=device_mod.SHAPE_ONLY)), cfg, mesh)


def _check_mesh_family(cfg: ModelConfig) -> None:
    if cfg.family not in MESH_FAMILIES:
        raise NotImplementedError(
            f"training on a mesh runs the families {MESH_FAMILIES}; the "
            f"{cfg.family!r} family on a mesh is queued in ROADMAP.md "
            f"(queue 1, item 6.5)")


def _gather_leaf(w, spec, data, l=None, per=0):
    """A leaf's ``data``-sharded dim gathered (``spec`` of the stacked
    leaf when ``l`` is its layer: dim 0 means the owner sends it)."""
    if data is None or "data" not in spec:
        return w
    dim = spec.index("data")
    if l is None:
        return collectives.fsdp_gather(w, data, dim)
    if dim == 0:
        return collectives.from_owner(w, data, l // per)
    return collectives.fsdp_gather(w, data, dim - 1)


def _mesh_layers(blocks, specs, n: int, data):
    """Per-layer (index, tree) of this rank's views of the stacked leaves,
    each unbound once (as ``_unstack``): layer l's slice, or, where FSDP
    split the layer dim, the slice at l's place in each rank's block of
    layers (the owner's is layer l)."""
    def views(tree, spec):
        if isinstance(tree, dict):
            return {k: views(v, spec[k]) for k, v in tree.items()}
        return torch.unbind(tree), spec[0] == "data" and data is not None

    def pick(vs, l):
        if isinstance(vs, dict):
            return {k: pick(v, l) for k, v in vs.items()}
        per_rank, split = vs
        return per_rank[l % len(per_rank)] if split else per_rank[l]
    vs = views(blocks, specs)
    return [(l, pick(vs, l)) for l in range(n)]


def _gather_layer(tree, specs, data, l: int, n: int, cfg, mesh,
                  path: str = ""):
    """Layer ``l``'s leaves gathered over ``data`` (``n`` layers). Under
    ``moe.manual_gather`` the experts stay ``data``-sharded by their
    per-layer spec, for the dispatch to gather."""
    if isinstance(tree, dict):
        return {k: _gather_layer(v, specs[k], data, l, n, cfg, mesh,
                                 f"{path}/{k}") for k, v in tree.items()}
    per = n // data.size if data is not None else n
    if "/experts/" in path + "/" and data is not None and \
            moe.manual_gather(sharding.dp_axes_of(mesh)):
        dim = moe.expert_gather_dims(cfg, mesh)[path.rsplit("/", 1)[1]]
        if "data" not in specs:
            return tree
        if specs.index("data") > 0:
            assert specs.index("data") - 1 == dim, (path, specs, dim)
            return tree
        w = collectives.from_owner(tree, data, l // per)
        if dim < 0:
            return w
        m = w.shape[dim] // data.size
        return w.narrow(dim, data.rank * m, m)
    return _gather_leaf(tree, specs, data, l, per)


def _mesh_forward(params, batch, cfg, mesh, collect_aux: bool = True):
    """``forward`` on a training mesh (see the module docstring): logits
    of this rank's rows (B_local, S, V) and the global aux."""
    _check_mesh_family(cfg)
    specs = train_specs(cfg, mesh)
    rows = batch["tokens"].shape[0]
    tokens = sharding.shard_tensor(
        batch["tokens"], sharding.batch_spec(2, mesh, rows), mesh)
    data, mg = mesh.axis("data"), mesh.model(cfg.d_ff)
    embed = _gather_leaf(params["embed"], specs["embed"], data)
    vocab = mg if embed.shape[0] != cfg.padded_vocab else None
    x = embed_lookup(embed, tokens, vocab)
    positions = torch.arange(tokens.shape[1], device=x.device)
    kind = _attn_kind(cfg)

    def body(xc, lp):
        l, p = lp
        p = _gather_layer(p, specs["blocks"], data, l, cfg.num_layers, cfg,
                          mesh, "blocks")
        xc, aux = _block_apply(p, xc, cfg, positions, None, collect_aux,
                               kind=kind, group=mg, mesh=mesh,
                               batch_rows=rows)
        return xc, _mark(aux, xc.device)
    x, aux = stacked_layers(body, x, _mesh_layers(
        params["blocks"], specs["blocks"], cfg.num_layers, data), cfg)
    x = norm_apply(cfg.norm, {k: _gather_leaf(v, specs["final_ln"][k], data)
                              for k, v in params["final_ln"].items()}, x)
    head = embed if cfg.tied_embeddings else \
        _gather_leaf(params["lm_head"], specs["lm_head"], data)
    return lm_logits(x, head, vocab), aux


def forward(params: Dict, batch: Dict, cfg: ModelConfig,
            collect_aux: bool = True, mesh=None):
    """Training forward: tokens (B, S) -> (logits (B, S, V), aux), aux
    stacked per layer as the JAX package stacks it (``l1``, ``nnz_mean``,
    ``nnz_max``, ``neuron_active``, ``tile_frac``, ``ffn_present``,
    ``moe_balance``: the router's balance loss, 0 outside a MoE block).
    dense/moe: a transformer block a layer. hybrid: a Mamba2 block a layer
    (``mamba2.mamba2_apply``), the one shared transformer block
    (``params["shared_attn"]``) after every ``shared_attn_every``-th, the
    other layers' aux zero with ``ffn_present`` 0. ssm: RWKV-6's time mix
    and channel mix, each after its norm and added back. vlm: per
    super-block ``cross_every - 1`` causal blocks, then the gated cross
    block against ``batch["patches"]`` (B, P, D), its aux after theirs.
    audio: the encoder over ``batch["frames"]`` (B, S_a, D), then the
    decoder's layers (causal self-attention, cross-attention to the
    encoder's output, the FFN), the encoder's aux before the decoder's.
    The layers run under ``cfg.remat`` (``stacked_layers``; the vlm
    family's self blocks one by one under ``_maybe_remat``, its cross
    blocks never recomputed, as JAX's scan of super-blocks). With
    ``collect_aux`` False no FFN builds its statistics and aux is None:
    the prefill step's forward, whose aux XLA drops in the JAX package.
    With ``mesh`` (a training ``sharding.Mesh``): this rank's shards and
    the whole batch, the logits of this rank's rows (the module
    docstring)."""
    _check_family(cfg)
    if mesh is not None:
        return _mesh_forward(params, batch, cfg, mesh, collect_aux)
    tokens = batch["tokens"]
    x = embed_lookup(params["embed"], tokens)
    positions = torch.arange(tokens.shape[1], device=x.device)
    if cfg.family == "vlm":
        x, aux = _vlm_forward(params, x, batch["patches"], cfg, positions,
                              collect_aux)
        return _head(params, x, cfg), aux
    if cfg.family == "audio":
        x, aux = _audio_forward(params, x, batch["frames"], cfg, positions,
                                collect_aux)
        return _head(params, x, cfg), aux
    layers = _unstack(params["blocks"], cfg.num_layers)

    if cfg.family == "hybrid":
        shared = params["shared_attn"]

        def body(xc, ip):
            i, p = ip
            xc = xc + mamba2.mamba2_apply(
                p["mamba"], norm_apply(cfg.norm, p["ln"], xc), cfg)
            if not _has_shared_attn(cfg, i):
                return xc, (_zero_aux(cfg, xc.device) if collect_aux
                            else None)
            xc, aux = _block_apply(shared, xc, cfg, positions, None,
                                   collect_aux)
            return xc, _mark(aux, xc.device)
        layers = list(enumerate(layers))
    elif cfg.family == "ssm":
        def body(xc, p):
            y, _ = rwkv6.timemix_apply(
                p["tm"], norm_apply(cfg.norm, p["ln1"], xc), cfg)
            xc = xc + y
            y, _, aux = rwkv6.channelmix_apply(
                p["cm"], norm_apply(cfg.norm, p["ln2"], xc), cfg,
                cfg.sparsity, collect_aux=collect_aux)
            return xc + y, _mark(aux, xc.device)
    else:
        kind = _attn_kind(cfg)

        def body(xc, p):
            xc, aux = _block_apply(p, xc, cfg, positions, None, collect_aux,
                                   kind=kind)
            return xc, _mark(aux, xc.device)
    x, aux = stacked_layers(body, x, layers, cfg)
    return _head(params, x, cfg), aux


def _head(params, x, cfg):
    """The final norm and the vocabulary projection."""
    x = norm_apply(cfg.norm, params["final_ln"], x)
    head = params["embed"] if cfg.tied_embeddings else params["lm_head"]
    return lm_logits(x, head)


def _stack_aux(auxs):
    if auxs[0] is None:                 # forward(..., collect_aux=False)
        return None
    return {k: torch.stack([a[k] for a in auxs]) for k in auxs[0]}


def _vlm_forward(params, x, patches, cfg, positions, collect_aux=True):
    """The vlm family's super-blocks: ``cross_every - 1`` causal blocks,
    each under ``_maybe_remat`` (``2level`` acts as ``full``: JAX scans
    the super-blocks without ``stacked_scan``), then the tanh-gated cross
    block (never recomputed), K and V from the raw patches, Q from
    ``ln1(x)``. Returns (x, aux stacked in that order)."""
    if cfg.remat not in REMAT_MODES:
        raise ValueError(f"unknown remat {cfg.remat!r}; one of {REMAT_MODES}")
    patches = patches.to(x.dtype)
    per, nb = cfg.cross_every, cfg.num_layers // cfg.cross_every

    def self_body(xc, p):
        xc, aux = _block_apply(p, xc, cfg, positions, None, collect_aux)
        return xc, _mark(aux, xc.device)
    step = _maybe_remat(self_body, cfg)
    selfs = _unstack(params["blocks"]["selfs"], nb)
    crosses = _unstack(params["blocks"]["cross"], nb)
    auxs = []
    for sp, cp in zip(selfs, crosses):
        for p in _unstack(sp, per - 1):
            x, aux = step(x, p)
            auxs.append(aux)
        x, aux = _block_apply(cp, x, cfg, positions, None, collect_aux,
                              kind="cross", kv_x=patches)
        auxs.append(_mark(aux, x.device))
    return x, _stack_aux(auxs)


def _encode(params, frames, cfg, collect_aux: bool):
    """The audio family's encoder: ``stacked_layers`` of bidirectional
    blocks over ``frames @ frontend_proj``, then ``enc_ln``. Returns (the
    output, each layer's aux when ``collect_aux``, else {})."""
    w = params["frontend_proj"]
    enc = frames.to(w.dtype) @ w
    enc_pos = torch.arange(enc.shape[1], device=enc.device)

    def body(xc, p):
        xc, aux = _block_apply(p, xc, cfg, enc_pos, None, collect_aux,
                               kind="bidir")
        return xc, _mark(aux, xc.device) if collect_aux else {}
    enc, aux = stacked_layers(
        body, enc, _unstack(params["enc_blocks"], cfg.encoder_layers), cfg)
    return norm_apply(cfg.norm, params["enc_ln"], enc), aux


def _audio_forward(params, x, frames, cfg, positions, collect_aux=True):
    """The audio family: the encoder (``_encode``), then the decoder's
    layers under ``stacked_layers``: causal self-attention after ``ln1``,
    cross-attention after ``lnx`` to the encoder's output, the FFN after
    ``ln2``, each added back. Returns (x, the encoder's aux then the
    decoder's)."""
    enc, aux_e = _encode(params, frames, cfg, collect_aux)

    def dec_body(xc, p):
        xc = xc + attention(p["attn"], norm_apply(cfg.norm, p["ln1"], xc),
                            cfg, positions=positions, kind="causal")
        xc = xc + attention(p["xattn"], norm_apply(cfg.norm, p["lnx"], xc),
                            cfg, positions=positions, kind="cross", kv_x=enc)
        y, aux = sparse_ffn.apply(p["ffn"], norm_apply(cfg.norm, p["ln2"], xc),
                                  cfg.sparsity, cfg.gated,
                                  collect_aux=collect_aux)
        return xc + y, _mark(aux, xc.device)
    x, aux_d = stacked_layers(
        dec_body, x, _unstack(params["dec_blocks"], cfg.num_layers), cfg)
    if not collect_aux:
        return x, None
    return x, {k: torch.cat([aux_e[k], aux_d[k]]) for k in aux_e}


def loss_fn(params: Dict, batch: Dict, cfg: ModelConfig, l1_coeff=None,
            moe_balance_coeff: float = 0.01, mesh=None):
    """Cross-entropy (f32 logsumexp) + Eq. 2 L1 regularization (the mean
    over FFN-bearing layers) -> (loss, (metrics, aux)). On a training
    ``mesh`` the loss is this rank's (its rows' cross-entropy, the global
    L1 and balance terms) and the metrics are global (the module
    docstring)."""
    logits, aux = forward(params, batch, cfg, mesh=mesh)
    labels = batch["labels"]
    if mesh is not None:
        labels = sharding.shard_tensor(labels, sharding.batch_spec(
            2, mesh, labels.shape[0]), mesh)
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    gold = torch.gather(lf, -1, labels.long()[..., None])[..., 0]
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
    if mesh is not None:
        dp = mesh.dp
        metrics["ce"] = collectives.pmean(ce.detach(), dp)
        metrics["loss"] = collectives.pmean(loss.detach(), dp)
    return loss, (metrics, aux)


def paged_prefill(params: Dict, pools: Dict, block_tables: torch.Tensor,
                  tokens: torch.Tensor, num_new: torch.Tensor,
                  cfg: ModelConfig, start_lens: Optional[torch.Tensor] = None,
                  last_only: bool = False, collect_aux: bool = False,
                  group=None):
    """Prefill a prompt chunk into the paged pools, appending to any cached
    history. tokens: (B, C) right-padded chunk; num_new: (B,) valid chunk
    lengths; start_lens: (B,) tokens already cached (None = 0); all int32.

    Returns (logits, pools): (B, C, V) logits (rows past num_new are
    garbage), or with ``last_only`` each row's last valid position only,
    (B, 1, V). ``collect_aux`` adds a per-layer sparsity probe
    ``{"nnz_mean", "tile_frac", "ffn_present"}`` (L,) in the middle.

    ``group`` (a ``sharding.ModelGroup``, this rank's place on the model
    axis; every paged entry point takes it): the params and pools are this
    rank's shards, the layers run the model axis's collectives, and every
    rank returns the whole logits."""
    x = embed_lookup(params["embed"], tokens, group)
    if start_lens is None:
        start_lens = torch.zeros_like(num_new)
    positions = start_lens[:, None] + \
        torch.arange(tokens.shape[1], device=tokens.device)[None, :]
    last_rows = torch.clamp(num_new - 1, 0, tokens.shape[1] - 1) \
        if last_only else None
    return _paged_scan(params, x, pools, cfg, positions, block_tables,
                       start_lens, num_new=num_new, last_rows=last_rows,
                       collect_aux=collect_aux, group=group)


def paged_decode_step(params: Dict, pools: Dict, block_tables: torch.Tensor,
                      seq_lens: torch.Tensor, tokens: torch.Tensor,
                      cfg: ModelConfig,
                      write_valid: Optional[torch.Tensor] = None,
                      collect_aux: bool = False, group=None):
    """Continuous-batching decode: one token per request. tokens: (B, 1);
    seq_lens: (B,) cached lengths (the new token is written there);
    ``write_valid`` (B,) bool sends a row's KV write to the null block when
    False (speculative draft steps past a request's budget). Returns
    (logits (B, 1, V), pools). Padded rows (all-null table, seq_len 0)
    produce garbage logits."""
    x = embed_lookup(params["embed"], tokens, group)
    positions = seq_lens[:, None]
    return _paged_scan(params, x, pools, cfg, positions, block_tables,
                       seq_lens, write_valid=write_valid,
                       collect_aux=collect_aux, group=group)


def paged_verify(params: Dict, pools: Dict, block_tables: torch.Tensor,
                 start_lens: torch.Tensor, num_new: torch.Tensor,
                 tokens: torch.Tensor, cfg: ModelConfig, group=None):
    """Speculative verify: score a drafted chunk in one batched pass.

    tokens (B, S): per request the last committed token followed by its
    drafts (right-padded); start_lens (B,) cached lengths; num_new (B,)
    valid chunk lengths. Writes exact K/V over whatever the draft left and
    returns (logits (B, S, V), pools); row j scores the token after
    position start + j. This is the chunk-append regime, so it delegates to
    ``paged_prefill`` and the two cannot drift apart."""
    return paged_prefill(params, pools, block_tables, tokens, num_new, cfg,
                         start_lens=start_lens, group=group)


def encode_frames(params: Dict, frames: torch.Tensor, cfg: ModelConfig
                  ) -> torch.Tensor:
    """The audio family's encoder over the stub frame embeddings (B, S_a,
    D) -> (B, S_a, D): ``frames @ frontend_proj``, the bidirectional
    blocks, ``enc_ln`` (JAX ``lm.py:369-379``)."""
    return _encode(params, frames, cfg, False)[0]


def prefill_cross_cache(params: Dict, cache: Dict, batch: Dict,
                        cfg: ModelConfig) -> Dict:
    """The cross-attention K/V, computed once a request (JAX ``lm.py:382-
    407``): audio from the encoder's output over ``batch["frames"]``, every
    decoder layer's ``xattn`` (``xk``/``xv`` (L, B, S_a, Hkv, hd)); vlm
    from the raw ``batch["patches"]`` (B, P, D), every cross block's
    (nb, B, P, Hkv, hd). Returns a new cache dict with them in place of
    the zeros."""
    hkv, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    if cfg.family == "audio":
        src = encode_frames(params, batch["frames"], cfg)
        attn = params["dec_blocks"]["xattn"]
    elif cfg.family == "vlm":
        src = batch["patches"].to(params["embed"].dtype)
        attn = params["blocks"]["cross"]["attn"]
    else:
        return dict(cache)
    b, s, _ = src.shape
    out = dict(cache)
    for name, w in (("xk", attn["wk"]), ("xv", attn["wv"])):
        out[name] = torch.einsum("bsd,ldh->lbsh", src, w).reshape(
            w.shape[0], b, s, hkv, hd)
    return out


def init_cache(cfg: ModelConfig, batch: int, cache_len: int, device=None,
               enc_len: int = 0, num_patches: int = 0) -> Dict[str, Any]:
    """Zero monolithic decode cache, with ``pos``, the tokens written so
    far (a Python int; JAX's is an int32 scalar). dense/moe: ``k`` and
    ``v`` of shape (L, batch, S_cache, Hkv, hd); ``cache_len`` is the
    capacity, a sliding window keeps a ring of min(cache_len, window)
    slots, a local chunk min(cache_len, attn_chunk), as JAX's
    ``init_cache`` sizes them. hybrid: each Mamba2 layer's float32 SSM
    ``state`` (L, batch, H, hd, N) and ``conv`` window (L, batch, W - 1,
    C), and ``k``/``v`` for each of the L // shared_attn_every applications
    of the shared block. ssm: each layer's float32 ``wkv`` state (L, batch,
    H, hd, hd) and the time and channel mixes' token shifts ``shift_tm``,
    ``shift_cm`` (L, batch, D). vlm: ``k``/``v`` of the L - nb self
    blocks and zero ``xk``/``xv`` (nb, batch, num_patches, Hkv, hd) of
    the nb cross blocks; audio: ``k``/``v`` (L, ...) and zero ``xk``/``xv``
    (L, batch, enc_len, Hkv, hd) (``prefill_cross_cache`` fills both)."""
    _check_family(cfg)
    dev = device_mod.resolve(device)
    dtype = device_mod.torch_dtype(cfg.param_dtype)
    L, hkv, hd = cfg.num_layers, cfg.num_kv_heads, cfg.resolved_head_dim

    def zeros(*shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=dev)
    if cfg.family == "hybrid":
        layer = mamba2.mamba2_cache_init(cfg, batch, dtype, dev)
        napp = L // cfg.shared_attn_every
        return {**{k: v.new_zeros((L, *v.shape)) for k, v in layer.items()},
                "k": zeros(napp, batch, cache_len, hkv, hd),
                "v": zeros(napp, batch, cache_len, hkv, hd), "pos": 0}
    if cfg.family in ("vlm", "audio"):
        self_layers, cross_layers, src = (
            (L - L // cfg.cross_every, L // cfg.cross_every, num_patches)
            if cfg.family == "vlm" else (L, L, enc_len))
        return {"k": zeros(self_layers, batch, cache_len, hkv, hd),
                "v": zeros(self_layers, batch, cache_len, hkv, hd),
                "xk": zeros(cross_layers, batch, src, hkv, hd),
                "xv": zeros(cross_layers, batch, src, hkv, hd), "pos": 0}
    if cfg.family == "ssm":
        h, hdr = rwkv6.rwkv_dims(cfg)
        return {"wkv": zeros(L, batch, h, hdr, hdr, dt=torch.float32),
                "shift_tm": zeros(L, batch, cfg.d_model),
                "shift_cm": zeros(L, batch, cfg.d_model), "pos": 0}
    sc = min(cache_len, cfg.window) if cfg.window else cache_len
    if cfg.attn_chunk:
        sc = min(cache_len, cfg.attn_chunk)
    return {"k": zeros(L, batch, sc, hkv, hd),
            "v": zeros(L, batch, sc, hkv, hd), "pos": 0}


def _hybrid_decode(params, cache, x, cfg, positions, pos):
    """The hybrid family's layers for one token: each Mamba2 layer's state
    and conv window, and after every ``shared_attn_every``-th layer the
    shared block against its application's K/V, all updated in place."""
    shared = params["shared_attn"]
    for l in range(cfg.num_layers):
        p = _layer(params["blocks"], l)
        y, new = mamba2.mamba2_decode(
            p["mamba"], norm_apply(cfg.norm, p["ln"], x), cfg,
            {"state": cache["state"][l], "conv": cache["conv"][l]})
        x = x + y
        cache["state"][l] = new["state"]
        cache["conv"][l] = new["conv"]
        if _has_shared_attn(cfg, l):
            app = l // cfg.shared_attn_every
            x, _ = _block_apply(shared, x, cfg, positions,
                                {"k": cache["k"][app], "v": cache["v"][app],
                                 "pos": pos}, False)
    return x


def _ssm_decode(params, cache, x, cfg):
    """The ssm family's layers for one token: each layer's WKV state and
    token shifts, updated in place."""
    for l in range(cfg.num_layers):
        p = _layer(params["blocks"], l)
        y, tm = rwkv6.timemix_apply(
            p["tm"], norm_apply(cfg.norm, p["ln1"], x), cfg,
            state={"wkv": cache["wkv"][l], "shift": cache["shift_tm"][l]})
        x = x + y
        y, cm, _ = rwkv6.channelmix_apply(
            p["cm"], norm_apply(cfg.norm, p["ln2"], x), cfg, cfg.sparsity,
            state={"shift": cache["shift_cm"][l]})
        x = x + y
        cache["wkv"][l] = tm["wkv"]
        cache["shift_tm"][l] = tm["shift"]
        cache["shift_cm"][l] = cm["shift"]
    return x


def _vlm_decode(params, cache, x, cfg, positions, pos):
    """The vlm family's layers for one token: each super-block's self
    blocks against their K/V (layer b * (cross_every - 1) + j of
    ``k``/``v``), then its cross block against the block's ``xk``/``xv``;
    the self caches updated in place."""
    per, nb = cfg.cross_every, cfg.num_layers // cfg.cross_every
    for b in range(nb):
        selfs = _layer(params["blocks"]["selfs"], b)
        for j in range(per - 1):
            l = b * (per - 1) + j
            x, _ = _block_apply(_layer(selfs, j), x, cfg, positions,
                                {"k": cache["k"][l], "v": cache["v"][l],
                                 "pos": pos}, False)
        x, _ = _block_apply(_layer(params["blocks"]["cross"], b), x, cfg,
                            positions, {"xk": cache["xk"][b],
                                        "xv": cache["xv"][b]}, False,
                            kind="cross")
    return x


def _audio_decode(params, cache, x, cfg, positions, pos):
    """The audio family's decoder layers for one token: causal
    self-attention against the layer's K/V (updated in place),
    cross-attention against its ``xk``/``xv``, the FFN."""
    for l in range(cfg.num_layers):
        p = _layer(params["dec_blocks"], l)
        x = x + attention(p["attn"], norm_apply(cfg.norm, p["ln1"], x), cfg,
                          positions=positions, kind="causal",
                          cache={"k": cache["k"][l], "v": cache["v"][l],
                                 "pos": pos})
        x = x + attention(p["xattn"], norm_apply(cfg.norm, p["lnx"], x), cfg,
                          positions=positions, kind="cross",
                          cache={"xk": cache["xk"][l], "xv": cache["xv"][l]})
        y, _ = sparse_ffn.apply(p["ffn"], norm_apply(cfg.norm, p["ln2"], x),
                                cfg.sparsity, cfg.gated)
        x = x + y
    return x


def decode_step(params: Dict, cache: Dict, tokens: torch.Tensor,
                cfg: ModelConfig) -> Tuple[torch.Tensor, Dict]:
    """One new token per sequence through the monolithic cache: tokens
    (B, 1) -> (logits (B, 1, V), cache), the cache updated in place and
    ``pos`` advanced by one. dense/moe: the K/V are written at position
    ``pos`` (its ring or chunk slot for a window or a local chunk);
    attention is plain masked attention over the cache
    (``layers.attention``), the FFN ``sparse_ffn.apply`` under
    ``cfg.sparsity`` (K1 + K2 on the card for ``gather``; each expert's in
    a MoE block). hybrid: ``mamba2.mamba2_decode`` a layer and the shared
    block (K1 + K2) at its applications. ssm: RWKV-6's per-token WKV step
    and the channel mix (K1 with relu^2, then K6). vlm: the self blocks
    and, after each super-block's, its gated cross block over ``xk``/``xv``
    (K1 + K2 in both). audio: the decoder's layers, cross-attention over
    ``xk``/``xv`` (K1 + K6: a non-gated FFN); an empty encoder cache
    (enc_len 0) contributes zeros. Raises "cache full" once
    ``pos`` reaches the K/V slots, unless they hold a whole window or
    chunk (the ring then wraps, the chunk restarts); the ssm family keeps
    no K/V and has no such limit."""
    _check_family(cfg)
    pos = int(cache["pos"])
    if "k" in cache:
        slots = cache["k"].shape[2]
        span = cfg.window or cfg.attn_chunk     # 0: causal, every key kept
        if pos >= slots and not (span and slots >= span):
            raise ValueError(f"cache full: pos {pos} of {slots}")
    x = embed_lookup(params["embed"], tokens)
    positions = torch.full((1,), pos, dtype=torch.int32, device=x.device)
    if cfg.family == "hybrid":
        x = _hybrid_decode(params, cache, x, cfg, positions, pos)
    elif cfg.family == "ssm":
        x = _ssm_decode(params, cache, x, cfg)
    elif cfg.family == "vlm":
        x = _vlm_decode(params, cache, x, cfg, positions, pos)
    elif cfg.family == "audio":
        x = _audio_decode(params, cache, x, cfg, positions, pos)
    else:
        for l in range(cfg.num_layers):
            layer_cache = {"k": cache["k"][l], "v": cache["v"][l],
                           "pos": pos}
            x, _ = _block_apply(_layer(params["blocks"], l), x, cfg,
                                positions, layer_cache, False,
                                kind=_attn_kind(cfg))
    cache["pos"] = pos + 1
    return _head(params, x, cfg), cache
