"""Mixture-of-Experts block with the paper's SparseFFN inside each expert
(ports ``repro/models/moe.py``).

``moe_apply_onehot`` is the JAX package's exact, drop-free dispatch: every
expert runs over every token and the router's combine weights zero the
tokens it did not pick. It is what JAX computes without a mesh
(``moe_apply`` with ``moe_drop_frac`` 0), so ``y`` and every aux statistic
(``l1``, ``nnz_mean``, ``nnz_max``, ``neuron_active``, ``tile_frac``,
``moe_balance``) equal JAX's, and so does the training loss. Each expert is
``core.sparse_ffn.apply`` under the config's ``ffn_impl``: on the card K1 +
K2 for ``gather``, K8 + K9 for ``hybrid``. The experts run one after the
other in a Python loop (JAX vmaps them).

``moe_apply_sorted`` is JAX's production dispatch on a mesh
(``repro/models/moe.py:129-227``): per data-parallel shard, a stable sort
of the (token, choice) pairs by expert into a static-capacity (E, C, D)
buffer, ``C = max(8, round_up_8(k T_local / E * capacity_factor))``; pairs
past an expert's capacity go to an out-of-bounds row and are dropped; the
combine is a float32 scatter-add. Where JAX's partial-manual
``shard_map`` keeps the experts under GSPMD, the port splits them over
``model`` itself, by ``param_spec``'s rules: expert-parallel (each rank
its E / tp experts) when the experts divide the axis, else
tensor-parallel inside each expert (each rank its d_ff columns). The
dispatch runs whole on every model rank; the tokens and combine weights
enter the split work through ``collectives.copy_in`` and the combined y
leaves through ``reduce_out``. The balance loss is per shard and the aux
is reduced over the dp axes as JAX's ``:206-215`` (pmean, pmax).
``REPRO_MOE_MANUAL_GATHER`` is JAX's switch, read in ``manual_gather``
under JAX's condition: the layer loop then leaves the experts
``data``-sharded and the dispatch gathers each leaf (``fsdp_gather``:
the weight's dtype, a float32 reduce-scatter transpose); by default the
layer loop gathers them with the rest of the layer, by the same
collective. The numbers are the same either way.

Parameters keep the JAX tree: ``router`` (d_model, E) and ``experts``,
each leaf of ``sparse_ffn.init`` stacked on a leading E axis.
"""
from __future__ import annotations

import os
from typing import Dict, Optional, Tuple, Union

import torch

from repro_torch.core import sparse_ffn
from repro_torch.distributed import collectives, sharding
from repro_torch.models.layers import INIT_STD


def moe_init(d_model: int, d_ff: int, num_experts: int, gated: bool,
             dtype: torch.dtype, generator: torch.Generator,
             device: torch.device) -> Dict:
    experts = [sparse_ffn.init(d_model, d_ff, gated, dtype, generator,
                               device) for _ in range(num_experts)]
    stacked = {k: torch.stack([e[k] for e in experts]) for k in experts[0]}
    del experts
    router = (INIT_STD * torch.randn((d_model, num_experts),
                                     generator=generator,
                                     device=device)).to(dtype)
    return {"router": router, "experts": stacked}


def _route(router: torch.Tensor, xt: torch.Tensor, k: int):
    """The router's float32 softmax over (T, D) tokens and its top ``k``:
    (probs (T, E), weights renormalised over the top k (T, k), their
    experts (T, k))."""
    probs = torch.softmax((xt @ router).float(), dim=-1)
    top_vals, top_ids = torch.topk(probs, k, dim=-1)
    return probs, top_vals / top_vals.sum(dim=-1, keepdim=True), top_ids


def _balance_loss(probs: torch.Tensor, combine_mask: torch.Tensor
                  ) -> torch.Tensor:
    """Switch/Mixtral load-balancing loss: E * sum_e f_e * P_e."""
    e = probs.shape[-1]
    frac = combine_mask.float().mean(dim=0)           # tokens per expert
    prob = probs.mean(dim=0)
    return e * torch.sum(frac * prob)


def _expert_ffn(experts: Dict[str, torch.Tensor], x: torch.Tensor, scfg,
                gated: bool, collect_aux):
    """Each expert's SparseFFN over the same tokens x (T, D): a list of E
    outputs (T, D) and a list of E aux dicts (or Nones)."""
    per = {k: torch.unbind(v) for k, v in experts.items()}
    outs = []
    for e in range(len(next(iter(per.values())))):
        outs.append(sparse_ffn.apply({k: v[e] for k, v in per.items()}, x,
                                     scfg, gated, collect_aux=collect_aux))
    return [y for y, _ in outs], [a for _, a in outs]


def _reduce_aux(aux_e, extra: Optional[Dict]) -> Dict:
    """The experts' statistics as JAX reduces them: means of ``l1``,
    ``nnz_mean`` and ``tile_frac``, the max of ``nnz_max``, ``neuron_active``
    any over the experts, and ``extra``; with ``extra`` None the serving
    probe only (``nnz_mean``, ``tile_frac``)."""
    out = {"nnz_mean": torch.stack([a["nnz_mean"] for a in aux_e]).mean(),
           "tile_frac": torch.stack([a["tile_frac"] for a in aux_e]).mean()}
    if extra is None:
        return out
    out["l1"] = torch.stack([a["l1"] for a in aux_e]).mean()
    out["nnz_max"] = torch.stack([a["nnz_max"] for a in aux_e]).max()
    out["neuron_active"] = torch.stack(
        [a["neuron_active"] for a in aux_e]).any(dim=0)
    out.update(extra)
    return out


def moe_apply_onehot(params: Dict, x: torch.Tensor, cfg, scfg, gated: bool,
                     collect_aux: Union[bool, str] = True
                     ) -> Tuple[torch.Tensor, Optional[Dict]]:
    """Exact drop-free dispatch: every expert over every token, combined
    with the router's renormalised top-k weights. x (..., D) -> y (..., D)
    and the aux (None when ``collect_aux`` is False; the probe's two keys
    for ``sparse_ffn.PROBE``; else every statistic and ``moe_balance``)."""
    lead, d = x.shape[:-1], x.shape[-1]
    xt = x.reshape(-1, d)
    probs, top_vals, top_ids = _route(params["router"], xt, cfg.top_k)
    combine = torch.zeros_like(probs).scatter(1, top_ids, top_vals)  # (T, E)
    ys, aux_e = _expert_ffn(params["experts"], xt, scfg, gated, collect_aux)
    y = torch.zeros(xt.shape, dtype=torch.float32, device=x.device)
    for e, ye in enumerate(ys):
        y = y + ye.float() * combine[:, e:e + 1]
    y = y.to(x.dtype).reshape(*lead, d)
    if not collect_aux:
        return y, None
    extra = None if collect_aux == sparse_ffn.PROBE else \
        {"moe_balance": _balance_loss(probs, combine > 0)}
    return y, _reduce_aux(aux_e, extra)


def manual_gather(dp_axes: Tuple[str, ...]) -> bool:
    """JAX's ``REPRO_MOE_MANUAL_GATHER`` switch (``moe.py:143-144``): on
    when the variable is ``1``, the mesh has a ``data`` axis and no
    ``pod`` axis."""
    return (os.environ.get("REPRO_MOE_MANUAL_GATHER") == "1"
            and "pod" not in dp_axes and "data" in dp_axes)


def expert_gather_dims(cfg, mesh) -> Dict[str, int]:
    """Each expert leaf's ``data``-sharded dim of its per-layer (E, ...)
    shape by the rule engine, -1 where it has none (JAX's
    ``_expert_manual_specs``)."""
    e, d, f = cfg.num_experts, cfg.d_model, cfg.d_ff
    shapes = {"wu": (e, d, f), "wd": (e, f, d)}
    if cfg.gated:
        shapes["wg"] = (e, d, f)
    out = {}
    for name, shape in shapes.items():
        spec = sharding.param_spec(f"experts/{name}", shape, cfg, mesh)
        out[name] = spec.index("data") if "data" in spec else -1
    return out


def _split(cfg, experts, group):
    """(the model group the experts' work is split over or None, whether
    each rank holds its own experts (EP), the first expert it holds)."""
    e_local, f_local = experts["wd"].shape[0], experts["wd"].shape[1]
    if group is None or e_local == cfg.num_experts and f_local == cfg.d_ff:
        return None, False, 0
    ep = e_local != cfg.num_experts
    return group, ep, group.rank * e_local if ep else 0


def _experts_train(experts, xs, scfg, gated, impl, group, ep):
    """Each held expert's FFN over its rows ``xs[j]``: (the outputs, y's
    partial sums under expert TP, and the aux over all E experts, summed
    over the model ranks where each holds its own)."""
    per = {k: torch.unbind(v) for k, v in experts.items()}
    ys, auxs = [], []
    for j in range(len(per["wd"])):
        y, st = sparse_ffn.train_shard({k: v[j] for k, v in per.items()},
                                       xs[j], scfg, gated, impl)
        ys.append(y)
        auxs.append(sparse_ffn.train_aux(st, scfg, None if ep else group,
                                         None))
    red = group if ep else None
    stack = {k: torch.stack([a[k] for a in auxs]) for k in auxs[0]}
    aux = {"l1": collectives.reduce_out(stack["l1"].sum(), red),
           "nnz_mean": collectives.psum(stack["nnz_mean"].sum(), red),
           "nnz_max": collectives.pmax(stack["nnz_max"].max(), red),
           "neuron_active": collectives.pany(
               stack["neuron_active"].any(dim=0), red),
           "tile_frac": collectives.psum(stack["tile_frac"].sum(), red)}
    return ys, aux


def _experts_mean(aux, e: int) -> Dict:
    for k in ("l1", "nnz_mean", "tile_frac"):
        aux[k] = aux[k] / e
    return aux


def moe_apply_onehot_sharded(params: Dict, x: torch.Tensor, cfg, scfg,
                             gated: bool, group, dp=None):
    """``moe_apply_onehot`` on a training mesh without a dispatch: the
    held experts (EP) or columns (expert TP) over every token of this
    rank's rows, the statistics reduced over ``group`` and ``dp``."""
    impl = scfg.ffn_impl if scfg.enabled else "dense"
    lead, d = x.shape[:-1], x.shape[-1]
    xt = x.reshape(-1, d)
    probs, top_vals, top_ids = _route(params["router"], xt, cfg.top_k)
    combine = torch.zeros_like(probs).scatter(1, top_ids, top_vals)
    experts = params["experts"]
    red, ep, e0 = _split(cfg, experts, group)
    xin = collectives.copy_in(xt, red)
    ys, aux = _experts_train(experts, [xin] * experts["wd"].shape[0], scfg,
                             gated, impl, red, ep)
    comb = collectives.copy_in(combine, red)
    y = torch.zeros(xt.shape, dtype=torch.float32, device=x.device)
    for j, ye in enumerate(ys):
        y = y + ye.float() * comb[:, e0 + j:e0 + j + 1]
    y = collectives.reduce_out(y, red).to(x.dtype).reshape(*lead, d)
    aux = _experts_mean(aux, cfg.num_experts)
    aux = {k: collectives.pmean(v, dp) if k in ("l1", "nnz_mean",
                                                 "tile_frac") else v
           for k, v in aux.items()}
    aux["nnz_max"] = collectives.pmax(aux["nnz_max"], dp)
    aux["neuron_active"] = collectives.pany(aux["neuron_active"], dp)
    aux["moe_balance"] = collectives.pmean(_balance_loss(probs, combine > 0),
                                             dp)
    return y, aux


def moe_apply_sorted(params: Dict, x: torch.Tensor, cfg, scfg, gated: bool,
                     mesh, dp_axes: Tuple[str, ...]
                     ) -> Tuple[torch.Tensor, Dict]:
    """JAX's sort-based dispatch on ``mesh`` (a ``sharding.Mesh``) with
    ``dp_axes`` its data-parallel axes. x (B_local, S, D): this rank's
    rows of a batch split over ``dp_axes``, whole on every model rank;
    ``params``: the router whole, the experts this rank's ``model`` share
    (gathered over ``data``, or ``data``-sharded when ``manual_gather``).
    Returns (y, aux) with ``moe_drop_frac``; the aux meaned (``l1``,
    ``nnz_mean``, ``tile_frac``, ``moe_balance``, ``moe_drop_frac``) or
    maxed (``nnz_max``, ``neuron_active``) over ``dp_axes``."""
    b, s, d = x.shape
    e, k = cfg.num_experts, cfg.top_k
    impl = scfg.ffn_impl if scfg.enabled else "dense"
    dp = mesh.axis(*dp_axes)
    experts = params["experts"]
    if manual_gather(dp_axes):
        dims, data = expert_gather_dims(cfg, mesh), mesh.axis("data")
        experts = {n: collectives.fsdp_gather(w, data, dims[n])
                   if dims[n] >= 0 else w for n, w in experts.items()}
    red, ep, e0 = _split(cfg, experts, mesh.model(cfg.d_ff))
    e_local = experts["wd"].shape[0]

    tl = b * s
    xt = x.reshape(tl, d)
    cap = int(k * tl / e * cfg.capacity_factor + 0.5)
    cap = max(8, (cap + 7) // 8 * 8)
    probs, top_vals, top_ids = _route(params["router"], xt, k)

    dev = x.device
    flat_ids = top_ids.reshape(-1)                             # (T*k,)
    flat_tok = torch.arange(tl, device=dev).repeat_interleave(k)
    order = torch.argsort(flat_ids, stable=True)
    sid, stok = flat_ids[order], flat_tok[order]
    sw = top_vals.reshape(-1)[order]
    counts = torch.bincount(sid, minlength=e)                  # per expert
    offsets = torch.cumsum(counts, 0) - counts
    pos = torch.arange(tl * k, device=dev) - offsets[sid]
    valid = pos < cap
    slot = torch.where(valid, sid * cap + pos,
                       torch.full_like(sid, e * cap))          # OOB: dropped

    # the split work: the held experts' rows of the (E, C, D) buffer
    xin = collectives.copy_in(xt, red)
    buf = torch.zeros((e * cap + 1, d), dtype=xt.dtype, device=dev)
    buf = buf.index_put((slot,), xin[stok])[:-1].reshape(e, cap, d)
    ys, aux = _experts_train(experts, buf[e0:e0 + e_local], scfg, gated,
                             impl, red, ep)
    ye = torch.cat([torch.stack(ys).reshape(e_local * cap, d),
                    torch.zeros((1, d), dtype=ys[0].dtype, device=dev)])
    held = valid & (slot >= e0 * cap) & (slot < (e0 + e_local) * cap)
    lslot = torch.where(held, slot - e0 * cap,
                        torch.full_like(slot, e_local * cap))
    w = (collectives.copy_in(sw, red) * held).to(ye.dtype)
    yt = torch.zeros((tl, d), dtype=torch.float32, device=dev).index_add(
        0, stok, (ye[lslot] * w[:, None]).float())
    yt = collectives.reduce_out(yt, red)

    chosen = torch.zeros_like(probs).scatter(1, top_ids, 1.0) > 0
    aux = _experts_mean(aux, e)
    aux = {"l1": collectives.pmean(aux["l1"], dp),
           "nnz_mean": collectives.pmean(aux["nnz_mean"], dp),
           "nnz_max": collectives.pmax(aux["nnz_max"], dp),
           "neuron_active": collectives.pany(aux["neuron_active"], dp),
           "moe_balance": collectives.pmean(_balance_loss(probs, chosen),
                                              dp),
           "moe_drop_frac": collectives.pmean(1.0 - valid.float().mean(),
                                                dp),
           "tile_frac": collectives.pmean(aux["tile_frac"], dp)}
    return yt.to(x.dtype).reshape(b, s, d), aux


def moe_apply(params: Dict, x: torch.Tensor, cfg, scfg, gated: bool,
              collect_aux: Union[bool, str] = True, mesh=None,
              batch_rows: int = 0) -> Tuple[torch.Tensor, Optional[Dict]]:
    """The MoE block, routed as JAX's ``moe_apply`` (``moe.py:230-244``):
    on a training ``mesh`` with data-parallel axes whose size divides the
    batch (``batch_rows`` global rows, x this rank's), the sorted
    dispatch; else the exact one-hot dispatch, with ``moe_drop_frac`` 0
    in the full aux (split over the model axis on a mesh without dp
    axes)."""
    if mesh is not None:
        dp_axes = sharding.dp_axes_of(mesh)
        total = 1
        for a in dp_axes:
            total *= mesh.size(a)
        if dp_axes and batch_rows % total == 0:
            return moe_apply_sorted(params, x, cfg, scfg, gated, mesh,
                                    dp_axes)
        y, aux = moe_apply_onehot_sharded(params, x, cfg, scfg, gated,
                                          mesh.model(cfg.d_ff), mesh.dp)
    else:
        y, aux = moe_apply_onehot(params, x, cfg, scfg, gated, collect_aux)
    if aux is not None and "moe_balance" in aux:
        aux["moe_drop_frac"] = torch.zeros((), device=x.device)
    return y, aux
