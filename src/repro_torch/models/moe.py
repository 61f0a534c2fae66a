"""Mixture-of-Experts block with the paper's SparseFFN inside each expert
(ports ``repro/models/moe.py`` as one device runs it).

``moe_apply_onehot`` is the JAX package's exact, drop-free dispatch: every
expert runs over every token and the router's combine weights zero the
tokens it did not pick. It is what JAX computes without a mesh
(``moe_apply`` with ``moe_drop_frac`` 0), so ``y`` and every aux statistic
(``l1``, ``nnz_mean``, ``nnz_max``, ``neuron_active``, ``tile_frac``,
``moe_balance``) equal JAX's, and so does the training loss. Each expert is
``core.sparse_ffn.apply`` under the config's ``ffn_impl``: on the card K1 +
K2 for ``gather``, K8 + K9 for ``hybrid``. The experts run one after the
other in a Python loop (JAX vmaps them). The sort-based dispatch of
``moe_apply_sorted`` and its ``REPRO_MOE_MANUAL_GATHER`` switch shard the
experts over a mesh, which the port does not have yet.

Parameters keep the JAX tree: ``router`` (d_model, E) and ``experts``,
each leaf of ``sparse_ffn.init`` stacked on a leading E axis.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

import torch

from repro_torch.core import sparse_ffn
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
    probs = torch.softmax((xt @ params["router"]).float(), dim=-1)
    top_vals, top_ids = torch.topk(probs, cfg.top_k, dim=-1)
    top_vals = top_vals / top_vals.sum(dim=-1, keepdim=True)
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


def moe_apply(params: Dict, x: torch.Tensor, cfg, scfg, gated: bool,
              collect_aux: Union[bool, str] = True
              ) -> Tuple[torch.Tensor, Optional[Dict]]:
    """The MoE block on one device: ``moe_apply_onehot`` with
    ``moe_drop_frac`` 0 in the full aux, as JAX's ``moe_apply`` without a
    mesh."""
    y, aux = moe_apply_onehot(params, x, cfg, scfg, gated, collect_aux)
    if aux is not None and "moe_balance" in aux:
        aux["moe_drop_frac"] = torch.zeros((), device=x.device)
    return y, aux
