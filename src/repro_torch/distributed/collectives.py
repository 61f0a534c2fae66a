"""Explicit collectives of tensor-parallel serving, and distributed
attention.

The JAX package leaves the model axis's collectives to GSPMD
(``shard_act`` in its layers); the port runs them itself, on the
``sharding.ModelGroup`` the serving entry points pass down:

- ``all_reduce``: the partial sums of a row-split product (attention's
  ``wo``, the FFN's ``W_d``, the vocab-split embedding lookup), in place;
- ``all_gather_last``: the vocab-split logits, so that every rank holds
  the full row and samples the same token.

Each call adds one to ``CALLS`` on the host, as a kernel wrapper counts
its launches; a CUDA graph's capture takes its counts back out and a
replay adds them again (``serving/graphs.py``).

``flash_decode_attention`` ports ``repro/distributed/collectives.py:25``:
decode attention against a sequence-sharded KV cache, where only the
online-softmax statistics cross ranks (``all_reduce`` of the row maxima
with MAX, then of ``num`` and ``den`` with SUM). No serving path calls it,
in the JAX package or in the port.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.distributed as dist

CALLS: Dict[str, int] = {"all_reduce": 0, "all_gather": 0}

# all_gather_single is all_gather_into_tensor's newer name
_gather_into = getattr(dist, "all_gather_single", None) or \
    dist.all_gather_into_tensor


def all_reduce(t: torch.Tensor, group, op=dist.ReduceOp.SUM
               ) -> torch.Tensor:
    """``t`` reduced over ``group`` (a ``ModelGroup``) in place; ``t``
    itself when ``group`` is None."""
    if group is not None:
        CALLS["all_reduce"] += 1
        dist.all_reduce(t, op=op, group=group.group)
    return t


def all_gather_last(t: torch.Tensor, group) -> torch.Tensor:
    """The ranks' ``t`` concatenated on the last dim, in rank order; ``t``
    itself when ``group`` is None."""
    if group is None:
        return t
    CALLS["all_gather"] += 1
    # the ranks' tensors concatenated on dim 0 (what every backend takes)
    out = torch.empty((group.size * t.shape[0],) + tuple(t.shape[1:]),
                      dtype=t.dtype, device=t.device)
    _gather_into(out, t.contiguous(), group=group.group)
    return out.view(group.size, *t.shape).movedim(0, -2).reshape(
        *t.shape[:-1], group.size * t.shape[-1])


def flash_decode_attention(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, length: int, mesh,
                           axis: str = "model") -> torch.Tensor:
    """q: (B, 1, H, hd), the same on every rank of ``axis``; k, v: this
    rank's slice (B, S / tp, H, hd) of a (B, S, H, hd) cache split on S
    in rank order (KV already repeated to H); length: the valid prefix.
    Returns (B, 1, H, hd) on every rank. Logits, maxima, probabilities'
    sums and the numerator in float32; the probabilities cast to q.dtype
    before the product with V, as JAX's."""
    group = mesh.get_group(axis)
    rank = mesh.get_local_rank(axis)
    scale = 1.0 / (q.shape[-1] ** 0.5)
    s_local = k.shape[1]
    kpos = rank * s_local + torch.arange(s_local, device=q.device)
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
    logits = torch.where((kpos < length)[None, None, None, :], logits,
                         torch.full((), -1e30, device=q.device))
    m = logits.amax(dim=-1)                                 # (B, H, 1)
    dist.all_reduce(m, op=dist.ReduceOp.MAX, group=group)
    p = torch.exp(logits - m[..., None])
    num = torch.einsum("bhqk,bkhd->bqhd", p.to(q.dtype), v).float()
    den = p.sum(dim=-1)                                     # (B, H, 1)
    dist.all_reduce(num, group=group)
    dist.all_reduce(den, group=group)
    return (num / torch.clamp(den, min=1e-30).transpose(1, 2)[..., None]
            ).to(q.dtype)


def reset_calls() -> None:
    for k in CALLS:
        CALLS[k] = 0


def calls() -> Dict[str, int]:
    return dict(CALLS)
