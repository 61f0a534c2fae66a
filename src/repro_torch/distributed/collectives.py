"""Explicit collectives of tensor-parallel serving and of training on a
mesh, and distributed attention.

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

Training on a ``sharding.Mesh`` differentiates through its collectives,
so they are ``torch.autograd.Function``s beside serving's in-place ones
(which stay as they are: a CUDA graph captures them). JAX's GSPMD
derives the same transposes from its sharding annotations:

- ``copy_in`` (model axis): forward the identity, backward an
  all-reduce. It marks where a tensor every model rank holds whole enters
  work split over the ranks (Megatron's ``f``);
- ``reduce_out`` (model axis): forward an all-reduce, backward the
  identity (Megatron's ``g``): the partial sums of a split product;
- ``gather_last``: the vocab-split logits gathered on the last dim, its
  backward this rank's slice;
- ``fsdp_gather``: the all-gather of a ``data``-sharded dim in the
  weight's dtype; its backward a reduce-scatter in float32 cast back to
  the weight's dtype, the transpose of JAX's ``_fsdp_gather_bf16``
  (``repro/models/moe.py:91-111``);
- ``from_owner``: a layer of a stack whose layer dim FSDP split, sent by
  the rank that holds it; its backward a float32 reduce to that rank;
- ``pmean`` (forward a mean over the dp ranks, backward the identity:
  each dp rank's gradient is meaned over the dp ranks afterwards, so a
  statistic that enters the loss through it is counted once), and
  ``pmax``, ``pany`` and ``psum`` over any axes, for statistics without
  a gradient.

Every one of them takes an axis as ``sharding.AxisGroup`` (or
``ModelGroup``) gives it: ``group``, ``rank`` and ``size``.

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

CALLS: Dict[str, int] = {"all_reduce": 0, "all_gather": 0,
                         "reduce_scatter": 0, "broadcast": 0, "reduce": 0}

# all_gather_single and reduce_scatter_single are the newer names
_gather_into = getattr(dist, "all_gather_single", None) or \
    dist.all_gather_into_tensor
_scatter_from = getattr(dist, "reduce_scatter_single", None) or \
    dist.reduce_scatter_tensor


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


def all_gather_dim(t: torch.Tensor, axis, dim: int) -> torch.Tensor:
    """The ranks' ``t`` concatenated on ``dim`` in rank order."""
    CALLS["all_gather"] += 1
    out = torch.empty((axis.size * t.shape[0],) + tuple(t.shape[1:]),
                      dtype=t.dtype, device=t.device)
    _gather_into(out, t.contiguous(), group=axis.group)
    out = out.view(axis.size, *t.shape).movedim(0, dim)
    return out.reshape(*t.shape[:dim], axis.size * t.shape[dim],
                       *t.shape[dim + 1:])


def _scatter_dim(t: torch.Tensor, axis, dim: int) -> torch.Tensor:
    """``t`` summed over the ranks, this rank's block of ``dim`` kept."""
    CALLS["reduce_scatter"] += 1
    n = t.shape[dim] // axis.size
    src = t.movedim(dim, 0).contiguous()
    out = torch.empty((n,) + tuple(src.shape[1:]), dtype=t.dtype,
                      device=t.device)
    _scatter_from(out, src, group=axis.group)
    return out.movedim(0, dim)


class _CopyIn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        CALLS["all_reduce"] += 1
        dist.all_reduce(g, group=ctx.axis.group)
        return g, None


class _ReduceOut(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        out = x.contiguous().clone()
        CALLS["all_reduce"] += 1
        dist.all_reduce(out, group=axis.group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherLast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis, ctx.n = axis, x.shape[-1]
        return all_gather_dim(x, axis, x.dim() - 1)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(-1, ctx.axis.rank * ctx.n, ctx.n), None


class _FsdpGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, w, axis, dim):
        ctx.axis, ctx.dim, ctx.dtype = axis, dim, w.dtype
        return all_gather_dim(w, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return (_scatter_dim(g.float(), ctx.axis, ctx.dim).to(ctx.dtype),
                None, None)


class _FromOwner(torch.autograd.Function):
    @staticmethod
    def forward(ctx, w, axis, owner):
        ctx.axis, ctx.owner, ctx.dtype = axis, owner, w.dtype
        out = w.contiguous().clone()
        CALLS["broadcast"] += 1
        dist.broadcast(out, src=dist.get_global_rank(axis.group, owner),
                       group=axis.group)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.float().contiguous().clone()
        CALLS["reduce"] += 1
        dist.reduce(g, dst=dist.get_global_rank(ctx.axis.group, ctx.owner),
                    group=ctx.axis.group)
        if ctx.axis.rank != ctx.owner:
            return None, None, None
        return g.to(ctx.dtype), None, None


class _PMean(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        out = x.contiguous().clone()
        CALLS["all_reduce"] += 1
        dist.all_reduce(out, group=axis.group)
        return out / axis.size

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_in(x: torch.Tensor, axis) -> torch.Tensor:
    """Megatron's ``f`` on ``axis`` (None: ``x`` itself)."""
    return x if axis is None else _CopyIn.apply(x, axis)


def reduce_out(x: torch.Tensor, axis) -> torch.Tensor:
    """Megatron's ``g`` on ``axis`` (None: ``x`` itself)."""
    return x if axis is None else _ReduceOut.apply(x, axis)


def gather_last(x: torch.Tensor, axis) -> torch.Tensor:
    """``all_gather_last`` with a backward (None: ``x`` itself)."""
    return x if axis is None else _GatherLast.apply(x, axis)


def fsdp_gather(w: torch.Tensor, axis, dim: int) -> torch.Tensor:
    """``w``'s ``data``-sharded dim ``dim`` gathered over ``axis``."""
    return _FsdpGather.apply(w, axis, dim % w.dim())


def from_owner(w: torch.Tensor, axis, owner: int) -> torch.Tensor:
    """``w`` as rank ``owner`` of ``axis`` holds it, on every rank (the
    other ranks' ``w`` gives the shape and dtype and gets no gradient)."""
    return _FromOwner.apply(w, axis, owner)


def pmean(x: torch.Tensor, axis) -> torch.Tensor:
    """The mean of ``x`` over ``axis`` (None: ``x``), backward the
    identity."""
    return x if axis is None else _PMean.apply(x, axis)


def pmax(x: torch.Tensor, axis) -> torch.Tensor:
    """The max of ``x`` over ``axis``; no gradient."""
    if axis is None:
        return x
    out = x.detach().contiguous().clone()
    CALLS["all_reduce"] += 1
    dist.all_reduce(out, op=dist.ReduceOp.MAX, group=axis.group)
    return out


def pany(x: torch.Tensor, axis) -> torch.Tensor:
    """Whether any rank of ``axis`` holds True at each place of the bool
    ``x``; no gradient."""
    return x if axis is None else pmax(x.to(torch.int32), axis) > 0


def psum(x: torch.Tensor, axis) -> torch.Tensor:
    """The sum of ``x`` over ``axis``; no gradient (a statistic's
    counts)."""
    if axis is None:
        return x
    out = x.detach().contiguous().clone()
    CALLS["all_reduce"] += 1
    dist.all_reduce(out, group=axis.group)
    return out


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
