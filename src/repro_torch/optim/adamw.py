"""AdamW + cosine schedule + global-norm clipping (paper App. B, Table 2),
as plain functions on the parameter tree, as ``repro/optim/adamw.py``
defines them: the update math runs in float32 whatever the moments'
dtype, and the result is functional (new tensors, nothing updated in
place). ``torch.optim.AdamW`` is not used: its step differs from the JAX
package's (bias correction and decay order), and the tests compare the
parameters after training steps.

On a training mesh the tree holds this rank's shards: ``update`` stays
elementwise on them, and ``global_norm`` (and so the clip) takes the
mesh and the leaves' specs, summing each leaf's squares over the axes
its spec shards it on, so that every element counts once.
"""
from __future__ import annotations

import math
from typing import Any, NamedTuple, Tuple

import torch

from repro_torch.tree import leaves, leaves_like, tree_map


class AdamWState(NamedTuple):
    step: torch.Tensor       # () int32
    m: Any                   # tree like params
    v: Any


def init(params: Any, dtype=torch.float32) -> AdamWState:
    first = leaves(params)[0]
    return AdamWState(torch.zeros((), dtype=torch.int32, device=first.device),
                      tree_map(lambda p: torch.zeros_like(p, dtype=dtype),
                               params),
                      tree_map(lambda p: torch.zeros_like(p, dtype=dtype),
                               params))


def cosine_schedule(step, peak_lr: float, warmup: int, total: int,
                    final_frac: float = 0.1) -> torch.Tensor:
    step = torch.as_tensor(step).float()
    warm = peak_lr * step / max(warmup, 1)
    t = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = final_frac * peak_lr + (1 - final_frac) * peak_lr * 0.5 * \
        (1 + torch.cos(math.pi * t))
    return torch.where(step < warmup, warm, cos)


def _axes_of(spec) -> Tuple[str, ...]:
    out = []
    for entry in spec:
        out += [entry] if isinstance(entry, str) else list(entry or ())
    return tuple(out)


def global_norm(tree: Any, mesh=None, specs: Any = None) -> torch.Tensor:
    """sqrt of the sum of every leaf's squares, in float32. With ``mesh``
    (a ``sharding.Mesh``) and ``specs`` (one spec a leaf) each leaf's sum
    over its shards is all-reduced over the axes its spec names (one
    collective for each set of axes), then summed in leaf order."""
    sums = [torch.sum(torch.square(g.float())) for g in leaves(tree)]
    if mesh is not None:
        from repro_torch.distributed import collectives
        axes = [_axes_of(sp) for sp in leaves_like(specs, tree)]
        for key in dict.fromkeys(a for a in axes if a):
            at = [i for i, a in enumerate(axes) if a == key]
            got = collectives.psum(torch.stack([sums[i] for i in at]),
                                     mesh.axis(*key))
            for j, i in enumerate(at):
                sums[i] = got[j]
    return torch.sqrt(sum(sums))


def clip_by_global_norm(grads: Any, max_norm: float, mesh=None,
                        specs: Any = None) -> Tuple[Any, torch.Tensor]:
    gn = global_norm(grads, mesh, specs)
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-12), max=1.0)
    return tree_map(lambda g: (g.float() * scale).to(g.dtype), grads), gn


def update(params: Any, grads: Any, state: AdamWState, *, lr,
           beta1: float = 0.9, beta2: float = 0.95, eps: float = 1e-8,
           weight_decay: float = 0.1) -> Tuple[Any, AdamWState]:
    """Decoupled weight decay; update math in f32 regardless of dtypes."""
    step = state.step + 1
    t = step.float()
    bc1 = 1 - beta1 ** t
    bc2 = 1 - beta2 ** t

    def upd(p, g, m, v):
        gf = g.float()
        mf = beta1 * m.float() + (1 - beta1) * gf
        vf = beta2 * v.float() + (1 - beta2) * torch.square(gf)
        step_v = (mf / bc1) / (torch.sqrt(vf / bc2) + eps) + \
            weight_decay * p.float()
        return ((p.float() - lr * step_v).to(p.dtype), mf.to(m.dtype),
                vf.to(v.dtype))

    out = tree_map(upd, params, grads, state.m, state.v)
    return _pick(out, 0), AdamWState(step, _pick(out, 1), _pick(out, 2))


def _pick(tree, i):
    """Item ``i`` of every (param, m, v) leaf triple of a dict tree."""
    if isinstance(tree, dict):
        return {k: _pick(v, i) for k, v in tree.items()}
    return tree[i]
