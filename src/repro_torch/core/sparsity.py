"""Sparsity-induction recipe (paper Sec. 2.2) + analysis instrumentation,
as ``repro.core.sparsity`` defines them:

- the activations and their derivative on the non-zero pattern;
- Eq. 2's L1 term and its App. C.3 warm-up schedule;
- per-layer / per-token sparsity statistics (Sec. 4.3, Figs. 6-7);
- dead-neuron tracking and targeted gate-column reinitialization (Eq. 6).
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch import random


def activation(name: str):
    if name == "relu":
        return torch.relu
    if name == "silu":
        return F.silu
    if name == "relu2":
        return lambda x: torch.square(torch.relu(x))
    raise ValueError(f"unknown activation {name!r}")


def activation_grad(name: str, h: torch.Tensor) -> torch.Tensor:
    """sigma'(z) expressed through the *post*-activation value h (valid on the
    non-zero pattern, where z is recoverable from h)."""
    if name == "relu":
        return torch.ones_like(h)
    if name == "relu2":
        return 2.0 * torch.sqrt(torch.clamp(h, min=0))
    raise ValueError(f"pattern-only backward undefined for {name!r}")


def l1_loss(h: torch.Tensor) -> torch.Tensor:
    """Per-layer mean |h| term of Eq. 2 (the 1/L average is taken by the model)."""
    return h.float().abs().mean()


def l1_schedule(step, l1_coeff: float, constant_steps: int,
                warmup_steps: int) -> torch.Tensor:
    """App. C.3 sparsity warm-up: 0 for ``constant_steps``, then a linear
    ramp over ``warmup_steps`` (a float32 0-d tensor; ``step`` an int or a
    0-d tensor)."""
    if warmup_steps <= 0:
        return torch.tensor(l1_coeff, dtype=torch.float32)
    t = (torch.as_tensor(step, dtype=torch.float32) - constant_steps) / \
        warmup_steps
    return l1_coeff * torch.clamp(t, 0.0, 1.0)


# --------------------------------------------------------------------------- #
# statistics (Sec. 4.3)
# --------------------------------------------------------------------------- #

def layer_stats(h: torch.Tensor) -> Dict[str, torch.Tensor]:
    """nnz statistics of one layer's hidden activations (tokens, N)."""
    nz = h != 0
    nnz = nz.sum(dim=-1)
    return {
        "nnz_mean": nnz.float().mean(),
        "nnz_max": nnz.max().to(torch.int32),
        "active_frac": nz.float().mean(),
        "l1": l1_loss(h),
    }


def position_nnz(h: torch.Tensor, batch: int, seq: int) -> torch.Tensor:
    """Average nnz per sequence position (Fig. 7b). h: (batch*seq, N)."""
    nnz = (h != 0).sum(dim=-1).reshape(batch, seq)
    return nnz.float().mean(dim=0)


def update_dead_mask(ever_active: torch.Tensor, h: torch.Tensor
                     ) -> torch.Tensor:
    """OR-accumulate per-neuron activity over a step (App. D.1 definition:
    a neuron is dead for a step if it never fired in ~1M tokens)."""
    return ever_active | (h != 0).reshape(-1, h.shape[-1]).any(dim=0)


def dead_fraction(ever_active: torch.Tensor) -> torch.Tensor:
    return 1.0 - ever_active.float().mean()


# --------------------------------------------------------------------------- #
# targeted dead-neuron reinitialization (Eq. 6)
# --------------------------------------------------------------------------- #

def targeted_reinit(key: torch.Tensor, w_gate: torch.Tensor,
                    dead: torch.Tensor, lam: float = 0.1,
                    sigma: float = 0.02) -> torch.Tensor:
    """W_g[:, j] <- (1-lam) W_g[:, j] + lam N(0, sigma^2) for dead columns j.

    Applied after every optimizer step (App. C.3). ``key`` is a threefry
    key (``repro_torch.random``): the noise is ``jax.random.normal``'s draw
    for that key. ``dead``: (N,) bool — neurons that never fired during the
    last window."""
    noise = sigma * random.normal(key, tuple(w_gate.shape), w_gate.dtype)
    blended = (1.0 - lam) * w_gate + lam * noise
    return torch.where(dead[None, :], blended, w_gate)
