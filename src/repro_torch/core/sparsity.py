"""Sparsity-induction recipe (paper Sec. 2.2): the activations, their
derivative on the non-zero pattern, Eq. 2's L1 term and its App. C.3
warm-up schedule, as ``repro.core.sparsity`` defines them."""
from __future__ import annotations

import torch
import torch.nn.functional as F


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
