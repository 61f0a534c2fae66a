"""Sparsity-induction recipe (paper Sec. 2.2): the activations and Eq. 2's
L1 term, as ``repro.core.sparsity`` defines them."""
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


def l1_loss(h: torch.Tensor) -> torch.Tensor:
    """Per-layer mean |h| term of Eq. 2 (the 1/L average is taken by the model)."""
    return h.float().abs().mean()
