"""Per-request sampling parameters for the serving engine.

This slice of the port samples greedily only. ``SamplingParams`` keeps the
JAX package's fields so requests carry the same description, but a request
with ``temperature > 0`` is refused at submission: stochastic sampling
waits for a port of the JAX engine's threefry ``fold_in`` key stream
(``repro/serving/sampling.py``), which per-request token identity across
preemption rests on.
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """How to turn logits into a token. temperature<=0 means greedy."""

    temperature: float = 0.0
    top_k: int = 0                  # 0 = no truncation (clamped to vocab)
    top_p: float = 1.0              # 1.0 = no nucleus truncation
    seed: Optional[int] = None      # per-request PRNG seed

    @property
    def greedy(self) -> bool:
        return self.temperature <= 0.0

    def validate(self) -> None:
        if self.top_k < 0:
            raise ValueError(f"top_k must be >= 0, got {self.top_k}")
        if not 0.0 < self.top_p <= 1.0:
            raise ValueError(f"top_p must be in (0, 1], got {self.top_p}")

    def require_greedy(self) -> None:
        if not self.greedy:
            raise NotImplementedError(
                "the PyTorch port samples greedily only; stochastic sampling "
                "(threefry fold_in key parity with the JAX engine) is queued "
                "for a later slice of the port")


GREEDY = SamplingParams()
