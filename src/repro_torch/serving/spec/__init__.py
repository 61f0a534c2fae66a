"""Self-speculative decoding for the continuous-batching engine.

One set of weights, two execution paths: the thresholded tile-skip path
(kernel K5) is nearly free but slightly lossy and drafts; the gather/TwELL
(or dense) path is exact and verifies. Ports ``repro/serving/spec/``:

  drafter.py   — ``Drafter``: the k-token draft loop through the draft
                 backend, writing scratch KV positions past each request's
                 committed length.
  verifier.py  — ``Verifier``: one batched verify forward through the
                 trusted backend (overwriting the draft's approximate K/V),
                 and the exact host-side acceptance rule.
  rollback.py  — returning the blocks of rejected scratch positions to the
                 pool after acceptance.

``ServingEngine(..., spec=SpecConfig(...))`` drives draft -> verify ->
accept -> rollback for spec-eligible requests while the rest of the batch
decodes one token at a time.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class SpecConfig:
    """Speculative-decoding knobs for the serving engine.

    k:               draft tokens proposed per engine step (per request).
    draft_backend:   cheap execution path for the draft loop
                     (``tile_skip`` | ``gather`` | ``dense``).
    draft_threshold: tile-skip gate threshold of the draft pass (0 = the
                     lossless skip); tile_skip drafts only.
    """

    k: int = 4
    draft_backend: str = "tile_skip"
    draft_threshold: float = 0.0

    def validate(self) -> None:
        if self.k < 1:
            raise ValueError(f"spec k must be >= 1, got {self.k}")
        if self.draft_threshold < 0:
            raise ValueError(
                f"draft_threshold must be >= 0, got {self.draft_threshold}")


from repro_torch.serving.spec.drafter import Drafter  # noqa: E402
from repro_torch.serving.spec.rollback import \
    rollback_after_verify  # noqa: E402
from repro_torch.serving.spec.verifier import Verifier  # noqa: E402

__all__ = ["SpecConfig", "Drafter", "Verifier", "rollback_after_verify"]
