"""Per-request sampling for the serving engine, bit for bit the JAX sampler.

Ports ``repro/serving/sampling.py`` on the threefry keys and draws of
``repro_torch/random.py`` (``jax.random`` as the installed jax 0.9.0
computes it); ``categorical`` is ``argmax(gumbel(key, shape, mode="low") +
logits)`` with ``gumbel = -log(-log(uniform(key, tiny, 1)))``.

Request sampling never touches ``torch.Generator`` or Philox: the
per-request key stream ``fold_in(base_key, num_generated)`` is what makes a
seeded request reproducible across batch composition and preemption, and
what lets the port's tokens equal the JAX engine's.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.random import (_TINY32, IntLike, PRNGKey,  # noqa: F401
                                _bits_to_unit, fold_in, log, random_bits,
                                uniform)


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """How to turn logits into a token. temperature<=0 means greedy."""

    temperature: float = 0.0
    top_k: int = 0                  # 0 = no truncation (clamped to vocab)
    top_p: float = 1.0              # 1.0 = no nucleus truncation
    seed: Optional[int] = None      # per-request PRNG seed (None: engine's)

    @property
    def greedy(self) -> bool:
        return self.temperature <= 0.0

    def validate(self) -> None:
        if self.top_k < 0:
            raise ValueError(f"top_k must be >= 0, got {self.top_k}")
        if not 0.0 < self.top_p <= 1.0:
            raise ValueError(f"top_p must be in (0, 1], got {self.top_p}")


GREEDY = SamplingParams()

# Independent PRNG streams for the speculative-decoding draws, disjoint from
# the plain decode stream (fold_in(base_key, position)).
_SPEC_STREAM_BASE = 0x53504543                 # "SPEC"
STREAM_DRAFT, STREAM_ACCEPT, STREAM_RESAMPLE = 0, 1, 2

def gumbel(key: torch.Tensor, shape) -> torch.Tensor:
    """``jax.random.gumbel(..., mode="low")`` in float32."""
    return -log(-log(uniform(key, shape, _TINY32, 1.0)))


def categorical(key: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical`` over the last axis of float32 ``logits``
    (..., V) with key (..., 2): argmax of Gumbel noise plus the logits."""
    v = logits.shape[-1]
    return torch.argmax(gumbel(key, (v,)) + logits.float(), dim=-1)


# ------------------------------------------------------------ request keys

def request_base_key(master_key: torch.Tensor, rid: int,
                     seed: Optional[int] = None) -> torch.Tensor:
    """The base key for one request: ``PRNGKey(seed)`` when the request is
    seeded (a function of the request alone), else the engine master key
    folded by the submission-order rid."""
    if seed is not None:
        return PRNGKey(seed, device=master_key.device)
    return fold_in(master_key, rid)


def request_key(base_key: torch.Tensor, position: int) -> torch.Tensor:
    """The key for a request's ``position``-th generated token."""
    return fold_in(base_key, position)


def batch_keys(base_keys: torch.Tensor, positions: torch.Tensor
               ) -> torch.Tensor:
    """Vectorized ``request_key``: (B, 2) keys x (B,) positions -> (B, 2)."""
    return fold_in(base_keys, positions)


def spec_key(base_key: torch.Tensor, position: IntLike, stream: int
             ) -> torch.Tensor:
    """Spec-decode key for one (request, position, stream) triple."""
    return fold_in(fold_in(base_key, _SPEC_STREAM_BASE + stream), position)


def spec_batch_keys(base_keys: torch.Tensor, positions: torch.Tensor,
                    stream: int) -> torch.Tensor:
    """Vectorized ``spec_key``: (B, 2) x (B,) -> (B, 2)."""
    return spec_key(base_keys, positions, stream)


# ------------------------------------------------------------ the sampler

def filter_logits(logits: torch.Tensor, temperatures: torch.Tensor,
                  top_ks: torch.Tensor,
                  top_ps: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Temperature-scale then truncate logits to the sampling support.

    logits (B, V); temperatures (B,) (rows <= 0 are scaled by 1.0: the
    caller takes argmax for those); top_ks (B,) int, 0 = unrestricted,
    clamped to V; top_ps (B,) in (0, 1], None or 1.0 = no nucleus.
    Returns (B, V) float32 with excluded entries -inf."""
    logits = logits.float()
    v = logits.shape[-1]
    t = temperatures.float()
    safe_t = torch.where(t > 0, t, torch.ones_like(t))[:, None]
    scaled = logits / safe_t
    kk = torch.clamp(top_ks.long(), 0, v)
    idx = torch.clamp(kk - 1, 0, v - 1)
    sorted_desc = torch.sort(scaled, dim=-1, descending=True).values
    kth = torch.gather(sorted_desc, -1, idx[:, None])
    ninf = torch.full_like(scaled, float("-inf"))
    masked = torch.where((kk[:, None] == 0) | (scaled >= kth), scaled, ninf)
    if top_ps is not None:
        # token j (sorted desc) is kept iff the mass strictly before it is
        # < top_p; rows with top_p >= 1 keep everything
        pp = top_ps.float()[:, None]
        sorted_m = torch.sort(masked, dim=-1, descending=True).values
        probs = torch.softmax(sorted_m, dim=-1)
        before = torch.cumsum(probs, dim=-1) - probs
        keep = (before < pp) | (pp >= 1.0)
        cutoff = torch.where(keep, sorted_m,
                             torch.full_like(sorted_m, float("inf"))
                             ).amin(dim=-1)
        masked = torch.where(masked >= cutoff[:, None], masked, ninf)
    return masked


def sample_tokens(logits: torch.Tensor, keys: torch.Tensor,
                  temperatures: torch.Tensor, top_ks: torch.Tensor,
                  top_ps: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Batched per-request sampling: logits (B, V), keys (B, 2),
    temperatures (B,), top_ks (B,), top_ps (B,) or None. Rows with
    temperature <= 0 take the argmax; the rest draw from the filtered
    categorical with their own key. Returns (B,) int64."""
    logits = logits.float()
    greedy_tok = torch.argmax(logits, dim=-1)
    masked = filter_logits(logits, temperatures, top_ks, top_ps)
    sampled = categorical(keys, masked)
    return torch.where(temperatures.to(logits.device) <= 0, greedy_tok,
                       sampled)
