"""Per-request sampling for the serving engine, bit for bit the JAX sampler.

Ports ``repro/serving/sampling.py`` together with the part of
``jax.random`` it rests on, as the installed jax 0.9.0 computes it:

- keys are threefry2x32 keys, a (2,) pair of uint32 words;
  ``PRNGKey(seed)`` is ``[seed >> 32, seed & 0xFFFFFFFF]`` and
  ``fold_in(key, d)`` hashes the counter pair ``(0, d)`` under ``key``;
- random bits follow ``jax_threefry_partitionable=True`` (the release's
  default): element ``i`` of a draw of shape ``s`` hashes the counter pair
  ``(i >> 32, i & 0xFFFFFFFF)`` and keeps the XOR of the two output words;
- ``uniform`` float32 puts the top 23 bits in the mantissa of a number in
  [1, 2) and subtracts 1;
- ``categorical`` is ``argmax(gumbel(key, shape, mode="low") + logits)``
  with ``gumbel = -log(-log(uniform(key, tiny, 1)))``.

The uint32 words live in int64 tensors masked with ``0xFFFFFFFF`` (torch has
no unsigned 32-bit arithmetic), so the same code runs on the CPU and on the
card. Request sampling never touches ``torch.Generator`` or Philox: the
per-request key stream ``fold_in(base_key, num_generated)`` is what makes a
seeded request reproducible across batch composition and preemption, and
what lets the port's tokens equal the JAX engine's.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Union

import numpy as np
import torch


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

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_TINY32 = float(np.finfo(np.float32).tiny)

IntLike = Union[int, torch.Tensor]


# ------------------------------------------------------------ threefry2x32

def _rotl(v: torch.Tensor, r: int) -> torch.Tensor:
    return ((v << r) | (v >> (32 - r))) & _MASK


def threefry2x32(key: torch.Tensor, x0: torch.Tensor, x1: torch.Tensor):
    """The Threefry-2x32 hash (20 rounds) of counter words ``(x0, x1)``
    under ``key`` (..., 2); every word is a uint32 held in int64. Shapes
    broadcast. Returns the two output words."""
    k0, k1 = key[..., 0], key[..., 1]
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _MASK
    x1 = (x1 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _MASK
    return x0, x1


def _words(v: IntLike, device=None) -> torch.Tensor:
    if isinstance(v, torch.Tensor):
        return v.to(torch.int64) & _MASK
    return torch.tensor(int(v) & _MASK, dtype=torch.int64, device=device)


def PRNGKey(seed: int, device=None) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` as an int64 (2,) tensor. jax converts a
    Python int seed to int32 (64-bit types are off), so the high word is 0
    and the low word is the seed's two's complement."""
    seed = int(seed)
    if not -2 ** 31 <= seed < 2 ** 31:
        raise ValueError(f"seed must fit in int32, got {seed}")
    return torch.tensor([0, seed & _MASK], dtype=torch.int64, device=device)


def fold_in(key: torch.Tensor, data: IntLike) -> torch.Tensor:
    """``jax.random.fold_in``: key (..., 2), data an int or a tensor that
    broadcasts against ``key[..., 0]``."""
    d = _words(data, key.device)
    o0, o1 = threefry2x32(key, torch.zeros_like(d), d)
    return torch.stack(torch.broadcast_tensors(o0, o1), dim=-1)


def random_bits(key: torch.Tensor, shape) -> torch.Tensor:
    """32 random bits per element of ``shape`` (the partitionable form):
    key (..., 2) -> (..., *shape) int64 words."""
    shape = tuple(shape)
    n = int(np.prod(shape)) if shape else 1
    i = torch.arange(n, dtype=torch.int64, device=key.device)
    k = key.reshape(*key.shape[:-1], *([1] * len(shape)), 2)
    o0, o1 = threefry2x32(k, (i >> 32).reshape(shape),
                          (i & _MASK).reshape(shape))
    return o0 ^ o1


def _bits_to_unit(bits: torch.Tensor) -> torch.Tensor:
    """uint32 words -> float32 in [0, 1): 23 mantissa bits under exponent 0."""
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    return f - 1.0


def uniform(key: torch.Tensor, shape=(), minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform`` in float32."""
    lo = torch.tensor(minval, dtype=torch.float32, device=key.device)
    hi = torch.tensor(maxval, dtype=torch.float32, device=key.device)
    f = _bits_to_unit(random_bits(key, shape))
    return torch.maximum(lo, f * (hi - lo) + lo)


def _fma(a: torch.Tensor, b, c) -> torch.Tensor:
    """float32 a * b + c rounded once: the product of two float32 numbers is
    exact in float64, so only the sum rounds (twice, f64 then f32; the two
    roundings disagree with one only on an exact float32 tie)."""
    a = a.double()
    b = b.double() if isinstance(b, torch.Tensor) else float(np.float32(b))
    c = c.double() if isinstance(c, torch.Tensor) else float(np.float32(c))
    return (a * b + c).float()


def log(x: torch.Tensor) -> torch.Tensor:
    """float32 natural log as XLA's CPU backend computes ``jnp.log``: the
    Cephes ``logf`` polynomial, its multiply-adds contracted to FMAs.
    ``torch.log`` is correctly rounded far more often and so disagrees with
    it in the last bit on about one input in seven, which would move Gumbel
    draws and, at a near-tie, a sampled token. XLA's CPU code flushes
    denormal inputs to zero, so their log is -inf here too."""
    x = x.float()
    xc = torch.where(x <= _TINY32, torch.full_like(x, _TINY32), x)
    i = xc.view(torch.int32)
    e = ((i >> 23) - 0x7F).float() + 1.0
    m = ((i & -2139095041) | 0x3F000000).view(torch.float32)    # in [0.5, 1)
    small = m < 0.707106781186547524
    e = e - small.float()
    m = (m - 1.0) + torch.where(small, m, torch.zeros_like(m))
    m2 = m * m
    m3 = m2 * m
    y = _fma(m, 7.0376836292e-2, -1.1514610310e-1)
    y1 = _fma(m, -1.2420140846e-1, 1.4249322787e-1)
    y2 = _fma(m, 2.0000714765e-1, -2.4999993993e-1)
    y = _fma(y, m, 1.1676998740e-1)
    y1 = _fma(y1, m, -1.6668057665e-1)
    y2 = _fma(y2, m, 3.3333331174e-1)
    y = _fma(y, m3, y1)
    y = _fma(y, m3, y2)
    y = _fma(y, m3, e * float(np.float32(-2.12194440e-4)))
    out = _fma(m2, -0.5, m) + y
    out = _fma(e, 0.693359375, out)
    out = torch.where(x < 0, torch.full_like(x, float("nan")), out)
    out = torch.where(x.abs() < _TINY32, torch.full_like(x, float("-inf")),
                      out)
    return torch.where(torch.isinf(x) & (x > 0), x, out)


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
