"""The part of ``jax.random`` the port draws with, bit for bit as the
installed jax 0.9.0 computes it on the CPU:

- keys are threefry2x32 keys, a (2,) pair of uint32 words;
  ``PRNGKey(seed)`` is ``[seed >> 32, seed & 0xFFFFFFFF]`` and
  ``fold_in(key, d)`` hashes the counter pair ``(0, d)`` under ``key``;
- random bits and ``split`` follow ``jax_threefry_partitionable=True`` (the
  release's default): element ``i`` of a draw of shape ``s`` hashes the
  counter pair ``(i >> 32, i & 0xFFFFFFFF)``; bits keep the XOR of the two
  output words, ``split`` keeps both words as the new key;
- ``uniform`` puts the top mantissa bits in a number in [1, 2) and
  subtracts 1;
- ``normal`` is ``sqrt(2) * erf_inv(uniform(key, nextafter(-1, 0), 1))``,
  with XLA's float32 ``erf_inv`` (Giles' polynomials over XLA's ``log1p``).

The uint32 words live in int64 tensors masked with ``0xFFFFFFFF`` (torch has
no unsigned 32-bit arithmetic), so the same code runs on the CPU and on the
card. The serving sampler (``serving/sampling.py``) and the dead-neuron
reinitialization (``core/sparsity.py``) draw from here.
"""
from __future__ import annotations

from typing import Union

import numpy as np
import torch

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


def _bits_to_unit(bits: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """uint32 words -> ``dtype`` in [0, 1): the word's top mantissa bits
    under exponent 0 (23 of 32 for float32; for bfloat16, with fewer than 8
    mantissa bits, jax draws 8-bit words, the low byte of each 32-bit word,
    and keeps their top 7)."""
    if dtype == torch.bfloat16:
        f = (((bits & 0xFF) >> 1) | 0x3F80).to(torch.int16)
    elif dtype == torch.float32:
        f = ((bits >> 9) | 0x3F800000).to(torch.int32)
    else:
        raise TypeError(f"uniform draws float32 or bfloat16, not {dtype}")
    return f.view(dtype) - 1.0


def _rounded(v: float, dtype) -> float:
    """The Python float ``v`` rounded to ``dtype`` on the host."""
    if dtype == torch.float32:
        return float(np.float32(v))
    return float(torch.tensor(float(np.float32(v))).to(dtype))


def uniform(key: torch.Tensor, shape=(), minval: float = 0.0,
            maxval: float = 1.0, dtype=torch.float32) -> torch.Tensor:
    """``jax.random.uniform`` in float32 (or bfloat16). The bounds stay
    Python scalars (values of ``dtype``, their difference rounded in it) and
    never become tensors: a tensor made from a host number is a pageable
    copy, which a CUDA graph capture refuses (the sampling entries are
    captured)."""
    lo = _rounded(minval, dtype)
    span = _rounded(_rounded(maxval, dtype) - lo, dtype)
    f = _bits_to_unit(random_bits(key, shape), dtype)
    return torch.clamp_min(f * span + lo, lo)


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


# ------------------------------------------------------------ split, normal

def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split``: key (2,) -> (num, 2); new key ``i`` is the
    two-word hash of the counter pair ``(i >> 32, i & 0xFFFFFFFF)``."""
    i = torch.arange(int(num), dtype=torch.int64, device=key.device)
    o0, o1 = threefry2x32(key, i >> 32, i & _MASK)
    return torch.stack([o0, o1], dim=-1)


# Cephes' log1p rational approximation, as XLA's CPU backend evaluates it
_LOG1P_NUM = (4.5270000862445199635215e-5, 4.9854102823193375972212e-1,
              6.5787325942061044846969e0, 2.9911919328553073277375e1,
              6.0949667980987787057556e1, 5.7112963590585538103336e1,
              2.0039553499201281259648e1)
_LOG1P_DEN = (1.0, 1.5062909083469192043167e1, 8.3047565967967209469434e1,
              2.2176239823732856465394e2, 3.0909872225312059774938e2,
              2.1642788614495947685003e2, 6.0118660497603843919306e1)
# Giles, "Approximating the erfinv function": w < 5 and w >= 5 branches
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)


def _horner(x: torch.Tensor, coeffs) -> torch.Tensor:
    r = torch.full_like(x, float(np.float32(coeffs[0])))
    for c in coeffs[1:]:
        r = _fma(r, x, c)
    return r


def log1p(x: torch.Tensor) -> torch.Tensor:
    """float32 log(1 + x) as XLA's CPU backend computes ``jnp.log1p``:
    below |x| < sqrt(2) - 1 Cephes' rational approximation (its Horner
    steps and the final multiply-add as FMAs), else ``log(x + 1)`` with
    XLA's ``log``. Not correctly rounded, like XLA's."""
    x = x.float()
    x2 = x * x
    small = (x * x2) * (_horner(x, _LOG1P_NUM) / _horner(x, _LOG1P_DEN))
    small = x + _fma(x2, -0.5, small)
    return torch.where(x.abs() < 0.41421356237309504880, small, log(x + 1.0))


def erf_inv(x: torch.Tensor) -> torch.Tensor:
    """float32 inverse error function as XLA lowers ``lax.erf_inv``:
    w = -log1p(-x^2), a degree-8 polynomial in w - 2.5 (w < 5) or in
    sqrt(w) - 3, times x; +-inf at +-1. Equal to jax's bit for bit except
    where XLA's CPU ``sqrt`` (an estimate refined once, not correctly
    rounded) differs from ``torch.sqrt`` in the last bit: |x| above about
    0.9966, where the result may differ by an ulp."""
    x = x.float()
    w = -log1p(x * -x)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0)

    def coeff(i):
        return torch.where(lt, float(np.float32(_ERFINV_LT5[i])),
                           float(np.float32(_ERFINV_GE5[i])))
    p = coeff(0)
    for i in range(1, len(_ERFINV_LT5)):
        p = _fma(p, w, coeff(i))
    return torch.where(x.abs() == 1.0, x * float("inf"), p * x)


def normal(key: torch.Tensor, shape=(), dtype=torch.float32) -> torch.Tensor:
    """``jax.random.normal`` in float32 (or bfloat16): ``uniform`` in
    (-1, 1) of ``dtype`` (the lower bound is -1's neighbour toward 0), then
    ``sqrt(2) * erf_inv``; for bfloat16 erf_inv runs in float32 and rounds
    once, the product with sqrt(2) rounds in bfloat16."""
    eps = 2.0 ** -24 if dtype == torch.float32 else 2.0 ** -8
    u = uniform(key, shape, -1.0 + eps, 1.0, dtype)
    return erf_inv(u).to(dtype) * _rounded(np.sqrt(2), dtype)
