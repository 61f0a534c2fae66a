"""Kernel K7 (causal flash attention) in the PyTorch port: its plain version
against the JAX package's Pallas kernel (interpret mode) and
``kernels/ref.py:flash_attention``, over the sweep of
tests/test_kernels.py:117-130, and the ``FlashAttention`` autograd
function's gradients against ``jax.grad`` of the reference. Same numpy
inputs on both sides.

Tolerances: float32 2e-4 (rtol and atol; both sides take an f32 softmax,
summed in different orders); bfloat16 3e-2, as tests/test_kernels.py
(the probabilities round to bf16 at different points: the Pallas body and
the plain version round exp(s - max) before the product with v, ref.py
the normalised probabilities).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention_pallas
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import (flash_attention_backward,
                                                 flash_attention_plain)

SWEEP = [(2, 128, 2, 64, 64, 64), (1, 256, 4, 32, 64, 128),
         (2, 512, 1, 64, 128, 256)]


def _tol(dtype):
    return dict(rtol=3e-2, atol=3e-2) if dtype == "bfloat16" else \
        dict(rtol=2e-4, atol=2e-4)


def _qkv(b, s, h, hd, seed):
    rng = np.random.RandomState(seed)
    return [rng.randn(b, s, h, hd).astype(np.float32) for _ in range(3)]


def _both(a, dtype):
    j = jnp.asarray(a, dtype=jnp.dtype(dtype))
    t = torch.from_numpy(a)
    return j, (t.bfloat16() if dtype == "bfloat16" else t)


@pytest.mark.parametrize("b,s,h,hd,bq,bk", SWEEP)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_pallas_and_ref(b, s, h, hd, bq, bk, dtype):
    (jq, q), (jk, k), (jv, v) = [_both(a, dtype)
                                 for a in _qkv(b, s, h, hd, s + hd)]
    o = flash_attention_plain(q, k, v)
    assert o.dtype == q.dtype and o.shape == q.shape
    got = o.float().numpy()
    jo = flash_attention_pallas(jq, jk, jv, bq=bq, bk=bk, interpret=True)
    np.testing.assert_allclose(got, np.asarray(jo, np.float32),
                               **_tol(dtype))
    np.testing.assert_allclose(got, np.asarray(jref.flash_attention(
        jq, jk, jv), np.float32), **_tol(dtype))


@pytest.mark.parametrize("b,s,h,hd", [(2, 64, 2, 16), (1, 96, 3, 32)])
def test_gradients_match_jax_grad(b, s, h, hd):
    """dq, dk, dv of <o, do> through ops.flash_attention (the autograd
    function) and through flash_attention_backward itself, against
    jax.grad of ref.flash_attention."""
    q, k, v = _qkv(b, s, h, hd, 7)
    do = np.random.RandomState(8).randn(b, s, h, hd).astype(np.float32)

    def jloss(q_, k_, v_):
        return jnp.sum(jref.flash_attention(q_, k_, v_) * jnp.asarray(do))
    jg = jax.grad(jloss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    o = ops.flash_attention(tq, tk, tv)
    grads = torch.autograd.grad(o, (tq, tk, tv), torch.from_numpy(do))
    direct = flash_attention_backward(tq.detach(), tk.detach(), tv.detach(),
                                      o.detach(), torch.from_numpy(do))
    for name, g, d, want in zip("qkv", grads, direct, jg):
        np.testing.assert_allclose(g.numpy(), np.asarray(want),
                                   **_tol("float32"), err_msg=f"d{name}")
        np.testing.assert_array_equal(g.numpy(), d.numpy())


def test_first_row_attends_only_itself():
    """Causality: row 0's output is v[0] exactly, whatever the scores."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 16, 2, 8, 3))
    o = flash_attention_plain(q, k, v)
    torch.testing.assert_close(o[:, 0], v[:, 0], rtol=0, atol=1e-6)
