"""The hybrid training format in the PyTorch port against the JAX package:
``core/hybrid.py`` (pack, unpack, the overflow contract, both products),
kernels K8/K9's plain versions against the Pallas kernels in interpret
mode, and the hybrid FFN ``autograd.Function`` against JAX's
``custom_vjp`` -- outputs, statistics and all four gradients. Same numpy
inputs on both sides.

Tolerances: the packed format is compared exactly (indices, counts,
routing, values copied); float32 products 2e-4 (rtol and atol), as
tests/test_kernels.py; gradients 2e-4 as well (both sides run the same
Eq. 4 arithmetic, in different summation orders).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import SparsityConfig as JSparsityConfig
from repro.core import hybrid as jhyb
from repro.core import sparse_ffn as jffn
from repro.kernels import ref as jref
from repro.kernels.hybrid_matmul import (dense_to_hybrid_pallas,
                                         hybrid_to_dense_pallas)
from repro_torch.config import SparsityConfig
from repro_torch.core import hybrid as hyb
from repro_torch.core import sparse_ffn
from repro_torch.kernels import ops
from repro_torch.kernels.hybrid_matmul import (dense_to_hybrid_plain,
                                               hybrid_to_dense_plain)

TOL = dict(rtol=2e-4, atol=2e-4)
FIELDS = ("ell_values", "ell_indices", "row_nnz", "is_dense", "dense_rows",
          "dense_map", "overflow")


def _mixed_rows(seed, m, n, sparse_nnz, dense_frac):
    """Rows with a few non-zeros plus some dense rows (the paper's
    observation), as tests/test_hybrid_format.py builds them."""
    rng = np.random.RandomState(seed)
    h = np.zeros((m, n), np.float32)
    for r in range(m):
        cols = rng.randint(0, n, sparse_nnz)
        h[r, cols] = np.abs(rng.randn(sparse_nnz)) + 0.1
    dense = rng.rand(m) < dense_frac
    h[dense] = np.abs(rng.randn(int(dense.sum()), n)) + 0.1
    return h


def _assert_same_pack(hy, jy):
    for f in FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(hy, f)),
                                      np.asarray(getattr(jy, f)), err_msg=f)
    assert hy.n == jy.n


@pytest.mark.parametrize("seed,dense_frac,backup", [
    (0, 0.0, 16), (1, 0.2, 16), (2, 0.4, 16), (3, 0.4, 2), (4, 0.3, 1)])
def test_pack_and_unpack_match_jax(seed, dense_frac, backup):
    """Every field of the packed format equals JAX's, the overflow flag
    included (backup 1-2 rows: the excess dense rows are dropped)."""
    m, n, ew = 16, 64, 8
    h = _mixed_rows(seed, m, n, 4, dense_frac)
    hy = hyb.pack(torch.from_numpy(h), ew, num_dense_rows=backup)
    jy = jhyb.pack(jnp.asarray(h), ew, num_dense_rows=backup)
    _assert_same_pack(hy, jy)
    np.testing.assert_array_equal(hyb.unpack(hy).numpy(),
                                  np.asarray(jhyb.unpack(jy)))
    if backup >= m:
        np.testing.assert_array_equal(hyb.unpack(hy).numpy(), h)
    assert hyb.memory_bytes(hy) == jhyb.memory_bytes(jy)


def test_overflow_contract_and_log():
    """Backup exhaustion sets the flag (App. B.2.1) and the overflow log;
    the log counts the rows each side of the format took."""
    ops.HybridOverflowLog.reset()
    hy = hyb.pack(torch.ones(8, 32), ell_width=4, num_dense_rows=2)
    assert bool(hy.overflow) and ops.HybridOverflowLog.seen()
    assert int((hy.dense_map >= 0).sum()) == 2
    assert ops.HybridOverflowLog.rows() == (0, 8)
    ops.HybridOverflowLog.reset()
    assert ops.HybridOverflowLog.rows() == (0, 0)
    h = torch.ones(8, 32)
    h[:5, 3:] = 0                           # 5 rows of 3 non-zeros
    hyb.pack(h, ell_width=4, num_dense_rows=8)
    hyb.pack(h, ell_width=4, num_dense_rows=8)
    assert not ops.HybridOverflowLog.seen()
    assert ops.HybridOverflowLog.rows() == (10, 6)


def test_pack_with_mask_and_elementwise():
    h = _mixed_rows(5, 12, 48, 5, 0.2) - 0.05          # a few negatives
    mask = h > 0
    hy = hyb.pack(torch.from_numpy(h), 8, 12, mask=torch.from_numpy(mask))
    jy = jhyb.pack(jnp.asarray(h), 8, 12, mask=jnp.asarray(mask))
    _assert_same_pack(hy, jy)
    e = hyb.elementwise(hy, hy.ell_values, hy.dense_rows, torch.mul)
    je = jhyb.elementwise(jy, jy.ell_values, jy.dense_rows, jnp.multiply)
    _assert_same_pack(e, je)


@pytest.mark.parametrize("seed,dense_frac", [(0, 0.0), (1, 0.2), (2, 0.4)])
def test_products_match_jax(seed, dense_frac):
    """hybrid_to_dense_matmul (K8 side + backup matmul) and
    dense_to_hybrid_matmul (K9 side + backup matmul) against JAX's, and
    both against the dense products."""
    m, n, k, ew = 12, 64, 24, 8
    rng = np.random.RandomState(seed + 10)
    h = _mixed_rows(seed, m, n, 5, dense_frac)
    w = (rng.randn(n, k) * 0.1).astype(np.float32)
    x = rng.randn(m, k).astype(np.float32)
    w2 = (rng.randn(k, n) * 0.1).astype(np.float32)
    hy = hyb.pack(torch.from_numpy(h), ew, num_dense_rows=m)
    jy = jhyb.pack(jnp.asarray(h), ew, num_dense_rows=m)
    y = hyb.hybrid_to_dense_matmul(hy, torch.from_numpy(w))
    np.testing.assert_allclose(y.numpy(), np.asarray(
        jhyb.hybrid_to_dense_matmul(jy, jnp.asarray(w))), **TOL)
    np.testing.assert_allclose(y.numpy(), h @ w, **TOL)
    out = hyb.dense_to_hybrid_matmul(torch.from_numpy(x),
                                     torch.from_numpy(w2.T.copy()), hy)
    jout = jhyb.dense_to_hybrid_matmul(jnp.asarray(x), jnp.asarray(w2), jy)
    np.testing.assert_allclose(out.ell_values.numpy(),
                               np.asarray(jout.ell_values), **TOL)
    np.testing.assert_allclose(out.dense_rows.numpy(),
                               np.asarray(jout.dense_rows), **TOL)
    got, mask = hyb.unpack(out).numpy(), h != 0
    np.testing.assert_allclose(got[mask], (x @ w2)[mask], **TOL)
    assert (got[~mask] == 0).all()


@pytest.mark.parametrize("m,n,k,ew", [(64, 256, 128, 16), (128, 512, 64, 32)])
def test_k8_k9_plain_match_pallas(m, n, k, ew):
    """The sweep of tests/test_kernels.py:90-114: the plain versions of K8
    and K9 against hybrid_to_dense_pallas / dense_to_hybrid_pallas in
    interpret mode (ELL side only), and against kernels/ref.py."""
    rng = np.random.RandomState(m + n)
    h = np.maximum(rng.randn(m, n) - 1.8, 0).astype(np.float32)
    h[::16] = np.abs(rng.randn(m // 16, n)) + 0.1       # backup rows
    w = (rng.randn(n, k) * 0.1).astype(np.float32)
    x = rng.randn(m, k).astype(np.float32)
    w2 = (rng.randn(k, n) * 0.1).astype(np.float32)
    jy = jhyb.pack(jnp.asarray(h), ew, num_dense_rows=max(1, m // 8))
    idx, nnz = torch.from_numpy(np.array(jy.ell_indices)), \
        torch.from_numpy(np.array(jy.row_nnz))
    sparse = torch.from_numpy(~np.array(jy.is_dense))
    assert sparse.any() and not sparse.all()            # both sides used
    y = hybrid_to_dense_plain(torch.from_numpy(np.array(jy.ell_values)),
                              idx, nnz, sparse, torch.from_numpy(w))
    jk8 = hybrid_to_dense_pallas(jy.ell_values, jy.ell_indices, jy.row_nnz,
                                 ~jy.is_dense, jnp.asarray(w), tile=128,
                                 bm=64)
    np.testing.assert_allclose(y.numpy(), np.asarray(jk8), **TOL)
    ell_only = jy._replace(dense_rows=jnp.zeros_like(jy.dense_rows))
    np.testing.assert_allclose(y.numpy(), np.asarray(
        jref.hybrid_to_dense(ell_only, jnp.asarray(w))), **TOL)
    v = dense_to_hybrid_plain(torch.from_numpy(x),
                              torch.from_numpy(w2.T.copy()), idx, nnz,
                              sparse)
    jk9 = dense_to_hybrid_pallas(jnp.asarray(x), jnp.asarray(w2),
                                 jy.ell_indices, jy.row_nnz, ~jy.is_dense,
                                 tile=128, bm=64)
    np.testing.assert_allclose(v.numpy(), np.asarray(jk9), **TOL)
    np.testing.assert_allclose(v.numpy(), np.asarray(
        jref.dense_to_hybrid(jnp.asarray(x), jnp.asarray(w2),
                             jy).ell_values), **TOL)


M, K, N = 32, 48, 128


def _ffn_setup(gated, act, seed=0, ell_width=24):
    """Weights with 3/4 of the pattern-bearing columns dead, so the rows
    fit the ELL width and a few overflow into the backup (as
    tests/test_sparse_ffn.py sets up JAX)."""
    rng = np.random.RandomState(seed)
    p = {"wu": rng.randn(K, N) * 0.02, "wd": rng.randn(N, K) * 0.02}
    if gated:
        p["wg"] = rng.randn(K, N) * 0.02
    alive = rng.rand(N) < 0.25
    p["wg" if gated else "wu"] *= alive[None, :]
    p = {k: (v * 8).astype(np.float32) for k, v in p.items()}
    x = rng.randn(M, K).astype(np.float32)
    gy = rng.randn(M, K).astype(np.float32)
    scfg = dict(enabled=True, l1_coeff=1e-3, activation=act, twell_tile=32,
                twell_c=4, ell_width=ell_width, dense_backup_frac=0.5,
                ffn_impl="hybrid")
    return p, x, gy, scfg


@pytest.mark.parametrize("gated,act,ell_width", [
    (True, "relu", 24), (False, "relu", 18), (False, "relu2", 18)])
def test_hybrid_function_matches_jax_custom_vjp(gated, act, ell_width):
    """y, l1, the packed statistics and the gradients of x and every weight
    (cotangents gy for y and 0.7 for l1: the L1 injection runs) against
    JAX's _hybrid_gated / _hybrid_nongated."""
    p, x, gy, scfg = _ffn_setup(gated, act, ell_width=ell_width)
    md = max(1, int(M * scfg["dense_backup_frac"]))
    names = ("wg", "wu", "wd") if gated else ("wu", "wd")
    jfn = jffn._hybrid_gated if gated else jffn._hybrid_nongated

    def jax_f(xx, *ws):
        return jfn(xx, *ws, scfg["ell_width"], md, act)
    (jy, jl1, (jnnz, jact)), vjp = jax.vjp(
        jax_f, jnp.asarray(x), *(jnp.asarray(p[k]) for k in names))
    jgrads = vjp((jnp.asarray(gy), jnp.float32(0.7),
                  (jnp.zeros_like(jnnz), jnp.zeros_like(jact))))

    tp = {k: torch.from_numpy(v).requires_grad_(True) for k, v in p.items()}
    tx = torch.from_numpy(x).requires_grad_(True)
    fn = sparse_ffn._HybridGated if gated else sparse_ffn._HybridNongated
    y, l1, nnz, active = fn.apply(tx, *(tp[k] for k in names),
                                  scfg["ell_width"], md, act)
    grads = torch.autograd.grad([y, l1], [tx] + [tp[k] for k in names],
                                [torch.from_numpy(gy), torch.tensor(0.7)])
    # the rows spread over both sides of the format
    assert 0 < int((nnz > scfg["ell_width"]).sum()) <= md
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(l1.item(), float(jl1), rtol=1e-5)
    np.testing.assert_array_equal(nnz.numpy(), np.asarray(jnnz))
    np.testing.assert_array_equal(active.numpy(), np.asarray(jact))
    for name, g, jg in zip(("x",) + names, grads, jgrads):
        np.testing.assert_allclose(g.numpy(), np.asarray(jg), **TOL,
                                   err_msg=f"grad {name}")


@pytest.mark.parametrize("gated", [True, False])
def test_hybrid_apply_aux_matches_jax(gated):
    p, x, _, scfg = _ffn_setup(gated, "relu", seed=1)
    jy, jaux = jffn.apply({k: jnp.asarray(v) for k, v in p.items()},
                          jnp.asarray(x), JSparsityConfig(**scfg), gated)
    y, aux = sparse_ffn.apply({k: torch.from_numpy(v) for k, v in p.items()},
                              torch.from_numpy(x), SparsityConfig(**scfg),
                              gated, collect_aux=True)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
    assert set(aux) == set(jaux)
    for k in aux:
        np.testing.assert_allclose(np.asarray(aux[k]),
                                   np.asarray(jaux[k]), rtol=1e-5,
                                   err_msg=k)


def test_hybrid_saves_packed_tensors_only():
    """The Table 1 contract: the backward keeps the inputs and the packed
    activations, never a dense (M, N) activation. The largest saved tensor
    is a weight (K x N)."""
    p, x, _, scfg = _ffn_setup(True, "relu")
    shapes = []

    def pack_hook(t):
        shapes.append(tuple(t.shape))
        return t
    tp = {k: torch.from_numpy(v).requires_grad_(True) for k, v in p.items()}
    with torch.autograd.graph.saved_tensors_hooks(pack_hook, lambda t: t):
        y, l1, _, _ = sparse_ffn._HybridGated.apply(
            torch.from_numpy(x).requires_grad_(True), tp["wg"], tp["wu"],
            tp["wd"], scfg["ell_width"], 16, "relu")
    assert shapes and max(np.prod(s) for s in shapes) <= K * N, shapes
    assert (M, N) not in shapes, shapes
    assert (M, 16) not in shapes and (16, N) in shapes, shapes


def test_silu_has_no_pattern_only_backward():
    p, x, _, scfg = _ffn_setup(True, "relu")
    scfg = SparsityConfig(**dict(scfg, activation="silu"))
    tp = {k: torch.from_numpy(v).requires_grad_(True) for k, v in p.items()}
    y, _ = sparse_ffn.apply(tp, torch.from_numpy(x), scfg, True,
                            collect_aux=True)
    with pytest.raises(ValueError, match="pattern-only"):
        y.sum().backward()
