"""TwELL format and the plain versions of kernels K1/K2/K6 in the PyTorch
port, held against the JAX package on the same numpy inputs.

Tolerances: float32 2e-4 and bfloat16 2e-2 (rtol and atol), as
tests/test_kernels.py; indices, counts and the overflow flag exactly.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import twell as jtwell
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.sparse_ffn import (twell_down_proj_pallas,
                                      twell_fused_ffn_pallas)
from repro.kernels.twell_pack import twell_gate_matmul_pallas
from repro_torch.core import twell
from repro_torch.kernels import ops
from repro_torch.kernels.sparse_ffn import (twell_down_proj_plain,
                                            twell_fused_ffn_plain)
from repro_torch.kernels.twell_pack import twell_gate_matmul_plain

# (M, K, N, tile, C), as tests/test_kernels.py SHAPES
SHAPES = [(64, 128, 256, 128, 4), (128, 256, 512, 256, 8),
          (64, 64, 1024, 256, 8), (256, 128, 256, 128, 8)]
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _tol(name):
    return dict(rtol=2e-2, atol=2e-2) if name == "bfloat16" else \
        dict(rtol=2e-4, atol=2e-4)


def _inputs(m, k, n, seed=0, keep=0.3):
    """x, W_g (only a `keep` fraction of gate columns alive), W_u, W_d."""
    rng = np.random.RandomState(seed)
    x = (rng.randn(m, k) * 0.5).astype(np.float32)
    col = rng.rand(n) < keep
    wg = (rng.randn(k, n) * 0.08 * col[None]).astype(np.float32)
    wu = (rng.randn(k, n) * 0.08).astype(np.float32)
    wd = (rng.randn(n, k) * 0.08).astype(np.float32)
    return x, wg, wu, wd


def _both(a, name):
    jd, td = DTYPES[name]
    return jnp.asarray(a, jd), torch.from_numpy(a).to(td)


def _f32(a):
    return np.asarray(a.float() if isinstance(a, torch.Tensor) else
                      jnp.asarray(a, jnp.float32))


def _torch_tw(jtw):
    """repro.core.twell.TwellActs -> the port's TwellActs (same arrays)."""
    vals = np.array(jtw.values, np.float32)
    dt = torch.bfloat16 if jtw.values.dtype == jnp.bfloat16 else torch.float32
    return twell.TwellActs(
        torch.from_numpy(vals).to(dt),
        torch.from_numpy(np.array(jtw.indices)),
        torch.from_numpy(np.array(jtw.nnz)),
        torch.tensor(bool(jtw.overflow)), jtw.tile, jtw.compression, jtw.n)


@pytest.mark.parametrize("m,n,tile,c,shift", [
    (16, 256, 128, 4, 1.0),          # sparse, no overflow
    (8, 512, 256, 8, 1.6),           # very sparse
    (16, 256, 128, 8, -0.5),         # dense: tiles overflow T/C
    (4, 64, 64, 1, 0.0),             # C = 1: every column has a slot
])
def test_pack_unpack_match_jax(m, n, tile, c, shift):
    rng = np.random.RandomState(7)
    h = np.maximum(rng.randn(m, n) - shift, 0).astype(np.float32)
    jtw = jtwell.pack(jnp.asarray(h), tile, c)
    tw = twell.pack(torch.from_numpy(h), tile, c)
    np.testing.assert_array_equal(tw.indices.numpy(), np.asarray(jtw.indices))
    np.testing.assert_array_equal(tw.nnz.numpy(), np.asarray(jtw.nnz))
    assert bool(tw.overflow) == bool(jtw.overflow)
    np.testing.assert_array_equal(tw.values.numpy(), np.asarray(jtw.values))
    np.testing.assert_array_equal(twell.unpack(tw).numpy(),
                                  np.asarray(jtwell.unpack(jtw)))
    np.testing.assert_array_equal(twell.nnz_per_row(tw).numpy(),
                                  np.asarray(jtwell.nnz_per_row(jtw)))
    if shift < 0:
        assert bool(tw.overflow), "geometry meant to overflow did not"


def test_fused_ffn_reference_matches_jax():
    x, wg, wu, wd = _inputs(32, 64, 256, seed=3, keep=0.2)
    h = np.maximum(x @ wg, 0)
    jtw = jtwell.pack(jnp.asarray(h), 128, 4)
    tw = twell.pack(torch.from_numpy(h), 128, 4)
    want = jtwell.fused_ffn_reference(jnp.asarray(x), jtw, jnp.asarray(wu),
                                      jnp.asarray(wd))
    got = twell.fused_ffn_reference(torch.from_numpy(x), tw,
                                    torch.from_numpy(wu), torch.from_numpy(wd))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **_tol("f32"))


@pytest.mark.parametrize("m,k,n,tile,c", SHAPES)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_plain_gate_matmul_matches_pallas(m, k, n, tile, c, dtype):
    x, wg, _, _ = _inputs(m, k, n)
    jx, tx = _both(x, dtype)
    jw, tw_ = _both(wg, dtype)
    jv, ji, jn = twell_gate_matmul_pallas(jx, jw, tile, c, "relu", bm=64,
                                          bk=64, interpret=True)
    v, i, nz = twell_gate_matmul_plain(tx, tw_, tile, c, "relu")
    np.testing.assert_array_equal(nz.numpy(), np.asarray(jn))   # exact counts
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    np.testing.assert_allclose(_f32(v), _f32(jv), **_tol(dtype))


@pytest.mark.parametrize("m,k,n,tile,c", SHAPES)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_plain_fused_ffn_matches_pallas(m, k, n, tile, c, dtype):
    x, wg, wu, wd = _inputs(m, k, n, keep=0.08)
    jx, tx = _both(x, dtype)
    jwg, _ = _both(wg, dtype)
    jwu, twu = _both(wu, dtype)
    jwd, twd = _both(wd, dtype)
    jtw = jref.twell_gate_matmul(jx, jwg, tile, c, "relu")
    assert not bool(jtw.overflow)
    want = twell_fused_ffn_pallas(jtw.values, jtw.indices, jtw.nnz, jx, jwu,
                                  jwd, tile, bm=64, interpret=True)
    got = twell_fused_ffn_plain(tx, _torch_tw(jtw), twu.t().contiguous(), twd)
    np.testing.assert_allclose(_f32(got), _f32(want), **_tol(dtype))


@pytest.mark.parametrize("keep", [0.1, 1.0])
def test_ops_gate_matmul_clip_and_overflow_match_jax(keep):
    """ops clips the kernel's exact counts to T/C and raises the flag, as
    repro/kernels/ops.py does; keep=1.0 overflows."""
    x, wg, _, _ = _inputs(32, 64, 512, seed=5, keep=keep)
    jtw = jops.twell_gate_matmul(jnp.asarray(x), jnp.asarray(wg), 256, 8)
    ops.OverflowLog.reset()
    tw = ops.twell_gate_matmul(torch.from_numpy(x), torch.from_numpy(wg),
                               256, 8)
    np.testing.assert_array_equal(tw.nnz.numpy(), np.asarray(jtw.nnz))
    np.testing.assert_array_equal(tw.indices.numpy(), np.asarray(jtw.indices))
    np.testing.assert_allclose(tw.values.numpy(), np.asarray(jtw.values),
                               **_tol("f32"))
    assert bool(tw.overflow) == bool(jtw.overflow) == (keep == 1.0)
    assert ops.OverflowLog.seen() == (keep == 1.0)
    ops.OverflowLog.reset()
    assert not ops.OverflowLog.seen()


def test_ops_fused_ffn_matches_jax_ops():
    x, wg, wu, wd = _inputs(16, 128, 512, seed=9, keep=0.08)
    jtw = jops.twell_gate_matmul(jnp.asarray(x), jnp.asarray(wg), 256, 8)
    want = jops.twell_fused_ffn(jnp.asarray(x), jtw, jnp.asarray(wu),
                                jnp.asarray(wd))
    tw = ops.twell_gate_matmul(torch.from_numpy(x), torch.from_numpy(wg),
                               256, 8)
    got = ops.twell_fused_ffn(torch.from_numpy(x), tw,
                              torch.from_numpy(wu).t().contiguous(),
                              torch.from_numpy(wd))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **_tol("f32"))


def _down_inputs(m, k, n, tile, dtype, keep):
    """The non-gated pattern: h = relu(x @ W_u) packed by the JAX oracle
    (K1's contract, nnz clipped to T/C), with the first tile dead for every
    row and row 1 empty; W_d in ``dtype``."""
    x, _, wu, wd = _inputs(m, k, n, seed=11, keep=1.0)
    col = np.random.RandomState(12).rand(n) < keep
    wu = wu * col[None]
    wu[:, :tile] = 0
    x[1] = 0
    jx, _ = _both(x, dtype)
    jwu, _ = _both(wu, dtype)
    jwd, twd = _both(wd, dtype)
    return jx, jwu, jwd, twd


@pytest.mark.parametrize("keep", [0.15, 1.0])
@pytest.mark.parametrize("m,k,n,tile,c", SHAPES[:2])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_plain_down_proj_matches_pallas_and_ref(m, k, n, tile, c, dtype,
                                                keep):
    """K6's plain version against twell_down_proj_pallas (interpret mode)
    and ref.twell_down_proj; keep=1.0 overflows T/C and runs on the
    clipped counts, as repro/kernels/ops.py hands them over."""
    jx, jwu, jwd, twd = _down_inputs(m, k, n, tile, dtype, keep)
    jtw = jops.twell_gate_matmul(jx, jwu, tile, c)
    assert bool(jtw.overflow) == (keep == 1.0)
    nnz = np.asarray(jtw.nnz)
    assert (nnz[:, 0] == 0).all() and (nnz[1] == 0).all()
    tw = _torch_tw(jtw)
    got = twell_down_proj_plain(tw.values, tw.indices, tw.nnz, twd, tile)
    assert got.dtype == torch.float32
    want = twell_down_proj_pallas(jtw.values, jtw.indices, jtw.nnz, jwd,
                                  tile, bm=64, interpret=True)
    np.testing.assert_allclose(got.numpy(), _f32(want), **_tol(dtype))
    np.testing.assert_allclose(got.numpy(),
                               _f32(jref.twell_down_proj(jtw, jwd)),
                               **_tol(dtype))
    assert float(got[1].abs().max()) == 0.0


def test_ops_down_proj_matches_jax_ops():
    """ops.twell_down_proj on ops.twell_gate_matmul's packed pattern against
    the JAX package's ops (y in W_d's type)."""
    x, _, wu, wd = _inputs(16, 128, 512, seed=13, keep=1.0)
    wu = wu * (np.random.RandomState(14).rand(512) < 0.1)[None]
    jtw = jops.twell_gate_matmul(jnp.asarray(x), jnp.asarray(wu), 256, 8)
    want = jops.twell_down_proj(jtw, jnp.asarray(wd))
    tw = ops.twell_gate_matmul(torch.from_numpy(x), torch.from_numpy(wu),
                               256, 8)
    got = ops.twell_down_proj(tw, torch.from_numpy(wd))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **_tol("f32"))
