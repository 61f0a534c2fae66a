"""Kernel K5 (tile-skip gated FFN) in the PyTorch port: its plain version
against the JAX package's Pallas kernel (interpret mode) and reference, and
the ``tile_skip`` FFN implementation against the JAX ``sparse_ffn.apply``,
aux statistics included. Same numpy inputs on both sides.

Tolerances: float32 2e-4 and bfloat16 2e-2 (rtol and atol), as
tests/test_kernels.py; the frameworks sum in different orders.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core import sparse_ffn as jffn
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.sparse_ffn import tile_skip_ffn_pallas
from repro_torch.configs import get_config
from repro_torch.core import sparse_ffn
from repro_torch.kernels import ops
from repro_torch.kernels.sparse_ffn import tile_skip_ffn_plain
from test_torch_twell import SHAPES, _both, _f32, _inputs, _tol


@pytest.mark.parametrize("m,k,n,tile,c", SHAPES[:2])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_plain_matches_pallas_at_threshold_zero(m, k, n, tile, c, dtype):
    """The sweep of tests/test_kernels.py:80 (keep 0.15: most gate tiles
    dead, so the Pallas kernel skips cells)."""
    ins = _inputs(m, k, n, keep=0.15)
    (jx, tx), (jwg, twg), (jwu, twu), (jwd, twd) = [_both(a, dtype)
                                                    for a in ins]
    jy, jh = tile_skip_ffn_pallas(jx, jwg, jwu, jwd, tile, "relu", bm=64,
                                  interpret=True)
    y, h = tile_skip_ffn_plain(tx, twg, twu, twd, tile, "relu")
    assert y.dtype == torch.float32 and h.dtype == tx.dtype
    np.testing.assert_allclose(_f32(y), _f32(jy), **_tol(dtype))
    np.testing.assert_allclose(_f32(h), _f32(jh), **_tol(dtype))


@pytest.mark.parametrize("act", ["relu", "relu2"])
@pytest.mark.parametrize("threshold", [0.0, 0.3, 0.6])
def test_plain_matches_reference_with_threshold(act, threshold):
    """Per-(row, tile) dropping of repro/kernels/ref.py:tile_skip_ffn; the
    row-tile gate maxima of these inputs spread over 0.3-1.0."""
    x, wg, wu, wd = _inputs(48, 128, 1024, seed=4, keep=0.05)
    jy, jh = jref.tile_skip_ffn(*(jnp.asarray(a) for a in (x, wg, wu, wd)),
                                128, act, threshold)
    y, h = tile_skip_ffn_plain(*(torch.from_numpy(a) for a in
                                 (x, wg, wu, wd)), 128, act, threshold)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **_tol("f32"))
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), **_tol("f32"))
    if threshold:      # the threshold dropped some (row, tile) but not all
        dropped = (h.reshape(48, 8, 128) == 0).all(-1).float().mean()
        assert 0 < dropped < 1


def test_ops_matches_jax_ops_and_refuses_other_activations():
    x, wg, wu, wd = _inputs(16, 64, 512, seed=6, keep=0.3)
    for thr in (0.0, 0.1):
        jy, jh = jops.tile_skip_ffn(*(jnp.asarray(a) for a in
                                      (x, wg, wu, wd)), 256, "relu", thr)
        y, h = ops.tile_skip_ffn(*(torch.from_numpy(a) for a in
                                   (x, wg, wu, wd)), 256, "relu", thr)
        assert y.dtype == torch.float32
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), **_tol("f32"))
        np.testing.assert_allclose(h.numpy(), np.asarray(jh), **_tol("f32"))
    with pytest.raises(ValueError, match="activation"):
        tile_skip_ffn_plain(*(torch.from_numpy(a) for a in (x, wg, wu, wd)),
                            256, "silu")


def _cfgs(threshold):
    out = []
    for base in (jax_get_config("paper-0.5b"), get_config("paper-0.5b")):
        c = base.reduced()
        out.append(dataclasses.replace(c, sparsity=dataclasses.replace(
            c.sparsity, ffn_impl="tile_skip", tile_skip_threshold=threshold)))
    return out


@pytest.mark.parametrize("threshold", [0.0, 0.2])
@pytest.mark.parametrize("gated", [True, False])
def test_apply_and_aux_match_jax(threshold, gated):
    """sparse_ffn.apply(ffn_impl="tile_skip"): y and, with collect_aux, the
    aux dict built from h; a non-gated FFN takes the dense path."""
    jcfg, tcfg = _cfgs(threshold)
    rng = np.random.RandomState(2)
    d, n = 64, jcfg.sparsity.twell_tile * 2
    p = {"wu": (rng.randn(d, n) * 0.3).astype(np.float32),
         "wd": (rng.randn(n, d) * 0.3).astype(np.float32)}
    if gated:
        p["wg"] = (rng.randn(d, n) * 0.3).astype(np.float32)
    x = rng.randn(2, 3, d).astype(np.float32)
    jy, jaux = jffn.apply({k: jnp.asarray(v) for k, v in p.items()},
                          jnp.asarray(x), jcfg.sparsity, gated)
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    ty, taux = sparse_ffn.apply(tp, torch.from_numpy(x), tcfg.sparsity,
                                gated, collect_aux=True)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **_tol("f32"))
    assert set(taux) == set(jaux)
    for k in jaux:
        np.testing.assert_allclose(taux[k].numpy(), np.asarray(jaux[k]),
                                   err_msg=k, **_tol("f32"))
    _, none = sparse_ffn.apply(tp, torch.from_numpy(x), tcfg.sparsity, gated)
    assert none is None
