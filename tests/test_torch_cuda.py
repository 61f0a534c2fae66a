"""The port's CUDA kernels against their plain PyTorch versions on the card,
over shapes beyond the main path's: ragged M, C = 1, narrow tiles, relu^2,
the non-gated down projection past one column slice and on empty rows,
head dims 16..128, GQA groups up to 16, block sizes up to 64, boundary and
padded rows, tile-skip thresholds and dead tiles, causal attention over
ragged sequence lengths and padded head dims, and the hybrid products over
both sides of the format, bf16 and float32. Marked ``cuda``: each
test skips without an NVIDIA card (the fixture decides at run time). On the
machine with the card, from the repo root:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerance: bf16 2e-2 (rtol and atol), as tests/test_kernels.py; TwELL
indices and counts exactly, except on rows where a gate pre-activation
lies within 1e-3 max|pre| of zero and may round either way.
"""
import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda

TOL = dict(rtol=2e-2, atol=2e-2)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _bf16(a, dev):
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(
        dev).bfloat16()


def _gate(m, k, n, keep, seed, dev):
    rng = np.random.RandomState(seed)
    x = rng.randn(m, k) * 0.5
    col = rng.rand(n) < keep
    wg = rng.randn(k, n) * 0.08 * col[None]
    wu = rng.randn(k, n) * 0.08
    wd = rng.randn(n, k) * 0.08
    return [_bf16(a, dev) for a in (x, wg, wu, wd)]


GATE_SHAPES = [  # (M, K, N, T, C, act, keep)
    (1, 64, 256, 64, 1, "relu", 0.3),
    (37, 128, 512, 128, 4, "relu", 0.1),
    (70, 256, 768, 256, 2, "relu2", 0.1),
    (4, 2048, 5632, 256, 8, "relu", 0.02),
    (300, 512, 1024, 256, 8, "relu", 0.05),
    (16, 96, 512, 64, 8, "relu", 1.0),          # overflows T/C
    (5, 200, 256, 64, 4, "relu", 0.2),          # K not a multiple of 64
]


@pytest.mark.parametrize("shape", GATE_SHAPES, ids=str)
def test_gate_matmul_and_fused_ffn_match_plain(card, shape):
    from repro_torch.core import twell
    from repro_torch.kernels.sparse_ffn import (twell_fused_ffn_cuda,
                                                twell_fused_ffn_plain)
    from repro_torch.kernels.twell_pack import (twell_gate_matmul_cuda,
                                                twell_gate_matmul_plain)
    m, k, n, t, c, act, keep = shape
    x, wg, wu, wd = _gate(m, k, n, keep, sum(shape[:5]), card)
    v, i, z = twell_gate_matmul_cuda(x, wg, t, c, act)
    pv, pi, pz = twell_gate_matmul_plain(x, wg, t, c, act)
    pre = x.float() @ wg.float()
    rows = ~((pre != 0) & (pre.abs() < 1e-3 * pre.abs().max())).any(-1)
    assert torch.equal(z[rows], pz[rows])
    assert torch.equal(i[rows], pi[rows])
    torch.testing.assert_close(v[rows].float(), pv[rows].float(), **TOL)
    tc = t // c
    tw = twell.TwellActs(pv, pi, torch.clamp(pz, max=tc), (pz > tc).any(),
                         t, c, n)
    y = twell_fused_ffn_cuda(x, tw, wu.t().contiguous(), wd)
    py = twell_fused_ffn_plain(x, tw, wu.t().contiguous(), wd)
    torch.testing.assert_close(y, py.float(), **TOL)


TILE_SKIP_SHAPES = [  # (M, K, N, T, act, keep, threshold, dead tiles)
    (4, 2048, 5632, 256, "relu", 0.02, 0.0, 11),  # main path, decode
    (4, 2048, 5632, 256, "relu", 0.3, 0.5, 11),
    (256, 2048, 5632, 256, "relu", 0.02, 0.0, 11),
    (1, 64, 256, 64, "relu", 0.3, 0.0, 0),
    (37, 128, 512, 128, "relu2", 0.1, 0.0, 1),
    (70, 256, 768, 256, "relu", 0.5, 0.3, 1),
    (33, 96, 512, 32, "relu2", 0.4, 0.05, 5),
]


@pytest.mark.parametrize("shape", TILE_SKIP_SHAPES, ids=str)
def test_tile_skip_ffn_matches_plain(card, shape):
    """K5: y and h within bf16 tolerance, a (32-row block, tile) cell
    flagged active exactly where some kept row has a live gate, and the
    W_g columns of `dead` tiles zeroed so the skip branch runs."""
    from repro_torch.kernels.sparse_ffn import (tile_skip_ffn_cuda,
                                                tile_skip_ffn_plain)
    m, k, n, t, act, keep, thr, dead = shape
    x, wg, wu, wd = _gate(m, k, n, keep, m + k + n + t, card)
    nt = n // t
    dead_tiles = np.random.RandomState(m).permutation(nt)[:dead]
    for j in dead_tiles:
        wg[:, j * t:(j + 1) * t] = 0
    rb = -(-m // 32)
    flags = torch.full((rb, nt), -1, dtype=torch.int32, device=card)
    y, h = tile_skip_ffn_cuda(x, wg, wu, wd, t, act, thr, cell_active=flags)
    py, ph = tile_skip_ffn_plain(x, wg, wu, wd, t, act, thr)
    g = torch.relu(x.float() @ wg.float())
    g = g * g if act == "relu2" else g
    gmax = g.reshape(m, nt, t).amax(-1)                       # (M, nT)
    # a row whose tile maximum lies within 1% of the threshold (or, at
    # threshold 0, within 1e-3 max of zero) may be kept or dropped
    near = (gmax - thr).abs() <= 1e-2 * thr if thr else \
        (gmax > 0) & (gmax <= 1e-3 * gmax.max())
    rows = ~near.any(-1)
    torch.testing.assert_close(y[rows], py[rows], **TOL)
    torch.testing.assert_close(h[rows].float(), ph[rows].float(), **TOL)
    keep_rt = gmax > thr
    pad = rb * 32 - m
    want = torch.nn.functional.pad(keep_rt, (0, 0, 0, pad)).reshape(
        rb, 32, nt).any(1)
    ok = torch.nn.functional.pad(rows, (0, pad), value=True).reshape(
        rb, 32).all(1)
    assert torch.equal(flags[ok].bool(), want[ok])
    assert int(flags.min()) >= 0
    assert not flags[:, torch.from_numpy(dead_tiles).to(card)].any()
    if dead:
        assert float(h.float().reshape(m, nt, t)[:, dead_tiles].abs().max()) \
            == 0.0


DOWN_SHAPES = [  # (M, K, N, T, C, keep)
    (4, 2048, 8192, 256, 8, 0.02),               # olmo-1b decode
    (256, 2048, 8192, 256, 8, 0.02),             # olmo-1b 4 x 64-token chunk
    (2, 64, 256, 64, 1, 0.3),                    # K under one 256-column slice
    (37, 520, 512, 128, 4, 0.1),                 # K past one slice, ragged
    (9, 256, 1024, 256, 1, 1.0),                 # C = 1: every column a slot
    (16, 96, 512, 64, 8, 1.0),                   # overflowing pack, clipped
]


@pytest.mark.parametrize("shape", DOWN_SHAPES, ids=str)
def test_down_proj_matches_plain(card, shape):
    """K6 on the packed pattern of relu(x @ W_u) (counts clipped to T/C, as
    ops hands them over), with the first tile dead and row 0 empty: y within
    bf16 tolerance of the plain version, the empty row exactly 0, and the
    same bits from run to run."""
    from repro_torch.kernels.sparse_ffn import (twell_down_proj_cuda,
                                                twell_down_proj_plain)
    from repro_torch.kernels.twell_pack import twell_gate_matmul_plain
    m, k, n, t, c, keep = shape
    x, wu, _, wd = _gate(m, k, n, keep, sum(shape[:5]), card)
    wu[:, :t] = 0
    x[0] = 0
    v, i, z = twell_gate_matmul_plain(x, wu, t, c, "relu")
    z = torch.clamp(z, max=t // c)
    y = twell_down_proj_cuda(v, i, z, wd, t)
    py = twell_down_proj_plain(v, i, z, wd, t)
    assert y.dtype == torch.float32 and y.shape == (m, k)
    torch.testing.assert_close(y, py, **TOL)
    assert float(y[0].abs().max()) == 0.0
    assert torch.equal(y, twell_down_proj_cuda(v, i, z, wd, t))


def _paged(rng, b, hkv, hd, bs, width, dev):
    n = 1 + b * width
    kp = _bf16(rng.randn(n, bs, hkv, hd), dev)
    vp = _bf16(rng.randn(n, bs, hkv, hd), dev)
    bt = rng.permutation(np.arange(1, n))[:b * width].reshape(b, width)
    return kp, vp, torch.from_numpy(bt.astype(np.int32)).to(dev)


ATTN_SHAPES = [  # (B, Hkv, G, hd, bs, width)
    (3, 2, 2, 16, 4, 6),
    (2, 4, 1, 32, 16, 9),
    (4, 1, 16, 64, 16, 5),
    (2, 2, 4, 128, 8, 7),
    (2, 2, 1, 64, 64, 3),
    (5, 3, 3, 48, 2, 11),
]


@pytest.mark.parametrize("shape", ATTN_SHAPES, ids=str)
def test_paged_decode_matches_plain(card, shape):
    from repro_torch.kernels.paged_decode_attention import (
        paged_decode_attention_cuda, paged_decode_attention_plain)
    b, hkv, g, hd, bs, width = shape
    rng = np.random.RandomState(sum(shape))
    kp, vp, bt = _paged(rng, b, hkv, hd, bs, width, card)
    sl = rng.randint(0, width * bs, size=b)
    sl[0], sl[-1] = 0, width * bs - 1                 # both ends of a table
    if b > 2:
        sl[1] = bs                                     # a page boundary
        bt[2] = 0                                      # a padded row
        sl[2] = 0
    sl = torch.from_numpy(sl.astype(np.int32)).to(card)
    q = _bf16(rng.randn(b, 1, hkv * g, hd), card)
    o = paged_decode_attention_cuda(q, kp, vp, bt, sl)
    po = paged_decode_attention_plain(q, kp, vp, bt, sl)
    assert torch.isfinite(o.float()).all()
    torch.testing.assert_close(o.float(), po.float(), **TOL)


@pytest.mark.parametrize("s", [1, 5, 16, 64])
@pytest.mark.parametrize("shape", ATTN_SHAPES, ids=str)
def test_paged_chunk_matches_plain(card, shape, s):
    from repro_torch.kernels.paged_chunk_attention import (
        paged_chunk_attention_cuda, paged_chunk_attention_plain)
    b, hkv, g, hd, bs, width = shape
    width = max(width, -(-(s + 1) // bs) + 1)
    rng = np.random.RandomState(sum(shape) + s)
    kp, vp, bt = _paged(rng, b, hkv, hd, bs, width, card)
    sl = rng.randint(0, width * bs - s, size=b).astype(np.int32)
    nn = rng.randint(1, s + 1, size=b).astype(np.int32)
    sl[0] = 0                                          # fresh prefill
    if b > 2:
        nn[2], sl[2] = 0, 0                            # a padded row
        bt[2] = 0
    sl_t = torch.from_numpy(sl).to(card)
    nn_t = torch.from_numpy(nn).to(card)
    q = _bf16(rng.randn(b, s, hkv * g, hd), card)
    o = paged_chunk_attention_cuda(q, kp, vp, bt, sl_t, nn_t)
    po = paged_chunk_attention_plain(q, kp, vp, bt, sl_t, nn_t)
    assert torch.isfinite(o.float()).all()
    valid = torch.from_numpy(np.arange(s)[None, :] < nn[:, None]).to(card)
    torch.testing.assert_close(o.float()[valid], po.float()[valid], **TOL)
    if b > 2:
        assert float(o[2].float().abs().max()) == 0.0


FLASH_SHAPES = [  # (B, S, H, hd)
    (1, 1, 1, 64),
    (2, 100, 3, 64),          # S not a multiple of the 64-row tile
    (1, 257, 2, 32),
    (2, 64, 4, 128),
    (1, 130, 2, 16),          # head dim padded to 32
    (1, 200, 2, 40),          # head dim padded to 64
    (2, 1024, 4, 64),
]


def _qkv(shape, dtype, dev, seed):
    rng = np.random.RandomState(seed)
    return [torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(
        dev).to(dtype) for _ in range(3)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=str)
@pytest.mark.parametrize("shape", FLASH_SHAPES, ids=str)
def test_flash_attention_matches_plain(card, shape, dtype):
    """K7: causal attention within bf16 tolerance of the plain version (the
    float32 kernel within 2e-4: both sum an f32 softmax, in other orders),
    the same bits from run to run, and row 0 equal to v's row 0."""
    from repro_torch.kernels.flash_attention import (flash_attention_cuda,
                                                     flash_attention_plain)
    q, k, v = _qkv(shape, dtype, card, sum(shape))
    o = flash_attention_cuda(q, k, v)
    po = flash_attention_plain(q, k, v)
    assert o.dtype == dtype and torch.isfinite(o.float()).all()
    tol = TOL if dtype == torch.bfloat16 else dict(rtol=2e-4, atol=2e-4)
    torch.testing.assert_close(o.float(), po.float(), **tol)
    torch.testing.assert_close(o[:, 0].float(), v[:, 0].float(), **tol)
    assert torch.equal(o, flash_attention_cuda(q, k, v))


def _hybrid_case(m, n, k, e, dense_rows, dtype, dev, seed):
    """A hybrid pattern with rows on both sides of the format: ~e/2
    non-zeros a row, and ``dense_rows`` rows with more than e."""
    from repro_torch.core import hybrid as hyb
    rng = np.random.RandomState(seed)
    h = np.where(rng.rand(m, n) < 0.5 * e / n, rng.randn(m, n), 0.0)
    h[rng.permutation(m)[:dense_rows]] = rng.randn(dense_rows, n)
    hy = hyb.pack(torch.from_numpy(h.astype(np.float32)).to(dev).to(dtype),
                  e, max(1, dense_rows))
    x = torch.from_numpy(rng.randn(m, k).astype(np.float32)).to(dev)
    w = torch.from_numpy((rng.randn(n, k) * 0.1).astype(np.float32)).to(dev)
    return hy, x.to(dtype), w.to(dtype)


HYBRID_SHAPES = [  # (M, N, K, E, dense rows)
    (1, 64, 8, 4, 0),
    (37, 256, 64, 16, 3),
    (300, 512, 136, 32, 10),
    (5, 128, 2056, 8, 1),         # K past one 1024-column slice
    (8, 2048, 64, 1024, 1),       # the widest ELL row the kernels take
    (512, 5632, 2048, 128, 8),    # paper-0.5b's FFN
]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=str)
@pytest.mark.parametrize("shape", HYBRID_SHAPES, ids=str)
def test_hybrid_matmuls_match_plain(card, shape, dtype):
    """K8 (ELL side of h @ W, with float32 slot values too, as the backward
    passes them) and K9 (the SDDMM on the pattern, both orientations of
    the products' W) against their plain versions: float32 outputs, equal
    to 1e-4 relative (f32 sums in other orders), the same bits from run to
    run, 0 on backup rows and invalid slots."""
    from repro_torch.kernels.hybrid_matmul import (dense_to_hybrid_cuda,
                                                   dense_to_hybrid_plain,
                                                   hybrid_to_dense_cuda,
                                                   hybrid_to_dense_plain)
    m, n, k, e, dense = shape
    hy, x, w = _hybrid_case(m, n, k, e, dense, dtype, card, sum(shape))
    live = ~hy.is_dense
    assert int(hy.is_dense.sum()) == dense and not bool(hy.overflow)
    tol = dict(rtol=1e-4, atol=1e-4)
    for vals in (hy.ell_values, hy.ell_values.float()):
        y = hybrid_to_dense_cuda(vals, hy.ell_indices, hy.row_nnz, live, w)
        py = hybrid_to_dense_plain(vals, hy.ell_indices, hy.row_nnz, live, w)
        assert y.dtype == torch.float32 and y.shape == (m, k)
        torch.testing.assert_close(y, py, **tol)
        assert not y[hy.is_dense].any()
        assert torch.equal(y, hybrid_to_dense_cuda(
            vals, hy.ell_indices, hy.row_nnz, live, w))
    vals = dense_to_hybrid_cuda(x, w, hy.ell_indices, hy.row_nnz, live)
    pv = dense_to_hybrid_plain(x, w, hy.ell_indices, hy.row_nnz, live)
    assert vals.dtype == torch.float32 and vals.shape == (m, e)
    torch.testing.assert_close(vals, pv, **tol)
    slot = torch.arange(e, device=card)
    valid = (slot[None] < hy.row_nnz[:, None]) & live[:, None]
    assert not vals[~valid].any()
    assert torch.equal(vals, dense_to_hybrid_cuda(x, w, hy.ell_indices,
                                                  hy.row_nnz, live))


def test_ops_dispatch_counts_launches(card):
    from repro_torch.core import hybrid as hyb
    from repro_torch.kernels import ops
    x, wg, wu, wd = _gate(4, 64, 256, 0.3, 0, card)
    ops.reset_launch_counts()
    tw = ops.twell_gate_matmul(x, wg, 64, 2)
    y = ops.twell_fused_ffn(x, tw, wu.t().contiguous(), wd)
    assert y.dtype == x.dtype and y.is_cuda
    yt, ht = ops.tile_skip_ffn(x, wg, wu, wd, 64, "relu", 0.1)
    assert yt.dtype == x.dtype and ht.shape == (4, 256)
    q = x.reshape(1, 4, 2, 32).contiguous()
    o = ops.flash_attention(q, q, q)
    assert o.dtype == q.dtype and o.shape == q.shape
    yd = ops.twell_down_proj(ops.twell_gate_matmul(x, wu, 64, 1), wd)
    assert yd.dtype == wd.dtype and yd.shape == (4, 64)
    hy = hyb.pack(torch.relu(x @ wg), 16, 1)
    live = ~hy.is_dense
    yh = ops.hybrid_to_dense(hy.ell_values, hy.ell_indices, hy.row_nnz, live,
                             wd)
    vh = ops.dense_to_hybrid(x, wu.t().contiguous(), hy.ell_indices,
                             hy.row_nnz, live)
    assert yh.shape == (4, 64) and vh.shape == (4, 16)
    counts = ops.launch_counts()
    assert counts["twell_gate_matmul"] == 2 and counts["twell_fused_ffn"] == 1
    assert counts["twell_down_proj"] == 1
    assert counts["tile_skip_ffn"] == 1 and counts["flash_attention"] == 1
    assert counts["hybrid_to_dense"] == 1 and counts["dense_to_hybrid"] == 1
    assert counts["paged_decode_attention"] == 0
