"""The host-side launch plan of K5, the tile-skip gated FFN
(``repro_torch/kernels/sparse_ffn.py:tile_skip_plan``): a plain function of
shapes that takes no tensor, covers every 64-deep K stage, every row of a
block and every kept stage of the down projection exactly once across a
cluster's ranks, keeps both clusters within the portable size 8 and both
rings within a block's shared memory, fills at most one wave of the
H100's 132 SMs at the serving shapes with every cluster resident by the
model it shares with K1 (``twell_pack.resident_clusters``), and holds two
up blocks an SM at widths up to 32. Both kernels' schedules are replayed on
the CPU in float32 -- each rank's partial products, the rank-order sums,
the per-row keep decision, the 32-row groups' flags ORed into row blocks and
the down kernel's list of kept stages -- against the plain version. And the
wrapper refuses CPU tensors and tiles it is not built for before anything
is built.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import build
from repro_torch.kernels import sparse_ffn as sf
from repro_torch.kernels import twell_pack as tp

SMS = 132
BK = tp.GATE_BK

# (M, K, N, T): paper-0.5b's FFN at the drafts' M (1, 4) and beyond (the
# tile_skip backend's decode and prefill rows), then the card sweep's
SERVING = [(m, 2048, 5632, 256)
           for m in (1, 4, 8, 9, 20, 33, 64, 128, 129, 256)]
SWEEP = [(1, 64, 256, 64), (37, 128, 512, 128), (70, 256, 768, 256),
         (33, 96, 512, 64), (129, 1024, 2048, 128), (300, 512, 1024, 256)]


def _covered_once(splits, count):
    return [i for lo, hi in splits for i in range(lo, hi)] == \
        list(range(count))


@pytest.mark.parametrize("shape", SERVING + SWEEP, ids=str)
def test_stages_and_rows_covered_once(shape):
    m, k, n, t = shape
    plan = sf.tile_skip_plan(m, k, n, t, SMS)
    assert plan.k_stages == tp.cdiv(k, BK)
    assert len(tp.splits(plan.k_stages, plan.ks)) == plan.ks
    assert _covered_once(tp.splits(plan.k_stages, plan.ks), plan.k_stages)
    for b in range(plan.row_blocks):
        valid = min(plan.width, m - b * plan.width)
        for ks in (plan.ks, plan.ks_down):
            assert _covered_once(tp.splits(valid, ks), valid)
    assert plan.n_stages == n // BK
    for kept in {0, 1, t // BK, plan.n_stages // 2, plan.n_stages}:
        assert len(tp.splits(kept, plan.ks_down)) == plan.ks_down
        assert _covered_once(tp.splits(kept, plan.ks_down), kept)


@pytest.mark.parametrize("shape", SERVING + SWEEP, ids=str)
def test_width_clusters_and_rings(shape):
    m, k, n, t = shape
    plan = sf.tile_skip_plan(m, k, n, t, SMS)
    # the narrowest wgmma width that holds the block's rows
    assert plan.width == next(w for w in tp.GATE_WIDTHS
                              if w >= min(m, tp.GATE_WIDTHS[-1]))
    assert plan.row_blocks == tp.cdiv(m, plan.width)
    assert 1 <= plan.ks <= min(tp.MAX_KS, plan.k_stages)
    assert 1 <= plan.ks_down <= min(tp.MAX_KS, plan.n_stages)
    assert plan.cols in sf.TILE_SKIP_COLS
    assert plan.grid == (n // t * plan.ks, plan.row_blocks)
    assert plan.grid_down == (tp.cdiv(k, plan.cols) * plan.ks_down,
                              plan.row_blocks)
    assert min(plan.stages, plan.stages_down) >= tp.MIN_STAGES
    # a rank keeps ceil(rows / ks) rows of g: one a warp in registers, the
    # rest in shared memory
    warps = (1 if t == 64 else 2) * 4 + 1
    assert plan.g_rows == max(0,
                              tp.cdiv(min(m, plan.width), plan.ks) - warps)
    assert sf.up_smem(t, plan.width, plan.stages, plan.g_rows) <= \
        tp.SMEM_BYTES
    assert sf.down_smem(plan.cols, plan.width, plan.stages_down,
                        n // t) <= tp.SMEM_BYTES


def _resident(plan, n, t, k):
    """Both kernels' clusters all resident at once by the plan's model, in
    one wave of at most one block a slot."""
    up = n // t * plan.row_blocks
    down = tp.cdiv(k, plan.cols) * plan.row_blocks
    return (up * plan.ks <= SMS and down * plan.ks_down <= SMS and
            up <= tp.resident_clusters(plan.ks, plan.per_sm, SMS) and
            down <= tp.resident_clusters(plan.ks_down, plan.per_sm_down, SMS))


@pytest.mark.parametrize("shape", SERVING, ids=str)
def test_serving_shapes_fill_one_wave(shape):
    """Every cluster of both kernels resident at once by the model, and one
    more up rank would break that (unless the cluster is already at 8 or
    at the K stages)."""
    m, k, n, t = shape
    plan = sf.tile_skip_plan(m, k, n, t, SMS)
    assert plan.blocks <= SMS and plan.blocks_down <= SMS
    assert _resident(plan, n, t, k)
    wider = plan.ks + 1
    up = n // t * plan.row_blocks
    assert plan.ks in (tp.MAX_KS, plan.k_stages) or up * wider > SMS or \
        up > tp.resident_clusters(wider, plan.per_sm, SMS)


@pytest.mark.parametrize("shape", [s for s in SERVING + SWEEP
                                   if min(s[0], 128) <= tp.PAIR_WIDTH],
                         ids=str)
def test_two_blocks_an_sm_at_narrow_widths(shape):
    """At n <= 32 the up kernel keeps K1's two blocks an SM: a ring of 3
    and only the rank's g rows past one a warp in shared memory."""
    m, k, n, t = shape
    plan = sf.tile_skip_plan(m, k, n, t, SMS)
    assert plan.width <= tp.PAIR_WIDTH
    assert plan.per_sm == 2 and plan.stages == tp.MIN_STAGES
    smem = sf.up_smem(t, plan.width, plan.stages, plan.g_rows)
    assert 2 * (smem + 1024) <= tp.SM_SMEM_BYTES


@pytest.mark.parametrize("shape,want", [
    ((4, 2048, 5632, 256), (8, 6, 3, 0, 2, 128, 8, 3, 2, 132, 128)),
    ((20, 2048, 5632, 256), (32, 6, 3, 0, 2, 128, 8, 3, 2, 132, 128)),
    ((64, 2048, 5632, 256), (64, 4, 4, 7, 1, 128, 6, 4, 1, 88, 96)),
    ((256, 2048, 5632, 256), (128, 2, 3, 55, 1, 128, 3, 4, 1, 88, 96)),
], ids=str)
def test_serving_plans(shape, want):
    """(width, ks, ring, g rows, blocks an SM; down columns, ks, ring,
    blocks an SM; up and down blocks) at the serving shapes: the drafts'
    M = 4 runs K1's decode plan, and its down kernel 16 column blocks of 8
    ranks."""
    p = sf.tile_skip_plan(*shape, SMS)
    assert (p.width, p.ks, p.stages, p.g_rows, p.per_sm, p.cols, p.ks_down,
            p.stages_down, p.per_sm_down, p.blocks, p.blocks_down) == want


def _inputs(m, k, n, t, dead, seed):
    rng = np.random.RandomState(seed)
    x = rng.randn(m, k).astype(np.float32)
    wg = (rng.randn(k, n) * (rng.rand(n) < 0.3)).astype(np.float32) * 0.1
    wg.reshape(k, n // t, t)[:, rng.permutation(n // t)[:dead]] = 0
    wu = rng.randn(k, n).astype(np.float32) * 0.1
    wd = rng.randn(n, k).astype(np.float32) * 0.1
    return [torch.from_numpy(a) for a in (x, wg, wu, wd)]


def _rank_sum(parts, lo, hi):
    total = torch.zeros_like(parts[0][lo:hi])
    for p in parts:                                 # rank order
        total = total + p[lo:hi]
    return total


def replay(x, wg, wu, wd, t, act, thr, plan):
    """Both kernels' schedules under ``plan``, in float32 on the CPU.
    Returns (y, h, flags)."""
    m, k = x.shape
    n = wg.shape[1]
    nt = n // t
    h = torch.zeros(m, n)
    y = torch.zeros(m, k)
    flags = torch.zeros(tp.cdiv(m, 32), nt, dtype=torch.int32)
    ksl = [slice(lo * BK, min(hi * BK, k))
           for lo, hi in tp.splits(plan.k_stages, plan.ks)]
    for b in range(plan.row_blocks):
        row0 = b * plan.width
        rv = min(plan.width, m - row0)
        xb = x[row0:row0 + rv]
        splits = tp.splits(rv, plan.ks)
        for j in range(nt):        # the up kernel's clusters of this block
            cols = slice(j * t, (j + 1) * t)
            parts = [xb[:, s] @ wg[s, cols] for s in ksl]   # one a rank
            g = torch.zeros(rv, t)
            keep = torch.zeros(rv, dtype=torch.bool)
            for lo, hi in splits:
                a = torch.relu(_rank_sum(parts, lo, hi))
                g[lo:hi] = a * a if act == "relu2" else a
                keep[lo:hi] = g[lo:hi].amax(-1) > thr
            for w in range(tp.cdiv(rv, 32)):                # rank 0
                flags[row0 // 32 + w, j] = int(keep[32 * w:32 * w + 32].any())
            if not keep.any():       # the tile is skipped: h stays zero
                continue
            parts = [xb[:, s] @ wu[s, cols] for s in ksl]
            for lo, hi in splits:
                hu = _rank_sum(parts, lo, hi)
                h[row0 + lo:row0 + hi, cols] = torch.where(
                    keep[lo:hi, None], hu * g[lo:hi], torch.zeros(()))
        # the down kernel: the row block's kept tiles' stages, tile order
        groups = flags[row0 // 32:(row0 + rv - 1) // 32 + 1]
        kept = [j for j in range(nt) if bool(groups[:, j].any())]
        stages = [j * t + p * BK for j in kept for p in range(t // BK)]
        hb = h[row0:row0 + rv]
        for c0 in range(0, k, plan.cols):
            cs = slice(c0, min(c0 + plan.cols, k))
            parts = []
            for lo, hi in tp.splits(len(stages), plan.ks_down):
                acc = torch.zeros(rv, cs.stop - c0)
                for n0 in stages[lo:hi]:
                    acc = acc + hb[:, n0:n0 + BK] @ wd[n0:n0 + BK, cs]
                parts.append(acc)
            for lo, hi in tp.splits(rv, plan.ks_down):
                y[row0 + lo:row0 + hi, cs] = _rank_sum(parts, lo, hi)
    return y, h, flags


@pytest.mark.parametrize("shape", [  # (M, K, N, T, act, threshold, dead)
    (5, 200, 256, 64, "relu", 0.0, 1),
    (4, 640, 1024, 256, "relu", 0.0, 2),
    (4, 640, 1024, 256, "relu", 0.4, 1),
    (9, 640, 512, 256, "relu2", 0.2, 1),
    (37, 128, 512, 128, "relu2", 0.3, 1),
    (70, 256, 768, 256, "relu", 0.5, 1),
    (33, 96, 512, 64, "relu2", 0.05, 5),
    (129, 128, 512, 128, "relu", 0.4, 1),
], ids=str)
def test_schedules_replayed_match_plain(shape):
    """The kernels' arithmetic under the plan on the CPU equals the plain
    version: y and h (f32 inputs: the two differ only in the order of the
    f32 sums, a few ulps of sums up to ~30 here: atol 1e-4), and the flags
    are 1 exactly where some row of the 32-row group keeps the tile (no
    live row-tile maximum of these inputs lies within 1e-3 of the
    threshold); the dead tiles make both branches of the decision run."""
    m, k, n, t, act, thr, dead = shape
    x, wg, wu, wd = _inputs(m, k, n, t, dead, m + k + n)
    plan = sf.tile_skip_plan(m, k, n, t, SMS)
    y, h, flags = replay(x, wg, wu, wd, t, act, thr, plan)
    py, ph = sf.tile_skip_ffn_plain(x, wg, wu, wd, t, act, thr)
    torch.testing.assert_close(h, ph, rtol=1e-5, atol=1e-4)
    torch.testing.assert_close(y, py, rtol=1e-5, atol=1e-4)
    g = torch.relu(x @ wg)
    gmax = (g * g if act == "relu2" else g).reshape(m, n // t, t).amax(-1)
    assert float((gmax[gmax > 0] - thr).abs().min()) > 1e-3
    pad = tp.cdiv(m, 32) * 32 - m
    want = torch.nn.functional.pad(gmax > thr, (0, 0, 0, pad)).reshape(
        -1, 32, n // t).any(1)
    assert torch.equal(flags.bool(), want)
    assert 0 < int(flags.sum()) < flags.numel()     # both branches ran


def test_plan_takes_no_tensor():
    """A tensor (a device value) in place of a shape is refused, and so are
    the tiles the kernel is not built for."""
    with pytest.raises(TypeError):
        sf.tile_skip_plan(torch.tensor(4), 2048, 5632, 256, SMS)
    with pytest.raises(TypeError):
        sf.tile_skip_plan(4, np.int64(2048), 5632, 256, SMS)
    for bad in [(4, 2048, 5632, 32), (4, 2048, 5632, 512),
                (4, 2048, 5000, 256), (0, 2048, 5632, 256)]:
        with pytest.raises(ValueError):
            sf.tile_skip_plan(*bad, SMS)


def _no_build(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a kernel was built for an unsupported input")
    monkeypatch.setattr(build, "build_all", refuse)
    monkeypatch.setattr(build, "bind", refuse)


@pytest.mark.parametrize("tile,match", [(256, "CUDA device"),
                                        (32, "tile"), (512, "tile")])
def test_wrapper_refuses_before_building(monkeypatch, tile, match):
    """CPU tensors, and tiles the kernel is not built for (T 32: the plain
    version still takes any tile on the CPU), raise in the wrapper's
    checks before any kernel is built or bound."""
    _no_build(monkeypatch)
    x = torch.zeros(4, 64, dtype=torch.bfloat16)
    wg = torch.zeros(64, 1024, dtype=torch.bfloat16)
    wd = torch.zeros(1024, 64, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match=match):
        sf.tile_skip_ffn_cuda(x, wg, wg, wd, tile)
