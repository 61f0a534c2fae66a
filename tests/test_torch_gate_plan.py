"""The host-side launch plan of K1, the TwELL gate matmul + pack kernel
(``repro_torch/kernels/twell_pack.py:gate_plan``): a plain function of
shapes that takes no tensor, covers every 64-deep K stage and every row of a
block exactly once across a cluster's ranks, keeps the cluster within the
portable size 8 and the ring within a block's shared memory, rounds M up to
an instantiated wgmma width, and fills at most one wave of the H100's 132
SMs at the serving shapes, every cluster resident at once by the plan's
model. The cluster split is also replayed on the CPU (f32 partial products
summed in rank order) against the plain version. And the wrapper refuses
CPU tensors and unsupported tiles before anything is built.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import twell
from repro_torch.kernels import build
from repro_torch.kernels import twell_pack as tp

SMS = 132

# (M, K, N, T): the serving shapes (paper-0.5b's W_g, olmo-1b's W_u) and
# the card sweep's
SERVING = [(4, 2048, 5632, 256), (20, 2048, 5632, 256),
           (64, 2048, 5632, 256), (256, 2048, 5632, 256),
           (4, 2048, 8192, 256), (256, 2048, 8192, 256)]
SWEEP = [(1, 64, 256, 64), (37, 128, 512, 128), (70, 256, 768, 256),
         (300, 512, 1024, 256), (16, 96, 512, 64), (5, 200, 256, 64),
         (8, 2048, 5632, 256), (9, 2048, 5632, 256), (65, 2048, 5632, 256),
         (128, 2048, 5632, 256), (129, 2048, 5632, 256)]


@pytest.mark.parametrize("shape", SERVING + SWEEP, ids=str)
def test_k_stages_covered_once(shape):
    m, k, n, t = shape
    plan = tp.gate_plan(m, k, n, t, SMS)
    assert plan.k_stages == -(-k // tp.GATE_BK)
    stages = [s for lo, hi in plan.k_splits() for s in range(lo, hi)]
    assert stages == list(range(plan.k_stages))
    assert len(plan.k_splits()) == plan.ks
    assert plan.k_stages * tp.GATE_BK >= k > (plan.k_stages - 1) * tp.GATE_BK


@pytest.mark.parametrize("shape", SERVING + SWEEP, ids=str)
def test_width_cluster_and_ring(shape):
    m, k, n, t = shape
    plan = tp.gate_plan(m, k, n, t, SMS)
    assert plan.width in tp.GATE_WIDTHS
    assert plan.width >= min(m, tp.GATE_WIDTHS[-1])
    # the narrowest width that holds the block's rows
    narrower = [w for w in tp.GATE_WIDTHS if w < plan.width]
    assert all(w < min(m, tp.GATE_WIDTHS[-1]) for w in narrower)
    assert plan.row_blocks == -(-m // plan.width)
    assert 1 <= plan.ks <= tp.MAX_KS and plan.ks <= plan.k_stages
    assert plan.grid == (n // t * plan.ks, plan.row_blocks)
    assert plan.stages >= tp.MIN_STAGES
    smem = 1024 + plan.stages * (tp.stage_bytes(t, plan.width) + 16)
    assert smem <= tp.SMEM_BYTES
    # the f32 partial tile, aliased over the ring, fits inside it
    assert plan.width * (t + 4) * 4 <= plan.stages * tp.stage_bytes(
        t, plan.width)


def _one_wave(plan, m, k, n, t, ks):
    per_sm = tp.blocks_per_sm(t, plan.width)
    clusters = n // t * plan.row_blocks
    return clusters * ks <= SMS and \
        clusters <= tp.resident_clusters(ks, per_sm, SMS)


@pytest.mark.parametrize("shape", SERVING, ids=str)
def test_serving_shapes_fill_one_wave(shape):
    """At most one block an SM, every cluster resident at once by the
    plan's model, and one more rank a cluster would break either (unless
    the cluster is already at 8 or at the K stages)."""
    m, k, n, t = shape
    plan = tp.gate_plan(m, k, n, t, SMS)
    assert plan.blocks <= SMS
    assert _one_wave(plan, m, k, n, t, plan.ks)
    assert plan.ks in (tp.MAX_KS, plan.k_stages) or \
        not _one_wave(plan, m, k, n, t, plan.ks + 1)


@pytest.mark.parametrize("shape,want", [
    ((4, 2048, 5632, 256), (8, 1, 6, 3, 132)),
    ((20, 2048, 5632, 256), (32, 1, 6, 3, 132)),
    ((64, 2048, 5632, 256), (64, 1, 4, 4, 88)),
    ((4, 2048, 8192, 256), (8, 1, 4, 3, 128)),
    ((256, 2048, 5632, 256), (128, 2, 2, 4, 88)),
    ((256, 2048, 8192, 256), (128, 2, 2, 4, 128)),
], ids=str)
def test_serving_plans(shape, want):
    """(width, row blocks, ks, stages, blocks) at the serving shapes: two
    blocks an SM with a ring of 3 at decode and verify widths."""
    plan = tp.gate_plan(*shape, SMS)
    assert (plan.width, plan.row_blocks, plan.ks, plan.stages,
            plan.blocks) == want


@pytest.mark.parametrize("ks", range(1, 9))
@pytest.mark.parametrize("per_sm", [1, 2])
def test_resident_model_within_the_slots(ks, per_sm):
    """Clusters of 1 or 2 fill every block slot; wider ones count 3/4."""
    held = tp.resident_clusters(ks, per_sm, SMS)
    assert held * ks <= SMS * per_sm
    assert held * ks >= (SMS * per_sm if ks <= 2 else
                         SMS * per_sm * 3 // 4 - ks)


@pytest.mark.parametrize("valid", [1, 4, 5, 8, 20, 37, 128])
@pytest.mark.parametrize("ks", [1, 3, 6, 8])
def test_pack_rows_cover_every_row_once(valid, ks):
    plan = tp.GatePlan(128, 1, ks, 3, 32, (ks, 1))
    rows = [r for lo, hi in plan.pack_rows(valid) for r in range(lo, hi)]
    assert rows == list(range(valid))


def test_plan_takes_no_tensor():
    """A tensor (a device value) in place of a shape is refused: the plan
    never reads one, so a launch never waits on the card."""
    with pytest.raises(TypeError):
        tp.gate_plan(torch.tensor(4), 2048, 5632, 256, SMS)
    with pytest.raises(TypeError):
        tp.gate_plan(4, 2048, 5632, 256, torch.tensor(SMS))
    with pytest.raises(TypeError):
        tp.gate_plan(4, np.int64(2048), 5632, 256, SMS)
    with pytest.raises(TypeError):
        tp.resident_clusters(4, 1, torch.tensor(SMS))
    for bad in [(4, 2048, 5632, 32), (4, 2048, 5632, 512),
                (4, 2048, 5000, 256), (0, 2048, 5632, 256)]:
        with pytest.raises(ValueError):
            tp.gate_plan(*bad, SMS)


@pytest.mark.parametrize("shape", [(5, 200, 256, 64, 4),
                                   (37, 128, 512, 128, 4),
                                   (70, 256, 768, 256, 2),
                                   (16, 96, 512, 64, 8),
                                   (9, 640, 512, 256, 8)], ids=str)
def test_cluster_split_replayed_matches_plain(shape):
    """The kernel's arithmetic on the CPU: each rank's f32 partial product
    over its K stages, summed in rank order, then act and pack, equals the
    plain version's pack (f32 inputs: the two differ only in the order of
    the f32 sum, by a few ulps of the largest sums, |h| up to ~100 here, an
    ulp 7.6e-6: atol 1e-4)."""
    m, k, n, t, c = shape
    rng = np.random.RandomState(m + k)
    x = torch.from_numpy(rng.randn(m, k).astype(np.float32))
    w = torch.from_numpy((rng.randn(k, n) * (rng.rand(n) < 0.3)).astype(
        np.float32))
    plan = tp.gate_plan(m, k, n, t, SMS)
    h = torch.zeros(m, n)
    for lo, hi in plan.k_splits():
        ks = slice(lo * tp.GATE_BK, min(hi * tp.GATE_BK, k))
        h = h + x[:, ks] @ w[ks]
    h = torch.relu(h)
    packed = twell.pack(h, t, c, mask=h > 0)
    v, i, z = tp.twell_gate_matmul_plain(x, w, t, c)
    nnz = (h > 0).reshape(m, n // t, t).sum(-1, dtype=torch.int32)
    assert torch.equal(nnz, z)
    assert torch.equal(packed.indices, i)
    torch.testing.assert_close(packed.values, v, rtol=1e-5, atol=1e-4)


def _no_build(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a kernel was built for an unsupported input")
    monkeypatch.setattr(build, "build_all", refuse)
    monkeypatch.setattr(build, "bind", refuse)


@pytest.mark.parametrize("tile", [256, 32, 512])
def test_wrapper_refuses_before_building(monkeypatch, tile):
    """CPU tensors, and tiles the kernel is not built for, raise in the
    wrapper's checks before any kernel is built or bound."""
    _no_build(monkeypatch)
    x = torch.zeros(4, 64, dtype=torch.bfloat16)
    w = torch.zeros(64, 1024, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        tp.twell_gate_matmul_cuda(x, w, tile, 8)
