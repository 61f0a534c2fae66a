"""The host-side launch plans of the Hopper attention kernels K7 and K4
(``repro_torch/kernels/attention_plan.py``): plain functions of shapes that
take no tensor, cover every query tile and every live key exactly once,
launch K7's heaviest query tiles first, and size K4's cluster from the
block table alone. Also: both wrappers refuse
unsupported inputs before anything is built. Runs on the CPU.
"""
import pytest
import torch

from repro_torch.kernels import attention_plan as ap
from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import flash_attention_cuda
from repro_torch.kernels.paged_chunk_attention import \
    paged_chunk_attention_cuda

FLASH = [(8, 1024, 32, 64), (1, 4096, 32, 64), (2, 100, 3, 64),
         (1, 257, 2, 32), (2, 777, 12, 128), (1, 1, 1, 16), (3, 1100, 7, 40)]


@pytest.mark.parametrize("sms", [132, 7])
@pytest.mark.parametrize("shape", FLASH, ids=str)
def test_flash_plan_covers_every_tile_once_heaviest_first(shape, sms):
    b, s, h, hd = shape
    plan = ap.flash_plan(b, s, h, hd, sms)
    nq = -(-s // ap.FLASH_ROWS)
    n = b * h * nq
    assert plan.grid == min(sms, n)
    items = [w for i in range(plan.grid) for w in plan.block_items(i)]
    assert sorted(items) == list(range(n))
    assert sorted(plan.item(w) for w in range(n)) == \
        [(x, t) for x in range(b * h) for t in range(nq)]
    for i in range(plan.grid):                       # heaviest first
        work = [len(plan.key_tiles(plan.item(w)[1], s))
                for w in plan.block_items(i)]
        assert work == sorted(work, reverse=True)
    if plan.grid <= b * h:            # every block starts on a heaviest tile
        assert all(plan.item(i)[1] == nq - 1 for i in range(plan.grid))
    for t in range(nq):                              # every visible key once
        tiles = plan.key_tiles(t, s)
        last_row = min(s, (t + 1) * ap.FLASH_ROWS) - 1
        keys = [k for kt in tiles
                for k in range(kt * plan.key_tile, (kt + 1) * plan.key_tile)
                if k <= last_row]
        assert keys == list(range(last_row + 1))


@pytest.mark.parametrize("hd,tiles", [(16, (64, 128)), (40, (64, 128)),
                                      (64, (64, 128)), (72, (128, 64)),
                                      (128, (128, 64))])
def test_flash_plan_tiles_by_head_dim(hd, tiles):
    plan = ap.flash_plan(2, 300, 4, hd, 132)
    assert (plan.hd_pad, plan.key_tile) == tiles


@pytest.mark.parametrize("width,bs,cluster", [(64, 16, 4), (1, 2, 1),
                                              (16, 16, 1), (17, 16, 2),
                                              (160, 16, 8), (300, 8, 8),
                                              (1024, 64, 8)])
def test_chunk_cluster_from_table_width_times_block_size(width, bs, cluster):
    plan = ap.chunk_plan(4, 64, 32, 8, width, bs)
    assert plan.cluster == cluster
    assert plan.grid == (plan.row_tiles * cluster, 8, 4)


@pytest.mark.parametrize("g,s,rows,row_tiles", [(1, 64, 64, 1), (1, 1, 64, 1),
                                                (4, 64, 128, 2),
                                                (8, 64, 128, 4),
                                                (3, 30, 128, 1)])
def test_chunk_rows_per_block(g, s, rows, row_tiles):
    plan = ap.chunk_plan(2, s, 4 * g, 4, 64, 16)
    assert (plan.rows, plan.row_tiles) == (rows, row_tiles)


@pytest.mark.parametrize("kend", [0, 1, 63, 64, 65, 130, 964, 2048, 2464])
@pytest.mark.parametrize("cluster", [1, 2, 4, 8])
def test_chunk_splits_cover_every_live_key_once(kend, cluster):
    splits = ap.chunk_splits(kend, cluster)
    assert len(splits) == cluster
    keys = [k for lo, hi in splits for k in range(lo, hi)]
    assert keys == list(range(kend))
    for lo, hi in splits:                    # whole 64-key tiles
        assert lo % ap.CHUNK_KEY_TILE == 0
        assert hi % ap.CHUNK_KEY_TILE == 0 or hi == kend


def test_plans_take_no_tensor():
    """A tensor (a device value) in place of a shape is refused: a plan
    never reads one, so a launch never waits on the card."""
    with pytest.raises(TypeError):
        ap.chunk_plan(4, 64, 32, 8, torch.tensor(64), 16)
    with pytest.raises(TypeError):
        ap.chunk_splits(torch.tensor(964), 4)
    with pytest.raises(TypeError):
        ap.flash_plan(8, torch.tensor(1024), 32, 64, 132)
    with pytest.raises(ValueError):
        ap.flash_plan(1, 128, 2, 136, 132)


def _no_build(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a kernel was built for an unsupported input")
    monkeypatch.setattr(build, "build_all", refuse)
    monkeypatch.setattr(build, "bind", refuse)


@pytest.mark.parametrize("hd", [64, 136, 20])
def test_wrappers_refuse_before_building(monkeypatch, hd):
    """CPU tensors (and so hd > 128, hd % 8) raise in the wrappers' checks,
    before any kernel is built or bound."""
    _no_build(monkeypatch)
    q = torch.zeros(1, 8, 2, hd, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        flash_attention_cuda(q, q, q)
    pool = torch.zeros(3, 4, 2, hd, dtype=torch.bfloat16)
    ints = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(ValueError):
        paged_chunk_attention_cuda(q, pool, pool,
                                   torch.ones(1, 2, dtype=torch.int32),
                                   ints, ints)
