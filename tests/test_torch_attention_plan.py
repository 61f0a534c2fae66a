"""The host-side launch plans of the Hopper attention kernels K7, K4 and K3
(``repro_torch/kernels/attention_plan.py``): plain functions of shapes that
take no tensor, cover every query tile and every live key exactly once,
launch K7's heaviest query tiles first, size K4's cluster from the block
table alone, and size K3's cluster to fill the card with every cluster
resident. An f32 replay of K3's schedule (each rank's online softmax over
its 64-key tiles, then the merge in rank order) is held against the plain
version at 1e-5. Also: the wrappers refuse unsupported inputs before
anything is built. Runs on the CPU.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import attention_plan as ap
from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import flash_attention_cuda
from repro_torch.kernels import twell_pack as tp
from repro_torch.kernels.paged_chunk_attention import \
    paged_chunk_attention_cuda
from repro_torch.kernels.paged_decode_attention import (
    paged_decode_attention_cuda, paged_decode_attention_plain)

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
    with pytest.raises(TypeError):
        ap.decode_plan(4, 32, 32, 64, torch.tensor(34), 16, 132)
    with pytest.raises(TypeError):
        ap.decode_splits(torch.tensor(100), 544, 3)
    with pytest.raises(ValueError):
        ap.decode_plan(4, 34, 2, 64, 34, 16, 132)      # G = 17


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
    with pytest.raises(ValueError):
        paged_decode_attention_cuda(q[:, :1].contiguous(), pool, pool,
                                    torch.ones(1, 2, dtype=torch.int32),
                                    ints)


# K3's plan at the served shapes (paper-0.5b 32/32 heads of 64, GQA 32/8,
# olmo-1b 16/16 of 128; a 34-page table of 16-key pages), a narrow table,
# 16 heads a group and a wide table
DECODE = [(32, 32, 64, 34, 16), (32, 8, 64, 64, 16), (16, 16, 128, 34, 16),
          (16, 16, 128, 128, 16), (6, 2, 16, 6, 4), (32, 2, 64, 1, 64),
          (48, 3, 96, 300, 8), (16, 1, 128, 2048, 16)]


@pytest.mark.parametrize("sms", [132, 16])
@pytest.mark.parametrize("shape", DECODE, ids=str)
def test_decode_plan_fills_the_card_with_resident_clusters(shape, sms):
    """CL is 1..8 and at most the table's 64-key tiles; B x Hkv x CL
    blocks reach the SM count unless CL is already that cap (or one block
    fills an SM's shared memory); every
    cluster is resident at once (K1's model); CL never grows with B."""
    h, hkv, hd, width, bs = shape
    tiles = -(-width * bs // ap.DECODE_KEY_TILE)
    cap = min(ap.MAX_CLUSTER, tiles)
    last = ap.MAX_CLUSTER
    for b in (1, 2, 3, 4, 8, 16, 64):
        plan = ap.decode_plan(b, h, hkv, hd, width, bs, sms)
        assert 1 <= plan.cluster <= cap
        assert plan.cluster <= last
        last = plan.cluster
        assert plan.grid == (plan.cluster, hkv, b)
        assert plan.per_sm >= 1
        if plan.cluster > 1:
            assert b * hkv <= tp.resident_clusters(plan.cluster,
                                                   plan.per_sm, sms)
        # with two or more blocks an SM, a cluster one wider than CL not
        # fitting means the blocks already reach the SMs (with one block
        # an SM, as at a 32K-key table of head dim 128, they may not)
        if plan.cluster < cap and plan.per_sm >= 2:
            assert b * hkv * plan.cluster >= sms
        assert plan.smem == ap.decode_smem(plan.hd_pad, plan.n, width)
        assert (plan.hd_pad, plan.n) == (64 if hd <= 64 else 128,
                                         8 if h // hkv <= 8 else 16)


def test_decode_plan_of_the_served_models():
    """paper-0.5b and olmo-1b at the serving batch of 4: three ranks a
    (request, kv head); one request alone takes the widest cluster."""
    assert ap.decode_plan(4, 32, 32, 64, 34, 16, 132).cluster == 3
    assert ap.decode_plan(4, 16, 16, 128, 34, 16, 132).cluster == 3
    assert ap.decode_plan(1, 32, 32, 64, 34, 16, 132).cluster == 8
    assert ap.decode_plan(64, 32, 32, 64, 34, 16, 132).cluster == 1


@pytest.mark.parametrize("table_keys", [64, 544, 2048])
@pytest.mark.parametrize("cluster", [1, 2, 3, 8])
@pytest.mark.parametrize("seq_len", [0, 1, 15, 16, 63, 64, 127, 543, 2047])
def test_decode_splits_tile_the_live_keys(seq_len, cluster, table_keys):
    splits = ap.decode_splits(seq_len, table_keys, cluster)
    kend = min(seq_len + 1, table_keys)
    assert len(splits) == cluster
    assert [k for lo, hi in splits for k in range(lo, hi)] == \
        list(range(kend))
    for lo, hi in splits:
        assert lo % ap.DECODE_KEY_TILE == 0 or lo == hi == kend
        assert hi % ap.DECODE_KEY_TILE == 0 or hi == kend


def _decode_replay(q, kpool, vpool, bt, seq_lens, cluster):
    """K3's schedule in f32: for each (request, kv head) every rank's online
    softmax over its 64-key tiles (``decode_splits``), then the ranks'
    (m, l, acc) merged in rank order and divided by max(l, 1e-30)."""
    b, _, h, hd = q.shape
    _, bs, hkv, _ = kpool.shape
    g, width = h // hkv, bt.shape[1]
    kf = kpool[bt.long()].reshape(b, width * bs, hkv, hd)
    vf = vpool[bt.long()].reshape(b, width * bs, hkv, hd)
    out = torch.zeros_like(q)
    for i in range(b):
        for hk in range(hkv):
            qg = q[i, 0, hk * g:(hk + 1) * g]
            parts = []
            for lo, hi in ap.decode_splits(int(seq_lens[i]), width * bs,
                                           cluster):
                m = torch.full((g,), -1e30)
                l, acc = torch.zeros(g), torch.zeros(g, hd)
                for t0 in range(lo, hi, ap.DECODE_KEY_TILE):
                    t1 = min(t0 + ap.DECODE_KEY_TILE, hi)
                    s = qg @ kf[i, t0:t1, hk].T / hd ** 0.5
                    m_new = torch.maximum(m, s.max(dim=1).values)
                    corr = torch.exp(m - m_new)
                    p = torch.exp(s - m_new[:, None])
                    l = l * corr + p.sum(dim=1)
                    acc = acc * corr[:, None] + p @ vf[i, t0:t1, hk]
                    m = m_new
                parts.append((m, l, acc))
            mx = torch.stack([m for m, _, _ in parts]).max(dim=0).values
            lt, at = torch.zeros(g), torch.zeros(g, hd)
            for m, l, acc in parts:                  # rank order
                a = torch.exp(m - mx)
                lt = lt + a * l
                at = at + a[:, None] * acc
            out[i, 0, hk * g:(hk + 1) * g] = at / torch.clamp(
                lt, min=1e-30)[:, None]
    return out


@pytest.mark.parametrize("sms", [132, 2])
@pytest.mark.parametrize("g", [1, 4, 16])
def test_decode_schedule_replay_matches_plain(g, sms):
    """The replay of K3's schedule under ``decode_plan``'s cluster against
    the plain version: seq_len 0 on a padded row (all-null table), 1,
    bs - 1, bs, both sides of a 64-key tile boundary and the table's last
    key."""
    hkv, hd, bs, width = 2, 16, 8, 24
    sl = [0, 1, bs - 1, bs, 63, 64, width * bs - 1]
    b = len(sl)
    plan = ap.decode_plan(b, g * hkv, hkv, hd, width, bs, sms)
    assert plan.cluster == (3 if sms == 132 else 1)
    rng = np.random.RandomState(g)
    n = 1 + b * width
    kpool = torch.from_numpy(rng.randn(n, bs, hkv, hd).astype(np.float32))
    vpool = torch.from_numpy(rng.randn(n, bs, hkv, hd).astype(np.float32))
    bt = torch.from_numpy(rng.permutation(np.arange(1, n))[:b * width]
                          .reshape(b, width).astype(np.int32))
    bt[0] = 0
    seq_lens = torch.tensor(sl, dtype=torch.int32)
    q = torch.from_numpy(rng.randn(b, 1, g * hkv, hd).astype(np.float32))
    got = _decode_replay(q, kpool, vpool, bt, seq_lens, plan.cluster)
    want = paged_decode_attention_plain(q, kpool, vpool, bt, seq_lens)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, atol=1e-5, rtol=0)
