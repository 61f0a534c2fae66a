"""The host-side launch plan of K2, the TwELL fused up + down projection
(``repro_torch/kernels/sparse_ffn.py:fused_ffn_plan``): a plain function of
shapes that takes no tensor, covers every row, every 64-deep K stage (the
up partials' reduction range and y's columns alike) and every union chunk
exactly once, keeps a block within its shared memory and both products'
accumulators within the plan's register rule, puts every cluster on the
H100's 132 SMs at once at the serving shapes, and refuses an N its u16
positions cannot hold and tiles it is not built for. The kernel's schedule
is replayed on the CPU -- per row block the union of the TwELL valid
prefixes' columns (byte map, bitmap, prefix popcount), its chunks of 128
positions, each rank's partial of h_u over its K stages, the partials
summed in rank order, h rounded once at the valid slots of each rank's
rows, the down products over each rank's columns of y -- and held against
``twell_fused_ffn_plain`` (bf16 2e-2, float32 2e-4, rtol and atol, as
tests/test_torch_twell.py), with every y element written exactly once and
every (row, position) entry of h at most once, on gates packed by K1's
plain version. Plans up to K 4096 are pinned as they were before the wide
plans; past it (llama4-scout's K 5120, mixtral-8x22b's 6144, up to 8192) a
rank holds up to 16 stages with a ring shorter than a phase, and the ring's
groups are replayed too. Every plan up to K 8192 is pinned (a digest of a
grid of 1320) as it was before the widest slices: past K 8192
(llama3-405b's K 16384 at its N 53248) a rank holds up to 32 stages, 16
slices of y in 8-row blocks. The wrapper refuses bad shapes, types and
alignment before anything is built.
"""
import dataclasses
import hashlib

import numpy as np
import pytest
import torch

from repro_torch.core import twell
from repro_torch.kernels import build
from repro_torch.kernels import sparse_ffn as sf
from repro_torch.kernels import twell_pack as tp
from repro_torch.kernels.twell_pack import twell_gate_matmul_plain

SMS = 132
BK = tp.GATE_BK
UC = sf.FUSED_FFN_UC

# (M, K, N, T, C): paper-0.5b's FFN at the plan's width and row-block
# boundaries (decode 4, the spec verify 20, the prefill step 256), then the
# card sweep's shapes
SERVING = [(m, 2048, 5632, 256, 8)
           for m in (1, 4, 8, 9, 20, 64, 65, 128, 129, 256, 300)]
SWEEP = [(1, 64, 256, 64, 1), (37, 128, 512, 128, 4), (70, 256, 768, 256, 2),
         (16, 96, 512, 64, 8), (5, 200, 256, 64, 4), (300, 512, 1024, 256, 8),
         (4, 2048, 8192, 256, 8), (4096, 2048, 5632, 256, 8)]


def _covered_once(splits, count):
    return [i for lo, hi in splits for i in range(lo, hi)] == \
        list(range(count))


@pytest.mark.parametrize("arg", range(6))
def test_fused_ffn_plan_takes_only_ints(arg):
    """A tensor (a device value) in place of a shape is refused: the plan
    never reads the pattern, so a serving step never waits on the card."""
    shape = [4, 2048, 5632, 256, 8, SMS]
    shape[arg] = torch.tensor(shape[arg])
    with pytest.raises(TypeError):
        sf.fused_ffn_plan(*shape)


@pytest.mark.parametrize("sms", [SMS, 5])
@pytest.mark.parametrize("shape", SERVING + SWEEP, ids=str)
def test_fused_ffn_plan_covers_rows_stages_and_chunks_once(shape, sms):
    m, k, n, t, c = shape
    plan = sf.fused_ffn_plan(m, k, n, t, c, sms)
    assert plan.width in sf.FUSED_FFN_WIDTHS
    assert plan.width == min(w for w in sf.FUSED_FFN_WIDTHS
                             if w >= min(m, 64)) or plan.width < 64
    assert plan.row_blocks == tp.cdiv(m, plan.width)
    assert (plan.row_blocks - 1) * plan.width < m
    assert plan.grid == (plan.ks, plan.row_blocks)
    assert plan.k_stages == tp.cdiv(k, BK)
    assert 1 <= plan.ks <= min(tp.MAX_KS, plan.k_stages)
    assert plan.split == (plan.width >= sf.FUSED_FFN_SPLIT_WIDTH and
                          plan.ks > 1)
    ksplits = plan.k_splits()
    assert len(ksplits) == plan.ks and _covered_once(ksplits, plan.k_stages)
    assert all(hi > lo for lo, hi in ksplits), "a rank without a K stage"
    assert max(hi - lo for lo, hi in ksplits) == plan.k_per_rank
    for b in range(plan.row_blocks):
        rv = min(plan.width, m - b * plan.width)
        assert _covered_once(plan.scatter_rows(rv), rv)
    for union in sorted({0, 1, UC - 1, UC, UC + 1, 3 * UC, n // 2, n}):
        chunks = plan.chunks(union)
        assert _covered_once(chunks, union)
        assert all(hi - lo <= UC and lo % UC == 0 for lo, hi in chunks)
        assert len(chunks) == tp.cdiv(union, UC)


@pytest.mark.parametrize("shape", SERVING + SWEEP, ids=str)
def test_fused_ffn_plan_fits_registers_and_shared_memory(shape):
    """A rank's share of y in its accumulators beside the up product's,
    (slices + 1) x width / 2 floats a thread, within the rule; the ring,
    x's tile, the h and partial tiles and the union's maps within a
    block's 227 KB; the byte map within the ring it is staged over; the
    deepest ring that fits."""
    m, k, n, t, c = shape
    plan = sf.fused_ffn_plan(m, k, n, t, c, SMS)
    assert plan.slices in sf.FUSED_FFN_SLICES
    assert 2 * plan.slices >= plan.k_per_rank
    assert (plan.slices + 1) * plan.width // 2 <= sf.FUSED_FFN_ACC
    assert plan.smem == sf.fused_ffn_smem(plan.width, plan.k_per_rank,
                                          plan.stages, n)
    assert plan.smem <= tp.SMEM_BYTES
    lo, hi = sf.FUSED_FFN_STAGES
    assert lo <= plan.stages <= hi
    assert sf.fused_ffn_staging(n) <= plan.stages * sf.FUSED_FFN_UNIT
    assert plan.stages >= 2 * tp.cdiv(plan.k_per_rank, 2)
    if plan.stages < hi:
        assert sf.fused_ffn_smem(plan.width, plan.k_per_rank,
                                 plan.stages + 1, n) > tp.SMEM_BYTES


@pytest.mark.parametrize("m", [4, 20, 256])
def test_fused_ffn_plan_clusters_fit_the_card(m):
    """At decode, the spec verify and the prefill step every cluster is
    resident at once, one block an SM (K1's residency model), and the
    cluster is as wide as the portable size."""
    plan = sf.fused_ffn_plan(m, 2048, 5632, 256, 8, SMS)
    assert plan.blocks <= SMS
    assert plan.row_blocks <= tp.resident_clusters(plan.ks, 1, SMS)
    assert plan.ks == tp.MAX_KS
    assert plan.stages == sf.FUSED_FFN_STAGES[1]


@pytest.mark.parametrize("bad", [
    (4, 2048, 65536, 256, 8),       # u16 positions
    (4, 2048, 65792, 256, 8),
    (4, 2048, 5632, 32, 8),         # tiles the kernel is not built for
    (4, 2048, 5632, 512, 8),
    (4, 2044, 5632, 256, 8),        # K % 8
    (4, 2048, 5600, 256, 8),        # N % T
    (4, 2048, 5632, 256, 3),        # T % C
    (0, 2048, 5632, 256, 8)])
def test_fused_ffn_plan_refuses(bad):
    with pytest.raises(ValueError):
        sf.fused_ffn_plan(*bad, SMS)


def test_fused_ffn_plan_narrows_rows_for_a_wide_k():
    """A K whose share a rank cannot hold at 64 rows (more than 4 stages a
    rank) takes narrower row blocks; one past 8 stages a rank takes the
    wide slices, narrower still; one past 16 stages a rank the widest, at
    8 rows a block; one past 32 stages a rank (K above FUSED_FFN_MAX_K) is
    refused, and so is an N whose maps leave no ring at K 16384."""
    plan = sf.fused_ffn_plan(256, 4096, 5632, 256, 8, SMS)
    assert plan.width < 64 and plan.ks == tp.MAX_KS
    assert (plan.slices + 1) * plan.width // 2 <= sf.FUSED_FFN_ACC
    plan = sf.fused_ffn_plan(256, 64 * 8 * 9, 5632, 256, 8, SMS)
    assert plan.width < 64 and plan.slices in sf.FUSED_FFN_WIDE_SLICES
    assert (plan.slices + 1) * plan.width // 2 <= sf.FUSED_FFN_ACC
    plan = sf.fused_ffn_plan(256, 64 * 8 * 17, 5632, 256, 8, SMS)
    assert plan.width == 8 and plan.slices in sf.FUSED_FFN_WIDEST_SLICES
    assert (plan.slices + 1) * plan.width // 2 <= sf.FUSED_FFN_ACC
    assert sf.FUSED_FFN_MAX_K == 16384
    sf.fused_ffn_plan(4, sf.FUSED_FFN_MAX_K, 5632, 256, 8, SMS)
    for k, n in ((sf.FUSED_FFN_MAX_K + 8, 5632), (64 * 8 * 33, 5632),
                 (sf.FUSED_FFN_MAX_K, 53248 + 256)):
        with pytest.raises(ValueError, match="K up to 16384"):
            sf.fused_ffn_plan(4, k, n, 256, 8, SMS)


def _k2_grid():
    """(M, K, N, T, C, SMs) of 1320 plans up to K 8192: decode to a 4096-row
    step, K 64-8192, N 256-22016, on 132 and 5 SMs."""
    for m in (1, 4, 8, 9, 20, 33, 64, 65, 256, 300, 4096):
        for k in (64, 200, 1024, 2048, 3072, 4096, 4608, 5120, 6144, 8192):
            for n in (256, 5632, 8192, 14336, 16384, 22016):
                for sms in (SMS, 5):
                    yield m, k, n, 256, 8, sms


# the digest of _k2_grid's plans (every field) before the widest slices
K8192_DIGEST = "09ccc5bdf2fc61a9"


def test_fused_ffn_plan_up_to_k8192_is_unchanged():
    """Every plan up to K 8192, field for field, as before K2 took K past
    8192 (paper-0.5b's, olmo-1b's, phi3-mini's, deepseek-67b's and the MoE
    experts' K2 times stand on them)."""
    rows = [(s, dataclasses.astuple(sf.fused_ffn_plan(*s)))
            for s in _k2_grid()]
    assert len(rows) == 1320
    assert all(p[5] not in sf.FUSED_FFN_WIDEST_SLICES for _, p in rows)
    assert hashlib.sha256(repr(rows).encode()).hexdigest()[:16] == \
        K8192_DIGEST


# (M, K, N, T, C) -> (width, ks, slices, stages, split): the plans up to K
# 4096 as they were before the wide-K plans were added, which must not move
# (paper-0.5b's and olmo-1b's K2 times stand on them)
NARROW_PLANS = {
    (1, 2048, 5632, 256, 8): (8, 8, 2, 8, False),
    (4, 2048, 5632, 256, 8): (8, 8, 2, 8, False),
    (8, 2048, 5632, 256, 8): (8, 8, 2, 8, False),
    (9, 2048, 5632, 256, 8): (16, 8, 2, 8, False),
    (20, 2048, 5632, 256, 8): (32, 8, 2, 8, True),
    (64, 2048, 5632, 256, 8): (64, 8, 2, 8, True),
    (65, 2048, 5632, 256, 8): (64, 8, 2, 8, True),
    (128, 2048, 5632, 256, 8): (64, 8, 2, 8, True),
    (129, 2048, 5632, 256, 8): (64, 8, 2, 8, True),
    (256, 2048, 5632, 256, 8): (64, 8, 2, 8, True),
    (300, 2048, 5632, 256, 8): (64, 8, 2, 8, True),
    (4096, 2048, 5632, 256, 8): (64, 8, 2, 8, True),
    (8192, 2048, 5632, 256, 8): (64, 8, 2, 8, True),
    (4, 2048, 8192, 256, 8): (8, 8, 2, 8, False),
    (256, 2048, 8192, 256, 8): (64, 8, 2, 7, True),
    (4, 4096, 5632, 256, 8): (8, 8, 4, 8, False),
    (64, 4096, 5632, 256, 8): (32, 8, 4, 8, True),
    (256, 4096, 5632, 256, 8): (32, 8, 4, 8, True),
    (4, 4096, 14336, 256, 8): (8, 8, 4, 8, False),
    (64, 4096, 14336, 256, 8): (32, 8, 4, 8, True),
    (1, 64, 256, 64, 1): (8, 1, 2, 8, False),
    (37, 128, 512, 128, 4): (64, 2, 2, 8, True),
    (70, 256, 768, 256, 2): (64, 4, 2, 8, True),
    (16, 96, 512, 64, 8): (16, 2, 2, 8, False),
    (5, 200, 256, 64, 4): (8, 4, 2, 8, False),
    (300, 512, 1024, 256, 8): (64, 8, 2, 8, True),
}


@pytest.mark.parametrize("shape", list(NARROW_PLANS), ids=str)
def test_fused_ffn_plan_up_to_k4096_is_unchanged(shape):
    plan = sf.fused_ffn_plan(*shape, SMS)
    assert (plan.width, plan.ks, plan.slices, plan.stages, plan.split) == \
        NARROW_PLANS[shape]
    assert plan.whole and plan.up_groups(plan.k_per_rank) == \
        [(0, plan.k_per_rank)]


# past K 4096: llama4-scout's expert FFN (K 5120, N 8192), mixtral-8x22b's
# (K 6144, N 16384), the widest K, and K 4608 (9 stages a rank)
WIDE = [(m, k, n, 256, 8) for m in (1, 4, 20, 64, 256, 8192)
        for k, n in ((5120, 8192), (6144, 16384))] + \
    [(4, 8192, 22016, 256, 8), (64, 8192, 16384, 256, 8),
     (37, 4608, 5632, 256, 8), (5, 5128, 512, 64, 4)]


@pytest.mark.parametrize("shape", WIDE, ids=str)
def test_fused_ffn_wide_plan_fits_and_groups_the_ring(shape):
    """A rank past 8 stages holds FUSED_FFN_WIDE_SLICES within the register
    rule and a ring shorter than a phase within a block's shared memory;
    the groups it lands its up stages and its slices' down stages in cover
    each once, in order, each within half the ring."""
    m, k, n, t, c = shape
    plan = sf.fused_ffn_plan(m, k, n, t, c, SMS)
    assert plan.k_per_rank > 8 and plan.slices in sf.FUSED_FFN_WIDE_SLICES
    assert 2 * plan.slices >= plan.k_per_rank
    assert (plan.slices + 1) * plan.width // 2 <= sf.FUSED_FFN_ACC
    assert plan.smem == sf.fused_ffn_smem(plan.width, plan.k_per_rank,
                                          plan.stages, n) <= tp.SMEM_BYTES
    assert sf.FUSED_FFN_STAGES[0] <= plan.stages <= sf.FUSED_FFN_STAGES[1]
    assert not plan.whole
    assert _covered_once(plan.k_splits(), plan.k_stages)
    for lo, hi in plan.k_splits():
        ns = hi - lo
        ups = plan.up_groups(ns)
        assert _covered_once(ups, ns)
        assert all(0 < b - a <= plan.stages // 2 for a, b in ups)
        downs = plan.down_groups(tp.cdiv(ns, 2))
        assert _covered_once(downs, tp.cdiv(ns, 2))
        assert all(0 < 2 * (b - a) <= plan.stages // 2 or b - a == 1
                   for a, b in downs)


# past K 8192: llama3-405b's FFN (K 16384, N 53248) at decode, the spec
# verify, a 64-row chunk and the prefill step; K 12288; K 16384 at a
# narrow N; the first K past 8192
WIDEST = [(m, 16384, 53248, 256, 8) for m in (4, 20, 64, 256)] + \
    [(m, 12288, 53248, 256, 8) for m in (4, 64, 256)] + \
    [(4, 16384, 5632, 256, 8), (9, 8200, 512, 64, 4)]


@pytest.mark.parametrize("shape", WIDEST, ids=str)
def test_fused_ffn_widest_plan_fits_and_groups_the_ring(shape):
    """A rank past 16 stages holds FUSED_FFN_WIDEST_SLICES at 8 rows a
    block within the register rule, a ring of at least 3 stages and the
    byte map of N within a block's shared memory; its groups cover its up
    stages and its slices' down stages each once, in order, within half
    the ring."""
    m, k, n, t, c = shape
    plan = sf.fused_ffn_plan(m, k, n, t, c, SMS)
    assert plan.k_per_rank > 16 and plan.width == 8
    assert plan.slices in sf.FUSED_FFN_WIDEST_SLICES
    assert 2 * plan.slices >= plan.k_per_rank
    assert (plan.slices + 1) * plan.width // 2 <= sf.FUSED_FFN_ACC
    assert plan.smem == sf.fused_ffn_smem(plan.width, plan.k_per_rank,
                                          plan.stages, n) <= tp.SMEM_BYTES
    assert sf.fused_ffn_staging(n) <= plan.stages * sf.FUSED_FFN_UNIT
    assert sf.FUSED_FFN_STAGES[0] <= plan.stages <= sf.FUSED_FFN_STAGES[1]
    assert plan.row_blocks == tp.cdiv(m, 8) and not plan.whole
    assert _covered_once(plan.k_splits(), plan.k_stages)
    for lo, hi in plan.k_splits():
        ns = hi - lo
        ups = plan.up_groups(ns)
        assert _covered_once(ups, ns)
        assert all(0 < b - a <= plan.stages // 2 for a, b in ups)
        downs = plan.down_groups(tp.cdiv(ns, 2))
        assert _covered_once(downs, tp.cdiv(ns, 2))
        assert all(0 < 2 * (b - a) <= plan.stages // 2 or b - a == 1
                   for a, b in downs)


def ring_replay(plan, ns, chunks):
    """The cp.async ring of one rank over ``chunks`` union chunks as the
    kernel runs it: before each group ``land`` refills every slot whose
    stage is done with the next stages (as far ahead as the ring holds),
    then the group's stages are read. Returns the (stage, slot) reads and
    asserts each read finds its own stage in its slot, landed."""
    nst, nsl = plan.stages, tp.cdiv(ns, 2)
    per_c = ns + 2 * nsl
    total = chunks * per_c
    slot = [None] * nst
    issued, j, reads = 0, 0, []

    def land(j0, g):
        nonlocal issued
        assert 0 < g <= nst
        while issued < min(total, j0 + nst):
            old = slot[issued % nst]
            assert old is None or old < j0, "a slot refilled while in use"
            slot[issued % nst] = issued
            issued += 1
        assert issued >= j0 + g

    for _ in range(chunks):
        for lo, hi in plan.up_groups(ns):
            land(j, hi - lo)
            for s in range(hi - lo):
                assert slot[(j + s) % nst] == j + s
                reads.append(j + s)
            j += hi - lo
        for lo, hi in plan.down_groups(nsl):
            land(j, 2 * (hi - lo))
            for v in range(2 * (hi - lo)):
                assert slot[(j + v) % nst] == j + v
                reads.append(j + v)
            j += 2 * (hi - lo)
    return reads, total


@pytest.mark.parametrize("shape", [(4, 2048, 5632, 256, 8),
                                   (64, 4096, 5632, 256, 8)] + WIDE[:4] +
                         WIDE[-4:] + WIDEST[::2], ids=str)
def test_fused_ffn_ring_schedule_reads_every_stage_once(shape):
    """Whole phases (up to K 4096) and grouped ones (past it): every ring
    stage of every chunk is read once, in order, after it landed and
    before its slot is refilled."""
    plan = sf.fused_ffn_plan(*shape, SMS)
    for lo, hi in {plan.k_splits()[0], plan.k_splits()[-1]}:
        reads, total = ring_replay(plan, hi - lo, 3)
        assert reads == list(range(total))


# --------------------------------------------------------------------------- #
# the kernel's schedule, replayed
# --------------------------------------------------------------------------- #

def _union(idx, cnt, n, t, tc):
    """One row block's union as the kernel builds it from the TwELL valid
    prefixes (slot s of tile j valid iff s < cnt[r, j]): the byte map of
    their columns, folded into 32-bit words, the words' exclusive prefix
    popcount. Returns (U, the columns in order, every column's position:
    its word's prefix plus the bits below it)."""
    words = tp.cdiv(n, 32)
    flags = np.zeros(32 * words, dtype=bool)
    for r in range(cnt.shape[0]):
        for j in range(n // t):
            cols = idx[r, j * tc:j * tc + cnt[r, j]]
            flags[cols[(cols >= 0) & (cols < n)]] = True
    bits = flags.reshape(words, 32)
    prefix = np.concatenate([[0], np.cumsum(bits.sum(1))[:-1]])
    below = np.cumsum(bits, axis=1) - bits
    pos = (prefix[:, None] + below).reshape(-1)[:n]
    return int(bits.sum()), np.nonzero(flags)[0], pos


def fused_replay(x, tw, wu_t, wd, plan):
    """K2's schedule under ``plan``: operands as the kernel reads them
    (x.dtype widened to float32), products and sums in float32, h rounded
    once to x.dtype. Returns (y float32, the writes of every y element,
    the most writes any (row, position) entry of h took)."""
    m, k = x.shape
    n = wd.shape[0]
    t, tc = tw.tile, tw.slot_width
    xf, wuf, wdf = x.float(), wu_t.float(), wd.float()
    idx = tw.indices.numpy()
    cnt_all = np.clip(tw.nnz.numpy(), 0, tc)
    gate = tw.values.float()
    kpad = plan.k_stages * BK
    y = torch.full((m, k), float("nan"))
    writes = torch.zeros((m, k), dtype=torch.int32)
    most = 0
    for b in range(plan.row_blocks):
        r0, w = b * plan.width, plan.width
        rv = min(w, m - r0)
        cnt = cnt_all[r0:r0 + rv]
        u, cols, pos = _union(idx[r0:r0 + rv], cnt, n, t, tc)
        # the block's valid slots: (row, slot)
        slot = np.arange(idx.shape[1])
        valid = (slot % tc)[None, :] < np.repeat(cnt, tc, axis=1)
        rr, ss = np.nonzero(valid)
        cc = idx[r0 + rr, ss]
        keep = (cc >= 0) & (cc < n)
        rr, ss, cc = rr[keep], ss[keep], cc[keep]
        xb = torch.zeros(w, kpad)
        xb[:rv, :k] = xf[r0:r0 + rv]
        yb = torch.zeros(w, kpad)
        for lo, hi in plan.chunks(u):
            live = torch.from_numpy(cols[lo:hi])
            au = torch.zeros(UC, kpad)           # gathered, 0 past U and K
            au[:hi - lo, :k] = wuf[live]
            ad = torch.zeros(UC, kpad)
            ad[:hi - lo, :k] = wdf[live]
            parts = [au[:, s0 * BK:s1 * BK] @ xb[:, s0 * BK:s1 * BK].t()
                     for s0, s1 in plan.k_splits()]   # (UC, rows) each
            h = torch.zeros(w, UC)
            hits = torch.zeros(w, UC, dtype=torch.int32)
            for r_lo, r_hi in plan.scatter_rows(rv):  # each rank's rows
                pc = pos[cc] - lo
                sel = (rr >= r_lo) & (rr < r_hi) & (pc >= 0) & (pc < UC)
                r_t = torch.from_numpy(rr[sel])
                p_t = torch.from_numpy(pc[sel])
                total = torch.zeros(len(r_t))
                for part in parts:                   # rank order
                    total = total + part[p_t, r_t]
                g = gate[r0 + rr[sel], ss[sel]]
                h[r_t, p_t] = (total * g).to(x.dtype).float()
                hits.index_put_((r_t, p_t), torch.ones_like(r_t, dtype=torch.int32),
                                accumulate=True)
            most = max(most, int(hits.max()))
            for s0, s1 in plan.k_splits():           # each rank's columns
                yb[:, s0 * BK:s1 * BK] += h @ ad[:, s0 * BK:s1 * BK]
        for s0, s1 in plan.k_splits():
            k0, k1 = s0 * BK, min(s1 * BK, k)
            y[r0:r0 + rv, k0:k1] = yb[:rv, k0:k1]
            writes[r0:r0 + rv, k0:k1] += 1
    return y, writes, most


# name: (M, K, N, T, C, keep, dtype, special): a union wider than one chunk
# with overflowed tiles, C = 1, K 200, an empty row, two row blocks, an
# all-empty gate, paper-0.5b at the spec verify's M
CASES = {
    "overflow_wide": (16, 96, 512, 64, 8, 1.0, torch.bfloat16, None),
    "c1": (5, 128, 256, 64, 1, 0.3, torch.bfloat16, None),
    "k200": (5, 200, 256, 64, 4, 0.2, torch.bfloat16, None),
    "empty_row": (9, 128, 512, 128, 4, 0.1, torch.bfloat16, "empty_row"),
    "two_blocks": (70, 192, 768, 256, 2, 0.3, torch.bfloat16, None),
    "scattered_f32": (37, 136, 512, 128, 4, 1.0, torch.float32, None),
    "all_empty": (3, 64, 256, 64, 2, 0.3, torch.bfloat16, "all_empty"),
    "verify": (20, 2048, 5632, 256, 8, 0.02, torch.bfloat16, None),
    # past K 4096: llama4-scout's and mixtral-8x22b's d_model (a rank of
    # 10 and 12 stages, the ring in groups) at a narrow N
    "k5120": (6, 5120, 512, 128, 4, 0.3, torch.bfloat16, None),
    "k6144": (33, 6144, 256, 64, 2, 0.3, torch.bfloat16, None),
    # past K 8192: llama3-405b's d_model (a rank of 32 stages, 16 slices
    # of y, 8-row blocks) at a narrow N
    "k16384": (10, 16384, 256, 64, 2, 0.3, torch.bfloat16, None),
}


def _case(name):
    """(x, the K1-plain-packed gate clipped as ops clips it, W_u^T, W_d)."""
    m, k, n, t, c, keep, dt, special = CASES[name]
    rng = np.random.RandomState(sum(map(ord, name)))
    x = rng.randn(m, k) * 0.5
    if special == "empty_row":
        x[3] = 0.0
    if special == "all_empty":
        x[:] = 0.0
    col = rng.rand(n) < keep
    wg = rng.randn(k, n) * 0.08 * col[None]
    wu = rng.randn(k, n) * 0.08
    wd = rng.randn(n, k) * 0.08
    x, wg, wu, wd = (torch.from_numpy(a.astype(np.float32)).to(dt)
                     for a in (x, wg, wu, wd))
    v, i, z = twell_gate_matmul_plain(x, wg, t, c, "relu")
    tc = t // c
    tw = twell.TwellActs(v, i, torch.clamp(z, max=tc), (z > tc).any(), t, c,
                         n)
    return x, tw, wu.t().contiguous(), wd, z


@pytest.mark.parametrize("sms", [SMS, 3])
@pytest.mark.parametrize("name", list(CASES))
def test_fused_ffn_schedule_replay_matches_plain(name, sms):
    x, tw, wu_t, wd, _ = _case(name)
    m, k = x.shape
    plan = sf.fused_ffn_plan(m, k, wd.shape[0], tw.tile, tw.compression, sms)
    got, writes, most = fused_replay(x, tw, wu_t, wd, plan)
    want = sf.twell_fused_ffn_plain(x, tw, wu_t, wd)
    assert (writes == 1).all(), "a y element was written twice or never"
    assert most <= 1, "an h entry took two slots"
    tol = 2e-2 if x.dtype == torch.bfloat16 else 2e-4
    torch.testing.assert_close(got, want.float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("name", ["overflow_wide", "two_blocks", "verify"])
def test_fused_ffn_replay_one_rank(name):
    """The same schedule with the K loop on one rank (no cluster split):
    the rank-order sum is the only difference, within the tolerance."""
    x, tw, wu_t, wd, _ = _case(name)
    m, k = x.shape
    base = sf.fused_ffn_plan(m, k, wd.shape[0], tw.tile, tw.compression, SMS)
    plan = sf.FusedFfnPlan(base.width, base.row_blocks, 1, base.k_stages,
                           base.k_stages, base.slices, base.stages,
                           base.smem, (1, base.row_blocks), False)
    got, writes, most = fused_replay(x, tw, wu_t, wd, plan)
    want = sf.twell_fused_ffn_plain(x, tw, wu_t, wd)
    assert (writes == 1).all() and most <= 1
    torch.testing.assert_close(got, want.float(), rtol=2e-2, atol=2e-2)


def test_replay_cases_reach_their_corners():
    """Each case exercises the corner it is named for."""
    def block_union(name, b=0):
        x, tw, _, wd, _ = _case(name)
        m, k = x.shape
        plan = sf.fused_ffn_plan(m, k, wd.shape[0], tw.tile, tw.compression,
                                 SMS)
        r0 = b * plan.width
        rv = min(plan.width, m - r0)
        cnt = np.clip(tw.nnz.numpy()[r0:r0 + rv], 0, tw.slot_width)
        return _union(tw.indices.numpy()[r0:r0 + rv], cnt, wd.shape[0],
                      tw.tile, tw.slot_width)[0]
    _, tw, _, _, z = _case("overflow_wide")
    assert bool((z > tw.slot_width).any()), "no tile overflowed T/C"
    assert block_union("overflow_wide") > UC
    assert block_union("scattered_f32") > 2 * UC
    assert CASES["c1"][4] == 1 and CASES["k200"][1] % BK
    _, tw, _, _, _ = _case("empty_row")
    assert int(tw.nnz[3].sum()) == 0 and int(tw.nnz.sum()) > 0
    assert block_union("all_empty") == 0
    assert sf.fused_ffn_plan(70, 192, 768, 256, 2, SMS).row_blocks == 2
    assert 0 < block_union("verify") <= UC
    for name in ("k5120", "k6144", "k16384"):
        m, k, n, t, c = CASES[name][:5]
        assert not sf.fused_ffn_plan(m, k, n, t, c, SMS).whole
    assert block_union("k6144", 1) > 0
    plan = sf.fused_ffn_plan(*CASES["k16384"][:5], SMS)
    assert plan.slices == 16 and plan.row_blocks == 2
    assert block_union("k16384", 1) > 0


def test_replay_counts_a_repeated_column():
    """The h tile's contract (a row's valid slots hold distinct columns, as
    K1 writes them) is what the replay's count checks: a row that names one
    column twice puts two slots on one entry."""
    x, tw, wu_t, wd, _ = _case("c1")
    idx = tw.indices.clone()
    row = int(torch.nonzero(tw.nnz[:, 0] >= 2)[0, 0])
    idx[row, 1] = idx[row, 0]
    bad = tw._replace(indices=idx)
    plan = sf.fused_ffn_plan(5, 128, 256, 64, 1, SMS)
    _, _, most = fused_replay(x, bad, wu_t, wd, plan)
    assert most == 2
    _, _, most = fused_replay(x, tw, wu_t, wd, plan)
    assert most == 1


def _no_build(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a kernel was built for an unsupported input")
    monkeypatch.setattr(build, "build_all", refuse)
    monkeypatch.setattr(build, "bind", refuse)


def _operands(m=4, k=64, n=256, t=64, c=2):
    x = torch.zeros(m, k, dtype=torch.bfloat16)
    slots = n // c
    tw = twell.TwellActs(torch.zeros(m, slots, dtype=torch.bfloat16),
                         torch.zeros(m, slots, dtype=torch.int32),
                         torch.zeros(m, n // t, dtype=torch.int32),
                         torch.tensor(False), t, c, n)
    return x, tw, torch.zeros(n, k, dtype=torch.bfloat16), \
        torch.zeros(n, k, dtype=torch.bfloat16)


def _misaligned(shape):
    numel = int(np.prod(shape))
    return torch.zeros(numel + 1, dtype=torch.bfloat16)[1:].view(*shape)


@pytest.mark.parametrize("bad,err,match", [
    ("x_f16", TypeError, "bfloat16"),
    ("wd_f32", TypeError, "bfloat16"),
    ("idx_i64", TypeError, "int32"),
    ("k_odd", ValueError, "K % 8"),
    ("tile_32", ValueError, "tile"),
    ("wide_n", ValueError, "N <="),
    ("wd_rows", ValueError, "inconsistent"),
    ("values_cols", ValueError, "inconsistent"),
    ("strided", ValueError, "contiguous"),
    ("x_misaligned", ValueError, "aligned"),
    ("wu_misaligned", ValueError, "aligned"),
    ("cpu", ValueError, "CUDA")])
def test_twell_fused_ffn_cuda_refuses_before_building(monkeypatch, bad, err,
                                                       match):
    """Types, shapes the kernel does not take, operands that are not
    contiguous or not 16-byte aligned, and CPU tensors raise in the
    wrapper's checks before any kernel is built or bound."""
    _no_build(monkeypatch)
    x, tw, wu_t, wd = _operands()
    if bad == "x_f16":
        x = x.half()
    elif bad == "wd_f32":
        wd = wd.float()
    elif bad == "idx_i64":
        tw = tw._replace(indices=tw.indices.long())
    elif bad == "k_odd":
        x, tw, wu_t, wd = _operands(k=60)
    elif bad == "tile_32":
        x, tw, wu_t, wd = _operands(t=32)
    elif bad == "wide_n":
        x, tw, wu_t, wd = _operands(k=8, n=65536, t=256, c=8)
    elif bad == "wd_rows":
        wd = wd[:128]
    elif bad == "values_cols":
        tw = tw._replace(values=tw.values[:, :64].contiguous())
    elif bad == "strided":
        x = torch.zeros(64, 4, dtype=torch.bfloat16).t()
    elif bad == "x_misaligned":
        x = _misaligned((4, 64))
    elif bad == "wu_misaligned":
        wu_t = _misaligned((256, 64))
    with pytest.raises(err, match=match):
        sf.twell_fused_ffn_cuda(x, tw, wu_t, wd)
