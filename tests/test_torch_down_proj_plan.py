"""The host-side launch plan of K6, the non-gated TwELL down projection
(``repro_torch/kernels/sparse_ffn.py:down_proj_plan``): a plain function of
shapes that takes no tensor, covers every row, every 64-column stage of y
and every union chunk exactly once, keeps a block within its shared memory
and its accumulators within the register rule, puts every cluster on the
H100's 132 SMs at once at olmo-1b's shapes (and a decode call on at least
16 SMs), and refuses an N its u16 positions cannot hold and tiles it is
not built for. The kernel's schedule is replayed on the CPU -- per row
block the union of the TwELL valid prefixes' columns (each rank's rows
marked, the ranks' maps ORed; byte map, bitmap, prefix popcount), its
chunks of 128 positions in groups of the h tile's chunks, the packed values
scattered into h by union position, the products over each column block's
stages -- and held against ``twell_down_proj_plain`` (bf16 2e-2, float32
2e-4, rtol and atol, as tests/test_torch_twell.py), with every y element
written exactly once and every (row, position) entry of h at most once, on
patterns packed by K1's plain version (an empty row block and a union
wider than a chunk among them). The wrapper refuses bad shapes, types and
alignment before anything is built.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import build
from repro_torch.kernels import sparse_ffn as sf
from repro_torch.kernels import twell_pack as tp
from repro_torch.kernels.twell_pack import twell_gate_matmul_plain

SMS = 132
BK = tp.GATE_BK
UC = sf.FUSED_FFN_UC

# (M, K, N, T, C): olmo-1b's FFN at the plan's width and row-block
# boundaries (decode 4, the 256-row prefill step), then the card sweep's
# shapes
OLMO = [(m, 2048, 8192, 256, 8)
        for m in (1, 4, 8, 9, 20, 64, 65, 128, 129, 256, 300)]
SWEEP = [(2, 64, 256, 64, 1), (37, 520, 512, 128, 4), (9, 256, 1024, 256, 1),
         (16, 96, 512, 64, 8), (8, 512, 1024, 128, 4), (33, 512, 1024, 128, 4),
         (65, 1024, 2048, 256, 8), (24, 2048, 8192, 256, 8),
         (256, 2048, 8192, 256, 8), (4096, 2048, 8192, 256, 8)]


def _covered_once(splits, count):
    return [i for lo, hi in splits for i in range(lo, hi)] == \
        list(range(count))


@pytest.mark.parametrize("arg", range(6))
def test_down_proj_plan_takes_only_ints(arg):
    """A tensor (a device value) in place of a shape is refused: the plan
    never reads the pattern, so a serving step never waits on the card."""
    shape = [4, 2048, 8192, 256, 8, SMS]
    shape[arg] = torch.tensor(shape[arg])
    with pytest.raises(TypeError):
        sf.down_proj_plan(*shape)


@pytest.mark.parametrize("sms", [SMS, 5])
@pytest.mark.parametrize("shape", OLMO + SWEEP, ids=str)
def test_down_proj_plan_covers_rows_stages_and_chunks_once(shape, sms):
    m, k, n, t, c = shape
    plan = sf.down_proj_plan(m, k, n, t, c, sms)
    assert plan.width == min(w for w in sf.FUSED_FFN_WIDTHS
                             if w >= min(m, 64))
    assert plan.row_blocks == tp.cdiv(m, plan.width)
    assert (plan.row_blocks - 1) * plan.width < m
    assert plan.k_stages == tp.cdiv(k, BK)
    ranges = plan.k_ranges()
    assert len(ranges) == plan.col_blocks
    assert _covered_once(ranges, plan.k_stages)
    assert all(0 < hi - lo <= plan.k_per_block for lo, hi in ranges)
    assert 1 <= plan.ks <= tp.MAX_KS and plan.col_blocks % plan.ks == 0
    assert not plan.split or plan.width >= sf.FUSED_FFN_SPLIT_WIDTH
    for b in range(plan.row_blocks):
        rv = min(plan.width, m - b * plan.width)
        rows = plan.union_rows(rv)
        assert len(rows) == plan.ks
        if plan.split:
            assert _covered_once(rows, rv)
        else:
            assert rows == [(0, rv)] * plan.ks
    for union in sorted({0, 1, UC - 1, UC, UC + 1, 3 * UC, n // 2, n}):
        groups = plan.groups(union)
        chunks = [ch for g in groups for ch in g]
        assert chunks == sf.FusedFfnPlan.chunks(union)
        assert _covered_once(chunks, union)
        assert all(hi - lo <= UC and lo % UC == 0 for lo, hi in chunks)
        assert all(1 <= len(g) <= plan.h_chunks for g in groups)
        assert len(groups) == tp.cdiv(tp.cdiv(union, UC), plan.h_chunks)


@pytest.mark.parametrize("shape", OLMO + SWEEP, ids=str)
def test_down_proj_plan_fits_registers_and_shared_memory(shape):
    """A block's share of y in its accumulators, slices x width / 2 floats
    a thread, within the rule; the ring, the h tile and the union's maps
    within a block's 227 KB; the ring at least a chunk's stages and
    holding the byte map staged over it; the most h chunks with the least
    ring, then the deepest ring that fits; the fewest slices that keep the
    grid to the SMs."""
    m, k, n, t, c = shape
    plan = sf.down_proj_plan(m, k, n, t, c, SMS)
    assert plan.slices in sf.DOWN_PROJ_SLICES
    assert plan.slices * plan.width // 2 <= sf.FUSED_FFN_ACC
    assert plan.smem == sf.down_proj_smem(plan.width, plan.h_chunks,
                                          plan.stages, n)
    assert plan.smem <= tp.SMEM_BYTES
    lo, hi = sf.DOWN_PROJ_STAGES
    assert max(lo, 2 * plan.slices) <= plan.stages <= hi
    assert sf.fused_ffn_staging(n) <= plan.stages * sf.FUSED_FFN_UNIT
    if plan.stages < hi:
        assert sf.down_proj_smem(plan.width, plan.h_chunks, plan.stages + 1,
                                 n) > tp.SMEM_BYTES
    more = [h for h in sf.DOWN_PROJ_H_CHUNKS if h > plan.h_chunks]
    assert all(sf.down_proj_smem(plan.width, h, max(lo, 2 * plan.slices), n)
               > tp.SMEM_BYTES for h in more)
    fewer = [s for s in sf.DOWN_PROJ_SLICES if s < plan.slices]
    assert all(plan.row_blocks * tp.cdiv(plan.k_stages, 2 * s) > SMS
               for s in fewer)


@pytest.mark.parametrize("m", [1, 4, 20, 64, 256, 300])
def test_down_proj_plan_clusters_fit_the_card(m):
    """At olmo-1b's decode and prefill every block is resident at once, one
    block an SM (K1's residency model): a decode call's W_d gathers spread
    over 16 SMs, one a 128-column slice of y, and from 32 rows a block the
    clusters are as wide as the portable size."""
    plan = sf.down_proj_plan(m, 2048, 8192, 256, 8, SMS)
    assert plan.blocks <= SMS
    assert plan.blocks // plan.ks <= tp.resident_clusters(plan.ks, 1, SMS)
    assert plan.col_blocks >= 16 and plan.slices == 1
    assert plan.h_chunks == sf.DOWN_PROJ_H_CHUNKS[0]
    assert plan.stages == sf.DOWN_PROJ_STAGES[1]
    assert plan.ks == (tp.MAX_KS if plan.width >= 32 else 1)


def test_down_proj_plan_widens_slices_past_one_wave():
    """A grid of 128-column blocks wider than the SMs takes wider column
    blocks; one too wide for the widest keeps it and runs in more waves."""
    plan = sf.down_proj_plan(1024, 2048, 8192, 256, 8, SMS)
    assert plan.slices == 2 and plan.blocks <= SMS
    plan = sf.down_proj_plan(4096, 2048, 8192, 256, 8, SMS)
    assert plan.slices == 4 and plan.blocks > SMS and plan.ks == 1


@pytest.mark.parametrize("bad", [
    (4, 2048, 65536, 256, 8),       # u16 positions
    (4, 2048, 65792, 256, 8),
    (4, 2048, 8192, 32, 8),         # tiles the kernel is not built for
    (4, 2048, 8192, 512, 8),
    (4, 2044, 8192, 256, 8),        # K % 8
    (4, 2048, 8000, 256, 8),        # N % T
    (4, 2048, 8192, 256, 3),        # T % C
    (0, 2048, 8192, 256, 8)])
def test_down_proj_plan_refuses(bad):
    with pytest.raises(ValueError):
        sf.down_proj_plan(*bad, SMS)


# --------------------------------------------------------------------------- #
# the kernel's schedule, replayed
# --------------------------------------------------------------------------- #

def _flags(idx, cnt, n, t, tc, rows):
    """The byte map of the columns of the valid prefixes (slot s of tile j
    valid iff s < cnt[r, j]) of ``rows`` [lo, hi) of a block."""
    flags = np.zeros(32 * tp.cdiv(n, 32), dtype=bool)
    for r in range(*rows):
        for j in range(n // t):
            cols = idx[r, j * tc:j * tc + cnt[r, j]]
            flags[cols[(cols >= 0) & (cols < n)]] = True
    return flags


def _union(flags, n):
    """(U, the columns in order, every column's position: its word's
    prefix plus the bits below it) from the byte map, as the kernel folds
    it into 32-bit words and scans their popcounts."""
    bits = flags.reshape(-1, 32)
    prefix = np.concatenate([[0], np.cumsum(bits.sum(1))[:-1]])
    below = np.cumsum(bits, axis=1) - bits
    pos = (prefix[:, None] + below).reshape(-1)[:n]
    return int(bits.sum()), np.nonzero(flags)[0], pos


def down_replay(vals, idx, nnz, wd, tile, plan):
    """K6's schedule under ``plan``: operands as the kernel reads them
    (widened to float32), products and sums in float32. Returns (y float32,
    the writes of every y element, the most writes any (row, position)
    entry of h took)."""
    m, slots = vals.shape
    n, k = wd.shape
    nt = n // tile
    tc = slots // nt
    idx_np = idx.numpy()
    cnt_all = np.clip(nnz.numpy(), 0, tc)
    vf, wdf = vals.float(), wd.float()
    kpad = plan.k_stages * BK
    y = torch.full((m, k), float("nan"))
    writes = torch.zeros((m, k), dtype=torch.int32)
    most = 0
    hold = plan.h_chunks * UC
    for b in range(plan.row_blocks):
        r0 = b * plan.width
        rv = min(plan.width, m - r0)
        cnt = cnt_all[r0:r0 + rv]
        ib = idx_np[r0:r0 + rv]
        # each rank marks its rows (all of them without the split); the
        # ranks' bitmaps ORed
        flags = np.zeros(32 * tp.cdiv(n, 32), dtype=bool)
        for rows in plan.union_rows(rv):
            flags |= _flags(ib, cnt, n, tile, tc, rows)
        u, cols, pos = _union(flags, n)
        # the block's valid slots: (row, slot, column)
        slot = np.arange(slots)
        valid = (slot % tc)[None, :] < np.repeat(cnt, tc, axis=1)
        rr, ss = np.nonzero(valid)
        cc = ib[rr, ss]
        keep = (cc >= 0) & (cc < n)
        rr, ss, cc = rr[keep], ss[keep], cc[keep]
        yb = torch.zeros(plan.width, kpad)
        for g, group in enumerate(plan.groups(u)):
            lo = group[0][0]
            h = torch.zeros(plan.width, hold)       # zero past the slots
            hits = torch.zeros(plan.width, hold, dtype=torch.int32)
            pc = pos[cc] - lo
            sel = (pc >= 0) & (pc < hold)
            if g:   # a later group scans only the tiles of its columns
                t0, t1 = cols[lo] // tile, cols[group[-1][1] - 1] // tile
                assert ((ss[sel] // tc >= t0) & (ss[sel] // tc <= t1)).all()
            for lo_r, hi_r in plan.union_rows(rv):  # each rank its rows,
                mine = sel & (rr >= lo_r) & (rr < hi_r)  # copied by the rest
                r_t = torch.from_numpy(rr[mine])
                p_t = torch.from_numpy(pc[mine])
                h[r_t, p_t] = vf[r0 + rr[mine], ss[mine]]
                hits.index_put_((r_t, p_t),
                                torch.ones_like(r_t, dtype=torch.int32),
                                accumulate=True)
                if not plan.split:
                    break           # one rank: all the rows
            most = max(most, int(hits.max()))
            for ci, (clo, chi) in enumerate(group):
                ad = torch.zeros(UC, kpad)          # gathered, 0 past U, K
                ad[:chi - clo, :k] = wdf[torch.from_numpy(cols[clo:chi])]
                hc = h[:, ci * UC:(ci + 1) * UC]
                for s0, s1 in plan.k_ranges():     # each column block
                    yb[:, s0 * BK:s1 * BK] += hc @ ad[:, s0 * BK:s1 * BK]
        for s0, s1 in plan.k_ranges():
            k0, k1 = s0 * BK, min(s1 * BK, k)
            y[r0:r0 + rv, k0:k1] = yb[:rv, k0:k1]
            writes[r0:r0 + rv, k0:k1] += 1
    return y, writes, most


# name: (M, K, N, T, C, keep, dtype, special): olmo-1b at decode and at
# the prefill step, a union wider than one chunk with overflowed tiles (and
# wider than the h tile), C = 1, K 200, an empty row, an all-empty row
# block beside a live one, two row blocks split over a cluster, float32
CASES = {
    "olmo_decode": (4, 2048, 8192, 256, 8, 0.02, torch.bfloat16, None),
    "olmo_prefill": (256, 2048, 8192, 256, 8, 0.02, torch.bfloat16, None),
    "overflow_wide": (16, 96, 512, 64, 8, 1.0, torch.bfloat16, None),
    "scattered": (40, 136, 2048, 128, 4, 1.0, torch.bfloat16, None),
    "c1": (5, 128, 256, 64, 1, 0.3, torch.bfloat16, None),
    "k200": (5, 200, 256, 64, 4, 0.2, torch.bfloat16, None),
    "empty_row": (9, 128, 512, 128, 4, 0.1, torch.bfloat16, "empty_row"),
    "empty_block": (70, 192, 768, 256, 2, 0.3, torch.bfloat16,
                    "empty_block"),
    "two_blocks": (100, 520, 1024, 128, 4, 0.2, torch.bfloat16, None),
    "scattered_f32": (37, 136, 512, 128, 4, 1.0, torch.float32, None),
}


def _case(name):
    """(vals, idx, nnz clipped as ops clips it, wd, tile, exact nnz): the
    pattern of relu(x @ W_u) packed by K1's plain version."""
    m, k, n, t, c, keep, dt, special = CASES[name]
    rng = np.random.RandomState(sum(map(ord, name)))
    x = rng.randn(m, k) * 0.5
    if special == "empty_row":
        x[3] = 0.0
    if special == "empty_block":
        x[64:] = 0.0
    col = rng.rand(n) < keep
    wu = rng.randn(k, n) * 0.08 * col[None]
    wd = rng.randn(n, k) * 0.08
    x, wu, wd = (torch.from_numpy(a.astype(np.float32)).to(dt)
                 for a in (x, wu, wd))
    v, i, z = twell_gate_matmul_plain(x, wu, t, c, "relu")
    return v, i, torch.clamp(z, max=t // c), wd, t, z


def _block_union(name, b=0):
    v, i, z, wd, t, _ = _case(name)
    m, slots = v.shape
    n = wd.shape[0]
    tc = slots // (n // t)
    plan = sf.down_proj_plan(m, wd.shape[1], n, t, t // tc, SMS)
    r0 = b * plan.width
    rv = min(plan.width, m - r0)
    cnt = z.numpy()[r0:r0 + rv]
    return _union(_flags(i.numpy()[r0:r0 + rv], cnt, n, t, tc, (0, rv)),
                  n)[0]


@pytest.mark.parametrize("sms", [SMS, 3])
@pytest.mark.parametrize("name", list(CASES))
def test_down_proj_schedule_replay_matches_plain(name, sms):
    v, i, z, wd, t, _ = _case(name)
    m, slots = v.shape
    n, k = wd.shape
    plan = sf.down_proj_plan(m, k, n, t, t * (n // t) // slots, sms)
    got, writes, most = down_replay(v, i, z, wd, t, plan)
    want = sf.twell_down_proj_plain(v, i, z, wd, t)
    assert (writes == 1).all(), "a y element was written twice or never"
    assert most <= 1, "an h entry took two slots"
    tol = 2e-2 if v.dtype == torch.bfloat16 else 2e-4
    torch.testing.assert_close(got, want, rtol=tol, atol=tol)


@pytest.mark.parametrize("name", ["scattered", "two_blocks", "olmo_prefill"])
def test_down_proj_replay_one_chunk_of_h(name):
    """The same schedule with an h tile of one chunk (a scatter a chunk)
    and without the cluster split: the same function."""
    v, i, z, wd, t, _ = _case(name)
    m, slots = v.shape
    n, k = wd.shape
    base = sf.down_proj_plan(m, k, n, t, t * (n // t) // slots, SMS)
    plan = sf.DownProjPlan(base.width, base.row_blocks, base.col_blocks, 1,
                           base.k_stages, base.slices, 1, base.stages,
                           base.smem)
    got, writes, most = down_replay(v, i, z, wd, t, plan)
    want = sf.twell_down_proj_plain(v, i, z, wd, t)
    assert (writes == 1).all() and most <= 1
    torch.testing.assert_close(got, want, rtol=2e-2, atol=2e-2)


def test_replay_cases_reach_their_corners():
    """Each case exercises the corner it is named for."""
    _, _, z, _, _, exact = _case("overflow_wide")
    assert bool((exact > z).any()), "no tile overflowed T/C"
    assert _block_union("overflow_wide") > UC
    hold = sf.down_proj_plan(40, 136, 2048, 128, 4, SMS).h_chunks * UC
    assert _block_union("scattered") > hold
    assert _block_union("scattered_f32") > 2 * UC
    assert CASES["c1"][4] == 1 and CASES["k200"][1] % BK
    _, _, z, _, _, _ = _case("empty_row")
    assert int(z[3].sum()) == 0 and int(z.sum()) > 0
    plan = sf.down_proj_plan(70, 192, 768, 256, 2, SMS)
    assert plan.row_blocks == 2
    assert _block_union("empty_block", 1) == 0
    assert _block_union("empty_block", 0) > 0
    plan = sf.down_proj_plan(100, 520, 1024, 128, 4, SMS)
    assert plan.row_blocks == 2 and plan.split and plan.col_blocks > 1
    assert UC < _block_union("olmo_decode") <= 2 * UC   # two chunks at
    assert UC < _block_union("olmo_prefill") <= 2 * UC  # both, one group


def test_replay_counts_a_repeated_column():
    """The h tile's contract (a row's valid slots hold distinct columns, as
    K1 writes them) is what the replay's count checks: a row that names one
    column twice puts two slots on one entry."""
    v, i, z, wd, t, _ = _case("c1")
    bad = i.clone()
    row = int(torch.nonzero(z[:, 0] >= 2)[0, 0])
    bad[row, 1] = bad[row, 0]
    plan = sf.down_proj_plan(5, 128, 256, 64, 1, SMS)
    _, _, most = down_replay(v, bad, z, wd, t, plan)
    assert most == 2
    _, _, most = down_replay(v, i, z, wd, t, plan)
    assert most == 1


def _no_build(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a kernel was built for an unsupported input")
    monkeypatch.setattr(build, "build_all", refuse)
    monkeypatch.setattr(build, "bind", refuse)


def _operands(m=4, k=64, n=256, t=64, c=2):
    slots = n // c
    return (torch.zeros(m, slots, dtype=torch.bfloat16),
            torch.zeros(m, slots, dtype=torch.int32),
            torch.zeros(m, n // t, dtype=torch.int32),
            torch.zeros(n, k, dtype=torch.bfloat16), t)


@pytest.mark.parametrize("bad,err,match", [
    ("vals_f16", TypeError, "bfloat16"),
    ("wd_f32", TypeError, "bfloat16"),
    ("idx_i64", TypeError, "int32"),
    ("nnz_i64", TypeError, "int32"),
    ("k_odd", ValueError, "K % 8"),
    ("tile_32", ValueError, "tile"),
    ("t_not_c", ValueError, "tile % C"),
    ("wide_n", ValueError, "N <="),
    ("idx_cols", ValueError, "inconsistent"),
    ("nnz_tiles", ValueError, "inconsistent"),
    ("n_not_tile", ValueError, "inconsistent"),
    ("strided", ValueError, "contiguous"),
    ("wd_misaligned", ValueError, "aligned"),
    ("cpu", ValueError, "CUDA")])
def test_twell_down_proj_cuda_refuses_before_building(monkeypatch, bad, err,
                                                       match):
    """Types, shapes the kernel does not take, operands that are not
    contiguous, a W_d that is not 16-byte aligned, and CPU tensors raise in
    the wrapper's checks before any kernel is built or bound."""
    _no_build(monkeypatch)
    vals, idx, nnz, wd, t = _operands()
    if bad == "vals_f16":
        vals = vals.half()
    elif bad == "wd_f32":
        wd = wd.float()
    elif bad == "idx_i64":
        idx = idx.long()
    elif bad == "nnz_i64":
        nnz = nnz.long()
    elif bad == "k_odd":
        vals, idx, nnz, wd, t = _operands(k=60)
    elif bad == "tile_32":
        vals, idx, nnz, wd, t = _operands(t=32, c=1)
    elif bad == "t_not_c":                  # 12 slots a 64-column tile
        vals, idx, nnz, wd, t = _operands(n=256, t=64, c=2)
        vals, idx = vals[:, :48].contiguous(), idx[:, :48].contiguous()
    elif bad == "wide_n":
        vals, idx, nnz, wd, t = _operands(k=8, n=65536, t=256, c=8)
    elif bad == "idx_cols":
        idx = idx[:, :64].contiguous()
    elif bad == "nnz_tiles":
        nnz = nnz[:, :2].contiguous()
    elif bad == "n_not_tile":
        wd = torch.zeros(250, 64, dtype=torch.bfloat16)
    elif bad == "strided":
        wd = torch.zeros(64, 256, dtype=torch.bfloat16).t()
    elif bad == "wd_misaligned":
        wd = torch.zeros(256 * 64 + 1, dtype=torch.bfloat16)[1:].view(256, 64)
    with pytest.raises(err, match=match):
        sf.twell_down_proj_cuda(vals, idx, nnz, wd, t)
