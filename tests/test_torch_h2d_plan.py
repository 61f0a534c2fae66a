"""The host-side launch plan of K8's bf16 kernel, the hybrid format's SpMM
``y = h @ W`` (``repro_torch/kernels/hybrid_matmul.py:h2d_plan``): a plain
function of shapes that takes no tensor, covers every row and every K
slice of y exactly once, cuts any union into tile chunks that cover it
once, keeps a block within its shared memory, fills the H100's 132 SMs at
the training shape and refuses an N whose maps do not fit. The kernel's
schedule is replayed on the CPU in float32 -- per row block the byte map
of the valid slots' columns, its bitmap and prefix popcount, the h tile
scattered by position (f32 values as bf16 hi + lo, cast by torch), the
K slices dealt over the splits, the union's tile chunks and their 64-deep
stages of gathered W rows -- and held against the plain version at 1e-4
(the tolerance of the card test), with every y element written exactly
once and every tile entry at most once on ``pack``'s output. Every plan
up to N 16384 is pinned (a digest of a grid of 420) as it was before the
wide union maps; past it (deepseek-67b's d_ff 22016, llama3-405b's 53248)
the plan takes them, and the schedule is replayed there too. The wrapper
refuses what the kernel does not take before anything is built.
"""
import hashlib

import numpy as np
import pytest
import torch

from repro_torch.core import hybrid as hyb
from repro_torch.kernels import build
from repro_torch.kernels import hybrid_matmul as hm
from repro_torch.kernels import twell_pack as tp

SMS = 132
ROWS, KS, US = hm.H2D_ROWS, hm.H2D_KS, hm.H2D_US

# (M, K, N, E): the train phase's FFN both ways (paper-0.5b: h @ W_d and
# grad h_u @ W_u^T, N 5632; olmo-1b's N 8192), then narrow and ragged
# shapes, the widest ELL row and a K past one slice
SHAPES = [(8192, 2048, 5632, 128), (8192, 5632, 2048, 128),
          (8192, 2048, 8192, 128), (1, 8, 64, 4), (37, 64, 256, 16),
          (300, 136, 512, 32), (40, 72, 384, 10), (5, 2056, 128, 8),
          (8, 64, 2048, 1024), (512, 2048, 5632, 128), (20000, 64, 256, 8)]


@pytest.mark.parametrize("arg", range(6))
def test_h2d_plan_takes_only_ints(arg):
    """A tensor (a device value) in place of a shape is refused: the plan
    never reads the pattern, so a training step never waits on the card."""
    shape = [8192, 2048, 5632, 128, SMS, 2]
    shape[arg] = torch.tensor(shape[arg])
    with pytest.raises(TypeError):
        hm.h2d_plan(*shape)


@pytest.mark.parametrize("terms", [1, 2])
@pytest.mark.parametrize("sms", [SMS, 5])
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_h2d_plan_covers_every_row_slice_and_chunk_once(shape, sms, terms):
    m, k, n, e = shape
    plan = hm.h2d_plan(m, k, n, e, sms, terms)
    assert plan.row_blocks == tp.cdiv(m, ROWS)
    assert (plan.row_blocks - 1) * ROWS < m <= plan.row_blocks * ROWS
    assert plan.k_slices == tp.cdiv(k, KS)
    assert 1 <= plan.splits <= plan.k_slices
    assert plan.grid == (plan.row_blocks, plan.splits)
    dealt = sorted(t for s in range(plan.splits) for t in plan.slices(s))
    assert dealt == list(range(plan.k_slices))
    biggest = min(n, min(m, ROWS) * e)
    for union in sorted({0, 1, US - 1, US, US + 1, plan.cols,
                         plan.cols + 1, biggest // 2, biggest}):
        chunks = plan.chunks(union)
        pos = [p for lo, hi in chunks for p in range(lo, hi)]
        assert pos == list(range(tp.cdiv(union, US) * US))
        assert all(hi - lo <= plan.cols and lo % US == 0
                   for lo, hi in chunks)
        assert (len(chunks) <= 1) == (union <= plan.cols)


@pytest.mark.parametrize("terms", [1, 2])
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_h2d_plan_fits_shared_memory(shape, terms):
    """The ring, the tile's ``terms`` parts and the N-sized maps within a
    block's 227 KB; one row of indices and values (a scatter's piece)
    within the ring; the tile at least the union the plan prefers to keep
    (or the widest a block can meet), no wider than that, and the deepest
    ring that fits beside it."""
    m, k, n, e = shape
    plan = hm.h2d_plan(m, k, n, e, SMS, terms)
    assert plan.stages in hm.H2D_STAGES
    assert plan.smem == hm.h2d_smem(n, plan.stages, plan.cols, terms)
    assert plan.smem <= tp.SMEM_BYTES
    widest = tp.cdiv(min(n, min(m, ROWS) * e), US) * US
    assert plan.cols % US == 0 and US <= plan.cols <= widest
    assert plan.stages * hm.H2D_STAGE_BYTES - 128 >= 1024 * (4 + 4)
    if hm.h2d_smem(n, hm.H2D_STAGES[0], min(widest, hm.H2D_RESIDENT),
                   terms) <= tp.SMEM_BYTES:
        assert plan.cols >= min(widest, hm.H2D_RESIDENT)
    deeper = [st for st in hm.H2D_STAGES if st > plan.stages]
    assert all(hm.h2d_smem(n, st, plan.cols, terms) > tp.SMEM_BYTES
               for st in deeper)
    assert plan.cols == widest or hm.h2d_smem(
        n, plan.stages, plan.cols + US, terms) > tp.SMEM_BYTES


@pytest.mark.parametrize("terms", [1, 2])
@pytest.mark.parametrize("k", [2048, 5632])
def test_h2d_plan_fills_the_card_at_the_training_shape(k, terms):
    """M 8192: 64 row blocks of 128 rows, two splits each, 128 blocks of
    the 132 SMs (a third split would need a second wave); the train
    phase's union (~216 columns a block) stays in the tile, so each block
    scatters it once."""
    plan = hm.h2d_plan(8192, k, 5632, 128, SMS, terms)
    assert (plan.row_blocks, plan.splits) == (64, 2)
    assert plan.blocks <= SMS < plan.blocks + plan.row_blocks
    assert len(plan.chunks(216)) == 1 and plan.cols >= 256


@pytest.mark.parametrize("m", [1, 4, 64, 65, 128, 300, 2048])
def test_h2d_plan_blocks_fill_the_sms_or_the_slices(m):
    plan = hm.h2d_plan(m, 2048, 5632, 128, SMS)
    assert plan.blocks <= max(SMS, plan.row_blocks)
    assert plan.splits == plan.k_slices or \
        plan.blocks + plan.row_blocks > SMS


@pytest.mark.parametrize("n,e,widest", [(65536, 128, 65535),
                                        (60000, 1024, 58912)])
def test_h2d_plan_refuses_too_wide_n(n, e, widest):
    """Past u16 positions, or where even the wide maps leave no tile of 64
    positions and ring of 4 (f32 values): refused, naming the widest N."""
    with pytest.raises(ValueError, match=f"too wide.*N up to {widest}"):
        hm.h2d_plan(8192, 2048, n, e, SMS, 2)
    hm.h2d_plan(8192, 2048, widest, e, SMS, 2)


def _hybrid_grid():
    """(M, K, N, E, SMs) of 210 shapes up to N 16384, each at terms 1 and
    2."""
    for m in (1, 64, 300, 2048, 8192):
        for n in (64, 512, 5632, 8192, 11008, 14336, 16384):
            for e in (8, 128, 1024):
                for sms in (SMS, 3):
                    yield m, 2048, n, e, sms


# the digest of _hybrid_grid's plans (their fields before ``wide``) before
# the wide union maps
N16384_DIGEST = "d9b488b3c48eb1e9"


def test_h2d_plan_up_to_n16384_is_unchanged():
    """Every plan up to N 16384, field for field, on the narrow maps, as
    before the wide maps (paper-0.5b's, olmo-1b's and phi3-mini's K8 times
    stand on them)."""
    fields = ("splits", "stages", "cols", "row_blocks", "k_slices", "smem")
    rows, wide = [], []
    for shape in _hybrid_grid():
        for terms in (1, 2):
            plan = hm.h2d_plan(*shape, terms)
            rows.append((shape, terms,
                         tuple(getattr(plan, f) for f in fields)))
            wide.append(plan.wide)
    assert len(rows) == 420 and not any(wide)
    assert hashlib.sha256(repr(rows).encode()).hexdigest()[:16] == \
        N16384_DIGEST


# deepseek-67b's (K 8192, N 22016) and llama3-405b's (K 16384, N 53248)
# FFN at the train phase's M and E, the first N past 16384, a narrow E
WIDE = [(8192, 8192, 22016, 128), (8192, 16384, 53248, 128),
        (8192, 2048, 16416, 128), (300, 64, 53248, 16)]


@pytest.mark.parametrize("terms", [1, 2])
@pytest.mark.parametrize("shape", WIDE, ids=str)
def test_h2d_wide_plan_fits_shared_memory(shape, terms):
    """Past N 16384 the wide maps: the ring, the tile's parts, the bitmap
    and its prefix and the union's columns within a block's 227 KB; the
    tile as the narrow rule sets it (the resident union first, the ring,
    then the tile); at the train shape 64 row blocks of two splits and the
    train phase's ~216-column union in at most two chunks."""
    m, k, n, e = shape
    plan = hm.h2d_plan(m, k, n, e, SMS, terms)
    assert plan.wide and plan.stages in hm.H2D_STAGES
    assert plan.smem == hm.h2d_smem(n, plan.stages, plan.cols, terms, e) \
        <= tp.SMEM_BYTES
    widest = tp.cdiv(min(n, min(m, ROWS) * e), US) * US
    assert plan.cols % US == 0 and US <= plan.cols <= widest
    deeper = [st for st in hm.H2D_STAGES if st > plan.stages]
    assert all(hm.h2d_smem(n, st, plan.cols, terms, e) > tp.SMEM_BYTES
               for st in deeper)
    assert plan.cols == widest or hm.h2d_smem(
        n, plan.stages, plan.cols + US, terms, e) > tp.SMEM_BYTES
    if m == 8192:
        assert (plan.row_blocks, plan.splits) == (64, 2)
        assert len(plan.chunks(216)) <= 2


@pytest.mark.parametrize("shape", [(0, 2048, 5632, 128, SMS, 1),
                                   (8192, 0, 5632, 128, SMS, 1),
                                   (8192, 2048, 5632, 128, SMS, 3)])
def test_h2d_plan_refuses_empty_shapes(shape):
    with pytest.raises(ValueError):
        hm.h2d_plan(*shape)


# --------------------------------------------------------------------------- #
# the kernel's schedule, replayed in float32
# --------------------------------------------------------------------------- #

def _union(idx, nv, n):
    """One row block's union as the kernel builds it: the byte map of the
    valid slots' columns, folded into 32-bit words, the words' exclusive
    prefix popcount. Returns (U, the columns in order, the position of
    every column of N: prefix[w] + popcount(word w below the column's
    bit); meaningful on the union's columns)."""
    words = tp.cdiv(n, 32)
    flags = np.zeros(32 * words, dtype=bool)
    for r, cnt in enumerate(nv):
        cols = idx[r, :cnt]
        flags[cols[(cols >= 0) & (cols < n)]] = True
    bits = flags.reshape(words, 32)
    prefix = np.concatenate([[0], np.cumsum(bits.sum(1))[:-1]])
    below = np.cumsum(bits, axis=1) - bits            # bits below, a word
    pos = (prefix[:, None] + below).reshape(-1)[:n]
    return int(bits.sum()), np.nonzero(flags)[0], pos


def _parts(v, terms):
    """The tile's bf16 parts of values v (torch's bf16 cast): v itself
    (bf16 values), or hi = bf16(v) and lo = bf16(v - hi)."""
    if terms == 1:
        return [v.bfloat16().float()]
    hi = v.bfloat16().float()
    return [hi, (v - hi).bfloat16().float()]


def h2d_replay(vals, idx, row_nnz, sparse, w, plan, terms):
    """K8's bf16 schedule under ``plan`` in float32 (W bf16, as the kernel
    reads it). Returns (y, the writes of every y element, the most writes
    any tile entry took)."""
    m, e = idx.shape
    n, k = w.shape
    idx_np = idx.numpy()
    wb = w.bfloat16().float()
    y = torch.full((m, k), float("nan"))
    y_writes = torch.zeros((m, k), dtype=torch.int32)
    most = 0
    kpad = plan.k_slices * KS
    for rb in range(plan.row_blocks):
        r0 = rb * ROWS
        rv = min(ROWS, m - r0)
        nv = [min(max(int(row_nnz[r0 + r]), 0), e) if bool(sparse[r0 + r])
              else 0 for r in range(rv)]
        block_idx = idx_np[r0:r0 + rv]
        u, cols, pos = _union(block_idx, nv, n)
        # the block's valid slots: (row, position, value)
        rr, ee = np.nonzero(np.arange(e)[None, :] < np.array(nv)[:, None])
        cc = block_idx[rr, ee]
        ok = (cc >= 0) & (cc < n)
        rr, ee, cc = rr[ok], ee[ok], cc[ok]
        pp = torch.from_numpy(pos[cc])
        parts = _parts(vals[r0 + rr, ee].float(), terms)
        rr_t = torch.from_numpy(rr)
        for s in range(plan.splits):
            for t in plan.slices(s):                # the block's K slices
                acc = torch.zeros(ROWS, KS)
                for lo, hi in plan.chunks(u):       # the tile's chunks
                    tile = torch.zeros(terms, ROWS, hi - lo)
                    hits = torch.zeros(ROWS, hi - lo, dtype=torch.int32)
                    inc = (pp >= lo) & (pp < hi)
                    at = (rr_t[inc], pp[inc] - lo)
                    hits.index_put_(at, torch.ones_like(at[0],
                                                        dtype=torch.int32),
                                    accumulate=True)
                    most = max(most, int(hits.max()) if hits.numel() else 0)
                    for q in range(terms):
                        tile[q].index_put_(at, parts[q][inc])
                    for p0 in range(lo, hi, US):    # 64-deep stages
                        b = torch.zeros(US, kpad)   # gathered, 0 past U, K
                        live = cols[p0:min(p0 + US, u)]
                        b[:len(live), :k] = wb[torch.from_numpy(live)]
                        for q in range(terms):
                            acc += tile[q][:, p0 - lo:p0 - lo + US] @ \
                                b[:, t * KS:(t + 1) * KS]
                k0, k1 = t * KS, min(t * KS + KS, k)
                y[r0:r0 + rv, k0:k1] = acc[:rv, :k1 - k0]
                y_writes[r0:r0 + rv, k0:k1] += 1
    return y, y_writes, most


# name: (M, N, K, E, dense rows, kind); the first rows of HYBRID_SHAPES in
# tests/test_torch_cuda.py, a union near N (the tile in chunks), an empty
# union, a row block with no ELL row and the train phase's pattern cut to
# 256 rows
CASES = {
    "one_row": (1, 64, 8, 4, 0, "random"),
    "ragged": (37, 256, 64, 16, 3, "random"),
    "two_blocks": (300, 512, 136, 32, 10, "random"),
    "e10": (40, 384, 72, 10, 2, "random"),
    "k2056": (5, 128, 2056, 8, 1, "random"),
    "e1024": (8, 2048, 64, 1024, 1, "random"),
    "scattered": (130, 2048, 136, 64, 2, "scattered"),
    "empty_union": (70, 256, 72, 16, 0, "empty"),
    "backup_block": (300, 512, 136, 32, 128, "backup_block"),
    "alive216": (256, 5632, 264, 128, 2, "alive216"),
    # past N 16384 (the wide maps): a random pattern, and the train
    # phase's at deepseek-67b's N
    "wide_n": (150, 22016, 72, 16, 4, "random"),
    "alive216_wide": (256, 22016, 136, 128, 2, "alive216"),
}


def _case(name, terms):
    """(values, idx, row_nnz, is_sparse, w) of one replay case, packed by
    ``hyb.pack``: bf16 values (terms 1) or f32 ones bf16 cannot hold."""
    m, n, k, e, dense, kind = CASES[name]
    rng = np.random.RandomState(sum(map(ord, name)))
    if kind == "alive216":
        pool = rng.permutation(n)[:216]
        pick = np.argpartition(rng.rand(m, 216), 108, axis=1)[:, :108]
        h = np.zeros((m, n))
        h[np.arange(m)[:, None], pool[pick]] = rng.randn(m, 108)
    elif kind == "scattered":
        h = np.where(rng.rand(m, n) < 0.8 * e / n, rng.randn(m, n), 0.0)
    elif kind == "empty":
        h = np.zeros((m, n))
    else:
        h = np.where(rng.rand(m, n) < 0.5 * e / n, rng.randn(m, n), 0.0)
    rows = np.arange(dense) if kind == "backup_block" else \
        rng.permutation(m)[:dense]
    h[rows] = rng.randn(dense, n)
    h = torch.from_numpy(h.astype(np.float32))
    if terms == 1:
        h = h.bfloat16()
    hy = hyb.pack(h, e, dense + 8)       # room for rows past E by chance
    assert not bool(hy.overflow)
    w = torch.from_numpy((rng.randn(n, k) * 0.1).astype(np.float32))
    return hy.ell_values, hy.ell_indices, hy.row_nnz, ~hy.is_dense, w


@pytest.mark.parametrize("terms", [1, 2])
@pytest.mark.parametrize("sms", [SMS, 3])
@pytest.mark.parametrize("name", list(CASES))
def test_h2d_schedule_replay_matches_plain(name, sms, terms):
    vals, idx, nnz, live, w = _case(name, terms)
    m, e = idx.shape
    n, k = w.shape
    plan = hm.h2d_plan(m, k, n, e, sms, terms)
    got, writes, most = h2d_replay(vals, idx, nnz, live, w, plan, terms)
    want = hm.hybrid_to_dense_plain(vals, idx, nnz, live, w.bfloat16())
    assert (writes == 1).all(), "a y element was written twice or never"
    assert most <= 1, "a tile entry took two slots"
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("terms", [1, 2])
@pytest.mark.parametrize("name", ["two_blocks", "scattered", "alive216"])
def test_h2d_replay_in_chunks_of_one_stage(name, terms):
    """The same schedule with the narrowest tile, 64 positions: every
    union of more than 64 columns goes in chunks, scattered again for each
    K slice, the accumulators carried over the chunks."""
    vals, idx, nnz, live, w = _case(name, terms)
    m, e = idx.shape
    n, k = w.shape
    base = hm.h2d_plan(m, k, n, e, SMS, terms)
    plan = hm.H2dPlan(base.splits, 4, US, base.row_blocks, base.k_slices,
                      hm.h2d_smem(n, 4, US, terms))
    got, writes, most = h2d_replay(vals, idx, nnz, live, w, plan, terms)
    want = hm.hybrid_to_dense_plain(vals, idx, nnz, live, w.bfloat16())
    assert (writes == 1).all() and most <= 1
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


def test_h2d_f32_values_need_both_parts():
    """f32 values that bf16 cannot hold: hi alone misses the 1e-4
    tolerance that hi + lo holds, so the kernel's second tile is needed."""
    vals, idx, nnz, live, w = _case("alive216", 2)
    m, e = idx.shape
    n, k = w.shape
    plan = hm.h2d_plan(m, k, n, e, SMS, 2)
    want = hm.hybrid_to_dense_plain(vals, idx, nnz, live, w.bfloat16())
    hi_only, _, _ = h2d_replay(vals, idx, nnz, live, w, plan, 1)
    assert not torch.allclose(hi_only, want, rtol=1e-4, atol=1e-4)
    both, _, _ = h2d_replay(vals, idx, nnz, live, w, plan, 2)
    torch.testing.assert_close(both, want, rtol=1e-4, atol=1e-4)


def test_replay_cases_reach_their_corners():
    """Each case exercises the corner it is named for."""
    def union_of(name, block=0):
        vals, idx, nnz, live, w = _case(name, 1)
        r0 = block * ROWS
        rv = min(ROWS, idx.shape[0] - r0)
        nv = [int(nnz[r0 + r]) if bool(live[r0 + r]) else 0
              for r in range(rv)]
        return _union(idx.numpy()[r0:r0 + rv], nv, w.shape[0])[0]
    plan = hm.h2d_plan(130, 136, 2048, 64, SMS)
    assert len(plan.chunks(union_of("scattered"))) > 1
    assert union_of("empty_union") == 0
    assert union_of("backup_block", 0) == 0 and union_of("backup_block", 1)
    assert 150 <= union_of("alive216") <= 216
    assert hm.h2d_plan(5, 2056, 128, 8, SMS).k_slices == 17
    assert hm.h2d_plan(300, 136, 512, 32, 3).splits == 1
    for name in ("wide_n", "alive216_wide"):
        m, n, k, e = CASES[name][:4]
        plan = hm.h2d_plan(m, k, n, e, SMS)
        assert plan.wide and union_of(name) <= hm.union_cap(n, e)
    assert 150 <= union_of("alive216_wide") <= 216


def test_replay_counts_a_repeated_column():
    """The tile's contract (distinct columns a row, as pack writes them) is
    what the replay's write count checks: a row that names one column
    twice puts two slots on one tile entry."""
    idx = torch.tensor([[3, 5, 3, 0]], dtype=torch.int32)
    vals = torch.ones((1, 4))
    nnz = torch.tensor([3], dtype=torch.int32)
    live = torch.ones(1, dtype=torch.bool)
    w = torch.ones((8, 8))
    plan = hm.h2d_plan(1, 8, 8, 4, SMS)
    _, _, most = h2d_replay(vals, idx, nnz, live, w, plan, 1)
    assert most == 2
    _, idx_p, nnz_p, live_p, _ = _case("two_blocks", 1)
    for r in range(idx_p.shape[0]):
        if live_p[r]:
            row = idx_p[r, :int(nnz_p[r])]
            assert row.unique().numel() == row.numel()


def _no_build(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a kernel was built for an unsupported input")
    monkeypatch.setattr(build, "build_all", refuse)
    monkeypatch.setattr(build, "bind", refuse)


@pytest.mark.parametrize("bad,err", [("cpu", ValueError),
                                     ("values", TypeError),
                                     ("weights", TypeError)])
def test_hybrid_to_dense_cuda_refuses_before_building(monkeypatch, bad, err):
    """CPU tensors, and values or weights of a type the kernels do not take
    (float16), raise in the wrapper's checks before any kernel is built or
    bound."""
    _no_build(monkeypatch)
    vals = torch.zeros(4, 8, dtype=torch.float16 if bad == "values"
                       else torch.bfloat16)
    idx = torch.zeros(4, 8, dtype=torch.int32)
    nnz = torch.zeros(4, dtype=torch.int32)
    live = torch.ones(4, dtype=torch.bool)
    w = torch.zeros(32, 16, dtype=torch.float16 if bad == "weights"
                    else torch.bfloat16)
    with pytest.raises(err):
        hm.hybrid_to_dense_cuda(vals, idx, nnz, live, w)
