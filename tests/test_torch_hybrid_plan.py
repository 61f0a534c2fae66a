"""The host-side launch plan of K9's bf16 kernel, the hybrid format's SDDMM
``(x @ W)[pattern]`` (``repro_torch/kernels/hybrid_matmul.py:d2h_plan``):
a plain function of shapes that takes no tensor, covers every row and
every chunk of the largest union a block can meet exactly once, keeps a
block within its shared memory, fills the H100's 132 SMs at the training
shape and refuses an N whose maps do not fit. The kernel's schedule is
replayed on the CPU in float32 -- per row block the byte map of the valid
slots' columns, its bitmap and prefix popcount, the union's chunks dealt
over the splits in passes of one or two, each chunk's product in 64-deep
stages and the pick by position, split 0 writing the zeros -- and held
against the plain version at 1e-5 (the same f32 products summed in
another order), with every slot written exactly once. Every plan up to N
16384 is pinned (a digest of a grid of 210) as it was before the wide
union maps; past it (deepseek-67b's d_ff 22016, llama3-405b's 53248) the
plan takes them, and their columns and popcount positions are replayed.
The wrapper refuses what the kernel does not take before anything is
built.
"""
import hashlib

import numpy as np
import pytest
import torch

from repro_torch.kernels import build
from repro_torch.kernels import hybrid_matmul as hm
from repro_torch.kernels import twell_pack as tp

SMS = 132
UN = hm.D2H_COLS
BK = hm.D2H_BK

# (M, K, N, E): the train phase's FFN both ways (paper-0.5b: x @ W_u and
# gy @ W_d^T; olmo-1b's N 8192), then narrow and ragged shapes and the
# widest ELL row
SHAPES = [(8192, 2048, 5632, 128), (8192, 2048, 8192, 128),
          (1, 8, 64, 4), (37, 64, 256, 16), (64, 136, 512, 32),
          (65, 2056, 128, 8), (200, 64, 512, 16), (300, 136, 5632, 128),
          (512, 2048, 5632, 128), (3, 64, 2048, 1024), (20000, 64, 256, 8)]


@pytest.mark.parametrize("arg", range(5))
def test_d2h_plan_takes_only_ints(arg):
    """A tensor (a device value) in place of a shape is refused: the plan
    never reads the pattern, so a training step never waits on the card."""
    shape = [8192, 2048, 5632, 128, SMS]
    shape[arg] = torch.tensor(shape[arg])
    with pytest.raises(TypeError):
        hm.d2h_plan(*shape)


@pytest.mark.parametrize("sms", [SMS, 5])
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_d2h_plan_covers_every_row_and_chunk_once(shape, sms):
    m, k, n, e = shape
    plan = hm.d2h_plan(m, k, n, e, sms)
    rows = hm.D2H_ROWS
    assert plan.row_blocks == tp.cdiv(m, rows)
    assert (plan.row_blocks - 1) * rows < m <= plan.row_blocks * rows
    biggest = min(n, min(m, rows) * e)
    assert plan.max_chunks == tp.cdiv(biggest, UN)
    assert 1 <= plan.splits <= plan.max_chunks
    assert plan.grid == (plan.row_blocks, plan.splits)
    for union in sorted({0, 1, UN - 1, UN, UN + 1, biggest // 2, biggest}):
        dealt = sorted(c for s in range(plan.splits)
                       for p in plan.passes(s, union) for c in p)
        assert dealt == list(range(tp.cdiv(union, UN)))


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_d2h_plan_fits_shared_memory(shape):
    """The ring, the N-sized maps and the row counts within a block's
    227 KB; the staged (128 x 136) f32 accumulators and one row of indices
    within the ring; the deepest ring that fits."""
    m, k, n, e = shape
    plan = hm.d2h_plan(m, k, n, e, SMS)
    rows = hm.D2H_ROWS
    assert plan.stages in hm.D2H_STAGES
    assert plan.smem == hm.d2h_smem(n, plan.stages)
    assert plan.smem <= tp.SMEM_BYTES
    assert rows * (UN + 8) * 4 + 4 * 1024 <= \
        plan.stages * (rows + UN) * 128
    deeper = [st for st in hm.D2H_STAGES if st > plan.stages]
    assert all(hm.d2h_smem(n, st) > tp.SMEM_BYTES for st in deeper)


@pytest.mark.parametrize("n", [5632, 8192])
def test_d2h_plan_fills_the_card_at_the_training_shape(n):
    """M 8192: 64 row blocks of 128 rows, two splits each, 128 blocks of
    the 132 SMs; a third split would need a second wave."""
    plan = hm.d2h_plan(8192, 2048, n, 128, SMS)
    assert (plan.row_blocks, plan.splits) == (64, 2)
    assert plan.blocks <= SMS < plan.blocks + plan.row_blocks


@pytest.mark.parametrize("m", [1, 4, 64, 65, 128, 300, 2048])
def test_d2h_plan_blocks_fill_the_sms_or_the_chunks(m):
    plan = hm.d2h_plan(m, 2048, 5632, 128, SMS)
    assert plan.blocks <= max(SMS, plan.row_blocks)
    assert plan.splits == plan.max_chunks or \
        plan.blocks + plan.row_blocks > SMS


@pytest.mark.parametrize("stages,paired", [(4, False), (5, True),
                                           (6, True)])
def test_d2h_passes_pair_chunks_where_the_ring_holds_three(stages, paired):
    """Block s takes chunks s, s + S, ...: two a pass while two remain
    where the ring's bytes hold three stages of two chunks, else one."""
    plan = hm.D2hPlan(2, stages, 64, 44, hm.d2h_smem(5632, stages))
    union = 41 * UN - 3                        # 41 chunks
    want0 = [(c, c + 2) for c in range(0, 40, 4)] + [(40,)]
    want1 = [(c, c + 2) for c in range(1, 40, 4)]
    if not paired:
        want0 = [(c,) for c in range(0, 41, 2)]
        want1 = [(c,) for c in range(1, 41, 2)]
    assert plan.passes(0, union) == want0
    assert plan.passes(1, union) == want1
    assert plan.passes(0, UN) == [(0,)] and plan.passes(1, UN) == []


@pytest.mark.parametrize("n,e,widest", [(65536, 128, 65535),
                                        (60000, 1024, 44352)])
def test_d2h_plan_refuses_too_wide_n(n, e, widest):
    """Past u16 positions, or where even the wide maps (the union's columns
    min(N, 128 E)) leave no ring: refused, naming the widest N at E."""
    with pytest.raises(ValueError, match=f"too wide.*N up to {widest}"):
        hm.d2h_plan(8192, 2048, n, e, SMS)
    hm.d2h_plan(8192, 2048, widest, e, SMS)


def _hybrid_grid():
    """(M, K, N, E, SMs) of 210 plans up to N 16384."""
    for m in (1, 64, 300, 2048, 8192):
        for n in (64, 512, 5632, 8192, 11008, 14336, 16384):
            for e in (8, 128, 1024):
                for sms in (SMS, 3):
                    yield m, 2048, n, e, sms


# the digest of _hybrid_grid's plans (their fields before ``wide``) before
# the wide union maps
N16384_DIGEST = "e2badd4893e19785"


def test_d2h_plan_up_to_n16384_is_unchanged():
    """Every plan up to N 16384, field for field, on the narrow maps, as
    before the wide maps (paper-0.5b's, olmo-1b's and phi3-mini's K9 times
    stand on them)."""
    fields = ("splits", "stages", "row_blocks", "max_chunks", "smem")
    rows, wide = [], []
    for shape in _hybrid_grid():
        plan = hm.d2h_plan(*shape)
        rows.append((shape, tuple(getattr(plan, f) for f in fields)))
        wide.append(plan.wide)
    assert len(rows) == 210 and not any(wide)
    assert hashlib.sha256(repr(rows).encode()).hexdigest()[:16] == \
        N16384_DIGEST


# the dense configs' FFN widths past N 16384 at the train phase's M and E
# (both orientations read a (d_ff, d_model) matrix by rows): deepseek-67b
# (K 8192, N 22016) and llama3-405b (K 16384, N 53248); the first N past
# 16384; a narrow E
WIDE = [(8192, 8192, 22016, 128), (8192, 16384, 53248, 128),
        (8192, 2048, 16416, 128), (300, 64, 53248, 16)]


@pytest.mark.parametrize("shape", WIDE, ids=str)
def test_d2h_wide_plan_fits_shared_memory(shape):
    """Past N 16384 the wide maps: the ring, the bitmap and its prefix and
    the union's columns (at most min(N, 128 E)) within a block's 227 KB,
    the deepest ring that fits, the staged accumulators within the ring;
    at the train shape 64 row blocks of two splits."""
    m, k, n, e = shape
    plan = hm.d2h_plan(m, k, n, e, SMS)
    assert plan.wide and plan.stages in hm.D2H_STAGES
    assert plan.smem == hm.d2h_smem(n, plan.stages, e) <= tp.SMEM_BYTES
    assert hm.d2h_smem(n, plan.stages) > tp.SMEM_BYTES or n < 19000
    deeper = [st for st in hm.D2H_STAGES if st > plan.stages]
    assert all(hm.d2h_smem(n, st, e) > tp.SMEM_BYTES for st in deeper)
    assert hm.D2H_ROWS * (UN + 8) * 4 + 4 * 1024 <= \
        plan.stages * (hm.D2H_ROWS + UN) * 128
    assert hm.union_cap(n, e) == min(n, hm.D2H_ROWS * e)
    if m == 8192:
        assert (plan.row_blocks, plan.splits) == (64, 2)


def test_d2h_plan_refuses_empty_shapes():
    with pytest.raises(ValueError):
        hm.d2h_plan(0, 2048, 5632, 128, SMS)


# --------------------------------------------------------------------------- #
# the kernel's schedule, replayed in float32
# --------------------------------------------------------------------------- #

def _union(idx, nv, n):
    """One row block's union as the kernel builds it: the byte map of the
    valid slots' columns, folded into 32-bit words, the words' exclusive
    prefix popcount. Returns (words, prefix, U, the columns in order)."""
    flags = np.zeros(32 * tp.cdiv(n, 32), dtype=np.uint8)
    for r, cnt in enumerate(nv):
        cols = idx[r, :cnt]
        flags[cols[(cols >= 0) & (cols < n)]] = 1
    words = [int(sum(int(f) << b for b, f in enumerate(flags[32 * w:
                                                             32 * w + 32])))
             for w in range(tp.cdiv(n, 32))]
    prefix, run = [], 0
    for wd in words:
        prefix.append(run)
        run += bin(wd).count("1")
    cols = [32 * w + b for w, wd in enumerate(words) for b in range(32)
            if wd >> b & 1]
    return words, prefix, run, cols


def _position(col, words, prefix):
    w, b = col >> 5, col & 31
    return prefix[w] + bin(words[w] & ((1 << b) - 1)).count("1")


def wide_maps(idx, nv, n, e):
    """One row block's wide maps as the kernel builds them: each valid
    slot's column ORed into its bitmap word (no byte map), the words'
    prefix, the union's columns into a table of ``union_cap(n, e)``
    entries. Returns (U, the table, the words, the prefix); asserts the
    table holds the union and each column is written once."""
    words = [0] * tp.cdiv(n, 32)
    for r, cnt in enumerate(nv):
        for c in map(int, idx[r, :cnt]):
            if 0 <= c < n:
                words[c >> 5] |= 1 << (c & 31)
    prefix, run = [], 0
    for wd in words:
        prefix.append(run)
        run += bin(wd).count("1")
    cap = hm.union_cap(n, e)
    assert run <= cap, "the union outgrows the wide column table"
    table = [-1] * cap
    for w, wd in enumerate(words):
        p = prefix[w]
        for b in range(32):
            if wd >> b & 1:
                assert table[p] == -1
                table[p] = 32 * w + b
                p += 1
    return run, table, words, prefix


def d2h_replay(x, wt, idx, row_nnz, sparse, plan):
    """K9's bf16 schedule under ``plan`` in float32. Returns (vals, the
    number of writes of every slot)."""
    m, k = x.shape
    n, e = wt.shape[0], idx.shape[1]
    idx_np = idx.numpy()
    vals = torch.full((m, e), float("nan"))
    writes = torch.zeros((m, e), dtype=torch.int32)
    rows = hm.D2H_ROWS
    for rb in range(plan.row_blocks):
        r0 = rb * rows
        rv = min(rows, m - r0)
        nv = [min(max(int(row_nnz[r0 + r]), 0), e) if bool(sparse[r0 + r])
              else 0 for r in range(rv)]
        block_idx = idx_np[r0:r0 + rv]
        words, prefix, u, cols = _union(block_idx, nv, n)
        # the row block's x tile, zero past M and past K's last stage
        kpad = tp.cdiv(k, BK) * BK
        a = torch.zeros(rows, kpad)
        a[:rv, :k] = x[r0:r0 + rv]
        pos = {c: _position(c, words, prefix) for c in cols}
        for s in range(plan.splits):
            if s == 0:               # the zeros of every other slot
                for r in range(rv):
                    for j in range(e):
                        c = int(block_idx[r, j])
                        if j >= nv[r] or not 0 <= c < n:
                            vals[r0 + r, j] = 0.0
                            writes[r0 + r, j] += 1
            for chunks in plan.passes(s, u):       # x's tile once a pass
                accs = []
                for c in chunks:
                    lo, hi = c * UN, min(c * UN + UN, u)
                    b = torch.zeros(UN, kpad)      # gathered, zero past U
                    b[:hi - lo, :k] = wt[cols[lo:hi]]
                    acc = torch.zeros(rows, UN)
                    for k0 in range(0, kpad, BK):  # one stage at a time
                        acc += a[:, k0:k0 + BK] @ b[:, k0:k0 + BK].t()
                    accs.append(acc)
                for r in range(rv):                # the pick
                    for j in range(nv[r]):
                        col = int(block_idx[r, j])
                        p = pos.get(col, -1)
                        for c, acc in zip(chunks, accs):
                            if p // UN == c:
                                vals[r0 + r, j] = acc[r, p % UN]
                                writes[r0 + r, j] += 1
    return vals, writes


def _pattern(rng, m, n, e, counts, sparse, ordered=True):
    """(idx, row_nnz, is_sparse): row r's first counts[r] slots hold
    distinct columns (ascending, as the pack writes them, or shuffled);
    the slots past them hold stray in-range columns, which the kernel must
    not read."""
    idx = rng.randint(0, n, size=(m, e)).astype(np.int32)
    for r, cnt in enumerate(counts):
        cols = rng.choice(n, size=cnt, replace=False)
        idx[r, :cnt] = np.sort(cols) if ordered else cols
    return (torch.from_numpy(idx), torch.tensor(counts, dtype=torch.int32),
            torch.tensor(sparse, dtype=torch.bool))


def _case(name):
    """(x, wt, idx, row_nnz, is_sparse) of one replay case."""
    rng = np.random.RandomState(sum(map(ord, name)))
    m, k, n, e = {"ragged_m": (200, 64, 512, 16), "k8": (70, 8, 256, 8),
                  "k136": (70, 136, 256, 8), "k2056": (70, 2056, 256, 8),
                  "e1024": (3, 64, 2048, 1024),
                  "union_all_n": (128, 64, 256, 32),
                  "backup_block": (200, 64, 512, 16),
                  "empty_rows": (90, 64, 384, 16),
                  "shuffled": (130, 64, 1024, 64),
                  "wide_n": (150, 64, 22016, 16)}[name]
    counts = list(rng.randint(0, e + 1, size=m))
    sparse = [True] * m
    if name == "e1024":                       # ~900 columns a row
        counts = list(rng.randint(800, e + 1, size=m))
    if name == "union_all_n":                 # rows 0..7 cover all 256
        counts = [e] * m
    if name == "backup_block":                # row block 0 all backup
        sparse = [r >= 128 for r in range(m)]
    if name == "empty_rows":                  # sparse rows with no slot
        counts = [0 if r % 3 == 0 else c for r, c in enumerate(counts)]
    idx, nnz, live = _pattern(rng, m, n, e, counts, sparse,
                              ordered=name != "shuffled")
    if name == "union_all_n":
        for r in range(8):
            idx[r] = torch.arange(r * e, (r + 1) * e, dtype=torch.int32)
    x = torch.from_numpy(rng.randn(m, k).astype(np.float32))
    wt = torch.from_numpy((rng.randn(n, k) * 0.1).astype(np.float32))
    return x, wt, idx, nnz, live


REPLAY = ["ragged_m", "k8", "k136", "k2056", "e1024", "union_all_n",
          "backup_block", "empty_rows", "shuffled", "wide_n"]


@pytest.mark.parametrize("sms", [SMS, 3])
@pytest.mark.parametrize("name", REPLAY)
def test_d2h_schedule_replay_matches_plain(name, sms):
    x, wt, idx, nnz, live = _case(name)
    m, k = x.shape
    n, e = wt.shape[0], idx.shape[1]
    plan = hm.d2h_plan(m, k, n, e, sms)
    got, writes = d2h_replay(x, wt, idx, nnz, live, plan)
    want = hm.dense_to_hybrid_plain(x, wt, idx, nnz, live)
    assert (writes == 1).all(), "a slot was written twice or never"
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_replay_cases_reach_their_corners():
    """Each case exercises the corner it is named for."""
    x, wt, idx, nnz, live = _case("union_all_n")
    _, _, u, _ = _union(idx.numpy()[:128], [32] * 128, 256)
    assert u == 256
    x, wt, idx, nnz, live = _case("e1024")
    plan = hm.d2h_plan(3, 64, 2048, 1024, SMS)
    _, _, u, _ = _union(idx.numpy(), nnz.tolist(), 2048)
    assert tp.cdiv(u, UN) > 4 and plan.splits > 1
    few = hm.d2h_plan(3, 64, 2048, 1024, 3)        # passes of two chunks
    assert tp.cdiv(u, UN) > few.splits and \
        any(len(p) == 2 for p in few.passes(0, u))
    x, wt, idx, nnz, live = _case("backup_block")
    assert not live[:128].any() and live[128:].all()
    x, wt, idx, nnz, live = _case("empty_rows")
    assert (nnz == 0).any() and live.all()
    assert 200 % hm.D2H_ROWS and hm.d2h_plan(200, 64, 512, 16,
                                             SMS).row_blocks == 2
    x, wt, idx, nnz, live = _case("wide_n")
    assert hm.d2h_plan(150, 64, 22016, 16, SMS).wide


@pytest.mark.parametrize("block", [0, 1])
def test_d2h_wide_maps_read_every_union_column_once(block):
    """The wide maps of a row block of the ``wide_n`` case: the columns
    table holds the union (within min(N, 128 E)) in ascending order, and
    each valid slot's popcount position finds its own column there: every
    union column is named, each at one position."""
    x, wt, idx, nnz, live = _case("wide_n")
    n, e = wt.shape[0], idx.shape[1]
    r0 = block * hm.D2H_ROWS
    rv = min(hm.D2H_ROWS, idx.shape[0] - r0)
    nv = [int(nnz[r0 + r]) for r in range(rv)]
    block_idx = idx.numpy()[r0:r0 + rv]
    u, table, words, prefix = wide_maps(block_idx, nv, n, e)
    assert u > UN and table[:u] == sorted(table[:u])
    assert table[:u] == _union(block_idx, nv, n)[3]
    seen = set()
    for r in range(rv):
        for c in block_idx[r, :nv[r]]:
            p = _position(int(c), words, prefix)
            assert table[p] == c
            seen.add(p)
    assert seen == set(range(u))


def _no_build(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a kernel was built for an unsupported input")
    monkeypatch.setattr(build, "build_all", refuse)
    monkeypatch.setattr(build, "bind", refuse)


@pytest.mark.parametrize("bad,err", [("cpu", ValueError),
                                     ("dtypes", TypeError)])
def test_dense_to_hybrid_cuda_refuses_before_building(monkeypatch, bad, err):
    """CPU tensors, and x and wt of two types, raise in the wrapper's
    checks before any kernel is built or bound."""
    _no_build(monkeypatch)
    x = torch.zeros(4, 16, dtype=torch.bfloat16)
    wt = torch.zeros(32, 16, dtype=torch.float32 if bad == "dtypes"
                     else torch.bfloat16)
    idx = torch.zeros(4, 8, dtype=torch.int32)
    nnz = torch.zeros(4, dtype=torch.int32)
    live = torch.ones(4, dtype=torch.bool)
    with pytest.raises(err):
        hm.dense_to_hybrid_cuda(x, wt, idx, nnz, live)
